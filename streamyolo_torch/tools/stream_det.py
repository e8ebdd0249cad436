#!/usr/bin/env python3
"""Real-time streaming detection CLI of the port, the counterpart of
``tools/stream_det.py``.

    python -m streamyolo_torch.tools.stream_det --data-root D/Argoverse-1.1/tracking \\
        --annot-path D/Argoverse-HD/annotations/val.json -f cfgs/l_s50_onex_dfp_tal_filp.py \\
        -c weights.pth --out-dir OUT [--device-preproc] [--device cpu]

Runs ``CUDAStreamDetector`` against each sequence's frames under the wall
clock and writes the per-sequence pkls and ``time_info.pkl`` that
``streaming_eval`` pairs and scores. ``--sim-zoo ZOO`` runs the same
protocol under a simulated clock that advances by runtimes drawn from the
zoo entry ``--sim-name``, scaled by ``--perf-factor``; the draws are seeded
(``SIM_SEED``; the JAX tool draws unseeded), so a simulated run is
reproducible. ``--infinite`` (with ``--sim-zoo``) processes every frame as
if each had its own card, and writes the per-sequence pkls.

``-f`` names one of the port's configs (a path into ``cfgs/`` is matched by
its basename) or a config file of its own. ``-c`` reads a ``.pth`` state
dict (raw or under ``model``) or a ``.safetensors`` file with torch names,
shape-tolerant (missing or mismatched entries keep their init values); a
JAX ``.pkl`` is refused with a pointer to ``tools/export_safetensors.py``.
The modules are bf16 unless ``--fp32``. ``--device-preproc`` downsamples
the raw frame on the card (kernel B2; raw frames must be exactly twice the
input size) instead of resizing on the host (``data/cv2_ops.py::resize_u8``,
native, equal to ``cv2.resize``). ``--aot-dir DIR``
serves from the captured graphs that ``precompile --serve DIR`` wrote for
this configuration (``stream/online.py``; eager, with a warning, on a key
miss). Frames are read from ``--data-root`` by the port's JPEG decoder
(``data/image_io.py``, equal to ``cv2.imread``; no cv2 needed), or taken
from ``main(load_frame=...)``. Runs on ``cuda`` unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import pickle
from typing import Callable, Dict, Optional, Sequence

import numpy as np

WARMUP_FRAMES = 10
SIM_SEED = 0


def make_parser():
    parser = argparse.ArgumentParser("streamyolo_torch streaming detection")
    parser.add_argument("--data-root", type=str, required=True)
    parser.add_argument("--annot-path", type=str, required=True)
    parser.add_argument("--det-stride", type=int, default=1)
    parser.add_argument("--in_scale", type=float, default=0.5)
    parser.add_argument("--fps", type=float, default=30)
    parser.add_argument("--dynamic-schedule", action="store_true", default=False)
    parser.add_argument("--out-dir", type=str, required=True)
    parser.add_argument("--config", "-f", type=str, required=True)
    parser.add_argument("--weights", "-c", type=str, required=True)
    parser.add_argument("--conf", type=float, default=0.01)
    parser.add_argument("--nms", type=float, default=0.65)
    parser.add_argument("--fp32", action="store_true", default=False,
                        help="float32 modules (default: bf16 modules)")
    parser.add_argument("--overwrite", action="store_true", default=False)
    parser.add_argument("--sim-zoo", type=str, default=None,
                        help="runtime zoo pkl: run under a simulated clock")
    parser.add_argument("--infinite", action="store_true", default=False,
                        help="process EVERY frame (infinite compute); needs --sim-zoo")
    parser.add_argument("--sim-name", type=str, default=None, help="zoo entry name")
    parser.add_argument("--perf-factor", type=float, default=1.0)
    parser.add_argument("--aot-dir", type=str, default=None,
                        help="serve from the captured graphs that precompile --serve "
                             "wrote under this directory (eager on a key miss)")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--device-preproc", action="store_true", default=False,
                        help="0.5x downsample on the card (kernel B2); raw frames "
                             "must be exactly 2x the input size")
    return parser


def build_detector(config: str, weights: str, input_size, *, fp32: bool = False,
                   device: str = "cuda", **det_kw):
    """``CUDAStreamDetector`` over the model of ``config`` with ``weights``
    merged shape-tolerantly into its seeded init (bf16 modules unless
    ``fp32``); ``det_kw`` goes to the detector."""
    import torch

    from streamyolo_torch.exp import get_exp
    from streamyolo_torch.stream import CUDAStreamDetector
    from streamyolo_torch.tools.eval import load_checkpoint
    from streamyolo_torch.utils.weights import merge_state_dict

    exp = get_exp(config)
    exp.compute_dtype = "float32" if fp32 else "bfloat16"
    state = merge_state_dict(exp.init_model(), load_checkpoint(weights), strict=False)
    if fp32:  # float32 means float32, not TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    model = exp.get_model(device)
    model.load_state_dict(state, strict=True)
    return CUDAStreamDetector(model, input_size=input_size, num_classes=exp.num_classes,
                              use_bf16=not fp32, device=device, **det_kw)


def main(argv: Optional[Sequence[str]] = None,
         load_frame: Optional[Callable[[dict], np.ndarray]] = None) -> Dict:
    """Run as the command line says. Returns the run's ``time_info`` (with
    ``--infinite``: the per-sequence results). ``load_frame`` (image dict
    -> BGR uint8 frame) supplies the pixels instead of reading them from
    ``--data-root``."""
    args = make_parser().parse_args(argv)
    if args.infinite and not args.sim_zoo:
        raise SystemExit("--infinite requires --sim-zoo")

    from streamyolo_torch.data import COCO
    from streamyolo_torch.stream import (SimClock, dist_from_zoo, run_streaming_detection,
                                         stream_sequence_infinite)
    from streamyolo_torch.stream.online import imread_loader
    from streamyolo_torch.utils.device import resolve_device

    resolve_device(args.device)  # no card: fail before anything is read
    db = COCO(args.annot_path)
    img0 = next(iter(db.imgs.values()))
    input_size = (int(img0["height"] * args.in_scale), int(img0["width"] * args.in_scale))
    detector = build_detector(
        args.config, args.weights, input_size, fp32=args.fp32, device=args.device,
        in_scale=args.in_scale, conf_thre=args.conf, nms_thre=args.nms,
        device_preproc=args.device_preproc, aot_dir=args.aot_dir)
    print("loaded checkpoint done.")
    detector.warmup(WARMUP_FRAMES)

    clock = runtime_dist = None
    if args.sim_zoo:
        clock = SimClock()
        runtime_dist = dist_from_zoo(args.sim_zoo, args.sim_name,
                                     perf_factor=args.perf_factor, seed=SIM_SEED)
    load_frame = load_frame or imread_loader(db, args.data_root)

    if args.infinite:
        os.makedirs(args.out_dir, exist_ok=True)
        results = {}
        for sid, seq in enumerate(db.dataset["sequences"]):
            frames = [load_frame(img) for img in db.imgs.values() if img["sid"] == sid]
            results[seq] = stream_sequence_infinite(frames, detector, fps=args.fps,
                                                    runtime_dist=runtime_dist)
            with open(os.path.join(args.out_dir, seq + ".pkl"), "wb") as f:
                pickle.dump(results[seq], f)
        return results

    return run_streaming_detection(
        db, args.data_root, args.out_dir, detector, fps=args.fps,
        det_stride=args.det_stride, dynamic_schedule=args.dynamic_schedule,
        clock=clock, runtime_dist=runtime_dist, overwrite=args.overwrite,
        load_frame=load_frame)


if __name__ == "__main__":
    main()
