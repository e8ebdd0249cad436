#!/usr/bin/env python3
"""Offline detection dump of the port, the counterpart of
``tools/offline_det.py``: the streaming detector on EVERY frame, no clock,
the results in CCF format (``results_ccf.pkl``) and their COCO score
(``eval_summary.pkl``, unless ``--no-eval``).

    python -m streamyolo_torch.tools.offline_det --data-root D --annot-path val.json \\
        -f cfgs/l_s50_onex_dfp_tal_filp.py -c weights.pth --out-dir OUT \\
        [--device-preproc] [--device cpu]

Weights, configs, ``--fp32``, ``--device-preproc``, ``--device`` and
``main(load_frame=...)`` as in ``stream_det``.
"""

from __future__ import annotations

import argparse
import os
import pickle
from typing import Callable, Dict, Optional, Sequence

import numpy as np


def make_parser():
    parser = argparse.ArgumentParser("streamyolo_torch offline detection")
    parser.add_argument("--data-root", type=str, required=True)
    parser.add_argument("--annot-path", type=str, required=True)
    parser.add_argument("--in_scale", type=float, default=0.5)
    parser.add_argument("--config", "-f", type=str, required=True)
    parser.add_argument("--weights", "-c", type=str, required=True)
    parser.add_argument("--conf", type=float, default=0.01)
    parser.add_argument("--nms", type=float, default=0.65)
    parser.add_argument("--out-dir", type=str, required=True)
    parser.add_argument("--no-eval", action="store_true", default=False)
    parser.add_argument("--fp32", action="store_true", default=False,
                        help="float32 modules (default: bf16 modules)")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--device-preproc", action="store_true", default=False,
                        help="0.5x downsample on the card (kernel B2)")
    return parser


def main(argv: Optional[Sequence[str]] = None,
         load_frame: Optional[Callable[[dict], np.ndarray]] = None) -> Dict:
    """Detect every frame as the command line says; returns
    ``results_ccf`` and the ``summary`` (None with ``--no-eval`` or no
    detections)."""
    args = make_parser().parse_args(argv)
    from streamyolo_torch.data import COCO
    from streamyolo_torch.stream import eval_ccf
    from streamyolo_torch.stream.online import imread_loader
    from streamyolo_torch.tools.sap_rehearsal import offline_ccf
    from streamyolo_torch.tools.stream_det import build_detector
    from streamyolo_torch.utils.device import resolve_device

    resolve_device(args.device)
    db = COCO(args.annot_path)
    img0 = next(iter(db.imgs.values()))
    input_size = (int(img0["height"] * args.in_scale), int(img0["width"] * args.in_scale))
    detector = build_detector(
        args.config, args.weights, input_size, fp32=args.fp32, device=args.device,
        in_scale=args.in_scale, conf_thre=args.conf, nms_thre=args.nms,
        device_preproc=args.device_preproc)

    results_ccf = offline_ccf(db, detector, load_frame or imread_loader(db, args.data_root))
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "results_ccf.pkl"), "wb") as f:
        pickle.dump(results_ccf, f)
    print(f"wrote {len(results_ccf)} detections")

    summary = None
    if not args.no_eval:
        summary = eval_ccf(db, results_ccf)
        if summary is not None:
            with open(os.path.join(args.out_dir, "eval_summary.pkl"), "wb") as f:
                pickle.dump(summary, f)
    return {"results_ccf": results_ccf, "summary": summary}


if __name__ == "__main__":
    main()
