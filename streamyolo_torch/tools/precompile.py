#!/usr/bin/env python3
"""Build the port's kernels and export its serving graphs, the counterpart
of ``tools/precompile.py``.

    python -m streamyolo_torch.tools.precompile -f cfgs/l_s50_onex_dfp_tal_filp.py \\
        [--serve DIR [--streams N]] [-b 8] [--train [--train-batch 4]] [--device cpu] [opts]

Builds every kernel of ``ops/_build.SOURCES`` (one ``nvcc`` each, all at
once, cached by content under ``build/kernels/``) and prints each build's
seconds. ``--serve DIR`` exports the serving artifacts of
``CUDAStreamDetector`` at the config's ``test_size`` and the serving
thresholds (``--conf``, ``--nms``, ``--topk``), for the host path and for
``device_preproc`` (raw frames of twice the size, kernel B2): per
configuration the graph manifests and the kernel libraries
(``stream/online.py::export_stream_executables``); ``--streams N`` also
those of the N-stream ``MultiStreamDetector``. A detector (or
``stream_det --aot-dir DIR``) of the same configuration then loads the
libraries instead of running ``nvcc`` and captures its graphs at
construction. Then it runs the offline-eval forward at ``-b`` and, with
``--train``, one train step at ``--train-batch``, as a check that they run.
The model carries the config's seeded weights (the artifacts depend on the
shapes only). Modules are bf16 (``--fp16``, always on, as in the JAX tool).
Trailing ``key value`` pairs override the config (``depth 0.33``). Runs on
``cuda`` unless ``--device cpu``, where no kernel is built (the CPU runs
their plain versions) and the exported steps run uncaptured.

Unlike XLA, torch keeps no cache of compiled programs or of cuDNN's
algorithm choices across processes: the kernel libraries are the only
artifacts a later process reuses; the graphs are captured again in it.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np

def make_parser():
    parser = argparse.ArgumentParser("streamyolo_torch kernel build and graph export")
    parser.add_argument("-f", "--exp_file", required=True)
    parser.add_argument("-b", "--batch-size", type=int, default=8,
                        help="offline eval batch size to run")
    parser.add_argument("--train", action="store_true", default=False,
                        help="also run one train step")
    parser.add_argument("--train-batch", type=int, default=4)
    parser.add_argument("--fp16", action="store_true", default=True)
    parser.add_argument("--serve", metavar="AOT_DIR", default=None,
                        help="export the CUDAStreamDetector graph manifests and kernel "
                             "libraries (host path and device_preproc) under AOT_DIR")
    parser.add_argument("--conf", type=float, default=0.01,
                        help="serving conf threshold (detector default)")
    parser.add_argument("--nms", type=float, default=0.65,
                        help="serving NMS threshold (detector default)")
    parser.add_argument("--topk", type=int, default=200,
                        help="serving pre-NMS top-k (detector default)")
    parser.add_argument("--streams", type=int, default=0,
                        help="with --serve: also export the MultiStreamDetector "
                             "artifacts for N streams")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER,
                        help="config overrides as key value pairs")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run as the command line says. Returns ``{"builds": {source:
    seconds}, "serve": [manifest paths], "seconds": {part: seconds}}``."""
    args = make_parser().parse_args(argv)
    import torch

    from streamyolo_torch.exp import get_exp
    from streamyolo_torch.ops import _build
    from streamyolo_torch.ops.nms import postprocess_fixed
    from streamyolo_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    exp = get_exp(args.exp_file)
    exp.merge(args.opts)
    if args.fp16:
        exp.compute_dtype = "bfloat16"
    out = {"builds": {}, "serve": [], "seconds": {}}

    if device.type == "cuda":
        t0 = time.perf_counter()
        report = _build.build_all()
        out["builds"] = {name: r["seconds"] for name, r in report.items()}
        for name, r in report.items():
            print(f"kernel {name}: {'cached' if r['log'] == 'cached' else 'built'} in "
                  f"{r['seconds']:.1f}s -> {r['path']}")
        out["seconds"]["build"] = time.perf_counter() - t0
    else:
        print("kernels: none built (the CPU runs their plain versions)")
    print("torch keeps no cross-process cache of cuDNN's algorithm choices or of captured "
          "graphs: the kernel libraries are the only artifacts a later process reuses")

    model = exp.get_model(device)
    model.load_state_dict(exp.init_model())
    h, w = exp.test_size
    serve_kw = dict(input_size=(h, w), conf_thre=args.conf, nms_thre=args.nms,
                    num_classes=exp.num_classes, pre_nms_topk=args.topk,
                    use_bf16=args.fp16, device=device)

    if args.serve:
        from streamyolo_torch.stream import (export_multi_stream_executables,
                                             export_stream_executables)

        for device_preproc in (False, True):
            t0 = time.perf_counter()
            paths = export_stream_executables(model, args.serve, device_preproc=device_preproc,
                                              **serve_kw)
            name = "serve_device_preproc" if device_preproc else "serve"
            out["seconds"][name] = time.perf_counter() - t0
            out["serve"] += list(paths)
            print(f"serving graphs ({'device_preproc' if device_preproc else 'host path'}) "
                  f"exported in {out['seconds'][name]:.1f}s:\n  " + "\n  ".join(paths))
        if args.streams:
            t0 = time.perf_counter()
            paths = export_multi_stream_executables(model, args.serve, n_streams=args.streams,
                                                    **serve_kw)
            out["seconds"]["serve_multi"] = time.perf_counter() - t0
            out["serve"] += list(paths)
            print(f"{args.streams}-stream graphs exported in "
                  f"{out['seconds']['serve_multi']:.1f}s:\n  " + "\n  ".join(paths))

    t0 = time.perf_counter()
    ch = 6 if exp.dataset_name in ("one", "two") else 3
    forward = exp.get_forward_fn(model)
    dets = postprocess_fixed(forward(np.zeros((args.batch_size, h, w, ch), np.uint8)),
                             exp.num_classes, exp.test_conf, exp.nmsthre)
    dets.cpu()
    out["seconds"]["eval_forward"] = time.perf_counter() - t0
    print(f"offline eval b={args.batch_size} ran in {out['seconds']['eval_forward']:.1f}s")

    if args.train:
        from streamyolo_torch.train.step import create_train_state, make_train_step

        t0 = time.perf_counter()
        tmodel = exp.get_model(device, dtype=torch.float32)
        tmodel.load_state_dict(exp.init_model())
        b = args.train_batch
        state = create_train_state(tmodel, exp.momentum, exp.weight_decay)
        step = make_train_step(
            exp.num_classes, exp.get_lr_schedule(b, 100), gamma=exp.tal_gamma,
            ignore_thr=exp.tal_ignore_thr, ignore_value=exp.tal_ignore_value,
            use_tal=exp.head_name == "tal", fp16=args.fp16)
        labels = np.zeros((b, 120, 5), np.float32)
        labels[:, 0] = [2.0, w / 2, h / 2, 30.0, 20.0]
        batch = {"images": torch.zeros((b, h, w, ch), dtype=torch.uint8, device=device),
                 "labels": torch.from_numpy(labels).to(device),
                 "support_labels": torch.from_numpy(labels).to(device)}
        float(step(state, batch)["total_loss"])
        out["seconds"]["train_step"] = time.perf_counter() - t0
        print(f"train step b={b} ran in {out['seconds']['train_step']:.1f}s")
    return out


if __name__ == "__main__":
    main()
