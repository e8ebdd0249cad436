#!/usr/bin/env python3
"""One-command BASELINE validation of the port, the counterpart of
``tools/validate_baseline.py``: evaluate the five configs on the released
reference weights and diff the result against the published table.

    python -m streamyolo_torch.tools.validate_baseline \\
        --weights-dir /path/with/{s,m,l}_s50_one_x.pth \\
        --data-dir /path/containing/Argoverse-HD [--int8] [--device cpu]

Each row is the reference eval recipe through the port's eval CLI
(``streamyolo_torch/tools/eval.py``): ``--conf 0.01``, conv+BN fold
(``--no-fuse`` skips it), batch 64, a strict load of the ``.pth`` /
``.safetensors`` weights, the dual-frame forward. ``--int8`` evaluates the
int8 PTQ serving path instead (calibrated on ``--calib-batches`` val
batches). The table is printed and the exit code is 1 if any row lands
outside ``--tolerance`` sAP points (or failed), 2 for an unknown row.

Testability hooks: ``opts`` forwards ``key value`` overrides to every
config, ``--expected-json`` replaces the published table, ``--models``
selects rows, ``--weights NAME=PATH`` overrides weight files, and
``main(argv, load_frame)`` takes the frames from memory.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Callable, Optional, Sequence

import numpy as np

# name -> (config, released weight file, published (sAP, sAP50, sAP75))
BASELINE_ROWS = {
    "s": ("cfgs/s_s50_onex_dfp_tal_flip.py", "s_s50_one_x.pth", (29.8, 50.3, 29.8)),
    "m": ("cfgs/m_s50_onex_dfp_tal_flip.py", "m_s50_one_x.pth", (33.7, 54.5, 34.0)),
    "l": ("cfgs/l_s50_onex_dfp_tal_filp.py", "l_s50_one_x.pth", (36.9, 58.1, 37.5)),
    "l2x": ("cfgs/l_s50_twox_dfp_tal_flip.py", "l_s50_two_x.pth", (34.6, 56.3, 34.7)),
    "still": ("cfgs/l_s50_still_dfp_flip.py", "l_s50_still.pth", (39.4, 60.0, 40.2)),
}


def make_parser():
    p = argparse.ArgumentParser("streamyolo_torch baseline validation")
    p.add_argument("--weights-dir", required=True,
                   help="directory holding the released .pth files")
    p.add_argument("--data-dir", required=True,
                   help="directory containing Argoverse-HD/ and Argoverse-1.1/")
    p.add_argument("-b", "--batch-size", type=int, default=64)
    p.add_argument("--conf", type=float, default=0.01,
                   help="eval confidence threshold (reference recipe: 0.01)")
    p.add_argument("--tolerance", type=float, default=0.5,
                   help="max |sAP - published| in AP points before failing")
    p.add_argument("--no-fuse", action="store_true",
                   help="skip the conv+BN fold (the recipe fuses)")
    p.add_argument("--int8", action="store_true",
                   help="validate the int8 PTQ serving path instead of fp (expect a "
                        "small sAP drop: widen --tolerance)")
    p.add_argument("--calib-batches", type=int, default=8,
                   help="val batches observed by --int8 calibration")
    p.add_argument("--models", default=",".join(BASELINE_ROWS),
                   help=f"comma-separated subset of rows (of {','.join(BASELINE_ROWS)})")
    p.add_argument("--weights", default="", metavar="NAME=PATH[,NAME=PATH...]",
                   help="per-model weight-file overrides")
    p.add_argument("--expected-json", default=None,
                   help="JSON {name: [sAP, sAP50, sAP75]} replacing the published table")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("opts", nargs=argparse.REMAINDER,
                   help="Exp attribute overrides applied to every config")
    return p


def run_one(cfg: str, weight_path: str, args,
            load_frame: Optional[Callable[[dict], np.ndarray]] = None):
    """One row through the eval CLI; (sAP, sAP50, sAP75) in percent."""
    from streamyolo_torch.tools import eval as eval_tool

    argv = ["-f", cfg, "-c", weight_path, "-b", str(args.batch_size), "--conf",
            str(args.conf), "--no-dedup", "--device", args.device]
    if args.int8:
        argv += ["--int8", "--calib-batches", str(args.calib_batches)]
    elif not args.no_fuse:
        argv.append("--fuse")
    out = eval_tool.main(argv + list(args.opts) + ["data_dir", args.data_dir],
                         load_frame=load_frame)
    return 100 * out["ap"], 100 * out["ap50"], 100 * float(out["stats"][2])


def table(models, expected, results, tolerance):
    """(table text, failure messages) of the rows against the expected ones."""
    hdr = (f"{'model':<6} {'sAP':>7} {'pub':>6} {'diff':>7}   "
           f"{'sAP50':>7} {'pub':>6}   {'sAP75':>7} {'pub':>6}   status")
    lines, failures = [hdr, "-" * len(hdr)], []
    for name in models:
        pub, got = expected[name], results[name]
        if got is None:
            lines.append(f"{name:<6} {'—':>7} {pub[0]:>6.1f} {'—':>7}   {'—':>7} "
                         f"{pub[1]:>6.1f}   {'—':>7} {pub[2]:>6.1f}   ERROR")
            continue
        diff = got[0] - pub[0]
        ok = abs(diff) <= tolerance
        if not ok:
            failures.append(f"{name}: sAP {got[0]:.2f} vs published {pub[0]:.2f} "
                            f"(|diff| {abs(diff):.2f} > tolerance {tolerance})")
        lines.append(f"{name:<6} {got[0]:>7.2f} {pub[0]:>6.1f} {diff:>+7.2f}   "
                     f"{got[1]:>7.2f} {pub[1]:>6.1f}   {got[2]:>7.2f} {pub[2]:>6.1f}   "
                     f"{'OK' if ok else 'FAIL'}")
    return "\n".join(lines), failures


def main(argv: Optional[Sequence[str]] = None,
         load_frame: Optional[Callable[[dict], np.ndarray]] = None) -> int:
    """Validate as the command line says; returns the exit code.
    ``load_frame`` (image dict -> BGR uint8 frame) supplies the pixels."""
    from streamyolo_torch.utils.logger import get_logger

    args = make_parser().parse_args(argv)
    logger = get_logger()
    expected = {k: v[2] for k, v in BASELINE_ROWS.items()}
    if args.expected_json:
        with open(args.expected_json) as f:
            expected.update({k: tuple(v) for k, v in json.load(f).items()})
    models = [m for m in args.models.split(",") if m]
    unknown = [m for m in models if m not in BASELINE_ROWS]
    if unknown:
        logger.error("unknown model rows: %s (of %s)", unknown, list(BASELINE_ROWS))
        return 2
    overrides = dict(kv.split("=", 1) for kv in args.weights.split(",") if kv)

    results, failures = {}, []
    for name in models:
        cfg, weight_file, _ = BASELINE_ROWS[name]
        weight_path = overrides.get(name, os.path.join(args.weights_dir, weight_file))
        results[name] = None
        if not os.path.exists(weight_path):
            failures.append(f"{name}: missing weights {weight_path}")
            continue
        logger.info("=== %s: %s + %s", name, cfg, weight_path)
        try:
            results[name] = run_one(cfg, weight_path, args, load_frame)
        except Exception as e:  # a failed row must not mask the others
            logger.exception("row %s failed", name)
            failures.append(f"{name}: {type(e).__name__}: {e}")

    text, missed = table(models, expected, results, args.tolerance)
    failures += missed
    logger.info("BASELINE validation (conf %.3g, fuse=%s, int8=%s, b=%d):\n%s", args.conf,
                not args.no_fuse, args.int8, args.batch_size, text)
    print(text)
    for f in failures:
        logger.error("baseline validation failure: %s", f)
    if failures:
        return 1
    logger.info("all %d rows within %.2f sAP of the published table", len(models),
                args.tolerance)
    return 0


if __name__ == "__main__":
    sys.exit(main())
