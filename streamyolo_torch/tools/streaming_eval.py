#!/usr/bin/env python3
"""Streaming (sAP) evaluation CLI of the port, the counterpart of
``tools/streaming_eval.py``: pair the timestamped detections of a
``stream_det`` run with the ground truth and COCO-evaluate them.

    python -m streamyolo_torch.tools.streaming_eval --annot-path val.json \\
        --result-dir OUT [--out-dir DIR] [--fps 30] [--eta 0]

Writes ``results_ccf.pkl``, ``eval_assoc.pkl`` and ``eval_summary.pkl`` to
``--out-dir`` (default: the result directory). Host only.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def make_parser():
    parser = argparse.ArgumentParser("streamyolo_torch streaming eval")
    parser.add_argument("--annot-path", type=str, required=True)
    parser.add_argument("--result-dir", type=str, required=True)
    parser.add_argument("--out-dir", type=str, default=None)
    parser.add_argument("--fps", type=float, default=30)
    parser.add_argument("--eta", type=int, default=0, help="evaluation offset (frames)")
    parser.add_argument("--overwrite", action="store_true", default=False)
    parser.add_argument("--no-eval", action="store_true", default=False,
                        help="accepted for compatibility; changes nothing")
    return parser


def main(argv: Optional[Sequence[str]] = None):
    """Pair and score as the command line says; returns (eval_summary,
    assoc)."""
    args = make_parser().parse_args(argv)
    from streamyolo_torch.data import COCO
    from streamyolo_torch.stream import streaming_eval

    return streaming_eval(COCO(args.annot_path), args.result_dir, fps=args.fps, eta=args.eta,
                          out_dir=args.out_dir, overwrite=args.overwrite)


if __name__ == "__main__":
    main()
