#!/usr/bin/env python3
"""Post-hoc Kalman forecasting over a saved streaming run, then sAP: the
port's counterpart of ``tools/forecast_kf.py``.

    python -m streamyolo_torch.tools.forecast_kf --annot-path val.json \\
        --in-dir RUN --out-dir OUT [--fps 30] [--eta 0] [--match-iou-th 0.3]

Writes ``results_ccf.pkl`` and, unless ``--no-eval``, ``eval_summary.pkl``.
Host only.
"""

from __future__ import annotations

import argparse
import os
import pickle
from typing import Dict, Optional, Sequence


def make_parser():
    parser = argparse.ArgumentParser("streamyolo_torch post-hoc KF forecasting")
    parser.add_argument("--annot-path", type=str, required=True)
    parser.add_argument("--in-dir", type=str, required=True,
                        help="streaming run dir (per-sequence pkls)")
    parser.add_argument("--out-dir", type=str, required=True)
    parser.add_argument("--fps", type=float, default=30)
    parser.add_argument("--eta", type=int, default=0)
    parser.add_argument("--match-iou-th", type=float, default=0.3)
    parser.add_argument("--no-eval", action="store_true", default=False)
    return parser


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Forecast and score as the command line says; returns
    ``results_ccf``, ``assoc`` and the ``summary`` (None with ``--no-eval``
    or no boxes)."""
    args = make_parser().parse_args(argv)
    from streamyolo_torch.data import COCO
    from streamyolo_torch.stream import eval_ccf
    from streamyolo_torch.stream.forecast import forecast_results

    db = COCO(args.annot_path)
    results_by_seq = {}
    for seq in db.dataset["sequences"]:
        with open(os.path.join(args.in_dir, seq + ".pkl"), "rb") as f:
            results_by_seq[seq] = pickle.load(f)

    results_ccf, assoc = forecast_results(db, results_by_seq, fps=args.fps, eta=args.eta,
                                          match_iou_th=args.match_iou_th)
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "results_ccf.pkl"), "wb") as f:
        pickle.dump(results_ccf, f)
    print(f"forecast results: {len(results_ccf)} boxes, {assoc}")

    summary = None
    if not args.no_eval:
        summary = eval_ccf(db, results_ccf)
        if summary is not None:
            with open(os.path.join(args.out_dir, "eval_summary.pkl"), "wb") as f:
                pickle.dump(summary, f)
            s = summary["stats"]
            print(f"forecasted sAP: {s[0]*100:.1f} sAP50: {s[1]*100:.1f} "
                  f"sAP75: {s[2]*100:.1f}")
    return {"results_ccf": results_ccf, "assoc": assoc, "summary": summary}


if __name__ == "__main__":
    main()
