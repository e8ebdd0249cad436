#!/usr/bin/env python3
"""Aggregate streaming-eval outputs of several run directories into a CSV:
the port's counterpart of ``tools/collect_summary.py``.

    python -m streamyolo_torch.tools.collect_summary RUN1 RUN2 ... [--out summary.csv]
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Sequence


def make_parser():
    parser = argparse.ArgumentParser("streamyolo_torch summary aggregation")
    parser.add_argument("dirs", nargs="+", help="experiment output directories")
    parser.add_argument("--out", default="summary.csv")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    """Write the CSV as the command line says; returns its rows."""
    args = make_parser().parse_args(argv)
    from streamyolo_torch.stream.collect_summary import collect_summary

    rows = collect_summary(args.dirs, args.out)
    print(f"wrote {len(rows)} rows to {args.out}")
    return rows


if __name__ == "__main__":
    main()
