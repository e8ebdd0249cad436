"""Aggregate streaming-eval outputs of several runs into one CSV: the port's
own copy of ``streamyolo_tpu/stream/collect_summary.py``.

Each run directory's ``eval_summary.pkl`` (the sAP stats) and
``time_info.pkl`` (the runtimes) become one CSV row.
"""

from __future__ import annotations

import csv
import os
import pickle
from typing import List, Optional

import numpy as np

FIELDS = [
    "name", "sAP", "sAP50", "sAP75", "sAP_S", "sAP_M", "sAP_L",
    "runtime_mean_ms", "runtime_std_ms", "n_processed", "n_total",
    "pct_realtime",
]
STAT_FIELDS = ("sAP", "sAP50", "sAP75", "sAP_S", "sAP_M", "sAP_L")


def collect_one(exp_dir: str, name: Optional[str] = None) -> Optional[dict]:
    """One run's row, or None if the directory holds neither file."""
    row = {k: "" for k in FIELDS}
    row["name"] = name or os.path.basename(os.path.normpath(exp_dir))
    found = False

    summary_path = os.path.join(exp_dir, "eval_summary.pkl")
    if os.path.isfile(summary_path):
        with open(summary_path, "rb") as f:
            summary = pickle.load(f)
        stats = summary["stats"] if isinstance(summary, dict) else summary
        for idx, key in enumerate(STAT_FIELDS):
            row[key] = round(float(stats[idx]) * 100, 2)
        found = True

    time_path = os.path.join(exp_dir, "time_info.pkl")
    if os.path.isfile(time_path):
        with open(time_path, "rb") as f:
            ti = pickle.load(f)
        rt = np.asarray(ti.get("runtime_all", []))
        if len(rt):
            row["runtime_mean_ms"] = round(float(rt.mean() * 1e3), 2)
            row["runtime_std_ms"] = round(float(rt.std(ddof=1) * 1e3), 2)
        row["n_processed"] = ti.get("n_processed", "")
        row["n_total"] = ti.get("n_total", "")
        if ti.get("n_processed"):
            row["pct_realtime"] = round(
                100.0 * ti.get("n_small_runtime", 0) / ti["n_processed"], 2)
        found = True
    return row if found else None


def collect_summary(exp_dirs: List[str], out_csv: str) -> List[dict]:
    """Write the rows of ``exp_dirs`` (those with results) to ``out_csv``."""
    rows = [r for r in (collect_one(d) for d in exp_dirs) if r is not None]
    with open(out_csv, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=FIELDS)
        writer.writeheader()
        writer.writerows(rows)
    return rows
