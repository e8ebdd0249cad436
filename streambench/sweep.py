"""The knee of an open-loop camera cell: the most cameras the port serves
at the cell's frame rate without a growing backlog.

    python3 -m streambench.sweep --workload NAME --cameras 12 16 20 ... [--seconds 20]

For each camera count it runs the cell's runner (``kinds/cameras.py``)
with that count in place of the cell's, for ``--seconds``, without the
correctness check, and prints one JSON line per count: the latency's
median, 95th percentile and maximum, the share of ticks that started over
1 ms late, the last second's median latency, and whether the count
``holds``: the last second's ticks started on time (at most 10 % over
1 ms late) and its median latency is under one frame period. The knee is
the largest count that holds; a camera cell serves 0.8 of it or less.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from streambench import harness
from streambench.kinds import cameras


def point(cell, n: int, seconds: float, seed: int, device) -> dict:
    sized = dataclasses.replace(cell, traffic={**cell.traffic, "cameras": n})
    check = cameras.check
    cameras.check = lambda *a, **k: {}  # the knee is a matter of time alone
    try:
        rec = cameras.run(sized, seed, seconds, False, device, time.perf_counter())
    finally:
        cameras.check = check
    lat = rec["frame_latency_s"][::n]  # one entry per tick
    fps = cell.traffic["fps"]
    last = lat[-int(fps):]
    late = rec["late_s"]
    last_late = late[-int(fps):]
    holds = bool((last_late > 1e-3).mean() <= 0.1 and np.median(last) < 1.0 / fps)
    return {"cameras": n, "median_ms": float(np.median(lat) * 1e3),
            "p95_ms": float(np.percentile(lat, 95) * 1e3), "max_ms": float(lat.max() * 1e3),
            "late_share": float((late > 1e-3).mean()),
            "last_second_median_ms": float(np.median(last) * 1e3),
            "frames_per_s": rec["frames_done"] / rec["rate_window_s"], "holds": holds,
            "memory_peak_bytes": rec["memory_peak_bytes"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--cameras", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=2_500_000_000)
    args = p.parse_args(argv)
    cell = harness.load_cell(harness.load_json(harness.ROOT / "BENCHMARK.json"), args.workload)
    harness.require_cards(cell.workload["chips"])
    device = torch.device("cuda", 0)
    points = []
    for n in args.cameras:
        points.append(point(cell, n, args.seconds, args.seed, device))
        print(json.dumps(points[-1]), flush=True)
        torch.cuda.empty_cache()
    held = [q["cameras"] for q in points if q["holds"]]
    print(json.dumps({"workload": args.workload, "knee": max(held) if held else None,
                      "device": harness.device_info(device, 1), "points": points}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
