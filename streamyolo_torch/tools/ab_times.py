"""Time kernels B1 and B2 and the serving step of one checkout on one
NVIDIA GPU.

    python streamyolo_torch/tools/ab_times.py [--root DIR]

Imports ``streamyolo_torch`` from ``--root`` (default: the checkout this file
lies in), builds that checkout's kernels and times them, so two checkouts can
be compared in one call on one card, in turns, one process each::

    for r in OLD . . OLD; do python streamyolo_torch/tools/ab_times.py --root $r; done

Shapes: B1 at K = 200 with every candidate valid (as at serving), B = 1 and
B = 56 (self-test boxes, threshold 0.65); B2 at 1200x1920 -> 600x960 bf16
fused, ten frames in turn (69 MB, more than the 50 MB L2). Each is timed the
two ways of ``chip_smoke.py``: one call between two events after a sleep, and
a run of calls back to back divided by the count; ``floor`` is a one-element
torch kernel timed both ways. The step is ``chip_smoke.py``'s: StreamYOLO-l
at 600x960 bf16, random weights from seed 0, host path and
``device_preproc``, wall clock of 50 steady ``CUDAStreamDetector`` calls
(median). Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import itertools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

OWN_ROOT = Path(__file__).resolve().parents[2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(OWN_ROOT), help="checkout whose kernels are timed")
    args = ap.parse_args()

    sys.path.insert(0, str(OWN_ROOT))
    import numpy as np
    import torch

    from chip_smoke import (INPUT, NCLS, SEED, STEADY_STEPS, lift_pred_biases, nms_case,
                            time_back_to_back, time_cuda)

    if not torch.cuda.is_available():
        print("ab_times: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    import streamyolo_torch
    from streamyolo_torch.models import build_streamyolo
    from streamyolo_torch.ops import _build
    from streamyolo_torch.ops.nms_cuda import nms_keep
    from streamyolo_torch.ops.preproc import downsample2x
    from streamyolo_torch.stream import CUDAStreamDetector

    report = _build.build_all()
    dev = torch.device("cuda")
    one = torch.zeros(1, device=dev)
    times = {"floor": {"single": time_cuda(lambda: one.add_(1), 200, device_only=True),
                       "back_to_back": time_back_to_back(lambda: one.add_(1))}}
    for b in (1, 56):
        cases = [nms_case(200, seed=s) for s in range(b)]
        boxes = torch.from_numpy(np.stack([c[0] for c in cases])).to(dev)
        valid = torch.ones(boxes.shape[:2], dtype=torch.bool, device=dev)
        times[f"b1_B{b}"] = {
            "single": time_cuda(lambda: nms_keep(boxes, valid, 0.65), 200, device_only=True),
            "back_to_back": time_back_to_back(lambda: nms_keep(boxes, valid, 0.65))}
    rng = np.random.RandomState(0)
    pool = itertools.cycle([torch.from_numpy(rng.randint(0, 256, (1200, 1920, 3), np.uint8))
                            .to(dev) for _ in range(10)])

    def b2():
        return downsample2x(next(pool), out_dtype=torch.bfloat16, fused=True)

    times["b2"] = {"single": time_cuda(b2, 200, device_only=True),
                   "back_to_back": time_back_to_back(b2)}

    model = build_streamyolo("l", NCLS, dtype=torch.bfloat16, device=dev,
                             generator=torch.Generator().manual_seed(SEED))
    lift_pred_biases(model)
    step = {}
    for name, scale in (("host", 1), ("device_preproc", 2)):
        frames = [rng.randint(0, 256, (scale * INPUT[0], scale * INPUT[1], 3), np.uint8)
                  for _ in range(4)]
        det = CUDAStreamDetector(model, input_size=INPUT, in_scale=0.5, use_bf16=True,
                                 device_preproc=name == "device_preproc")
        det.warmup(3)
        wall = []
        for i in range(1 + STEADY_STEPS):
            t = time.perf_counter()
            det(frames[i % len(frames)], preprocessed=name == "host")
            wall.append((time.perf_counter() - t) * 1e3)
        step[name + "_wall_ms"] = statistics.median(wall[1:])  # steady steps
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    ptxas = {n: [ln.strip() for ln in r["log"].splitlines() if "registers" in ln]
             for n, r in report.items()}
    print(json.dumps({"root": args.root, "package": streamyolo_torch.__file__,
                      "nvidia_smi": smi, "ms": times, "step": step, "ptxas": ptxas}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
