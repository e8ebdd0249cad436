"""The readings that a cell's correctness limits are set from.

    python3 -m streambench.control --workload NAME [--seeds 12] [--control-seeds 3]
        [--seconds 2] [--first-seed N]

runs, in one process on the card, the cell's runner with a short window
(the cell's own load and sizes) over ``--seeds`` seeds with the program,
and over ``--control-seeds`` seeds with the control in the program's place:
the reference computed in float8 (``reference/control.py``). Prints one
JSON line: each seed's compared numbers, the program's largest (the lower
reading) and the control's smallest (the upper reading). The benchmark's
own runs never run the control.

``stand_in`` builds the reference as a system a runner can serve, for the
control and for the harness's tests.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from streambench import count, harness
from streambench.reference import postprocess
from streambench.reference.control import Fp8Ops
from streambench.reference.precision import float32_exact
from streambench.weights import as_float32


class ReferenceDetector:
    """The reference as a multi-camera detector: ``__call__(frames,
    preprocessed=True)``, ``last_rows``, ``reset()``, with the DFP buffer
    carried in float32."""

    def __init__(self, config: dict, state, device, cameras: int, ops):
        self.cfg, self.ops, self.device = config, ops, device
        self.model = count.model_of(config)
        self.p = as_float32(state)
        self.buffer = None
        self.last_rows = None

    def reset(self):
        self.buffer = None

    def __call__(self, frames, preprocessed: bool = True):
        x = torch.from_numpy(np.stack(frames)).to(self.device)
        m, p, cfg = self.model, self.p, self.cfg
        with float32_exact():
            cur = m.pafpn(p, self.ops, m.frames_in(x))
            sup = cur if self.buffer is None else self.buffer
            pred = m.detect(p, self.ops, m.fuse(p, self.ops, cur, sup))
            rows = postprocess.detections(pred, cfg["num_classes"], cfg["conf_thre"],
                                          cfg["nms_thre"], cfg["pre_nms_topk"])
        self.buffer = cur
        self.last_rows = rows.cpu().numpy()
        return [None] * len(frames)


def stand_in(kind: str, ops):
    """A ``system`` for the runner ``kind`` that serves the reference
    computed with ``ops``."""
    if kind == "cameras":
        return lambda cfg, state, device, n: ReferenceDetector(cfg, state, device, n, ops)
    raise ValueError(f"no stand-in for the runner {kind!r}")


def readings(cell, seeds, seconds: float, device, system=None):
    run_kind = harness.runner(cell.traffic["kind"])
    out = []
    for seed in seeds:
        t = time.perf_counter()
        rec = run_kind.run(cell, seed, seconds, False, device, time.perf_counter(), system)
        out.append({"seed": seed, **rec["readings"], "seconds": time.perf_counter() - t})
        print(json.dumps(out[-1]), file=sys.stderr, flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--first-seed", type=int, default=3_000_000_000)
    args = p.parse_args(argv)
    cell = harness.load_cell(harness.load_json(harness.ROOT / "BENCHMARK.json"), args.workload)
    harness.require_cards(cell.workload["chips"])
    device = torch.device("cuda", 0)
    kind = cell.traffic["kind"]
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds + args.control_seeds)]
    program = readings(cell, seeds[:args.seeds], args.seconds, device)
    control = readings(cell, seeds[args.seeds:], args.seconds, device, stand_in(kind, Fp8Ops()))
    result = {"workload": args.workload, "program": program, "control": control}
    names = [k for k in program[0] if k not in ("seed", "seconds")]
    result["lower"] = {k: max(r[k] for r in program) for k in names}
    result["upper"] = {k: min(r[k] for r in control) for k in names}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
