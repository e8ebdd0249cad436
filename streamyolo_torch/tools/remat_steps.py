"""The rematerialised train step against the plain step, on one NVIDIA GPU.

    python -m streamyolo_torch.tools.remat_steps [--batch 8]
        [--depth 0.33 --width 0.5] [--input 600 960] [--device cpu]

From one seeded state of StreamYOLO-s (``train_sweep.train_setup``:
float32 master weights, bf16 autocast; the step counter at ``STEP``, the
end of the schedule's warm-up, so the LR is not 0), each from its own copy
of that state and with cuDNN's autotuner on as ``train_sweep`` has it: a
plain step, a second plain step, and the step of ``make_train_step(...,
remat=True)``.

Each step is held to the first plain step over the metrics, the state dict
(weights, BatchNorm statistics, ``num_batches_tracked``), the parameters'
gradients, momentum and EMA: the tensors that differ, the largest gap
relative to its tensor's largest magnitude, the tensors whose largest gap
exceeds the second plain step's (``above_plain_gap``), the running
statistics and counts that differ (``stats_differ``), and the step's peak
memory (``torch.cuda.max_memory_allocated`` after
``reset_peak_memory_stats``, the earlier steps' tensors freed). Prints ONE
JSON line. Runs on ``cuda``; raises without a card unless ``--device
cpu``, where the memory figures are null.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

import torch

from streamyolo_torch.tools import train_sweep
from streamyolo_torch.tools.measure import card, sync
from streamyolo_torch.utils.device import resolve_device

STEP = 100  # train_sweep's schedule ends its warm-up here (1 epoch of 100)
STATS = ("running_mean", "running_var", "num_batches_tracked")


def run_step(kind: str, batch: int, device, depth, width, size) -> dict:
    """One step of ``kind`` (``plain`` or ``remat``) from the seeded
    state; returns its tensors on the CPU and its peak memory."""
    _, step, state, data = train_sweep.train_setup(batch, device, depth, width, size,
                                                   remat=kind == "remat")
    model = state.model
    state.step = STEP
    cuda = device.type == "cuda"
    with train_sweep.cudnn_autotuned():
        sync(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        metrics = step(state, data)
        sync(device)
    names = {id(p): n for n, p in model.named_parameters()}
    out = {"metrics": {k: torch.as_tensor(v).detach().cpu() for k, v in metrics.items()},
           "model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
           "grad": {n: p.grad.cpu() for n, p in model.named_parameters()},
           "momentum": {names[id(p)]: s["momentum_buffer"].cpu()
                        for p, s in state.optimizer.state.items()},
           "ema": {k: v.cpu() for k, v in state.ema.state.items()},
           "peak_memory_gb": torch.cuda.max_memory_allocated(device) / 1e9 if cuda else None}
    del step, state, data, model
    if cuda:
        torch.cuda.empty_cache()
    return out


def gaps(ref: dict, other: dict) -> dict:
    """``other``'s largest gap to ``ref``, per tensor."""
    return {f"{part}.{k}": float((other[part][k].double() - v.double()).abs().max())
            for part in ("metrics", "model", "grad", "momentum", "ema")
            for k, v in ref[part].items()}


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--depth", type=float, default=0.33)
    p.add_argument("--width", type=float, default=0.5)
    p.add_argument("--input", type=int, nargs=2, default=train_sweep.INPUT, metavar=("H", "W"))
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    kinds = ["plain", "plain_again", "remat"]
    steps = {k: run_step(k.removesuffix("_again"), args.batch, device, args.depth, args.width,
                         tuple(args.input)) for k in kinds}
    plain = steps["plain"]
    plain_gap = gaps(plain, steps["plain_again"])
    result = {"device": card(device), "batch": args.batch, "input": list(args.input),
              "tensors": len(plain_gap), "steps": {}}
    for kind in kinds[1:]:
        gap = gaps(plain, steps[kind])
        rel = {k: g / max(float(plain[k.split(".")[0]][k.split(".", 1)[1]].double().abs().max()),
                          1e-30) for k, g in gap.items()}
        above = sorted((k for k in gap if gap[k] > plain_gap[k]), key=lambda k: -rel[k])
        worst = max(rel, key=rel.get)
        result["steps"][kind] = {
            "differ": sum(g > 0 for g in gap.values()), "worst_rel": rel[worst], "worst": worst,
            "above_plain_gap": len(above), "above_plain_gap_first": above[:5],
            "stats_differ": [k for k in gap if k.startswith("model.") and k.endswith(STATS)
                             and gap[k] > 0],
            "total_loss": float(steps[kind]["metrics"]["total_loss"]),
            "peak_memory_gb": steps[kind]["peak_memory_gb"]}
    result["plain"] = {"total_loss": float(plain["metrics"]["total_loss"]),
                       "lr": float(plain["metrics"]["lr"]),
                       "peak_memory_gb": plain["peak_memory_gb"]}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
