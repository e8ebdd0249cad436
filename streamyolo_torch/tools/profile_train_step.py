"""Where the time of a train step goes on the card.

    python -m streamyolo_torch.tools.profile_train_step [--batch 8] [--steps 5]
        [--size 600 960] [--float32] [--trace out.json]

Builds StreamYOLO-l through the ``l_s50_onex_dfp_tal_filp`` config (float32
master weights, seeded init, channels_last) and trains on one fixed batch of
random 6-channel uint8 frames with 10 synthetic boxes per image, bf16
autocast unless ``--float32``. After 3 warm steps it times ``--steps``
steady steps phase by phase with CUDA events (forward, assignment + loss,
backward, SGD, EMA), then traces as many with ``torch.profiler`` and prints
one JSON line: wall ms per step (host clock, synchronised), each phase's
device ms, the card's busy time per step (the sum of kernel times; one
stream), the idle share, kernel launches per step, peak device memory, and
the kernels that take the most time.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from streamyolo_torch.exp import get_exp
from streamyolo_torch.models.losses import streamyolo_losses
from streamyolo_torch.tools.profile_step import _kernel_stats
from streamyolo_torch.train import build_lr_schedule, create_train_state

PHASES = ("forward", "assign_loss", "backward", "sgd", "ema")


def _batch(batch: int, size, seed: int = 0):
    rng = np.random.RandomState(seed)
    h, w = size
    labels = np.zeros((batch, 120, 5), np.float32)
    labels[:, :10, 0] = rng.randint(0, 8, (batch, 10))
    labels[:, :10, 1] = rng.uniform(0.1, 0.9, (batch, 10)) * w
    labels[:, :10, 2] = rng.uniform(0.1, 0.9, (batch, 10)) * h
    labels[:, :10, 3:5] = rng.uniform(0.03, 0.25, (batch, 10, 2)) * h
    support = labels.copy()
    support[:, :10, 1:3] += rng.normal(0, 2, (batch, 10, 2)).astype(np.float32)
    images = rng.randint(0, 256, (batch, h, w, 6), np.uint8)
    return {k: torch.from_numpy(v).cuda() for k, v in
            (("images", images), ("labels", labels), ("support_labels", support))}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--size", type=int, nargs=2, default=(600, 960))
    p.add_argument("--float32", action="store_true", help="no bf16 autocast (TF32 off)")
    p.add_argument("--trace", type=str, default=None, help="write a chrome trace here")
    args = p.parse_args()

    fp16 = not args.float32
    if not fp16:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = True  # as the trainer
    exp = get_exp(exp_name="l_s50_onex_dfp_tal_filp")
    model = exp.get_model("cuda", dtype=torch.float32)
    model.load_state_dict(exp.init_model())
    state = create_train_state(model, exp.momentum, exp.weight_decay)
    lr = build_lr_schedule("constant", exp.basic_lr_per_img * args.batch, 10, 10)
    batch = _batch(args.batch, args.size)

    def step(events=None):
        mark = (lambda i: events[i].record()) if events else (lambda i: None)
        mark(0)
        for g in state.optimizer.param_groups:
            g["lr"] = lr(state.step)
        with torch.autocast("cuda", dtype=torch.bfloat16, enabled=fp16):
            outputs = model(batch["images"], mode="off_pipe")
        mark(1)
        losses = streamyolo_losses(outputs, batch["labels"], batch["support_labels"],
                                   exp.num_classes, gamma=exp.tal_gamma,
                                   ignore_thr=exp.tal_ignore_thr,
                                   ignore_value=exp.tal_ignore_value)
        mark(2)
        state.optimizer.zero_grad(set_to_none=True)
        losses["total_loss"].backward()
        mark(3)
        state.optimizer.step()
        mark(4)
        state.step += 1
        state.ema.update(state.step)
        mark(5)

    model.train()
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    phase_ms = {k: [] for k in PHASES}
    walls = []
    for _ in range(args.steps):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        t = time.perf_counter()
        step(events)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
        for i, k in enumerate(PHASES):
            phase_ms[k].append(events[i].elapsed_time(events[i + 1]))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    if args.trace:
        prof.export_chrome_trace(args.trace)
    busy_us, n_kernels, rows = _kernel_stats(prof)
    busy_ms = busy_us / 1e3 / args.steps
    wall = statistics.median(walls)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "model": "StreamYOLO-l", "batch": args.batch, "size": list(args.size),
        "dtype": "bf16 autocast" if fp16 else "float32 (TF32 off)", "steps": args.steps,
        "wall_ms_per_step": wall, "images_per_s": args.batch * 1e3 / wall,
        "phase_device_ms": {k: statistics.median(v) for k, v in phase_ms.items()},
        "traced_wall_ms_per_step": traced_ms,
        "device_busy_ms_per_step": busy_ms,
        "idle_share": 1.0 - busy_ms / traced_ms,
        "kernels_per_step": n_kernels / args.steps,
        "peak_device_memory_gb": peak_gb,
        "top_kernels": [
            {"name": name[:80], "ms_per_step": t / 1e3 / args.steps, "per_step": c / args.steps}
            for name, t, c in rows[:12]],
    }))


if __name__ == "__main__":
    main()
