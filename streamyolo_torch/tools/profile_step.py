"""Where the time of the streaming step goes on the card.

    python -m streamyolo_torch.tools.profile_step [--steps 20] [--trace out.json]

Builds StreamYOLO-l (bf16 modules, seeded LeCun-normal weights, obj/cls
prediction biases 0, as ``chip_smoke.py``) and serves 600x960 frames
through ``CUDAStreamDetector`` (host path, conf 0.01, NMS 0.65, top-k 200).
After a warmup it traces ``--steps`` steady steps with ``torch.profiler``
and prints one JSON line: wall ms per step, the card's busy time per step
(sum of kernel times; one stream, so kernels do not overlap), the idle
share, kernel launches per step, and the kernels that take the most time.
It then times the same steps once more with cuDNN's autotuner on, to show
how much of the step the default convolution algorithms cost.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from streamyolo_torch.models import build_streamyolo
from streamyolo_torch.stream import CUDAStreamDetector


def _kernel_stats(prof) -> tuple:
    """(total kernel µs, kernel count, [(name, µs, count)] by time) of a trace."""
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(evt, "self_device_time_total", None)
        if t is None:
            t = evt.self_cuda_time_total
        rows.append((evt.key, float(t), int(evt.count)))
    rows.sort(key=lambda r: -r[1])
    return sum(r[1] for r in rows), sum(r[2] for r in rows), rows


def _wall_ms(det, frames, steps) -> float:
    times = []
    for i in range(steps):
        t = time.perf_counter()
        det(frames[i % len(frames)], preprocessed=True)
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--trace", type=str, default=None, help="write a chrome trace here")
    args = p.parse_args()

    model = build_streamyolo("l", 8, dtype=torch.bfloat16, device="cuda",
                             generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for m in list(model.head.obj_preds) + list(model.head.cls_preds):
            m.bias.zero_()
    det = CUDAStreamDetector(model, input_size=(600, 960), conf_thre=0.01,
                             nms_thre=0.65, pre_nms_topk=200, use_bf16=True)
    rng = np.random.RandomState(0)
    frames = [rng.randint(0, 256, (600, 960, 3), np.uint8) for _ in range(4)]
    det.warmup(5)
    det(frames[0], preprocessed=True)  # star; the traced steps are steady

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(args.steps):
            det(frames[i % len(frames)], preprocessed=True)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    if args.trace:
        prof.export_chrome_trace(args.trace)
    busy_us, n_kernels, rows = _kernel_stats(prof)

    wall_default = _wall_ms(det, frames, 50)
    torch.backends.cudnn.benchmark = True
    det.warmup(5)
    det(frames[0], preprocessed=True)
    wall_autotuned = _wall_ms(det, frames, 50)
    torch.backends.cudnn.benchmark = False

    busy_ms = busy_us / 1e3 / args.steps
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "steps": args.steps,
        "traced_wall_ms_per_step": traced_ms,
        "device_busy_ms_per_step": busy_ms,
        "idle_share": 1.0 - busy_ms / traced_ms,
        "kernels_per_step": n_kernels / args.steps,
        "top_kernels": [
            {"name": name[:80], "ms_per_step": t / 1e3 / args.steps, "per_step": c / args.steps}
            for name, t, c in rows[:8]],
        "wall_ms_median_cudnn_default": wall_default,
        "wall_ms_median_cudnn_benchmark": wall_autotuned,
    }))


if __name__ == "__main__":
    main()
