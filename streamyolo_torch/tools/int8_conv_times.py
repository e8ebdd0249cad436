"""Check and time the int8 conv kernel (``csrc/int8_conv.cu``) at every conv
shape of StreamYOLO-l's steady serving step, on one NVIDIA GPU.

    python streamyolo_torch/tools/int8_conv_times.py [--root DIR] [--check-only] [--full] [--sweep]

``STEP_SHAPES`` are the 29 distinct ``BaseConv`` calls of one steady
``on_pipe`` step at 600x960 with their calls per step (128 in all), as
forward pre-hooks on ``build_streamyolo("l")`` list them (``chip_smoke.py``
phase ``int8`` holds the list to the model). For each shape: the planner's
choice, and the kernel against its plain version in every element (bf16,
per-tensor scale; with ``--full`` also float32 and a per-channel scale).
Unless ``--check-only``, each shape is timed as ``chip_smoke.py`` times
kernels: the kernel back to back and alone (device time after a sleep),
cuDNN's bf16 convolution of the same layer back to back, ``torch._int_mm``
on pre-quantized operands for the 1x1 layers, and the bound (bytes at the
HBM rate, or float32 quantize / dequantize operations plus int8 tensor-core
operations at their peaks). Sums are over the step's 128 calls.

``--sweep`` times, for each shape, every plan of ``plan_candidates`` (bf16,
back to back) beside the planner's own estimate, and checks each against
the plain version: the data the planner's cost model is fitted to.

Imports ``streamyolo_torch`` from ``--root`` (default: this checkout), so two
checkouts can be compared in one call on one card, in turns::

    for r in OLD . . OLD; do python streamyolo_torch/tools/int8_conv_times.py --root $r; done

Prints the card's name and power limit, each kernel's ptxas report, and one
JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import subprocess
import sys
from pathlib import Path

OWN_ROOT = Path(__file__).resolve().parents[2]

# (calls per step, (n, c, h, w, c_out, k, stride, groups)), most calls first
STEP_SHAPES = (
    (19, (1, 256, 38, 60, 256, 3, 1, 1)),
    (15, (1, 256, 38, 60, 256, 1, 1, 1)),
    (12, (1, 128, 75, 120, 128, 1, 1, 1)),
    (12, (1, 128, 75, 120, 128, 3, 1, 1)),
    (8, (1, 512, 38, 60, 256, 1, 1, 1)),
    (8, (1, 1024, 19, 30, 512, 1, 1, 1)),
    (6, (1, 512, 19, 30, 512, 1, 1, 1)),
    (6, (1, 512, 19, 30, 512, 3, 1, 1)),
    (4, (1, 256, 75, 120, 128, 1, 1, 1)),
    (4, (1, 256, 75, 120, 256, 3, 1, 1)),
    (4, (1, 256, 19, 30, 256, 3, 1, 1)),
    (3, (1, 64, 150, 240, 64, 1, 1, 1)),
    (3, (1, 64, 150, 240, 64, 3, 1, 1)),
    (3, (1, 256, 75, 120, 256, 1, 1, 1)),
    (3, (1, 512, 38, 60, 512, 1, 1, 1)),
    (2, (1, 128, 150, 240, 64, 1, 1, 1)),
    (2, (1, 1024, 19, 30, 1024, 1, 1, 1)),
    (2, (1, 1024, 38, 60, 256, 1, 1, 1)),
    (2, (1, 512, 75, 120, 128, 1, 1, 1)),
    (1, (1, 12, 300, 480, 64, 3, 1, 1)),
    (1, (1, 64, 300, 480, 128, 3, 2, 1)),
    (1, (1, 128, 150, 240, 128, 1, 1, 1)),
    (1, (1, 128, 150, 240, 256, 3, 2, 1)),
    (1, (1, 256, 75, 120, 512, 3, 2, 1)),
    (1, (1, 512, 38, 60, 1024, 3, 2, 1)),
    (1, (1, 2048, 19, 30, 1024, 1, 1, 1)),
    (1, (1, 256, 75, 120, 256, 3, 2, 1)),
    (1, (1, 512, 38, 60, 512, 3, 2, 1)),
    (1, (1, 1024, 19, 30, 256, 1, 1, 1)),
)


def ptxas_by_kernel(log: str) -> dict:
    """ptxas's ``-v`` report per compiled kernel: {name: {registers,
    smem_bytes, stack_bytes, spill_stores, spill_loads}}; names
    demangled where ``c++filt`` exists."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name].update(stack_bytes=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[name]["smem_bytes"] = int(sm.group(1)) if sm else 0
    try:
        names = subprocess.run(["c++filt"], input="\n".join(out), capture_output=True,
                               text=True, timeout=30).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        return out
    return dict(zip(names, out.values())) if len(names) == len(out) else out


def layer_times(shape, single: bool, reps: int = 3, plain: bool = False) -> dict:
    """One shape on the card: the kernel back to back (and alone with
    ``single``), cuDNN's bf16 convolution back to back, ``torch._int_mm``
    for a 1x1 stride-1 layer, the plain version (``plain``), the bound;
    ms."""
    import torch
    import torch.nn.functional as F

    from chip_smoke import bound_ms, conv_work, int8_operands, time_back_to_back, time_cuda
    from streamyolo_torch.ops.int8_conv import int8_conv, int8_conv_plain

    n, c, h, w, co, k, stride, groups = shape
    x, kq, ws, act = int8_operands(shape, torch.bfloat16, False, seed=0)
    wt = (torch.randn(co, c // groups, k, k, device="cuda") * 0.05).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    kernel = lambda: int8_conv(x, kq, ws, act, stride=stride, groups=groups)  # noqa: E731
    cudnn = lambda: F.conv2d(x, wt, stride=stride, padding=(k - 1) // 2,  # noqa: E731
                             groups=groups)
    saved = int8_conv.launches
    out = {"ms_back_to_back": time_back_to_back(kernel, calls=20, reps=reps),
           "cudnn_bf16_ms_back_to_back": time_back_to_back(cudnn, calls=20, reps=reps)}
    if single:
        out["ms"] = time_cuda(kernel, iters=50, device_only=True)
        out["cudnn_bf16_ms"] = time_cuda(cudnn, iters=50, device_only=True)
    if plain:
        out["plain_ms"] = time_cuda(lambda: int8_conv_plain(x, kq, ws, act, stride, groups),
                                    iters=reps)
    if k == 1 and stride == 1 and groups == 1:
        # the int32 product of the pre-quantized [N*H*W, C_in] x [C_in, C_out]
        a = torch.randint(-127, 128, (n * h * w, c), device="cuda", dtype=torch.int8)
        b = kq.reshape(co, c).t()
        try:
            out["int_mm_ms_back_to_back"] = time_back_to_back(
                lambda: torch._int_mm(a, b), calls=20, reps=reps)
        except RuntimeError as e:  # a yardstick, not the port's path
            out["int_mm_error"] = str(e).splitlines()[0]
    int8_conv.launches = saved
    macs, n_bytes, fops = conv_work(shape, 2)
    out["bound_ms"], out["bound_by"] = bound_ms(n_bytes, fops, 2 * macs)
    out["macs"] = macs
    return out


def sweep(mod, int8_operands, int8_exact) -> int:
    """One JSON line per (shape, candidate plan): the plan, its modelled
    and measured ms (bf16, 20 calls back to back, median of 3)."""
    import torch

    from chip_smoke import time_back_to_back

    for i, (calls, shape) in enumerate(STEP_SHAPES):
        n, c, h, w, co, k, stride, groups = shape
        x, kq, ws, act = int8_operands(shape, torch.bfloat16, False, seed=i)
        chosen = mod.plan_int8_conv(*shape)
        for cost, blocks, plan in mod.plan_candidates(n, c, h, w, co, k, stride):
            saved = mod.int8_conv.launches
            got = mod.int8_conv(x, kq, ws, act, stride=stride, plan=plan)
            exact = bool(torch.equal(got, mod.int8_conv_plain(x, kq, ws, act, stride)))
            ms = time_back_to_back(lambda: mod.int8_conv(x, kq, ws, act, stride=stride,
                                                         plan=plan), calls=20, reps=3)
            mod.int8_conv.launches = saved
            print(json.dumps({"shape": list(shape), "calls": calls, "mw": plan.mw, "bn": plan.bn,
                              "splits": plan.splits, "blocks": blocks, "smem": plan.smem,
                              "model_us": cost, "us": ms * 1e3, "exact": exact,
                              "chosen": plan == chosen}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(OWN_ROOT), help="checkout whose kernel is timed")
    ap.add_argument("--check-only", action="store_true", help="the exact checks, no times")
    ap.add_argument("--full", action="store_true",
                    help="also check float32 and per-channel scales at every shape")
    ap.add_argument("--sweep", action="store_true",
                    help="time every candidate plan of every shape (and nothing else)")
    args = ap.parse_args()

    sys.path.insert(0, str(OWN_ROOT))
    import torch

    if not torch.cuda.is_available():
        print("int8_conv_times: no CUDA device available", file=sys.stderr)
        return 1
    from chip_smoke import int8_exact, int8_operands

    sys.path.insert(0, str(Path(args.root).resolve()))
    for name in [m for m in sys.modules if m.startswith("streamyolo_torch")]:
        del sys.modules[name]
    import streamyolo_torch
    from streamyolo_torch.ops import _build
    from streamyolo_torch.ops import int8_conv as mod

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    report = _build.build_all()
    ptxas = ptxas_by_kernel(report["int8_conv"]["log"])
    for name, r in ptxas.items():
        print(f"ptxas {name}: {r}", flush=True)
    if args.sweep:
        return sweep(mod, int8_operands, int8_exact)
    planner = getattr(mod, "plan_int8_conv", None)
    rows, compared = [], 0
    variants = [(torch.bfloat16, False)] + (
        [(torch.float32, False), (torch.bfloat16, True)] if args.full else [])
    for i, (calls, shape) in enumerate(STEP_SHAPES):
        row = {"shape": list(shape), "calls": calls}
        if planner is not None:
            plan = planner(*shape)
            row["plan"] = {f: v for f, v in dataclasses.asdict(plan).items()
                           if f in ("flat", "mw", "bn", "splits", "grid", "smem")}
        for dtype, per_channel in variants:
            ops = int8_operands(shape, dtype, per_channel, seed=i)
            compared += int8_exact(*ops, shape[6], shape[7], f"{shape} {dtype} pc={per_channel}")
        if not args.check_only:
            row.update(layer_times(shape, single=True))
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"calls": sum(r["calls"] for r in rows), "elements_compared": compared}
    if not args.check_only:
        for key in ("ms_back_to_back", "ms", "cudnn_bf16_ms_back_to_back", "bound_ms"):
            summary[key] = sum(r["calls"] * r[key] for r in rows)
        one = [r for r in rows if "int_mm_ms_back_to_back" in r]
        summary["int_mm_ms_1x1"] = sum(r["calls"] * r["int_mm_ms_back_to_back"] for r in one)
        summary["kernel_ms_1x1"] = sum(r["calls"] * r["ms_back_to_back"] for r in one)
    print(json.dumps({"root": args.root, "package": streamyolo_torch.__file__, "nvidia_smi": smi,
                      "summary": summary, "ptxas": ptxas}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
