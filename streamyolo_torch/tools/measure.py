"""What the port's measuring tools share: the work a forward does, the share
of the card's peaks a measured time reaches, the card's identity, and timed
samples.

``count_work`` and ``roofline`` are the counterparts of
``tools/bench_suite.py``'s ``_cost`` / ``_flops`` / ``_roofline``. XLA's
cost analysis counts a compiled program; the port counts from its own
shapes: one forward with hooks on every convolution and matrix product
(``nn.Conv2d``, the int8 conv of a quantized ``nn/blocks.py::BaseConv``,
``nn.Linear``). It runs on ``torch.device("meta")`` tensors, so a
full-width count does no arithmetic (``on_meta`` makes the copy to count
with). Convolutions are counted dense, the padded taps included, as the
kernels compute them: XLA's count of the JAX model leaves the taps that
fall in the padding out and adds the elementwise operations
(``tests/test_torch_bench_tools.py`` holds the two counts together).

Peaks (``PEAK_OPS_PER_S``, ``HBM_BYTES_PER_S``): NVIDIA's data sheet for one
H100 SXM, dense, at its full 700 W power limit: 989 TFLOP/s in bf16 and
fp16, 495 TF32, 67 float32 outside the tensor cores, 1,979 TOP/s int8; HBM
3.35 TB/s. A card set below 700 W reaches less, so every tool's JSON line
carries ``nvidia-smi``'s name and power limit (``card``).

Off the card the tools run the same control flow and report no time:
``time_samples`` returns None there, and ``roofline`` fills the counts and
leaves every time and share None.
"""

from __future__ import annotations

import copy
import subprocess
import time
from typing import Callable, List, Optional

import torch
from torch import nn

PEAK_OPS_PER_S = {"bf16": 989e12, "fp16": 989e12, "tf32": 495e12, "fp32": 67e12,
                  "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12
PEAK_SOURCE = "H100 SXM data sheet, dense, at 700 W"
_FORMATS = {torch.bfloat16: "bf16", torch.float16: "fp16", torch.float32: "fp32"}


def card(device: torch.device) -> dict:
    """The ``device`` object of a tool's JSON line: on a card its name,
    ``nvidia-smi --query-gpu=name,power.limit``'s line and the card count;
    on the CPU ``{"kind": "cpu", "nvidia_smi": None}``."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "nvidia_smi": None}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
    index = torch.cuda.current_device() if device.index is None else device.index
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(index),
            "nvidia_smi": smi[index], "count": torch.cuda.device_count()}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_samples(fn: Callable[[], object], n_samples: int, calls: int,
                 device: torch.device) -> Optional[List[float]]:
    """Seconds per call of ``n_samples`` samples, each ``calls`` calls of
    ``fn`` in a row and one synchronize (host clock). Off the card the calls
    run and None is returned: a CPU time is no measure of the card."""
    samples = []
    for _ in range(n_samples):
        sync(device)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        sync(device)
        samples.append((time.perf_counter() - t0) / calls)
    return samples if device.type == "cuda" else None


def stats_ms(samples: Optional[List[float]]) -> dict:
    """min / median / max of per-call seconds, in ms (None without samples)."""
    if not samples:
        return {"min_ms": None, "median_ms": None, "max_ms": None}
    s = sorted(samples)
    mid = len(s) // 2
    median = s[mid] if len(s) % 2 else (s[mid - 1] + s[mid]) / 2
    return {"min_ms": s[0] * 1e3, "median_ms": median * 1e3, "max_ms": s[-1] * 1e3}


def on_meta(model: nn.Module) -> nn.Module:
    """A copy of ``model`` on the meta device (shapes, dtypes and structure,
    no data) to count work with; the model itself is untouched."""
    return copy.deepcopy(model).to("meta")


def meta_like(x) -> torch.Tensor:
    """An empty meta tensor of ``x``'s shape and dtype (a tensor or a NumPy
    array)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(x)
    return torch.empty(x.shape, dtype=x.dtype, device="meta")


def _format(module: nn.Module, dtype: torch.dtype) -> str:
    if getattr(module, "kernel_q", None) is not None:
        return "int8"
    return _FORMATS.get(dtype, str(dtype).replace("torch.", ""))


def tensor_bytes(*tensors) -> int:
    """The bytes ``tensors`` hold (None counts 0)."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def count_work(model: nn.Module, inputs, **forward_kwargs) -> dict:
    """One forward ``model(*inputs, **forward_kwargs)`` (``inputs`` a tensor
    or a tuple) with hooks on every ``nn.Conv2d``, quantized ``BaseConv``
    and ``nn.Linear``; returns its work:

    * ``flops``: 2 x the float multiply-adds (dense convolutions: every tap
      of every output, padding included);
    * ``int8_ops``: 2 x the int8 multiply-adds of quantized ``BaseConv``s;
    * ``ops_by_format``: those operations by the number format they run in
      (``bf16``, ``fp32``, ``int8``, ...), which ``roofline`` prices;
    * ``bytes``: per call each input, weight (bias, int8 kernel and scales
      included) and output read or written once;
    * ``calls``: one record per call, in order: ``op`` (``conv``,
      ``int8_conv``, ``linear``), ``format``, ``base_conv`` (the conv of a
      ``BaseConv`` block), ``shape`` (conv: n, c, h, w, c_out, k, stride,
      groups; linear: the input's shape and out features), ``macs``,
      ``bytes``.

    Works on meta tensors (``on_meta``, ``meta_like``): counting a
    full-width step then costs no arithmetic. The counts follow the shapes
    only, so they equal the counts of the same forward on the card."""
    from streamyolo_torch.nn.blocks import BaseConv

    records: List[dict] = []
    block_convs = {id(m.conv) for m in model.modules() if isinstance(m, BaseConv)}

    def conv_record(module, conv, x, out, op, weight_bytes):
        k = conv.kernel_size[0]
        n, c, h, w = x.shape
        macs = out.numel() * (c // conv.groups) * conv.kernel_size[0] * conv.kernel_size[1]
        records.append({"op": op, "format": _format(module, x.dtype),
                        "base_conv": module is not conv or id(conv) in block_convs,
                        "shape": (n, c, h, w, conv.out_channels, k, conv.stride[0],
                                  conv.groups),
                        "macs": macs, "bytes": tensor_bytes(x, out) + weight_bytes})

    def on_conv(module, args, out):
        conv_record(module, module, args[0], out, "conv", tensor_bytes(module.weight, module.bias))

    def on_block(module, args, out):
        if module.kernel_q is None:
            return  # its nn.Conv2d counted the call
        conv_record(module, module.conv, args[0], out, "int8_conv",
                    tensor_bytes(module.kernel_q, module.w_scale, module.act_scale))

    def on_linear(module, args, out):
        x = args[0]
        records.append({"op": "linear", "format": _format(module, x.dtype), "base_conv": False,
                        "shape": (*x.shape, module.out_features),
                        "macs": out.numel() * module.in_features,
                        "bytes": tensor_bytes(x, out, module.weight, module.bias)})

    hooks = []
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            hooks.append(m.register_forward_hook(on_conv))
        elif isinstance(m, BaseConv):
            hooks.append(m.register_forward_hook(on_block))
        elif isinstance(m, nn.Linear):
            hooks.append(m.register_forward_hook(on_linear))
    try:
        with torch.no_grad():
            model(*(inputs if isinstance(inputs, (tuple, list)) else (inputs,)),
                  **forward_kwargs)
    finally:
        for h in hooks:
            h.remove()
    by_format: dict = {}
    for r in records:
        by_format[r["format"]] = by_format.get(r["format"], 0) + 2 * r["macs"]
    int8_ops = by_format.get("int8", 0)
    return {"flops": sum(by_format.values()) - int8_ops, "int8_ops": int8_ops,
            "ops_by_format": by_format, "bytes": sum(r["bytes"] for r in records),
            "calls": records}


def scale_work(work: dict, factor: float) -> dict:
    """``work`` times ``factor`` (the train step's forward + backward: the
    backward's input and weight gradients are each a convolution of the
    forward's size, so the step is 3x its forward), without the calls."""
    return {"flops": work["flops"] * factor, "int8_ops": work["int8_ops"] * factor,
            "ops_by_format": {f: v * factor for f, v in work["ops_by_format"].items()},
            "bytes": work["bytes"] * factor}


def roofline(work: dict, seconds: Optional[float], device: torch.device) -> dict:
    """The share of the card's peaks that ``work`` done in ``seconds``
    reaches:

    * ``mfu``: the time the operations need at the peak of their number
      format (``format``; ``fp32`` convolutions run TF32 while cuDNN may,
      ``torch.backends.cudnn.allow_tf32``), summed over formats, over
      ``seconds``. With one format it is operations / seconds / peak;
    * ``hbm_share``: ``bytes`` / ``seconds`` / 3.35 TB/s;
    * ``bound_ms`` and ``bound_by``: the larger of the two least times,
      and which (``operations`` or ``bytes``).

    ``tflops``, ``tops_int8`` and ``gbytes`` are the counts. Off the card,
    or without a time, every time and share is None; so is ``mfu`` of work
    without operations (SGD, EMA: their bytes only are counted)."""
    out = {"tflops": work["flops"] / 1e12, "tops_int8": work["int8_ops"] / 1e12,
           "gbytes": work["bytes"] / 1e9, "mfu": None, "hbm_share": None,
           "bound_ms": None, "bound_by": None}
    fmts = {}
    for fmt, ops in work["ops_by_format"].items():
        if fmt == "fp32" and torch.backends.cudnn.enabled and torch.backends.cudnn.allow_tf32:
            fmt = "tf32"
        fmts[fmt] = fmts.get(fmt, 0) + ops
    out["format"] = "+".join(sorted(fmts)) or None
    out["peaks"] = {f: PEAK_OPS_PER_S[f] / 1e12 for f in sorted(fmts)}
    out["peak_source"] = PEAK_SOURCE
    if device.type != "cuda" or not seconds:
        return out
    t_ops = sum(ops / PEAK_OPS_PER_S[f] for f, ops in fmts.items())
    t_bytes = work["bytes"] / HBM_BYTES_PER_S
    out.update(mfu=t_ops / seconds if fmts else None,
               hbm_share=t_bytes / seconds if work["bytes"] else None,
               bound_ms=max(t_ops, t_bytes) * 1e3,
               bound_by="operations" if t_ops >= t_bytes else "bytes")
    return out
