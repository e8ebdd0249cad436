"""The benchmark's frozen yardstick: the work of a step counted from the
configuration's shapes, and the share of the card's peaks a measured time
reaches.

The count runs the reference model (``reference/model.py``) on meta
tensors through ``CountingOps``, so it follows the architecture and never
what implements a layer in the program. Convolutions are counted dense,
the taps that fall in the padding included: 2 x the multiply-adds. Bytes:
per convolution its input, weight, bias and output read or written once,
in the served dtype. This is the rule of the program's own
``streamyolo_torch/tools/measure.py::count_work``, frozen here.

Peaks: NVIDIA's data sheet for one H100 SXM, dense, at its full 700 W power
limit: 989 TFLOP/s in bf16 and fp16, 495 TF32, 67 float32 outside the
tensor cores, 1,979 TOP/s int8; HBM 3.35 TB/s. A card set below 700 W
reaches less: each run reports the card's name and power limit.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

from streambench.reference.model import StreamYOLO

PEAK_OPS_PER_S = {"bf16": 989e12, "fp16": 989e12, "tf32": 495e12, "fp32": 67e12,
                  "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12
DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}
FORMATS = {"bfloat16": "bf16", "float16": "fp16", "float32": "fp32"}


class CountingOps:
    """``ops`` for the reference forward that counts each convolution."""

    def __init__(self):
        self.macs = 0
        self.bytes = 0
        self.calls = 0

    def conv(self, x, w, b, stride: int, pad: int, groups: int = 1):
        out = F.conv2d(x, w, b, stride, pad, 1, groups)
        self.macs += out.numel() * w[0].numel()
        self.bytes += sum(t.numel() * t.element_size() for t in (x, w, b, out) if t is not None)
        self.calls += 1
        return out


def model_of(cfg: dict) -> StreamYOLO:
    return StreamYOLO(cfg["depth"], cfg["width"], cfg["num_classes"])


def meta_params(model: StreamYOLO, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    return {name: torch.empty(shape, dtype=dtype, device="meta")
            for name, shape, _ in model.spec()}


def count(cfg: dict, batch: int, body: Callable) -> dict:
    """The work of ``body(model, params, ops, frames)`` on meta [batch, 3,
    H, W] frames in the configuration's dtype: ``flops``, ``bytes``,
    ``convs``, ``format``."""
    dtype = DTYPES[cfg["dtype"]]
    model = model_of(cfg)
    params = meta_params(model, dtype)
    ops = CountingOps()
    h, w = cfg["input_size"]
    frames = torch.empty((batch, 3, h, w), dtype=dtype, device="meta")
    body(model, params, ops, frames)
    return {"flops": 2 * ops.macs, "bytes": ops.bytes, "convs": ops.calls,
            "format": FORMATS[cfg["dtype"]]}


def serve_step(model, p, ops, x):
    """The steady serving step: the backbone and neck once on the current
    frame, the DFP fuse with the carried buffer, the head."""
    cur = model.pafpn(p, ops, x)
    return model.head_maps(p, ops, model.fuse(p, ops, cur, cur))


def time_at_peak(work: dict) -> float:
    """The least seconds ``work`` needs on one H100: the larger of its
    operations at the peak of its format and its bytes at the HBM rate."""
    return max(work["flops"] / PEAK_OPS_PER_S[work["format"]], work["bytes"] / HBM_BYTES_PER_S)


def nms_work(images: int, k: int) -> dict:
    """Kernel B1's least work for ``images`` images of ``k`` candidates:
    reads the float32 boxes and the valid flags, writes the keep flags, and
    decides the k (k - 1) / 2 pairs by IoU: 12 float32 operations a pair
    (4 max / min, 2 subtractions, 2 clamps and a product for the
    intersection, 2 for the union, 1 for the test) and 3 a box for its
    area."""
    pairs = k * (k - 1) // 2
    return {"flops": images * (12 * pairs + 3 * k), "bytes": images * k * (16 + 1 + 1),
            "format": "fp32"}
