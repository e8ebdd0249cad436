"""Seeded weights for a configuration, made on the device in a few large
calls and handed alike to the program and to the reference.

Convolution weights are LeCun normal, N(0, gain^2 / fan_in), the JAX
package's and the port's convolution init at gain 1. The stem's gain is
1 / 255, as if it read pixels scaled to 0..1 (YOLOX feeds 0..255 pixels).
``calibrated`` sets every BatchNorm's running statistics from seeded
frames, as a trained network's are (``reference.model.CalibratingOps``),
and BatchNorm's weight is drawn from U(0.1, 0.3) and its bias from
N(0, 0.1). That keeps the deep random trunk in its near-linear regime:
features keep their scale on every frame, differ from frame to frame, and
a rounding error is not amplified layer by layer. With weights near 1 the
trunk is chaotic (bf16 rounding alone moves its features by tens of
percent, and some frames blow up by orders of magnitude); with arbitrary
running statistics the features shrink through SiLU until the output no
longer depends on the frame. The prediction convolutions' gain is 8, so
that the head's logits spread as a trained head's do. The prediction
biases are 0: with YOLOX's prior-probability init every score would fall
under the serving confidence of 0.01 and NMS would see nothing.

The values are drawn in float32 and rounded once to the served dtype; the
reference computes in float32 from those same rounded values.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from streambench.seeds import generator

CONV_GAIN = {"conv": 1.0, "stem_conv": 1.0 / 255.0, "pred_conv": 8.0}
BN_DRAWS = {"bn_weight": (0.1, 0.3, "uniform"), "bn_bias": (0.0, 0.1, "normal"),
            "bn_mean": (0.0, 0.1, "normal"), "bn_var": (0.5, 1.5, "uniform")}


def make(spec: List[Tuple[str, tuple, str]], seed: int, device: torch.device,
         dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The state dict of ``spec`` (``reference.model.StreamYOLO.spec()``)
    drawn from ``seed`` on ``device`` in ``dtype`` (the BatchNorm counts
    int64 zeros)."""
    gen = generator(seed, "weights", device)
    out: Dict[str, torch.Tensor] = {}
    groups: Dict[str, list] = {}
    for name, shape, kind in spec:
        groups.setdefault(kind, []).append((name, shape))
    for kind, entries in groups.items():
        sizes = [int(np.prod(shape)) for _, shape in entries]
        total = sum(sizes)
        if kind == "count":
            flat = torch.zeros(total, dtype=torch.int64, device=device)
        elif kind == "pred_bias":
            flat = torch.zeros(total, dtype=torch.float32, device=device)
        elif kind in CONV_GAIN:
            flat = torch.randn(total, generator=gen, device=device)
            fan_in = torch.tensor([int(np.prod(shape[1:])) for _, shape in entries],
                                  dtype=torch.float32, device=device)
            counts = torch.tensor(sizes, device=device)
            flat *= torch.repeat_interleave(fan_in.rsqrt() * CONV_GAIN[kind], counts)
        else:
            a, b, how = BN_DRAWS[kind]
            if how == "uniform":
                flat = torch.rand(total, generator=gen, device=device) * (b - a) + a
            else:
                flat = torch.randn(total, generator=gen, device=device) * b + a
        if flat.is_floating_point():
            flat = flat.to(dtype)
        for (name, shape), part in zip(entries, torch.split(flat, sizes)):
            out[name] = part.view(shape)
    return out


def calibrated(model, seed: int, device: torch.device, dtype: torch.dtype,
               frames: np.ndarray) -> Dict[str, torch.Tensor]:
    """``make``'s state with every BatchNorm's running statistics taken from
    ``frames`` ([n, H, W, 3] uint8 on the host: frames the cell serves), by
    the reference in float32 with TF32 off, in a star step (the DFP fuse
    reads the frames' own features)."""
    from streambench.reference.model import CalibratingOps
    from streambench.reference.precision import float32_exact

    state = make(model.spec(), seed, device, dtype)
    p = as_float32(state)
    ops = CalibratingOps()
    with float32_exact():
        x = model.frames_in(torch.from_numpy(np.ascontiguousarray(frames)).to(device))
        cur = model.pafpn(p, ops, x)
        model.head_maps(p, ops, model.fuse(p, ops, cur, cur))
    for k, v in p.items():
        if k.endswith(("running_mean", "running_var")):
            state[k] = v.to(dtype)
    return state


def as_float32(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The same values in float32, for the reference."""
    return {k: v.float() if v.is_floating_point() else v for k, v in state.items()}
