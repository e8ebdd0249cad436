"""Canonical YOLOX-style conv blocks in PyTorch.

Counterpart of ``streamyolo_tpu/nn/blocks.py``: ``BaseConv`` (conv + BN +
SiLU), ``DWConv``, ``Bottleneck``, ``ResLayer``, ``CSPLayer``,
``SPPBottleneck`` and ``Focus``. Activations are NCHW inside the port (``channels_last`` memory
format on the card); attribute names follow the yolox ``state_dict``
(``conv``/``bn``, ``m.0``...), the tree the JAX package's importer maps.

``BaseConv`` carries the int8 serving hook of the JAX ``BaseConv``: a block
that holds ``kernel_q`` / ``w_scale`` / ``act_scale`` (``quant/ptq.py``
builds them) runs its conv through ``ops/int8_conv.py``. Calibration is a
forward pre-hook that ``quant/ptq.py::calibrate_activations`` registers.

Left out: the phase-packed CSP body (``nn/packed.py``, a TPU lane layout
with the same parameter tree) and ``_FocusStemConv`` (a TPU lane trick;
only its parameter names ``stem.conv.conv.weight`` / ``stem.conv.bn``
matter, and ``Focus`` below has them).

BatchNorm: eps=1e-3, torch momentum 0.03 (the JAX package's flax momentum
0.97 is the weight of the old statistic). In training, ``BatchNorm2d``
moves the running variance by the *biased* batch variance, as flax does;
``torch.nn.BatchNorm2d`` would use the unbiased one, n / (n - 1) larger.
Under a process group of more than one rank, training BatchNorm takes its
statistics over the global batch (``parallel/``), as the JAX package's
BatchNorm does under its data mesh.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from streamyolo_torch.ops.int8_conv import int8_conv
from streamyolo_torch.parallel.multihost import all_reduce_sum_, get_rank, get_world_size

BN_EPS = 1e-3
BN_MOMENTUM = 0.03


def get_activation(name: str = "silu") -> nn.Module:
    if name == "silu":
        return nn.SiLU()
    if name == "relu":
        return nn.ReLU()
    if name == "lrelu":
        return nn.LeakyReLU(0.1)
    raise AttributeError(f"Unsupported act type: {name}")


class _GlobalBatchNorm(torch.autograd.Function):
    """Training BatchNorm over the batch of every rank of the process group:
    the output, input gradient and local weight / bias gradients of
    ``F.batch_norm`` over the ranks' batches concatenated (each rank then
    holds its share of the weight and bias gradients, which the step's
    gradient all-reduce sums).

    Forward: each rank's (count, mean, M2) per channel, from
    ``torch.var_mean``, goes into its row of a zero [world, 3, C] float64
    block; one all-reduce gathers the rows and every rank merges them alike
    (Chan's parallel rule), so the global mean and biased variance carry no
    ``E[x^2] - E[x]^2`` cancellation and are the same bits on every rank.
    Backward: one all-reduce of the per-channel sums of ``dy`` and
    ``dy * x_hat``; ``dx = w / sigma * (dy - mean(dy) - x_hat * mean(dy *
    x_hat))`` with the global means. The local reductions and the
    transform run in float32, or float64 for a float64 input; the merge in
    float64; the output in the input's dtype."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float, world: int, rank: int):
        c = x.shape[1]
        ct = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(ct)
        var_l, mean_l = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
        n_l = xf.numel() // c
        rows = xf.new_zeros((world, 3, c), dtype=torch.float64)
        rows[rank, 0] = n_l
        rows[rank, 1] = mean_l
        rows[rank, 2] = var_l.double() * n_l
        all_reduce_sum_(rows)
        counts, means, m2s = rows.unbind(1)
        n = counts.sum(0)
        mean = (counts * means).sum(0) / n
        var = (m2s + counts * (means - mean) ** 2).sum(0) / n
        mean_c, var_c = mean.to(ct), var.to(ct)
        invstd = torch.rsqrt(var + eps).to(ct)
        scale = invstd * weight.to(ct)
        y = (xf - mean_c[:, None, None]) * scale[:, None, None] + bias.to(ct)[:, None, None]
        ctx.save_for_backward(x, weight, mean_c, invstd, n)
        ctx.mark_non_differentiable(mean_c, var_c)
        return y.to(x.dtype), mean_c, var_c

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd, n = ctx.saved_tensors
        ct = mean.dtype
        xhat = (x.to(ct) - mean[:, None, None]) * invstd[:, None, None]
        dyf = dy.to(ct)
        sums = torch.stack([dyf.sum((0, 2, 3)), (dyf * xhat).sum((0, 2, 3))])
        dbias, dweight = sums.clone()  # this rank's shares
        all_reduce_sum_(sums)
        g_dy, g_dyx = (sums.double() / n).to(ct)
        dx = (dyf - g_dy[:, None, None] - xhat * g_dyx[:, None, None]) \
            * (invstd * weight.to(ct))[:, None, None]
        return (dx.to(x.dtype), dweight.to(weight.dtype), dbias.to(weight.dtype),
                None, None, None)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training step updates the running statistics
    as flax's ``nn.BatchNorm`` does: by the batch mean and the *biased*
    batch variance, ``(1 - momentum) * running + momentum * batch``. The
    normalisation (batch statistics, biased variance) is torch's own.

    ``F.batch_norm`` computes the batch statistics once, for the
    normalisation, and writes them into two scratch buffers at momentum 1
    (the mean and the unbiased variance); the running statistics are then
    blended from those, the variance scaled by (n - 1) / n. The scratch
    buffers are not in the state dict, whose names are
    ``nn.BatchNorm2d``'s.

    Under a process group of more than one rank, a training call takes the
    statistics over the global batch (``_GlobalBatchNorm``) and the running
    statistics move by them, with the global ``n``; eval mode and a world
    of 1 take the path above."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.register_buffer("_batch_mean", torch.zeros_like(self.running_mean),
                             persistent=False)
        self.register_buffer("_batch_var", torch.zeros_like(self.running_var),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        m = self.momentum
        world = get_world_size()
        if world > 1:
            y, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias, self.eps, world,
                                                  get_rank())
            with torch.no_grad():
                self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
                self.running_var.mul_(1.0 - m).add_(var, alpha=m)
                self.num_batches_tracked.add_(1)
            return y
        # momentum 1: the scratch buffers become this batch's statistics
        y = F.batch_norm(x, self._batch_mean, self._batch_var, self.weight, self.bias,
                         True, 1.0, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_mean.mul_(1.0 - m).add_(self._batch_mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(self._batch_var, alpha=m * (n - 1) / n)
            self.num_batches_tracked.add_(1)
        return y


class BaseConv(nn.Module):
    """Conv2d(bias=False) -> BatchNorm -> activation, ``(k - 1) // 2`` padding.

    int8 serving: loading a state dict that holds ``<prefix>.kernel_q``
    (int8 OIHW), ``w_scale`` (float32 [C_out]) and ``act_scale`` (float32,
    scalar or [C_in]) makes the block quantized; its conv then runs through
    ``ops/int8_conv.py`` and BN (an identity with bias after the fold) and
    the activation run in the module's dtype. A ``conv.weight`` stripped to
    the 1-element placeholder (``quantize_state_dict(strip=True)``) loads
    as it is. The two scales stay float32 under ``.to(dtype)`` / ``.half()``
    (the JAX ``quant`` collection is never cast). A state dict without
    ``kernel_q`` makes the block a float one again."""

    QUANT_BUFFERS = ("kernel_q", "w_scale", "act_scale")

    def __init__(self, in_channels: int, out_channels: int, ksize: int,
                 stride: int = 1, groups: int = 1, act: str = "silu"):
        super().__init__()
        pad = (ksize - 1) // 2
        self.conv = nn.Conv2d(in_channels, out_channels, ksize, stride, pad,
                              groups=groups, bias=False)
        self.bn = BatchNorm2d(out_channels, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = get_activation(act)
        for name in self.QUANT_BUFFERS:
            self.register_buffer(name, None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kernel_q is None:
            return self.act(self.bn(self.conv(x)))
        if self.training:
            raise ValueError(
                "int8 PTQ variables are serving-only: the round/clip in the "
                "quantized conv has zero gradient, so training through it would "
                "silently learn nothing — fine-tune with the fp variables and "
                "re-quantize")
        y = int8_conv(x, self.kernel_q, self.w_scale, self.act_scale,
                      stride=self.conv.stride[0], groups=self.conv.groups)
        return self.act(self.bn(y))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        quantized = prefix + "kernel_q" in state_dict
        device = self.bn.weight.device
        for name, dtype in zip(self.QUANT_BUFFERS, (torch.int8, torch.float32, torch.float32)):
            src = state_dict.get(prefix + name) if quantized else None
            # kernel_q channels_last: OHWI in memory, as the int8 kernel reads it
            fmt = torch.channels_last if name == "kernel_q" and src is not None \
                and src.ndim == 4 else torch.contiguous_format
            self._buffers[name] = (None if src is None else torch.empty(
                src.shape, dtype=dtype, device=device, memory_format=fmt))
        weight = state_dict.get(prefix + "conv.weight")
        ours = self.conv.weight
        if weight is not None and weight.shape != ours.shape \
                and 1 in (weight.numel(), ours.numel()) and (quantized or ours.numel() == 1):
            # the stripped placeholder in, or a full kernel back into a stripped block
            self.conv.weight = nn.Parameter(
                torch.empty(weight.shape, dtype=ours.dtype, device=ours.device),
                requires_grad=ours.requires_grad)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def _apply(self, fn, recurse=True):
        scales = {n: self._buffers[n] for n in ("w_scale", "act_scale")
                  if self._buffers.get(n) is not None}
        super()._apply(fn, recurse)
        for name, before in scales.items():
            after = self._buffers[name]
            if after.dtype != torch.float32:  # a cast: keep float32, follow the device
                self._buffers[name] = before.to(after.device)
        return self


class DWConv(nn.Module):
    """Depthwise conv followed by a pointwise conv."""

    def __init__(self, in_channels: int, out_channels: int, ksize: int,
                 stride: int = 1, act: str = "silu"):
        super().__init__()
        self.dconv = BaseConv(in_channels, in_channels, ksize, stride,
                              groups=in_channels, act=act)
        self.pconv = BaseConv(in_channels, out_channels, 1, 1, act=act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pconv(self.dconv(x))


class Bottleneck(nn.Module):
    """1x1 reduce -> 3x3 conv, residual when widths match and ``shortcut``."""

    def __init__(self, in_channels: int, out_channels: int, shortcut: bool = True,
                 expansion: float = 0.5, depthwise: bool = False, act: str = "silu"):
        super().__init__()
        hidden = int(out_channels * expansion)
        conv2_cls = DWConv if depthwise else BaseConv
        self.conv1 = BaseConv(in_channels, hidden, 1, 1, act=act)
        self.conv2 = conv2_cls(hidden, out_channels, 3, 1, act=act)
        self.use_add = shortcut and in_channels == out_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(self.conv1(x))
        return y + x if self.use_add else y


class ResLayer(nn.Module):
    """Residual 1x1 (half width) -> 3x3 block with leaky ReLU (the yolox
    ``ResLayer`` of the legacy ``Darknet`` 21/53)."""

    def __init__(self, in_channels: int):
        super().__init__()
        mid = in_channels // 2
        self.layer1 = BaseConv(in_channels, mid, 1, 1, act="lrelu")
        self.layer2 = BaseConv(mid, in_channels, 3, 1, act="lrelu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.layer2(self.layer1(x))


class CSPLayer(nn.Module):
    """Cross-Stage-Partial layer: two 1x1 branches, ``n`` bottlenecks on one,
    concat, 1x1 fuse."""

    def __init__(self, in_channels: int, out_channels: int, n: int = 1,
                 shortcut: bool = True, expansion: float = 0.5,
                 depthwise: bool = False, act: str = "silu"):
        super().__init__()
        hidden = int(out_channels * expansion)
        self.conv1 = BaseConv(in_channels, hidden, 1, 1, act=act)
        self.conv2 = BaseConv(in_channels, hidden, 1, 1, act=act)
        self.conv3 = BaseConv(2 * hidden, out_channels, 1, 1, act=act)
        self.m = nn.Sequential(*[
            Bottleneck(hidden, hidden, shortcut, 1.0, depthwise, act=act)
            for _ in range(n)
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.m(self.conv1(x))
        x2 = self.conv2(x)
        return self.conv3(torch.cat((x1, x2), dim=1))


class SPPBottleneck(nn.Module):
    """1x1 reduce, parallel max-pools (5/9/13, stride 1, same padding),
    concat, 1x1 fuse."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_sizes: Sequence[int] = (5, 9, 13), activation: str = "silu"):
        super().__init__()
        hidden = in_channels // 2
        self.conv1 = BaseConv(in_channels, hidden, 1, 1, act=activation)
        self.m = nn.ModuleList(
            [nn.MaxPool2d(k, stride=1, padding=k // 2) for k in kernel_sizes])
        self.conv2 = BaseConv(hidden * (len(kernel_sizes) + 1), out_channels, 1, 1,
                              act=activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x)
        x = torch.cat([x] + [m(x) for m in self.m], dim=1)
        return self.conv2(x)


def space_to_depth_focus(x: torch.Tensor) -> torch.Tensor:
    """NCHW 2x2 space-to-depth in the yolox ``Focus`` channel order:
    [top-left, bottom-left, top-right, bottom-right]."""
    tl = x[..., ::2, ::2]
    bl = x[..., 1::2, ::2]
    tr = x[..., ::2, 1::2]
    br = x[..., 1::2, 1::2]
    return torch.cat((tl, bl, tr, br), dim=1)


class Focus(nn.Module):
    """Space-to-depth stem, then conv: (B, C, H, W) -> (B, out, H/2, W/2)."""

    def __init__(self, in_channels: int, out_channels: int, ksize: int = 1,
                 stride: int = 1, act: str = "silu"):
        super().__init__()
        self.conv = BaseConv(in_channels * 4, out_channels, ksize, stride, act=act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(space_to_depth_focus(x))
