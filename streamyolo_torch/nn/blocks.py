"""Canonical YOLOX-style conv blocks in PyTorch.

Counterpart of ``streamyolo_tpu/nn/blocks.py``: ``BaseConv`` (conv + BN +
SiLU), ``DWConv``, ``Bottleneck``, ``CSPLayer``, ``SPPBottleneck`` and
``Focus``. Activations are NCHW inside the port (``channels_last`` memory
format on the card); attribute names follow the yolox ``state_dict``
(``conv``/``bn``, ``m.0``...), the tree the JAX package's importer maps.

Left out: the int8 / calibration hooks of the JAX ``BaseConv`` (they belong
to ``quant/``), the phase-packed CSP body (``nn/packed.py``, a TPU lane
layout with the same parameter tree) and ``_FocusStemConv`` (a TPU lane
trick; only its parameter names ``stem.conv.conv.weight`` / ``stem.conv.bn``
matter, and ``Focus`` below has them).

BatchNorm: eps=1e-3, torch momentum 0.03 (the JAX package's flax momentum
0.97 is the weight of the old statistic). In training, ``BatchNorm2d``
moves the running variance by the *biased* batch variance, as flax does;
``torch.nn.BatchNorm2d`` would use the unbiased one, n / (n - 1) larger.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

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
    ``nn.BatchNorm2d``'s."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.register_buffer("_batch_mean", torch.zeros_like(self.running_mean),
                             persistent=False)
        self.register_buffer("_batch_var", torch.zeros_like(self.running_var),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        # momentum 1: the scratch buffers become this batch's statistics
        y = F.batch_norm(x, self._batch_mean, self._batch_var, self.weight, self.bias,
                         True, 1.0, self.eps)
        n = x.numel() // x.shape[1]
        m = self.momentum
        with torch.no_grad():
            self.running_mean.mul_(1.0 - m).add_(self._batch_mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(self._batch_var, alpha=m * (n - 1) / n)
            self.num_batches_tracked.add_(1)
        return y


class BaseConv(nn.Module):
    """Conv2d(bias=False) -> BatchNorm -> activation, ``(k - 1) // 2`` padding."""

    def __init__(self, in_channels: int, out_channels: int, ksize: int,
                 stride: int = 1, groups: int = 1, act: str = "silu"):
        super().__init__()
        pad = (ksize - 1) // 2
        self.conv = nn.Conv2d(in_channels, out_channels, ksize, stride, pad,
                              groups=groups, bias=False)
        self.bn = BatchNorm2d(out_channels, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = get_activation(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.bn(self.conv(x)))


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
