"""The backbones in PyTorch, the counterparts of
``streamyolo_tpu/models/darknet.py``: ``CSPDarknet`` (unpacked network
only: the JAX package's phase-packed stages are a TPU layout with the same
parameter tree) and the legacy plain ``Darknet`` 21/53, which no shipped
config uses.

Stages are ``nn.Sequential``s so the state-dict names are the yolox ones
(``dark2.0.conv.weight``); ``Darknet``'s SPP tail is ``dark5_spp``, the
name the JAX package's parameter tree gives it.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from streamyolo_torch.nn.blocks import (
    BaseConv,
    CSPLayer,
    DWConv,
    Focus,
    ResLayer,
    SPPBottleneck,
)


class CSPDarknet(nn.Module):
    """YOLOX CSPDarknet: base_channels = int(wid_mul * 64),
    base_depth = max(round(dep_mul * 3), 1); returns the dict of the
    ``out_features`` maps (dark3/4/5 at strides 8/16/32 by default)."""

    def __init__(self, dep_mul: float, wid_mul: float,
                 out_features: Sequence[str] = ("dark3", "dark4", "dark5"),
                 depthwise: bool = False, act: str = "silu"):
        super().__init__()
        if not out_features:
            raise ValueError("please provide output features of Darknet")
        self.out_features = tuple(out_features)
        Conv = DWConv if depthwise else BaseConv
        c = int(wid_mul * 64)
        d = max(round(dep_mul * 3), 1)
        kw = dict(depthwise=depthwise, act=act)

        self.stem = Focus(3, c, ksize=3, act=act)
        self.dark2 = nn.Sequential(
            Conv(c, c * 2, 3, 2, act=act), CSPLayer(c * 2, c * 2, n=d, **kw))
        self.dark3 = nn.Sequential(
            Conv(c * 2, c * 4, 3, 2, act=act), CSPLayer(c * 4, c * 4, n=d * 3, **kw))
        self.dark4 = nn.Sequential(
            Conv(c * 4, c * 8, 3, 2, act=act), CSPLayer(c * 8, c * 8, n=d * 3, **kw))
        self.dark5 = nn.Sequential(
            Conv(c * 8, c * 16, 3, 2, act=act),
            SPPBottleneck(c * 16, c * 16, activation=act),
            CSPLayer(c * 16, c * 16, n=d, shortcut=False, **kw),
        )

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        outputs = {}
        x = self.stem(x)
        outputs["stem"] = x
        for name in ("dark2", "dark3", "dark4", "dark5"):
            x = getattr(self, name)(x)
            outputs[name] = x
        return {k: v for k, v in outputs.items() if k in self.out_features}


class Darknet(nn.Module):
    """The legacy plain Darknet 21 / 53 with leaky-ReLU ``BaseConv``s: a
    stride-1 stem conv, then five groups (a stride-2 conv and ``ResLayer``s:
    1 in the stem, then ``DEPTH2BLOCKS[depth]``), the last followed by the
    SPP tail (1x1, 3x3, ``SPPBottleneck``, 3x3, 1x1). Returns the dict of the
    ``out_features`` maps."""

    DEPTH2BLOCKS = {21: (1, 2, 2, 1), 53: (2, 8, 8, 4)}

    def __init__(self, depth: int, in_channels: int = 3, stem_out_channels: int = 32,
                 out_features: Sequence[str] = ("dark3", "dark4", "dark5")):
        super().__init__()
        if not out_features:
            raise ValueError("please provide output features of Darknet")
        self.out_features = tuple(out_features)
        c = stem_out_channels
        self.stem = nn.Sequential(BaseConv(in_channels, c, 3, 1, act="lrelu"),
                                  *self._group(c, 1))
        c *= 2
        for name, n in zip(("dark2", "dark3", "dark4", "dark5"), self.DEPTH2BLOCKS[depth]):
            setattr(self, name, nn.Sequential(*self._group(c, n)))
            c *= 2  # the group's output width
        self.dark5_spp = nn.Sequential(
            BaseConv(c, c, 1, 1, act="lrelu"),
            BaseConv(c, 2 * c, 3, 1, act="lrelu"),
            SPPBottleneck(2 * c, c, activation="lrelu"),
            BaseConv(c, 2 * c, 3, 1, act="lrelu"),
            BaseConv(2 * c, c, 1, 1, act="lrelu"),
        )

    @staticmethod
    def _group(in_channels: int, num_blocks: int):
        return [BaseConv(in_channels, in_channels * 2, 3, 2, act="lrelu"),
                *[ResLayer(in_channels * 2) for _ in range(num_blocks)]]

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        outputs = {}
        x = self.stem(x)
        outputs["stem"] = x
        for name in ("dark2", "dark3", "dark4"):
            x = getattr(self, name)(x)
            outputs[name] = x
        outputs["dark5"] = self.dark5_spp(self.dark5(x))
        return {k: v for k, v in outputs.items() if k in self.out_features}
