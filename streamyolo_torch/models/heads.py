"""Decoupled YOLOX detection head (TAL / PIPE variants) in PyTorch.

Counterpart of ``streamyolo_tpu/models/heads.py``: per level a 1x1 stem,
2x 3x3 cls and reg branches, and 1x1 cls / reg / obj prediction convs whose
cls/obj biases start at ``-log((1 - p) / p)``, p = 1e-2. The head returns
raw NCHW maps ordered (reg, obj, cls); ``eval_outputs`` applies the sigmoid
to obj/cls only, flattens the anchors row-major per level with the levels
in stride order, and decodes ``xy = (pred + grid) * stride``,
``wh = exp(pred) * stride``. The sigmoid and the exp run in the maps' own
dtype (bf16 on the serving path) and the result is float32, as in the JAX
package.
"""

from __future__ import annotations

import functools
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from streamyolo_torch.nn.blocks import BaseConv, DWConv


class YOLOXHead(nn.Module):
    def __init__(self, num_classes: int, width: float = 1.0,
                 strides: Sequence[int] = (8, 16, 32),
                 in_channels: Sequence[int] = (256, 512, 1024),
                 act: str = "silu", depthwise: bool = False,
                 prior_prob: float = 1e-2):
        super().__init__()
        self.num_classes = num_classes
        self.strides = tuple(strides)
        Conv = DWConv if depthwise else BaseConv
        feat = int(256 * width)
        self.stems = nn.ModuleList()
        self.cls_convs = nn.ModuleList()
        self.reg_convs = nn.ModuleList()
        self.cls_preds = nn.ModuleList()
        self.reg_preds = nn.ModuleList()
        self.obj_preds = nn.ModuleList()
        for c in in_channels:
            self.stems.append(BaseConv(int(c * width), feat, 1, 1, act=act))
            self.cls_convs.append(nn.Sequential(
                Conv(feat, feat, 3, 1, act=act), Conv(feat, feat, 3, 1, act=act)))
            self.reg_convs.append(nn.Sequential(
                Conv(feat, feat, 3, 1, act=act), Conv(feat, feat, 3, 1, act=act)))
            self.cls_preds.append(nn.Conv2d(feat, num_classes, 1))
            self.reg_preds.append(nn.Conv2d(feat, 4, 1))
            self.obj_preds.append(nn.Conv2d(feat, 1, 1))
        self.prior_prob = prior_prob
        self.initialize_biases(prior_prob)

    def initialize_biases(self, prior_prob: float) -> None:
        bias = -math.log((1 - prior_prob) / prior_prob)
        with torch.no_grad():
            for m in list(self.cls_preds) + list(self.obj_preds):
                m.bias.fill_(bias)

    def forward(self, xin: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        outputs = []
        for k, x in enumerate(xin):
            x = self.stems[k](x)
            cls_out = self.cls_preds[k](self.cls_convs[k](x))
            reg_feat = self.reg_convs[k](x)
            outputs.append(torch.cat(
                [self.reg_preds[k](reg_feat), self.obj_preds[k](reg_feat), cls_out],
                dim=1))
        return outputs


class TALHead(YOLOXHead):
    """Trunk + Trend-Aware Loss hyperparameters (the loss itself is not part
    of the serving path)."""

    def __init__(self, *args, gamma: float = 1.5, ignore_thr: float = 0.2,
                 ignore_value: float = 0.2, **kwargs):
        super().__init__(*args, **kwargs)
        self.gamma = gamma
        self.ignore_thr = ignore_thr
        self.ignore_value = ignore_value


class PIPEHead(YOLOXHead):
    """Plain YOLOX head (still-frame config, no trend weighting)."""


def level_grids(
    hw: Sequence[Tuple[int, int]], strides: Sequence[int]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(grid_xy [N,2], expanded_strides [N], level_id [N]) as NumPy; anchors
    row-major per level, levels in stride order."""
    xs, ss, lids = [], [], []
    for lid, ((h, w), s) in enumerate(zip(hw, strides)):
        yv, xv = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        xs.append(np.stack([xv.reshape(-1), yv.reshape(-1)], axis=-1))
        ss.append(np.full((h * w,), s))
        lids.append(np.full((h * w,), lid))
    return (
        np.concatenate(xs, 0).astype(np.float32),
        np.concatenate(ss, 0).astype(np.float32),
        np.concatenate(lids, 0),
    )


@functools.lru_cache(maxsize=16)
def _device_grids(hw: Tuple[Tuple[int, int], ...], strides: Tuple[int, ...],
                  device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grid constants on ``device``, made once per geometry (not per frame),
    outside inference mode: the eval (under ``torch.inference_mode``) and the
    training loss (under autograd) share them."""
    grid_xy, exp_strides, _ = level_grids(hw, strides)
    with torch.inference_mode(False):
        return (torch.from_numpy(grid_xy).to(device),
                torch.from_numpy(exp_strides).to(device))


def flatten_levels(outputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-level NCHW maps -> [B, N_total, C], anchors row-major per level."""
    return torch.cat([o.flatten(2).transpose(1, 2) for o in outputs], dim=1)


def decode_outputs(flat: torch.Tensor, grid_xy: torch.Tensor,
                   strides: torch.Tensor) -> torch.Tensor:
    """Raw flattened [B, N, 5+C] -> (cx, cy, w, h) in pixels; obj/cls pass.

    ``exp`` runs in ``flat``'s dtype; the float32 grid and strides promote
    xy and wh to float32, and the obj/cls channels are promoted at the
    concatenation, as in the JAX package."""
    strides = strides[None, :, None]
    xy = (flat[..., :2] + grid_xy[None]) * strides
    wh = torch.exp(flat[..., 2:4]) * strides
    return torch.cat([xy, wh, flat[..., 4:].float()], dim=-1)


def eval_outputs(outputs: Sequence[torch.Tensor], strides: Sequence[int]) -> torch.Tensor:
    """Sigmoid obj/cls, flatten, decode -> float32 [B, N, 5+C].

    Rounds where the JAX package rounds: its ``jax.nn.sigmoid`` lowers to
    negate, exp, add and divide, each rounded to the maps' dtype, so the
    sigmoid is written out as those four ops (``torch.sigmoid`` rounds once
    and differs in bf16)."""
    hw = tuple(tuple(int(d) for d in o.shape[-2:]) for o in outputs)
    grid_xy, exp_strides = _device_grids(hw, tuple(strides), outputs[0].device)
    flat = flatten_levels(outputs)
    flat = torch.cat([flat[..., :4], 1 / (1 + torch.exp(-flat[..., 4:]))], dim=-1)
    return decode_outputs(flat, grid_xy, exp_strides)
