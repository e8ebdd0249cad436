"""Nearest resize with torch ``F.interpolate(mode='nearest')`` semantics,
the counterpart of ``streamyolo_tpu/ops/resize.py::resize_nearest``
(dst index i -> src index floor(i * src / dst); at 600x960 the stride-16
level 38x60 upsamples to the 75x120 skip, a non-integer scale)."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour resize of NCHW ``x`` to spatial ``size`` (h, w)."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="nearest")
