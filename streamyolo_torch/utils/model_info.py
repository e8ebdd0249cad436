"""Model cost summary for ``--speed``: parameters and GFLOPs, the
counterpart of ``streamyolo_tpu/utils/model_info.py``.

GFLOPs come from ``torch.utils.flop_counter`` over one forward of a
3-channel input at ``tsize`` (the ``off_pipe`` self-duplicate mode, as the
JAX package counts it): convolutions and matrix products, 2 operations per
multiply-add.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode


def count_params(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def get_model_info(model: torch.nn.Module, tsize: Tuple[int, int]) -> str:
    """'Params: {:.2f}M, Gflops: {:.2f}' for a [1, h, w, 3] input."""
    h, w = tsize
    device = next(model.parameters()).device
    x = torch.zeros((1, h, w, 3), dtype=torch.uint8, device=device)
    with torch.inference_mode(), FlopCounterMode(display=False) as counter:
        model(x, mode="off_pipe")
    flops = counter.get_total_flops()
    return f"Params: {count_params(model) / 1e6:.2f}M, Gflops: {flops / 1e9:.2f}"
