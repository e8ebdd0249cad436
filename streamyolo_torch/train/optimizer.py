"""SGD with yolox's parameter groups, the counterpart of
``streamyolo_tpu/train/optimizer.py``.

``torch.optim.SGD(momentum=0.9, nesterov=True)`` over three groups, in
yolox's order: BatchNorm weights (no decay), conv weights
(``weight_decay``), biases (no decay). The groups are decided by module
type, not by name: a BatchNorm scale is also called ``weight`` in torch.
The conv weights are exactly the JAX package's decayed leaves (flax
``kernel``, the prediction convs included). Torch adds the decay to the
gradient before the momentum buffer, as the JAX chain
``add_decayed_weights`` -> ``trace(nesterov)`` does.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn


def param_groups(model: nn.Module) -> Tuple[List[nn.Parameter], List[nn.Parameter],
                                            List[nn.Parameter]]:
    """(BatchNorm weights, conv weights, biases) of ``model``; raises if a
    parameter falls in none of them."""
    bn_w, conv_w, biases = [], [], []
    for m in model.modules():
        if isinstance(m, nn.modules.batchnorm._BatchNorm):
            bn_w.append(m.weight)
            biases.append(m.bias)
        elif isinstance(m, (nn.Conv2d, nn.Linear)):
            conv_w.append(m.weight)
            if m.bias is not None:
                biases.append(m.bias)
    grouped = {id(p) for p in bn_w + conv_w + biases}
    stray = [n for n, p in model.named_parameters() if id(p) not in grouped]
    if stray:
        raise ValueError(f"parameters outside the SGD groups: {stray[:5]}")
    return bn_w, conv_w, biases


def sgd_optimizer(model: nn.Module, momentum: float = 0.9, weight_decay: float = 5e-4,
                  nesterov: bool = True) -> torch.optim.SGD:
    """The optimizer over ``param_groups(model)``; the LR is set per step by
    the train step (it starts at 0)."""
    bn_w, conv_w, biases = param_groups(model)
    return torch.optim.SGD(
        [{"params": bn_w, "weight_decay": 0.0},
         {"params": conv_w, "weight_decay": weight_decay},
         {"params": biases, "weight_decay": 0.0}],
        lr=0.0, momentum=momentum, nesterov=nesterov)
