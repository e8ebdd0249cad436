"""Learning-rate schedules, the counterpart of ``streamyolo_tpu/train/lr.py``
(yolox ``LRScheduler``): plain functions of the step that the train step
sets on the optimizer's parameter groups before each update.

The shipped configs use ``yoloxwarmcos`` with ``warmup_epochs=1``,
``warmup_lr_start=0``, ``min_lr_ratio=0.05`` and ``no_aug_epochs = max_epoch``:
the cosine segment is empty, so the schedule is a quadratic warmup to
``lr`` over the first epoch and then a constant ``0.05 * lr`` (a quirk of
the reference recipe, kept). The LR of step 0 is 0.
"""

from __future__ import annotations

import math
from typing import Callable


def yolox_warm_cos_lr(lr: float, min_lr_ratio: float, total_iters: int,
                      warmup_total_iters: int, warmup_lr_start: float,
                      no_aug_iters: int) -> Callable[[int], float]:
    """``schedule(step) -> lr`` of yolox's ``yoloxwarmcos``."""
    min_lr = lr * min_lr_ratio
    cos_span = max(total_iters - warmup_total_iters - no_aug_iters, 1)

    def schedule(step: int) -> float:
        step = float(step)
        if step <= warmup_total_iters:
            return ((lr - warmup_lr_start) * (step / max(warmup_total_iters, 1)) ** 2
                    + warmup_lr_start)
        if step >= total_iters - no_aug_iters:
            return min_lr
        return min_lr + 0.5 * (lr - min_lr) * (
            1.0 + math.cos(math.pi * (step - warmup_total_iters) / cos_span))

    return schedule


def build_lr_schedule(scheduler: str, lr: float, iters_per_epoch: int, max_epoch: int,
                      warmup_epochs: float = 1.0, warmup_lr_start: float = 0.0,
                      min_lr_ratio: float = 0.05,
                      no_aug_epochs: int = 0) -> Callable[[int], float]:
    """The schedule of a yolox ``LRScheduler`` name: ``yoloxwarmcos``,
    ``warmcos`` or ``constant``."""
    total = iters_per_epoch * max_epoch
    warmup = int(iters_per_epoch * warmup_epochs)
    if scheduler == "yoloxwarmcos":
        return yolox_warm_cos_lr(lr, min_lr_ratio, total, warmup, warmup_lr_start,
                                 int(iters_per_epoch * no_aug_epochs))
    if scheduler == "warmcos":
        return yolox_warm_cos_lr(lr, min_lr_ratio, total, warmup, warmup_lr_start, 0)
    if scheduler == "constant":
        return lambda step: float(lr)
    raise ValueError(f"Unknown scheduler: {scheduler}")
