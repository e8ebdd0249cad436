"""The StreamYOLO train step, the counterpart of
``streamyolo_tpu/train/step.py``: forward, SimOTA + loss, backward, SGD,
EMA.

  * The forward runs in train mode (batch statistics, two pafpn passes for
    the current and the support frame) under
    ``torch.autocast(..., torch.bfloat16)`` when ``fp16``; the weights stay
    float32 (master weights; SGD on bf16 weights would lose every update
    below one ulp) and no GradScaler is needed (bf16 has float32's range).
  * The assignment and the loss run after the autocast region, on the maps
    cast to float32, as everything after the head is float32 in JAX.
  * The LR of step ``state.step`` is set on every parameter group before
    the SGD update (``lr(0)`` is 0 under the warmup schedules).
  * ``ModelEMA`` follows every float entry of the state dict, parameters and
    BatchNorm running statistics alike, with
    ``d = 0.9998 * (1 - exp(-updates / 2000))`` and ``updates = step + 1``.

Data parallel (``parallel/``): under a process group of more than one
rank each rank steps on its slice of the global batch. BatchNorm and the
loss normalizers reduce over the global batch, each rank's loss is its
share of the global-batch loss, and the rank gradients are **summed**
(``all_reduce_grads``, in buckets) before SGD, so the step computes what
one process computes on the whole batch, as the JAX step does under its
data mesh, and every rank ends it with the same weights, BatchNorm
statistics, momentum and EMA. The metrics are the global ones (one
all-reduce of the packed shares). With no group, or a world of 1, none of
this runs.

``remat=True`` rematerialises the forward, as the JAX step's ``remat``
does with ``jax.checkpoint``: the model's ``off_pipe`` forward, inside the
autocast region, is one region that keeps no activation (SimOTA and the
loss stay outside it). Its first pass runs without autograd and hands the
loss its maps as leaves; the backward takes the loss's gradient as far as
those maps, runs the forward again with autograd under the same autocast,
and back-propagates the maps' gradients through it. The re-run runs in
``nn/blocks.py::recomputing()``, so BatchNorm normalises by the same batch
statistics and moves its running statistics and count once per step
(under a process group the re-run all-reduces its statistics again, on
every rank in the same order). The step's results are those of the plain
step, bit for bit. The re-run runs in the calling thread, not inside the
autograd engine as ``torch.utils.checkpoint``'s does: cuDNN keeps its
chosen plans per thread, and in the engine's device thread a convolution
of the re-run may take another plan than its first pass and round
otherwise (``PERF.md``, the card's runs of the rematerialised step). Like
the JAX trainer, the port's trainer and its CLI never set it; ``bench_suite
--remat`` measures it.

Nothing synchronises with the host: the metrics are 0-d tensors on the
device (and the float ``lr``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from streamyolo_torch.models.losses import streamyolo_losses
from streamyolo_torch.nn.blocks import recomputing
from streamyolo_torch.parallel.multihost import (
    all_reduce_grads,
    all_reduce_sum_,
    get_world_size,
)
from streamyolo_torch.train.optimizer import sgd_optimizer

EMA_DECAY = 0.9998


def ema_decay(updates: int) -> float:
    """The EMA decay after ``updates`` updates, rounded as the JAX package
    computes it (float32)."""
    f32 = np.float32
    return float(f32(EMA_DECAY) * (f32(1.0) - np.exp(f32(-updates) / f32(2000.0))))


class ModelEMA:
    """yolox ``ModelEMA`` over ``model``'s state dict: ``state`` is a copy of
    the whole state dict, and ``update`` moves its float entries toward the
    model's. It reads the model's tensors in place, so it stays bound to the
    model it was made from (and its device)."""

    def __init__(self, model: nn.Module):
        src = model.state_dict()
        self.state: Dict[str, torch.Tensor] = {k: v.detach().clone() for k, v in src.items()}
        self._keys = [k for k, v in src.items() if v.is_floating_point()]
        self._src = [src[k] for k in self._keys]

    @torch.no_grad()
    def update(self, updates: int) -> None:
        d = ema_decay(updates)
        ema = [self.state[k] for k in self._keys]
        torch._foreach_mul_(ema, d)
        torch._foreach_add_(ema, self._src, alpha=float(np.float32(1.0) - np.float32(d)))


@dataclasses.dataclass
class TrainState:
    """What a train step updates in place: the model (weights and BatchNorm
    statistics), the optimizer (momentum buffers), the EMA, and the step."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    ema: ModelEMA
    step: int = 0


def create_train_state(model: nn.Module, momentum: float = 0.9,
                       weight_decay: float = 5e-4) -> TrainState:
    """A fresh state: SGD over ``model``'s groups, the EMA at the weights."""
    return TrainState(model, sgd_optimizer(model, momentum, weight_decay), ModelEMA(model), 0)


def load_carried_state(state: TrainState, carried: Dict) -> None:
    """Install a train state carried across from the JAX package
    (``utils/weights.py::jax_train_state_to_port``): the weights and
    BatchNorm statistics, the EMA, every parameter's momentum buffer, and
    the step."""
    model = state.model
    model.load_state_dict(carried["model"])
    with torch.no_grad():
        for k, v in carried["ema"].items():
            state.ema.state[k].copy_(v)
    for name, p in model.named_parameters():
        state.optimizer.state[p]["momentum_buffer"] = carried["momentum"][name].to(
            p.device, p.dtype).clone()
    state.step = carried["step"]


def make_train_step(num_classes: int, lr_schedule: Callable[[int], float],
                    strides=(8, 16, 32), gamma: float = 1.0, ignore_thr: float = 0.5,
                    ignore_value: float = 1.5, use_l1: bool = True, use_tal: bool = True,
                    fp16: bool = False, remat: bool = False):
    """``train_step(state, batch) -> metrics``. The batch: ``images``
    [B, H, W, 6] (current ++ support, uint8 or float, on the model's device),
    ``labels`` and ``support_labels`` [B, M, 5] (cls, cx, cy, w, h),
    zero-padded. ``remat``: rematerialise the forward (module docstring).

    ``loss_fn(model, batch)``: the losses of the plain forward, whose
    gradient reaches the parameters under ``remat`` too. The step's parts,
    for tools that time them: ``forward(model, images)`` (the maps; under
    ``remat`` the first pass, leaves without a graph) and
    ``backward(model, images, outputs, loss)`` (the gradient into the
    parameters; under ``remat`` with the re-run)."""

    def autocast(images: torch.Tensor):
        return torch.autocast(images.device.type, dtype=torch.bfloat16, enabled=fp16)

    def plain_forward(model: nn.Module, images: torch.Tensor):
        with autocast(images):
            return model(images, mode="off_pipe")

    def forward(model: nn.Module, images: torch.Tensor):
        if not remat:
            return plain_forward(model, images)
        with autocast(images), torch.no_grad():
            outputs = model(images, mode="off_pipe")
        return [o.detach().requires_grad_() for o in outputs]

    def backward(model: nn.Module, images: torch.Tensor, outputs, loss: torch.Tensor):
        if not remat:
            loss.backward()
            return
        grads = torch.autograd.grad(loss, outputs)
        with autocast(images), recomputing():
            again = model(images, mode="off_pipe")
        torch.autograd.backward(again, grads)

    def losses_of(outputs, batch) -> Dict[str, torch.Tensor]:
        return streamyolo_losses(
            outputs, batch["labels"], batch.get("support_labels") if use_tal else None,
            num_classes=num_classes, strides=strides, gamma=gamma, ignore_thr=ignore_thr,
            ignore_value=ignore_value, use_l1=use_l1, use_tal=use_tal)

    def loss_fn(model: nn.Module, batch) -> Dict[str, torch.Tensor]:
        return losses_of(plain_forward(model, batch["images"]), batch)

    def train_step(state: TrainState, batch) -> Dict[str, Optional[torch.Tensor]]:
        state.model.train()
        lr = lr_schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        images = batch["images"]
        outputs = forward(state.model, images)
        losses = losses_of(outputs, batch)
        state.optimizer.zero_grad(set_to_none=True)
        backward(state.model, images, outputs, losses["total_loss"])
        metrics = {k: v.detach() for k, v in losses.items()}
        if get_world_size() > 1:
            all_reduce_grads(state.model.parameters())
            shares = [k for k in metrics if k != "num_fg"]  # num_fg is global already
            summed = all_reduce_sum_(torch.stack([metrics[k] for k in shares]))
            metrics.update(zip(shares, summed.unbind()))
        state.optimizer.step()
        state.step += 1
        state.ema.update(state.step)
        metrics["lr"] = lr
        return metrics

    train_step.forward = forward
    train_step.loss_fn = loss_fn
    train_step.backward = backward
    return train_step
