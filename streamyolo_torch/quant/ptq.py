"""Post-training int8 quantization for serving, the counterpart of
``streamyolo_tpu/quant/ptq.py``.

Fold BN into the conv weights (``utils/fuse.py``, in float32), observe
per-conv input ranges over a calibration set, and re-emit the state dict
with every calibrated CBS conv (a ``BaseConv``) as a symmetric-int8
``kernel_q`` plus scales. A ``BaseConv`` that loads them runs its conv
through ``ops/int8_conv.py``: int8 x int8 -> int32 on the card's tensor
cores, dequantized in the kernel's epilogue. The head's ``*_preds`` convs
are plain ``nn.Conv2d`` (no BN) and stay full precision, as in the JAX
package.

Scheme: activations per tensor (or, with ``per_channel_act``, per input
channel) and weights per output channel, symmetric, to [-127, 127]; zero
points are 0, so the int32 sum needs no correction terms.

Every scale is computed as the JAX package computes it, so that the two
give the same int8 model from the same calibration: the per-tensor
``act_scale`` is ``float32(float64(absmax.max()) / 127)``; ``w_scale`` and
the per-channel scales are float32 divisions; ``kernel_q`` rounds half to
even. ``skip`` regexes match the module's path as the JAX package names it
(``backbone/backbone/dark2_0``, ``flax_module_path``), so a regex selects
the same convs in both packages.

Quantization changes the numbers: validate AP on real data with
``tools/validate_baseline.py --int8`` before shipping an int8 deployment.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Mapping, Sequence

import numpy as np
import torch

from streamyolo_torch.nn.blocks import BaseConv
from streamyolo_torch.utils.fuse import fuse_state_dict

_SCALE_FLOOR = 1e-8  # all-zero calibration input: keep the divide finite


def flax_module_path(prefix: str) -> str:
    """A torch module name -> the JAX package's '/'-joined module path: a
    list index joins the segment before it (``backbone.backbone.dark2.0`` ->
    ``backbone/backbone/dark2_0``, ``head.cls_convs.0.1`` ->
    ``head/cls_convs_0_1``); the inverse of ``utils/weights.py``'s rule."""
    out = []
    for seg in prefix.split("."):
        if seg.isdigit() and out:
            out[-1] = f"{out[-1]}_{seg}"
        else:
            out.append(seg)
    return "/".join(out)


@torch.no_grad()
def calibrate_activations(model: torch.nn.Module, batches: Iterable,
                          **forward_kwargs) -> Dict[str, torch.Tensor]:
    """Run ``model`` (in eval mode) over ``batches`` (NHWC NumPy arrays or
    tensors, as the forward takes them) and return each ``BaseConv``'s
    per-input-channel absmax, ``{module name: float32 [C_in]}``: the maximum
    of ``abs(float32(x))`` over N, H, W, every call and every batch.

    ``forward_kwargs`` go to the model; ``mode='off_pipe'`` by default (the
    6-channel dual-frame input runs every backbone conv, the DFP fusion
    convs included)."""
    forward_kwargs.setdefault("mode", "off_pipe")
    absmax: Dict[str, torch.Tensor] = {}

    def observe(name):
        def pre_hook(module, args):
            a = args[0].detach().float().abs().amax(dim=(0, 2, 3))
            prev = absmax.get(name)
            absmax[name] = a if prev is None else torch.maximum(prev, a)
        return pre_hook

    device = next(model.parameters()).device
    handles = [m.register_forward_pre_hook(observe(n))
               for n, m in model.named_modules() if isinstance(m, BaseConv)]
    was_training = model.training
    model.eval()
    n_batches = 0
    try:
        for x in batches:
            x = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
            model(x.to(device), **forward_kwargs)
            n_batches += 1
    finally:
        for h in handles:
            h.remove()
        model.train(was_training)
    if not n_batches:
        raise ValueError("calibration needs at least one batch")
    return {k: v.cpu() for k, v in absmax.items()}


def quantize_state_dict(state_dict: Mapping[str, torch.Tensor],
                        absmax: Mapping[str, torch.Tensor], *, skip: Sequence[str] = (),
                        strip: bool = False,
                        per_channel_act: bool = False) -> Dict[str, torch.Tensor]:
    """A float32 serving state dict: BN folded, and every calibrated CBS
    conv (``absmax`` from ``calibrate_activations``) given
    ``<prefix>.kernel_q`` (int8 OIHW), ``<prefix>.w_scale`` (float32
    [C_out]) and ``<prefix>.act_scale`` (float32 scalar, or [C_in] with
    ``per_channel_act``).

    ``skip``: regexes searched in ``flax_module_path(prefix)``; matching
    convs keep the float path. ``strip``: each quantized conv's
    ``conv.weight`` becomes a 1-element placeholder. ``per_channel_act``:
    one activation scale per input channel, folded into the kernel before
    its per-output-channel quantization; a conv whose kernel's input extent
    differs from the calibration vector (a grouped conv) keeps the
    per-tensor scale. Raises ``ValueError`` when no conv matched."""
    floats = {k: v.float() if v.is_floating_point() else v for k, v in state_dict.items()}
    out = fuse_state_dict(floats)
    skip_res = [re.compile(s) for s in skip]
    n_quantized = 0
    for prefix, observed in absmax.items():
        pre = f"{prefix}." if prefix else ""  # "" is a BaseConv at the root
        kernel_key = f"{pre}conv.weight"
        if kernel_key not in out or f"{pre}bn.running_var" not in out:
            continue
        if any(r.search(flax_module_path(prefix)) for r in skip_res):
            continue
        kernel = out[kernel_key]
        observed = torch.clamp_min(observed.float(), _SCALE_FLOOR)
        if per_channel_act and observed.ndim == 1 and kernel.shape[1] == observed.shape[0]:
            s_c = observed / 127.0
            kernel = kernel * s_c[None, :, None, None]
            act_scale = s_c
        else:
            act_scale = torch.tensor(float(observed.max()) / 127.0, dtype=torch.float32)
        w_absmax = torch.clamp_min(kernel.abs().amax(dim=(1, 2, 3)), _SCALE_FLOOR)
        w_scale = w_absmax / 127.0
        out[f"{pre}kernel_q"] = torch.clamp(
            torch.round(kernel / w_scale[:, None, None, None]), -127, 127).to(torch.int8)
        out[f"{pre}w_scale"] = w_scale
        out[f"{pre}act_scale"] = act_scale
        if strip:
            out[kernel_key] = torch.zeros((1, 1, 1, 1), dtype=torch.float32)
        n_quantized += 1
    if not n_quantized:
        raise ValueError(
            "no conv matched the calibration — was calibrate_activations run on a "
            "model with this state dict's structure?")
    return out


def quantize_for_serving(model: torch.nn.Module, state_dict: Mapping[str, torch.Tensor],
                         batches: Iterable, *, skip: Sequence[str] = (), strip: bool = False,
                         per_channel_act: bool = False,
                         **forward_kwargs) -> Dict[str, torch.Tensor]:
    """Calibrate ``model`` (holding ``state_dict``'s float weights) over
    ``batches``, then quantize the float32 ``state_dict``; see the two
    steps above. Load the result with ``model.load_state_dict(q,
    strict=True)``."""
    absmax = calibrate_activations(model, batches, **forward_kwargs)
    return quantize_state_dict(state_dict, absmax, skip=skip, strip=strip,
                               per_channel_act=per_channel_act)
