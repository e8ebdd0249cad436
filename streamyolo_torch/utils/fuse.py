"""Conv+BN folding for serving (``--fuse``), the counterpart of
``streamyolo_tpu/utils/fuse.py``.

Every ``BaseConv`` pairs a bias-free ``conv.weight`` (OIHW) with a sibling
``bn``. Folding scales the conv's output channels by
``s = weight / sqrt(running_var + eps)`` and rewrites the BN to an identity
with bias: ``running_mean = 0``, ``running_var = 1 - eps``, ``weight = 1``,
``bias = bias - running_mean * s``. The model then computes what it computed
unfused, with no module surgery; cuDNN still runs the BN as its own pass.

The fold works on a state dict, in float32, so that a bf16 model gets the
fold of the float32 weights cast once (``tools/eval.py`` folds before it
loads the weights into the model). It equals the JAX package's fold bit for
bit, which int8 quantization (``quant/ptq.py``) needs: one ulp in a folded
kernel can move its ``w_scale``.
"""

from __future__ import annotations

from typing import Dict

import torch

from streamyolo_torch.nn.blocks import BN_EPS


def fuse_state_dict(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A new state dict with every ``<prefix>.conv.weight`` +
    ``<prefix>.bn.*`` pair folded; other entries are shared, not copied."""
    out = dict(state_dict)
    for key, kernel in state_dict.items():
        if key != "conv.weight" and not key.endswith(".conv.weight"):
            continue  # (a BaseConv at the root has no prefix)
        bn = key[: -len("conv.weight")] + "bn."
        if bn + "running_var" not in state_dict:
            continue
        scale = state_dict[bn + "weight"].float()
        bias = state_dict[bn + "bias"].float()
        mean = state_dict[bn + "running_mean"].float()
        var = state_dict[bn + "running_var"].float()
        # the square root in float64, rounded once: correctly rounded, as
        # NumPy's float32 sqrt is (the JAX fold's); PyTorch's float32 sqrt
        # on the CPU is not always
        s = scale / torch.sqrt((var + BN_EPS).double()).float()
        out[key] = (kernel.float() * s[:, None, None, None]).to(kernel.dtype)
        out[bn + "weight"] = torch.ones_like(state_dict[bn + "weight"])
        out[bn + "bias"] = (bias - mean * s).to(state_dict[bn + "bias"].dtype)
        out[bn + "running_mean"] = torch.zeros_like(state_dict[bn + "running_mean"])
        out[bn + "running_var"] = torch.full_like(state_dict[bn + "running_var"], 1.0 - BN_EPS)
    return out
