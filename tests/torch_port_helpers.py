"""Shared pieces of the ``test_torch_*.py`` parity tests: JAX variables with
non-trivial BatchNorm statistics, their conversion into the PyTorch port,
and the guard for tests that need a CUDA card."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from streamyolo_torch.utils.weights import jax_variables_to_state_dict


def randomize_bn(variables, seed: int = 0):
    """Copy of flax ``variables`` with every BatchNorm's scale/bias/mean/var
    drawn from a seeded numpy generator (init leaves them at identity, which
    would hide a wrong eps or a swapped statistic)."""
    rng = np.random.default_rng(seed)

    def walk(tree, collection, in_bn=False):
        out = {}
        for key, value in tree.items():
            if isinstance(value, dict):
                out[key] = walk(value, collection, in_bn=(key == "bn"))
                continue
            arr = np.asarray(value, np.float32)
            if in_bn and key == "scale":
                arr = rng.uniform(0.5, 1.5, arr.shape).astype(np.float32)
            elif in_bn and key == "bias" and collection == "params":
                arr = rng.normal(0, 0.1, arr.shape).astype(np.float32)
            elif key == "mean":
                arr = rng.normal(0, 0.1, arr.shape).astype(np.float32)
            elif key == "var":
                arr = rng.uniform(0.5, 1.5, arr.shape).astype(np.float32)
            out[key] = arr
        return out

    return {c: walk(dict(v), c) for c, v in variables.items()}


def load_port(module: torch.nn.Module, variables) -> torch.nn.Module:
    """Load converted JAX ``variables`` into the port ``module`` (strict)."""
    module.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    return module.eval()


def lift_pred_biases(variables):
    """Zero the obj/cls prediction biases (prior-prob init puts every score
    near 1e-4, so NMS would see no candidates)."""
    out = {c: dict(v) for c, v in variables.items()}
    head = dict(out["params"]["head"])
    for name, leaf in head.items():
        if name.startswith(("obj_preds_", "cls_preds_")):
            head[name] = {**leaf, "bias": np.zeros_like(np.asarray(leaf["bias"]))}
    out["params"]["head"] = head
    return out


def nhwc_to_nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def require_cuda():
    """Skip the calling test unless a CUDA card and nvcc are present."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: pytest -m cuda)")
