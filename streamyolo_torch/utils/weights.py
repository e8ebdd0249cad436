"""Weights carried across from the JAX package and from released files.

The port's modules use the yolox ``state_dict`` names
(``backbone.backbone.dark2.0.conv.weight``, ``head.cls_convs.0.0.conv.weight``,
``head.stems.0...``), so a released ``.pth`` loads ``strict=True``.

``flax_path_to_torch`` is the port's own copy of the naming rules of
``streamyolo_tpu/utils/torch_import.py:90-123``:

  * a flax segment ending in ``_<digits>`` is a torch list index
    (``dark2_0`` -> ``dark2.0``, ``m_0_1`` -> ``m.0.1``);
  * a 4-D ``kernel`` transposes HWIO -> OIHW, a 2-D one [in, out] -> [out, in];
  * BatchNorm ``scale`` -> ``weight``; ``batch_stats`` ``mean``/``var`` ->
    ``running_mean``/``running_var``;
  * the int8 ``quant`` collection (``quant/ptq.py``) -> the ``BaseConv``'s
    ``kernel_q`` (HWIO -> OIHW, int8 kept), ``w_scale`` and ``act_scale``
    (float32 kept); a stripped 1-element ``conv.weight`` comes across as it
    is.

JAX exports no ``num_batches_tracked``; the loaders here fill it (0) for
every BatchNorm so strict loading works. ``merge_state_dict`` puts a loaded
checkpoint over a model's own state dict, strictly (eval) or tolerating
missing and mismatched entries (fine-tuning). ``jax_train_state_to_port``
carries a whole mid-training state across: weights, BatchNorm statistics,
SGD momentum, EMA and step.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch


def flax_path_to_torch(
    collection: str, path: Tuple[str, ...], ndim: int
) -> Tuple[str, Optional[Tuple[int, ...]]]:
    """One flax variables leaf -> (torch state_dict key, transpose to apply)."""
    segments = []
    for seg in path[:-1]:
        parts = seg.split("_")
        i = len(parts)
        while i > 1 and parts[i - 1].isdigit():
            i -= 1
        segments.append("_".join(parts[:i]))
        segments.extend(parts[i:])
    leaf = path[-1]
    prefix = ".".join(segments)
    if collection == "quant":
        if leaf not in ("kernel_q", "w_scale", "act_scale"):
            raise KeyError(f"Unrecognized quant leaf: {'/'.join(path)}")
        transpose = (3, 2, 0, 1) if leaf == "kernel_q" and ndim == 4 else None
        return (f"{prefix}.{leaf}" if prefix else leaf), transpose
    if collection == "batch_stats":
        if leaf not in ("mean", "var"):
            raise KeyError(f"Unrecognized batch_stats leaf: {'/'.join(path)}")
        return f"{prefix}.running_{leaf}", None
    if leaf == "kernel":
        if ndim == 4:  # HWIO -> OIHW
            return f"{prefix}.weight", (3, 2, 0, 1)
        if ndim == 2:  # flax Dense [in, out] -> torch Linear [out, in]
            return f"{prefix}.weight", (1, 0)
        return f"{prefix}.weight", None
    if leaf == "scale":
        return f"{prefix}.weight", None
    if leaf == "bias":
        return f"{prefix}.bias", None
    raise KeyError(f"Unrecognized flax parameter leaf: {collection}/{'/'.join(path)}")


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def with_num_batches_tracked(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Add a zero ``num_batches_tracked`` beside every ``running_mean`` that
    lacks one (JAX and some exporters do not write it)."""
    out = dict(state_dict)
    for key in state_dict:
        if key.endswith(".running_mean"):
            nbt = key[: -len("running_mean")] + "num_batches_tracked"
            out.setdefault(nbt, torch.zeros((), dtype=torch.long))
    return out


def jax_variables_to_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Nested ``{'params', 'batch_stats'[, 'quant']}`` dict of arrays -> the
    port's state dict (torch names, OIHW convs, ``num_batches_tracked``
    filled; arrays keep their dtype)."""
    out: Dict[str, torch.Tensor] = {}
    for full_path, value in _flatten(variables):
        collection, path = full_path[0], full_path[1:]
        arr = np.asarray(value)
        key, transpose = flax_path_to_torch(collection, path, arr.ndim)
        if transpose is not None:
            arr = arr.transpose(transpose)
        out[key] = torch.from_numpy(np.array(arr, copy=True, order="C"))
    return with_num_batches_tracked(out)


def jax_train_state_to_port(state: Mapping[str, Any]) -> Dict[str, Any]:
    """The JAX ``TrainState``'s trees, as NumPy arrays -> the port's train
    state.

    ``state`` holds ``params``, ``batch_stats``, ``trace`` (the momentum of
    optax's ``trace`` transform, a tree like ``params``), ``ema_params``,
    ``ema_batch_stats`` and ``step``. Returns ``model`` and ``ema`` (state
    dicts), ``momentum`` (parameter name -> SGD momentum buffer, convs
    OIHW) and ``step`` (an int); ``train/step.py::load_carried_state``
    installs them."""
    momentum = {}
    for path, value in _flatten(state["trace"]):
        arr = np.asarray(value)
        key, transpose = flax_path_to_torch("params", path, arr.ndim)
        if transpose is not None:
            arr = arr.transpose(transpose)
        momentum[key] = torch.from_numpy(np.array(arr, copy=True, order="C"))
    return {
        "model": jax_variables_to_state_dict(
            {"params": state["params"], "batch_stats": state["batch_stats"]}),
        "ema": jax_variables_to_state_dict(
            {"params": state["ema_params"], "batch_stats": state["ema_batch_stats"]}),
        "momentum": momentum,
        "step": int(np.asarray(state["step"])),
    }


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """Read a released-format ``.pth`` (a raw state dict, or a trainer
    checkpoint holding it under ``model``) or a ``.safetensors`` file with
    torch names (needs the ``safetensors`` package)."""
    if str(path).endswith(".safetensors"):
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            raise ImportError(
                "reading .safetensors needs the safetensors package") from e
        state_dict = load_file(path)
    else:
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        state_dict = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    return with_num_batches_tracked(
        {k: torch.as_tensor(v) for k, v in state_dict.items()})


def merge_state_dict(base: Mapping[str, torch.Tensor], loaded: Mapping[str, torch.Tensor],
                     strict: bool = True) -> Dict[str, torch.Tensor]:
    """``base`` with its entries replaced by ``loaded``'s. ``strict``: the
    two must hold the same keys with the same shapes, else ``KeyError`` /
    ``ValueError`` naming them. Not strict: entries missing from
    ``loaded`` or of another shape keep ``base``'s values and are logged."""
    missing = sorted(set(base) - set(loaded))
    unexpected = sorted(set(loaded) - set(base))
    mismatched = {k for k in set(base) & set(loaded)
                  if tuple(base[k].shape) != tuple(loaded[k].shape)}
    if strict and (missing or unexpected):
        raise KeyError(f"checkpoint keys differ from the model's: missing "
                       f"{missing[:5]} ({len(missing)}), unexpected {unexpected[:5]} "
                       f"({len(unexpected)})")
    if strict and mismatched:
        raise ValueError(f"checkpoint shapes differ from the model's at "
                         f"{sorted(mismatched)[:5]} ({len(mismatched)})")
    if missing or mismatched:
        from streamyolo_torch.utils.logger import get_logger

        get_logger().warning("%d missing and %d mismatched checkpoint entries keep "
                             "their init values", len(missing), len(mismatched))
    out = dict(base)
    out.update({k: loaded[k] for k in base if k in loaded and k not in mismatched})
    return out
