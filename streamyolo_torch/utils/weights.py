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

``read_safetensors`` and ``write_safetensors`` read and write the
``.safetensors`` format by hand (an 8-byte little-endian header length, the
JSON header, then the raw little-endian tensors), so the port reads the
JAX package's ``tools/export_safetensors.py`` files where the
``safetensors`` package is not installed. ``torch_key_to_flax`` is the
inverse of ``flax_path_to_torch`` (``tools/export_safetensors.py
--flax-names``).
"""

from __future__ import annotations

import json
import os
import struct
import sys
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

# the .safetensors dtype names of the tensors a checkpoint holds
SAFETENSORS_DTYPES = {
    "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16, "I8": torch.int8,
    "I32": torch.int32, "I64": torch.int64, "BOOL": torch.bool,
}
_SAFETENSORS_NAMES = {v: k for k, v in SAFETENSORS_DTYPES.items()}
_HEADER_MAX = 100 << 20  # a header longer than this is not a checkpoint's


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


def read_safetensors(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, str]]:
    """A ``.safetensors`` file -> (``{name: CPU tensor}`` in file order, the
    header's ``__metadata__``). Raises ``ValueError`` naming the file for a
    malformed header, an unknown dtype, or offsets that do not tile the data
    exactly."""
    if sys.byteorder != "little":
        raise RuntimeError("reading .safetensors needs a little-endian host")
    with open(path, "rb") as f:
        blob = f.read()
    if len(blob) < 8:
        raise ValueError(f"{path}: too short for a .safetensors file")
    (n,) = struct.unpack("<Q", blob[:8])
    if n > min(_HEADER_MAX, len(blob) - 8):
        raise ValueError(f"{path}: header length {n} exceeds the file")
    try:
        header = json.loads(blob[8:8 + n])
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"{path}: header is not JSON ({e})") from e
    if not isinstance(header, dict):
        raise ValueError(f"{path}: header is not a JSON object")
    metadata = header.pop("__metadata__", None) or {}
    entries = []
    for name, info in header.items():
        try:
            shape = [int(d) for d in info["shape"]]
            begin, stop = (int(o) for o in info["data_offsets"])
            dtype_name = info["dtype"]
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"{path}: malformed header entry {name!r} ({e!r})") from e
        if dtype_name not in SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: {name} has dtype {dtype_name!r}; the port reads "
                             f"{', '.join(SAFETENSORS_DTYPES)}")
        entries.append((begin, stop, name, SAFETENSORS_DTYPES[dtype_name], shape))
    data = memoryview(blob)[8 + n:]
    out: Dict[str, torch.Tensor] = {}
    end = 0
    for begin, stop, name, dtype, shape in sorted(entries, key=lambda e: e[:2]):
        size = int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=dtype).element_size()
        if begin != end or stop - begin != size or stop > len(data):
            raise ValueError(f"{path}: {name} has offsets [{begin}, {stop}) for {size} bytes "
                             f"after byte {end} of {len(data)}")
        end = stop
        raw = bytearray(data[begin:stop])  # writable: torch.frombuffer shares it
        flat = torch.frombuffer(raw, dtype=dtype) if size else torch.empty(0, dtype=dtype)
        out[name] = flat.reshape(shape)
    if end != len(data):
        raise ValueError(f"{path}: {len(data) - end} bytes after the last tensor")
    return dict(sorted(out.items())), metadata


def write_safetensors(path: str, tensors: Mapping[str, torch.Tensor],
                      metadata: Optional[Mapping[str, str]] = None) -> int:
    """Write ``tensors`` (any device, a dtype of ``SAFETENSORS_DTYPES``) as
    ``.safetensors``: the header padded with spaces to 8 bytes, the tensors
    in name order. Atomic (a temporary file and ``os.replace``). Returns the
    number of tensors written."""
    if sys.byteorder != "little":
        raise RuntimeError("writing .safetensors needs a little-endian host")
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    chunks, offset = [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().cpu().contiguous()
        if t.dtype not in _SAFETENSORS_NAMES:
            raise TypeError(f"{name}: {t.dtype} has no .safetensors dtype here")
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": _SAFETENSORS_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        chunks.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in chunks:
            f.write(raw)
    os.replace(tmp, path)
    return len(chunks)


def torch_key_to_flax(key: str, ndim: int,
                      state_keys) -> Tuple[Optional[str], Optional[Tuple[int, ...]]]:
    """One port state-dict entry -> ('/'-joined flax variables path, transpose
    to apply), the inverse of ``flax_path_to_torch``; ``(None, None)`` for a
    ``num_batches_tracked`` (JAX keeps none). ``state_keys`` are all the
    state dict's keys: a 1-D ``weight`` beside a ``running_mean`` is a
    BatchNorm ``scale``, any other ``weight`` a ``kernel``."""
    prefix, _, leaf = key.rpartition(".")
    segments = []
    for seg in prefix.split(".") if prefix else []:
        if seg.isdigit() and segments:
            segments[-1] = f"{segments[-1]}_{seg}"
        else:
            segments.append(seg)
    module = "/".join(segments)
    pre = f"{prefix}." if prefix else ""

    def path(collection, name):
        return "/".join(p for p in (collection, module, name) if p)

    if leaf == "num_batches_tracked":
        return None, None
    if leaf in ("kernel_q", "w_scale", "act_scale"):
        return path("quant", leaf), ((2, 3, 1, 0) if leaf == "kernel_q" and ndim == 4 else None)
    if leaf in ("running_mean", "running_var"):
        return path("batch_stats", leaf[len("running_"):]), None
    if leaf == "bias":
        return path("params", "bias"), None
    if leaf == "weight":
        if ndim == 1 and f"{pre}running_mean" in state_keys:
            return path("params", "scale"), None
        if ndim == 4:  # OIHW -> HWIO
            return path("params", "kernel"), (2, 3, 1, 0)
        if ndim == 2:  # torch Linear [out, in] -> flax Dense [in, out]
            return path("params", "kernel"), (1, 0)
        return path("params", "kernel"), None
    raise KeyError(f"Unrecognized port state-dict entry: {key}")


def save_safetensors(state_dict: Mapping[str, torch.Tensor], path: str,
                     torch_layout: bool = True) -> int:
    """A port state dict as a ``.safetensors`` file, the counterpart of
    ``streamyolo_tpu/utils/checkpoint.py::save_safetensors``, tensor for
    tensor: ``torch_layout=True`` writes the yolox names with OIHW convs,
    ``False`` the flax tree ('/'-joined names, HWIO; ``torch_key_to_flax``).
    Neither writes ``num_batches_tracked``. Returns the number of tensors
    written."""
    keys = set(state_dict)
    out: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        value = torch.as_tensor(value)
        if torch_layout:
            if not key.endswith("num_batches_tracked"):
                out[key] = value
            continue
        name, transpose = torch_key_to_flax(key, value.ndim, keys)
        if name is not None:
            out[name] = value.permute(transpose) if transpose is not None else value
    return write_safetensors(path, out, {"format": "pt" if torch_layout else "flax",
                                         "producer": "streamyolo_torch"})


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """Read a released-format ``.pth`` (a raw state dict, or a trainer
    checkpoint holding it under ``model``) or a ``.safetensors`` file with
    torch names (``read_safetensors``: no package needed)."""
    if str(path).endswith(".safetensors"):
        state_dict = read_safetensors(path)[0]
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
