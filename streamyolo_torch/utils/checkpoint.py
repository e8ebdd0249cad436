"""Training checkpoints, the counterpart of
``streamyolo_tpu/utils/checkpoint.py``, in the reference's torch layout.

``save_checkpoint`` writes ``<save_dir>/<name>_ckpt.pth`` (``latest``,
``last_epoch``, ``last_mosaic_epoch``, ``epoch_N``) and, on a new best AP,
copies it to ``best_ckpt.pth``; each file goes through a temporary file in
the same directory and ``os.replace``, so a crash never leaves a truncated
file under the real name. The trainer stores ``start_epoch``, ``model``
(the weights an eval reads: the EMA state dict when the config keeps an
EMA), ``best_ap``, and what ``--resume`` needs: ``train_model`` (the
training weights and BatchNorm statistics), ``optimizer`` (the SGD state:
momentum buffers), ``ema`` and ``step``. The port's ``tools/eval.py -c``
reads such a file as it is (the state dict under ``model``).
"""

from __future__ import annotations

import os
import pickle
import shutil
import zipfile
from typing import Any, Dict

import torch

JAX_PICKLE_MESSAGE = (
    "{path} is a JAX checkpoint (a pickle of flax and optax train state) that cannot "
    "be read without jax; convert its weights with tools/export_safetensors.py and "
    "fine-tune from the .safetensors file")


def save_checkpoint(state: Dict[str, Any], is_best: bool, save_dir: str, model_name: str) -> str:
    """Atomic write of ``<model_name>_ckpt.pth`` (and the ``best_ckpt.pth``
    copy when ``is_best``); returns the path."""
    os.makedirs(save_dir, exist_ok=True)
    filename = os.path.join(save_dir, model_name + "_ckpt.pth")
    tmp = filename + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, filename)
    if is_best:
        best = os.path.join(save_dir, "best_ckpt.pth")
        shutil.copyfile(filename, best + ".tmp")
        os.replace(best + ".tmp", best)
    return filename


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A trainer checkpoint (or a released ``.pth`` / ``.safetensors`` state
    dict, returned as ``{"model": state_dict, "start_epoch": 0}``) on the
    CPU. A JAX ``.pkl`` is refused before it is read; a truncated or
    corrupted file raises with its path."""
    if path.endswith(".pkl"):
        raise ValueError(JAX_PICKLE_MESSAGE.format(path=path))
    if not os.path.isfile(path):
        raise FileNotFoundError(f"checkpoint not found: {path}")
    from streamyolo_torch.utils.weights import load_state_dict_file, with_num_batches_tracked

    try:
        if path.endswith(".safetensors"):
            return {"model": load_state_dict_file(path), "start_epoch": 0}
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    except (RuntimeError, EOFError, pickle.UnpicklingError, zipfile.BadZipFile,
            ValueError) as e:
        raise RuntimeError(
            f"corrupted or truncated checkpoint: {path} ({type(e).__name__}: {e}); "
            "checkpoints are written atomically, so fall back to the sibling "
            "latest / last_epoch / best_ckpt file") from e
    if isinstance(ckpt, dict) and "model" in ckpt:
        return ckpt
    return {"model": with_num_batches_tracked({k: torch.as_tensor(v) for k, v in ckpt.items()}),
            "start_epoch": 0}


def load_ckpt_tolerant(base: Dict[str, torch.Tensor],
                       loaded: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Shape-tolerant merge for fine-tuning (yolox ``load_ckpt``): missing or
    mismatched entries keep ``base``'s values, with a warning."""
    from streamyolo_torch.utils.weights import merge_state_dict, with_num_batches_tracked

    return merge_state_dict(base, with_num_batches_tracked(dict(loaded)), strict=False)
