"""Eval-side data loading, the counterpart of
``streamyolo_tpu/data/loader.py``: ``torch.utils.data.DataLoader`` with the
NumPy collate. The samplers, the mosaic adapter and the device prefetcher
come with the training slice.
"""

from __future__ import annotations

import numpy as np
import torch.utils.data


def _numpy_collate(batch):
    """Stack samples to NumPy arrays; tuples (the target pair, ``img_info``)
    stay tuples of stacked arrays, so ids ``[1]`` arrays become ``[B, 1]``."""
    elem = batch[0]
    if isinstance(elem, np.ndarray):
        return np.stack(batch, 0)
    if isinstance(elem, tuple):
        return tuple(_numpy_collate([b[i] for b in batch]) for i in range(len(elem)))
    if isinstance(elem, (int, float)):
        return np.asarray(batch)
    return batch


class DataLoader(torch.utils.data.DataLoader):
    """The NumPy collate by default; worker processes are spawned (not
    forked from a process that may hold a CUDA context and threads)."""

    def __init__(self, dataset, **kwargs):
        kwargs.setdefault("collate_fn", _numpy_collate)
        if kwargs.get("num_workers", 0) > 0:
            kwargs.setdefault("multiprocessing_context", "spawn")
        super().__init__(dataset, **kwargs)
