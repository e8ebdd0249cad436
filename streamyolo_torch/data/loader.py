"""Host-side data loading, the counterpart of
``streamyolo_tpu/data/loader.py``: ``torch.utils.data.DataLoader`` with the
NumPy collate, the seeded infinite sampler and the mosaic-flag batch
sampler of yolox, the strided eval shard of a rank, and the CUDA
prefetcher.

Batches stay uint8 (images) and float32 (labels) NumPy arrays on the host;
``DevicePrefetcher`` pins them and copies them to the card on a side
stream while the previous step runs.
"""

from __future__ import annotations

import itertools
import random
import threading
import uuid
from typing import Dict, Iterator, Optional

import numpy as np
import torch
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


class InfiniteSampler(torch.utils.data.Sampler):
    """An endless stream of indices: a fresh permutation of ``size`` per
    pass from a seeded ``torch.Generator``, strided by rank (yolox
    ``InfiniteSampler``). Each new iterator restarts from the seed."""

    def __init__(self, size: int, shuffle: bool = True, seed: int = 0, rank: int = 0,
                 world_size: int = 1):
        self._size = size
        self._shuffle = shuffle
        self._seed = int(seed)
        self._rank = rank
        self._world_size = world_size

    def __iter__(self) -> Iterator[int]:
        yield from itertools.islice(self._infinite_indices(), self._rank, None,
                                    self._world_size)

    def _infinite_indices(self):
        g = torch.Generator()
        g.manual_seed(self._seed)
        while True:
            if self._shuffle:
                yield from torch.randperm(self._size, generator=g).tolist()
            else:
                yield from range(self._size)

    def __len__(self):
        return self._size // self._world_size


class YoloBatchSampler(torch.utils.data.BatchSampler):
    """A batch sampler that tags every index with the mosaic flag,
    ``(mosaic, idx)`` (yolox ``YoloBatchSampler``)."""

    def __init__(self, *args, mosaic: bool = True, **kwargs):
        super().__init__(*args, **kwargs)
        self.mosaic = mosaic

    def __iter__(self):
        for batch in super().__iter__():
            yield [(self.mosaic, idx) for idx in batch]


def worker_init_reset_seed(worker_id: int):
    """Re-seed ``random``, torch and NumPy in a worker from fresh entropy
    (yolox ``worker_init_reset_seed``)."""
    seed = uuid.uuid4().int % 2 ** 32
    random.seed(seed)
    torch.manual_seed(seed)
    np.random.seed(seed)


def _mosaic_flag_getitem(dataset, item):
    """Unpack a ``(mosaic_flag, index)`` item of ``YoloBatchSampler`` onto
    the dataset (yolox's ``Dataset.mosaic_getitem``)."""
    if isinstance(item, tuple):
        dataset.enable_mosaic = item[0]
        item = item[1]
    return dataset[item]


class _IndexUnpackDataset(torch.utils.data.Dataset):
    """The train dataset seen through ``_mosaic_flag_getitem``."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, item):
        return _mosaic_flag_getitem(self.dataset, item)

    def __getattr__(self, name):
        # unpickling in a worker looks attributes up before __init__ ran
        if name == "dataset":
            raise AttributeError(name)
        return getattr(self.dataset, name)


class ShardDataset(torch.utils.data.Dataset):
    """Rank ``rank``'s strided shard of a dataset for the sharded eval (the
    role of ``DistributedSampler(shuffle=False)``): indices ``rank,
    rank + world, rank + 2 * world, ...``. Attribute access forwards to the
    dataset (the evaluators read ``coco`` / ``class_ids`` through it)."""

    def __init__(self, dataset, rank: int, world_size: int):
        self.dataset = dataset
        self._rank = rank
        self._world = world_size

    def __len__(self):
        return (len(self.dataset) - self._rank + self._world - 1) // self._world

    def __getitem__(self, idx):
        return self.dataset[self._rank + idx * self._world]

    def __getattr__(self, name):
        if name == "dataset":  # see _IndexUnpackDataset.__getattr__
            raise AttributeError(name)
        return getattr(self.dataset, name)


class DevicePrefetcher:
    """Keeps one batch in flight: a background thread pulls the next
    collated batch from the loader, pins it, and copies it to the card with
    ``non_blocking`` copies on a side stream, while the caller's step runs
    (yolox's CUDA ``DataPrefetcher``). ``next()`` makes the caller's stream
    wait for the copies, marks the tensors as used on it (so the caching
    allocator does not hand their memory to the next copy too early) and
    starts the next preload.

    ``next()`` returns ``{"images", "labels"[, "support_labels"]}`` tensors,
    or ``None`` once the loader is exhausted; an error of the loader is
    raised on the caller's thread. ``__init__`` is re-entrant: calling it
    again (the trainer's restart) first joins the preload in flight.
    ``close()`` joins it too and drops its result, after which ``next()``
    returns ``None``. On a CPU device the batches are plain CPU tensors.
    A bare ``"cuda"`` means the caller's current card, resolved here (the
    preload thread's own current card is card 0), so a rank that set its
    card copies to it."""

    def __init__(self, loader, device="cuda"):
        prior = getattr(self, "_thread", None)
        if prior is not None:
            prior.join()
        from streamyolo_torch.utils.device import resolve_device

        self._device = resolve_device(device)
        self._cuda = self._device.type == "cuda"
        if self._cuda and self._device.index is None:
            self._device = torch.device("cuda", torch.cuda.current_device())
        self._stream = torch.cuda.Stream(self._device) if self._cuda else None
        self._it = iter(loader)
        self._thread: Optional[threading.Thread] = None
        self._result = None
        self._error: Optional[BaseException] = None
        self._kick()

    def _to_batch(self, raw) -> Dict[str, torch.Tensor]:
        images, targets = raw[0], raw[1]
        arrays = {"images": images}
        if isinstance(targets, tuple):
            arrays["labels"], arrays["support_labels"] = targets[0], targets[1]
        else:
            arrays["labels"] = targets
        host = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()}
        if not self._cuda:
            return host, None
        with torch.cuda.stream(self._stream):
            batch = {k: v.pin_memory().to(self._device, non_blocking=True)
                     for k, v in host.items()}
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return batch, ready

    def _preload(self):
        try:
            self._result = self._to_batch(next(self._it))
        except StopIteration:
            self._result = None
        except BaseException as e:  # re-raised on the caller's thread
            self._error = e
            self._result = None

    def _kick(self):
        self._thread = threading.Thread(target=self._preload, daemon=True)
        self._thread.start()

    def next(self) -> Optional[Dict[str, torch.Tensor]]:
        if self._thread is None:  # exhausted, errored or closed, and not restarted
            return None
        self._thread.join()
        self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        result, self._result = self._result, None
        if result is None:  # exhausted: never kick a dead iterator
            return None
        batch, ready = result
        if ready is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(ready)
            for t in batch.values():
                t.record_stream(stream)
        self._kick()
        return batch

    def close(self):
        """Join the preload in flight and drop what it loaded."""
        if self._thread is not None:
            self._thread.join()
        self._thread = None
        self._result = None
        self._error = None
