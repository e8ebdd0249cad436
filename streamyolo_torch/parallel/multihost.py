"""Process-group helpers: rank topology, barrier, cross-process gathers and
sums, the counterpart of ``streamyolo_tpu/parallel/multihost.py``.

One process per card (per worker on the CPU), joined by a
``torch.distributed`` process group. Everything degrades to the trivial
single-process behaviour when no group is initialised or its world size is
1, as the JAX helpers do with ``process_count() == 1``: no collective runs.

``init_distributed`` brings a group up from (backend, url, world size,
rank) with a timeout: a group that cannot form raises, a collective whose
peer died raises (gloo) or aborts (NCCL's watchdog) after the timeout;
nothing carries on alone or on the CPU. A NCCL group's collectives run on
the rank's current card; a gloo group's take tensors on the CPU or, for the
all-reduces of the train step, on a card (gloo stages them through the
host).
"""

from __future__ import annotations

import datetime
import hashlib
import socket
from typing import Any, Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 1800.0  # torch's own default for a gloo group
GRAD_BUCKET_BYTES = 25 * 2 ** 20  # DDP's default bucket


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    return dist.get_rank() if _initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if _initialized() else 1


def is_main_process() -> bool:
    return get_rank() == 0


def init_distributed(backend: str, url: str, world_size: int, rank: int,
                     device: str = "cuda", local_rank: int = 0,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group at ``url`` (``tcp://host:port``) as ``rank``
    of ``world_size`` and return the rank's device: ``cuda:{local_rank}``
    (made the current card before any stream or collective exists) or the
    CPU for ``device='cpu'``. NCCL needs the card; a group that does not
    form within ``timeout_s`` raises."""
    if _initialized():
        raise RuntimeError("a process group is already initialised in this process")
    if not url:
        raise ValueError("a process group needs --dist-url (tcp://host:port)")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU")
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(
                f"local rank {local_rank} has no card: {torch.cuda.device_count()} visible")
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    elif backend == "nccl":
        raise ValueError("the nccl backend needs a CUDA device; use gloo on the CPU")
    dist.init_process_group(backend, init_method=url, world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def free_local_port() -> int:
    """A TCP port free on 127.0.0.1 now, for a group on one host."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def destroy() -> None:
    """Leave the process group, if one is initialised."""
    if _initialized():
        dist.destroy_process_group()


def _collective_device() -> torch.device:
    """Where a small host-side payload goes for a collective: the current
    card under NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def synchronize() -> None:
    """Barrier across the group (no-op single-process)."""
    if get_world_size() == 1:
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def all_gather_objects(obj: Any) -> List[Any]:
    """Gather a picklable object from every rank, in rank order, on every
    rank (the evaluators' detection gather)."""
    if get_world_size() == 1:
        return [obj]
    out: List[Any] = [None] * get_world_size()
    dist.all_gather_object(out, obj)
    return out


def psum_stats(values) -> np.ndarray:
    """Sum a small stat vector (timing meters etc.) across ranks, in float64."""
    values = np.asarray(values, np.float64)
    if get_world_size() == 1:
        return values
    t = torch.from_numpy(values.copy()).to(_collective_device())
    dist.all_reduce(t)
    return t.cpu().numpy()


def all_reduce_sum_(tensor: torch.Tensor) -> torch.Tensor:
    """In-place sum of ``tensor`` over the ranks (the caller checks the
    world size); returns it."""
    dist.all_reduce(tensor)
    return tensor


def all_reduce_grads(params: Iterable[torch.nn.Parameter]) -> None:
    """Sum every parameter's gradient over the ranks, in flat buckets of at
    most ``GRAD_BUCKET_BYTES`` (one all-reduce each; a larger tensor is a bucket
    of its own). Every rank ends with the same bits. Parameters without a
    gradient are skipped, which must then hold on every rank."""
    buckets: List[List[torch.Tensor]] = []
    bucket: List[torch.Tensor] = []
    size = 0
    for g in (p.grad for p in params if p.grad is not None):
        n = g.numel() * g.element_size()
        if bucket and (size + n > GRAD_BUCKET_BYTES or g.dtype != bucket[0].dtype):
            buckets.append(bucket)
            bucket, size = [], 0
        bucket.append(g)
        size += n
    if bucket:
        buckets.append(bucket)
    for bucket in buckets:
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat)
        for g, part in zip(bucket, flat.split([g.numel() for g in bucket])):
            g.copy_(part.view(g.shape))


def tensors_digest(tensors: Sequence[torch.Tensor]) -> str:
    """A hash of the tensors' bytes (on the host), in order."""
    h = hashlib.blake2b(digest_size=16)
    for t in tensors:
        h.update(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def check_same_on_ranks(value: Any, what: str) -> None:
    """Raise on every rank unless ``value`` (picklable, compared with ``==``)
    is the same on every rank."""
    if get_world_size() == 1:
        return
    values = all_gather_objects(value)
    if any(v != values[0] for v in values[1:]):
        raise RuntimeError(f"{what} differs between ranks: {values}")


def local_batch_size(global_batch: int, world_size: Optional[int] = None) -> int:
    """The rank's share of a global batch; the division must be exact."""
    world = get_world_size() if world_size is None else world_size
    if global_batch % world:
        raise ValueError(f"the batch {global_batch} does not split over {world} ranks")
    return global_batch // world
