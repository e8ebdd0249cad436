"""Data parallelism, the counterpart of ``streamyolo_tpu/parallel``.

The JAX package trains data-parallel with one process per host and a 1-D
``Mesh(('data',))`` over every local chip: the batch is sharded on axis 0
and GSPMD inserts the gradient all-reduce. Here the same step runs with one
process per card and a ``torch.distributed`` process group, and its mesh
helpers (``make_mesh``, ``batch_sharding``, ``replicated``,
``shard_batch``) become **the rank's slice of the global batch**: each rank
loads ``batch // world`` images (the rank-strided sampler of
``exp/stream_exp.py``), holds a full copy of the state, and the step
computes what one process computes on the whole global batch:

  * BatchNorm takes its statistics over the global batch
    (``nn/blocks.py::BatchNorm2d``), with flax's rule for the running
    variance;
  * the loss normalizers are sums over the ranks (``models/losses.py``),
    so each rank's loss is its share of the global-batch loss;
  * the rank gradients are summed (``multihost.all_reduce_grads``), and
    every rank ends the step with the same bits.

With no process group, or a world of 1, nothing of this runs.

The latency axis, one frame's rows sliced over the devices of one process
(``SPATIAL_AXIS``, ``make_spatial_mesh``, ``row_sharding``), is
``parallel/spatial.py``, served by ``CUDAStreamDetector(mesh=...)``. Those
names load on first use: ``spatial.py`` imports the model modules, which
import ``multihost`` from this package.
"""

from __future__ import annotations

from typing import Dict

import torch

from streamyolo_torch.parallel.multihost import (
    all_gather_objects,
    all_reduce_grads,
    all_reduce_sum_,
    check_same_on_ranks,
    destroy,
    free_local_port,
    get_rank,
    get_world_size,
    init_distributed,
    is_main_process,
    local_batch_size,
    psum_stats,
    synchronize,
    tensors_digest,
)


def shard_batch(batch: Dict[str, torch.Tensor], rank: int, world_size: int
                ) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s contiguous slice (axis 0) of a global batch: the rows
    the JAX data mesh places on its ``rank``-th device."""
    out = {}
    for k, v in batch.items():
        n = local_batch_size(v.shape[0], world_size)
        out[k] = v[rank * n:(rank + 1) * n]
    return out


_SPATIAL = ("SPATIAL_AXIS", "make_spatial_mesh", "row_sharding")


def __getattr__(name: str):
    if name in _SPATIAL:
        from streamyolo_torch.parallel import spatial

        return getattr(spatial, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "SPATIAL_AXIS",
    "all_gather_objects",
    "all_reduce_grads",
    "all_reduce_sum_",
    "check_same_on_ranks",
    "destroy",
    "free_local_port",
    "get_rank",
    "get_world_size",
    "init_distributed",
    "is_main_process",
    "local_batch_size",
    "make_spatial_mesh",
    "psum_stats",
    "row_sharding",
    "shard_batch",
    "synchronize",
    "tensors_digest",
]
