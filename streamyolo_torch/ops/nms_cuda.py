"""Kernel B1: the NMS keep mask on the card, with its plain PyTorch version.

Replaces the TPU kernel ``streamyolo_tpu/ops/nms_pallas.py::_nms_kernel``
(entry ``nms_padded_pallas``). The CUDA source is ``csrc/nms.cu``: one block
per image; all threads build the suppression bitmask (iou > thr for every
pair j > i, packed in 32-bit words in shared memory), then one warp runs the
exact greedy scan over it with no block barrier, 32 rows per shuffle.
Bound on an H100: at the serving K = 200 the kernel moves ~3.6 KB and the
greedy result needs at most K^2/2 IoUs, so it is far from the byte and
operation bounds; what holds it back is the launch, the load, the bitmask's
K^2/2 IoUs on the one SM of the image's block, and the scan's chain of K
dependent bit tests (one shuffle and ~32 shared-memory loads per 32 rows).

``nms_keep`` takes the plain version only for tensors on the CPU; on a CUDA
tensor it launches the kernel or raises. ``nms_keep.launches`` counts the
launches.

The plain versions ``nms_padded`` (the fixed point) and
``nms_padded_sequential`` (the greedy sweep) are the counterparts of
``streamyolo_tpu/ops/nms.py`` and use its IoU operations
(torchvision area convention, union clamped at 1e-12).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

MAX_K = 1024


def _thr32(nms_thre: float) -> float:
    """The threshold as the float32 the JAX package compares against."""
    return float(np.float32(nms_thre))


def _iou_matrix_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """[..., K, 4] xyxy -> [..., K, K] IoU, row = earlier box."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    tlx = torch.maximum(x1[..., :, None], x1[..., None, :])
    tly = torch.maximum(y1[..., :, None], y1[..., None, :])
    brx = torch.minimum(x2[..., :, None], x2[..., None, :])
    bry = torch.minimum(y2[..., :, None], y2[..., None, :])
    inter = (brx - tlx).clamp(min=0.0) * (bry - tly).clamp(min=0.0)
    area = (x2 - x1).clamp(min=0.0) * (y2 - y1).clamp(min=0.0)
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / union.clamp(min=1e-12)


def nms_padded_sequential(boxes: torch.Tensor, valid: torch.Tensor,
                          nms_thre: float) -> torch.Tensor:
    """Greedy NMS as K sequential suppression steps over score-sorted
    [..., K, 4] boxes and a [..., K] bool valid mask -> [..., K] keep."""
    k = boxes.shape[-2]
    over = _iou_matrix_xyxy(boxes) > _thr32(nms_thre)
    idx = torch.arange(k, device=boxes.device)
    keep = valid.clone()
    for i in range(k):
        keep &= ~(keep[..., i:i + 1] & over[..., i, :] & (idx > i))
    return keep


def nms_padded(boxes: torch.Tensor, valid: torch.Tensor, nms_thre: float) -> torch.Tensor:
    """Greedy NMS as the fixed point
    ``keep = valid & ~any(suppress & keep[:, None], 0)`` iterated from
    ``keep = valid`` for at most K steps (the suppression graph is a DAG, so
    the fixed point is the greedy result)."""
    k = boxes.shape[-2]
    idx = torch.arange(k, device=boxes.device)
    suppress = (_iou_matrix_xyxy(boxes) > _thr32(nms_thre)) & (idx[:, None] < idx[None, :])

    def step(keep):
        return valid & ~(suppress & keep[..., :, None]).any(dim=-2)

    prev, keep, it = valid, step(valid), 0
    while it < k and bool((keep != prev).any()):
        prev, keep, it = keep, step(keep), it + 1
    return keep


def _lib() -> ctypes.CDLL:
    from streamyolo_torch.ops import _build

    lib = _build.load("nms")
    if lib.streamyolo_nms.argtypes is None:
        lib.streamyolo_nms.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
        ]
        lib.streamyolo_nms.restype = ctypes.c_int
    return lib


def nms_keep(boxes: torch.Tensor, valid: torch.Tensor, nms_thre: float) -> torch.Tensor:
    """[B, K, 4] float32 score-sorted (class-offset) xyxy boxes + [B, K] bool
    valid -> [B, K] bool keep mask. CPU tensors: the plain fixed point.
    CUDA tensors: kernel B1."""
    if boxes.device.type == "cpu":
        return nms_padded(boxes, valid, nms_thre)
    if boxes.device.type != "cuda":
        raise ValueError(f"nms_keep runs on cpu or cuda tensors, got {boxes.device}")
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(
            f"nms_keep wants float32 boxes and bool valid, got {boxes.dtype}, {valid.dtype}")
    if boxes.ndim != 3 or boxes.shape[-1] != 4 or tuple(valid.shape) != tuple(boxes.shape[:2]):
        raise ValueError(
            f"nms_keep wants boxes [B, K, 4] and valid [B, K], got "
            f"{tuple(boxes.shape)} and {tuple(valid.shape)}")
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("nms_keep wants contiguous tensors")
    if valid.device != boxes.device:
        raise ValueError("boxes and valid lie on different devices")
    b, k = valid.shape
    if k > MAX_K:
        raise ValueError(f"nms_keep handles K <= {MAX_K}, got {k}")
    keep = torch.empty_like(valid)
    if b == 0 or k == 0:
        return keep
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    err = _lib().streamyolo_nms(
        boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), b, k,
        _thr32(nms_thre), stream)
    nms_keep.launches += 1
    if err:
        raise RuntimeError(f"NMS kernel launch failed: cudaError {err}")
    return keep


nms_keep.launches = 0
