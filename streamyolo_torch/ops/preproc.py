"""Kernel B2: the 0.5x streaming preprocess on the card, with its plain
PyTorch version.

Replaces the TPU kernel ``streamyolo_tpu/ops/preproc_pallas.py::_kernel``
(entry ``downsample2x_bilinear``): a [H, W, 3] uint8 frame -> the
[H/2, W/2, 3] 2x2 box average, which is cv2 ``INTER_LINEAR`` at exactly
0.5. The CUDA source is ``csrc/preproc.cu``: a 2-D grid (output row from
``blockIdx.y``), each thread a run of 8 output pixels read with 16-byte
loads and written with 16-byte stores; a frame whose rows are not on the
16-byte grid (misaligned ``data_ptr``, W not a multiple of 16) takes the
kernel's per-pixel path. Bound on an H100: bytes (1200x1920 -> 600x960 bf16
reads 6.91 MB and writes 3.46 MB, ~3.1 us at 3.35 TB/s); the fused mode
folds the detector's rounding, cast and layout into the same single pass.

``downsample2x`` takes the plain version only for tensors on the CPU; on a
CUDA tensor it launches the kernel or raises. ``downsample2x.launches``
counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

_OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1}


def downsample2x_reference(frame_u8: torch.Tensor) -> torch.Tensor:
    """Plain version, raw mode: [H, W, 3] uint8 -> [H/2, W/2, 3] float32
    box average (a sum of four bytes is exact, so this is bit-exact)."""
    h, w, c = frame_u8.shape
    x = frame_u8.float().reshape(h // 2, 2, w // 2, 2, c)
    return x.sum(dim=(1, 3)) * 0.25


def round_like_cv2(x: torch.Tensor) -> torch.Tensor:
    """clip(floor(x + 0.5), 0, 255): the rounding cv2 applies when it writes
    the resized uint8 frame."""
    return torch.clamp(torch.floor(x + 0.5), 0, 255)


def downsample2x_plain(frame_u8: torch.Tensor, out_dtype: torch.dtype = torch.float32,
                       fused: bool = False) -> torch.Tensor:
    """The plain version of ``downsample2x`` in both modes, on any device."""
    out = downsample2x_reference(frame_u8)
    return (round_like_cv2(out) if fused else out).to(out_dtype)


def _lib() -> ctypes.CDLL:
    from streamyolo_torch.ops import _build

    lib = _build.load("preproc")
    if lib.streamyolo_downsample2x.argtypes is None:
        lib.streamyolo_downsample2x.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.streamyolo_downsample2x.restype = ctypes.c_int
    return lib


def downsample2x(frame_u8: torch.Tensor, *, out_dtype: torch.dtype = torch.float32,
                 fused: bool = False) -> torch.Tensor:
    """[H, W, 3] uint8 -> [H/2, W/2, 3] ``out_dtype`` (float32 or bfloat16).

    ``fused=False``: the raw box average (``downsample2x_reference``).
    ``fused=True``: the detector's input, ``round_like_cv2`` of it, in the
    model's NHWC input layout."""
    if frame_u8.dtype != torch.uint8 or frame_u8.ndim != 3 or frame_u8.shape[-1] != 3:
        raise ValueError(
            f"downsample2x wants a [H, W, 3] uint8 frame, got "
            f"{tuple(frame_u8.shape)} {frame_u8.dtype}")
    h, w, _ = frame_u8.shape
    if h % 2 or w % 2:
        raise ValueError(f"downsample2x wants even H and W, got {h}x{w}")
    if out_dtype not in _OUT_KINDS:
        raise TypeError(f"downsample2x writes float32 or bfloat16, not {out_dtype}")
    if frame_u8.device.type == "cpu":
        return downsample2x_plain(frame_u8, out_dtype, fused)
    if frame_u8.device.type != "cuda":
        raise ValueError(f"downsample2x runs on cpu or cuda tensors, got {frame_u8.device}")
    if not frame_u8.is_contiguous():
        raise ValueError("downsample2x wants a contiguous frame")
    out = torch.empty((h // 2, w // 2, 3), dtype=out_dtype, device=frame_u8.device)
    stream = torch.cuda.current_stream(frame_u8.device).cuda_stream
    err = _lib().streamyolo_downsample2x(
        frame_u8.data_ptr(), out.data_ptr(), h, w, _OUT_KINDS[out_dtype],
        int(fused), stream)
    downsample2x.launches += 1
    if err:
        raise RuntimeError(f"downsample kernel launch failed: cudaError {err}")
    return out


downsample2x.launches = 0
