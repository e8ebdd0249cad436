"""The int8 convolution of a quantized ``BaseConv`` on the card, with its
plain PyTorch version.

Computes ``streamyolo_tpu/nn/blocks.py::BaseConv._int8_conv``, which the JAX
package leaves to XLA (a ``conv_general_dilated`` with int8 operands and an
int32 result; no Pallas kernel). PyTorch has no int8 convolution on CUDA,
so the port writes one: ``csrc/int8_conv.cu`` (an implicit GEMM on
``mma.sync`` int8 tensor-core tiles that quantizes the float activation as
it loads it, and dequantizes in the epilogue). At StreamYOLO-l's serving
shapes an H100 bounds the 1x1 layers by bytes (float activation in, int8
weights, output out) and the wide 3x3 layers by int8 operations.

``int8_conv`` takes the plain version only for tensors on the CPU; on a
CUDA tensor it launches the kernel or raises. ``int8_conv.launches``
counts the launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

_DTYPE_KINDS = {torch.float32: 0, torch.bfloat16: 1}


def int8_conv_plain(x: torch.Tensor, kernel_q: torch.Tensor, w_scale: torch.Tensor,
                    act_scale: torch.Tensor, stride: int = 1, groups: int = 1) -> torch.Tensor:
    """The plain version on any device: ``xq = clip(round(float(x) /
    act_scale), -127, 127)`` (round half to even), ``acc = conv(xq,
    kernel_q)`` with ``(k - 1) // 2`` padding, exact through float64 (every
    partial sum is an integer below 2**53), then ``float32(acc) * mult``
    rounded once to ``x``'s dtype; ``mult = act_scale * w_scale`` in float32,
    or ``w_scale`` alone for a per-input-channel ``act_scale``."""
    pad = (kernel_q.shape[-1] - 1) // 2
    per_channel = act_scale.ndim > 0
    scale = act_scale.reshape(1, -1, 1, 1) if per_channel else act_scale
    xq = torch.clamp(torch.round(x.float() / scale), -127, 127)
    acc = F.conv2d(xq.double(), kernel_q.double(), stride=stride, padding=pad, groups=groups)
    mult = w_scale if per_channel else act_scale * w_scale
    return (acc.float() * mult.reshape(1, -1, 1, 1)).to(x.dtype)


def _lib() -> ctypes.CDLL:
    from streamyolo_torch.ops import _build

    lib = _build.load("int8_conv")
    if lib.streamyolo_int8_conv.argtypes is None:
        lib.streamyolo_int8_conv.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [
            ctypes.c_void_p]
        lib.streamyolo_int8_conv.restype = ctypes.c_int
    return lib


def _check(x, kernel_q, w_scale, act_scale, stride, groups):
    if x.dtype not in _DTYPE_KINDS or x.ndim != 4:
        raise TypeError(f"int8_conv wants a [N, C, H, W] float32 or bfloat16 input, got "
                        f"{tuple(x.shape)} {x.dtype}")
    if kernel_q.dtype != torch.int8 or kernel_q.ndim != 4 \
            or kernel_q.shape[2] != kernel_q.shape[3]:
        raise TypeError(f"int8_conv wants a square [C_out, C_in / groups, k, k] int8 kernel, "
                        f"got {tuple(kernel_q.shape)} {kernel_q.dtype}")
    c, co = x.shape[1], kernel_q.shape[0]
    if groups < 1 or c % groups or co % groups or kernel_q.shape[1] * groups != c:
        raise ValueError(f"int8_conv: kernel {tuple(kernel_q.shape)} with groups={groups} "
                         f"does not fit {c} input channels")
    if stride < 1:
        raise ValueError(f"int8_conv: stride {stride}")
    if w_scale.dtype != torch.float32 or tuple(w_scale.shape) != (co,):
        raise TypeError(f"int8_conv wants a float32 [{co}] w_scale, got "
                        f"{tuple(w_scale.shape)} {w_scale.dtype}")
    if act_scale.dtype != torch.float32 or tuple(act_scale.shape) not in ((), (c,)):
        raise TypeError(f"int8_conv wants a float32 act_scale of shape () or ({c},), got "
                        f"{tuple(act_scale.shape)} {act_scale.dtype}")


def int8_conv(x: torch.Tensor, kernel_q: torch.Tensor, w_scale: torch.Tensor,
              act_scale: torch.Tensor, *, stride: int = 1, groups: int = 1) -> torch.Tensor:
    """[N, C, H, W] float32 / bfloat16 -> [N, C_out, Ho, Wo] of the same
    dtype, ``channels_last`` on the card. ``kernel_q`` is OIHW int8,
    ``w_scale`` float32 [C_out], ``act_scale`` a float32 scalar (per
    tensor) or [C] (per input channel).

    On the card ``x`` must be ``channels_last``; an NCHW-contiguous input is
    copied to ``channels_last`` first (an explicit copy: the port's
    activations on the card are ``channels_last`` already), any other layout
    raises. ``kernel_q`` is read OHWI: a ``channels_last`` kernel (a model
    placed on the card) is read in place, another one is copied."""
    _check(x, kernel_q, w_scale, act_scale, stride, groups)
    if x.device.type == "cpu":
        return int8_conv_plain(x, kernel_q, w_scale, act_scale, stride, groups)
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv runs on cpu or cuda tensors, got {x.device}")
    for name, t in (("kernel_q", kernel_q), ("w_scale", w_scale), ("act_scale", act_scale)):
        if t.device != x.device:
            raise ValueError(f"int8_conv: {name} on {t.device}, input on {x.device}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        if not x.is_contiguous():
            raise ValueError("int8_conv wants a channels_last or contiguous NCHW input, got "
                             f"strides {x.stride()}")
        x = x.contiguous(memory_format=torch.channels_last)
    w_ohwi = kernel_q.permute(0, 2, 3, 1)
    if not w_ohwi.is_contiguous():
        w_ohwi = w_ohwi.contiguous()
    n, c, h, w = x.shape
    co, k = kernel_q.shape[0], kernel_q.shape[-1]
    pad = (k - 1) // 2
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    out = torch.empty((n, co, ho, wo), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().streamyolo_int8_conv(
        x.data_ptr(), w_ohwi.data_ptr(), act_scale.contiguous().data_ptr(),
        w_scale.contiguous().data_ptr(), out.data_ptr(), n, h, w, c, co, k, stride, groups,
        int(act_scale.ndim > 0), _DTYPE_KINDS[x.dtype], stream)
    int8_conv.launches += 1
    if err:
        raise RuntimeError(f"int8 conv kernel launch failed: cudaError {err}")
    return out


int8_conv.launches = 0
