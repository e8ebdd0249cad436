"""The int8 convolution of a quantized ``BaseConv`` on the card, with its
plain PyTorch version.

Computes ``streamyolo_tpu/nn/blocks.py::BaseConv._int8_conv``, which the JAX
package leaves to XLA (a ``conv_general_dilated`` with int8 operands and an
int32 result; no Pallas kernel). PyTorch has no int8 convolution on CUDA,
so the port writes one: ``csrc/int8_conv.cu`` (an implicit GEMM on
Hopper's ``wgmma`` int8 tensor cores; each block quantizes its tile's
float input once into a swizzled int8 patch in shared memory, copies its
weights in by ``cp.async`` meanwhile, and dequantizes in the epilogue;
split-K runs in a thread-block cluster). At StreamYOLO-l's serving shapes
an H100 bounds the 1x1 layers by bytes (float activation in, int8
weights, output out) and the wide 3x3 layers by int8 operations.

``plan_int8_conv`` chooses, from the shape alone, the kernel's tile (64
or 128 consecutive pixels for a 1x1 stride-1 conv, an 8 x 8 or 16 x 8 block
of output pixels otherwise), its output-channel width ``bn``, its split-K
factor and its shared memory; the kernel refuses a plan that does not fit
the shape.

``int8_conv`` takes the plain version only for tensors on the CPU; on a
CUDA tensor it launches the kernel or raises. ``int8_conv.launches``
counts the launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

_DTYPE_KINDS = {torch.float32: 0, torch.bfloat16: 1}

SMS = 132  # streaming multiprocessors of an H100 SXM: the planner fills them
TILE_M = 64  # output pixels of one warpgroup's wgmma m64
MAX_SMEM = 232448  # dynamic shared memory a block may use
SMEM_BUDGET = 200 * 1024  # what the planner gives the A patch and the weights together
MAX_SPLITS = 8  # portable thread-block cluster size
PLAN_FIELDS = ("flat", "mw", "bn", "splits", "c_split", "tiles_y", "tiles_x", "rp", "qw",
               "n_slots", "a_plane", "a_bytes", "smem", "vec")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def row_bytes(c_split: int) -> int:
    """R: the bytes of K in a shared-memory row of both operands, the widest
    of wgmma's 128 / 64 / 32-byte swizzles that divides ``c_split``."""
    return 128 if c_split % 128 == 0 else 64 if c_split % 64 == 0 else 32


@dataclasses.dataclass(frozen=True)
class Int8ConvPlan:
    """How ``csrc/int8_conv.cu`` cuts one conv (groups 1). A block's two
    warpgroups each run an m64 wgmma: stacked (``mw`` 2, a 128-pixel x
    ``bn`` tile) or side by side (``mw`` 1, 64 pixels x ``bn``, each
    warpgroup ``bn`` / 2 channels). ``flat``: consecutive output pixels
    (1x1 stride 1); otherwise an 8 ``mw`` x 8 block of output pixels of one
    image, ``tiles_y`` x ``tiles_x`` per image, whose haloed input patch
    ((8 mw - 1) stride + k rows, 7 stride + k columns) is stored ``rp``
    slots a row, each row ``stride`` phases of ``qw`` slots (x = slot *
    stride + phase). A slot holds R channels (``row_bytes``) per plane,
    planes ``a_plane`` bytes apart, ``a_bytes`` in all. ``bn`` output
    channels per block; ``splits`` blocks (one cluster) share a tile, split
    by input channels, ``c_split`` each; a block holds its weights whole
    (``bn`` channels, every tap, ``c_split`` input channels) after the A
    patch. ``smem``: the block's dynamic shared memory. ``vec``: C_in is a
    multiple of 16, so a thread loads 16 channels of a pixel as 16-byte
    vectors (where the pointers are aligned too); otherwise (the
    12-channel Focus stem, a 24-byte pixel) element by element. ``grid``:
    the launch grid (tiles, output-channel blocks, splits)."""

    flat: int
    mw: int
    bn: int
    splits: int
    c_split: int
    tiles_y: int
    tiles_x: int
    rp: int
    qw: int
    n_slots: int
    a_plane: int
    a_bytes: int
    smem: int
    vec: int
    grid: tuple

    def record(self) -> list:
        """The ints the C entry point reads, in ``PLAN_FIELDS`` order."""
        return [getattr(self, f) for f in PLAN_FIELDS]


def _block_us(mw: int, bn: int, k: int, c_split: int, n_slots: int, splits: int) -> float:
    """A rough model of one block's time on an H100 (us): fixed launch and
    barrier costs, a round of loads and quantizes per 1,024 A items (16
    channels of a slot), its weights from L2, its wgmmas, and the epilogue
    (its reduction over the cluster). Its choice over StreamYOLO-l's 29
    step shapes sums to within 4 % of the fastest candidate of each shape
    as timed by ``tools/int8_conv_times.py --sweep`` (PERF.md)."""
    items = n_slots * c_split // 16
    b_bytes = k * k * c_split * bn
    macs = TILE_M * mw * bn * k * k * c_split
    epilogue = TILE_M * mw * bn / 8192 * (1.5 if splits > 1 else 1.0)
    return 4.0 + 2.0 * _cdiv(items, 1024) + b_bytes / 60e3 + macs / 7e9 + epilogue


def plan_candidates(n: int, c: int, h: int, w: int, co: int, k: int, stride: int,
                    mw: int = 0) -> list:
    """Every plan the kernel can run for a conv shape (groups 1), as
    (modelled us, blocks, plan): each tile (``mw`` 2: 128 pixels, the
    warpgroups share the weights; ``mw`` 1: 64 pixels and twice the
    channels, they share the A patch; ``mw`` restricts it), warpgroup width
    (64, 128, 256 channels, no wider than C_out needs) and split-K factor
    (1 to ``MAX_SPLITS``, input channels in multiples of 32) whose A patch
    and weights fit ``SMEM_BUDGET``, costed as waves x ``_block_us``: a
    block whose warpgroups are 256 wide holds an SM (its registers),
    narrower ones two if their shared memory allows."""
    pad = (k - 1) // 2
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    flat = int(k == 1 and stride == 1)
    chunks = _cdiv(c, 32)  # K per tap in 32-byte (one k32 step) units
    out = []
    for mw in (mw,) if mw else (1, 2):
        if flat:
            tiles_y = tiles_x = rp = qw = 0
            tiles, n_slots = _cdiv(n * ho * wo, TILE_M * mw), TILE_M * mw
        else:
            tiles_y, tiles_x = _cdiv(ho, 8 * mw), _cdiv(wo, 8)
            qw = _cdiv(7 * stride + k, stride)
            rp = stride * qw
            tiles, n_slots = n * tiles_y * tiles_x, ((8 * mw - 1) * stride + k) * rp
        for bnw in (64, 128, 256):  # a warpgroup's channels
            if bnw > 64 and (bnw // 2 >= co or mw == 1 and bnw >= co):
                break
            bn = bnw if mw == 2 else 2 * bnw
            for splits in (1, 2, 4, 8):
                if splits > MAX_SPLITS or chunks % splits:
                    break
                c_split = 32 * (chunks // splits)
                rb = row_bytes(c_split)
                a_plane = _cdiv(n_slots * rb, 1024) * 1024  # whole swizzle atoms
                a = c_split // rb * a_plane
                need = a + k * k * c_split * bn  # the A planes, then the weights
                if need > SMEM_BUDGET:
                    continue
                smem = max(need, TILE_M * mw * (bn + 8) * 4)
                per_sm = min(1 if bnw == 256 else 2, 228 * 1024 // (smem + 1024))
                blocks = tiles * _cdiv(co, bn) * splits
                cost = _cdiv(blocks, SMS * per_sm) * _block_us(mw, bn, k, c_split, n_slots,
                                                                 splits)
                out.append((cost, blocks, Int8ConvPlan(
                    flat, mw, bn, splits, c_split, tiles_y, tiles_x, rp, qw, n_slots, a_plane, a,
                    smem, int(c % 16 == 0), (tiles, _cdiv(co, bn), splits))))
    return out


@functools.lru_cache(maxsize=None)
def plan_int8_conv(n: int, c: int, h: int, w: int, co: int, k: int, stride: int,
                   groups: int = 1):
    """The kernel's plan for one conv shape: the cheapest of
    ``plan_candidates`` (ties to fewer blocks), or None for a grouped conv
    (the direct kernel). Deterministic, a plain function of the shape."""
    if groups != 1:
        return None
    found = plan_candidates(n, c, h, w, co, k, stride)
    if not found:
        raise ValueError(f"int8_conv: no plan fits {SMEM_BUDGET} bytes of shared memory for "
                         f"{(n, c, h, w, co, k, stride)}")
    return min(found, key=lambda t: t[:2])[2]


def _record(plan) -> ctypes.Array:
    record = plan.record() if plan is not None else [0] * len(PLAN_FIELDS)
    return (ctypes.c_int * len(record))(*record)


@functools.lru_cache(maxsize=None)
def _plan_record(n, c, h, w, co, k, stride, groups):
    return _record(plan_int8_conv(n, c, h, w, co, k, stride, groups))


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
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
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
              act_scale: torch.Tensor, *, stride: int = 1, groups: int = 1,
              plan: Int8ConvPlan = None) -> torch.Tensor:
    """[N, C, H, W] float32 / bfloat16 -> [N, C_out, Ho, Wo] of the same
    dtype, ``channels_last`` on the card. ``kernel_q`` is OIHW int8,
    ``w_scale`` float32 [C_out], ``act_scale`` a float32 scalar (per
    tensor) or [C] (per input channel).

    On the card ``x`` must be ``channels_last``; an NCHW-contiguous input is
    copied to ``channels_last`` first (an explicit copy: the port's
    activations on the card are ``channels_last`` already), any other layout
    raises. ``kernel_q`` is read OHWI: a ``channels_last`` kernel (a model
    placed on the card) is read in place, another one is copied. ``plan``
    overrides the planner's choice (one of ``plan_candidates`` of the
    shape; ``tools/int8_conv_times.py --sweep`` times them all)."""
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
    record = _plan_record(n, c, h, w, co, k, stride, groups) if plan is None \
        else _record(plan)
    err = _lib().streamyolo_int8_conv(
        x.data_ptr(), w_ohwi.data_ptr(), act_scale.contiguous().data_ptr(),
        w_scale.contiguous().data_ptr(), out.data_ptr(), n, h, w, c, co, k, stride, groups,
        int(act_scale.ndim > 0), _DTYPE_KINDS[x.dtype], record, len(record), stream)
    int8_conv.launches += 1
    if err:
        raise RuntimeError(f"int8 conv kernel launch failed: cudaError {err}")
    return out


int8_conv.launches = 0
