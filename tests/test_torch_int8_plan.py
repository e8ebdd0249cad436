"""The int8 conv kernel's tile planner (``ops/int8_conv.py::plan_int8_conv``)
on the CPU, and a NumPy model of how ``csrc/int8_conv.cu`` walks a plan.

Shapes: the 29 conv shapes of StreamYOLO-l's steady serving step
(``tools/int8_conv_times.py::STEP_SHAPES``), the ``CASES`` of
``tests/test_torch_quant_cuda.py``, and edge shapes (M tails, C_out below
and past the channel block, the 12-channel stem, stride 2 on odd extents).
For each: every output element is written by exactly one block, the splits
own disjoint input channels that cover C_in, each partial sum and the total
stay within int32, the plan fits the card's shared memory and is the same
on every call. The model of the kernel (which input pixel each slot of the
int8 patch holds, and which 64 x 32 bytes each wgmma's matrix descriptors
address in the patch and the weight ring) reproduces an exact integer
convolution at small shapes: bound, equal in every element."""

import numpy as np
import pytest

from streamyolo_torch.ops import int8_conv as mod
from streamyolo_torch.ops.int8_conv import (MAX_SMEM, MAX_SPLITS, TILE_M, plan_candidates,
                                             plan_int8_conv, row_bytes)
from streamyolo_torch.tools.int8_conv_times import STEP_SHAPES

from .test_torch_quant_cuda import CASES

STEP = [shape for _, shape in STEP_SHAPES]
CASE_SHAPES = [(n, c, h, w, co, k, s, g) for n, c, co, h, w, k, s, g, _ in CASES if g == 1]
EDGE = [  # n, c, h, w, c_out, k, stride, groups
    (1, 64, 5, 7, 64, 1, 1, 1),        # flat: M = 35 < 64
    (3, 128, 7, 9, 320, 1, 1, 1),      # flat across images; C_out past one 256 block
    (1, 64, 38, 60, 96, 3, 1, 1),      # C_out 96 under a 128-wide block
    (1, 32, 13, 21, 24, 3, 1, 1),      # C_out 24 under a 64-wide block
    (1, 12, 300, 480, 64, 3, 1, 1),    # the Focus stem, full size
    (1, 12, 11, 17, 64, 3, 1, 1),      # the stem, tails
    (1, 64, 75, 120, 128, 3, 2, 1),    # stride 2, odd extent: 75x120 -> 38x60
    (1, 256, 19, 30, 512, 3, 2, 1),    # stride 2, 19x30 -> 10x15
    (2, 48, 37, 59, 40, 3, 2, 1),      # stride 2, odd both ways, C_in not a multiple of 32
    (1, 4096, 3, 5, 64, 1, 1, 1),      # split-K at its limit
]
ALL = STEP + CASE_SHAPES + EDGE


def out_hw(shape):
    _, _, h, w, _, k, s, _ = shape
    pad = (k - 1) // 2
    return (h + 2 * pad - k) // s + 1, (w + 2 * pad - k) // s + 1


def tile_origin(plan, shape, bx):
    """(img, oy0, ox0) of a patch block, as the kernel derives them."""
    per = plan.tiles_y * plan.tiles_x
    t = bx % per
    return bx // per, (t // plan.tiles_x) * 8 * plan.mw, (t % plan.tiles_x) * 8


def tile_pixels(plan, shape, bx):
    """The output pixel of each of the block's 64 mw rows, -1 for a padded
    row (the kernel's epilogue)."""
    n, ho_wo = shape[0], out_hw(shape)
    r = np.arange(TILE_M * plan.mw)
    if plan.flat:
        m = bx * TILE_M * plan.mw + r
        return np.where(m < n * ho_wo[0] * ho_wo[1], m, -1)
    img, oy0, ox0 = tile_origin(plan, shape, bx)
    oy, ox = oy0 + r // 8, ox0 + r % 8
    ok = (oy < ho_wo[0]) & (ox < ho_wo[1])
    return np.where(ok, (img * ho_wo[0] + oy) * ho_wo[1] + ox, -1)


def slot_pixels(plan, shape, bx):
    """The input pixel each slot of the block's int8 patch holds, -1 for a
    zero slot (the kernel's ``load_patch``)."""
    n, c, h, w, co, k, s, _ = shape
    sl = np.arange(plan.n_slots)
    if plan.flat:
        m = bx * TILE_M * plan.mw + sl
        return np.where(m < n * h * w, m, -1)
    img, oy0, ox0 = tile_origin(plan, shape, bx)
    pad = (k - 1) // 2
    py, rem = sl // plan.rp, sl % plan.rp
    phase = rem // plan.qw
    px = (rem % plan.qw) * s + phase
    ih, iw = oy0 * s - pad + py, ox0 * s - pad + px
    ok = (px < 7 * s + k) & (ih >= 0) & (ih < h) & (iw >= 0) & (iw < w)
    return np.where(ok, (img * h + ih) * w + iw, -1)


def desc_tile(buf, start, lbo, sbo, rows):
    """The rows x 32 bytes a no-swizzle K-major matrix descriptor names:
    8-row x 16-byte core matrices, 8-row groups ``sbo`` apart, the two
    16-byte halves of K ``lbo`` apart."""
    r, kk = np.arange(rows)[:, None], np.arange(32)[None, :]
    return buf[start + (r // 8) * sbo + (r % 8) * 16 + (kk // 16) * lbo + kk % 16]


def swizzle(addr, row_bytes):
    """wgmma's R-byte swizzle of a shared-memory byte address (from a base
    aligned to its 8-row atom): 16-byte chunk bits 4.. XOR address bits 7.."""
    bits = {128: 7, 64: 3, 32: 1}[row_bytes]
    return addr ^ (((addr >> 7) & bits) << 4)


def desc_tile_swizzled(buf, start, rb, rows, sbo):
    """The rows x 32 bytes a K-major descriptor in the R-byte swizzle mode
    names: rows R bytes apart in 8-row groups ``sbo`` apart, then swizzled
    by address (the descriptor's base offset carries the start's phase)."""
    r, kk = np.arange(rows)[:, None], np.arange(32)[None, :]
    return buf[swizzle(start + (r // 8) * sbo + (r % 8) * rb + kk, rb)]


def kernel_walk(plan, shape, xq, wq):
    """The int32 output [M, C_out] as the kernel's blocks compute it from
    int8 ``xq`` [n, h, w, c] and ``wq`` [co, k, k, c]."""
    n, c, h, w, co, k, s, _ = shape
    ho, wo = out_hw(shape)
    x_pix, w_k = xq.reshape(-1, c), wq.reshape(co, k * k * c)
    out = np.full((n * ho * wo, co), np.iinfo(np.int64).min)
    rb = row_bytes(plan.c_split)
    a_sbo = (8 if plan.flat else s * plan.rp) * rb
    bnw = plan.bn // (3 - plan.mw)  # a warpgroup's channels
    per_tap = plan.c_split // 16
    for bx in range(plan.grid[0]):
        src, dst = slot_pixels(plan, shape, bx), tile_pixels(plan, shape, bx)
        for by in range(plan.grid[1]):
            n0 = by * plan.bn
            cols = np.arange(n0, min(co, n0 + plan.bn))
            parts = []
            for z in range(plan.splits):
                c_base = z * plan.c_split
                # the patch, [plane of R channels][slot][R bytes], swizzled
                planes = np.zeros((plan.c_split // rb, plan.a_plane // rb, rb), np.int8)
                for ch in range(per_tap):
                    c0, vals = c_base + 16 * ch, np.zeros((plan.n_slots, 16), np.int8)
                    nv = max(0, min(16, c - c0))
                    vals[src >= 0, :nv] = x_pix[src[src >= 0], c0:c0 + nv]
                    kb, cidx = divmod(16 * ch, rb)
                    planes[kb, :plan.n_slots, cidx:cidx + 16] = vals
                a = np.zeros(planes.size, np.int8)
                a[swizzle(np.arange(planes.size), rb)] = planes.ravel()
                # the weights, [tap][K block of R bytes][channel][R bytes], swizzled
                blk = np.zeros((k * k, plan.c_split // rb, plan.bn, rb), np.int8)
                for tap, p in np.ndindex(k * k, per_tap):
                    nv = max(0, min(16, c - c_base - 16 * p))
                    kb, cidx = divmod(16 * p, rb)
                    blk[tap, kb, :len(cols), cidx:cidx + nv] = w_k[
                        cols, tap * c + c_base + 16 * p:][:, :nv]
                flat_b = blk.ravel()
                b = np.zeros_like(flat_b)
                b[swizzle(np.arange(flat_b.size), rb)] = flat_b
                acc = np.zeros((TILE_M * plan.mw, plan.bn), np.int64)
                for tap, j, g in np.ndindex(k * k, plan.c_split // 32, 2):  # warpgroup g
                    ky, kx = divmod(tap, k)
                    slot0 = 0 if plan.flat else ky * plan.rp + (kx % s) * plan.qw + kx // s
                    row0, col0 = (TILE_M * g, 0) if plan.mw == 2 else (0, bnw * g)
                    kb, within = divmod(32 * j, rb)
                    at = desc_tile_swizzled(
                        a, kb * plan.a_plane + (row0 // TILE_M * 8 * a_sbo) + slot0 * rb + within,
                        rb, TILE_M, a_sbo)
                    bt = desc_tile_swizzled(
                        b, ((tap * (plan.c_split // rb) + kb) * plan.bn + col0) * rb + within,
                        rb, bnw, 8 * rb)
                    acc[row0:row0 + TILE_M, col0:col0 + bnw] += at.astype(
                        np.int64) @ bt.astype(np.int64).T
                assert np.abs(acc).max(initial=0) < 2 ** 31
                parts.append(acc)
            total = sum(parts)
            rows = np.nonzero(dst >= 0)[0]
            out[np.ix_(dst[rows], cols)] = total[np.ix_(rows, cols - n0)]
    return out


def conv_int(shape, xq, wq):
    """The exact integer convolution, [M, C_out]."""
    n, c, h, w, co, k, s, _ = shape
    ho, wo = out_hw(shape)
    pad = (k - 1) // 2
    xp = np.pad(xq.astype(np.int64), ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    out = np.zeros((n, ho, wo, co), np.int64)
    for ky in range(k):
        for kx in range(k):
            win = xp[:, ky:ky + s * (ho - 1) + 1:s, kx:kx + s * (wo - 1) + 1:s]
            out += win @ wq[:, ky, kx, :].astype(np.int64).T
    return out.reshape(-1, co)


@pytest.mark.parametrize("shape", ALL, ids=str)
def test_plan_covers_each_output_once(shape):
    n, c, h, w, co, k, s, _ = shape
    ho, wo = out_hw(shape)
    plan = plan_int8_conv(*shape)
    assert plan.grid[1] * plan.bn >= co > (plan.grid[1] - 1) * plan.bn
    count = np.zeros((n * ho * wo, co), np.int32)
    tile_m = TILE_M * plan.mw
    for bx in range(plan.grid[0]):
        pix = tile_pixels(plan, shape, bx)
        for z in range(plan.splits):  # block z of the cluster writes these rows
            rows = pix[z * tile_m // plan.splits:(z + 1) * tile_m // plan.splits]
            rows = rows[rows >= 0]
            for by in range(plan.grid[1]):
                count[rows, by * plan.bn:(by + 1) * plan.bn] += 1
    assert count.min() == count.max() == 1


@pytest.mark.parametrize("shape", ALL, ids=str)
def test_plan_splits_and_fits(shape):
    """Splits own disjoint channel ranges covering C_in, every one with a
    real channel; int32 holds any partial and the total; shared memory and
    the ring fit; the C entry point's checks (``plan_fits``) pass."""
    n, c, h, w, co, k, s, _ = shape
    plan = plan_int8_conv(*shape)
    ranges = [range(z * plan.c_split, min(c, (z + 1) * plan.c_split))
              for z in range(plan.splits)]
    assert [ch for r in ranges for ch in r] == list(range(c)) and all(len(r) for r in ranges)
    assert plan.splits <= MAX_SPLITS and plan.grid[2] == plan.splits
    assert 127 * 127 * k * k * plan.c_split < 2 ** 31 and 127 * 127 * k * k * c < 2 ** 31
    assert plan.c_split % 32 == 0
    assert plan.bn // (3 - plan.mw) in (64, 128, 256)  # a warpgroup's channels
    rb = row_bytes(plan.c_split)
    assert plan.a_bytes % 1024 == 0 and plan.a_bytes >= plan.c_split // rb * plan.a_plane
    assert plan.a_plane >= rb * plan.n_slots and plan.a_plane % 1024 == 0
    assert plan.a_bytes + k * k * plan.c_split * plan.bn <= plan.smem <= MAX_SMEM
    assert plan.smem >= TILE_M * plan.mw * (plan.bn + 8) * 4  # the epilogue's int32 tile
    assert plan.mw in (1, 2)
    if plan.flat:
        assert k == s == 1 and plan.n_slots == TILE_M * plan.mw
    else:
        ho, wo = out_hw(shape)
        assert (plan.tiles_y, plan.tiles_x) == (-(-ho // (8 * plan.mw)), -(-wo // 8))
        pw, ph = 7 * s + k, (8 * plan.mw - 1) * s + k
        assert plan.qw * s >= pw and plan.rp >= s * plan.qw and plan.n_slots >= ph * plan.rp
        # the last slot a tap reads lies in the patch
        last = max(ky * plan.rp + (kx % s) * plan.qw + kx // s for ky in range(k)
                   for kx in range(k)) + (8 * plan.mw - 1) * s * plan.rp + 7
        assert last < plan.n_slots
    assert len(plan.record()) == len(mod.PLAN_FIELDS) == 14


@pytest.mark.parametrize("shape", ALL, ids=str)
def test_plan_is_deterministic(shape):
    first = plan_int8_conv(*shape)
    plan_int8_conv.cache_clear()
    assert plan_int8_conv(*shape) == first and plan_int8_conv(*shape).record() == first.record()


def test_plan_paths():
    """The 12-channel stem takes the element-by-element path (no 16-byte
    pixel stride), K padded to 32 per tap; every other step shape the
    vector path; 1x1 stride-1 convs are flat, the rest patch tiles; the
    /32 level splits K; a channel block is never wider than C_out needs."""
    stem = plan_int8_conv(1, 12, 300, 480, 64, 3, 1, 1)
    assert stem.vec == 0 and stem.c_split == 32 and not stem.flat
    for shape in STEP:
        plan = plan_int8_conv(*shape)
        assert plan.vec == (shape[1] != 12)
        assert plan.flat == (shape[5] == 1 and shape[6] == 1)
        if shape[2] * shape[3] // shape[6] ** 2 <= 19 * 30:
            assert plan.splits > 1, shape
        assert plan.bn // (3 - plan.mw) == 64 or plan.bn // 2 < shape[4]
    assert plan_int8_conv(2, 48, 13, 17, 48, 3, 1, 48) is None  # grouped: the direct kernel


SMALL = [  # the kernel's walk at small sizes, every path
    (1, 12, 11, 17, 64, 3, 1, 1),      # stem: element path, tails
    (2, 32, 9, 11, 48, 3, 2, 1),       # stride 2, odd extents, two images
    (1, 40, 9, 11, 24, 1, 2, 1),       # 1x1 stride 2, C_in 40 (split-K, padded chunk)
    (3, 64, 5, 7, 96, 1, 1, 1),        # flat across images, tails
    (1, 96, 13, 21, 320, 3, 1, 1),     # two channel blocks, the second partial
    (1, 512, 3, 5, 64, 3, 1, 1),       # split-K
    (1, 256, 6, 10, 256, 3, 2, 1),     # stride 2 with split-K
    (1, 32, 21, 37, 64, 3, 2, 1),      # stride 2, odd extents, more tiles
]


@pytest.mark.parametrize("mw", [1, 2])
@pytest.mark.parametrize("shape", SMALL, ids=str)
def test_kernel_walk_equals_conv(shape, mw):
    n, c, h, w, co, k, s, _ = shape
    rng = np.random.default_rng(sum(shape))
    xq = rng.integers(-127, 128, (n, h, w, c), dtype=np.int64).astype(np.int8)
    wq = rng.integers(-127, 128, (co, k, k, c), dtype=np.int64).astype(np.int8)
    # the cheapest plan with this tile height
    plan = min(plan_candidates(*shape[:7], mw=mw), key=lambda t: t[:2])[2]
    assert plan.mw == mw
    got = kernel_walk(plan, shape, xq, wq)
    np.testing.assert_array_equal(got, conv_int(shape, xq, wq))
