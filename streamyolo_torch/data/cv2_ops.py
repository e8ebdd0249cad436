"""NumPy counterparts of the cv2 calls on the JAX package's training data
path, equal to cv2 bit for bit, so that the port needs no cv2 to augment:

  * ``resize_u8``: ``cv2.resize(img, (w, h), interpolation=INTER_LINEAR)``,
    native (``native/image_io.cpp``); ``resize_u8_reference`` is its NumPy
    twin, which the tests hold it against and no data or serving path
    calls;
  * ``warp_affine_u8``: ``cv2.warpAffine(img, M, (w, h), borderValue=b)``;
  * ``warp_perspective_u8``: ``cv2.warpPerspective`` likewise;
  * ``bgr2hsv_u8`` / ``hsv2bgr_u8``: ``cv2.cvtColor`` with
    ``COLOR_BGR2HSV`` / ``COLOR_HSV2BGR`` on uint8.

All take and return [H, W, 3] uint8 arrays; the NumPy ones are vectorised
(no loop over pixels). The arithmetic is cv2's own, as cv2 runs it on an
x86-64 host with AVX2, including the places where its SIMD body and its
scalar tail round differently:

  * ``resize``: cv2's fixed-point path. The horizontal pass is exact in
    int32 with 11-bit coefficients (the x map is clamped at both borders);
    the vertical pass is the SIMD one for every column: each row value is
    shifted right by 4 and multiplied by its 11-bit coefficient keeping the
    high 16 bits, the two products are summed and rounded off by 2 bits.
    The y map is not clamped: at the top and bottom the two taps read the
    same clamped row with weights that do not sum to one coefficient, so
    the per-product truncation shows there. An exact 2x downsample is
    cv2's 2x2 average, ``(a + b + c + d + 2) >> 2``.
  * The warps: float32 throughout. The inverse map is taken in float64 as
    cv2 takes it (the closed form for an affine, the 3x3 adjugate for a
    perspective) and cast to float32. A row's offset is ``y*M1 + M2`` (a
    float32 product, then a sum); the SIMD body, 16 output pixels at a time
    while ``x <= width - 16``, takes ``fma(M0, x, offset)``; the scalar tail
    takes ``fma(x, M0, y*M1) + M2``. A perspective divides by its third
    coordinate. The bilinear tap is three fused multiply-adds,
    ``r0 = fma(ax, p01 - p00, p00)``, ``r1`` likewise, ``fma(ay, r1 - r0,
    r0)``, rounded half to even; taps outside the image read the border.
  * ``COLOR_BGR2HSV``: integer arithmetic with cv2's 12-bit division tables.
  * ``COLOR_HSV2BGR``: float32 with fused ``1 - s*h``; the SIMD body (32
    pixels at a time along each row while ``x <= width - 32``) truncates the
    result, the scalar tail rounds it.

``fma32`` is a correctly rounded float32 fused multiply-add in NumPy: the
product of two float32 is exact in float64, and the one double rounding
that can follow (a float64 sum exactly halfway between two float32) is
corrected with the sum's exact residual.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from streamyolo_torch.native import load_image_io

_COEF_BITS = 11  # cv2's INTER_RESIZE_COEF_BITS
_WARP_BLOCK = 16  # output pixels per SIMD step of cv2's warp kernels (AVX2)
_HSV_BLOCK = 32  # pixels per SIMD step of cv2's HSV -> BGR (AVX2)
_HSV_SHIFT = 12
_ROWS_PER_CHUNK = 64  # output rows per vectorised warp chunk (bounds memory)


def fma32(a, b, c) -> np.ndarray:
    """``a * b + c`` with one rounding to float32, for operands that hold
    float32 values (float32 arrays, or float64 arrays of float32 values)."""
    c64 = np.asarray(c, np.float64)
    p = np.asarray(a, np.float64) * np.asarray(b, np.float64)  # exact
    s = p + c64
    r = s.astype(np.float32)
    # s halfway between two float32: its low 29 fraction bits are 1 << 28
    bits = np.ascontiguousarray(s).view(np.uint64)
    mid = (bits & np.uint64((1 << 29) - 1)) == np.uint64(1 << 28)
    if mid.any():
        idx = np.nonzero(mid)
        pm, cm, sm = np.broadcast_to(p, s.shape)[idx], np.broadcast_to(c64, s.shape)[idx], s[idx]
        bb = sm - pm
        err = (pm - (sm - bb)) + (cm - bb)  # p + c == s + err exactly
        rm = r[idx]
        up = sm - rm.astype(np.float64)  # which way s was rounded
        fix = err * up > 0  # the exact sum lies beyond s, away from rm
        toward = np.where(up > 0, np.float32(np.inf), np.float32(-np.inf))
        r[idx] = np.where(fix, np.nextafter(rm, toward), rm)
    return r


# ---------------------------------------------------------------- resize


def _linear_taps(n_in: int, n_out: int, clamp: bool):
    """cv2's source indices and 11-bit weights along one axis: the
    half-pixel map in float32 at scale ``1 / (n_out / n_in)``. ``clamp``
    (the x axis) pins the taps outside the image to the border pixel with
    weights (1, 0); without it (the y axis) only the indices are clamped."""
    f = ((np.arange(n_out) + 0.5) * (1.0 / (n_out / n_in)) - 0.5).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    frac = f - i0.astype(np.float32)
    if clamp:
        low, high = i0 < 0, i0 >= n_in - 1
        i0[low], frac[low] = 0, 0
        i0[high], frac[high] = n_in - 1, 0
    i1 = np.clip(i0 + 1, 0, n_in - 1)
    i0 = np.clip(i0, 0, n_in - 1)
    scale = np.float32(1 << _COEF_BITS)
    w0 = np.rint((np.float32(1) - frac) * scale).astype(np.int32)
    w1 = np.rint(frac * scale).astype(np.int32)
    return i0, i1, w0, w1


def resize_u8(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """``cv2.resize(img, (out_w, out_h), interpolation=cv2.INTER_LINEAR)``
    for an [H, W, C] uint8 image, in native code (``resize_linear_u8`` of
    ``native/image_io.cpp``, ``resize_u8_reference`` transcribed). The same
    size returns ``img`` itself."""
    h, w = img.shape[:2]
    if (h, w) == (out_h, out_w):
        return img
    if img.dtype != np.uint8 or img.ndim != 3 or min(h, w, out_h, out_w) < 1:
        raise ValueError(f"resize_u8 takes a non-empty [H, W, C] uint8 image and a size >= 1, "
                         f"got {img.dtype} {img.shape} -> ({out_h}, {out_w})")
    src = np.ascontiguousarray(img)
    out = np.empty((out_h, out_w, img.shape[2]), np.uint8)
    load_image_io().resize_linear_u8(src, h, w, img.shape[2], out, out_h, out_w)
    return out


def resize_u8_reference(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """``resize_u8`` in NumPy: the plain twin of the native resize."""
    h, w = img.shape[:2]
    if (h, w) == (out_h, out_w):
        return img
    if h == 2 * out_h and w == 2 * out_w:
        pairs = img.reshape(out_h, 2, w, -1)
        rows = pairs[:, 0].astype(np.uint16) + pairs[:, 1]
        quads = rows.reshape(out_h, out_w, 2, -1)
        acc = quads[:, :, 0] + quads[:, :, 1]
        acc += 2
        acc >>= 2
        return acc.astype(np.uint8)
    x0, x1, wx0, wx1 = _linear_taps(w, out_w, clamp=True)
    y0, y1, wy0, wy1 = _linear_taps(h, out_h, clamp=False)
    s = img.astype(np.int32)
    # int32 holds every intermediate: a row value is <= 255 * 2048
    rows = (s[:, x0] * wx0[None, :, None] + s[:, x1] * wx1[None, :, None]) >> 4
    acc = ((rows[y0] * wy0[:, None, None]) >> 16) + ((rows[y1] * wy1[:, None, None]) >> 16)
    return np.clip((acc + 2) >> 2, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------- warps


def _invert_affine(m: np.ndarray) -> np.ndarray:
    """cv2.warpAffine's inverse of a 2x3 map, in float64, as 6 values."""
    m = np.asarray(m, np.float64).reshape(6).copy()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, m[1] * -d, m[3] * -d, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m


def _invert_3x3(m: np.ndarray) -> np.ndarray:
    """cv2.invert's closed form for a 3x3 float64 matrix (the adjugate over
    the determinant), as 9 values."""
    m = np.asarray(m, np.float64)
    d = (m[0, 0] * (m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1])
         - m[0, 1] * (m[1, 0] * m[2, 2] - m[1, 2] * m[2, 0])
         + m[0, 2] * (m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0]))
    if d == 0:
        return np.zeros(9)
    d = 1.0 / d
    return np.array([
        (m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1]) * d,
        (m[0, 2] * m[2, 1] - m[0, 1] * m[2, 2]) * d,
        (m[0, 1] * m[1, 2] - m[0, 2] * m[1, 1]) * d,
        (m[1, 2] * m[2, 0] - m[1, 0] * m[2, 2]) * d,
        (m[0, 0] * m[2, 2] - m[0, 2] * m[2, 0]) * d,
        (m[0, 2] * m[1, 0] - m[0, 0] * m[1, 2]) * d,
        (m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0]) * d,
        (m[0, 1] * m[2, 0] - m[0, 0] * m[2, 1]) * d,
        (m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]) * d,
    ])


def _mapped(m: np.ndarray, y: np.ndarray, x_vec: np.ndarray, x_tail: np.ndarray):
    """One source coordinate (row ``m`` of the float32 inverse map) for
    output rows ``y`` [R, 1]: the SIMD body's at columns ``x_vec``, the
    scalar tail's at ``x_tail``; [R, W] float32."""
    m0, m1, m2 = (np.float32(v) for v in m)
    body = fma32(m0, x_vec, y * m1 + m2)
    tail = fma32(x_tail, m0, y * m1) + m2
    return np.concatenate([np.broadcast_to(body, (len(y), x_vec.size)),
                           np.broadcast_to(tail, (len(y), x_tail.size))], axis=1)


def _warp_u8(img: np.ndarray, inv: np.ndarray, out_hw: Sequence[int], border,
             perspective: bool) -> np.ndarray:
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    h, w, c = img.shape
    inv = inv.astype(np.float32)
    n_vec = out_w // _WARP_BLOCK * _WARP_BLOCK
    xs = np.arange(out_w, dtype=np.float32)
    x_vec, x_tail = xs[None, :n_vec], xs[None, n_vec:]
    # two border pixels on every side: a tap index is clipped into them
    pad = np.empty((h + 4, w + 4, c), np.uint8)
    pad[...] = np.asarray(border, np.uint8).reshape(-1)[:c] if np.ndim(border) else border
    pad[2:h + 2, 2:w + 2] = img
    flat = pad.reshape(-1, c)
    out = np.empty((out_h, out_w, c), np.uint8)
    for r0 in range(0, out_h, _ROWS_PER_CHUNK):
        y = np.arange(r0, min(r0 + _ROWS_PER_CHUNK, out_h), dtype=np.float32)[:, None]
        sx = _mapped(inv[0:3], y, x_vec, x_tail)
        sy = _mapped(inv[3:6], y, x_vec, x_tail)
        if perspective:
            wz = _mapped(inv[6:9], y, x_vec, x_tail)
            sx, sy = sx / wz, sy / wz
        fx, fy = np.floor(sx), np.floor(sy)
        ax, ay = (sx - fx)[..., None], (sy - fy)[..., None]
        # float32 -> int64 of out-of-range or NaN coordinates lands outside
        with np.errstate(invalid="ignore"):
            ix = np.clip(np.nan_to_num(fx, nan=-4.0), -4, w + 4).astype(np.int64) + 2
            iy = np.clip(np.nan_to_num(fy, nan=-4.0), -4, h + 4).astype(np.int64) + 2
        cx0, cx1 = np.clip(ix, 0, w + 3), np.clip(ix + 1, 0, w + 3)
        cy0, cy1 = np.clip(iy, 0, h + 3) * (w + 4), np.clip(iy + 1, 0, h + 3) * (w + 4)
        p00 = flat[cy0 + cx0].astype(np.float64)
        p01 = flat[cy0 + cx1].astype(np.float64)
        p10 = flat[cy1 + cx0].astype(np.float64)
        p11 = flat[cy1 + cx1].astype(np.float64)
        top = fma32(ax, p01 - p00, p00)
        bottom = fma32(ax, p11 - p10, p10)
        val = fma32(ay, bottom - top, top)  # bottom - top rounds in float32
        out[r0:r0 + len(y)] = np.clip(np.rint(val), 0, 255).astype(np.uint8)
    return out


def warp_affine_u8(img: np.ndarray, matrix: np.ndarray, out_hw: Sequence[int],
                   border=114) -> np.ndarray:
    """``cv2.warpAffine(img, matrix, (out_w, out_h), borderValue=border)``:
    ``matrix`` [2, 3] maps source to output pixels, INTER_LINEAR, a constant
    border. ``out_hw`` is (height, width)."""
    return _warp_u8(img, _invert_affine(matrix), out_hw, border, perspective=False)


def warp_perspective_u8(img: np.ndarray, matrix: np.ndarray, out_hw: Sequence[int],
                        border=114) -> np.ndarray:
    """``cv2.warpPerspective(img, matrix, (out_w, out_h), borderValue=border)``
    for a [3, 3] ``matrix``, as ``warp_affine_u8``."""
    return _warp_u8(img, _invert_3x3(matrix), out_hw, border, perspective=True)


# ---------------------------------------------------------------- colour


def _hsv_tables() -> Tuple[np.ndarray, np.ndarray]:
    i = np.arange(256, dtype=np.float64)
    i[0] = 1
    sdiv = np.rint((255 << _HSV_SHIFT) / i).astype(np.int32)
    hdiv = np.rint((180 << _HSV_SHIFT) / (6.0 * i)).astype(np.int32)
    sdiv[0] = hdiv[0] = 0
    return sdiv, hdiv


def bgr2hsv_u8(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_BGR2HSV)`` on uint8: H in [0, 180)."""
    sdiv, hdiv = _hsv_tables()
    b, g, r = (img[..., k].astype(np.int32) for k in range(3))
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * sdiv[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * hdiv[diff] + half) >> _HSV_SHIFT
    h += np.where(h < 0, 180, 0)
    return np.stack([h, s, v], axis=-1).astype(np.uint8)


_SECTOR_TAPS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def hsv2bgr_u8(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_HSV2BGR)`` on an [H, W, 3] uint8 image
    (H in degrees / 2)."""
    f32, one = np.float32, np.float32(1)
    h = img[..., 0].astype(f32) * f32(6.0 / 180)
    s = img[..., 1].astype(f32) * f32(1.0 / 255)
    v = img[..., 2].astype(f32) * f32(1.0 / 255)
    whole = np.trunc(h)
    h = h - whole
    sector = (whole - np.trunc(whole * f32(1.0 / 6)) * f32(6)).astype(np.int64)
    tab = np.stack([v, v * (one - s), v * fma32(-s, h, one), v * fma32(-s, one - h, one)],
                   axis=-1)
    bgr = np.take_along_axis(tab, _SECTOR_TAPS[sector], axis=-1) * f32(255)
    width = img.shape[1]
    n_vec = width // _HSV_BLOCK * _HSV_BLOCK
    out = np.empty(img.shape, np.uint8)
    out[:, :n_vec] = np.clip(np.trunc(bgr[:, :n_vec]), 0, 255)
    out[:, n_vec:] = np.clip(np.rint(bgr[:, n_vec:]), 0, 255)
    return out
