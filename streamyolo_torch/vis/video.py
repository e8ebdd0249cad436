"""MP4 writing without cv2: ``VideoWriter`` writes the file
``cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))``
writes, an MPEG-4 Part 2 simple-profile stream in an MP4 container, with
the port's own encoder (``native/video.cpp``, built with g++ at first use;
a failed build raises ``NativeBuildError``, nothing stands in for it).

The stream is coded as FFmpeg's mpeg4 encoder behind cv2 codes it: H.263
quantisation at quantiser 3, an I-VOP every 12 frames and P-VOPs between
them, half-pel motion with f_code 1, no B-VOPs; the time base is the
reduced fraction of ``fps`` by OpenCV's rule (``time_base``), so cv2 reads
``CAP_PROP_FPS`` back as given. A frame with an odd width or height loses
its last column or row, as cv2's writer crops it. FFmpeg's bytes are not
matched (its rate control and motion search are its own): the port's file
is held to what cv2 reads back from the JAX package's file, and its bytes
are pinned (``tests/test_torch_video.py``).

    with VideoWriter("out.mp4", 30.0, (w, h)) as writer:
        for frame in frames:          # [h, w, 3] uint8 BGR
            writer.write(frame)

The NumPy functions below (``bgr_to_yuv420``, ``forward_blocks``,
``inverse_blocks``) are twins of the encoder's numeric stages, bit for bit,
for the tests; ``native_*`` call the native stages alone.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import Tuple

import numpy as np

from streamyolo_torch.native import load_video

_ERR = 512


def time_base(fps: float) -> Tuple[int, int]:
    """(vop_time_increment_resolution, frame duration) in whole ticks: the
    fraction OpenCV's FFmpeg writer makes of ``fps`` (a power of ten as the
    denominator, grown until the fraction is within 0.001 of ``fps``),
    reduced as FFmpeg reduces the time base."""
    fps = float(fps)
    if not fps > 0 or math.isinf(fps):
        raise ValueError(f"fps {fps} must be finite and above 0")
    rate, base = int(fps + 0.5), 1
    while abs(rate / base - fps) > 0.001:
        base *= 10
        rate = int(fps * base + 0.5)
    g = math.gcd(rate, base)
    rate, base = rate // g, base // g
    if rate > 65535:
        raise ValueError(f"fps {fps} needs a time base of 1/{rate}: MPEG-4 allows 1/65535 at most")
    return rate, base


class VideoWriter:
    """An MP4 file of ``frame_size`` = (width, height) BGR frames at
    ``fps``; the odd last column or row of the size is dropped."""

    def __init__(self, path: str, fps: float, frame_size: Tuple[int, int]):
        width, height = (int(v) for v in frame_size)
        num, den = time_base(fps)
        self._lib = load_video()
        err = ctypes.create_string_buffer(_ERR)
        self._handle = self._lib.video_open(os.fsencode(path), width, height, num, den,
                                            min(8, os.cpu_count() or 1), err, _ERR)
        if not self._handle:
            raise ValueError(err.value.decode())
        self.path = path
        self.frame_size = (width, height)

    def write(self, frame: np.ndarray) -> None:
        frame = np.ascontiguousarray(frame)
        if frame.dtype != np.uint8 or frame.ndim != 3 or frame.shape[2] != 3:
            raise ValueError(f"a frame is [h, w, 3] uint8 BGR, not {frame.dtype} "
                             f"{list(frame.shape)}")
        if self._handle is None:
            raise ValueError(f"{self.path} is released")
        h, w = frame.shape[:2]
        err = ctypes.create_string_buffer(_ERR)
        if self._lib.video_write(self._handle, frame, h, w, err, _ERR) != 0:
            raise ValueError(err.value.decode())

    def reconstruction(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The last frame as a decoder shows it: Y, U, V planes."""
        w, h = self.frame_size[0] & ~1, self.frame_size[1] & ~1
        planes = (np.zeros((h, w), np.uint8), np.zeros((h // 2, w // 2), np.uint8),
                  np.zeros((h // 2, w // 2), np.uint8))
        self._lib.video_recon(self._handle, *planes)
        return planes

    def release(self) -> None:
        """Write the index (``moov``) and close the file."""
        if self._handle is None:
            return
        handle, self._handle = self._handle, None
        err = ctypes.create_string_buffer(_ERR)
        if self._lib.video_close(handle, err, _ERR) != 0:
            raise OSError(err.value.decode())

    def __enter__(self) -> "VideoWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __del__(self):
        if getattr(self, "_handle", None) is not None:
            self.release()


# ---------------------------------------------------------------------------
# the encoder's numeric stages: native calls and their NumPy twins


def native_bgr_to_yuv420(bgr: np.ndarray):
    bgr = np.ascontiguousarray(bgr, np.uint8)
    h, w = bgr.shape[0] & ~1, bgr.shape[1] & ~1
    y = np.zeros((h, w), np.uint8)
    u = np.zeros((h // 2, w // 2), np.uint8)
    v = np.zeros((h // 2, w // 2), np.uint8)
    load_video().video_bgr_to_yuv420(bgr, bgr.shape[0], bgr.shape[1], y, u, v)
    return y, u, v


def native_forward_blocks(samples: np.ndarray, intra: bool, chroma: bool, q: int) -> np.ndarray:
    samples = np.ascontiguousarray(samples, np.int16).reshape(-1, 64)
    levels = np.zeros_like(samples)
    load_video().video_forward_blocks(samples, len(samples), int(intra), int(chroma), q, levels)
    return levels


def native_inverse_blocks(levels: np.ndarray, intra: bool, chroma: bool, q: int) -> np.ndarray:
    levels = np.ascontiguousarray(levels, np.int16).reshape(-1, 64)
    out = np.zeros(levels.shape, np.int32)
    load_video().video_inverse_blocks(levels, len(levels), int(intra), int(chroma), q, out)
    return out


def bgr_to_yuv420(bgr: np.ndarray):
    """BT.601 limited range: Y of each pixel, U and V of each 2x2 block's
    summed colour; an odd last row or column is dropped."""
    h, w = bgr.shape[0] & ~1, bgr.shape[1] & ~1
    p = bgr[:h, :w].astype(np.int32)
    b, g, r = p[..., 0], p[..., 1], p[..., 2]
    y = ((66 * r + 129 * g + 25 * b + 128) >> 8) + 16
    s = p.reshape(h // 2, 2, w // 2, 2, 3).sum(axis=(1, 3))
    bs, gs, rs = s[..., 0], s[..., 1], s[..., 2]
    u = ((-38 * rs - 74 * gs + 112 * bs + 512) >> 10) + 128
    v = ((112 * rs - 94 * gs - 18 * bs + 512) >> 10) + 128
    return y.astype(np.uint8), u.astype(np.uint8), v.astype(np.uint8)


def _fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """jfdctint.c on [n, 8, 8] samples (no level shift), rows then columns;
    the output is scaled up by 8."""
    d = blocks.astype(np.int64)

    def descale(x, n):
        return (x + (1 << (n - 1))) >> n

    for pas in range(2):
        v = d if pas == 0 else d.transpose(0, 2, 1)
        n = 15 if pas else 11
        p = [v[..., k] for k in range(8)]
        tmp0, tmp7 = p[0] + p[7], p[0] - p[7]
        tmp1, tmp6 = p[1] + p[6], p[1] - p[6]
        tmp2, tmp5 = p[2] + p[5], p[2] - p[5]
        tmp3, tmp4 = p[3] + p[4], p[3] - p[4]
        tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
        out = [None] * 8
        if pas:
            out[0], out[4] = descale(tmp10 + tmp11, 2), descale(tmp10 - tmp11, 2)
        else:
            out[0], out[4] = (tmp10 + tmp11) * 4, (tmp10 - tmp11) * 4
        z1 = (tmp12 + tmp13) * 4433
        out[2] = descale(z1 + tmp13 * 6270, n)
        out[6] = descale(z1 + tmp12 * -15137, n)
        z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
        z5 = (z3 + z4) * 9633
        tmp4, tmp5, tmp6, tmp7 = tmp4 * 2446, tmp5 * 16819, tmp6 * 25172, tmp7 * 12299
        z1, z2, z3, z4 = z1 * -7373, z2 * -20995, z3 * -16069 + z5, z4 * -3196 + z5
        out[7] = descale(tmp4 + z1 + z3, n)
        out[5] = descale(tmp5 + z2 + z4, n)
        out[3] = descale(tmp6 + z2 + z3, n)
        out[1] = descale(tmp7 + z1 + z4, n)
        v = np.stack(out, axis=-1)
        d = v if pas == 0 else v.transpose(0, 2, 1)
    return d


def _dc_scale(q: int, chroma: bool) -> int:
    if chroma:
        return 8 if q < 5 else (q + 13) // 2 if q < 25 else q - 6
    return 8 if q < 5 else 2 * q if q < 9 else q + 8 if q < 25 else 2 * q - 16


def forward_blocks(samples: np.ndarray, intra: bool, chroma: bool, q: int) -> np.ndarray:
    """[n, 64] samples -> levels in natural order: the islow FDCT, an intra
    DC rounded over 8 * dc_scaler, every other coefficient truncated over
    16 * q, an inter one less 4 * q first."""
    d = _fdct_islow(np.asarray(samples).reshape(-1, 8, 8)).reshape(-1, 64)
    a = np.abs(d)
    bias = 0 if intra else 4 * q
    level = np.minimum(np.where(a > bias, (a - bias) // (16 * q), 0), 2047)
    levels = np.where(d < 0, -level, level)
    if intra:
        s = 8 * _dc_scale(q, chroma)
        levels[:, 0] = (d[:, 0] + (s >> 1)) // s
    return levels.astype(np.int16)


_W = (0, 22725, 21407, 19266, 16383, 12873, 8867, 4520)


def _wrap32(x: np.ndarray) -> np.ndarray:
    """The IDCT's sums wrap as its unsigned 32-bit arithmetic does."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _simple_idct(c: np.ndarray) -> np.ndarray:
    """FFmpeg's 8-bit simple IDCT on [n, 64] int16 coefficients: the output
    of the column pass before idct_put's or idct_add's clip."""
    W1, W2, W3, W4, W5, W6, W7 = _W[1:]
    r = c.reshape(-1, 8, 8).astype(np.int64)
    a0 = W4 * r[..., 0] + (1 << 10)
    a1, a2, a3 = a0 + W6 * r[..., 2], a0 - W6 * r[..., 2], a0 - W2 * r[..., 2]
    a0 = a0 + W2 * r[..., 2]
    b0 = W1 * r[..., 1] + W3 * r[..., 3]
    b1 = W3 * r[..., 1] - W7 * r[..., 3]
    b2 = W5 * r[..., 1] - W1 * r[..., 3]
    b3 = W7 * r[..., 1] - W5 * r[..., 3]
    a0 = a0 + W4 * r[..., 4] + W6 * r[..., 6]
    a1 = a1 - W4 * r[..., 4] - W2 * r[..., 6]
    a2 = a2 - W4 * r[..., 4] + W2 * r[..., 6]
    a3 = a3 + W4 * r[..., 4] - W6 * r[..., 6]
    b0 = b0 + W5 * r[..., 5] + W7 * r[..., 7]
    b1 = b1 - W1 * r[..., 5] - W5 * r[..., 7]
    b2 = b2 + W7 * r[..., 5] + W3 * r[..., 7]
    b3 = b3 + W3 * r[..., 5] - W1 * r[..., 7]
    rows = _wrap32(np.stack([a0 + b0, a1 + b1, a2 + b2, a3 + b3, a3 - b3, a2 - b2, a1 - b1,
                             a0 - b0], axis=-1)) >> 11
    dc_only = ~r[..., 1:].any(axis=-1)  # the row shortcut: row[0] << 3 everywhere
    rows = np.where(dc_only[..., None], (r[..., :1] * 8), rows)
    rows = rows.astype(np.int16).astype(np.int64)  # the row pass stores int16
    col = rows.transpose(0, 2, 1)  # [n, column, row]
    a0 = W4 * (col[..., 0] + (1 << 19) // W4)
    a1, a2, a3 = a0 + W6 * col[..., 2], a0 - W6 * col[..., 2], a0 - W2 * col[..., 2]
    a0 = a0 + W2 * col[..., 2]
    b0 = W1 * col[..., 1] + W3 * col[..., 3]
    b1 = W3 * col[..., 1] - W7 * col[..., 3]
    b2 = W5 * col[..., 1] - W1 * col[..., 3]
    b3 = W7 * col[..., 1] - W5 * col[..., 3]
    a0 = a0 + W4 * col[..., 4] + W6 * col[..., 6]
    a1 = a1 - W4 * col[..., 4] - W2 * col[..., 6]
    a2 = a2 - W4 * col[..., 4] + W2 * col[..., 6]
    a3 = a3 + W4 * col[..., 4] - W6 * col[..., 6]
    b0 = b0 + W5 * col[..., 5] + W7 * col[..., 7]
    b1 = b1 - W1 * col[..., 5] - W5 * col[..., 7]
    b2 = b2 + W7 * col[..., 5] + W3 * col[..., 7]
    b3 = b3 + W3 * col[..., 5] - W1 * col[..., 7]
    out = _wrap32(np.stack([a0 + b0, a1 + b1, a2 + b2, a3 + b3, a3 - b3, a2 - b2, a1 - b1,
                            a0 - b0], axis=-1)) >> 20  # [n, column, row]
    return out.transpose(0, 2, 1).reshape(-1, 64).astype(np.int32)


def inverse_blocks(levels: np.ndarray, intra: bool, chroma: bool, q: int) -> np.ndarray:
    """[n, 64] levels in natural order -> the IDCT's output: H.263 inverse
    quantisation ((2|l| + 1) q, less 1 for an even q; an intra DC times
    dc_scaler; an inter coefficient clipped to [-2048, 2047]), then the
    simple IDCT."""
    lv = np.asarray(levels).reshape(-1, 64).astype(np.int64)
    qadd = (q - 1) | 1
    c = np.where(lv > 0, lv * 2 * q + qadd, np.where(lv < 0, lv * 2 * q - qadd, 0))
    if intra:
        c[:, 0] = lv[:, 0] * _dc_scale(q, chroma)
    else:
        c = np.clip(c, -2048, 2047)
    return _simple_idct(c.astype(np.int16))
