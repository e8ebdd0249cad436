"""``cv2.putText``, ``cv2.getTextSize`` and ``cv2.rectangle`` without cv2,
bit for bit with cv2 5.0, for ``FONT_HERSHEY_SIMPLEX`` text and ``LINE_8``
boxes on uint8 images (BGR ``[H, W, 3]`` or gray ``[H, W]``), in place.

cv2 5.0 draws Hershey text with a TrueType renderer: ``FONT_HERSHEY_SIMPLEX``
at ``fontScale`` and ``thickness`` is its ``sans`` face (the Rubik variable
font, committed here as ``fonts/Rubik.ttf``) at ``cvRound(fontScale * 100 /
3.7)`` pixels and weight 400, or 600 for a thickness above 1; the text is
anti-aliased whatever the line type. The renderer is
``native/draw.cpp::draw_text``. A code point the font lacks raises
``ValueError`` naming it: cv2 would look it up in its other fonts, which the
repository does not hold.
"""

from __future__ import annotations

import ctypes
import functools
import numbers
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

from streamyolo_torch.native import load_draw

FONT_PATH = Path(__file__).resolve().parent / "fonts" / "Rubik.ttf"


@functools.lru_cache(maxsize=1)
def _font() -> bytes:
    return FONT_PATH.read_bytes()


def hershey_simplex_font(font_scale: float, thickness: int) -> Tuple[int, int]:
    """cv2 5.0's TrueType size (pixels) and weight for ``FONT_HERSHEY_SIMPLEX``
    at ``font_scale`` and ``thickness``."""
    size = int(np.rint(float(font_scale) * 100.0 / 3.7))
    return size, 400 if thickness <= 1 else 600


def _codes(text: str) -> np.ndarray:
    if not isinstance(text, str):
        raise TypeError(f"text must be a str, not {type(text).__name__}")
    return np.frombuffer(text.encode("utf-32-le"), np.int32).copy()


def _point(p, name: str) -> Tuple[int, int]:
    """cv2's Point: two int32 values."""
    if len(p) != 2 or not all(isinstance(v, numbers.Integral) for v in p):
        raise TypeError(f"{name} must be two integers, not {p!r}")
    if not all(-2**31 <= int(v) < 2**31 for v in p):
        raise ValueError(f"{name} {p!r} does not fit int32")
    return int(p[0]), int(p[1])


def _image(img: np.ndarray) -> Tuple[int, int, int]:
    if not isinstance(img, np.ndarray) or img.dtype != np.uint8:
        raise TypeError("the image must be a uint8 numpy array")
    if not img.flags.c_contiguous:
        raise ValueError("the image must be C-contiguous (it is drawn in place)")
    if img.ndim == 2:
        return img.shape[0], img.shape[1], 1
    if img.ndim == 3 and img.shape[2] in (1, 3):
        return img.shape[0], img.shape[1], img.shape[2]
    raise ValueError(f"the image must be [H, W] or [H, W, 1 or 3], not {img.shape}")


def _colour(color, channels: int) -> np.ndarray:
    """cv2's Scalar -> raw pixel: each value rounded and saturated, missing
    ones 0."""
    values = [color] if isinstance(color, numbers.Number) else list(color)
    if len(values) > 4:
        raise ValueError(f"a colour has at most 4 values, not {len(values)}")
    values = values + [0] * (4 - len(values))
    return np.array([min(max(int(np.rint(float(v))), 0), 255) for v in values[:max(channels, 1)]],
                    np.int32)


def _check(rc: int, err: ctypes.Array) -> None:
    if rc == -2:
        raise ValueError(err.value.decode())
    if rc != 0:
        raise RuntimeError(f"draw.cpp: {err.value.decode()}")


def put_text(img: np.ndarray, text: str, org: Sequence[int], font_scale: float,
             color, thickness: int = 1) -> np.ndarray:
    """``cv2.putText(img, text, org, cv2.FONT_HERSHEY_SIMPLEX, font_scale,
    color, thickness, lineType)`` (any line type: the text is anti-aliased),
    drawn into ``img``, which is returned. ``org`` is the first baseline's
    left end; a newline starts a line below."""
    h, w, channels = _image(img)
    x, y = _point(org, "org")
    size, weight = hershey_simplex_font(font_scale, thickness)
    if size < 0:
        raise ValueError(f"font_scale {font_scale}: mirrored text is not drawn")
    codes = _codes(text)
    if size == 0 or len(codes) == 0:
        return img
    font = _font()
    err = ctypes.create_string_buffer(256)
    rc = load_draw().draw_text(font, len(font), img.reshape(-1), h, w, channels, codes,
                               len(codes), x, y, size, weight, _colour(color, channels),
                               err, len(err))
    _check(rc, err)
    return img


def text_size(text: str, font_scale: float, thickness: int = 1) -> Tuple[Tuple[int, int], int]:
    """``cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX, font_scale,
    thickness)``: ((width, height), baseline)."""
    size, weight = hershey_simplex_font(font_scale, thickness)
    if size < 0:
        raise ValueError(f"font_scale {font_scale}: mirrored text is not measured")
    codes = _codes(text)
    font = _font()
    out = np.zeros(3, np.int64)
    err = ctypes.create_string_buffer(256)
    rc = load_draw().text_extent(font, len(font), codes, len(codes), size, weight, out, err,
                                 len(err))
    _check(rc, err)
    return (int(out[0]), int(out[1])), int(out[2])


def rectangle(img: np.ndarray, pt1: Sequence[int], pt2: Sequence[int], color,
              thickness: int = 1) -> np.ndarray:
    """``cv2.rectangle(img, pt1, pt2, color, thickness)`` with ``LINE_8``
    (a negative thickness fills), drawn into ``img``, which is returned."""
    h, w, channels = _image(img)
    x1, y1 = _point(pt1, "pt1")
    x2, y2 = _point(pt2, "pt2")
    if not isinstance(thickness, numbers.Integral) or thickness > 32767:
        raise ValueError(f"thickness must be an integer up to 32767, not {thickness!r}")
    load_draw().draw_rectangle(img.reshape(-1), h, w, channels, x1, y1, x2, y2,
                               _colour(color, channels), int(thickness))
    return img
