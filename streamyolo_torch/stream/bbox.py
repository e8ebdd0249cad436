"""Box format conversions, in-place and copying variants: the port's own
copy of ``streamyolo_tpu/stream/bbox.py``.

ltwh / ltrb / cxywh conversions plus the sqrt-area helper. In-place
variants end with ``_``; copying variants allocate float64.
"""

from __future__ import annotations

import numpy as np


def _as2d(b):
    b = np.asarray(b)
    return b[None] if b.ndim == 1 else b


def ltwh2ltrb_(bboxes: np.ndarray) -> np.ndarray:
    b = _as2d(bboxes)
    b[:, 2:] += b[:, :2]
    return bboxes


def ltwh2ltrb(bboxes) -> np.ndarray:
    return ltwh2ltrb_(_as2d(bboxes).astype(np.float64, copy=True))


def ltrb2ltwh_(bboxes: np.ndarray) -> np.ndarray:
    b = _as2d(bboxes)
    b[:, 2:] -= b[:, :2]
    return bboxes


def ltrb2ltwh(bboxes) -> np.ndarray:
    return ltrb2ltwh_(_as2d(bboxes).astype(np.float64, copy=True))


def ltwh2cxywh_(bboxes: np.ndarray) -> np.ndarray:
    b = _as2d(bboxes)
    b[:, :2] += b[:, 2:] / 2
    return bboxes


def ltwh2cxywh(bboxes) -> np.ndarray:
    return ltwh2cxywh_(_as2d(bboxes).astype(np.float64, copy=True))


def cxywh2ltwh_(bboxes: np.ndarray) -> np.ndarray:
    b = _as2d(bboxes)
    b[:, :2] -= b[:, 2:] / 2
    return bboxes


def cxywh2ltwh(bboxes) -> np.ndarray:
    return cxywh2ltwh_(_as2d(bboxes).astype(np.float64, copy=True))


def cxywh2ltrb(bboxes) -> np.ndarray:
    return ltwh2ltrb_(cxywh2ltwh(bboxes))


def ltrb2cxywh(bboxes) -> np.ndarray:
    return ltwh2cxywh_(ltrb2ltwh(bboxes))


def bbox_sqrt_area(bboxes_ltwh) -> np.ndarray:
    b = _as2d(bboxes_ltwh)
    return np.sqrt(b[:, 2] * b[:, 3])
