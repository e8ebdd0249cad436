"""Eval-side transforms: the letterbox ``preproc`` and the val transforms,
the counterparts of ``streamyolo_tpu/data/transforms.py``.

The card's machine has no cv2, so the resize is the port's own NumPy
``INTER_LINEAR`` (``data/dbcode.py::resize_linear_u8``, cv2's fixed-point
arithmetic) on every host. At the 0.5 ratio of every shipped config on
1200x1920 Argoverse-HD it equals cv2 bit for bit (there cv2 takes its
2x2-average path, and the fixed-point taps are 1/2, 1/2); elsewhere it is
within one grey level. The train-side transforms come with the training
slice.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from streamyolo_torch.data.dbcode import resize_linear_u8


def resize_u8(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """``cv2.resize(img, (out_w, out_h), INTER_LINEAR)`` for an [H, W, 3]
    uint8 image; the same size returns the image itself (cv2 copies)."""
    if img.shape[:2] == (out_h, out_w):
        return img
    return resize_linear_u8(img, out_h, out_w)


def preproc(img: np.ndarray, input_size: Sequence[int]) -> Tuple[np.ndarray, float]:
    """Letterbox onto a 114-grey (input_h, input_w) canvas, anchored top-left,
    the resized extent truncated to ``int(dim * r)``. Returns the uint8 HWC
    canvas (the model casts on the device) and the ratio r."""
    padded_img = np.full((input_size[0], input_size[1], 3), 114, np.uint8)
    r = min(input_size[0] / img.shape[0], input_size[1] / img.shape[1])
    h, w = int(img.shape[0] * r), int(img.shape[1] * r)
    padded_img[:h, :w] = resize_u8(img, h, w)
    return padded_img, r


class ValTransform:
    """Letterbox only; labels replaced by a single zero row."""

    def __call__(self, img, res, input_size):
        img, _ = preproc(img, input_size)
        return img, np.zeros((1, 5), dtype=np.float32)


class DoubleValTransform:
    """``ValTransform`` on the current and the support frame."""

    def __init__(self):
        self.transform1 = ValTransform()
        self.transform2 = ValTransform()

    def __call__(self, img, res, input_size):
        img1, label1 = self.transform1(img[0], res[0], input_size)
        img2, label2 = self.transform2(img[1], res[1], input_size)
        return img1, img2, label1, label2
