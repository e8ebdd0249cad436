"""Host-side transforms: the letterbox ``preproc``, the train transforms
(flag-driven mirror, letterbox, cxcywh labels padded to ``max_labels``)
and the val transforms, the counterparts of
``streamyolo_tpu/data/transforms.py``.

The card's machine has no cv2, so the resize is the port's own NumPy
``INTER_LINEAR`` (``data/dbcode.py::resize_linear_u8``, cv2's fixed-point
arithmetic) on every host. At the 0.5 ratio of every shipped config on
1200x1920 Argoverse-HD it equals cv2 bit for bit (there cv2 takes its
2x2-average path, and the fixed-point taps are 1/2, 1/2); elsewhere it is
within one grey level.

``DoubleTrainTransform`` mirrors both frames of a pair with ONE coin flip
from Python's ``random`` (the temporal pair stays consistent). The HSV
jitter (``augment_hsv``, cv2's colour conversions) is not ported yet:
``hsv=True`` raises (the shipped configs set ``hsv=False``).
"""

from __future__ import annotations

import random
from typing import Sequence, Tuple

import numpy as np

from streamyolo_torch.data.dbcode import resize_linear_u8
from streamyolo_torch.ops.boxes import xyxy2cxcywh

HSV_MESSAGE = ("hsv=True needs augment_hsv (cv2 colour conversions), which is not ported "
               "yet (ROADMAP queue A item 12, the augmentation path without cv2)")


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


def _mirror(image: np.ndarray, boxes: np.ndarray, mirror: bool = False):
    """Horizontal flip of an HWC image and its xyxy boxes, gated by a flag so
    both frames of a pair share one coin flip."""
    width = image.shape[1]
    if mirror:
        image = image[:, ::-1]
        boxes = boxes.copy()
        boxes[:, 0::2] = width - boxes[:, 2::-2]
    return image, boxes


class TrainTransform:
    """One frame: flag-driven mirror, letterbox, xyxy -> cxcywh (scaled by
    the letterbox ratio), boxes with a side <= 1 px dropped, labels
    ``(cls, cx, cy, w, h)`` zero-padded to ``max_labels``. If every box
    degenerates, the un-augmented image and boxes are used instead."""

    def __init__(self, max_labels: int = 50, hsv: bool = True, flip: bool = True):
        if hsv:
            raise NotImplementedError(HSV_MESSAGE)
        self.max_labels = max_labels
        self.flip = flip

    def __call__(self, image, targets, input_dim, mirror: bool = False):
        boxes = targets[:, :4].copy()
        labels = targets[:, 4].copy()
        if len(boxes) == 0:
            image, _ = preproc(image, input_dim)
            return image, np.zeros((self.max_labels, 5), dtype=np.float32)

        image_o = image
        boxes_o = xyxy2cxcywh(targets[:, :4].copy())
        labels_o = targets[:, 4].copy()

        image_t = image
        if self.flip:
            image_t, boxes = _mirror(image, boxes, mirror=mirror)
        image_t, r_ = preproc(image_t, input_dim)
        boxes = xyxy2cxcywh(boxes)
        boxes *= r_

        mask_b = np.minimum(boxes[:, 2], boxes[:, 3]) > 1
        boxes_t = boxes[mask_b]
        labels_t = labels[mask_b]
        if len(boxes_t) == 0:
            image_t, r_o = preproc(image_o, input_dim)
            boxes_t = boxes_o * r_o
            labels_t = labels_o

        targets_t = np.hstack((np.expand_dims(labels_t, 1), boxes_t))
        padded = np.zeros((self.max_labels, 5), dtype=np.float32)
        padded[: min(len(targets_t), self.max_labels)] = targets_t[: self.max_labels]
        return image_t, np.ascontiguousarray(padded, dtype=np.float32)


class DoubleTrainTransform:
    """Both frames of a pair through ``TrainTransform`` with ONE coin flip
    (``random.randrange(2)``) as the mirror of both."""

    def __init__(self, max_labels: int = 50, hsv: bool = True, flip: bool = True):
        self.transform1 = TrainTransform(max_labels=max_labels, hsv=hsv, flip=flip)
        self.transform2 = TrainTransform(max_labels=max_labels, hsv=hsv, flip=flip)

    def __call__(self, image, targets, input_dim):
        a = bool(random.randrange(2))
        img1, label1 = self.transform1(image[0], targets[0], input_dim, mirror=a)
        img2, label2 = self.transform2(image[1], targets[1], input_dim, mirror=a)
        return img1, img2, label1, label2


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
