"""Host-side transforms, the counterparts of
``streamyolo_tpu/data/transforms.py``: the letterbox ``preproc``, the HSV
jitter ``augment_hsv``, the mosaic's ``random_perspective`` (with
``box_candidates`` / ``warp_keep_mask``), the train transforms (HSV jitter,
flag-driven mirror, letterbox, cxcywh labels padded to ``max_labels``) and
the val transforms.

The card's machine has no cv2, so every pixel operation here is the port's
counterpart of the cv2 call the JAX package makes (``data/cv2_ops.py``:
NumPy, the resize native), equal to it bit for bit: the resize, the warps and
the colour conversions. cv2 is never imported, even where it is installed.

Random draws keep the JAX package's order, Python's ``random`` and NumPy's
global generator alike: ``DoubleTrainTransform`` mirrors both frames of a
pair with ONE coin flip (``random.randrange(2)``), ``augment_hsv`` draws
its three gains from ``np.random``, and ``random_perspective`` draws its
warp from ``random`` so that the mosaic can replay it on the support frame.
"""

from __future__ import annotations

import math
import random
from typing import Sequence, Tuple

import numpy as np

from streamyolo_torch.data.cv2_ops import (
    bgr2hsv_u8,
    hsv2bgr_u8,
    resize_u8,
    warp_affine_u8,
    warp_perspective_u8,
)
from streamyolo_torch.ops.boxes import xyxy2cxcywh

def augment_hsv(img: np.ndarray, hgain=0.015, sgain=0.7, vgain=0.4) -> None:
    """In-place HSV gain jitter of a BGR uint8 image: one gain per channel,
    uniform in ``1 +/- gain`` from ``np.random``; the hue is scaled modulo
    cv2's 0..179 range, saturation and value are clipped at 255."""
    gains = 1.0 + np.random.uniform(-1.0, 1.0, 3) * (hgain, sgain, vgain)
    hsv = bgr2hsv_u8(img).astype(np.float64)
    hsv[..., 0] = (np.floor(hsv[..., 0]) * gains[0]) % 180
    hsv[..., 1:] = np.clip(hsv[..., 1:] * gains[1:], 0, 255)
    img[...] = hsv2bgr_u8(hsv.astype(img.dtype))


def warp_keep_mask(before: np.ndarray, after: np.ndarray, min_side: float = 2.0,
                   max_aspect: float = 20.0, min_area_frac: float = 0.2) -> np.ndarray:
    """Which of the (n, 4) xyxy boxes survive a warp: ``before`` (already at
    the warp's scale) and ``after``. A box survives if both warped sides
    exceed ``min_side`` px, it keeps more than ``min_area_frac`` of its
    area, and its aspect ratio stays under ``max_aspect``."""
    eps = 1e-16
    bw, bh = (before[:, 2] - before[:, 0]), (before[:, 3] - before[:, 1])
    aw, ah = (after[:, 2] - after[:, 0]), (after[:, 3] - after[:, 1])
    aspect = np.maximum(aw / (ah + eps), ah / (aw + eps))
    keep = (aw > min_side) & (ah > min_side)
    keep &= aw * ah > min_area_frac * (bw * bh + eps)
    keep &= aspect < max_aspect
    return keep


def box_candidates(box1, box2, wh_thr=2, ar_thr=20, area_thr=0.2):
    """The yolox ``box_candidates`` surface: (4, n) corner-stacked boxes
    before and after, through ``warp_keep_mask``."""
    return warp_keep_mask(np.asarray(box1).T, np.asarray(box2).T, min_side=wh_thr,
                          max_aspect=ar_thr, min_area_frac=area_thr)


def _sample_warp_matrix(size_hw: Tuple[int, int], out_hw: Tuple[int, int], degrees: float,
                        translate: float, scale: Tuple[float, float],
                        shear: float) -> Tuple[np.ndarray, float]:
    """One random rotate / scale / shear / translate warp as a 3x3 matrix
    and its zoom. Right to left: recentre the source on its middle, rotate
    by a uniform angle while scaling, shear each axis, then put the origin
    at a jittered point of the output. Six draws from ``random`` in a fixed
    order, so that a caller can replay the warp by restoring the state."""
    angle = math.radians(random.uniform(-degrees, degrees))
    zoom = random.uniform(scale[0], scale[1])
    shear_x = math.tan(math.radians(random.uniform(-shear, shear)))
    shear_y = math.tan(math.radians(random.uniform(-shear, shear)))
    tx = random.uniform(0.5 - translate, 0.5 + translate) * out_hw[1]
    ty = random.uniform(0.5 - translate, 0.5 + translate) * out_hw[0]

    recenter = np.array([[1, 0, -size_hw[1] / 2], [0, 1, -size_hw[0] / 2], [0, 0, 1]],
                        np.float64)
    cos_a, sin_a = zoom * math.cos(angle), zoom * math.sin(angle)
    # y grows downward: a positive angle turns counter-clockwise on screen
    rot = np.array([[cos_a, sin_a, 0], [-sin_a, cos_a, 0], [0, 0, 1]], np.float64)
    sh = np.array([[1, shear_x, 0], [shear_y, 1, 0], [0, 0, 1]], np.float64)
    shift = np.array([[1, 0, tx], [0, 1, ty], [0, 0, 1]], np.float64)
    return shift @ sh @ rot @ recenter, zoom


def _warp_boxes(boxes: np.ndarray, matrix: np.ndarray, out_hw: Tuple[int, int],
                perspective: float) -> np.ndarray:
    """(n, 4) xyxy boxes through the warp: the four corners mapped, their
    axis-aligned hull, clipped to the output."""
    x1, y1, x2, y2 = boxes.T
    corners = np.stack([np.stack([x1, y1], -1), np.stack([x2, y2], -1),
                        np.stack([x1, y2], -1), np.stack([x2, y1], -1)], axis=1)
    warped = corners @ matrix[:2, :2].T + matrix[:2, 2]
    if perspective:
        w = corners @ matrix[2, :2].T + matrix[2, 2]
        warped = warped / w[..., None]
    lo, hi = warped.min(axis=1), warped.max(axis=1)
    out = np.stack([lo[:, 0], lo[:, 1], hi[:, 0], hi[:, 1]], axis=-1)
    out[:, 0::2] = out[:, 0::2].clip(0, out_hw[1])
    out[:, 1::2] = out[:, 1::2].clip(0, out_hw[0])
    return out


def random_perspective(img: np.ndarray, targets=(), degrees=10, translate=0.1,
                       scale=(0.5, 1.5), shear=10, perspective=0.0, border=(0, 0)):
    """A random affine (or, with ``perspective``, perspective) warp of an
    image and its [xyxy, cls] targets onto a grey-114 canvas grown by
    ``2 * border`` (negative: the mosaic's crop back to the input size).
    Boxes that degenerate under the warp are dropped (``warp_keep_mask``)."""
    out_hw = (img.shape[0] + 2 * border[0], img.shape[1] + 2 * border[1])
    matrix, zoom = _sample_warp_matrix(img.shape[:2], out_hw, degrees, translate, scale, shear)

    if border != (0, 0) or not np.array_equal(matrix, np.eye(3)):
        if perspective:
            img = warp_perspective_u8(img, matrix, out_hw, border=114)
        else:
            img = warp_affine_u8(img, matrix[:2], out_hw, border=114)

    if len(targets):
        warped = _warp_boxes(targets[:, :4], matrix, out_hw, perspective)
        keep = warp_keep_mask(targets[:, :4] * zoom, warped)
        targets = targets[keep]
        targets[:, :4] = warped[keep]
    return img, targets


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
    """One frame: HSV jitter (``hsv``), flag-driven mirror, letterbox,
    xyxy -> cxcywh (scaled by the letterbox ratio), boxes with a side <= 1 px
    dropped, labels ``(cls, cx, cy, w, h)`` zero-padded to ``max_labels``.
    If every box degenerates, the un-augmented image and boxes are used
    instead. The caller's image is not modified."""

    def __init__(self, max_labels: int = 50, hsv: bool = True, flip: bool = True):
        self.max_labels = max_labels
        self.hsv = hsv
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
        if self.hsv:
            image_t = image.copy()
            augment_hsv(image_t)
        if self.flip:
            image_t, boxes = _mirror(image_t, boxes, mirror=mirror)
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
