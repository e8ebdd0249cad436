"""Box geometry, the counterpart of ``streamyolo_tpu/ops/boxes.py``:
``pairwise_iou`` (the yolox ``bboxes_iou`` that SimOTA and the Trend-Aware
Loss use), ``elementwise_iou``, ``xyxy2cxcywh``, ``xyxy2xywh``,
``cxcywh2xyxy`` and ``adjust_box_anns``.

The IoUs take tensors; the format converters take tensors or NumPy arrays
and return the same kind (the host transforms convert NumPy labels);
``adjust_box_anns`` is NumPy (the mosaic's mixup).
"""

from __future__ import annotations

import numpy as np
import torch


def pairwise_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor, xyxy: bool = True) -> torch.Tensor:
    """IoU of every pair of ``[..., Na, 4]`` and ``[..., Nb, 4]`` boxes ->
    ``[..., Na, Nb]`` (leading dimensions broadcast: a batch of images).

    ``xyxy=True``: corners; ``xyxy=False``: (cx, cy, w, h). Boxes that do
    not overlap (or are empty) give 0; the union is clamped at 1e-12."""
    a, b = boxes_a[..., :, None, :], boxes_b[..., None, :, :]
    if xyxy:
        tl = torch.maximum(a[..., :2], b[..., :2])
        br = torch.minimum(a[..., 2:4], b[..., 2:4])
        area_a = torch.prod(boxes_a[..., 2:4] - boxes_a[..., :2], dim=-1)
        area_b = torch.prod(boxes_b[..., 2:4] - boxes_b[..., :2], dim=-1)
    else:
        tl = torch.maximum(a[..., :2] - a[..., 2:4] / 2, b[..., :2] - b[..., 2:4] / 2)
        br = torch.minimum(a[..., :2] + a[..., 2:4] / 2, b[..., :2] + b[..., 2:4] / 2)
        area_a = torch.prod(boxes_a[..., 2:4], dim=-1)
        area_b = torch.prod(boxes_b[..., 2:4], dim=-1)
    valid = torch.all(tl < br, dim=-1)
    inter = torch.prod(br - tl, dim=-1) * valid
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-12)


def elementwise_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor,
                    xyxy: bool = True) -> torch.Tensor:
    """IoU of ``boxes_a[i]`` with ``boxes_b[i]``: ``[..., 4]`` and ``[..., 4]``
    -> ``[...]``, with ``pairwise_iou``'s conventions."""
    if xyxy:
        tl = torch.maximum(boxes_a[..., :2], boxes_b[..., :2])
        br = torch.minimum(boxes_a[..., 2:4], boxes_b[..., 2:4])
        area_a = torch.prod(boxes_a[..., 2:4] - boxes_a[..., :2], dim=-1)
        area_b = torch.prod(boxes_b[..., 2:4] - boxes_b[..., :2], dim=-1)
    else:
        tl = torch.maximum(boxes_a[..., :2] - boxes_a[..., 2:4] / 2,
                           boxes_b[..., :2] - boxes_b[..., 2:4] / 2)
        br = torch.minimum(boxes_a[..., :2] + boxes_a[..., 2:4] / 2,
                           boxes_b[..., :2] + boxes_b[..., 2:4] / 2)
        area_a = torch.prod(boxes_a[..., 2:4], dim=-1)
        area_b = torch.prod(boxes_b[..., 2:4], dim=-1)
    valid = torch.all(tl < br, dim=-1)
    inter = torch.prod(br - tl, dim=-1) * valid
    return inter / torch.clamp(area_a + area_b - inter, min=1e-12)


def _stack(arrs, like):
    return torch.stack(arrs, -1) if isinstance(like, torch.Tensor) else np.stack(arrs, -1)


def xyxy2cxcywh(boxes):
    """[x1, y1, x2, y2] -> [cx, cy, w, h] (a new array; yolox converts in place)."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return _stack([boxes[..., 0] + w * 0.5, boxes[..., 1] + h * 0.5, w, h], boxes)


def xyxy2xywh(boxes):
    """[x1, y1, x2, y2] -> [x1, y1, w, h] (COCO ltwh)."""
    return _stack([boxes[..., 0], boxes[..., 1], boxes[..., 2] - boxes[..., 0],
                   boxes[..., 3] - boxes[..., 1]], boxes)


def cxcywh2xyxy(boxes):
    """[cx, cy, w, h] -> [x1, y1, x2, y2]."""
    hw = boxes[..., 2] * 0.5
    hh = boxes[..., 3] * 0.5
    return _stack([boxes[..., 0] - hw, boxes[..., 1] - hh,
                   boxes[..., 0] + hw, boxes[..., 1] + hh], boxes)


def adjust_box_anns(bbox: np.ndarray, scale_ratio, padw, padh, w_max, h_max) -> np.ndarray:
    """Scale and shift [n, 4] xyxy boxes, clipped to a ``w_max x h_max``
    canvas (a new array; the yolox ``adjust_box_anns``)."""
    bbox = bbox.copy()
    bbox[:, 0::2] = np.clip(bbox[:, 0::2] * scale_ratio + padw, 0, w_max)
    bbox[:, 1::2] = np.clip(bbox[:, 1::2] * scale_ratio + padh, 0, h_max)
    return bbox
