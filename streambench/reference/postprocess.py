"""The serving point's postprocess in plain PyTorch: confidence filter,
top-K candidates in score order, class-aware greedy NMS -> [B, K, 8] rows
(x1, y1, x2, y2, obj, cls_conf, cls, keep), the contract of YOLOX's
``postprocess`` at a fixed K.

Candidates are ordered by descending masked score (score = obj x the best
class's probability, -1 below the confidence), ties by anchor index. NMS
is the greedy sweep: a candidate is kept when it is valid and no kept
candidate before it overlaps it by IoU > ``nms_thre`` (torchvision's area
convention, the union clamped at 1e-12); boxes of different classes are
kept apart by an offset of 8192 per class index."""

from __future__ import annotations

import numpy as np
import torch

CLASS_OFFSET = 8192.0


def candidates(pred: torch.Tensor, num_classes: int, conf_thre: float, k: int):
    """[B, N, 5 + C] -> (rows [B, K, 7] (x1, y1, x2, y2, obj, cls_conf, cls)
    in candidate order, valid [B, K])."""
    pred = pred.float()
    half = pred[..., 2:4] * 0.5
    corners = torch.cat([pred[..., :2] - half, pred[..., :2] + half], dim=-1)
    obj = pred[..., 4]
    cls_conf, cls = pred[..., 5:5 + num_classes].max(dim=-1)
    scores = obj * cls_conf
    masked = torch.where(scores >= float(np.float32(conf_thre)), scores,
                         torch.full_like(scores, -1.0))
    k = min(k, pred.shape[1])
    order = torch.sort(-masked, dim=-1, stable=True).indices[:, :k]
    payload = torch.cat([corners, obj[..., None], cls_conf[..., None],
                         cls.to(torch.float32)[..., None]], dim=-1)
    rows = payload.gather(1, order[..., None].expand(-1, -1, payload.shape[-1]))
    return rows, masked.gather(1, order) > 0.0


def iou_over(boxes: torch.Tensor, nms_thre: float) -> torch.Tensor:
    """[B, K, 4] corners -> [B, K, K] bool: IoU(i, j) > ``nms_thre`` in
    float32."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    tlx = torch.maximum(x1[..., :, None], x1[..., None, :])
    tly = torch.maximum(y1[..., :, None], y1[..., None, :])
    brx = torch.minimum(x2[..., :, None], x2[..., None, :])
    bry = torch.minimum(y2[..., :, None], y2[..., None, :])
    inter = (brx - tlx).clamp(min=0.0) * (bry - tly).clamp(min=0.0)
    area = (x2 - x1).clamp(min=0.0) * (y2 - y1).clamp(min=0.0)
    union = (area[..., :, None] + area[..., None, :]) - inter
    return inter / union.clamp(min=1e-12) > float(np.float32(nms_thre))


def greedy_keep(rows: torch.Tensor, valid: torch.Tensor, nms_thre: float) -> torch.Tensor:
    """The greedy NMS keep mask of [B, K, >= 7] candidate rows in order."""
    boxes = rows[..., :4] + rows[..., 6:7] * CLASS_OFFSET
    over = iou_over(boxes, nms_thre)
    k = rows.shape[1]
    later = torch.arange(k, device=rows.device)
    keep = valid.clone()
    for i in range(k):
        keep &= ~(keep[:, i:i + 1] & over[:, i, :] & (later > i))
    return keep


def detections(pred: torch.Tensor, num_classes: int, conf_thre: float, nms_thre: float,
               k: int) -> torch.Tensor:
    """[B, N, 5 + C] decoded predictions -> [B, K, 8] rows."""
    rows, valid = candidates(pred, num_classes, conf_thre, k)
    keep = greedy_keep(rows, valid, nms_thre)
    return torch.cat([rows, keep[..., None].to(torch.float32)], dim=-1)
