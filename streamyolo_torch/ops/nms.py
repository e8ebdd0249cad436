"""Fixed-shape batched postprocess: confidence filter, payload-carrying
top-k, class-aware greedy NMS -> [B, K, 8] rows.

Counterpart of ``streamyolo_tpu/ops/nms.py``. Rows are
``(x1, y1, x2, y2, obj, cls_conf, cls, keep)``, ``K = min(pre_nms_topk, N)``.
Candidates are ordered by the key ``(-masked_score, index)``: a STABLE sort
of ``-masked`` (``torch.topk`` promises no tie order). Class awareness uses
the coordinate-offset trick (offset 8192). The keep mask comes from
``nms_cuda.nms_keep``: kernel B1 on a CUDA tensor, the plain fixed point
on a CPU tensor.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from streamyolo_torch.ops.nms_cuda import nms_keep, nms_padded, nms_padded_sequential

# Bigger than any image dimension the models run (multiscale max 1120 px).
CLASS_OFFSET = 8192.0

__all__ = [
    "CLASS_OFFSET", "candidate_counts", "nms_keep", "nms_padded",
    "nms_padded_sequential", "postprocess", "postprocess_fixed",
    "select_candidates", "warn_if_saturated",
]


def select_candidates(
    prediction: torch.Tensor,
    num_classes: int,
    conf_thre: float,
    pre_nms_topk: int,
    class_agnostic: bool = False,
):
    """The pre-NMS half of ``postprocess_fixed``: [B, N, 5+C] ->
    (top [B, K, 7] rows (x1, y1, x2, y2, obj, cls_conf, cls) in candidate
    order, nms_boxes [B, K, 4] class-offset boxes, valid [B, K])."""
    pred = prediction.float()
    half_wh = pred[..., 2:4] * 0.5
    corners = torch.cat([pred[..., :2] - half_wh, pred[..., :2] + half_wh], dim=-1)
    obj = pred[..., 4]
    cls_conf, cls_idx = pred[..., 5:5 + num_classes].max(dim=-1)  # first max
    cls_pred = cls_idx.to(pred.dtype)
    scores = obj * cls_conf
    conf = float(np.float32(conf_thre))
    masked = torch.where(scores >= conf, scores, torch.full_like(scores, -1.0))

    k = min(pre_nms_topk, pred.shape[1])
    order = torch.sort(-masked, dim=-1, stable=True).indices[:, :k]
    top_scores = masked.gather(1, order)
    payload = torch.cat(
        [corners, obj[..., None], cls_conf[..., None], cls_pred[..., None]], dim=-1)
    top = payload.gather(1, order[..., None].expand(-1, -1, payload.shape[-1]))
    valid = top_scores > 0.0

    nms_boxes = top[..., :4]
    if not class_agnostic:
        nms_boxes = nms_boxes + top[..., 6:7] * CLASS_OFFSET
    return top, nms_boxes.contiguous(), valid.contiguous()


def postprocess_fixed(
    prediction: torch.Tensor,
    num_classes: int,
    conf_thre: float = 0.7,
    nms_thre: float = 0.45,
    pre_nms_topk: int = 1000,
    class_agnostic: bool = False,
) -> torch.Tensor:
    """[B, N, 5+C] decoded predictions (cx, cy, w, h, obj, cls...) ->
    [B, K, 8] float32 rows, on the prediction's device."""
    top, nms_boxes, valid = select_candidates(
        prediction, num_classes, conf_thre, pre_nms_topk, class_agnostic)
    keep = nms_keep(nms_boxes, valid, nms_thre)
    return torch.cat([top, keep[..., None].to(top.dtype)], dim=-1)


def candidate_counts(rows: np.ndarray, conf_thre: float) -> np.ndarray:
    """Per-image count of [..., K, 8] slots holding above-confidence
    candidates; a count equal to K means the pre-NMS top-k saturated."""
    scores = rows[..., 4] * rows[..., 5]
    return (scores >= conf_thre).sum(axis=-1)


def warn_if_saturated(rows: np.ndarray, conf_thre: float,
                      n_anchors: Optional[int] = None) -> int:
    """Log a warning when any image's candidate selection saturated; returns
    the number of saturated images. With ``k >= n_anchors`` nothing can have
    been dropped."""
    k = rows.shape[-2]
    if n_anchors is not None and k >= n_anchors:
        return 0
    n_sat = int((candidate_counts(rows, conf_thre) >= k).sum())
    if n_sat:
        from streamyolo_torch.utils.logger import get_logger

        get_logger().warning(
            "pre-NMS candidate selection saturated on %d image(s): >= %d "
            "candidates above conf %.4g — lowest-scored candidates were "
            "dropped before NMS; raise pre_nms_topk if post-NMS rows matter "
            "at this density",
            n_sat, k, conf_thre,
        )
    return n_sat


def postprocess(
    prediction,
    num_classes: int,
    conf_thre: float = 0.7,
    nms_thre: float = 0.45,
    pre_nms_topk: int = 1000,
    class_agnostic: bool = False,
) -> List[Optional[np.ndarray]]:
    """Per-image list of [n_i, 7] NumPy arrays (x1,y1,x2,y2,obj,cls_conf,cls)
    or None, the contract of ``yolox.utils.postprocess``. A NumPy input runs
    on the CPU; a tensor runs where it lies."""
    pred = torch.as_tensor(prediction)
    fixed = postprocess_fixed(pred, num_classes, conf_thre, nms_thre,
                              pre_nms_topk, class_agnostic).cpu().numpy()
    warn_if_saturated(fixed, conf_thre, n_anchors=pred.shape[1])
    outputs: List[Optional[np.ndarray]] = []
    for row in fixed:
        kept = row[row[:, 7] > 0.5][:, :7]
        outputs.append(kept if len(kept) else None)
    return outputs
