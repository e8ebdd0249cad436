"""SimOTA label assignment, fixed shape and batched, the counterpart of
``streamyolo_tpu/models/assign.py``.

Every image of the batch is assigned at once: ground truths are padded to
``max_labels`` and every dynamic quantity is a mask, so the assignment runs
on the device with no host synchronisation (no ``.item()``, no boolean
indexing to a data-dependent shape). It runs under ``torch.no_grad()`` in
float32, on inputs the caller has detached.

The semantics are the JAX package's, term by term:

  * candidate anchors: centre inside a gt box, or within 2.5 strides of the
    gt centre;
  * cost = BCE(sqrt(cls * obj), onehot) + 3 * (-log(iou + 1e-8))
    + 1e5 * (not in box and centre) + 1e9 * (not a candidate)
    + 1e9 * (padded gt), summed in that order;
  * dynamic k = max(int(sum of the 10 largest candidate IoUs), 1) per gt, and
    the k lowest-cost anchors matched per gt, both by peeling the extreme 10
    times with ``argmax`` (the first index wins ties, as ``jnp.argmax``);
  * an anchor matched by more than one gt keeps the argmin-cost gt over ALL
    gts (a reference quirk kept on purpose).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from streamyolo_torch.ops.boxes import pairwise_iou

CENTER_RADIUS = 2.5
BIG_COST = 1e9
PEEL_STEPS = 10


class Assignment(NamedTuple):
    """Per-anchor assignment of a batch, fixed shape [B, N] / [B]."""

    fg_mask: torch.Tensor  # [B, N] bool: the anchor is matched to some gt
    matched_gt: torch.Tensor  # [B, N] int64: index of the matched gt (0 if not fg)
    pred_iou: torch.Tensor  # [B, N] float32: IoU(pred, matched gt) (0 if not fg)
    num_fg: torch.Tensor  # [B] float32
    num_gt: torch.Tensor  # [B] float32


def _in_boxes_info(gt_boxes, gt_valid, anchor_xy, anchor_strides):
    """[B, M, N] in-box and in-centre masks; anchor centres are
    (grid + 0.5) * stride."""
    centers = (anchor_xy + 0.5) * anchor_strides[:, None]  # [N, 2]
    cx, cy = centers[None, None, :, 0], centers[None, None, :, 1]
    gcx, gcy = gt_boxes[..., 0:1], gt_boxes[..., 1:2]  # [B, M, 1]
    gw, gh = gt_boxes[..., 2:3], gt_boxes[..., 3:4]
    in_boxes = ((cx > gcx - 0.5 * gw) & (cx < gcx + 0.5 * gw)
                & (cy > gcy - 0.5 * gh) & (cy < gcy + 0.5 * gh))
    r = CENTER_RADIUS * anchor_strides[None, None, :]
    in_centers = (cx > gcx - r) & (cx < gcx + r) & (cy > gcy - r) & (cy < gcy + r)
    valid = gt_valid[..., None]
    return in_boxes & valid, in_centers & valid


def _bce_probs(p, y):
    """``F.binary_cross_entropy`` on probabilities, no reduction, with its
    -100 clamp of the logs."""
    log_p = torch.clamp(torch.log(p), min=-100.0)
    log_1mp = torch.clamp(torch.log1p(-p), min=-100.0)
    return -(y * log_p + (1.0 - y) * log_1mp)


def _peel_rows(x: torch.Tensor, fill: float):
    """One peel of every row's maximum: its index, its value, and ``x`` with
    it replaced by ``fill``."""
    i = torch.argmax(x, dim=-1, keepdim=True)
    return i, torch.gather(x, -1, i), x.scatter(-1, i, fill)


@torch.no_grad()
def simota_assign_batch(labels: torch.Tensor, bbox_preds: torch.Tensor,
                        obj_logits: torch.Tensor, cls_logits: torch.Tensor,
                        anchor_xy: torch.Tensor, anchor_strides: torch.Tensor,
                        num_classes: int) -> Assignment:
    """Fixed-shape SimOTA over a batch; every input float32.

    ``labels`` [B, M, 5] (cls, cx, cy, w, h), zero-padded; ``bbox_preds``
    [B, N, 4] decoded (cx, cy, w, h); ``obj_logits`` [B, N]; ``cls_logits``
    [B, N, C]; ``anchor_xy`` [N, 2] grid indices; ``anchor_strides`` [N]."""
    b, m = labels.shape[:2]
    n = bbox_preds.shape[1]
    gt_valid = labels.sum(dim=2) > 0  # the reference's nlabel rule
    gt_boxes = labels[..., 1:5]
    gt_cls = labels[..., 0].long()
    num_gt = gt_valid.float().sum(dim=1)

    in_boxes, in_centers = _in_boxes_info(gt_boxes, gt_valid, anchor_xy, anchor_strides)
    fg_cand = torch.any(in_boxes | in_centers, dim=1)  # [B, N]
    in_boxes_and_center = in_boxes & in_centers  # [B, M, N]

    # IoU over candidates only: non-candidates never enter the reference's
    # matrices, emulated with a hard zero here and a big cost below
    pair_iou = pairwise_iou(gt_boxes, bbox_preds, xyxy=False)  # [B, M, N]
    pair_iou = pair_iou * (gt_valid[:, :, None] & fg_cand[:, None, :])

    # sum over classes of BCE(sqrt(cls * obj), onehot), through the two BCE
    # branches so that no [B, M, N, C] tensor is made
    p = torch.sqrt(torch.sigmoid(cls_logits) * torch.sigmoid(obj_logits)[..., None])
    onehot = F.one_hot(gt_cls, num_classes).float()  # [B, M, C]
    log_p = torch.clamp(torch.log(p), min=-100.0)
    log_1mp = torch.clamp(torch.log1p(-p), min=-100.0)
    pair_cls_loss = -(onehot @ log_p.transpose(1, 2) + (1.0 - onehot) @ log_1mp.transpose(1, 2))

    pair_iou_loss = -torch.log(pair_iou + 1e-8)
    cost = (pair_cls_loss
            + 3.0 * pair_iou_loss
            + 100000.0 * (~in_boxes_and_center)
            + BIG_COST * (~fg_cand)[:, None, :]
            + BIG_COST * (~gt_valid)[:, :, None])

    # dynamic k from the sum of each gt's 10 largest IoUs (padded zeros add
    # nothing: the reference's min(10, candidates) truncation)
    steps = min(PEEL_STEPS, n)
    x = pair_iou
    iou_sum10 = torch.zeros((b, m, 1), dtype=torch.float32, device=labels.device)
    for _ in range(steps):
        _, top, x = _peel_rows(x, -1.0)
        iou_sum10 = iou_sum10 + top
    dynamic_ks = torch.clamp(iou_sum10.int(), min=1)  # [B, M, 1]

    # the dynamic_ks lowest-cost anchors of each gt, peeled in order
    neg_cost = -cost
    matching = torch.zeros((b, m, n), dtype=torch.bool, device=labels.device)
    for j in range(steps):
        i, _, neg_cost = _peel_rows(neg_cost, float("-inf"))
        chosen = torch.gather(matching, -1, i) | (j < dynamic_ks)
        matching = matching.scatter(-1, i, chosen)
    matching = matching & gt_valid[:, :, None] & fg_cand[:, None, :]

    # anchors matched by more than one gt: the argmin-cost gt over all gts
    conflicted = matching.int().sum(dim=1) > 1  # [B, N]
    argmin_gt = torch.argmin(cost, dim=1)  # [B, N]
    argmin_onehot = F.one_hot(argmin_gt, m).transpose(1, 2).bool()  # [B, M, N]
    matching = torch.where(conflicted[:, None, :], argmin_onehot, matching)

    fg_mask = torch.any(matching, dim=1)
    matched_gt = torch.argmax(matching.to(torch.uint8), dim=1)
    pred_iou = (matching * pair_iou).sum(dim=1)
    return Assignment(fg_mask, matched_gt, pred_iou, fg_mask.float().sum(dim=1), num_gt)
