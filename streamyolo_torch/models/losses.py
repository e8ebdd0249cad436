"""StreamYOLO training losses (TAL and plain), fixed shape, the counterpart
of ``streamyolo_tpu/models/losses.py``.

  * TAL: SimOTA targets, IoU loss (1 - iou^2), BCE obj over all anchors, BCE
    cls over the foreground, optional L1 on the raw regression outputs, and
    the Trend-Aware re-weighting: per matched gt, weight =
    1 / (iou(cur_gt, support_gt)^gamma + 1e-8), with ``ignore_value`` in
    place of an IoU below ``ignore_thr`` (new or occluded objects), and
    normalised so that the weighted loss sum equals the unweighted one.
  * plain (PIPE head, the STILL config): the same without the weighting.

Everything is a function of (raw per-level head maps, padded labels), with
no host synchronisation. Under a process group of more than one rank the
four batch-wide normalizers (``num_fg``, ``num_gts`` and the two TAL weight
sums) are sums over the ranks, taken by one all-reduce of a packed vector
(no gradient flows through them), so each rank's loss terms are its share
of the global batch's; SimOTA stays per image. The maps are flattened and cast to float32 first,
so a caller that ran the model under ``torch.autocast`` computes the
assignment and the loss in float32, as the JAX package does.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from streamyolo_torch.models.assign import simota_assign_batch
from streamyolo_torch.models.heads import _device_grids, flatten_levels
from streamyolo_torch.ops.boxes import pairwise_iou
from streamyolo_torch.parallel.multihost import all_reduce_sum_, get_world_size

REG_WEIGHT = 5.0


def iou_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """yolox ``IOUloss(reduction='none', loss_type='iou')``: 1 - iou^2 of
    (cx, cy, w, h) boxes."""
    tl = torch.maximum(pred[..., :2] - pred[..., 2:] / 2, target[..., :2] - target[..., 2:] / 2)
    br = torch.minimum(pred[..., :2] + pred[..., 2:] / 2, target[..., :2] + target[..., 2:] / 2)
    area_p = torch.prod(pred[..., 2:], dim=-1)
    area_g = torch.prod(target[..., 2:], dim=-1)
    en = torch.all(tl < br, dim=-1)
    area_i = torch.prod(br - tl, dim=-1) * en
    iou = area_i / (area_p + area_g - area_i + 1e-16)
    return 1.0 - iou ** 2


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Stable BCE with logits, no reduction, written out as the JAX
    package's ``max(x, 0) - x * y + log1p(exp(-|x|))`` (``torch.maximum``
    splits the gradient at x = 0 as ``jnp.maximum`` does; a clamp would not)."""
    return (torch.maximum(logits, logits.new_zeros(())) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def _tal_weights(labels, support_labels, matched_gt, gamma: float, ignore_thr: float,
                 ignore_value: float) -> torch.Tensor:
    """Per-anchor trend weight [B, N]. ``iou_t[gt]`` is the largest IoU of the
    current gt with any support gt; below ``ignore_thr`` it becomes
    ``ignore_value``; an image whose support frame has no gt uses 1."""
    sup_valid = support_labels.sum(dim=2) > 0  # [B, M]
    sup_any = sup_valid.any(dim=1, keepdim=True)  # [B, 1]
    pair = pairwise_iou(labels[..., 1:5], support_labels[..., 1:5], xyxy=False)
    pair = pair * sup_valid[:, None, :]
    ious = pair.max(dim=2).values  # [B, M]
    ious = torch.where(ious < ignore_thr, torch.full_like(ious, ignore_value), ious)
    ious = torch.where(sup_any, ious, torch.ones_like(ious))
    iou_t = torch.gather(ious, 1, matched_gt)  # [B, N]
    return 1.0 / (iou_t ** gamma + 1e-8)


def _get_l1_target(reg_target, anchor_xy, anchor_strides, eps: float = 1e-8):
    """The gt in the raw-output space: ``xy / s - grid``, ``log(wh / s + eps)``."""
    s = anchor_strides[None, :, None]
    xy = reg_target[..., :2] / s - anchor_xy[None]
    wh = torch.log(reg_target[..., 2:] / s + eps)
    return torch.cat([xy, wh], dim=-1)


def _weight_sums(weight, loss, fg) -> torch.Tensor:
    """``[sum(L), sum(w * L)]`` over the batch's foreground, detached."""
    with torch.no_grad():
        return torch.stack([torch.sum(loss * fg), torch.sum(weight * loss * fg)])


def _normalized_weight(weight, sums):
    """``w * sum(L) / sum(w * L)`` from ``_weight_sums``, detached."""
    with torch.no_grad():
        loss_sum, wl_sum = sums
        ratio = torch.where(wl_sum > 0, loss_sum / torch.clamp(wl_sum, min=1e-20),
                            torch.ones_like(wl_sum))
        return weight * ratio


def _decode(outputs: Sequence[torch.Tensor], strides: Sequence[int]):
    """Flattened float32 maps [B, N, 5+C], the training decode of the boxes
    (cx, cy, w, h), and the anchors' grid indices and strides."""
    hw = tuple(tuple(int(d) for d in o.shape[-2:]) for o in outputs)
    anchor_xy, anchor_strides = _device_grids(hw, tuple(strides), outputs[0].device)
    flat = flatten_levels(outputs).float()
    s = anchor_strides[None, :, None]
    bbox_preds = torch.cat([(flat[..., :2] + anchor_xy[None]) * s,
                            torch.exp(flat[..., 2:4]) * s], dim=-1)
    return flat, bbox_preds, anchor_xy, anchor_strides


def assign_outputs(outputs: Sequence[torch.Tensor], labels: torch.Tensor, num_classes: int,
                   strides: Sequence[int] = (8, 16, 32)):
    """SimOTA of the raw per-level maps against ``labels``: the assignment
    ``streamyolo_losses`` makes (for a caller that checks it)."""
    flat, bbox_preds, anchor_xy, anchor_strides = _decode(
        [o.detach() for o in outputs], strides)
    return simota_assign_batch(labels[..., :5].float(), bbox_preds, flat[..., 4], flat[..., 5:],
                               anchor_xy, anchor_strides, num_classes)


def streamyolo_losses(
    outputs: Sequence[torch.Tensor],
    labels: torch.Tensor,
    support_labels: Optional[torch.Tensor],
    num_classes: int,
    strides: Sequence[int] = (8, 16, 32),
    gamma: float = 1.0,
    ignore_thr: float = 0.5,
    ignore_value: float = 1.5,
    use_l1: bool = True,
    use_tal: bool = True,
) -> Dict[str, torch.Tensor]:
    """The training loss from the raw per-level head maps.

    ``outputs``: per-level NCHW maps [B, 4+1+C, H, W] (reg, obj, cls), any
    float dtype; ``labels``: [B, M, 5] (cls, cx, cy, w, h) zero-padded, the
    next frame's gt; ``support_labels``: the current frame's gt (TAL), or
    None for the plain loss. Returns the reference's loss dict: total_loss,
    iou_loss, conf_loss, cls_loss, l1_loss, num_fg (0-d tensors). Under a
    process group of more than one rank the loss terms are this rank's
    shares (their sum over the ranks is the global batch's loss) and
    ``num_fg`` is the global ratio."""
    flat, bbox_preds, anchor_xy, anchor_strides = _decode(outputs, strides)
    labels = labels[..., :5].float()  # mixup's label_cut rule
    if support_labels is not None:
        support_labels = support_labels[..., :5].float()
    raw_reg = flat[..., :4]
    obj_logits = flat[..., 4]
    cls_logits = flat[..., 5:]

    assign = simota_assign_batch(labels, bbox_preds.detach(), obj_logits.detach(),
                                 cls_logits.detach(), anchor_xy, anchor_strides, num_classes)
    fg = assign.fg_mask.float()  # [B, N]
    counts = torch.stack([assign.num_fg.sum(), assign.num_gt.sum()])

    # per-anchor targets from the matched gts
    matched_labels = torch.gather(labels, 1, assign.matched_gt[..., None].expand(-1, -1, 5))
    reg_target = matched_labels[..., 1:5]
    cls_target = (F.one_hot(matched_labels[..., 0].long(), num_classes).float()
                  * assign.pred_iou[..., None])

    loss_iou_el = iou_loss(bbox_preds, reg_target)  # [B, N]
    loss_obj_el = bce_with_logits(obj_logits, fg)  # [B, N]
    loss_cls_el = torch.sum(bce_with_logits(cls_logits, cls_target), dim=-1)
    zero = flat.new_zeros(())

    if use_l1:
        l1_target = _get_l1_target(reg_target, anchor_xy, anchor_strides)
        loss_l1_el = torch.abs(raw_reg - l1_target)  # [B, N, 4]

    if use_tal:
        if support_labels is None:
            raise ValueError("the TAL loss needs support_labels")
        weight = _tal_weights(labels, support_labels, assign.matched_gt, gamma, ignore_thr,
                              ignore_value)
        sums = [counts, _weight_sums(weight, loss_iou_el, fg)]
        if use_l1:
            sums.append(_weight_sums(weight[..., None], loss_l1_el, fg[..., None]))
    else:
        sums = [counts]
    if get_world_size() > 1:  # the batch-wide sums over every rank's images
        sums = list(all_reduce_sum_(torch.cat(sums)).view(-1, 2))
    num_fg = torch.clamp(sums[0][0], min=1.0)
    num_gts = torch.clamp(sums[0][1], min=1.0)

    if use_tal:
        w_iou = _normalized_weight(weight, sums[1])
        loss_iou = torch.sum(w_iou * loss_iou_el * fg) / num_fg
        if use_l1:
            w_l1 = _normalized_weight(weight[..., None], sums[2])
            loss_l1 = torch.sum(w_l1 * loss_l1_el * fg[..., None]) / num_fg
        else:
            loss_l1 = zero
    else:
        loss_iou = torch.sum(loss_iou_el * fg) / num_fg
        loss_l1 = torch.sum(loss_l1_el * fg[..., None]) / num_fg if use_l1 else zero

    loss_obj = torch.sum(loss_obj_el) / num_fg
    loss_cls = torch.sum(loss_cls_el * fg) / num_fg

    total = REG_WEIGHT * loss_iou + loss_obj + loss_cls + loss_l1
    return {
        "total_loss": total,
        "iou_loss": REG_WEIGHT * loss_iou,
        "conf_loss": loss_obj,
        "cls_loss": loss_cls,
        "l1_loss": loss_l1,
        "num_fg": num_fg / num_gts,
    }
