"""The numbers that decide ``correct``: served rows against the reference.

For each judged image the program served [K, 8] rows (x1, y1, x2, y2, obj,
cls_conf, cls, keep) and the reference computed the decoded predictions
[N, 5 + C] of every anchor from the same weights and frames. Four numbers,
each the worst over the judged blocks of images (the last three are
counts, exact, with the limit 0):

* ``row_gap``: how far the farthest served row lies from every reference
  prediction: for a row, the least over anchors of the largest of the
  centre's gap in the anchor's raw offset (cx / stride - grid) over the
  larger of 1 and the reference's offset, |d w| and |d h| over the larger
  of the reference's size and the stride, |d obj| and |d p(cls)|, where
  p(cls) is the reference's probability of the served class. Each term is
  a relative gap where a value is large, so rounding reads alike on every
  seed. A row that is no prediction of the reference (a stale DFP buffer,
  another camera's frame, an altered box) reads far off.
* ``keep_mismatch``: the rows whose keep flag differs from the reference's
  greedy NMS over the served candidates themselves (their boxes, classes
  and validity, in float32 on the CPU).
* ``order_breaks``: the served rows whose score (obj x cls_conf, -1 below
  the confidence, recomputed in float32 from the served obj and cls_conf
  as the program computes its sort key) is higher than the row before:
  candidates are served in descending score.
* ``missed_candidates``: the reference's candidates (score over the
  confidence) that no served row matches (a served row matches the anchor
  nearest it by ``row_gap``'s measure) and whose reference score beats the
  lowest served score by more than ``score_margin``, the rounding of the
  served precision; where fewer than K rows are above the confidence,
  every reference candidate over the confidence by more than the margin
  has to be served. A program that serves the wrong K candidates (ranked by
  another key, or by scores of another frame) leaves better ones out.

``selection_gap`` is the continuous form of the last: the most by which an
unmatched reference candidate beats the lowest served score (0 where none
does). It is not compared; the readings that set ``score_margin`` come
from it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from streambench.reference.model import anchors
from streambench.reference.postprocess import greedy_keep

ANCHOR_BLOCK = 256  # served rows compared at once against every anchor


def _masked_scores(obj: torch.Tensor, cls_conf: torch.Tensor, conf: float) -> torch.Tensor:
    """obj x cls_conf in float32, -1 below the confidence: the sort key."""
    s = obj * cls_conf
    return torch.where(s >= float(np.float32(conf)), s, torch.full_like(s, -1.0))


def judge(served: np.ndarray, ref_pred: torch.Tensor, hw, num_classes: int, conf_thre: float,
          nms_thre: float, score_margin: float) -> Dict[str, float]:
    """``served`` [B, K, 8] rows (host) against ``ref_pred`` [B, N, 5 + C]
    (any device, float32) of the same B images; ``hw`` the levels' map
    sizes. Returns the numbers over these B images."""
    device = ref_pred.device
    rows = torch.from_numpy(np.ascontiguousarray(served, dtype=np.float32))
    b, k = rows.shape[:2]

    # keep flags: the greedy NMS of the served candidates, on the CPU
    masked = _masked_scores(rows[..., 4], rows[..., 5], conf_thre)
    valid = masked > 0.0
    keep = greedy_keep(rows, valid, nms_thre)
    keep_mismatch = int((keep != (rows[..., 7] > 0.5)).sum())
    order_breaks = int((masked[:, 1:] > masked[:, :-1]).sum())

    rows = rows.to(device)

    grid, stride = anchors(hw, device)
    ref_t = ref_pred[..., :2] / stride[None, :, None] - grid[None]  # raw offsets
    t_scale = ref_t.abs().clamp(min=1.0)
    ref_wh = ref_pred[..., 2:4]
    wh_scale = torch.maximum(ref_wh, stride[None, :, None])
    row_gap = 0.0
    matched = torch.zeros(ref_pred.shape[:2], dtype=torch.bool, device=device)
    for i in range(b):
        for j in range(0, k, ANCHOR_BLOCK):
            r = rows[i, j:j + ANCHOR_BLOCK]
            xy = (r[:, :2] + r[:, 2:4]) * 0.5
            wh = r[:, 2:4] - r[:, :2]
            cls = r[:, 6].long().clamp(0, num_classes - 1)
            t = xy[:, None, :] / stride[None, :, None] - grid[None]
            gaps = [((t - ref_t[i][None]).abs() / t_scale[i][None]).amax(-1),
                    ((wh[:, None, :] - ref_wh[i][None]).abs() / wh_scale[i][None]).amax(-1),
                    (r[:, None, 4] - ref_pred[i, None, :, 4]).abs(),
                    (r[:, None, 5] - ref_pred[i, :, 5:].T[cls]).abs()]
            d, nearest = torch.stack(gaps).amax(0).min(-1)  # each row's nearest anchor
            matched[i, nearest] = True
            bad_cls = (r[:, 6] != r[:, 6].round()) | (r[:, 6] < 0) | (r[:, 6] >= num_classes)
            d = torch.where(bad_cls, torch.full_like(d, float("inf")), d)
            row_gap = max(row_gap, float(d.max()))

    # selection: the reference's candidates that beat the lowest served score
    conf = float(np.float32(conf_thre))
    ref_score = ref_pred[..., 4] * ref_pred[..., 5:5 + num_classes].amax(-1)
    masked = masked.to(device)
    lowest = torch.where(masked > 0.0, masked, torch.full_like(masked, float("inf"))).amin(-1)
    floor = torch.where(valid.to(device).sum(-1) >= k, lowest, torch.full_like(lowest, conf))
    excess = torch.where(~matched & (ref_score >= conf), ref_score - floor[:, None],
                         torch.full_like(ref_score, -1.0))
    return {"row_gap": row_gap, "keep_mismatch": float(keep_mismatch),
            "order_breaks": float(order_breaks),
            "missed_candidates": float((excess > score_margin).sum()),
            "selection_gap": max(float(excess.max()), 0.0)}


def worst(readings) -> Dict[str, float]:
    """The largest of each number over several ``judge`` results."""
    out: Dict[str, float] = {}
    for r in readings:
        for name, v in r.items():
            out[name] = max(out.get(name, v), v) if np.isfinite(v) else float("inf")
    return out
