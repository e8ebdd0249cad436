"""Greedy IoU track association: the port's own copy of
``streamyolo_tpu/stream/track.py``.

Boxes are ltwh. For each new detection j (in score order), the unmatched
previous box of the same label with the highest IoU >= the threshold is
claimed; unmatched new detections start fresh track ids. ``_greedy_match``
is the Python oracle; ``streamyolo_torch/native/streamyolo_native.cpp::iou_assoc_greedy``
is its C++ twin (bound in ``streamyolo_torch.native``), which ``iou_assoc``
uses when the native library builds. A failed build is logged with the
compiler's message, and the Python version serves.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np

from streamyolo_torch.eval.cocoeval import bbox_iou_xywh
from streamyolo_torch.native import NativeBuildError, iou_assoc_greedy_cpp, load
from streamyolo_torch.utils.logger import get_logger


def iou_ltwh(bboxes1: np.ndarray, bboxes2: np.ndarray) -> np.ndarray:
    """[m, 4] x [n, 4] ltwh -> [m, n] IoU (box-only ``maskUtils.iou``)."""
    bboxes1 = np.asarray(bboxes1, np.float64).reshape(-1, 4)
    bboxes2 = np.asarray(bboxes2, np.float64).reshape(-1, 4)
    return bbox_iou_xywh(bboxes1, bboxes2, np.zeros(len(bboxes2)))


def _greedy_match(ious: np.ndarray, labels1, labels2, match_iou_th: float):
    """For each new detection j (in score order), claim the still-free
    previous box of the same label with the highest IoU >= threshold.
    Equal maxima resolve to the HIGHEST row index, as the C++ twin's
    sequential scan does. Returns (matched1, matched2, unmatched2)."""
    ious = np.asarray(ious, np.float64)
    labels1 = np.asarray(labels1)
    labels2 = np.asarray(labels2)
    m, n = ious.shape
    free = np.ones(m, bool)
    prev_rows: List[int] = []
    new_cols: List[int] = []
    fresh: List[int] = []
    for j in range(n):
        if m:
            score = np.where(free & (labels1 == labels2[j]), ious[:, j], -np.inf)
            i = m - 1 - int(score[::-1].argmax())  # the last argmax on ties
        if not m or score[i] < match_iou_th:
            fresh.append(j)
        else:
            free[i] = False
            prev_rows.append(i)
            new_cols.append(j)
    return prev_rows, new_cols, fresh


@functools.lru_cache(maxsize=None)
def _greedy_impl():
    """The C++ twin if the native library builds, else ``_greedy_match``
    (chosen once per process; a failed build is logged)."""
    try:
        load()
    except NativeBuildError as e:
        get_logger().warning("native track association unavailable, using the Python "
                             "version: %s", e)
        return _greedy_match
    return iou_assoc_greedy_cpp


def _orders(m: int, matched1, matched2, unmatched2, no_unmatched1: bool):
    if no_unmatched1:
        order1 = list(matched1)
    else:
        order1 = list(matched1) + list(set(range(m)) - set(matched1))
    return order1, list(matched2) + list(unmatched2)


def iou_assoc(
    bboxes1, labels1, tracks1, tkidx: int, bboxes2, labels2,
    match_iou_th: float, no_unmatched1: bool = False,
) -> Tuple[list, list, int, np.ndarray, int]:
    """Associate previous (1) and new (2) detections and carry track ids.

    Returns (order1, order2, n_matched, tracks2, tkidx): the matched
    elements first in both orders, then the new detections' fresh ids."""
    ious = iou_ltwh(bboxes1, bboxes2)
    matched1, matched2, unmatched2 = _greedy_impl()(
        ious, np.asarray(labels1, np.int64), np.asarray(labels2, np.int64), match_iou_th)
    order1, order2 = _orders(len(bboxes1), matched1, matched2, unmatched2, no_unmatched1)
    n_matched = len(matched2)
    n_unmatched2 = len(unmatched2)
    tracks1 = np.asarray(tracks1)
    tracks2 = np.concatenate((
        tracks1[order1][:n_matched],
        np.arange(tkidx, tkidx + n_unmatched2, dtype=tracks1.dtype)))
    return order1, order2, n_matched, tracks2, tkidx + n_unmatched2


def iou_assoc_no_tracks(
    bboxes1, labels1, bboxes2, labels2, match_iou_th: float,
    no_unmatched1: bool = False,
) -> Tuple[list, list, int]:
    """``iou_assoc`` without track ids (the Python matcher, as the JAX
    package's): (order1, order2, n_matched)."""
    ious = iou_ltwh(bboxes1, bboxes2)
    matched1, matched2, unmatched2 = _greedy_match(ious, labels1, labels2, match_iou_th)
    order1, order2 = _orders(len(bboxes1), matched1, matched2, unmatched2, no_unmatched1)
    return order1, order2, len(matched2)


def track_based_shuffle(tracks1, tracks2, no_unmatched1: bool = False):
    """Reorder two detection sets so that entries sharing track ids align at
    the front: (order1, order2, n_matched)."""
    tracks1 = np.asarray(tracks1)
    tracks2 = np.asarray(tracks2)
    in1 = np.isin(tracks1, tracks2)
    in2 = np.isin(tracks2, tracks1)
    matched1 = np.nonzero(in1)[0]
    matched2 = np.nonzero(in2)[0]
    if no_unmatched1:
        order1 = matched1
    else:
        order1 = np.concatenate((matched1, np.nonzero(~in1)[0]))
    order2 = np.concatenate((matched2, np.nonzero(~in2)[0]))
    return order1, order2, len(matched1)
