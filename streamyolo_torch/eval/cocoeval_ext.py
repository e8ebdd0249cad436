"""C++-accelerated COCOeval (``COCOeval_opt``): the port's own copy of
``streamyolo_tpu/eval/cocoeval_ext.py`` over the port's native binding.

The same protocol as ``eval/cocoeval.py::COCOeval``; the whole evaluate +
accumulate pass (per-cell IoU, greedy matching across thresholds and area
ranges, global score sort, PR curves) runs in one native call
(``native/streamyolo_native.cpp::cocoeval_run``). The Python side prepares
flat per-cell arrays (lexsort + bincount). Per-image results
(``evalImgs``) are not materialised; ``eval`` and ``stats`` are.

``evaluator_class`` picks ``COCOeval_opt`` when the native library builds and
the NumPy ``COCOeval`` otherwise, and logs which one scores.
"""

from __future__ import annotations

import copy

import numpy as np

from streamyolo_torch.eval.cocoeval import COCOeval
from streamyolo_torch.native import NativeBuildError, cocoeval_run_cpp, load
from streamyolo_torch.utils.logger import get_logger


def evaluator_class():
    """``COCOeval_opt`` if the native library builds (or is built), else
    ``COCOeval``; a failed build is logged with the compiler's message."""
    try:
        load()
    except NativeBuildError as e:
        get_logger().warning("native COCOeval unavailable, scoring with the NumPy "
                             "COCOeval: %s", e)
        return COCOeval
    return COCOeval_opt


class COCOeval_opt(COCOeval):
    def evaluate(self):
        """Prepare flat per-cell arrays (k-major cells, dts score-sorted)."""
        p = self.params
        p.imgIds = list(np.unique(p.imgIds))
        if p.useCats:
            p.catIds = list(np.unique(p.catIds))
        self._prepare()

        img_index = {img_id: i for i, img_id in enumerate(p.imgIds)}
        cat_index = {cat_id: k for k, cat_id in enumerate(p.catIds)}
        self._K = len(p.catIds)
        self._I = len(p.imgIds)
        n_cells = self._K * self._I

        # ---- ground truths (order within a cell = annotation order)
        g_cells, g_boxes, g_areas, g_crowd, g_ign = [], [], [], [], []
        for (img_id, cat_id), anns in self._gts.items():
            if img_id not in img_index or cat_id not in cat_index:
                continue
            cell = cat_index[cat_id] * self._I + img_index[img_id]
            for g in anns:
                g_cells.append(cell)
                g_boxes.append(g["bbox"])
                g_areas.append(g["area"])
                g_crowd.append(int(g.get("iscrowd", 0)))
                g_ign.append(int(bool(g["ignore"])))
        g_cells = np.asarray(g_cells, np.int64)
        order = np.argsort(g_cells, kind="mergesort")
        self._g = dict(
            cells=g_cells[order],
            boxes=np.asarray(g_boxes, np.float64).reshape(-1, 4)[order],
            areas=np.asarray(g_areas, np.float64)[order],
            crowd=np.asarray(g_crowd, np.uint8)[order],
            ign=np.asarray(g_ign, np.uint8)[order],
        )
        self._g_off = np.zeros(n_cells + 1, np.int64)
        np.cumsum(np.bincount(self._g["cells"], minlength=n_cells),
                  out=self._g_off[1:])

        # ---- detections (order within a cell = stable descending score)
        d_cells, d_scores, d_boxes, d_areas = [], [], [], []
        for (img_id, cat_id), anns in self._dts.items():
            if img_id not in img_index or cat_id not in cat_index:
                continue
            cell = cat_index[cat_id] * self._I + img_index[img_id]
            for d in anns:
                d_cells.append(cell)
                d_scores.append(d["score"])
                d_boxes.append(d["bbox"])
                d_areas.append(d["area"])
        d_cells = np.asarray(d_cells, np.int64)
        d_scores = np.asarray(d_scores, np.float64)
        order = np.lexsort((-d_scores, d_cells))  # stable: cell, then -score
        self._d = dict(
            cells=d_cells[order],
            scores=d_scores[order],
            boxes=np.asarray(d_boxes, np.float64).reshape(-1, 4)[order],
            areas=np.asarray(d_areas, np.float64)[order],
        )
        self._d_off = np.zeros(n_cells + 1, np.int64)
        np.cumsum(np.bincount(self._d["cells"], minlength=n_cells),
                  out=self._d_off[1:])

        self._paramsEval = copy.deepcopy(self.params)

    def accumulate(self, p=None):
        if p is None:
            p = self.params
        precision, recall, scores = cocoeval_run_cpp(
            self._K, self._I, self._d_off, self._g_off,
            self._d["scores"], self._d["boxes"], self._d["areas"],
            self._g["boxes"], self._g["areas"], self._g["crowd"],
            self._g["ign"],
            np.asarray(p.iouThrs), np.asarray(p.recThrs),
            np.asarray(p.areaRng), np.asarray(p.maxDets),
        )
        self.eval = {
            "params": p,
            "counts": [len(p.iouThrs), len(p.recThrs), self._K,
                       len(p.areaRng), len(p.maxDets)],
            "precision": precision,
            "recall": recall,
            "scores": scores,
        }
