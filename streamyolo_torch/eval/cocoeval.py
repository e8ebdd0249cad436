"""COCO detection evaluation (bbox) in NumPy: the port's own copy of
``streamyolo_tpu/eval/cocoeval.py``, the plain oracle of the native
``eval/cocoeval_ext.py::COCOeval_opt``.

The standard COCO bbox protocol: IoU thresholds 0.5:0.05:0.95, recall
thresholds 0:0.01:1, maxDets (1, 10, 100), area ranges all / small / medium
/ large; greedy per-image matching in descending score order (crowd gts
match several dts, ignored matches are no false positives); the precision
envelope sampled at the 101 recall points; the 12 summary stats.
"""

from __future__ import annotations

import copy
from collections import defaultdict
from typing import Dict, List

import numpy as np


def bbox_iou_xywh(dt: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """IoU between [n,4] dt and [m,4] gt boxes in ltwh format -> [n, m].
    For crowd gt the denominator is the dt area (IoA semantics)."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    dx1, dy1 = dt[:, 0], dt[:, 1]
    dx2, dy2 = dt[:, 0] + dt[:, 2], dt[:, 1] + dt[:, 3]
    gx1, gy1 = gt[:, 0], gt[:, 1]
    gx2, gy2 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    iw = np.clip(
        np.minimum(dx2[:, None], gx2[None]) - np.maximum(dx1[:, None], gx1[None]),
        0, None,
    )
    ih = np.clip(
        np.minimum(dy2[:, None], gy2[None]) - np.maximum(dy1[:, None], gy1[None]),
        0, None,
    )
    inter = iw * ih
    d_area = (dt[:, 2] * dt[:, 3])[:, None]
    g_area = (gt[:, 2] * gt[:, 3])[None]
    union = np.where(iscrowd[None].astype(bool), d_area, d_area + g_area - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


class Params:
    def __init__(self, iouType: str = "bbox"):
        assert iouType == "bbox", "only bbox evaluation is supported"
        self.imgIds: List[int] = []
        self.catIds: List[int] = []
        self.iouThrs = np.linspace(0.5, 0.95, 10)
        self.recThrs = np.linspace(0.0, 1.00, 101)
        self.maxDets = [1, 10, 100]
        self.areaRng = [
            [0.0, 1e5**2],
            [0.0, 32**2],
            [32**2, 96**2],
            [96**2, 1e5**2],
        ]
        self.areaRngLbl = ["all", "small", "medium", "large"]
        self.useCats = 1
        self.iouType = iouType


class COCOeval:
    """Drop-in replacement for ``pycocotools.cocoeval.COCOeval`` (bbox)."""

    def __init__(self, cocoGt=None, cocoDt=None, iouType: str = "bbox"):
        self.cocoGt = cocoGt
        self.cocoDt = cocoDt
        self.params = Params(iouType)
        self.evalImgs: Dict = {}
        self.eval: Dict = {}
        self.stats = np.zeros(12)
        self.ious: Dict = {}
        if cocoGt is not None:
            self.params.imgIds = sorted(cocoGt.getImgIds())
            self.params.catIds = sorted(cocoGt.getCatIds())

    # -- data prep -----------------------------------------------------------

    def _prepare(self):
        p = self.params
        gts = self.cocoGt.loadAnns(
            self.cocoGt.getAnnIds(imgIds=p.imgIds, catIds=p.catIds if p.useCats else [])
        )
        dts = self.cocoDt.loadAnns(
            self.cocoDt.getAnnIds(imgIds=p.imgIds, catIds=p.catIds if p.useCats else [])
        )
        self._gts = defaultdict(list)
        self._dts = defaultdict(list)
        for gt in gts:
            gt = dict(gt)
            gt["ignore"] = gt.get("ignore", 0) or gt.get("iscrowd", 0)
            self._gts[(gt["image_id"], gt["category_id"])].append(gt)
        for dt in dts:
            self._dts[(dt["image_id"], dt["category_id"])].append(dict(dt))

    # -- per-image matching ----------------------------------------------------

    def computeIoU(self, imgId, catId):
        p = self.params
        if p.useCats:
            gt = self._gts[(imgId, catId)]
            dt = self._dts[(imgId, catId)]
        else:
            gt = [g for c in p.catIds for g in self._gts[(imgId, c)]]
            dt = [d for c in p.catIds for d in self._dts[(imgId, c)]]
        if len(gt) == 0 or len(dt) == 0:
            return np.zeros((len(dt), len(gt)))
        dt = sorted(dt, key=lambda d: -d["score"])[: p.maxDets[-1]]
        d_boxes = np.array([d["bbox"] for d in dt], dtype=np.float64)
        g_boxes = np.array([g["bbox"] for g in gt], dtype=np.float64)
        iscrowd = np.array([int(g.get("iscrowd", 0)) for g in gt])
        return bbox_iou_xywh(d_boxes, g_boxes, iscrowd)

    def evaluateImg(self, imgId, catId, aRng, maxDet):
        gt = self._gts[(imgId, catId)]
        dt = self._dts[(imgId, catId)]
        if len(gt) == 0 and len(dt) == 0:
            return None
        p = self.params

        for g in gt:
            g["_ignore"] = 1 if (g["ignore"] or g["area"] < aRng[0] or g["area"] > aRng[1]) else 0

        gtind = np.argsort([g["_ignore"] for g in gt], kind="mergesort")
        gt = [gt[i] for i in gtind]
        dtind = np.argsort([-d["score"] for d in dt], kind="mergesort")
        dt = [dt[i] for i in dtind[:maxDet]]
        iscrowd = [int(g.get("iscrowd", 0)) for g in gt]
        ious = (
            self.ious[(imgId, catId)][:, gtind]
            if len(self.ious[(imgId, catId)]) > 0
            else self.ious[(imgId, catId)]
        )

        T = len(p.iouThrs)
        G = len(gt)
        D = len(dt)
        gtm = np.zeros((T, G))
        dtm = np.zeros((T, D))
        gtIg = np.array([g["_ignore"] for g in gt])
        dtIg = np.zeros((T, D))
        if len(ious):
            for tind, t in enumerate(p.iouThrs):
                for dind, d in enumerate(dt):
                    iou = min([t, 1 - 1e-10])
                    m = -1
                    for gind in range(G):
                        # gt already matched (and not crowd): skip
                        if gtm[tind, gind] > 0 and not iscrowd[gind]:
                            continue
                        # dt matched an un-ignored gt; stop at ignored gts
                        if m > -1 and gtIg[m] == 0 and gtIg[gind] == 1:
                            break
                        if ious[dind, gind] < iou:
                            continue
                        iou = ious[dind, gind]
                        m = gind
                    if m == -1:
                        continue
                    dtIg[tind, dind] = gtIg[m]
                    dtm[tind, dind] = gt[m]["id"]
                    gtm[tind, m] = d["id"]
        # unmatched dts outside the area range are ignored
        a = np.array(
            [d["area"] < aRng[0] or d["area"] > aRng[1] for d in dt]
        ).reshape(1, D)
        dtIg = np.logical_or(dtIg, np.logical_and(dtm == 0, np.repeat(a, T, 0)))
        return {
            "image_id": imgId,
            "category_id": catId,
            "aRng": aRng,
            "maxDet": maxDet,
            "dtIds": [d["id"] for d in dt],
            "gtIds": [g["id"] for g in gt],
            "dtMatches": dtm,
            "gtMatches": gtm,
            "dtScores": [d["score"] for d in dt],
            "gtIgnore": gtIg,
            "dtIgnore": dtIg,
        }

    def evaluate(self):
        p = self.params
        p.imgIds = list(np.unique(p.imgIds))
        if p.useCats:
            p.catIds = list(np.unique(p.catIds))
        self._prepare()
        catIds = p.catIds if p.useCats else [-1]
        self.ious = {
            (imgId, catId): self.computeIoU(imgId, catId)
            for imgId in p.imgIds
            for catId in catIds
        }
        maxDet = p.maxDets[-1]
        self.evalImgs = [
            self.evaluateImg(imgId, catId, areaRng, maxDet)
            for catId in catIds
            for areaRng in p.areaRng
            for imgId in p.imgIds
        ]
        self._paramsEval = copy.deepcopy(self.params)

    # -- accumulate / summarize -------------------------------------------------

    def accumulate(self, p=None):
        if p is None:
            p = self.params
        p.catIds = p.catIds if p.useCats == 1 else [-1]
        T = len(p.iouThrs)
        R = len(p.recThrs)
        K = len(p.catIds)
        A = len(p.areaRng)
        M = len(p.maxDets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        scores = -np.ones((T, R, K, A, M))

        _pe = self._paramsEval
        setK = set(_pe.catIds)
        setA = set(map(tuple, _pe.areaRng))
        setM = set(_pe.maxDets)
        setI = set(_pe.imgIds)
        k_list = [n for n, k in enumerate(p.catIds) if k in setK]
        m_list = [m for n, m in enumerate(p.maxDets) if m in setM]
        a_list = [
            n for n, a in enumerate(map(lambda x: tuple(x), p.areaRng)) if a in setA
        ]
        i_list = [n for n, i in enumerate(p.imgIds) if i in setI]
        I0 = len(_pe.imgIds)
        A0 = len(_pe.areaRng)
        for k, k0 in enumerate(k_list):
            Nk = k0 * A0 * I0
            for a, a0 in enumerate(a_list):
                Na = a0 * I0
                for m, maxDet in enumerate(m_list):
                    E = [self.evalImgs[Nk + Na + i] for i in i_list]
                    E = [e for e in E if e is not None]
                    if len(E) == 0:
                        continue
                    dtScores = np.concatenate(
                        [e["dtScores"][0:maxDet] for e in E]
                    )
                    inds = np.argsort(-dtScores, kind="mergesort")
                    dtScoresSorted = dtScores[inds]

                    dtm = np.concatenate(
                        [e["dtMatches"][:, 0:maxDet] for e in E], axis=1
                    )[:, inds]
                    dtIg = np.concatenate(
                        [e["dtIgnore"][:, 0:maxDet] for e in E], axis=1
                    )[:, inds]
                    gtIg = np.concatenate([e["gtIgnore"] for e in E])
                    npig = np.count_nonzero(gtIg == 0)
                    if npig == 0:
                        continue
                    tps = np.logical_and(dtm, np.logical_not(dtIg))
                    fps = np.logical_and(
                        np.logical_not(dtm), np.logical_not(dtIg)
                    )
                    tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
                    for t, (tp, fp) in enumerate(zip(tp_sum, fp_sum)):
                        nd = len(tp)
                        rc = tp / npig
                        pr = tp / (fp + tp + np.spacing(1))
                        q = np.zeros((R,))
                        ss = np.zeros((R,))
                        recall[t, k, a, m] = rc[-1] if nd else 0

                        pr = pr.tolist()
                        q = q.tolist()
                        for i in range(nd - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds_r = np.searchsorted(rc, p.recThrs, side="left")
                        try:
                            for ri, pi in enumerate(inds_r):
                                q[ri] = pr[pi]
                                ss[ri] = dtScoresSorted[pi]
                        except IndexError:
                            pass
                        precision[t, :, k, a, m] = np.array(q)
                        scores[t, :, k, a, m] = np.array(ss)
        self.eval = {
            "params": p,
            "counts": [T, R, K, A, M],
            "precision": precision,
            "recall": recall,
            "scores": scores,
        }

    def _summarize(self, ap=1, iouThr=None, areaRng="all", maxDets=100):
        p = self.params
        aind = [i for i, a in enumerate(p.areaRngLbl) if a == areaRng]
        mind = [i for i, m in enumerate(p.maxDets) if m == maxDets]
        if ap == 1:
            s = self.eval["precision"]
            if iouThr is not None:
                t = np.where(np.isclose(iouThr, p.iouThrs))[0]
                s = s[t]
            s = s[:, :, :, aind, mind]
        else:
            s = self.eval["recall"]
            if iouThr is not None:
                t = np.where(np.isclose(iouThr, p.iouThrs))[0]
                s = s[t]
            s = s[:, :, aind, mind]
        if len(s[s > -1]) == 0:
            return -1.0
        return float(np.mean(s[s > -1]))

    def summarize(self):
        self.stats = np.array(
            [
                self._summarize(1),
                self._summarize(1, iouThr=0.5, maxDets=self.params.maxDets[2]),
                self._summarize(1, iouThr=0.75, maxDets=self.params.maxDets[2]),
                self._summarize(1, areaRng="small", maxDets=self.params.maxDets[2]),
                self._summarize(1, areaRng="medium", maxDets=self.params.maxDets[2]),
                self._summarize(1, areaRng="large", maxDets=self.params.maxDets[2]),
                self._summarize(0, maxDets=self.params.maxDets[0]),
                self._summarize(0, maxDets=self.params.maxDets[1]),
                self._summarize(0, maxDets=self.params.maxDets[2]),
                self._summarize(0, areaRng="small", maxDets=self.params.maxDets[2]),
                self._summarize(0, areaRng="medium", maxDets=self.params.maxDets[2]),
                self._summarize(0, areaRng="large", maxDets=self.params.maxDets[2]),
            ]
        )
        return self.stats

    def __str__(self):
        names = [
            ("Average Precision  (AP) @[ IoU=0.50:0.95 | area=   all | maxDets=100 ]", 0),
            ("Average Precision  (AP) @[ IoU=0.50      | area=   all | maxDets=100 ]", 1),
            ("Average Precision  (AP) @[ IoU=0.75      | area=   all | maxDets=100 ]", 2),
            ("Average Precision  (AP) @[ IoU=0.50:0.95 | area= small | maxDets=100 ]", 3),
            ("Average Precision  (AP) @[ IoU=0.50:0.95 | area=medium | maxDets=100 ]", 4),
            ("Average Precision  (AP) @[ IoU=0.50:0.95 | area= large | maxDets=100 ]", 5),
            ("Average Recall     (AR) @[ IoU=0.50:0.95 | area=   all | maxDets=  1 ]", 6),
            ("Average Recall     (AR) @[ IoU=0.50:0.95 | area=   all | maxDets= 10 ]", 7),
            ("Average Recall     (AR) @[ IoU=0.50:0.95 | area=   all | maxDets=100 ]", 8),
            ("Average Recall     (AR) @[ IoU=0.50:0.95 | area= small | maxDets=100 ]", 9),
            ("Average Recall     (AR) @[ IoU=0.50:0.95 | area=medium | maxDets=100 ]", 10),
            ("Average Recall     (AR) @[ IoU=0.50:0.95 | area= large | maxDets=100 ]", 11),
        ]
        return "\n".join(f" {n} = {self.stats[i]:0.3f}" for n, i in names)
