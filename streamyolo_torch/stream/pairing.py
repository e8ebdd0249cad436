"""Streaming-evaluation pairing pass (sAP): the port's own copy of
``streamyolo_tpu/stream/pairing.py``.

  * for each ground-truth frame ii of a sequence the query time is
    ``(ii - eta) / fps``; the paired prediction is the LAST detector output
    with timestamp <= t;
  * ``miss`` counts frames with no output yet, ``in_time`` exact input-frame
    matches, ``mismatch`` accumulates the frame-index lag;
  * paired boxes (ltrb, original image scale) become COCO ltwh rows and are
    scored by COCOeval: the sAP table.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from streamyolo_torch.eval.cocoeval_ext import evaluator_class
from streamyolo_torch.stream.bbox import ltrb2ltwh
from streamyolo_torch.utils.logger import get_logger


def pair_streaming_results(
    db,
    results_by_seq: Dict[str, Dict],
    fps: float = 30.0,
    eta: int = 0,
) -> Tuple[List[dict], Dict[str, int]]:
    """Pair per-sequence streaming outputs with ground-truth frames.

    Args:
      db: COCO index with ``sequences`` in the dataset root.
      results_by_seq: seq name -> dict(results_parsed, timestamps, input_fidx).

    Returns (results_ccf, {miss, in_time, mismatch}).
    """
    seqs = db.dataset["sequences"]
    results_ccf: List[dict] = []
    in_time = 0
    miss = 0
    mismatch = 0

    for sid, seq in enumerate(seqs):
        frame_list = [img for img in db.imgs.values() if img["sid"] == sid]
        results = results_by_seq[seq]
        results_parsed = results["results_parsed"]
        timestamps = results["timestamps"]
        input_fidx = results["input_fidx"]

        tidx_p1 = 0
        for ii, img in enumerate(frame_list):
            t = (ii - eta) / fps
            while tidx_p1 < len(timestamps) and timestamps[tidx_p1] <= t:
                tidx_p1 += 1
            if tidx_p1 == 0:
                miss += 1
                bboxes, scores, labels = [], [], []
            else:
                tidx = tidx_p1 - 1
                ifidx = input_fidx[tidx]
                in_time += int(ii == ifidx)
                mismatch += ii - ifidx
                bboxes, scores, labels = results_parsed[tidx][:3]

            n = len(bboxes)
            if n:
                bboxes_ltwh = ltrb2ltwh(np.asarray(bboxes))
            for i in range(n):
                results_ccf.append(
                    {
                        "image_id": img["id"],
                        "bbox": [float(v) for v in bboxes_ltwh[i]],
                        "score": float(scores[i]),
                        "category_id": int(labels[i]),
                    }
                )
    return results_ccf, {"miss": miss, "in_time": in_time, "mismatch": mismatch}


def detections_for_image(
    results_ccf: Sequence[dict],
    image_id: int,
    start_idx: Optional[int] = None,
) -> Tuple[Optional[int], np.ndarray, np.ndarray, np.ndarray]:
    """Detections of one image id from a CCF result list: returns
    ``(next_start_idx, bboxes_ltwh [N,4], scores [N], category_ids [N])``.

    With ``start_idx`` the list is taken as image_id-sorted (the order
    ``pair_streaming_results`` emits) and scanned forward from there, and
    ``next_start_idx`` lets a caller sweep a whole db in one pass; without
    it, the list is filtered in full and ``next_start_idx`` is None.
    """
    if start_idx is not None:
        i = start_idx
        while i < len(results_ccf) and results_ccf[i]["image_id"] < image_id:
            i += 1
        end = i
        while end < len(results_ccf) and \
                results_ccf[end]["image_id"] == image_id:
            end += 1
        dets, nxt = results_ccf[i:end], end
    else:
        dets, nxt = [r for r in results_ccf if r["image_id"] == image_id], None
    return (
        nxt,
        np.asarray([d["bbox"] for d in dets], np.float64).reshape(-1, 4),
        np.asarray([d["score"] for d in dets], np.float64),
        np.asarray([d["category_id"] for d in dets], np.int64),
    )


def eval_ccf(db, results_ccf: Sequence[dict], img_ids=None):
    """COCO-evaluate CCF-format results against ``db`` with the native
    ``COCOeval_opt`` (the NumPy ``COCOeval`` if it does not build). Returns
    ``{"stats", "eval", "evaluator"}``, or None for no results."""
    if len(results_ccf) == 0:
        return None
    cls = evaluator_class()
    get_logger().info("scoring with %s", cls.__name__)
    cocoDt = db.loadRes(list(results_ccf))
    coco_eval = cls(db, cocoDt, "bbox")
    if img_ids is not None:
        coco_eval.params.imgIds = list(img_ids)
    coco_eval.evaluate()
    coco_eval.accumulate()
    coco_eval.summarize()
    return {"stats": coco_eval.stats, "eval": coco_eval.eval, "evaluator": cls.__name__}


def streaming_eval(
    db,
    result_dir: str,
    fps: float = 30.0,
    eta: int = 0,
    out_dir: Optional[str] = None,
    overwrite: bool = False,
):
    """The whole pairing + eval pass over a run directory (the per-sequence
    pkls of ``run_streaming_detection``). Returns (eval_summary, assoc)."""
    logger = get_logger()
    out_dir = out_dir or result_dir
    os.makedirs(out_dir, exist_ok=True)

    results_by_seq = {}
    for seq in db.dataset["sequences"]:
        with open(os.path.join(result_dir, seq + ".pkl"), "rb") as f:
            results_by_seq[seq] = pickle.load(f)

    logger.info("Pairing the output with the ground truth")
    results_ccf, assoc = pair_streaming_results(db, results_by_seq, fps, eta)

    with open(os.path.join(out_dir, "results_ccf.pkl"), "wb") as f:
        pickle.dump(results_ccf, f)
    with open(os.path.join(out_dir, "eval_assoc.pkl"), "wb") as f:
        pickle.dump(assoc, f)

    eval_summary = eval_ccf(db, results_ccf)
    if eval_summary is not None:
        with open(os.path.join(out_dir, "eval_summary.pkl"), "wb") as f:
            pickle.dump(eval_summary, f)
        logger.info(
            f"sAP: {eval_summary['stats'][0] * 100:.1f}  "
            f"sAP50: {eval_summary['stats'][1] * 100:.1f}  "
            f"sAP75: {eval_summary['stats'][2] * 100:.1f}"
        )
    logger.info(f"association: {assoc}")
    return eval_summary, assoc
