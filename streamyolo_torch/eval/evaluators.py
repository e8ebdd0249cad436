"""Offline pseudo-streaming evaluators (ONEX / TWOX / STILL), the
counterparts of ``streamyolo_tpu/eval/evaluators.py``.

  * ``ONEX_COCOEvaluator``: the prediction made from the input pair at image
    id t is written under ``image_id = t + 1`` (the future frame), the
    pseudo-streaming trick. The reference's boundary quirks are copied:
    detections for ids 15060 and 15061 are dropped (a hard-coded pair),
    frames whose NEXT image has fid 0 are dropped, and frames with fid 0
    hit a branch that never appends, so they contribute nothing;
  * ``TWOX_COCOEvaluator``: the same with a t + 2 shift and wider skips;
  * ``STILL_COCOEvaluator``: plain COCO eval.

Per batch: the forward (the dual-frame ``off_pipe`` forward or
``eval/seq_forward.py::SequentialDedupForward``), then ``postprocess_fixed``
at ``pre_nms_topk=1000`` (kernel B1 once per batch on the card), one
[B, K, 8] device-to-host copy, and the conversion to COCO rows. The timing
meters are the reference's: forward (synchronised) and NMS (postprocess,
copy and unpack), per image over all batches but the last.

Multi-process evaluation (``distributed``, by default whenever a process
group of more than one rank is up, as ``get_eval_loader`` then shards the
val set): every rank's detection list is all-gathered and the timing
meters summed (``parallel/multihost.py``); only the main process runs
COCOeval, the others return ``(0.0, 0.0, None)``.
"""

from __future__ import annotations

import itertools
import time
from typing import Callable, List, Sequence

import numpy as np
import torch

from streamyolo_torch.eval.cocoeval_ext import COCOeval_opt
from streamyolo_torch.ops.nms import candidate_counts, postprocess_fixed
from streamyolo_torch.utils.logger import get_logger


def _pipe_table(rows, headers) -> str:
    """A markdown pipe table, columns left-aligned and at least two wider
    than their header, floats as ``.3f`` (tabulate's ``pipe`` format)."""
    cells = [["" if v is None else f"{v:.3f}" if isinstance(v, float) else str(v)
              for v in row] for row in rows]
    widths = [max([len(h) + 2] + [len(r[i]) for r in cells]) for i, h in enumerate(headers)]

    def line(values):
        return "| " + " | ".join(v.ljust(w) for v, w in zip(values, widths)) + " |"

    sep = "|" + "|".join(":" + "-" * (w + 1) for w in widths) + "|"
    return "\n".join([line(headers), sep] + [line(r) for r in cells])


def per_class_AP_table(coco_eval, class_names: Sequence[str], headers=("class", "AP"),
                       colums=6) -> str:
    """Per-class AP table (AP at IoU 0.50:0.95, area all, 100 detections)."""
    per_class_AP = {}
    precisions = coco_eval.eval["precision"]
    assert len(class_names) == precisions.shape[2]
    for idx, name in enumerate(class_names):
        precision = precisions[:, :, idx, 0, -1]
        precision = precision[precision > -1]
        ap = np.mean(precision) if precision.size else float("nan")
        per_class_AP[name] = float(ap * 100)

    num_cols = min(colums, len(per_class_AP) * len(headers))
    result_pair = [x for pair in per_class_AP.items() for x in pair]
    row_pair = itertools.zip_longest(*[result_pair[i::num_cols] for i in range(num_cols)])
    return _pipe_table(list(row_pair), headers * (num_cols // len(headers)))


def _synchronize(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


class _StreamEvaluatorBase:
    """Shared loop: iterate the val loader, run the forward and the
    fixed-shape postprocess, convert to COCO rows, run COCOeval."""

    def __init__(self, dataloader, img_size, confthre: float, nmsthre: float,
                 num_classes: int, testdev: bool = False, per_class_AP: bool = False):
        self.dataloader = dataloader
        self.img_size = img_size
        self.confthre = confthre
        self.nmsthre = nmsthre
        self.num_classes = num_classes
        self.testdev = testdev
        self.per_class_AP = per_class_AP

    @property
    def dataset(self):
        ds = self.dataloader.dataset
        while hasattr(ds, "dataset"):
            ds = ds.dataset
        return ds

    def evaluate(self, forward_fn: Callable, distributed: bool = None, half: bool = False,
                 return_outputs: bool = False):
        """Run the whole evaluation.

        ``forward_fn``: NHWC uint8 batch (NumPy) -> decoded predictions
        ``[B, N, 5 + num_classes]`` (obj/cls sigmoided), a tensor on the
        model's device; with ``needs_ids`` it also takes the batch's ids.
        ``distributed``: gather every rank's detections before COCOeval;
        ``None`` means whenever a process group of more than one rank is
        up (sharded data without the gather would score each rank's shard
        alone). Off the main process it returns ``(0.0, 0.0, None)``."""
        from streamyolo_torch.parallel import (
            all_gather_objects,
            get_world_size,
            is_main_process,
            psum_stats,
        )

        if distributed is None:
            distributed = get_world_size() > 1

        data_list: List[dict] = []
        inference_time = 0.0
        nms_time = 0.0
        n_saturated = 0
        n_samples = max(len(self.dataloader) - 1, 1)

        batch_size = getattr(self.dataloader, "batch_size", None)
        for cur_iter, batch in enumerate(self.dataloader):
            imgs, _, info_imgs, ids = batch
            is_time_iter = cur_iter < len(self.dataloader) - 1

            # pad the last partial batch to the fixed batch size, so every
            # batch runs the same shapes (the padded rows are sliced off)
            n_real = imgs.shape[0]
            if batch_size and n_real < batch_size:
                pad = np.zeros((batch_size - n_real,) + imgs.shape[1:], imgs.dtype)
                imgs = np.concatenate([imgs, pad], axis=0)

            if is_time_iter:
                start = time.perf_counter()
            if getattr(forward_fn, "needs_ids", False):
                preds = forward_fn(imgs, ids)
            else:
                preds = forward_fn(imgs)
            if is_time_iter:
                _synchronize(preds)
                infer_end = time.perf_counter()
                inference_time += infer_end - start
            fixed = postprocess_fixed(preds, self.num_classes, self.confthre, self.nmsthre)
            dets = fixed.cpu().numpy()[:n_real]
            if dets.shape[1] < preds.shape[1]:  # K < anchors: the cap can bite
                n_saturated += int((candidate_counts(dets, self.confthre) >= dets.shape[1]).sum())
            outputs = [
                (row[row[:, 7] > 0.5][:, :7] if (row[:, 7] > 0.5).any() else None)
                for row in dets
            ]
            if is_time_iter:
                nms_time += time.perf_counter() - infer_end
            data_list.extend(self.convert_to_coco_format(outputs, info_imgs, ids))

        if n_saturated:
            get_logger().warning(
                "pre-NMS candidate selection saturated on %d image(s) at conf "
                "%.4g (the reference NMS is uncapped); rerun with a larger "
                "pre_nms_topk if the COCO rows matter at this density",
                n_saturated, self.confthre)
        statistics = np.array([inference_time, nms_time, n_samples])
        if distributed:
            data_list = list(itertools.chain(*all_gather_objects(data_list)))
            statistics = psum_stats(statistics)
        if distributed and not is_main_process():
            self._set_times(statistics)
            eval_results = (0.0, 0.0, None)
        else:
            eval_results = self.evaluate_prediction(data_list, statistics)
        if return_outputs:
            return eval_results, data_list
        return eval_results

    def _scale_boxes(self, output, img_h, img_w):
        bboxes = output[:, 0:4].copy()
        scale = min(self.img_size[0] / float(img_h), self.img_size[1] / float(img_w))
        bboxes /= scale
        bboxes[:, 2] = bboxes[:, 2] - bboxes[:, 0]  # xyxy -> ltwh
        bboxes[:, 3] = bboxes[:, 3] - bboxes[:, 1]
        return bboxes

    def convert_to_coco_format(self, outputs, info_imgs, ids):
        raise NotImplementedError

    def _set_times(self, statistics) -> None:
        """``last_times_ms``: the forward and NMS meters per image in ms."""
        inference_time, nms_time, n_samples = statistics
        bs = getattr(self.dataloader, "batch_size", None) or 1
        a_infer_time = 1000 * inference_time / (n_samples * bs)
        a_nms_time = 1000 * nms_time / (n_samples * bs)
        self.last_times_ms = {"forward": a_infer_time, "NMS": a_nms_time,
                              "inference": a_infer_time + a_nms_time}

    def evaluate_prediction(self, data_dict, statistics):
        """(AP, AP50, summary) by the native COCOeval; the timing meters per
        image in ms head the summary."""
        logger = get_logger()
        logger.info("Evaluate in main process...")

        self._set_times(statistics)
        info = ", ".join(f"Average {k} time: {v:.2f} ms"
                         for k, v in self.last_times_ms.items()) + "\n"

        if len(data_dict) > 0:
            cocoGt = self.dataset.coco
            cocoDt = cocoGt.loadRes(data_dict)
            coco_eval = COCOeval_opt(cocoGt, cocoDt, "bbox")
            coco_eval.evaluate()
            coco_eval.accumulate()
            coco_eval.summarize()
            self.last_stats = np.asarray(coco_eval.stats, dtype=np.float64)
            info += str(coco_eval) + "\n"
            if self.per_class_AP:
                from streamyolo_torch.data.argoverse_classes import ARGOVERSE_CLASSES

                info += "per class AP:\n" + per_class_AP_table(
                    coco_eval, ARGOVERSE_CLASSES) + "\n"
            return coco_eval.stats[0], coco_eval.stats[1], info
        return 0.0, 0.0, info


class ONEX_COCOEvaluator(_StreamEvaluatorBase):
    """1x-velocity pseudo-streaming evaluator (image_id shift t -> t+1)."""

    def convert_to_coco_format(self, outputs, info_imgs, ids):
        data_list = []
        images = self.dataset.coco.dataset["images"]
        class_ids = self.dataset.class_ids
        for output, img_h, img_w, img_id in zip(outputs, info_imgs[0], info_imgs[1], ids):
            if output is None:
                continue
            bboxes = self._scale_boxes(output, img_h, img_w)
            cls = output[:, 6]
            scores = output[:, 4] * output[:, 5]
            img_id = int(np.asarray(img_id).reshape(-1)[0])

            for ind in range(bboxes.shape[0]):
                label = class_ids[int(cls[ind])]
                # the reference's rules; the +1 bound guard cannot trigger on
                # Argoverse val (the hard-coded ids cover its tail) but keeps
                # other datasets in range
                if img_id in (15060, 15061) or img_id + 1 >= len(images):
                    continue
                elif images[img_id + 1]["fid"] == 0:
                    continue
                elif images[img_id]["fid"] == 0:
                    # the reference assigns an id here but never appends
                    continue
                else:
                    data_list.append({
                        "image_id": img_id + 1,
                        "category_id": label,
                        "bbox": bboxes[ind].tolist(),
                        "score": float(scores[ind]),
                        "segmentation": [],
                    })
        return data_list


class TWOX_COCOEvaluator(_StreamEvaluatorBase):
    """2x-velocity evaluator (shift t -> t+2, wider boundary skips)."""

    def convert_to_coco_format(self, outputs, info_imgs, ids):
        data_list = []
        images = self.dataset.coco.dataset["images"]
        class_ids = self.dataset.class_ids
        n_images = len(images)
        for output, img_h, img_w, img_id in zip(outputs, info_imgs[0], info_imgs[1], ids):
            if output is None:
                continue
            bboxes = self._scale_boxes(output, img_h, img_w)
            cls = output[:, 6]
            scores = output[:, 4] * output[:, 5]
            img_id = int(np.asarray(img_id).reshape(-1)[0])

            for ind in range(bboxes.shape[0]):
                label = class_ids[int(cls[ind])]
                # the fid 0 / 1 branches of the reference never append
                if img_id in (15060, 15061) or img_id + 2 >= n_images:
                    continue
                elif images[img_id + 1]["fid"] == 0:
                    continue
                elif images[img_id + 2]["fid"] == 0:
                    continue
                elif images[img_id]["fid"] in (0, 1):
                    continue
                else:
                    data_list.append({
                        "image_id": img_id + 2,
                        "category_id": label,
                        "bbox": bboxes[ind].tolist(),
                        "score": float(scores[ind]),
                        "segmentation": [],
                    })
        return data_list


class STILL_COCOEvaluator(_StreamEvaluatorBase):
    """Plain COCO evaluator, no id shift."""

    def convert_to_coco_format(self, outputs, info_imgs, ids):
        data_list = []
        class_ids = self.dataset.class_ids
        for output, img_h, img_w, img_id in zip(outputs, info_imgs[0], info_imgs[1], ids):
            if output is None:
                continue
            bboxes = self._scale_boxes(output, img_h, img_w)
            cls = output[:, 6]
            scores = output[:, 4] * output[:, 5]
            img_id = int(np.asarray(img_id).reshape(-1)[0])
            for ind in range(bboxes.shape[0]):
                data_list.append({
                    "image_id": img_id,
                    "category_id": class_ids[int(cls[ind])],
                    "bbox": bboxes[ind].tolist(),
                    "score": float(scores[ind]),
                    "segmentation": [],
                })
        return data_list
