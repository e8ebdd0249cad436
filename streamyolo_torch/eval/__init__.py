from streamyolo_torch.eval.cocoeval import COCOeval, Params, bbox_iou_xywh
from streamyolo_torch.eval.cocoeval_ext import COCOeval_opt, evaluator_class
from streamyolo_torch.eval.evaluators import (
    ONEX_COCOEvaluator,
    STILL_COCOEvaluator,
    TWOX_COCOEvaluator,
    per_class_AP_table,
)
from streamyolo_torch.eval.seq_forward import SequentialDedupForward, support_shifts

__all__ = ["COCOeval", "COCOeval_opt", "ONEX_COCOEvaluator", "Params",
           "STILL_COCOEvaluator", "SequentialDedupForward", "TWOX_COCOEvaluator",
           "bbox_iou_xywh", "evaluator_class", "per_class_AP_table", "support_shifts"]
