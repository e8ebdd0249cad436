from streamyolo_torch.eval.cocoeval import COCOeval, Params, bbox_iou_xywh
from streamyolo_torch.eval.cocoeval_ext import COCOeval_opt, evaluator_class

__all__ = ["COCOeval", "COCOeval_opt", "Params", "bbox_iou_xywh", "evaluator_class"]
