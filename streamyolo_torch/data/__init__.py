from streamyolo_torch.data.argoverse_classes import ARGOVERSE_CLASSES, COCO_SUBSET
from streamyolo_torch.data.coco import COCO
from streamyolo_torch.data.dbcode import (
    SyntheticArgoverse,
    db_from_img_folder,
    make_synthetic_argoverse,
    pseudo_gt_from_detections,
)

__all__ = ["ARGOVERSE_CLASSES", "COCO", "COCO_SUBSET", "SyntheticArgoverse",
           "db_from_img_folder", "make_synthetic_argoverse",
           "pseudo_gt_from_detections"]
