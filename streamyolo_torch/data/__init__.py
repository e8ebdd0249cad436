from streamyolo_torch.data.argoverse_classes import ARGOVERSE_CLASSES, COCO_SUBSET
from streamyolo_torch.data.coco import COCO
from streamyolo_torch.data.datasets import (
    ONE_ARGOVERSEDataset,
    STILL_ARGOVERSEDataset,
    TWO_ARGOVERSEDataset,
    imread,
)
from streamyolo_torch.data.dbcode import (
    SyntheticArgoverse,
    db_from_img_folder,
    make_synthetic_argoverse,
    pseudo_gt_from_detections,
)
from streamyolo_torch.data.loader import (
    DataLoader,
    DevicePrefetcher,
    InfiniteSampler,
    ShardDataset,
    YoloBatchSampler,
    worker_init_reset_seed,
)
from streamyolo_torch.data.mosaic import MosaicDetection, StillMosaicDetection
from streamyolo_torch.data.transforms import (
    DoubleTrainTransform,
    DoubleValTransform,
    TrainTransform,
    ValTransform,
    preproc,
)

__all__ = ["ARGOVERSE_CLASSES", "COCO", "COCO_SUBSET", "DataLoader", "DevicePrefetcher",
           "DoubleTrainTransform", "DoubleValTransform", "InfiniteSampler", "MosaicDetection",
           "ONE_ARGOVERSEDataset", "STILL_ARGOVERSEDataset", "ShardDataset",
           "StillMosaicDetection",
           "SyntheticArgoverse", "TWO_ARGOVERSEDataset", "TrainTransform", "ValTransform",
           "YoloBatchSampler", "db_from_img_folder", "imread", "make_synthetic_argoverse",
           "preproc", "pseudo_gt_from_detections", "worker_init_reset_seed"]
