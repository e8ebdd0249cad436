"""Argoverse-HD class names and their indices in the 80-class COCO list: the
port's own copy of ``streamyolo_tpu/data/argoverse_classes.py``."""

ARGOVERSE_CLASSES = (
    "person",
    "bicycle",
    "car",
    "motorcycle",
    "bus",
    "truck",
    "traffic_light",
    "stop_sign",
)

# Indices of the 8 Argoverse-HD classes inside the 80-class COCO list.
COCO_SUBSET = (0, 1, 2, 3, 5, 7, 9, 11)
