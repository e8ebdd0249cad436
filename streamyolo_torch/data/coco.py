"""Minimal COCO-format annotation index (the pycocotools API subset the
streaming harness reads): the port's own copy of
``streamyolo_tpu/data/coco.py``.

``COCO(path_or_dict)``, ``.dataset``, ``.cats``, ``.imgs``, ``.anns``,
``getImgIds``, ``getCatIds``, ``getAnnIds(imgIds=, catIds=, iscrowd=)``,
``loadImgs``, ``loadAnns``, ``loadCats``, ``loadRes(results)``, with
pycocotools semantics. Boxes only: Argoverse-HD has no masks.
"""

from __future__ import annotations

import copy
import json
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Union


def _as_list(x) -> list:
    return list(x) if isinstance(x, (list, tuple)) else [x]


class COCO:
    def __init__(self, annotation: Union[str, Dict[str, Any], None] = None):
        self.dataset: Dict[str, Any] = {}
        self.anns: Dict[int, dict] = {}
        self.imgs: Dict[int, dict] = {}
        self.cats: Dict[int, dict] = {}
        self.img_to_anns: Dict[int, List[dict]] = defaultdict(list)
        self.cat_to_imgs: Dict[int, List[int]] = defaultdict(list)
        if annotation is not None:
            if isinstance(annotation, str):
                with open(annotation) as f:
                    self.dataset = json.load(f)
            else:
                self.dataset = annotation
            self.create_index()

    # pycocotools naming kept for drop-in compatibility.
    def create_index(self):
        self.img_to_anns = defaultdict(list)
        self.cat_to_imgs = defaultdict(list)
        for ann in self.dataset.get("annotations", []):
            self.img_to_anns[ann["image_id"]].append(ann)
            self.anns[ann["id"]] = ann
        for img in self.dataset.get("images", []):
            self.imgs[img["id"]] = img
        for cat in self.dataset.get("categories", []):
            self.cats[cat["id"]] = cat
        for ann in self.dataset.get("annotations", []):
            if "category_id" in ann:
                self.cat_to_imgs[ann["category_id"]].append(ann["image_id"])

    def getImgIds(self, imgIds=(), catIds=()) -> List[int]:
        imgIds, catIds = _as_list(imgIds), _as_list(catIds)
        if not imgIds and not catIds:
            ids = set(self.imgs.keys())
        else:
            ids = set(imgIds) if imgIds else set()
            for i, cat_id in enumerate(catIds):
                imgs = set(self.cat_to_imgs[cat_id])
                ids = imgs if (i == 0 and not ids) else ids & imgs
        return sorted(ids)

    def getCatIds(self, catNms=(), supNms=(), catIds=()) -> List[int]:
        catNms, supNms, catIds = map(_as_list, (catNms, supNms, catIds))
        cats = list(self.dataset.get("categories", []))
        if catNms:
            cats = [c for c in cats if c["name"] in catNms]
        if supNms:
            cats = [c for c in cats if c.get("supercategory") in supNms]
        if catIds:
            cats = [c for c in cats if c["id"] in catIds]
        return [c["id"] for c in cats]

    def getAnnIds(
        self,
        imgIds=(),
        catIds=(),
        areaRng=(),
        iscrowd: Optional[bool] = None,
    ) -> List[int]:
        imgIds, catIds, areaRng = map(_as_list, (imgIds, catIds, areaRng))
        if imgIds:
            anns: List[dict] = []
            for img_id in imgIds:
                anns.extend(self.img_to_anns.get(img_id, []))
        else:
            anns = list(self.dataset.get("annotations", []))
        if catIds:
            cat_set = set(catIds)
            anns = [a for a in anns if a["category_id"] in cat_set]
        if areaRng:
            anns = [a for a in anns if areaRng[0] < a["area"] < areaRng[1]]
        if iscrowd is not None:
            anns = [a for a in anns if bool(a.get("iscrowd", 0)) == iscrowd]
        return [a["id"] for a in anns]

    def loadImgs(self, ids) -> List[dict]:
        return [self.imgs[i] for i in _as_list(ids)]

    def loadAnns(self, ids) -> List[dict]:
        return [self.anns[i] for i in _as_list(ids)]

    def loadCats(self, ids) -> List[dict]:
        return [self.cats[i] for i in _as_list(ids)]

    def loadRes(self, results: Union[str, Sequence[dict]]) -> "COCO":
        """A COCO object of detection results (boxes only; pycocotools
        ``loadRes`` semantics: area from the box, ids renumbered from 1,
        images shared with the ground truth)."""
        if isinstance(results, str):
            with open(results) as f:
                results = json.load(f)
        res = COCO()
        res.dataset = {
            "images": list(self.dataset.get("images", [])),
            "categories": copy.deepcopy(self.dataset.get("categories", [])),
        }
        anns = copy.deepcopy(list(results))
        for i, ann in enumerate(anns):
            x, y, w, h = ann["bbox"]
            ann.setdefault("area", w * h)
            ann["id"] = i + 1
            ann.setdefault("iscrowd", 0)
        res.dataset["annotations"] = anns
        res.create_index()
        return res
