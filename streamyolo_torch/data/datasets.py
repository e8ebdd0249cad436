"""Argoverse-HD streaming datasets (ONE_ / TWO_ / STILL_), the counterparts
of ``streamyolo_tpu/data/datasets.py``.

  * ``ONE_ARGOVERSEDataset``: each sample is the (current, support = t-1)
    frame pair; the target is the labels of frame t+1 (the model predicts
    the future) and the support target the current frame's labels.
  * ``TWO_ARGOVERSEDataset``: support t-2, target t+2.
  * ``STILL_ARGOVERSEDataset``: one frame, its own labels.

The boundary rules are the JAX package's, quirks included: the pairing
falls back to self-support at sequence starts and ends, and the LAST TWO
images of the whole dataset query the annotations of the non-existent image
id ``len(ids)`` and so get EMPTY targets. Image ids are assumed consecutive
from 0 and equal to the dataset index.

Pixels come through ``load_frame(image_dict) -> BGR uint8``: by default
``imread`` of ``<data_dir>/Argoverse-1.1/tracking/<seq_dir>/<name>``
(``data/image_io.py``, the native JPEG decoder, equal to ``cv2.imread``; no
cv2), or e.g. ``SyntheticArgoverse.frame`` for frames kept in memory. The
annotation tuples hold the image dicts where the JAX package holds file
names. ``input_dim`` is the mutable letterbox size of the
transforms (the yolox ``Dataset.input_dim`` indirection); frames are read
resized to ``img_size``.

``cache=True`` (``--cache``) keeps every frame, read and resized once, in a
uint8 memmap ``<data_dir>/img_resized_cache_<name>.array`` of shape
``[len, img_size[0], img_size[1], 3]``, each frame at the top-left of its
row: the JAX package's file, byte for byte. An existing file is reused as
it stands. Items are then read from the memmap (the pair datasets read the
support frame from its own row).
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import numpy as np

from streamyolo_torch.data.coco import COCO
from streamyolo_torch.data.cv2_ops import resize_u8
from streamyolo_torch.data.image_io import imread


class _ArgoverseBase:
    """Shared COCO-index plumbing. ``img_size`` is (height, width)."""

    def __init__(
        self,
        data_dir: str,
        json_file: str = "train.json",
        name: str = "train",
        img_size: Tuple[int, int] = (416, 416),
        preproc=None,
        load_frame: Optional[Callable[[dict], np.ndarray]] = None,
        cache: bool = False,
    ):
        self.data_dir = data_dir
        self.json_file = json_file
        self.coco = COCO(os.path.join(data_dir, "Argoverse-HD", "annotations", json_file))
        self.ids = self.coco.getImgIds()
        self.seq_dirs = self.coco.dataset["seq_dirs"]
        self.class_ids = sorted(self.coco.getCatIds())
        self.name = name
        self.img_size = tuple(img_size)
        self._input_dim = self.img_size
        self.enable_mosaic = False
        self.preproc = preproc
        self.load_frame = load_frame or self._imread
        # the support frame's dataset index per id (filled by the pair
        # datasets' _load_anno_from_id): the cache serves it from its row
        self._support_idx = {}
        self.annotations = [self._load_anno_from_id(i) for i in self.ids]
        self.imgs = None
        if cache:
            self._cache_images()

    @property
    def input_dim(self):
        return self._input_dim

    @input_dim.setter
    def input_dim(self, dim):
        self._input_dim = tuple(dim)

    def __len__(self):
        return len(self.ids)

    def _clean_objs(self, annotations, width, height) -> np.ndarray:
        """COCO anns -> [n, 5] (x1, y1, x2, y2, cls) clipped, then scaled by
        the letterbox ratio."""
        objs = []
        for obj in annotations:
            x1 = max(0, obj["bbox"][0])
            y1 = max(0, obj["bbox"][1])
            x2 = min(width - 1, x1 + max(0, obj["bbox"][2]))
            y2 = min(height - 1, y1 + max(0, obj["bbox"][3]))
            if obj["area"] > 0 and x2 >= x1 and y2 >= y1:
                objs.append((x1, y1, x2, y2, self.class_ids.index(obj["category_id"])))
        res = np.zeros((len(objs), 5), dtype=np.float64)
        for ix, o in enumerate(objs):
            res[ix] = o
        r = min(self.img_size[0] / height, self.img_size[1] / width)
        res[:, :4] *= r
        return res

    def _anns_of(self, img_id: int):
        return self.coco.loadAnns(self.coco.getAnnIds(imgIds=[int(img_id)], iscrowd=False))

    def _file_name(self, im_ann) -> str:
        return os.path.join(self.data_dir, "Argoverse-1.1", "tracking",
                            self.seq_dirs[im_ann["sid"]], im_ann["name"])

    def _imread(self, im_ann) -> np.ndarray:
        return imread(self._file_name(im_ann))

    def load_anno(self, index):
        return self.annotations[index][0]

    def _read_resized(self, im_ann) -> np.ndarray:
        img = self.load_frame(im_ann)
        r = min(self.img_size[0] / img.shape[0], self.img_size[1] / img.shape[1])
        return resize_u8(img, int(img.shape[0] * r), int(img.shape[1] * r))

    _IM_ANN_SLOT = 4  # where an annotation tuple holds its image dict

    def _cache_images(self):
        max_h, max_w = int(self.img_size[0]), int(self.img_size[1])
        cache_file = os.path.join(self.data_dir, f"img_resized_cache_{self.name}.array")
        shape = (len(self.ids), max_h, max_w, 3)
        if not os.path.exists(cache_file):
            imgs = np.memmap(cache_file, shape=shape, dtype=np.uint8, mode="w+")
            for i in range(len(self.ids)):
                img = self._read_resized(self.annotations[i][self._IM_ANN_SLOT])
                imgs[i, : img.shape[0], : img.shape[1]] = img
            imgs.flush()
            del imgs
        self.imgs = np.memmap(cache_file, shape=shape, dtype=np.uint8, mode="r+")

    def _cached_img(self, index) -> np.ndarray:
        h, w = self.annotations[index][self._IM_ANN_SLOT - 1]  # the resized size
        return self.imgs[index][:h, :w].copy()


class ONE_ARGOVERSEDataset(_ArgoverseBase):
    """1x velocity: support frame t-1, target labels t+1."""

    def _load_anno_from_id(self, id_):
        im_ann = self.coco.loadImgs(id_)[0]
        width, height = im_ann["width"], im_ann["height"]
        images = self.coco.dataset["images"]
        seq_len = len(self.ids)

        if images[int(id_)]["fid"] == 0:
            im_ann_support = im_ann
        elif int(id_) == seq_len - 1:
            im_ann_support = im_ann
        elif images[int(id_ + 1)]["fid"] == 0:
            im_ann_support = im_ann
        else:
            im_ann_support = self.coco.loadImgs(id_ - 1)[0]
        self._support_idx[int(id_)] = int(im_ann_support["id"])

        if id_ in (seq_len - 1, seq_len - 2):
            annotations = self.coco.img_to_anns.get(int(seq_len), [])
        elif images[int(id_)]["fid"] == 0:
            annotations = self._anns_of(id_)
        elif images[int(id_ + 1)]["fid"] == 0:
            annotations = self._anns_of(id_)
        else:
            annotations = self._anns_of(id_ + 1)

        res = self._clean_objs(annotations, width, height)
        support_res = self._clean_objs(self._anns_of(id_), width, height)
        r = min(self.img_size[0] / height, self.img_size[1] / width)
        return (res, support_res, (height, width), (int(height * r), int(width * r)),
                im_ann, im_ann_support)

    def pull_item(self, index):
        id_ = self.ids[index]
        res, support_res, img_info, _, im_ann, im_ann_support = self.annotations[index]
        if self.imgs is not None:
            img = self._cached_img(index)
            support_img = self._cached_img(self._support_idx[int(id_)])
        else:
            img = self._read_resized(im_ann)
            support_img = self._read_resized(im_ann_support)
        return img, support_img, res.copy(), support_res.copy(), img_info, np.array([id_])

    def __getitem__(self, index):
        img, support_img, target, support_target, img_info, img_id = self.pull_item(index)
        if self.preproc is not None:
            img, support_img, target, support_target = self.preproc(
                (img, support_img), (target, support_target), self.input_dim)
        return (np.concatenate((img, support_img), axis=-1), (target, support_target),
                img_info, img_id)


class TWO_ARGOVERSEDataset(ONE_ARGOVERSEDataset):
    """2x velocity: support frame t-2, target labels t+2."""

    def _load_anno_from_id(self, id_):
        im_ann = self.coco.loadImgs(id_)[0]
        width, height = im_ann["width"], im_ann["height"]
        images = self.coco.dataset["images"]
        seq_len = len(self.ids)

        if images[int(id_)]["fid"] == 0:
            im_ann_support = im_ann
        elif images[int(id_)]["fid"] == 1:
            im_ann_support = self.coco.loadImgs(id_ - 1)[0]
        elif int(id_) == seq_len - 1:
            im_ann_support = im_ann
        elif int(id_ + 1) == seq_len - 1:
            im_ann_support = self.coco.loadImgs(id_ - 1)[0]
        elif images[int(id_ + 1)]["fid"] == 0:
            im_ann_support = im_ann
        elif images[int(id_ + 2)]["fid"] == 0:
            im_ann_support = self.coco.loadImgs(id_ - 1)[0]
        else:
            im_ann_support = self.coco.loadImgs(id_ - 2)[0]
        self._support_idx[int(id_)] = int(im_ann_support["id"])

        if id_ in (seq_len - 1, seq_len - 2):
            annotations = self.coco.img_to_anns.get(int(seq_len), [])
        elif images[int(id_)]["fid"] == 0:
            annotations = self._anns_of(id_)
        elif images[int(id_)]["fid"] == 1:
            annotations = self._anns_of(id_ + 1)
        elif images[int(id_ + 1)]["fid"] == 0:
            annotations = self._anns_of(id_)
        elif images[int(id_ + 2)]["fid"] == 0:
            annotations = self._anns_of(id_ + 1)
        else:
            annotations = self._anns_of(id_ + 2)

        res = self._clean_objs(annotations, width, height)
        support_res = self._clean_objs(self._anns_of(id_), width, height)
        r = min(self.img_size[0] / height, self.img_size[1] / width)
        return (res, support_res, (height, width), (int(height * r), int(width * r)),
                im_ann, im_ann_support)


class STILL_ARGOVERSEDataset(_ArgoverseBase):
    """Single-frame dataset: labels of frame t."""

    _IM_ANN_SLOT = 3

    def _load_anno_from_id(self, id_):
        im_ann = self.coco.loadImgs(id_)[0]
        width, height = im_ann["width"], im_ann["height"]
        res = self._clean_objs(self._anns_of(id_), width, height)
        r = min(self.img_size[0] / height, self.img_size[1] / width)
        return res, (height, width), (int(height * r), int(width * r)), im_ann

    def pull_item(self, index):
        id_ = self.ids[index]
        res, img_info, _, im_ann = self.annotations[index]
        img = self._cached_img(index) if self.imgs is not None else self._read_resized(im_ann)
        return img, res.copy(), img_info, np.array([id_])

    def __getitem__(self, index):
        img, target, img_info, img_id = self.pull_item(index)
        if self.preproc is not None:
            img, target = self.preproc(img, target, self.input_dim)
        return img, target, img_info, img_id
