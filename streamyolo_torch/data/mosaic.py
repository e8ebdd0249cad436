"""The mosaic dataset wrappers, the counterparts of
``streamyolo_tpu/data/mosaic.py``: ``MosaicDetection`` (the ONE / TWO
pair datasets) and ``StillMosaicDetection`` (STILL), with the JAX
package's constructor surface.

Only the non-mosaic branch is ported: the item is the wrapped dataset's
``pull_item`` through the train transform at ``input_dim``. The shipped
configs set ``no_aug_epochs = max_epoch``, so the reference trains on this
branch alone. The mosaic / ``random_perspective`` / mixup branch needs
cv2's warps, which the card's machine lacks; asking for it
(``enable_mosaic``) raises until it is ported without cv2.
"""

from __future__ import annotations

import numpy as np

MOSAIC_MESSAGE = ("the mosaic / random_perspective / mixup augmentation is not ported yet "
                  "(ROADMAP queue A item 12, the augmentation path without cv2); train with "
                  "no_aug_epochs = max_epoch, as the shipped configs do")


class _MosaicBase:
    def __init__(self, dataset, img_size, mosaic=True, preproc=None,
                 degrees=10.0, translate=0.1, scale=(0.5, 1.5), mscale=(0.5, 1.5),
                 shear=2.0, perspective=0.0, enable_mixup=True,
                 mosaic_prob=1.0, mixup_prob=1.0, *args):
        self._dataset = dataset
        self.img_size = img_size
        self.preproc = preproc
        self.degrees = degrees
        self.translate = translate
        self.scale = scale
        self.shear = shear
        self.perspective = perspective
        self.mixup_scale = mscale
        self.enable_mosaic = mosaic
        self.enable_mixup = enable_mixup
        self.mosaic_prob = mosaic_prob
        self.mixup_prob = mixup_prob

    # the input_dim indirection, forwarded to the wrapped dataset
    @property
    def input_dim(self):
        return self._dataset.input_dim

    @input_dim.setter
    def input_dim(self, dim):
        self._dataset.input_dim = dim

    def __len__(self):
        return len(self._dataset)

    def _check_no_mosaic(self):
        if self.enable_mosaic:
            raise NotImplementedError(MOSAIC_MESSAGE)


class MosaicDetection(_MosaicBase):
    """Wrapper of the pair (ONE_ / TWO_) datasets: the 6-channel image
    (current ++ support), the label pair, ``img_info`` and the id."""

    def __getitem__(self, idx):
        self._check_no_mosaic()
        img, support_img, label, support_label, img_info, id_ = self._dataset.pull_item(idx)
        img, support_img, label, support_label = self.preproc(
            (img, support_img), (label, support_label), self.input_dim)
        return (np.concatenate((img, support_img), axis=-1), (label, support_label),
                img_info, id_)


class StillMosaicDetection(_MosaicBase):
    """Wrapper of the single-frame STILL dataset."""

    def __getitem__(self, idx):
        self._check_no_mosaic()
        img, label, img_info, id_ = self._dataset.pull_item(idx)
        img, label = self.preproc(img, label, self.input_dim)
        return img, label, img_info, id_
