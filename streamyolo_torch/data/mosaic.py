"""The mosaic dataset wrappers, the counterparts of
``streamyolo_tpu/data/mosaic.py``: ``MosaicDetection`` (the ONE / TWO
pair datasets) and ``StillMosaicDetection`` (STILL), with the JAX
package's constructor surface.

With probability ``mosaic_prob`` (while ``enable_mosaic``) an item is a
mosaic: four samples fitted into the quadrants of a 2x grey canvas around a
random centre, then warped by ``random_perspective`` back to the input size.
The pair wrapper builds the support frame's mosaic with the same geometry
(the warp is replayed from the saved ``random`` state); the STILL wrapper
then blends in a fifth, donor sample at half opacity (the CopyPaste mixup)
with probability ``mixup_prob``. Otherwise the item is the wrapped
dataset's ``pull_item`` through the train transform at ``input_dim``.

Everything runs on the host in the loader workers, with no cv2
(``data/cv2_ops.py``: NumPy, the resize native), and equal to the JAX package's cv2 output bit for
bit. The order of the ``random`` draws and the float32 box arithmetic are
the JAX package's, which ``tests/golden/mosaic_golden.npz`` pins.
"""

from __future__ import annotations

import random

import numpy as np

from streamyolo_torch.data.cv2_ops import resize_u8
from streamyolo_torch.data.transforms import box_candidates, random_perspective
from streamyolo_torch.ops.boxes import adjust_box_anns


def _axis_span(center, extent, limit, forward):
    """One axis of one mosaic quadrant: destination ``[lo, hi)`` on the 2x
    canvas plus the matching source-crop span.

    A tile is anchored at the shared center and grows either backward
    (toward 0) or forward (toward ``limit``). Whatever falls off the canvas
    is trimmed from the tile's far-from-center side, so the source crop of a
    backward tile keeps its trailing ``hi - lo`` pixels and a forward tile
    its leading ones.
    """
    if forward:
        lo, hi = center, min(center + extent, limit)
        return lo, hi, 0, hi - lo
    lo, hi = max(center - extent, 0), center
    return lo, hi, extent - (hi - lo), extent


def get_mosaic_coordinate(quadrant, xc, yc, w, h, input_h, input_w):
    """Paste rectangle on the 2x canvas + source crop for quadrant 0..3
    (row-major: top-left, top-right, bottom-left, bottom-right), for a
    ``w x h`` tile anchored at the shared center ``(xc, yc)``."""
    dx1, dx2, sx1, sx2 = _axis_span(xc, w, 2 * input_w, forward=quadrant % 2 == 1)
    dy1, dy2, sy1, sy2 = _axis_span(yc, h, 2 * input_h, forward=quadrant >= 2)
    return (dx1, dy1, dx2, dy2), (sx1, sy1, sx2, sy2)


def _fit_to_box(img, box_h, box_w):
    """Aspect-preserving resize so ``img`` fits inside a ``box_h x box_w``
    box; returns the resized image and the ratio applied."""
    h0, w0 = img.shape[:2]
    ratio = min(box_h / h0, box_w / w0)
    return resize_u8(img, int(h0 * ratio), int(w0 * ratio)), ratio


class _MosaicBase:
    def __init__(
        self, dataset, img_size, mosaic=True, preproc=None,
        degrees=10.0, translate=0.1, scale=(0.5, 1.5), mscale=(0.5, 1.5),
        shear=2.0, perspective=0.0, enable_mixup=True,
        mosaic_prob=1.0, mixup_prob=1.0, *args,
    ):
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

    # input_dim indirection forwarded to the wrapped dataset
    @property
    def input_dim(self):
        return self._dataset.input_dim

    @input_dim.setter
    def input_dim(self, dim):
        self._dataset.input_dim = dim

    def __len__(self):
        return len(self._dataset)

    def _compose_tiles(self, tiles, input_h, input_w, yc, xc):
        """Paste 4 ``(image, xyxy+cls boxes)`` tiles around the center
        ``(xc, yc)`` of a gray 2x canvas; shift each tile's boxes by its
        paste-origin-minus-crop-origin and clip the lot to the canvas."""
        canvas = None
        placed = []
        for quadrant, (img, boxes) in enumerate(tiles):
            img, ratio = _fit_to_box(img, input_h, input_w)
            if canvas is None:
                canvas = np.full(
                    (2 * input_h, 2 * input_w, img.shape[2]), 114, np.uint8
                )
            tile_h, tile_w = img.shape[:2]
            (dx1, dy1, dx2, dy2), (sx1, sy1, sx2, sy2) = get_mosaic_coordinate(
                quadrant, xc, yc, tile_w, tile_h, input_h, input_w
            )
            canvas[dy1:dy2, dx1:dx2] = img[sy1:sy2, sx1:sx2]

            boxes = boxes.copy()
            if boxes.size > 0:
                # stay in the boxes' own dtype: float32 labels see float32
                # arithmetic, as in the JAX package (the golden pins it)
                shift = np.asarray(
                    [dx1 - sx1, dy1 - sy1] * 2, dtype=boxes.dtype
                )
                boxes[:, :4] = boxes[:, :4] * ratio + shift
            placed.append(boxes)

        boxes = np.concatenate(placed, 0)
        np.clip(
            boxes[:, :4], 0,
            np.asarray([2 * input_w, 2 * input_h] * 2, dtype=boxes.dtype),
            out=boxes[:, :4],
        )
        return canvas, boxes

    def mixup(self, base_img, base_labels, input_dim, pull_single):
        """Blend one donor sample into the mosaic at half opacity and append
        its surviving boxes (CopyPaste style).

        The order of ``random`` draws is the JAX package's (the golden pins
        it): zoom factor, flip coin, donor index (drawn again until the
        donor has boxes), then the vertical and horizontal crop offsets.
        """
        zoom = random.uniform(*self.mixup_scale)
        flipped = random.uniform(0, 1) > 0.5

        donor_boxes = []
        while len(donor_boxes) == 0:
            donor_idx = random.randint(0, len(self) - 1)
            _, donor_boxes = pull_single(donor_idx)
        donor_img, donor_boxes = pull_single(donor_idx)

        # Letterbox the donor onto a gray canvas at the nominal input size,
        # then zoom the WHOLE canvas: zooming after padding means the gray
        # border scales with the image, so one ratio maps donor-pixel
        # coordinates onto the zoomed canvas.
        if donor_img.ndim == 3:
            canvas = np.full((input_dim[0], input_dim[1], 3), 114, np.uint8)
        else:
            canvas = np.full(input_dim, 114, np.uint8)
        ratio = min(
            input_dim[0] / donor_img.shape[0], input_dim[1] / donor_img.shape[1]
        )
        fitted = resize_u8(donor_img, int(donor_img.shape[0] * ratio),
                           int(donor_img.shape[1] * ratio))
        canvas[: fitted.shape[0], : fitted.shape[1]] = fitted
        canvas = resize_u8(canvas, int(canvas.shape[0] * zoom), int(canvas.shape[1] * zoom))
        ratio *= zoom
        if flipped:
            canvas = canvas[:, ::-1, :]
        src_h, src_w = canvas.shape[:2]

        # Cut a base-sized window out of the zoomed canvas at a random
        # position; on axes where the canvas is smaller than the base the
        # window is instead zero-padded below/right of it.
        dst_h, dst_w = base_img.shape[:2]
        frame = np.zeros((max(src_h, dst_h), max(src_w, dst_w), 3), np.uint8)
        frame[:src_h, :src_w] = canvas
        dy = random.randint(0, src_h - dst_h - 1) if src_h > dst_h else 0
        dx = random.randint(0, src_w - dst_w - 1) if src_w > dst_w else 0
        window = frame[dy : dy + dst_h, dx : dx + dst_w]

        # Map the donor's boxes through the same zoom / flip / crop chain;
        # keep only boxes that survive the crop non-degenerately.
        zoomed_boxes = adjust_box_anns(
            donor_boxes[:, :4].copy(), ratio, 0, 0, src_w, src_h
        )
        if flipped:
            zoomed_boxes[:, [0, 2]] = src_w - zoomed_boxes[:, [2, 0]]
        cropped_boxes = zoomed_boxes.copy()
        cropped_boxes[:, 0::2] = np.clip(cropped_boxes[:, 0::2] - dx, 0, dst_w)
        cropped_boxes[:, 1::2] = np.clip(cropped_boxes[:, 1::2] - dy, 0, dst_h)
        keep = box_candidates(zoomed_boxes.T, cropped_boxes.T, 5)

        if keep.any():
            appended = np.hstack((cropped_boxes[keep], donor_boxes[keep, 4:5]))
            base_labels = np.vstack((base_labels, appended))
            base_img = 0.5 * base_img.astype(np.float32) + 0.5 * window.astype(
                np.float32
            )
        return base_img.astype(np.uint8), base_labels


class MosaicDetection(_MosaicBase):
    """Wrapper of the pair (ONE_ / TWO_) datasets: the 6-channel image
    (current ++ support), the label pair, ``img_info`` and the id. Its
    mosaic branch has no mixup, as in the JAX package."""

    def __getitem__(self, idx):
        if self.enable_mosaic and random.random() < self.mosaic_prob:
            input_dim = self._dataset.input_dim
            input_h, input_w = input_dim[0], input_dim[1]
            yc = int(random.uniform(0.5 * input_h, 1.5 * input_h))
            xc = int(random.uniform(0.5 * input_w, 1.5 * input_w))
            indices = [idx] + [
                random.randint(0, len(self._dataset) - 1) for _ in range(3)
            ]

            cur_tiles, sup_tiles = [], []
            for index in indices:
                img, sup_img, label, sup_label, _, _ = self._dataset.pull_item(index)
                cur_tiles.append((img, label))
                sup_tiles.append((sup_img, sup_label))

            # The SAME mosaic geometry for both frames keeps the temporal
            # pair consistent (the augmentation analogue of the shared flip).
            rng_state = random.getstate()
            mosaic_img, mosaic_labels = self._compose_tiles(
                cur_tiles, input_h, input_w, yc, xc
            )
            sup_mosaic_img, sup_mosaic_labels = self._compose_tiles(
                sup_tiles, input_h, input_w, yc, xc
            )

            random.setstate(rng_state)
            mosaic_img, mosaic_labels = random_perspective(
                mosaic_img, mosaic_labels,
                degrees=self.degrees, translate=self.translate, scale=self.scale,
                shear=self.shear, perspective=self.perspective,
                border=[-input_h // 2, -input_w // 2],
            )
            random.setstate(rng_state)
            sup_mosaic_img, sup_mosaic_labels = random_perspective(
                sup_mosaic_img, sup_mosaic_labels,
                degrees=self.degrees, translate=self.translate, scale=self.scale,
                shear=self.shear, perspective=self.perspective,
                border=[-input_h // 2, -input_w // 2],
            )

            img, sup_img, label, sup_label = self.preproc(
                (mosaic_img, sup_mosaic_img),
                (mosaic_labels, sup_mosaic_labels),
                self.input_dim,
            )
            img_info = (img.shape[0], img.shape[1])
            return (
                np.concatenate((img, sup_img), axis=-1),
                (label, sup_label),
                img_info,
                np.array([idx]),
            )

        self._dataset.input_dim = self.input_dim
        img, support_img, label, support_label, img_info, id_ = self._dataset.pull_item(idx)
        img, support_img, label, support_label = self.preproc(
            (img, support_img), (label, support_label), self.input_dim
        )
        return (
            np.concatenate((img, support_img), axis=-1),
            (label, support_label),
            img_info,
            id_,
        )


class StillMosaicDetection(_MosaicBase):
    """Wrapper of the single-frame STILL dataset: mosaic, then the mixup."""

    def __getitem__(self, idx):
        if self.enable_mosaic and random.random() < self.mosaic_prob:
            input_dim = self._dataset.input_dim
            input_h, input_w = input_dim[0], input_dim[1]
            yc = int(random.uniform(0.5 * input_h, 1.5 * input_h))
            xc = int(random.uniform(0.5 * input_w, 1.5 * input_w))
            indices = [idx] + [
                random.randint(0, len(self._dataset) - 1) for _ in range(3)
            ]
            tiles = []
            for index in indices:
                img, label, _, _ = self._dataset.pull_item(index)
                tiles.append((img, label))
            mosaic_img, mosaic_labels = self._compose_tiles(
                tiles, input_h, input_w, yc, xc
            )
            mosaic_img, mosaic_labels = random_perspective(
                mosaic_img, mosaic_labels,
                degrees=self.degrees, translate=self.translate, scale=self.scale,
                shear=self.shear, perspective=self.perspective,
                border=[-input_h // 2, -input_w // 2],
            )
            if (
                self.enable_mixup
                and not len(mosaic_labels) == 0
                and random.random() < self.mixup_prob
            ):
                mosaic_img, mosaic_labels = self.mixup(
                    mosaic_img, mosaic_labels, self.input_dim,
                    lambda i: self._dataset.pull_item(i)[:2],
                )
            mix_img, padded_labels = self.preproc(
                mosaic_img, mosaic_labels, self.input_dim
            )
            img_info = (mix_img.shape[1], mix_img.shape[0])
            return mix_img, padded_labels, img_info, np.array([idx])

        self._dataset.input_dim = self.input_dim
        img, label, img_info, id_ = self._dataset.pull_item(idx)
        img, label = self.preproc(img, label, self.input_dim)
        return img, label, img_info, id_
