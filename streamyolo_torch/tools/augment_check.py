#!/usr/bin/env python3
"""Seeded samples of the training augmentation and their SHA-256.

    python -m streamyolo_torch.tools.augment_check [--work DIR]

From a small fixed synthetic dataset (``FIXTURE``, frames rendered in
memory, annotation json under ``--work``), ``collect`` takes seeded items of
the pair wrapper's mosaic with HSV jitter, of the STILL wrapper's mosaic +
mixup with HSV jitter, one ``random_perspective`` through the perspective
warp, and the ``--cache`` memmap; ``digest`` hashes them. The tool prints
one JSON line: the digest, ``AUGMENT_DIGEST`` and whether they are equal
(exit 1 if not).

``collect`` takes the three data modules as arguments, so the same code
runs the port's (no cv2) and, in ``tests/test_torch_augment.py``, the JAX
package's (with cv2 and frames written as PNG): that test holds the two
equal array by array and pins ``AUGMENT_DIGEST``. ``chip_smoke.py``
recomputes the digest on the card's host, which has no cv2, so the bytes
there are held to cv2's.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import random
import sys
import tempfile
from typing import Callable, Dict, Optional, Sequence

import numpy as np

FIXTURE = dict(seq_lens=(4, 3), size=(64, 100), n_objects=3, seed=7)
# not the 2x of the frames: the datasets' letterbox resize is a general one
IMG_SIZE = (40, 56)
# the Exp's augmentation (exp/base.py), mixup on
AUGMENT = dict(degrees=10.0, translate=0.1, scale=(0.1, 2.0), shear=2.0, perspective=0.0)
MIXUP_SCALE = (0.5, 1.5)
N_SAMPLES = 3
AUGMENT_DIGEST = "185ed6a2e18c446246aff6db09195aa566ac07ed86700e39cfe88fea45a4740e"


def write_fixture(root: str):
    """``FIXTURE``'s annotation json as ``train.json`` under ``root`` (frames
    named ``*.png``); returns the ``SyntheticArgoverse`` that renders them."""
    from streamyolo_torch.data.dbcode import SyntheticArgoverse

    synth = SyntheticArgoverse(**FIXTURE)
    for img in synth.data["images"]:
        img["name"] = img["name"].replace(".jpg", ".png")
    ann_dir = os.path.join(root, "Argoverse-HD", "annotations")
    os.makedirs(ann_dir, exist_ok=True)
    with open(os.path.join(ann_dir, "train.json"), "w") as f:
        json.dump(synth.data, f)
    return synth


def collect(root: str, datasets, transforms, mosaic,
            load_frame: Optional[Callable[[dict], np.ndarray]] = None) -> Dict[str, np.ndarray]:
    """The seeded samples, by name, from the fixture under ``root`` through
    the given ``datasets`` / ``transforms`` / ``mosaic`` modules. Builds the
    ``--cache`` memmap ``img_resized_cache_cache.array`` in ``root``."""
    kw = {} if load_frame is None else {"load_frame": load_frame}
    out: Dict[str, np.ndarray] = {}

    pair = mosaic.MosaicDetection(
        datasets.ONE_ARGOVERSEDataset(root, "train.json", img_size=IMG_SIZE, **kw),
        img_size=IMG_SIZE, mosaic=True, enable_mixup=False, mscale=MIXUP_SCALE,
        preproc=transforms.DoubleTrainTransform(max_labels=50, hsv=True, flip=True), **AUGMENT)
    for seed in range(N_SAMPLES):
        random.seed(seed)
        np.random.seed(seed)
        img, (label, support), _, _ = pair[seed % len(pair)]
        out[f"pair_img_{seed}"], out[f"pair_lab_{seed}"] = img, label
        out[f"pair_sup_{seed}"] = support

    still_ds = datasets.STILL_ARGOVERSEDataset(root, "train.json", img_size=IMG_SIZE, **kw)
    still = mosaic.StillMosaicDetection(
        still_ds, img_size=IMG_SIZE, mosaic=True, enable_mixup=True, mixup_prob=1.0,
        mscale=MIXUP_SCALE, preproc=transforms.TrainTransform(max_labels=50, hsv=True, flip=True),
        **AUGMENT)
    for seed in range(N_SAMPLES):
        random.seed(100 + seed)
        np.random.seed(100 + seed)
        img, label, _, _ = still[seed % len(still)]
        out[f"still_img_{seed}"], out[f"still_lab_{seed}"] = img, label

    random.seed(200)
    img, targets, _, _ = still_ds.pull_item(1)
    img, targets = transforms.random_perspective(
        img, targets, degrees=10.0, translate=0.1, scale=(0.5, 1.5), shear=2.0,
        perspective=1.0, border=(4, -6))
    out["perspective_img"], out["perspective_lab"] = img, targets

    cached = datasets.ONE_ARGOVERSEDataset(root, "train.json", name="cache", img_size=IMG_SIZE,
                                           cache=True, **kw)
    out["cache"] = np.array(cached.imgs)
    out["cache_item"] = np.concatenate(cached.pull_item(3)[:2], axis=-1)
    return out


def digest(arrays: Dict[str, np.ndarray]) -> str:
    """SHA-256 over the arrays in name order: name, dtype, shape, bytes."""
    h = hashlib.sha256()
    for name in sorted(arrays):
        a = np.ascontiguousarray(arrays[name])
        h.update(f"{name}|{a.dtype.str}|{a.shape}|".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def port_digest(work: str) -> str:
    """``digest`` of the port's samples, the fixture written under ``work``."""
    from streamyolo_torch.data import datasets, mosaic, transforms

    synth = write_fixture(work)
    return digest(collect(work, datasets, transforms, mosaic, load_frame=synth.frame))


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser("streamyolo_torch augment_check")
    parser.add_argument("--work", type=str, default=None,
                        help="directory for the fixture's json and the cache (a fresh one "
                             "by default; the cache file must not exist yet)")
    args = parser.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        got = port_digest(args.work or tmp)
    print(json.dumps({"digest": got, "expected": AUGMENT_DIGEST,
                      "equal": got == AUGMENT_DIGEST}))
    return 0 if got == AUGMENT_DIGEST else 1


if __name__ == "__main__":
    sys.exit(main())
