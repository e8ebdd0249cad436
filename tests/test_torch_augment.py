"""The port's augmentation path without cv2, against cv2 and the JAX package,
on the CPU:

  * the mosaic / mixup wrappers over the golden fixture of
    ``tests/test_mosaic_golden.py`` equal ``tests/golden/mosaic_golden.npz``
    bit for bit;
  * ``data/cv2_ops.py`` equals cv2 exactly: ``resize_u8`` (native) and its
    NumPy twin ``resize_u8_reference`` up and down,
    ``warp_affine_u8`` and ``warp_perspective_u8`` on matrices of
    ``_sample_warp_matrix`` (hypothesis cases at small sizes), and
    ``bgr2hsv_u8`` / ``hsv2bgr_u8`` on all 2^24 inputs each way, in cv2's
    SIMD body and in its scalar tail;
  * ``augment_hsv``, ``random_perspective``, the samples of
    ``tools/augment_check.py`` (mosaic + mixup + HSV, the perspective warp,
    the ``--cache`` memmap) and the ``--cache`` file equal the JAX
    package's under the same seeds, and the samples hash to the constant
    that ``chip_smoke.py`` checks on the card;
  * a fresh interpreter in which ``import cv2`` fails (and JAX cannot be
    imported) reproduces that hash and trains through ``tools/train.py``
    with the mosaic epoch, ``--cache`` and ``-l wandb``.

Everything is compared for equality; there is no tolerance.
"""

import os
import random
import subprocess
import sys

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from streamyolo_tpu.data import datasets as jdatasets
from streamyolo_tpu.data import mosaic as jmosaic
from streamyolo_tpu.data import transforms as jtransforms
from streamyolo_torch.data import cv2_ops
from streamyolo_torch.data import datasets as tdatasets
from streamyolo_torch.data import mosaic as tmosaic
from streamyolo_torch.data import transforms as ttransforms
from streamyolo_torch.tools import augment_check

from .test_mosaic_golden import _IMG_SIZE, GOLDEN, _build_dataset

cv2 = pytest.importorskip("cv2")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GREY = (114, 114, 114)


# ---------------------------------------------------------------- the golden


def png_dataset(cls, root):
    """A port dataset over the golden fixture, whose frames are PNGs that
    cv2 wrote, read by the port's own reader (``data/image_io.py``)."""
    return cls(root, "train.json", img_size=_IMG_SIZE)


def port_golden_arrays(root):
    """``test_mosaic_golden._collect`` through the port's wrappers."""
    out = {}
    rows = []
    for quadrant in range(4):
        for xc, yc in ((10, 12), (60, 50), (95, 60)):
            for w, h in ((30, 20), (104, 64), (3, 70)):
                dst, src = tmosaic.get_mosaic_coordinate(quadrant, xc, yc, w, h, *_IMG_SIZE)
                rows.append(list(dst) + list(src))
    out["coords"] = np.asarray(rows, np.int64)

    aug = dict(degrees=5.0, translate=0.05, scale=(0.8, 1.2), shear=1.0, mosaic_prob=1.0)
    wrapped = tmosaic.MosaicDetection(
        png_dataset(tdatasets.ONE_ARGOVERSEDataset, root),
        img_size=_IMG_SIZE, mosaic=True, enable_mixup=False,
        preproc=ttransforms.DoubleTrainTransform(max_labels=50, hsv=False, flip=True), **aug)
    for seed in range(4):
        random.seed(seed)
        stacked, (label, sup_label), _, _ = wrapped[seed % len(wrapped)]
        out[f"double_img_{seed}"], out[f"double_lab_{seed}"] = stacked, label
        out[f"double_sup_{seed}"] = sup_label

    still = tmosaic.StillMosaicDetection(
        png_dataset(tdatasets.STILL_ARGOVERSEDataset, root),
        img_size=_IMG_SIZE, mosaic=True, enable_mixup=True, mixup_prob=1.0, mscale=(0.6, 1.8),
        preproc=ttransforms.TrainTransform(max_labels=50, hsv=False, flip=True), **aug)
    for seed in range(6):
        random.seed(100 + seed)
        img, label, _, _ = still[seed % len(still)]
        out[f"still_img_{seed}"], out[f"still_lab_{seed}"] = img, label

    base_y, base_x = np.mgrid[0:_IMG_SIZE[0] * 2, 0:_IMG_SIZE[1] * 2]
    base_img = np.stack([(base_y * 5) % 256, (base_x * 7) % 256,
                         (base_y + base_x) % 256], -1).astype(np.uint8)
    base_labels = np.array([[4.0, 6.0, 30.0, 28.0, 1.0]], np.float32)

    def pull_single(i):
        if i % 3 == 0:  # no boxes: the donor is drawn again
            return base_img[:20, :20], np.zeros((0, 5), np.float32)
        yy, xx = np.mgrid[0:40, 0:70]
        img = np.stack([(yy * 3 + i) % 256, (xx * 2 + i) % 256,
                        (yy - xx + 5 * i) % 256], -1).astype(np.uint8)
        return img, np.array([[5.0 + i, 4.0, 36.0, 30.0, 2.0],
                              [40.0, 10.0, 66.0, 38.0, 0.0]], np.float32)

    for seed in range(6):
        random.seed(200 + seed)
        img, labels = still.mixup(base_img.copy(), base_labels.copy(), _IMG_SIZE, pull_single)
        out[f"mixup_img_{seed}"], out[f"mixup_lab_{seed}"] = img, labels
    return out


def test_mosaic_and_mixup_equal_the_golden(tmp_path):
    """Values equal, as ``test_mosaic_golden.py`` compares them (the golden
    holds images as float32, from before the letterbox stayed uint8)."""
    got = port_golden_arrays(_build_dataset(str(tmp_path)))
    want = np.load(GOLDEN)
    assert set(want.files) == set(got)
    for k in want.files:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------- cv2's calls


def image(seed, h, w):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3), np.uint8)


RESIZE_IMPLS = {"native": cv2_ops.resize_u8, "reference": cv2_ops.resize_u8_reference}


@pytest.mark.parametrize("impl", sorted(RESIZE_IMPLS))
@settings(max_examples=60, deadline=None)
@given(h=st.integers(1, 40), w=st.integers(1, 40), oh=st.integers(1, 90),
       ow=st.integers(1, 90), seed=st.integers(0, 2**16))
def test_resize_equals_cv2(impl, h, w, oh, ow, seed):
    """Down and up (the 2x average and the general fixed point alike), for
    the native resize and its NumPy twin."""
    for src_hw in ((h, w), (2 * oh, 2 * ow)):
        img = image(seed, *src_hw)
        want = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(RESIZE_IMPLS[impl](img, oh, ow), want)


@pytest.mark.parametrize("impl", sorted(RESIZE_IMPLS))
@pytest.mark.parametrize("src,dst", [((1200, 1920), (600, 960)), ((1200, 1920), (800, 1280)),
                                     ((600, 960), (331, 530)), ((37, 53), (90, 140)),
                                     ((300, 480), (1200, 1920))])
def test_resize_equals_cv2_at_frame_sizes(src, dst, impl):
    img = image(sum(src), *src)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(RESIZE_IMPLS[impl](img, *dst), want)


warp_cases = dict(
    h=st.integers(2, 70), w=st.integers(2, 70), oh=st.integers(1, 60), ow=st.integers(1, 90),
    degrees=st.floats(0, 45), translate=st.floats(0, 0.3), zoom_lo=st.floats(0.1, 1.0),
    zoom_hi=st.floats(1.0, 2.5), shear=st.floats(0, 10), seed=st.integers(0, 2**16))


def sampled_matrix(seed, h, w, oh, ow, degrees, translate, zoom_lo, zoom_hi, shear):
    random.seed(seed)
    matrix, _ = ttransforms._sample_warp_matrix((h, w), (oh, ow), degrees, translate,
                                                (zoom_lo, zoom_hi), shear)
    return matrix


@settings(max_examples=60, deadline=None)
@given(**warp_cases)
def test_warp_affine_equals_cv2(h, w, oh, ow, seed, **kw):
    img, matrix = image(seed, h, w), sampled_matrix(seed, h, w, oh, ow, **kw)
    want = cv2.warpAffine(img, matrix[:2], dsize=(ow, oh), borderValue=GREY)
    np.testing.assert_array_equal(cv2_ops.warp_affine_u8(img, matrix[:2], (oh, ow)), want)


@settings(max_examples=40, deadline=None)
@given(tilt=st.floats(-2e-3, 2e-3), **warp_cases)
def test_warp_perspective_equals_cv2(h, w, oh, ow, seed, tilt, **kw):
    """The sampled matrices (a third row of 0, 0, 1), and the same with a
    perspective term."""
    img, matrix = image(seed, h, w), sampled_matrix(seed, h, w, oh, ow, **kw)
    for m in (matrix, matrix + np.array([[0, 0, 0], [0, 0, 0], [tilt, -tilt / 2, 0]])):
        want = cv2.warpPerspective(img, m, dsize=(ow, oh), borderValue=GREY)
        np.testing.assert_array_equal(cv2_ops.warp_perspective_u8(img, m, (oh, ow)), want)


def test_warp_affine_at_the_mosaic_size():
    """A 1200x1920 mosaic canvas (grey around the tiles) warped to 600x960,
    the matrices of the Exp's augmentation (scale 0.1 to 2)."""
    canvas = np.full((1200, 1920, 3), 114, np.uint8)
    canvas[150:1050, 200:1700] = image(3, 900, 1500)
    for seed in (0, 1):
        matrix = sampled_matrix(seed, 1200, 1920, 600, 960, 10.0, 0.1, 0.1, 2.0, 2.0)
        want = cv2.warpAffine(canvas, matrix[:2], dsize=(960, 600), borderValue=GREY)
        np.testing.assert_array_equal(cv2_ops.warp_affine_u8(canvas, matrix[:2], (600, 960)),
                                      want)


def every_u8_triple(chunk):
    """The 2^24 (a, b, c) uint8 triples, in 16 chunks of 2^20."""
    values = np.arange(chunk << 20, (chunk + 1) << 20, dtype=np.uint32)
    return np.stack([values >> 16, (values >> 8) & 255, values & 255], -1).astype(np.uint8)


@pytest.mark.parametrize("code,port", [("COLOR_BGR2HSV", "bgr2hsv_u8"),
                                       ("COLOR_HSV2BGR", "hsv2bgr_u8")])
def test_colour_conversions_equal_cv2_on_every_input(code, port):
    """All 2^24 inputs, once in rows of 4096 (cv2's SIMD body) and once in
    rows of 16 (its scalar tail: cv2's HSV -> BGR truncates in the one and
    rounds in the other)."""
    fn = getattr(cv2_ops, port)
    for chunk in range(16):
        triples = every_u8_triple(chunk)
        for width in (4096, 16):
            img = triples.reshape(-1, width, 3)
            np.testing.assert_array_equal(fn(img), cv2.cvtColor(img, getattr(cv2, code)),
                                          err_msg=f"chunk {chunk}, rows of {width}")


# ---------------------------------------------------------------- against JAX


def test_augment_hsv_and_random_perspective_equal_jax():
    for seed in range(4):
        img = image(seed, 45 + seed, 70 + 3 * seed)
        got, want = img.copy(), img.copy()
        np.random.seed(seed)
        ttransforms.augment_hsv(got)
        np.random.seed(seed)
        jtransforms.augment_hsv(want)
        np.testing.assert_array_equal(got, want)

        targets = np.array([[5.0, 6.0, 30.0, 25.0, 1.0], [20.0, 2.0, 60.0, 40.0, 3.0],
                            [0.0, 30.0, 4.0, 44.0, 0.0]])
        for perspective, border in ((0.0, (-10, -12)), (1.0, (0, 0)), (0.0, (3, 5))):
            outs = []
            for tr in (ttransforms, jtransforms):
                random.seed(seed)
                outs.append(tr.random_perspective(img, targets.copy(), degrees=10, translate=0.1,
                                                  scale=(0.1, 2.0), shear=2.0,
                                                  perspective=perspective, border=border))
            (gi, gt), (wi, wt) = outs
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gt, wt)
    boxes = np.array([[0.0, 0.0, 10.0, 4.0], [1.0, 1.0, 2.0, 30.0]])
    np.testing.assert_array_equal(ttransforms.box_candidates(boxes.T, (boxes * 0.5).T),
                                  jtransforms.box_candidates(boxes.T, (boxes * 0.5).T))


def jax_fixture(root):
    """``augment_check``'s fixture with its frames written as PNG (lossless)
    where the JAX datasets read them."""
    synth = augment_check.write_fixture(str(root))
    for img in synth.data["images"]:
        d = os.path.join(str(root), "Argoverse-1.1", "tracking",
                         synth.data["seq_dirs"][img["sid"]])
        os.makedirs(d, exist_ok=True)
        cv2.imwrite(os.path.join(d, img["name"]), synth.frame(img))
    return str(root)


def test_augment_samples_and_cache_equal_jax(tmp_path):
    """Every sample of ``tools/augment_check.py`` (mosaic + HSV pairs,
    mosaic + mixup + HSV STILL items, the perspective warp, the cache and an
    item read from it) equals the JAX package's, the cache file byte for
    byte; the digest is the pinned one."""
    want = augment_check.collect(jax_fixture(tmp_path / "jax"), jdatasets, jtransforms, jmosaic)
    port_root = str(tmp_path / "port")
    synth = augment_check.write_fixture(port_root)
    got = augment_check.collect(port_root, tdatasets, ttransforms, tmosaic,
                                load_frame=synth.frame)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert all(np.count_nonzero(got[f"still_lab_{i}"][:, 0] + got[f"still_lab_{i}"][:, 3])
               for i in range(augment_check.N_SAMPLES))  # boxes survived the augmentation
    name = "img_resized_cache_cache.array"
    with open(tmp_path / "jax" / name, "rb") as f, open(os.path.join(port_root, name), "rb") as g:
        assert f.read() == g.read()
    assert augment_check.digest(want) == augment_check.AUGMENT_DIGEST


def test_cached_dataset_items_equal_jax(tmp_path):
    """``cache=True`` on both packages' STILL and TWO datasets: the same
    memmap bytes, and items read from it equal the uncached ones."""
    jroot = jax_fixture(tmp_path / "jax")
    troot = str(tmp_path / "port")
    synth = augment_check.write_fixture(troot)
    for cls in ("STILL_ARGOVERSEDataset", "TWO_ARGOVERSEDataset"):
        jds = getattr(jdatasets, cls)(jroot, "train.json", name=cls, img_size=(30, 50), cache=True)
        tds = getattr(tdatasets, cls)(troot, "train.json", name=cls, img_size=(30, 50),
                                      cache=True, load_frame=synth.frame)
        plain = getattr(tdatasets, cls)(troot, "train.json", img_size=(30, 50),
                                        load_frame=synth.frame)
        np.testing.assert_array_equal(np.asarray(tds.imgs), np.asarray(jds.imgs))
        for i in range(len(tds)):
            for g, w, p in zip(tds.pull_item(i), jds.pull_item(i), plain.pull_item(i)):
                np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
                np.testing.assert_array_equal(np.asarray(g), np.asarray(p))
        # an existing cache is reused as it stands
        again = getattr(tdatasets, cls)(troot, "train.json", name=cls, img_size=(30, 50),
                                        cache=True, load_frame=None)
        np.testing.assert_array_equal(np.asarray(again.imgs), np.asarray(jds.imgs))


# ---------------------------------------------------------------- without cv2

CHILD = """
import json, os, sys
for name in ("cv2", "jax", "flax", "streamyolo_tpu"):
    sys.modules[name] = None  # any import of them raises ImportError
work = sys.argv[1]
from streamyolo_torch.tools import augment_check
from streamyolo_torch.tools import train as train_tool
digest = augment_check.port_digest(os.path.join(work, "samples"))

# train: a val split beside the fixture's train split, frames from memory
data = os.path.join(work, "data")
synth = augment_check.write_fixture(data)
ann = os.path.join(data, "Argoverse-HD", "annotations")
with open(os.path.join(ann, "train.json")) as f:
    db = json.load(f)
with open(os.path.join(ann, "val.json"), "w") as f:
    json.dump(db, f)
opts = {"depth": 0.33, "width": 0.25, "data_dir": data, "output_dir": os.path.join(work, "out"),
        "input_size": (64, 96), "test_size": (64, 96), "random_size": None,
        "data_num_workers": 0, "max_epoch": 2, "no_aug_epochs": 0, "eval_interval": 2,
        "save_history_ckpt": False, "print_interval": 1, "seed": 3}
argv = ["-f", "cfgs/s_s50_onex_dfp_tal_flip.py", "-b", "2", "--device", "cpu", "-expn", "run",
        "--cache", "-l", "wandb"] + [str(x) for k, v in opts.items() for x in (k, v)]
sys.modules["torch.utils.tensorboard"] = None
trainer = train_tool.main(argv, load_frame=synth.frame)
import torch
leaked = sorted(n for n in sys.modules if n.split(".")[0] in ("cv2", "jax", "streamyolo_tpu")
                and sys.modules[n] is not None)
print(json.dumps({"digest": digest, "steps": trainer.state.step,
                  "iters_per_epoch": trainer.iters_per_epoch,
                  "wandb": type(trainer.wandb_logger).__name__,
                  "cache": os.path.isfile(os.path.join(data, "img_resized_cache_train.array")),
                  "mosaic_epochs": torch.load(os.path.join(
                      work, "out", "run", "last_mosaic_epoch_ckpt.pth"))["start_epoch"] - 1,
                  "losses_finite": all(v == v for v in trainer.meter["total_loss"]._deque),
                  "evals": len(trainer.eval_history), "leaked": leaked}))
"""


def test_without_cv2_the_samples_and_the_mosaic_training_run(tmp_path):
    """In a process that cannot import cv2 (nor JAX): the augment samples
    hash to the pinned digest, and ``tools/train.py`` trains StreamYOLO-s
    (depth 0.33, width 0.25) two epochs, the first on the mosaic branch
    (``no_aug_epochs`` 0: YOLOX closes the mosaic before epoch ``max_epoch -
    no_aug_epochs``, 1-based), with ``--cache`` and ``-l wandb`` (wandb
    absent: the no-op sink)."""
    import json

    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["OMP_NUM_THREADS"] = "2"
    proc = subprocess.run([sys.executable, "-c", CHILD, str(tmp_path)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["digest"] == augment_check.AUGMENT_DIGEST
    assert out["steps"] == 2 * out["iters_per_epoch"] > 0
    assert out["wandb"] == "WandbLogger" and out["cache"] and out["mosaic_epochs"] == 1
    assert out["losses_finite"] and out["evals"] == 1 and out["leaked"] == []
