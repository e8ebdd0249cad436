"""The port's train-side data path against the JAX package, on the CPU: the
train transforms, the mosaic wrappers' non-mosaic branch over the ONE, TWO
and STILL datasets, the mosaic branch, the samplers, the whole train
loader of the ``Exp`` (with and without the mosaic), the HSV jitter and
the prefetcher's behaviour.

Data: the textured ``write_fake_argoverse`` fixture (raw 60x96 frames read
with cv2, letterboxed at r = 0.5 to 30x48), ``data_num_workers 0``, and the
same ``random`` / NumPy / torch seeds on both sides. Items and batches must
be EQUAL: image bytes, both label arrays, ``img_info`` and ids.
"""

import os
import random
import time

import numpy as np
import pytest
import torch

from streamyolo_tpu.data import datasets as jdatasets
from streamyolo_tpu.data import loader as jloader
from streamyolo_tpu.data import mosaic as jmosaic
from streamyolo_tpu.data import transforms as jtransforms
from streamyolo_tpu.exp import get_exp as j_get_exp
from streamyolo_torch.data import datasets as tdatasets
from streamyolo_torch.data import loader as tloader
from streamyolo_torch.data import mosaic as tmosaic
from streamyolo_torch.data import transforms as ttransforms
from streamyolo_torch.data.cv2_ops import resize_u8
from streamyolo_torch.exp import get_exp

from .conftest import FAKE_IMG_SIZE
from .torch_port_helpers import pin_threads, write_textured_argoverse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFGS = {"ONE": "s_s50_onex_dfp_tal_flip", "TWO": "l_s50_twox_dfp_tal_flip",
        "STILL": "l_s50_still_dfp_flip"}


one_thread = pin_threads(1)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return write_textured_argoverse(tmp_path_factory.mktemp("train_data"), (5, 3))


def seed_all(seed):
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def assert_items_equal(got, want):
    assert type(got) is type(want) or isinstance(want, (tuple, list))
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_items_equal(g, w)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, (got.dtype, want.dtype)
        assert np.array_equal(got, want)
    else:
        assert got == want


def wrapped_pair(root, kind):
    """The JAX and the port mosaic wrapper (non-mosaic) over ``kind``."""
    name = {"ONE": "ONE_ARGOVERSEDataset", "TWO": "TWO_ARGOVERSEDataset",
            "STILL": "STILL_ARGOVERSEDataset"}[kind]
    double = kind != "STILL"
    out = []
    for ds_mod, tr_mod, mo_mod in ((jdatasets, jtransforms, jmosaic),
                                   (tdatasets, ttransforms, tmosaic)):
        tr = tr_mod.DoubleTrainTransform if double else tr_mod.TrainTransform
        ds = getattr(ds_mod, name)(root, "train.json", name="train", img_size=FAKE_IMG_SIZE,
                                   preproc=tr(max_labels=50, hsv=False, flip=True))
        wrapper = mo_mod.MosaicDetection if double else mo_mod.StillMosaicDetection
        out.append(wrapper(ds, img_size=FAKE_IMG_SIZE, mosaic=False,
                           preproc=tr(max_labels=120, hsv=False, flip=True)))
    return out


@pytest.mark.parametrize("kind", ["ONE", "TWO", "STILL"])
def test_mosaic_wrapper_items_equal_jax(root, kind):
    """Every item, over two passes with different seeds (the pair datasets'
    shared coin flip comes up both ways), equals the JAX package's."""
    jds, tds = wrapped_pair(root, kind)
    assert len(jds) == len(tds) == 8
    assert tds.input_dim == tuple(jds.input_dim) == FAKE_IMG_SIZE
    for seed in (0, 1):
        for i in range(len(tds)):
            seed_all(100 * seed + i)
            want = jds[i]
            seed_all(100 * seed + i)
            got = tds[i]
            assert_items_equal(got, want)
            img = got[0]
            assert img.dtype == np.uint8 and img.shape == (*FAKE_IMG_SIZE, 3 if kind == "STILL" else 6)
            labels = got[1][0] if kind != "STILL" else got[1]
            assert labels.shape == (120, 5) and labels.dtype == np.float32


def test_input_dim_moves_the_letterbox(root):
    """``input_dim`` set on the wrapper reaches the dataset's transform (a
    taller canvas at r = 1: grey rows below the frame)."""
    jds, tds = wrapped_pair(root, "ONE")
    jds.input_dim = tds.input_dim = (40, 48)
    seed_all(5)
    want = jds[3]
    seed_all(5)
    got = tds[3]
    assert got[0].shape == (40, 48, 6) and (got[0][30:] == 114).all()
    assert_items_equal(got, want)


def test_train_transform_degenerate_fallback_and_padding():
    """All boxes degenerate after the letterbox: the un-augmented pair is
    used (both packages); more boxes than ``max_labels`` are cut."""
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (60, 96, 3), np.uint8)
    thin = np.array([[10.0, 10.0, 11.0, 30.0, 2.0], [50.0, 5.0, 51.5, 9.0, 4.0]])
    many = np.concatenate([rng.uniform(0, 40, (9, 2)), np.zeros((9, 2)),
                           rng.randint(0, 8, (9, 1))], 1)
    many[:, 2:4] = many[:, :2] + 12
    for targets, max_labels, mirror in ((thin, 5, True), (many, 4, False), (many, 20, True),
                                        (np.zeros((0, 5)), 3, False)):
        for r_size in ((30, 48), (45, 64)):
            want = jtransforms.TrainTransform(max_labels, hsv=False)(
                img.copy(), targets.copy(), r_size, mirror=mirror)
            got = ttransforms.TrainTransform(max_labels, hsv=False)(
                img.copy(), targets.copy(), r_size, mirror=mirror)
            assert np.array_equal(got[0], want[0]) if r_size == (30, 48) else \
                got[0].shape == want[0].shape
            np.testing.assert_array_equal(got[1], want[1])


def test_mirror_matches_jax():
    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, (7, 9, 3), np.uint8)
    boxes = np.array([[1.0, 2.0, 4.0, 6.0], [0.0, 0.0, 9.0, 7.0]])
    for mirror in (False, True):
        gi, gb = ttransforms._mirror(img, boxes, mirror)
        wi, wb = jtransforms._mirror(img, boxes, mirror)
        assert np.array_equal(gi, wi) and np.array_equal(gb, wb)


def test_samplers_equal_jax():
    for seed, shuffle in ((0, True), (7, True), (3, False)):
        js = jloader.InfiniteSampler(11, shuffle=shuffle, seed=seed)
        ts = tloader.InfiniteSampler(11, shuffle=shuffle, seed=seed)
        take = lambda s: [next(it) for it in [iter(s)] for _ in range(40)]  # noqa: E731
        assert take(ts) == take(js) and len(ts) == len(js) == 11
        for mosaic in (False, True):
            jb = jloader.YoloBatchSampler(sampler=js, batch_size=4, drop_last=False, mosaic=mosaic)
            tb = tloader.YoloBatchSampler(sampler=ts, batch_size=4, drop_last=False, mosaic=mosaic)
            jit, tit = iter(jb), iter(tb)
            for _ in range(6):
                batch = next(tit)
                assert batch == next(jit) and all(flag is mosaic for flag, _ in batch)


@pytest.mark.parametrize("kind", ["ONE", "STILL"])
def test_exp_train_loader_batches_equal_jax(root, kind):
    """``get_data_loader`` of the same config and seed: the batches (after
    the NumPy collate) equal the JAX package's, two restarts of the loader
    included (the sampler restarts from its seed)."""
    opts = ["data_dir", root, "input_size", str(FAKE_IMG_SIZE), "data_num_workers", "0",
            "seed", "3"]
    jexp = j_get_exp(os.path.join(REPO, "cfgs", CFGS[kind] + ".py")).merge(opts)
    texp = get_exp(exp_name=CFGS[kind]).merge(opts)
    jl = jexp.get_data_loader(batch_size=3, no_aug=True)
    tl = texp.get_data_loader(batch_size=3, no_aug=True)
    assert len(texp.dataset) == len(jexp.dataset) == 8
    for restart in range(2):
        seed_all(restart)
        want = [b for _, b in zip(range(4), jl)]
        seed_all(restart)
        got = [b for _, b in zip(range(4), tl)]
        assert_items_equal(got, want)


@pytest.mark.parametrize("kind", ["ONE", "STILL"])
def test_exp_mosaic_loader_batches_equal_jax(root, kind):
    """``get_data_loader(no_aug=False)`` (mosaic; STILL also the mixup) of
    the same config and seed: the batches equal the JAX package's."""
    opts = ["data_dir", root, "input_size", str(FAKE_IMG_SIZE), "data_num_workers", "0",
            "seed", "5"]
    jexp = j_get_exp(os.path.join(REPO, "cfgs", CFGS[kind] + ".py")).merge(opts)
    texp = get_exp(exp_name=CFGS[kind]).merge(opts)
    jl = jexp.get_data_loader(batch_size=3, no_aug=False)
    tl = texp.get_data_loader(batch_size=3, no_aug=False)
    assert tl.dataset.enable_mosaic and jexp.dataset.enable_mosaic
    seed_all(1)
    want = [b for _, b in zip(range(3), jl)]
    seed_all(1)
    got = [b for _, b in zip(range(3), tl)]
    assert_items_equal(got, want)


def test_resize_fast_path_equals_cv2():
    """The exact-2x branch of ``resize_u8`` is cv2's INTER_LINEAR."""
    import cv2

    rng = np.random.RandomState(2)
    for h, w in ((60, 96), (2, 2), (30, 48), (1200, 1920)):
        img = rng.randint(0, 256, (h, w, 3), np.uint8)
        want = cv2.resize(img, (w // 2, h // 2), interpolation=cv2.INTER_LINEAR)
        assert np.array_equal(resize_u8(img, h // 2, w // 2), want)


# ---------------------------------------------------------------- the prefetcher


def raw_batches(n, fail_at=None, delay=0.0):
    """A loader stand-in: ``n`` collated (images, (labels, support)) batches."""
    for i in range(n):
        if delay:
            time.sleep(delay)
        if i == fail_at:
            raise ValueError(f"bad batch {i}")
        yield (np.full((2, 4, 6, 6), i, np.uint8),
               (np.full((2, 3, 5), i, np.float32), np.full((2, 3, 5), -i, np.float32)))


class Loader:
    def __init__(self, **kw):
        self.kw = kw

    def __iter__(self):
        return raw_batches(**self.kw)


def test_prefetcher_exhaustion_and_restart():
    loader = Loader(n=3)
    pf = tloader.DevicePrefetcher(loader, device="cpu")
    got = [pf.next() for _ in range(3)]
    assert [int(b["images"][0, 0, 0, 0]) for b in got] == [0, 1, 2]
    assert got[1]["images"].dtype == torch.uint8 and got[1]["labels"].dtype == torch.float32
    assert float(got[2]["support_labels"][0, 0, 0]) == -2.0
    assert pf.next() is None and pf.next() is None  # exhausted, no dead kick
    pf.__init__(loader, device="cpu")  # the trainer's restart
    assert int(pf.next()["images"][0, 0, 0, 0]) == 0
    pf.close()


def test_prefetcher_error_raised_on_caller():
    pf = tloader.DevicePrefetcher(Loader(n=4, fail_at=1), device="cpu")
    assert int(pf.next()["images"][0, 0, 0, 0]) == 0
    with pytest.raises(ValueError, match="bad batch 1"):
        pf.next()
    assert pf.next() is None


def test_prefetcher_close_drops_the_preload():
    """``close()`` joins the preload in flight and drops it: ``next()`` then
    returns None, never a stale batch."""
    pf = tloader.DevicePrefetcher(Loader(n=5, delay=0.05), device="cpu")
    assert int(pf.next()["images"][0, 0, 0, 0]) == 0
    pf.close()
    assert pf._thread is None and pf.next() is None


def test_prefetcher_reinit_joins_the_inflight_preload():
    """A restart while a slow preload is in flight waits for it: the new
    iterator's first batch comes first, and no thread is left behind."""
    loader = Loader(n=5, delay=0.1)
    pf = tloader.DevicePrefetcher(loader, device="cpu")
    old = pf._thread
    pf.__init__(loader, device="cpu")
    assert not old.is_alive()
    assert [int(pf.next()["images"][0, 0, 0, 0]) for _ in range(2)] == [0, 1]
    pf.close()


def test_prefetcher_wants_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tloader.DevicePrefetcher(Loader(n=1))


# ---------------------------------------------------------------- refusals


def test_unported_augmentations_raise(root):
    """What raised until the augmentation path was ported without cv2 now
    runs, equal to the JAX package: the HSV jitter (``hsv=True``, the
    default of both train transforms), the wrappers' mosaic branch, the
    ``Exp`` loader with ``no_aug=False`` and ``--cache``."""
    img = np.random.RandomState(4).randint(0, 256, (60, 96, 3), np.uint8)
    targets = np.array([[10.0, 10.0, 40.0, 30.0, 2.0], [50.0, 5.0, 90.0, 50.0, 4.0]])
    for mirror in (False, True):
        outs = []
        for tr in (ttransforms, jtransforms):
            np.random.seed(6)
            outs.append(tr.TrainTransform(hsv=True)(img.copy(), targets.copy(), (30, 48),
                                                    mirror=mirror))
        assert_items_equal(outs[0], outs[1])
    seed_all(2)
    want = jtransforms.DoubleTrainTransform()((img.copy(), img[::-1].copy()),
                                              (targets, targets), (30, 48))
    seed_all(2)
    assert_items_equal(ttransforms.DoubleTrainTransform()((img, img[::-1]), (targets, targets),
                                                          (30, 48)), want)
    jds, tds = wrapped_pair(root, "ONE")
    jds.enable_mosaic = tds.enable_mosaic = True
    for i in range(3):
        seed_all(i)
        want = jds[i]
        seed_all(i)
        assert_items_equal(tds[i], want)
    exp = get_exp(exp_name=CFGS["ONE"]).merge(["data_dir", root, "data_num_workers", "0"])
    assert exp.get_data_loader(batch_size=2, no_aug=False).dataset.enable_mosaic
    cached = tdatasets.ONE_ARGOVERSEDataset(root, "train.json", name="cache_check",
                                            cache=True)
    assert cached.imgs.shape == (8, 416, 416, 3)
    # the data-parallel loader is ported: with no process group it is one
    # process's (tests/test_torch_distributed.py runs it over two ranks)
    assert exp.get_data_loader(batch_size=2, is_distributed=True,
                               no_aug=True).batch_sampler.batch_size == 2
