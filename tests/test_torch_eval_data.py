"""The eval-side data path of the PyTorch port against the JAX package, on the
CPU: the letterbox ``preproc``, the ONE / TWO / STILL datasets, the NumPy
collate, ``support_shifts``, the three ``convert_to_coco_format``s and the
per-class AP table.

The fixture is ``tests/conftest.py::write_fake_argoverse`` with its flat
frames replaced by seeded noise (JPEGs both stacks decode with cv2), raw
60x96 frames at the test size 30x48: the 0.5 ratio of the shipped configs
on 1200x1920 Argoverse-HD. Tolerances: image bytes, targets, ``img_info``,
ids, shifts and COCO rows EQUAL; the letterbox bit-exact at every ratio.
"""

import types

import numpy as np
import pytest

from streamyolo_tpu.data import DataLoader as JDataLoader
from streamyolo_tpu.data import datasets as jdatasets
from streamyolo_tpu.data import transforms as jtransforms
from streamyolo_tpu.eval import evaluators as jevaluators
from streamyolo_tpu.eval.seq_forward import support_shifts as j_support_shifts
from streamyolo_torch.data import datasets as tdatasets
from streamyolo_torch.data import transforms as ttransforms
from streamyolo_torch.data.loader import DataLoader
from streamyolo_torch.eval import evaluators as tevaluators
from streamyolo_torch.eval.seq_forward import support_shifts

from .conftest import FAKE_H, FAKE_IMG_SIZE, FAKE_W
from .torch_port_helpers import pin_threads, write_textured_argoverse

KINDS = {"ONE": "ONE_ARGOVERSEDataset", "TWO": "TWO_ARGOVERSEDataset",
         "STILL": "STILL_ARGOVERSEDataset"}


one_thread = pin_threads(1)


@pytest.fixture(scope="module", params=[(5, 3), (2, 6)], ids=["seqs5+3", "seqs2+6"])
def fixture(request, tmp_path_factory):
    return write_textured_argoverse(tmp_path_factory.mktemp("eval_data"), request.param)


def datasets(root, kind, img_size=FAKE_IMG_SIZE, transform=True):
    double = kind != "STILL"
    preprocs = ((jtransforms.DoubleValTransform(), ttransforms.DoubleValTransform()) if double
                else (jtransforms.ValTransform(), ttransforms.ValTransform()))
    if not transform:
        preprocs = (None, None)
    return (getattr(jdatasets, KINDS[kind])(root, "val.json", name="val", img_size=img_size,
                                            preproc=preprocs[0]),
            getattr(tdatasets, KINDS[kind])(root, "val.json", name="val", img_size=img_size,
                                            preproc=preprocs[1]))


def assert_equal_nested(got, want):
    if isinstance(want, (tuple, list)):
        assert isinstance(got, type(want)) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_equal_nested(g, w)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert np.asarray(got).dtype == np.asarray(want).dtype


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("transform", [True, False], ids=["val_transform", "raw"])
def test_dataset_items_match_jax(fixture, kind, transform):
    """Every item (image bytes, targets, support targets, img_info, id) of
    the port's dataset equals the JAX dataset's, the empty targets of the
    last two images and the self-support boundaries included."""
    jds, tds = datasets(fixture, kind, transform=transform)
    assert len(tds) == len(jds) and tds.class_ids == jds.class_ids
    for i in range(len(jds)):
        want = jds[i] if transform else jds.pull_item(i)
        got = tds[i] if transform else tds.pull_item(i)
        assert_equal_nested(got, want)
        for slot in range(2 if kind != "STILL" else 1):
            np.testing.assert_array_equal(tds.annotations[i][slot], jds.annotations[i][slot])
    # the quirk: the last two dataset images query a non-existent id
    assert len(tds.load_anno(len(tds) - 1)) == len(tds.load_anno(len(tds) - 2)) == (
        0 if kind != "STILL" else 1)


def test_frames_come_through_load_frame(fixture):
    """``load_frame`` replaces the cv2 read: items from frames handed over in
    memory equal the items read from the JPEGs."""
    _, tds = datasets(fixture, "TWO")
    frames = {img["id"]: tdatasets.imread(tds._file_name(img))
              for img in tds.coco.dataset["images"]}
    mem = tdatasets.TWO_ARGOVERSEDataset(fixture, "val.json", name="val",
                                         img_size=FAKE_IMG_SIZE,
                                         preproc=ttransforms.DoubleValTransform(),
                                         load_frame=lambda img: frames[img["id"]])
    for i in range(len(tds)):
        assert_equal_nested(mem[i], tds[i])


def test_imread_without_cv2_raises_clearly(monkeypatch, tmp_path, fixture):
    """Without cv2 the dataset's ``imread`` (the port's native decoder)
    reads a frame equal to ``cv2.imread``, and a missing file raises an
    ``OSError`` that names it."""
    import sys

    import cv2

    _, tds = datasets(fixture, "TWO")
    path = tds._file_name(tds.coco.dataset["images"][0])
    want = cv2.imread(path)
    monkeypatch.setitem(sys.modules, "cv2", None)
    np.testing.assert_array_equal(tdatasets.imread(path), want)
    missing = str(tmp_path / "frame.jpg")
    with pytest.raises(OSError, match="frame.jpg"):
        tdatasets.imread(missing)


@pytest.mark.parametrize("src,dst,exact", [
    ((60, 96), (30, 48), True),      # r = 0.5: cv2's 2x2 average
    ((1200, 1920), (600, 960), True),
    ((61, 97), (30, 48), False),     # r just under 0.5, odd source
    ((60, 96), (32, 64), False),     # r = 0.533
    ((45, 64), (60, 96), False),     # upscale
])
def test_letterbox_matches_jax(src, dst, exact):
    """Bit for bit on cv2's 2x2-average path (``exact``) and on its general
    fixed-point path alike."""
    img = np.random.RandomState(src[0] * dst[1]).randint(0, 256, (*src, 3), np.uint8)
    want, r_want = jtransforms.preproc(img, dst)
    got, r_got = ttransforms.preproc(img, dst)
    assert r_got == r_want and got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    h, w = int(src[0] * r_got), int(src[1] * r_got)
    assert (got[h:] == 114).all() and (got[:, w:] == 114).all()


@pytest.mark.parametrize("kind", ["ONE", "STILL"])
def test_collate_matches_jax(fixture, kind):
    """Batches of 3 (the last one partial): images, target tuples,
    ``info_imgs`` (a tuple of stacked heights and widths) and ids [B, 1]."""
    jds, tds = datasets(fixture, kind)
    jl = JDataLoader(jds, batch_size=3, num_workers=0, shuffle=False)
    tl = DataLoader(tds, batch_size=3, num_workers=0, shuffle=False)
    assert len(tl) == len(jl)
    for got, want in zip(tl, jl):
        assert_equal_nested(got, want)
        imgs, _, info_imgs, ids = got
        assert isinstance(info_imgs, tuple) and len(info_imgs) == 2
        assert ids.shape == (imgs.shape[0], 1)


@pytest.mark.parametrize("kind", ["ONE", "TWO"])
def test_support_shifts_match_jax(fixture, kind):
    jds, tds = datasets(fixture, kind)
    got, want = support_shifts(tds), j_support_shifts(jds)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    # the shift is the dataset's own support frame
    for i in range(len(tds)):
        assert tds.annotations[i][5]["id"] == tds.ids[i] - got[i]


def crafted_outputs(n_images, rng):
    """Per-image [n, 7] rows (x1, y1, x2, y2, obj, cls_conf, cls) or None,
    over the dataset's ids plus the hard-coded 15060 / 15061 and ids past
    the dataset's end (the bound guards)."""
    ids = list(range(n_images)) + [15060, 15061, n_images, n_images + 1]
    outputs = []
    for k in range(len(ids)):
        if k % 5 == 3:
            outputs.append(None)
            continue
        n = int(rng.randint(1, 4))
        xy = rng.uniform(0, 40, (n, 2))
        wh = rng.uniform(1, 20, (n, 2))
        outputs.append(np.concatenate(
            [xy, xy + wh, rng.uniform(0.1, 1, (n, 2)), rng.randint(0, 8, (n, 1))],
            axis=1).astype(np.float32))
    info = (np.full(len(ids), FAKE_H), np.full(len(ids), FAKE_W))
    return outputs, info, np.asarray(ids)[:, None]


@pytest.mark.parametrize("evaluator", ["ONEX", "TWOX", "STILL"])
def test_convert_to_coco_format_matches_jax(fixture, evaluator):
    kind = {"ONEX": "ONE", "TWOX": "TWO", "STILL": "STILL"}[evaluator]
    jds, tds = datasets(fixture, kind)
    name = f"{evaluator}_COCOEvaluator"
    kw = dict(img_size=FAKE_IMG_SIZE, confthre=0.01, nmsthre=0.65, num_classes=8)
    jev = getattr(jevaluators, name)(JDataLoader(jds, batch_size=2, shuffle=False), **kw)
    tev = getattr(tevaluators, name)(DataLoader(tds, batch_size=2, shuffle=False), **kw)
    outputs, info, ids = crafted_outputs(len(tds), np.random.RandomState(len(tds)))
    want = jev.convert_to_coco_format(outputs, info, ids)
    got = tev.convert_to_coco_format(outputs, info, ids)
    assert got == want
    assert len(got) > 0
    if evaluator != "STILL":
        shift = 1 if evaluator == "ONEX" else 2
        kept = {d["image_id"] - shift for d in got}
        assert not kept & {15060, 15061}
        images = tds.coco.dataset["images"]
        assert all(images[i]["fid"] not in ((0,) if shift == 1 else (0, 1)) for i in kept)


def test_per_class_ap_table_matches_jax():
    pytest.importorskip("tabulate")
    rng = np.random.RandomState(0)
    precision = rng.uniform(0, 1, (10, 101, 8, 4, 3))
    precision[:, :, 1] = -1  # a class without ground truth: nan
    coco_eval = types.SimpleNamespace(eval={"precision": precision})
    names = ("person", "bicycle", "car", "motorcycle", "bus", "truck", "traffic_light",
             "stop_sign")
    for colums in (6, 4):
        assert (tevaluators.per_class_AP_table(coco_eval, names, colums=colums)
                == jevaluators.per_class_AP_table(coco_eval, names, colums=colums))
