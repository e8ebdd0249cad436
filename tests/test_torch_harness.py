"""The streaming harness of the PyTorch port against the JAX package, on the
CPU: clocks, runtime distributions and the zoo, box conversions, the
streaming protocol under ``SimClock``, pairing, COCO indexing, both
COCOeval implementations, and the synthetic dataset.

Tolerances: everything here is host arithmetic copied from the JAX package,
so results are EQUAL (draws, timestamps, pairings, annotations), except
COCOeval ``stats`` and ``precision`` (within 1e-12, as
``tests/test_native.py`` holds the two JAX implementations) and the
synthetic background (within 1 grey level of ``cv2.resize``).
"""

import json
import logging
import pickle

import numpy as np
import pytest

from streamyolo_tpu.data import coco as jcoco
from streamyolo_tpu.data import dbcode as jdbcode
from streamyolo_tpu.eval.cocoeval import COCOeval as JCOCOeval
from streamyolo_tpu.eval.cocoeval_ext import COCOeval_opt as JCOCOeval_opt
from streamyolo_tpu.stream import bbox as jbbox
from streamyolo_tpu.stream import clock as jclock
from streamyolo_tpu.stream import online as jonline
from streamyolo_tpu.stream import pairing as jpairing
from streamyolo_tpu.stream import runtime_dist as jrd
from streamyolo_torch import native
from streamyolo_torch.data import coco as tcoco
from streamyolo_torch.data import dbcode as tdbcode
from streamyolo_torch.eval import cocoeval_ext
from streamyolo_torch.eval.cocoeval import COCOeval
from streamyolo_torch.eval.cocoeval_ext import COCOeval_opt, evaluator_class
from streamyolo_torch.stream import bbox as tbbox
from streamyolo_torch.stream import clock as tclock
from streamyolo_torch.stream import online as tonline
from streamyolo_torch.stream import pairing as tpairing
from streamyolo_torch.stream import runtime_dist as trd

cv2 = pytest.importorskip("cv2")

FPS = 30.0


def test_sim_clock_and_wall_clock():
    t, j = tclock.SimClock(), jclock.SimClock()
    for dt in (0.0, 0.01, 1 / 30, 1e-9, 0.25):
        t.advance(dt)
        j.advance(dt)
        assert t.now() == j.now()
    t.reset()
    assert t.now() == 0.0
    with pytest.raises(ValueError):
        t.advance(-1e-3)
    w = tclock.WallClock()
    a = w.now()
    w.advance(10.0)  # a no-op: real work already took the time
    b = w.now()
    assert 0 <= a <= b < 1.0
    w.reset()
    assert w.now() < 1.0


def test_empirical_draws_equal_jax():
    samples = [0.012, 0.021, 0.045, 0.0146]
    for pf in (1.0, 2.0):
        t, j = trd.Empirical(samples, pf, seed=7), jrd.Empirical(samples, pf, seed=7)
        assert [t.draw() for _ in range(64)] == [j.draw() for _ in range(64)]
        assert [t.draw_sequential() for _ in range(9)] == [j.draw_sequential() for _ in range(9)]
        assert (t.mean(), t.std(), t.min(), t.max()) == (j.mean(), j.std(), j.min(), j.max())
    with pytest.raises(ValueError):
        trd.Empirical(samples, 0.0)
    with pytest.raises(ValueError, match="Unknown distribution"):
        trd.dist_from_dict({"type": "gaussian"})


def test_runtime_zoo_round_trip(tmp_path):
    """A zoo written by the port reads back in both packages with the same
    draws, and the port reads a zoo the JAX package wrote."""
    info = tmp_path / "time_info.pkl"
    with open(info, "wb") as f:
        pickle.dump({"runtime_all": [0.01, 0.02, 0.05]}, f)
    trd.add_to_runtime_zoo(str(info), str(tmp_path / "zoo" / "t.pkl"), "det")
    jrd.add_to_runtime_zoo(str(info), str(tmp_path / "j.pkl"), "det")
    for path in ("zoo/t.pkl", "j.pkl"):
        t = trd.dist_from_zoo(str(tmp_path / path), "det", perf_factor=1.5, seed=3)
        j = jrd.dist_from_zoo(str(tmp_path / path), "det", perf_factor=1.5, seed=3)
        assert [t.draw() for _ in range(20)] == [j.draw() for _ in range(20)]
    with open(tmp_path / "zoo" / "t.pkl", "rb") as f, open(tmp_path / "j.pkl", "rb") as g:
        assert pickle.load(f) == pickle.load(g)


@pytest.mark.parametrize("name", ["ltwh2ltrb", "ltrb2ltwh", "ltwh2cxywh", "cxywh2ltwh",
                                  "cxywh2ltrb", "ltrb2cxywh", "bbox_sqrt_area",
                                  "ltwh2ltrb_", "ltrb2ltwh_", "ltwh2cxywh_", "cxywh2ltwh_"])
def test_bbox_conversions_match_jax(name):
    """Every conversion, on [N, 4] and on one [4] box; the ``_`` variants
    in place."""
    boxes = np.random.default_rng(0).uniform(1, 100, (7, 4))
    for b in (boxes, boxes[0]):
        got, want = b.copy(), b.copy()
        out_t, out_j = getattr(tbbox, name)(got), getattr(jbbox, name)(want)
        np.testing.assert_array_equal(out_t, out_j)
        np.testing.assert_array_equal(got, want)


def _gt_oracle(db, sid):
    offset = min(i["id"] for i in db.dataset["images"] if i["sid"] == sid)

    def gt(fidx):
        anns = db.img_to_anns[offset + fidx]
        return ([[a["bbox"][0], a["bbox"][1], a["bbox"][0] + a["bbox"][2],
                  a["bbox"][1] + a["bbox"][3]] for a in anns],
                [a["category_id"] for a in anns])

    return gt


def _as_plain(result):
    """A stream_sequence result with the parsed arrays as lists (comparable)."""
    out = dict(result)
    out["results_parsed"] = [tuple(None if x is None else np.asarray(x).tolist() for x in r)
                             for r in result["results_parsed"]]
    return out


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    root = tmp_path_factory.mktemp("synthetic")
    jdbcode.make_synthetic_argoverse(str(root), seq_lens=(12, 9), size=(60, 96), seed=4)
    path = root / "Argoverse-HD" / "annotations" / "val.json"
    return root, str(path)


@pytest.mark.parametrize("runtimes,stride,dynamic", [
    ([0.004], 1, False), ([0.012, 0.021, 0.045], 1, False),
    ([0.012, 0.021, 0.045], 2, False), ([0.02, 0.05, 0.07], 1, True),
])
def test_stream_sequence_matches_jax(synthetic, runtimes, stride, dynamic):
    """The simulated streaming protocol (frame skips, the half-period rule,
    ``det_stride``, the 1e-9 hop) gives the JAX package's timestamps,
    input frames, runtimes and results exactly; so does the
    infinite-compute run."""
    _, path = synthetic
    db = jcoco.COCO(path)
    for sid in range(2):
        n = sum(1 for i in db.dataset["images"] if i["sid"] == sid)
        kw = dict(fps=FPS, det_stride=stride, dynamic_schedule=dynamic, frame_arg_is_index=True)
        t = tonline.stream_sequence(
            list(range(n)), tonline.SimulatedDetector(_gt_oracle(db, sid), None),
            clock=tclock.SimClock(), runtime_dist=trd.Empirical(runtimes, seed=sid), **kw)
        j = jonline.stream_sequence(
            list(range(n)), jonline.SimulatedDetector(_gt_oracle(db, sid), None),
            clock=jclock.SimClock(), runtime_dist=jrd.Empirical(runtimes, seed=sid), **kw)
        assert _as_plain(t) == _as_plain(j)
        assert len(t["timestamps"]) > 0
        t = tonline.stream_sequence_infinite(
            list(range(n)), tonline.SimulatedDetector(_gt_oracle(db, sid), None), fps=FPS,
            runtime_dist=trd.Empirical(runtimes, seed=sid), frame_arg_is_index=True)
        j = jonline.stream_sequence_infinite(
            list(range(n)), jonline.SimulatedDetector(_gt_oracle(db, sid), None), fps=FPS,
            runtime_dist=jrd.Empirical(runtimes, seed=sid), frame_arg_is_index=True)
        assert _as_plain(t) == _as_plain(j)


def test_pairing_and_detections_for_image_match_jax(synthetic):
    """``pair_streaming_results`` (with eta 0 and 1) and both modes of
    ``detections_for_image`` give the JAX package's CCF rows and counts."""
    _, path = synthetic
    db = jcoco.COCO(path)
    rng = np.random.default_rng(5)
    results = {}
    for sid, seq in enumerate(db.dataset["sequences"]):
        n = sum(1 for i in db.dataset["images"] if i["sid"] == sid)
        fidx = np.sort(rng.choice(n, size=n // 2, replace=False)).tolist()
        parsed = []
        for _ in fidx:
            k = int(rng.integers(0, 4))
            xy = rng.uniform(0, 50, (k, 2))
            parsed.append((np.concatenate([xy, xy + rng.uniform(2, 20, (k, 2))], 1),
                           rng.uniform(0, 1, k), rng.integers(0, 8, k), None))
        ts = (np.asarray(fidx) / FPS + rng.uniform(0.001, 0.05, len(fidx))).tolist()
        results[seq] = {"results_parsed": parsed, "timestamps": sorted(ts), "input_fidx": fidx}
    for eta in (0, 1):
        t_ccf, t_assoc = tpairing.pair_streaming_results(tcoco.COCO(path), results, FPS, eta)
        j_ccf, j_assoc = jpairing.pair_streaming_results(db, results, FPS, eta)
        assert t_ccf == j_ccf and t_assoc == j_assoc
    assert len(t_ccf) > 0
    start_t = start_j = 0
    for img_id in sorted(db.imgs):
        got = tpairing.detections_for_image(t_ccf, img_id, start_t)
        want = jpairing.detections_for_image(j_ccf, img_id, start_j)
        start_t, start_j = got[0], want[0]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        for g, w in zip(tpairing.detections_for_image(t_ccf, img_id),
                        jpairing.detections_for_image(j_ccf, img_id)):
            np.testing.assert_array_equal(g, w)


def _random_coco(rng, module, n_imgs=6, n_cats=3, crowd_prob=0.15):
    images = [dict(id=i, width=640, height=480) for i in range(n_imgs)]
    anns, k = [], 1
    for i in range(n_imgs):
        for _ in range(rng.integers(0, 8)):
            w, h = rng.uniform(8, 120, 2)
            x, y = rng.uniform(0, 640 - w), rng.uniform(0, 480 - h)
            anns.append(dict(id=k, image_id=i, category_id=int(rng.integers(1, n_cats + 1)),
                             bbox=[float(x), float(y), float(w), float(h)], area=float(w * h),
                             iscrowd=int(rng.random() < crowd_prob)))
            k += 1
    cats = [dict(id=c, name=f"c{c}") for c in range(1, n_cats + 1)]
    return module.COCO(dict(images=images, annotations=anns, categories=cats))


def _random_results(rng, gt, n_extra=10, jitter=12.0):
    res = []
    for ann in gt.dataset["annotations"]:
        if rng.random() < 0.8:
            x, y, w, h = ann["bbox"]
            res.append(dict(image_id=ann["image_id"], category_id=ann["category_id"],
                            bbox=[x + rng.normal(0, jitter), y + rng.normal(0, jitter),
                                  max(4.0, w + rng.normal(0, jitter)),
                                  max(4.0, h + rng.normal(0, jitter))],
                            score=float(rng.random())))
    for _ in range(n_extra):
        res.append(dict(image_id=int(rng.integers(0, len(gt.dataset["images"]))),
                        category_id=int(rng.integers(1, 4)),
                        bbox=[float(rng.uniform(0, 600)), float(rng.uniform(0, 440)),
                              float(rng.uniform(8, 80)), float(rng.uniform(8, 80))],
                        score=float(rng.random())))
    return res


def _evaluate(cls, gt, dt):
    e = cls(gt, dt, "bbox")
    e.evaluate()
    e.accumulate()
    e.summarize()
    return e


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_cocoeval_matches_jax(seed):
    """The port's NumPy ``COCOeval`` and native ``COCOeval_opt`` against the
    JAX package's two, on randomised ground truth (crowd boxes included)
    and detections, through the same ``loadRes``."""
    gt_t = _random_coco(np.random.default_rng(seed), tcoco)
    gt_j = _random_coco(np.random.default_rng(seed), jcoco)
    results = _random_results(np.random.default_rng(100 + seed), gt_t)
    dt_t, dt_j = gt_t.loadRes(results), gt_j.loadRes(results)
    assert dt_t.dataset["annotations"] == dt_j.dataset["annotations"]
    want = _evaluate(JCOCOeval, gt_j, dt_j)
    want_opt = _evaluate(JCOCOeval_opt, gt_j, dt_j)
    for cls in (COCOeval, COCOeval_opt):
        got = _evaluate(cls, gt_t, dt_t)
        np.testing.assert_allclose(got.stats, want.stats, atol=1e-12, rtol=0)
        np.testing.assert_allclose(got.stats, want_opt.stats, atol=1e-12, rtol=0)
        np.testing.assert_allclose(got.eval["precision"], want.eval["precision"], atol=1e-12)
        np.testing.assert_allclose(got.eval["recall"], want.eval["recall"], atol=1e-12)


def test_cocoeval_maxdets_cap_matches_jax():
    """More than 100 detections in one image: the maxDets cap."""
    rng = np.random.default_rng(11)
    data = dict(images=[dict(id=0, width=1000, height=1000)],
                annotations=[dict(id=i + 1, image_id=0, category_id=1,
                                  bbox=[float(50 * (i % 10)), float(50 * (i // 10)), 40.0, 40.0],
                                  area=1600.0, iscrowd=0) for i in range(30)],
                categories=[dict(id=1, name="a")])
    res = [dict(image_id=0, category_id=1, bbox=[float(rng.uniform(0, 500)),
                                                 float(rng.uniform(0, 500)), 40.0, 40.0],
                score=float(rng.random())) for _ in range(150)]
    gt_t, gt_j = tcoco.COCO(data), jcoco.COCO(json.loads(json.dumps(data)))
    want = _evaluate(JCOCOeval, gt_j, gt_j.loadRes(res))
    for cls in (COCOeval, COCOeval_opt):
        got = _evaluate(cls, gt_t, gt_t.loadRes(res))
        np.testing.assert_allclose(got.stats, want.stats, atol=1e-12, rtol=0)


def test_native_library_builds_under_build_dir():
    """The port builds its own copy of the native library under
    ``build/native/``, never beside the JAX binding."""
    lib = native.load()
    path = native._target()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "native")
    assert lib is native.load()


def test_evaluator_falls_back_and_logs(monkeypatch, caplog):
    """If the native library does not build, scoring uses the NumPy
    ``COCOeval`` and says so."""
    def broken():
        raise native.NativeBuildError("g++ failed")

    assert evaluator_class() is COCOeval_opt
    monkeypatch.setattr(cocoeval_ext, "load", broken)
    with caplog.at_level(logging.WARNING, logger="streamyolo_torch"):
        assert evaluator_class() is COCOeval
    assert any("NumPy COCOeval" in r.message for r in caplog.records)


def test_synthetic_dataset_matches_jax(synthetic, tmp_path):
    """The port's generator draws in the JAX package's order: the
    annotation files are equal, and the written frames decode as the JAX
    package's JPEGs do up to the background's upscaling (1 grey level
    before the JPEG coding)."""
    root, path = synthetic
    tdbcode.make_synthetic_argoverse(str(tmp_path), seq_lens=(12, 9), size=(60, 96), seed=4)
    with open(path) as f, open(tmp_path / "Argoverse-HD" / "annotations" / "val.json") as g:
        assert json.load(f) == json.load(g)
    synth = tdbcode.SyntheticArgoverse(seq_lens=(12, 9), size=(60, 96), seed=4)
    img = synth.data["images"][5]
    frame = synth.frame(img)
    assert frame.shape == (60, 96, 3) and frame.dtype == np.uint8
    inside = np.zeros(frame.shape[:2], bool)
    for ann in synth._anns[img["id"]]:
        x, y, w, h = (int(v) for v in ann["bbox"])
        inside[y:y + h, x:x + w] = True
    # the last rectangle is painted on top; outside all of them, the background
    assert (frame[y + h // 2, x + w // 2] == tdbcode.PALETTE[ann["category_id"]]).all()
    np.testing.assert_array_equal(frame[~inside], synth.backgrounds[img["sid"]][~inside])


@pytest.mark.parametrize("src,dst", [((12, 19), (120, 192)), ((6, 9), (64, 96)),
                                     ((120, 192), (1200, 1920)), ((7, 5), (13, 29)),
                                     ((40, 60), (20, 30))])
def test_background_resize_within_one_grey_level_of_cv2(src, dst):
    img = np.random.RandomState(sum(src)).randint(0, 256, (*src, 3), np.uint8)
    got = tdbcode.resize_linear_u8(img, *dst).astype(int)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR).astype(int)
    assert np.abs(got - want).max() <= 1


def test_pseudo_gt_and_img_folder_match_jax(synthetic):
    root, path = synthetic
    db = json.load(open(path))
    rng = np.random.default_rng(1)
    ccf = [dict(image_id=int(rng.integers(0, 21)), category_id=int(rng.integers(0, 12)),
                bbox=rng.uniform(1, 50, 4).tolist(), score=float(rng.random()))
           for _ in range(40)]
    for mapping in (None, tdbcode.COCO_TO_AVHD):
        assert (tdbcode.pseudo_gt_from_detections(db, ccf, 0.3, mapping)
                == jdbcode.pseudo_gt_from_detections(db, ccf, 0.3, mapping))
    tracking = str(root / "Argoverse-1.1" / "tracking")
    assert tdbcode.db_from_img_folder(tracking) == jdbcode.db_from_img_folder(tracking)
