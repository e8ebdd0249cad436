"""Track association, Kalman forecasting, the Streamer, the scheduling
simulator and the summary CSV of the PyTorch port against the JAX package,
on the CPU (``streamyolo_torch/stream/{track,forecast,schedule_sim,
collect_summary}.py`` and the native twins of ``streamyolo_torch.native``).

The same seeded NumPy inputs go through both. Tolerances: ``iou_ltwh`` and
the native ``bbox_iou_ltwh`` atol 1e-12; the matchers, association orders,
track ids and the shuffle exact; the extrapolations atol 1e-9;
``KFForecaster`` tracks, labels and ``tkidx`` equal, states, covariances and
forecasts atol 1e-9; ``forecast_results`` boxes atol 1e-9 with everything
else equal; ``sim`` equal as ``Fraction``s; the CSV equal byte for byte.
"""

import os
import pickle
from fractions import Fraction

import numpy as np
import pytest

from streamyolo_tpu.data.coco import COCO as JCOCO
from streamyolo_tpu.eval.cocoeval import bbox_iou_xywh as j_bbox_iou_xywh
from streamyolo_tpu.stream import Empirical as JEmpirical
from streamyolo_tpu.stream import SimClock as JSimClock
from streamyolo_tpu.stream import SimulatedDetector as JSimulatedDetector
from streamyolo_tpu.stream import collect_summary as jcollect
from streamyolo_tpu.stream import forecast as jforecast
from streamyolo_tpu.stream import schedule_sim as jsched
from streamyolo_tpu.stream import stream_sequence as j_stream_sequence
from streamyolo_tpu.stream import track as jtrack
from streamyolo_torch import native
from streamyolo_torch.data import COCO
from streamyolo_torch.stream import collect_summary as tcollect
from streamyolo_torch.stream import forecast as tforecast
from streamyolo_torch.stream import schedule_sim as tsched
from streamyolo_torch.stream import track as ttrack

from .torch_port_helpers import make_failing_detector, make_toy_detector, pin_threads


one_thread = pin_threads(1)


def random_boxes(rng, n, lo=0.0, hi=300.0):
    return np.column_stack([rng.uniform(lo, hi, n), rng.uniform(lo, hi, n),
                            rng.uniform(10, 60, n), rng.uniform(10, 60, n)])


def drifted(rng, boxes, sigma=3.0):
    return boxes + rng.normal(0, sigma, boxes.shape)


def assoc_case(seed):
    """Previous and new boxes: half the new ones drift from previous boxes
    (so they match), the rest are fresh; 3 labels."""
    rng = np.random.default_rng(seed)
    m, n = 12, 14
    prev = random_boxes(rng, m)
    new = np.concatenate([drifted(rng, prev[rng.permutation(m)[:7]]), random_boxes(rng, n - 7)])
    l1 = rng.integers(0, 3, m)
    l2 = rng.integers(0, 3, n)
    return prev, l1, new, l2


def tied_case():
    """Two previous boxes of label 1 with EXACTLY the same IoU with the new
    box (mirror images about it), one of label 2 on top of it, and a new
    box far from all of them."""
    prev = np.array([[0.0, 0, 10, 10], [10.0, 0, 10, 10], [5.0, 0, 10, 10]])
    new = np.array([[5.0, 0, 10, 10], [5.0, 0, 10, 10], [200.0, 200, 10, 10]])
    return prev, np.array([1, 1, 2]), new, np.array([1, 1, 1])


def test_iou_ltwh_matches_jax():
    rng = np.random.default_rng(0)
    a, b = random_boxes(rng, 9), random_boxes(rng, 11)
    np.testing.assert_allclose(ttrack.iou_ltwh(a, b), jtrack.iou_ltwh(a, b), atol=1e-12, rtol=0)
    assert ttrack.iou_ltwh(a, np.zeros((0, 4))).shape == (9, 0)
    assert ttrack.iou_ltwh(np.zeros((0, 4)), b).shape == (0, 11)


@pytest.mark.parametrize("seed", [0, 1, 2, "ties"])
def test_greedy_match_matches_jax(seed):
    prev, l1, new, l2 = tied_case() if seed == "ties" else assoc_case(seed)
    ious = ttrack.iou_ltwh(prev, new)
    want = jtrack._greedy_match(ious, l1, l2, 0.3)
    assert ttrack._greedy_match(ious, l1, l2, 0.3) == want
    assert len(want[0]) > 0 and len(want[2]) > 0


def test_greedy_match_ties_take_the_highest_row():
    prev, l1, new, l2 = tied_case()
    ious = ttrack.iou_ltwh(prev, new)
    assert ious[0, 0] == ious[1, 0] > 0.3
    # the first new box takes row 1 (the higher of the tied rows), the second
    # the remaining row 0; row 2 has the other label
    assert ttrack._greedy_match(ious, l1, l2, 0.3) == ([1, 0], [0, 1], [2])
    assert native.iou_assoc_greedy_cpp(ious, l1, l2, 0.3) == ([1, 0], [0, 1], [2])


@pytest.mark.parametrize("seed", [3, 4])
def test_cpp_twin_matches_python(seed):
    rng = np.random.default_rng(seed)
    m, n = 25, 30
    b1, b2 = random_boxes(rng, m), random_boxes(rng, n)
    l1, l2 = rng.integers(0, 3, m), rng.integers(0, 3, n)
    ious = ttrack.iou_ltwh(b1, b2)
    want = ttrack._greedy_match(ious, l1, l2, 0.2)
    assert native.iou_assoc_greedy_cpp(ious, l1, l2, 0.2) == want
    assert jtrack._greedy_match(ious, l1, l2, 0.2) == want


def test_bbox_iou_ltwh_cpp_matches_jax():
    rng = np.random.default_rng(7)
    dt, gt = random_boxes(rng, 9, hi=200), random_boxes(rng, 11, hi=200)
    crowd = (rng.random(11) < 0.3).astype(np.uint8)
    np.testing.assert_allclose(native.bbox_iou_ltwh_cpp(dt, gt, crowd),
                               j_bbox_iou_xywh(dt, gt, crowd), atol=1e-12, rtol=0)
    assert native.bbox_iou_ltwh_cpp(dt, np.zeros((0, 4)), np.zeros(0)).shape == (9, 0)


@pytest.mark.parametrize("no_unmatched1", [False, True])
@pytest.mark.parametrize("seed", [5, "ties"])
def test_iou_assoc_matches_jax(seed, no_unmatched1):
    prev, l1, new, l2 = tied_case() if seed == "ties" else assoc_case(seed)
    tracks1 = np.arange(100, 100 + len(prev), dtype=np.int64)
    got = ttrack.iou_assoc(prev, l1, tracks1, 200, new, l2, 0.3, no_unmatched1)
    want = jtrack.iou_assoc(prev, l1, tracks1, 200, new, l2, 0.3, no_unmatched1)
    assert got[:3] == want[:3] and got[4] == want[4]
    np.testing.assert_array_equal(got[3], want[3])
    assert got[3].dtype == want[3].dtype
    got_nt = ttrack.iou_assoc_no_tracks(prev, l1, new, l2, 0.3, no_unmatched1)
    assert got_nt == jtrack.iou_assoc_no_tracks(prev, l1, new, l2, 0.3, no_unmatched1)


def test_python_matcher_serves_when_the_native_build_fails(monkeypatch, caplog):
    def broken():
        raise native.NativeBuildError("g++ failed on streamyolo_native.cpp (exit 1):\nboom")

    monkeypatch.setattr(ttrack, "load", broken)
    ttrack._greedy_impl.cache_clear()
    try:
        with caplog.at_level("WARNING", logger="streamyolo_torch"):
            impl = ttrack._greedy_impl()
        assert impl is ttrack._greedy_match
        assert "boom" in caplog.text
        prev, l1, new, l2 = assoc_case(6)
        tracks1 = np.arange(len(prev))
        got = ttrack.iou_assoc(prev, l1, tracks1, 50, new, l2, 0.3)
        want = jtrack.iou_assoc(prev, l1, tracks1, 50, new, l2, 0.3)
        assert got[:3] == want[:3]
    finally:
        ttrack._greedy_impl.cache_clear()


@pytest.mark.parametrize("no_unmatched1", [False, True])
def test_track_based_shuffle_matches_jax(no_unmatched1):
    rng = np.random.default_rng(8)
    t1, t2 = rng.permutation(20)[:12], rng.permutation(20)[:9]
    got = ttrack.track_based_shuffle(t1, t2, no_unmatched1)
    want = jtrack.track_based_shuffle(t1, t2, no_unmatched1)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] > 0


@pytest.mark.parametrize("lt", [False, True])
def test_extrap_clean_up_matches_jax(lt):
    rng = np.random.default_rng(9)
    boxes = np.column_stack([rng.uniform(-80, 500, 40), rng.uniform(-80, 350, 40),
                             rng.uniform(-5, 60, 40), rng.uniform(-5, 60, 40)])
    got, keep = tforecast.extrap_clean_up(boxes, 480, 300, 75, lt)
    want, keep_r = jforecast.extrap_clean_up(boxes, 480, 300, 75, lt)
    np.testing.assert_array_equal(keep, keep_r)
    np.testing.assert_allclose(got, want, atol=1e-9, rtol=0)
    assert 0 < keep.sum() < len(keep)


@pytest.mark.parametrize("kind", ["lin", "quad", "quad_tail", "quad_no_velocity"])
def test_extrapolations_match_jax(kind):
    rng = np.random.default_rng(10)
    b1 = random_boxes(rng, 10)
    b2 = drifted(rng, b1, 5.0)
    if kind == "lin":
        args = (b1, b2, 1.5, 480, 300)
        got, want = tforecast.bbox_extrap_lin(*args), jforecast.bbox_extrap_lin(*args)
    else:
        n_v = {"quad": 10, "quad_tail": 6, "quad_no_velocity": 0}[kind]
        v1, v2 = rng.normal(0, 4, (n_v, 4)), rng.normal(0, 4, (n_v, 4))
        args = (b1, b2, v1, v2, 0.7, 1.3, 480, 300)
        got, want = tforecast.bbox_extrap_quad(*args), jforecast.bbox_extrap_quad(*args)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], atol=1e-9, rtol=0)
    assert len(got[0]) > 0


def kf_sequence(seed=11, steps=20):
    """20 updates of a scene whose objects move at constant velocity with
    noise: objects die, new ones are born, some updates are empty, and the
    times are irregular. Yields (t, boxes, scores, labels)."""
    rng = np.random.default_rng(seed)
    objs = [dict(box=random_boxes(rng, 1)[0], v=rng.normal(0, 40, 4) * [1, 1, 0.1, 0.1],
                 label=int(rng.integers(0, 3))) for _ in range(5)]
    t = 0.0
    for k in range(steps):
        t += float(rng.uniform(0.02, 0.08))
        if k % 4 == 3 and objs:  # a death
            objs.pop(int(rng.integers(0, len(objs))))
        if k % 3 == 2:  # a birth
            objs.append(dict(box=random_boxes(rng, 1)[0], v=rng.normal(0, 40, 4) * [1, 1, 0.1, 0.1],
                             label=int(rng.integers(0, 3))))
        if k == 9:
            yield t, np.zeros((0, 4)), np.zeros(0), np.zeros(0, np.int64)
            continue
        boxes = np.stack([o["box"] + o["v"] * t for o in objs]) + rng.normal(0, 1.0, (len(objs), 4))
        order = rng.permutation(len(objs))
        yield (t, boxes[order], rng.uniform(0.3, 1.0, len(objs)),
               np.array([objs[i]["label"] for i in order]))


def test_kf_forecaster_matches_jax():
    got, want = tforecast.KFForecaster(), jforecast.KFForecaster()
    births = 0
    for t, boxes, scores, labels in kf_sequence():
        got.update(t, boxes, scores, labels)
        want.update(t, boxes, scores, labels)
        np.testing.assert_array_equal(got.tracks, want.tracks)
        np.testing.assert_array_equal(got.labels, want.labels)
        assert got.tkidx == want.tkidx
        np.testing.assert_allclose(got.x, want.x, atol=1e-9, rtol=0)
        np.testing.assert_allclose(got.P, want.P, atol=1e-9, rtol=0)
        np.testing.assert_allclose(got.scores, want.scores, atol=0, rtol=0)
        for dt in (0.0, 0.033, 0.1):
            fg, fw = got.forecast(t + dt, 480, 300), want.forecast(t + dt, 480, 300)
            np.testing.assert_allclose(fg[0], fw[0], atol=1e-9, rtol=0)
            for a, b in zip(fg[1:], fw[1:]):
                np.testing.assert_array_equal(a, b)
        births = got.tkidx
    assert births > 8  # tracks were born after the first update, and some died
    assert len(got.tracks) < births


def lag1_run(db):
    """The lag-1 oracle streaming run of ``tests/test_track_forecast.py``:
    each sequence's ground truth, one frame late, through the JAX harness."""
    results = {}
    for sid, seq in enumerate(db.dataset["sequences"]):
        offset = min(i["id"] for i in db.dataset["images"] if i["sid"] == sid)

        def gt(fidx, offset=offset):
            anns = db.img_to_anns[offset + fidx]
            return ([[a["bbox"][0], a["bbox"][1], a["bbox"][0] + a["bbox"][2],
                      a["bbox"][1] + a["bbox"][3]] for a in anns],
                    [a["category_id"] for a in anns])

        n = sum(1 for i in db.dataset["images"] if i["sid"] == sid)
        results[seq] = j_stream_sequence(
            list(range(n)), JSimulatedDetector(gt, None), fps=30.0, clock=JSimClock(),
            runtime_dist=JEmpirical([1.0 / 30.0], seed=0), frame_arg_is_index=True)
    return results


@pytest.mark.parametrize("eta", [0, -1])
def test_forecast_results_matches_jax(fake_argoverse, eta):
    annot = os.path.join(fake_argoverse, "Argoverse-HD/annotations/val.json")
    jdb, tdb = JCOCO(annot), COCO(annot)
    results = lag1_run(jdb)
    want, want_assoc = jforecast.forecast_results(jdb, results, fps=30.0, eta=eta, min_size=20)
    got, got_assoc = tforecast.forecast_results(tdb, results, fps=30.0, eta=eta, min_size=20)
    assert got_assoc == want_assoc
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g["image_id"], g["category_id"], g["score"]) == \
            (w["image_id"], w["category_id"], w["score"])
        np.testing.assert_allclose(g["bbox"], w["bbox"], atol=1e-9, rtol=0)


def test_streamer_round_trip():
    """Submit, poll and forecast across the pipe to a spawned child; a busy
    detector refuses a frame; results come back in order, stamped with the
    submission time."""
    with tforecast.Streamer(make_toy_detector, match_iou_th=0.3) as s:
        for k in range(3):
            t = k * 0.1
            frame = [[10.0 + 30 * t]]
            assert s.submit(k, frame, t_sent=t)
            assert not s.submit(k, frame, t_sent=t)
            got = None
            for _ in range(600):
                got = s.poll(timeout=0.1)
                if got is not None:
                    break
            assert got == k
            assert s.forecaster.last_t == t
        bboxes, scores, labels, tracks = s.forecast(0.3, 1920, 1200)
        assert len(bboxes) == 1 and labels[0] == 2 and tracks[0] == 0
        assert bboxes[0][0] > 10.0  # moved forward
        # the same observations through the JAX forecaster
        want = jforecast.KFForecaster(match_iou_th=0.3)
        for k in range(3):
            x = 10.0 + 3 * k
            want.update(k * 0.1, [[x, 20.0, 10.0, 8.0]], [0.9], [2])
        np.testing.assert_allclose(bboxes, want.forecast(0.3, 1920, 1200)[0], atol=1e-9, rtol=0)
    assert not s._proc.is_alive()


def test_streamer_child_exception_surfaces():
    with tforecast.Streamer(make_failing_detector) as s:
        assert s.submit(0, [[1.0]], t_sent=0.0)
        with pytest.raises(RuntimeError, match="toy detector refuses frame"):
            for _ in range(600):
                s.poll(timeout=0.1)


R_VALUES = [Fraction(1, 2), Fraction(1), Fraction(5, 4), Fraction(3, 2), Fraction(7, 3),
            Fraction(2)]


@pytest.mark.parametrize("policy", sorted(tsched.POLICIES))
def test_sim_matches_jax(policy):
    assert sorted(tsched.POLICIES) == sorted(jsched.POLICIES)
    for r in R_VALUES:
        for eta in (-1, 0, 1):
            got = tsched.sim(tsched.POLICIES[policy], r, 13, eta)
            want = jsched.sim(jsched.POLICIES[policy], r, 13, eta)
            assert isinstance(got, (int, Fraction)) and got == want, (policy, r, eta)


def test_sim_rejects_queries_two_frames_ahead():
    for mod in (tsched, jsched):
        with pytest.raises(NotImplementedError):
            mod.sim(mod.p_idle_free, Fraction(3, 2), 13, eta=-2)


def test_collect_summary_writes_the_same_csv(tmp_path):
    rng = np.random.default_rng(12)
    dirs = []
    for name, has in (("both", ("eval", "time")), ("eval_only", ("eval",)),
                      ("time_only", ("time",)), ("empty", ())):
        d = tmp_path / name
        d.mkdir()
        if "eval" in has:
            with open(d / "eval_summary.pkl", "wb") as f:
                pickle.dump({"stats": rng.uniform(0, 1, 12)}, f)
        if "time" in has:
            with open(d / "time_info.pkl", "wb") as f:
                pickle.dump({"runtime_all": list(rng.uniform(0.01, 0.05, 30)),
                             "n_processed": 30, "n_total": 40, "n_small_runtime": 21}, f)
        dirs.append(str(d))
    got_rows = tcollect.collect_summary(dirs, str(tmp_path / "port.csv"))
    want_rows = jcollect.collect_summary(dirs, str(tmp_path / "jax.csv"))
    assert got_rows == want_rows and len(got_rows) == 3
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
