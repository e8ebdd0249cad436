"""The streaming-perception chain of the PyTorch port against the JAX
package, on the CPU, and the port's rehearsal tool.

The whole chain: one synthetic Argoverse-HD fixture (2 sequences x 10 raw
128x192 frames, written as JPEGs by the JAX generator), ``TPUStreamDetector``
against ``CUDAStreamDetector(device="cpu")`` on the same converted weights
(depth 0.33, width 0.25, obj/cls biases lifted, fp32), pseudo ground truth
from the JAX detector's every-frame run, then ``run_streaming_detection``
under ``SimClock`` with the same latency samples and seed, and
``streaming_eval``. Tolerances: timestamps, input frames, runtimes and the
association counts EQUAL; labels equal, boxes atol 1e-3 (pixels), scores
atol 1e-5; sAP, sAP50 and sAP75 within 0.1 points.
"""

import json
import os
import pickle
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from streamyolo_tpu.data import coco as jcoco
from streamyolo_tpu.data import dbcode as jdbcode
from streamyolo_tpu.models import DFPPAFPN as JDFPPAFPN
from streamyolo_tpu.models import StreamYOLO as JStreamYOLO
from streamyolo_tpu.models import TALHead as JTALHead
from streamyolo_tpu.stream import clock as jclock
from streamyolo_tpu.stream import online as jonline
from streamyolo_tpu.stream import pairing as jpairing
from streamyolo_tpu.stream import runtime_dist as jrd
from streamyolo_torch.data import coco as tcoco
from streamyolo_torch.models import DFPPAFPN, StreamYOLO, TALHead
from streamyolo_torch.stream import clock as tclock
from streamyolo_torch.stream import online as tonline
from streamyolo_torch.stream import pairing as tpairing
from streamyolo_torch.stream import runtime_dist as trd
from streamyolo_torch.tools import sap_rehearsal as ttool

from .torch_port_helpers import lift_pred_biases, load_port

pytest.importorskip("cv2")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

RAW = (128, 192)
KW = dict(input_size=(64, 96), in_scale=0.5, conf_thre=0.01, nms_thre=0.65,
          num_classes=8, pre_nms_topk=200, use_bf16=False)
SAMPLES = [0.02, 0.05, 0.07]  # draws above 33 ms make the run skip frames


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp("chain")
    jdbcode.make_synthetic_argoverse(str(root), seq_lens=(10, 10), size=RAW, seed=0)
    return (str(root / "Argoverse-1.1" / "tracking"),
            str(root / "Argoverse-HD" / "annotations" / "val.json"))


@pytest.fixture(scope="module")
def detectors():
    jmodel = JStreamYOLO(backbone=JDFPPAFPN(0.33, 0.25), head=JTALHead(num_classes=8, width=0.25))
    init = jax.jit(lambda key, x: jmodel.init(key, x, mode="off_pipe"))
    variables = lift_pred_biases(jax.tree_util.tree_map(
        np.asarray, init(jax.random.PRNGKey(2), jnp.zeros((1, 64, 96, 6), jnp.float32))))
    port = load_port(StreamYOLO(DFPPAFPN(0.33, 0.25), TALHead(num_classes=8, width=0.25)),
                     variables)
    return (jonline.TPUStreamDetector(jmodel, variables, **KW),
            tonline.CUDAStreamDetector(port, device="cpu", **KW))


def assert_parsed_close(got, want):
    assert len(got) == len(want)
    for (bb, sc, lb, _), (bb_r, sc_r, lb_r, _) in zip(got, want):
        np.testing.assert_array_equal(lb, lb_r)
        np.testing.assert_allclose(bb, bb_r, atol=1e-3, rtol=0)
        np.testing.assert_allclose(sc, sc_r, atol=1e-5, rtol=0)


def test_whole_chain_matches_jax(fixture, detectors, tmp_path):
    import sap_rehearsal as jtool

    data_root, annot = fixture
    jdet, tdet = detectors
    jdb, tdb = jcoco.COCO(annot), tcoco.COCO(annot)

    # every-frame oracle runs of both detectors
    j_oracle = jtool._offline_ccf(jdb, data_root, jdet)
    t_oracle = ttool.offline_ccf(tdb, tdet, tonline.imread_loader(tdb, data_root))
    assert len(t_oracle) == len(j_oracle) > 0
    for t, j in zip(t_oracle, j_oracle):
        assert (t["image_id"], t["category_id"]) == (j["image_id"], j["category_id"])
        np.testing.assert_allclose(t["bbox"], j["bbox"], atol=1e-3, rtol=0)
        assert abs(t["score"] - j["score"]) <= 1e-5

    # one pseudo ground truth (the JAX run's top tenth of scores) for both
    score_th = float(np.percentile([d["score"] for d in j_oracle], 90))
    pgt_path = str(tmp_path / "pseudo_gt.json")
    jdbcode.pseudo_gt_from_detections(jdb.dataset, j_oracle, score_th, out_path=pgt_path)
    jgt, tgt = jcoco.COCO(pgt_path), tcoco.COCO(pgt_path)
    assert len(tgt.anns) > 0

    jdir, tdir = str(tmp_path / "jax_run"), str(tmp_path / "port_run")
    j_info = jonline.run_streaming_detection(
        jgt, data_root, jdir, jdet, clock=jclock.SimClock(),
        runtime_dist=jrd.Empirical(SAMPLES, seed=0), overwrite=True)
    t_info = tonline.run_streaming_detection(
        tgt, data_root, tdir, tdet, clock=tclock.SimClock(),
        runtime_dist=trd.Empirical(SAMPLES, seed=0), overwrite=True)
    assert t_info == j_info
    assert 0 < t_info["n_processed"] < t_info["n_total"] == 20
    for seq in tgt.dataset["sequences"]:
        with open(os.path.join(tdir, seq + ".pkl"), "rb") as f:
            t = pickle.load(f)
        with open(os.path.join(jdir, seq + ".pkl"), "rb") as f:
            j = pickle.load(f)
        for key in ("timestamps", "input_fidx", "runtime"):
            assert t[key] == j[key], key
        assert_parsed_close(t["results_parsed"], j["results_parsed"])

    j_eval, j_assoc = jpairing.streaming_eval(jgt, jdir, overwrite=True)
    t_eval, t_assoc = tpairing.streaming_eval(tgt, tdir, overwrite=True)
    assert t_assoc == j_assoc
    assert t_eval["evaluator"] == "COCOeval_opt"
    np.testing.assert_allclose(100 * t_eval["stats"][:3], 100 * j_eval["stats"][:3],
                               atol=0.1, rtol=0)
    assert 0 < t_eval["stats"][0] <= 1


def _run_tools(tmp_path, name, extra):
    import sap_rehearsal as jtool

    common = ["--seqs", "2", "--frames", "25", "--perfect-detector"] + extra
    out_j, out_t = tmp_path / f"jax_{name}", tmp_path / f"port_{name}"
    argv = sys.argv
    try:
        sys.argv = ["sap_rehearsal.py", "-f", os.path.join(REPO, "cfgs", "l_s50_onex_dfp_tal_filp.py"),
                    "--out-dir", str(out_j), "--size", "60", "96"] + common
        jtool.main()
    finally:
        sys.argv = argv
    summary = ttool.main(["--out-dir", str(out_t), "--frame-size", "60", "96"] + common)
    with open(out_j / "rehearsal_summary.json") as f:
        want = json.load(f)
    with open(out_t / "rehearsal_summary.json") as f:
        assert json.load(f) == summary
    return out_t, summary, want


def test_perfect_detector_tool_matches_jax(tmp_path):
    """Both tools with the perfect detector write equal summaries (the
    ``config`` names differ: a config file there, a model size here), every
    artifact of the chain, and a 45 ms latency scores strictly worse than
    a 1.46 ms one."""
    out, fast, want = _run_tools(tmp_path, "fast", ["--latency-ms", "1.46"])
    assert fast.pop("config") == "streamyolo_l" and want.pop("config")
    assert fast == want
    for f in ("runtime_zoo.pkl", "stream_run/time_info.pkl", "stream_run/results_ccf.pkl",
              "stream_run/eval_assoc.pkl", "stream_run/eval_summary.pkl"):
        assert os.path.isfile(out / f), f
    assert fast["frames"] == {"total": 50, "processed": 50, "faster_than_frame_interval": 50}
    assert fast["association"] == {"miss": 2, "in_time": 0, "mismatch": 48}
    assert 0 < fast["sAP"] < 100 and fast["sAP50"] > fast["sAP75"]

    _, slow, want = _run_tools(tmp_path, "slow", ["--latency-ms", "45"])
    slow.pop("config"), want.pop("config")
    assert slow == want
    assert slow["frames"]["processed"] < 50
    assert slow["association"]["mismatch"] > fast["association"]["mismatch"]
    assert slow["sAP"] < fast["sAP"] and slow["sAP50"] < fast["sAP50"]


@pytest.mark.parametrize("extra", [
    # CPU walls depend on the host's load: --perf-factor scales them far
    # below one frame period, so every frame is processed whatever they read
    ["--in-memory", "--device-preproc", "--measure", "3", "--perf-factor", "1e6"],
    ["--latency-ms", "1.4,1.5"],
])
def test_tool_real_detector_on_cpu(tmp_path, extra):
    """The tool's real-detector chain (StreamYOLO-s from seeded weights,
    oracle pseudo ground truth, SimClock run, scoring) on the CPU: in memory
    with the device-preprocess path and measured latencies, and from
    written JPEGs with given latencies."""
    out = tmp_path / "real"
    summary = ttool.main(["--out-dir", str(out), "--size", "s", "--device", "cpu",
                          "--seqs", "2", "--frames", "5", "--frame-size", "128", "192",
                          "--conf", "1e-5", "--pgt-score-th", "1e-5"] + extra)
    assert summary["gt"] == "oracle"
    assert summary["frames"]["total"] == summary["frames"]["processed"] == 10
    assert summary["latency_ms"]["n_samples"] == (3 if "--measure" in extra else 2)
    assert summary["sAP"] is not None and 0 <= summary["sAP"] <= 100
    with open(out / "pseudo_gt.json") as f:
        assert len(json.load(f)["annotations"])
    assert os.path.isfile(out / "oracle_ccf.pkl")
    assert os.path.isdir(out / "fixture") == ("--in-memory" not in extra)


def test_tool_defaults_to_the_card(tmp_path):
    """Without ``--device`` the tool builds its detector on ``cuda``: on a
    host without a GPU it raises instead of running on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttool.main(["--out-dir", str(tmp_path), "--size", "s", "--in-memory", "--seqs", "1",
                    "--frames", "2", "--frame-size", "128", "192", "--latency-ms", "1"])


def test_measure_chain_needs_the_card(detectors):
    """``--measure-chain`` times with CUDA events: on the CPU it raises."""
    with pytest.raises(ValueError, match="CUDA events"):
        ttool.measure_chain(detectors[1], np.zeros((*RAW, 3), np.uint8), 2)
