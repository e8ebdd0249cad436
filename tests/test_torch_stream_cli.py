"""The streaming command lines of the PyTorch port against the JAX tools of
the same names, on the CPU: ``stream_det`` (``--sim-zoo``, ``--infinite``),
``offline_det``, ``streaming_eval``, ``forecast_kf``, ``collect_summary``
and the two-stage ``streamyolo.sh``.

One synthetic Argoverse-HD fixture (2 sequences x 10 raw 128x192 frames,
JPEGs written by the JAX generator), one ``.pth`` written from seeded JAX
variables of the StreamYOLO-s config (obj/cls prediction biases lifted to
0 so that NMS has candidates), ``--fp32``, a
runtime zoo with one fixed sample (so that the JAX tool's unseeded draws
are deterministic), ``--device cpu`` on the port's side. Tolerances, as
``tests/test_torch_rehearsal.py``: timestamps, input frames, runtimes and
``time_info`` equal; labels equal, boxes atol 1e-3 (pixels), scores atol
1e-5; sAP within 0.1 points; ``forecast_kf`` on the same JAX-made pkls:
equal results.
"""

import logging
import os
import pickle
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from streamyolo_tpu.data import dbcode as jdbcode
from streamyolo_tpu.exp import get_exp as j_get_exp
from streamyolo_torch.tools import collect_summary as t_collect
from streamyolo_torch.tools import forecast_kf as t_forecast_kf
from streamyolo_torch.tools import offline_det as t_offline_det
from streamyolo_torch.tools import precompile as t_precompile
from streamyolo_torch.tools import stream_det as t_stream_det
from streamyolo_torch.tools import streaming_eval as t_streaming_eval
from streamyolo_torch.utils.weights import jax_variables_to_state_dict

from .torch_port_helpers import child_env, lift_pred_biases, pin_threads

pytest.importorskip("cv2")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
CONFIG = "cfgs/s_s50_onex_dfp_tal_flip.py"
RAW = (128, 192)

one_thread = pin_threads(1)


def run_jax_tool(name, argv):
    """Run the JAX ``tools/<name>.py`` with ``argv`` as its command line."""
    saved = sys.argv
    sys.argv = [f"{name}.py", *argv]
    try:
        if name == "collect_summary":  # its CLI lives under the __main__ guard
            return runpy.run_path(os.path.join(REPO, "tools", "collect_summary.py"),
                                  run_name="__main__")
        import importlib

        return importlib.import_module(name).main()
    finally:
        sys.argv = saved


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The fixture, the weights, and the JAX and port runs of stream_det
    (``--sim-zoo``, ``--infinite``) and offline_det."""
    root = tmp_path_factory.mktemp("cli")
    jdbcode.make_synthetic_argoverse(str(root / "data"), seq_lens=(10, 10), size=RAW, seed=0)
    data_root = str(root / "data" / "Argoverse-1.1" / "tracking")
    annot = str(root / "data" / "Argoverse-HD" / "annotations" / "val.json")

    jexp = j_get_exp(os.path.join(REPO, CONFIG))
    variables = jax.tree_util.tree_map(np.asarray, jexp.init_model(jexp.get_model(), rng=4))
    variables = lift_pred_biases(variables)
    weights = str(root / "w.pth")
    torch.save(jax_variables_to_state_dict(variables), weights)
    zoo = str(root / "zoo.pkl")
    with open(zoo, "wb") as f:
        pickle.dump({"fixed": {"type": "empirical", "samples": [0.05]}}, f)

    common = ["--data-root", data_root, "--annot-path", annot, "-f", CONFIG, "-c", weights,
              "--fp32"]
    sim = ["--sim-zoo", zoo, "--sim-name", "fixed"]
    out = {"annot": annot, "data_root": data_root, "weights": weights, "root": root,
           "common": common}
    for side in ("jax", "port"):
        d = root / side
        jobs = {"sim": [*common, *sim, "--out-dir", str(d / "sim"), "--overwrite"],
                "inf": [*common, *sim, "--infinite", "--out-dir", str(d / "inf")]}
        for kind, argv in jobs.items():
            if side == "jax":
                run_jax_tool("stream_det", argv)
            else:
                t_stream_det.main([*argv, "--device", "cpu"])
            out[f"{side}_{kind}"] = str(d / kind)
        off = [*common, "--out-dir", str(d / "off")]
        if side == "jax":
            run_jax_tool("offline_det", off)
        else:
            t_offline_det.main([*off, "--device", "cpu"])
        out[f"{side}_off"] = str(d / "off")
    return out


def load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def assert_parsed_close(got, want):
    assert len(got) == len(want)
    for (bb, sc, lb), (bb_r, sc_r, lb_r) in zip((g[:3] for g in got), (w[:3] for w in want)):
        np.testing.assert_array_equal(lb, lb_r)
        np.testing.assert_allclose(bb, bb_r, atol=1e-3, rtol=0)
        np.testing.assert_allclose(sc, sc_r, atol=1e-5, rtol=0)


def assert_runs_match(got_dir, want_dir, seqs=("seq00", "seq01")):
    n = 0
    for seq in seqs:
        got, want = load(os.path.join(got_dir, seq + ".pkl")), load(os.path.join(want_dir, seq + ".pkl"))
        for key in ("timestamps", "input_fidx", "runtime"):
            assert got[key] == want[key], key
        assert_parsed_close(got["results_parsed"], want["results_parsed"])
        n += len(got["timestamps"])
    return n


def assert_ccf_close(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g["image_id"], g["category_id"]) == (w["image_id"], w["category_id"])
        np.testing.assert_allclose(g["bbox"], w["bbox"], atol=1e-3, rtol=0)
        assert abs(g["score"] - w["score"]) <= 1e-5


def test_stream_det_sim_zoo_matches_jax(runs):
    n = assert_runs_match(runs["port_sim"], runs["jax_sim"])
    got = load(os.path.join(runs["port_sim"], "time_info.pkl"))
    assert got == load(os.path.join(runs["jax_sim"], "time_info.pkl"))
    # 50 ms per frame at 30 fps: every other frame or so, none in time
    assert 0 < got["n_processed"] == n < got["n_total"] == 20
    assert got["n_small_runtime"] == 0


def test_stream_det_infinite_matches_jax(runs):
    # every frame is processed; those landing past the horizon are dropped
    assert assert_runs_match(runs["port_inf"], runs["jax_inf"]) == 2 * 9


def test_offline_det_matches_jax(runs):
    got = load(os.path.join(runs["port_off"], "results_ccf.pkl"))
    assert_ccf_close(got, load(os.path.join(runs["jax_off"], "results_ccf.pkl")))
    assert {r["image_id"] for r in got} == set(range(20))
    got_s = load(os.path.join(runs["port_off"], "eval_summary.pkl"))["stats"]
    want_s = load(os.path.join(runs["jax_off"], "eval_summary.pkl"))["stats"]
    np.testing.assert_allclose(100 * np.asarray(got_s), 100 * np.asarray(want_s), atol=0.1)


def test_streaming_eval_matches_jax(runs, tmp_path):
    ann = runs["annot"]
    run_jax_tool("streaming_eval", ["--annot-path", ann, "--result-dir", runs["jax_sim"],
                                    "--out-dir", str(tmp_path / "jax")])
    summary, assoc = t_streaming_eval.main(["--annot-path", ann, "--result-dir", runs["port_sim"],
                                            "--out-dir", str(tmp_path / "port")])
    assert assoc == load(tmp_path / "jax" / "eval_assoc.pkl")
    assert assoc["miss"] == 2 * 2  # 50 ms: the first output lands in frame 2
    want = load(tmp_path / "jax" / "eval_summary.pkl")["stats"]
    np.testing.assert_allclose(100 * np.asarray(summary["stats"]), 100 * np.asarray(want),
                               atol=0.1)
    for name in ("results_ccf.pkl", "eval_assoc.pkl", "eval_summary.pkl"):
        assert (tmp_path / "port" / name).is_file()
    assert_ccf_close(load(tmp_path / "port" / "results_ccf.pkl"),
                     load(tmp_path / "jax" / "results_ccf.pkl"))


def test_forecast_kf_matches_jax_on_the_same_run(runs, tmp_path):
    argv = ["--annot-path", runs["annot"], "--in-dir", runs["jax_sim"]]
    run_jax_tool("forecast_kf", [*argv, "--out-dir", str(tmp_path / "jax")])
    got = t_forecast_kf.main([*argv, "--out-dir", str(tmp_path / "port")])
    want = load(tmp_path / "jax" / "results_ccf.pkl")
    assert got["results_ccf"] == want and len(want) > 0
    assert load(tmp_path / "port" / "results_ccf.pkl") == want
    np.testing.assert_array_equal(got["summary"]["stats"],
                                  load(tmp_path / "jax" / "eval_summary.pkl")["stats"])


def test_collect_summary_cli_matches_jax(runs, tmp_path):
    dirs = [runs["jax_sim"], runs["port_sim"], runs["port_off"], runs["port_inf"]]
    run_jax_tool("collect_summary", [*dirs, "--out", str(tmp_path / "jax.csv")])
    rows = t_collect.main([*dirs, "--out", str(tmp_path / "port.csv")])
    assert len(rows) == 3  # the --infinite run writes neither file
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()


def test_streamyolo_sh_runs_both_stages(runs, tmp_path):
    """The two stages of the shell pipeline; the extra arguments reach
    ``stream_det`` (a simulated clock here, so that the CPU's speed does not
    decide how many frames land before the horizon)."""
    env = child_env(1, dict(os.environ, DATA_ROOT=runs["data_root"], ANNOT_PATH=runs["annot"]))
    out = tmp_path / "sh"
    proc = subprocess.run(
        ["bash", "streamyolo_torch/tools/streamyolo.sh", CONFIG, runs["weights"], str(out),
         "--fp32", "--device", "cpu", "--sim-zoo", str(runs["root"] / "zoo.pkl"),
         "--sim-name", "fixed"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert load(out / "time_info.pkl") == load(os.path.join(runs["port_sim"], "time_info.pkl"))
    assert load(out / "eval_assoc.pkl") == {"miss": 4, "in_time": 0, "mismatch": 36}
    assert (out / "eval_summary.pkl").is_file()


@pytest.mark.parametrize("tool", [t_stream_det, t_offline_det])
def test_port_cli_without_a_card_raises(runs, tool, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        tool.main([*runs["common"], "--out-dir", str(tmp_path)])


def test_stream_det_refuses_aot_dir_and_jax_checkpoints(runs, tmp_path, monkeypatch, caplog):
    """``--aot-dir`` (bf16 modules, ``--sim-zoo``): a directory without this
    configuration's graphs is a logged miss and the run is eager; after
    ``precompile --serve DIR --streams 2 --device cpu`` the run serves from
    the exported steps (``aot_loaded``, every call a replay) and writes the
    eager run's pkls. A JAX ``.pkl`` is refused; ``--infinite`` needs
    ``--sim-zoo``."""
    made = []
    build = t_stream_det.build_detector
    monkeypatch.setattr(t_stream_det, "build_detector",
                        lambda *a, **k: made.append(build(*a, **k)) or made[-1])
    bf16 = [a for a in runs["common"] if a != "--fp32"] + [
        "--device", "cpu", "--sim-zoo", str(runs["root"] / "zoo.pkl"), "--sim-name", "fixed"]
    aot = tmp_path / "aot"
    aot.mkdir()
    with caplog.at_level(logging.WARNING, logger="streamyolo_torch"):
        t_stream_det.main([*bf16, "--out-dir", str(tmp_path / "miss"), "--aot-dir", str(aot)])
    assert not made[-1].aot_loaded
    assert any("no captured-graph manifests" in r.message for r in caplog.records)
    paths = t_precompile.main(["-f", CONFIG, "--serve", str(aot), "--streams", "2", "--device",
                               "cpu", "-b", "1", "test_size", f"({RAW[0] // 2}, {RAW[1] // 2})"])
    assert len(paths["serve"]) == 6 and all(os.path.isfile(p) for p in paths["serve"])
    info = t_stream_det.main([*bf16, "--out-dir", str(tmp_path / "hit"), "--aot-dir", str(aot)])
    det = made[-1]
    assert det.aot_loaded and det.graphs is not None
    # stars: the probe's, the warm-up's, one per sequence; calls after the probe
    # and the warm-up: one per result, and at most one per sequence whose
    # result lands past the horizon
    calls = sum(det.graphs.replays) - 2 - t_stream_det.WARMUP_FRAMES
    assert det.graphs.replays[0] == 4
    assert info["n_processed"] <= calls <= info["n_processed"] + 2
    for seq in ("seq00", "seq01"):
        hit, miss = load(tmp_path / "hit" / f"{seq}.pkl"), load(tmp_path / "miss" / f"{seq}.pkl")
        assert hit["timestamps"] == miss["timestamps"] and len(hit["results_parsed"]) > 0
        for a, b in zip(hit["results_parsed"], miss["results_parsed"], strict=True):
            assert all(np.array_equal(u, v) for u, v in zip(a[:3], b[:3]))

    argv = [*runs["common"], "--out-dir", str(tmp_path), "--device", "cpu"]
    pkl = [a if a != runs["weights"] else str(tmp_path / "w.pkl") for a in argv]
    with pytest.raises(ValueError, match="export_safetensors"):
        t_stream_det.main(pkl)
    with pytest.raises(SystemExit, match="--infinite requires --sim-zoo"):
        t_stream_det.main([*argv, "--infinite"])
