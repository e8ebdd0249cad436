"""The port's measuring tools on the CPU (``streamyolo_torch/tools/measure.py``,
``bench.py``, ``bench_suite.py``, ``train_sweep.py``, ``bench_hostpath.py``):

* ``count_work`` of the dual-frame forward at depth 0.33, width 0.25, 64x96
  against XLA's cost analysis of the JAX model (``packed=False``, the call
  of ``tools/bench_suite.py::_cost``);
* the full-width steady ``on_pipe`` step counted on meta tensors against
  ``int8_conv_times.STEP_SHAPES``;
* every tool's ``main`` at a tiny width with ``--device cpu``: one JSON line,
  its keys, every time, rate and share null, the counts filled; the
  ``--remat`` train cells named with the ``_remat`` suffix and counting the
  recomputed forward;
* ``remat_steps.py``'s plain and remat steps equal bit for bit on the
  CPU;
* the chain ``bench.py`` times against the detector fed call by call;
* without a card and without ``--device cpu`` each tool raises before it
  runs anything;
* ``budget_table``'s arithmetic, and the ``--train`` fixture read back by
  the port's train loader.
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamyolo_tpu.models.dfp_pafpn import DFPPAFPN as JaxDFPPAFPN
from streamyolo_tpu.models.heads import TALHead as JaxTALHead
from streamyolo_tpu.models.yolox import StreamYOLO as JaxStreamYOLO
from streamyolo_torch.models import DFPPAFPN, StreamYOLO, TALHead
from streamyolo_torch.tools import bench, bench_hostpath, bench_suite, remat_steps, train_sweep
from streamyolo_torch.tools.int8_conv_times import STEP_SHAPES
from streamyolo_torch.tools.measure import count_work, meta_like, on_meta, roofline
from .torch_port_helpers import load_port, pin_threads

TINY = ["--device", "cpu", "--depth", "0.33", "--width", "0.25", "--input", "64", "96"]
# the share of XLA's count that is not a convolution's multiply-add at this
# size: BatchNorm, SiLU, the residual adds, the concats' copies are free, the
# decode (sigmoid, exp, grid adds). Measured 2.30 % (149,665,120 against
# 146,216,704 multiply-add FLOPs); the bound leaves room for XLA versions.
XLA_NON_CONV_SHARE_MAX = 0.03


one_thread = pin_threads(1)


def _taps(size: int, k: int, stride: int) -> int:
    """(output, tap) pairs along one axis whose tap reads the input, not the
    ``(k - 1) // 2`` padding: what XLA's cost analysis counts of a conv."""
    pad = (k - 1) // 2
    out = (size + 2 * pad - k) // stride + 1
    return sum(1 for o in range(out) for t in range(k) if 0 <= o * stride - pad + t < size)


def _conv_macs(shape) -> int:
    n, c, h, w, co, k, stride, groups = shape
    pad = (k - 1) // 2
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    return n * ho * wo * co * (c // groups) * k * k


def test_count_work_against_xla_cost_analysis():
    """The dense count (every tap, as the kernels compute) is above XLA's;
    the same calls counted as XLA counts a conv (padding taps left out) are
    below it by the elementwise operations XLA adds, under 3 % here."""
    jmodel = JaxStreamYOLO(backbone=JaxDFPPAFPN(depth=0.33, width=0.25, dtype=jnp.float32,
                                                packed=False),
                           head=JaxTALHead(num_classes=8, width=0.25, dtype=jnp.float32))
    x = jax.ShapeDtypeStruct((1, 64, 96, 6), jnp.float32)
    avals = jax.eval_shape(lambda k, x: jmodel.init(k, x, mode="off_pipe", train=False),
                           jax.random.PRNGKey(0), x)
    fn = jax.jit(lambda v, x: jmodel.apply(v, x, mode="off_pipe", train=False))
    cost = fn.lower(avals, x).compile().cost_analysis()
    xla_flops = float((cost[0] if isinstance(cost, (list, tuple)) else cost)["flops"])

    # the port's model holding the JAX variables' tree (zeros: a count
    # depends on the shapes alone)
    zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), avals)
    model = load_port(StreamYOLO(DFPPAFPN(0.33, 0.25), TALHead(num_classes=8, width=0.25)),
                      zeros)
    images = np.random.RandomState(0).randint(0, 255, (1, 64, 96, 6)).astype(np.uint8)
    work = count_work(model, torch.from_numpy(images), mode="off_pipe")
    assert work == count_work(on_meta(model), meta_like(images), mode="off_pipe")
    assert work["int8_ops"] == 0 and set(work["ops_by_format"]) == {"fp32"}
    assert len(work["calls"]) >= sum(1 for m in model.modules()
                                     if isinstance(m, torch.nn.Conv2d))
    unpadded = sum(2 * n * co * (c // g) * _taps(h, k, s) * _taps(w, k, s)
                   for n, c, h, w, co, k, s, g in (r["shape"] for r in work["calls"]))
    assert work["flops"] == sum(2 * _conv_macs(r["shape"]) for r in work["calls"])
    assert work["flops"] > xla_flops >= unpadded
    assert (xla_flops - unpadded) / xla_flops <= XLA_NON_CONV_SHARE_MAX


def test_full_width_step_count_on_meta_matches_step_shapes():
    """StreamYOLO-l's steady on_pipe step at 600x960, counted on meta
    tensors: the 128 ``BaseConv`` calls of ``STEP_SHAPES`` (29 shapes), the
    same multiply-adds, and the 9 prediction convs besides."""
    exp = bench.seeded_exp(bench.CONFIG)
    model = exp.get_model("cpu", dtype=torch.bfloat16)
    work = bench.step_work(model, (1, 600, 960, 3))
    blocks = [tuple(r["shape"]) for r in work["calls"] if r["base_conv"]]
    counts = {s: blocks.count(s) for s in set(blocks)}
    assert len(blocks) == 128 and len(counts) == 29
    assert sorted(counts.items()) == sorted((s, n) for n, s in STEP_SHAPES)
    block_macs = sum(r["macs"] for r in work["calls"] if r["base_conv"])
    assert block_macs == sum(n * _conv_macs(s) for n, s in STEP_SHAPES)
    assert len(work["calls"]) - len(blocks) == 9
    assert work["ops_by_format"] == {"bf16": work["flops"]}
    # off the card a roofline has the counts and no time or share
    r = roofline(work, 1e-3, torch.device("cpu"))
    assert r["tflops"] == work["flops"] / 1e12 and r["mfu"] is None and r["bound_ms"] is None
    assert r["format"] == "bf16" and r["peaks"] == {"bf16": 989.0}


def test_roofline_prices_each_format_at_its_peak():
    work = {"flops": 989e9, "int8_ops": 1979e9, "bytes": 3.35e9,
            "ops_by_format": {"bf16": 989e9, "int8": 1979e9}}
    card = torch.device("cuda")  # arithmetic only: nothing runs on it
    r = roofline(work, 4e-3, card)
    assert r["mfu"] == pytest.approx(0.5) and r["hbm_share"] == pytest.approx(0.25)
    assert r["bound_ms"] == pytest.approx(2.0) and r["bound_by"] == "operations"
    assert r["format"] == "bf16+int8"
    r = roofline({**work, "bytes": 3.35e10}, 20e-3, card)
    assert r["bound_by"] == "bytes" and r["bound_ms"] == pytest.approx(10.0)
    no_ops = roofline({"flops": 0, "int8_ops": 0, "bytes": 3.35e9, "ops_by_format": {}},
                      2e-3, card)
    assert no_ops["mfu"] is None and no_ops["hbm_share"] == pytest.approx(0.5)


def _times(obj, path=""):
    """(path, value) of every time-valued key of a tool's line."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            p = f"{path}.{k}"
            if re.search(r"(^|_)ms(_|$)", k) and not isinstance(v, dict) \
                    and k not in ("deadline_ms", "resize_ms"):
                yield p, v
            elif k in ("mfu", "hbm_share", "vs_baseline", "value", "frames_per_sec",
                       "imgs_per_sec", "peak_memory_gb", "fixture_write_s",
                       "per_worker_imgs_per_sec", "train_step_imgs_per_sec",
                       "overlap_efficiency", "streams_per_card", "bound_by", "winner"):
                yield p, v
            else:
                yield from _times(v, p)
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            yield from _times(v, f"{path}[{i}]")


def _tflops(obj):
    if isinstance(obj, dict):
        for k, v in obj.items():
            if k == "tflops":
                yield v
            else:
                yield from _tflops(v)
    elif isinstance(obj, list):
        for v in obj:
            yield from _tflops(v)


TOOL_RUNS = {
    "bench": (bench, TINY + ["--samples", "1", "--steps", "2"],
              ("metric", "value", "unit", "vs_baseline", "operating_point", "device", "mfu",
               "step_ms", "median_step_ms", "graphs")),
    "bench_suite all": (bench_suite, ["all", "--batch", "2", "--samples", "1", "--steps", "1"]
                        + TINY, ("device", "stream_d0.33_w0.25_fp32_b2",
                                 "stream_d0.33_w0.25_bf16_b2", "eval_fwd_d0.33_w0.25_b2",
                                 "eval_dedup_d0.33_w0.25_b2", "train_d0.33_w0.25_b2")),
    "bench_suite stream_int8": (bench_suite, ["stream_int8", "--samples", "1", "--steps", "1"]
                                + TINY, ("device", "stream_d0.33_w0.25_int8_b1")),
    "bench_suite stream_sweep": (bench_suite, ["stream_sweep", "--batches", "1,2", "--samples",
                                               "1", "--steps", "1"] + TINY,
                                 ("stream_d0.33_w0.25_bf16_b1", "stream_d0.33_w0.25_bf16_b2",
                                  "capacity_30fps_bf16")),
    "bench_suite train_parts": (bench_suite, ["train_parts", "--batch", "2", "--samples", "1",
                                              "--steps", "1"] + TINY,
                                tuple(f"train_parts_d0.33_w0.25_{p}_b2"
                                      for p in bench_suite.TRAIN_PARTS)),
    "bench_suite train_s --remat": (bench_suite, ["train_s", "--remat", "--batch", "2",
                                                  "--samples", "1", "--steps", "1"] + TINY,
                                    ("device", "train_d0.33_w0.25_b2_remat")),
    "bench_suite train_parts --remat": (bench_suite, ["train_parts", "--remat", "--batch", "2",
                                                      "--samples", "1", "--steps", "1"] + TINY,
                                        tuple(f"train_parts_d0.33_w0.25_{p}_b2_remat"
                                              for p in bench_suite.TRAIN_PARTS)),
    "train_sweep": (train_sweep, ["2", "--samples", "1", "--chain", "1"] + TINY,
                    ("model", "input", "device", "points")),
    "bench_hostpath": (bench_hostpath, TINY + ["--samples", "2", "--step-samples", "1",
                                               "--steps", "2"],
                       ("device", "host", "transfers", "step", "budget")),
    "bench_hostpath --train": (bench_hostpath,
                               ["--train"] + TINY + ["--train-batch", "2", "--train-batches",
                                                     "1", "--train-frames", "3",
                                                     "--train-workers", "0"],
                               ("device", "train")),
}


@pytest.mark.parametrize("run", sorted(TOOL_RUNS))
def test_tool_main_on_cpu_prints_counts_and_no_times(run, capsys):
    tool, argv, keys = TOOL_RUNS[run]
    assert tool.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    line = json.loads(lines[-1])
    assert all(k in line for k in keys), sorted(line)
    assert line["device"] == {"platform": "cpu", "kind": "cpu", "nvidia_smi": None}
    times = dict(_times(line))
    assert times and all(v is None for v in times.values()), \
        {p: v for p, v in times.items() if v is not None}
    counted = [t for t in _tflops(line) if t is not None]
    assert counted and any(t > 0 for t in counted)
    if run == "bench":
        assert line["graphs"]["aot_loaded"] and line["metric"].endswith("_64x96")
    if run == "bench_suite stream_int8":
        cell = line["stream_d0.33_w0.25_int8_b1"]
        assert cell["tops_int8"] > 0 and cell["format"] == "bf16+int8"
    if run.startswith("bench_suite train"):
        # the backward is 2x the forward's convolutions, 3x with the re-run
        # forward of --remat; the whole step 3x, or 4x
        remat = run.endswith("--remat")
        cells = [k for k in line if k != "device"]
        assert all(k.endswith("_remat") == remat for k in cells), cells
        fwd = train_sweep.forward_work(
            bench.seeded_exp(train_sweep.CONFIG, 0.33, 0.25).get_model("cpu"),
            torch.empty((2, 64, 96, 6), dtype=torch.uint8))["flops"] / 1e12
        suffix = "_remat" if remat else ""
        if "train_parts" in run:
            parts = {p: line[f"train_parts_d0.33_w0.25_{p}_b2{suffix}"]["tflops"]
                     for p in ("forward", "backward")}
            assert parts["forward"] == pytest.approx(fwd)
            assert parts["backward"] == pytest.approx((3 if remat else 2) * fwd)
        else:
            assert line[f"train_d0.33_w0.25_b2{suffix}"]["tflops"] == pytest.approx(4 * fwd)
            assert line[f"train_d0.33_w0.25_b2{suffix}"]["remat"] is True
    if run == "bench_hostpath --train":
        assert line["train"]["jpeg_mbytes"] > 0
        assert {"loader_w0", "loader_w0_cache", "overlap", "sizing"} <= set(line["train"])


def test_remat_steps_on_cpu(capsys):
    """``remat_steps`` at a tiny width: the second plain step and the
    remat step equal the first plain step bit for bit on the CPU; no memory
    figure."""
    assert remat_steps.main(["--batch", "2"] + TINY) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["device"]["platform"] == "cpu" and line["tensors"] > 1000
    assert line["plain"]["lr"] > 0 and line["plain"]["peak_memory_gb"] is None
    assert set(line["steps"]) == {"plain_again", "remat"}
    for kind, r in line["steps"].items():
        assert r["differ"] == r["above_plain_gap"] == 0 and not r["stats_differ"], kind
        assert r["total_loss"] == line["plain"]["total_loss"], kind


def test_chain_rows_equal_detector_calls():
    """``bench.chain``'s last rows after N steps over the frame pool equal a
    detector fed the same frames call by call, bit for bit; the carried
    buffer shows (a fresh detector's star step on the last frame differs)."""
    from streamyolo_torch.stream import CUDAStreamDetector

    model = bench.serving_model(bench.seeded_exp(bench.CONFIG, 0.33, 0.25), torch.bfloat16,
                                torch.device("cpu"))
    kw = dict(input_size=(64, 96), conf_thre=bench.CONF_THRE, nms_thre=bench.NMS_THRE,
              num_classes=bench.NUM_CLASSES, pre_nms_topk=bench.PRE_NMS_TOPK, use_bf16=True,
              device="cpu")
    pool = bench.frame_pool(1, (64, 96), torch.device("cpu"))
    n = 6
    rows = bench.chain(CUDAStreamDetector(model, **kw), pool, n)
    called = CUDAStreamDetector(model, **kw)
    for i in range(n):
        called(pool[i % len(pool)][0].numpy(), preprocessed=True)
    assert rows.shape == (1, 126, 8)  # K = every anchor of a 64x96 input (< top-k 200)
    assert np.array_equal(rows[0].numpy(), called.last_rows)
    assert (called.last_rows[:, 7] > 0.5).any()
    star = CUDAStreamDetector(model, **kw)
    star(pool[(n - 1) % len(pool)][0].numpy(), preprocessed=True)
    assert not np.array_equal(star.last_rows, called.last_rows)


@pytest.mark.parametrize("tool,argv", [
    (bench, ["--depth", "0.33", "--width", "0.25"]),
    (bench_suite, ["all", "--depth", "0.33", "--width", "0.25"]),
    (train_sweep, ["2"]),
    (bench_hostpath, []),
    (bench_hostpath, ["--train"]),
    (remat_steps, []),
], ids=["bench", "bench_suite", "train_sweep", "bench_hostpath", "bench_hostpath_train",
        "remat_steps"])
def test_tools_refuse_the_cpu_by_default(tool, argv, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is available")

    def ran(*args, **kwargs):
        raise AssertionError("the tool ran without a device")

    for mod, name in ((bench, "serving_model"), (train_sweep, "train_setup"),
                      (bench_hostpath, "bench_host"), (bench_hostpath, "bench_train")):
        monkeypatch.setattr(mod, name, ran)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv)


def _min_median(median):
    return {"min_ms": None if median is None else median / 2, "median_ms": median}


def test_budget_table_adds_the_measured_medians():
    host = {"resize_ms": _min_median(1.25), "unpack_ms": _min_median(0.02)}
    transfers = {"h2d_input": {"pageable_ms": _min_median(0.5), "pinned_ms": _min_median(0.2)},
                 "h2d_raw": {"pageable_ms": _min_median(2.0), "pinned_ms": _min_median(0.75)},
                 "d2h_rows": {"pageable_ms": _min_median(0.03), "pinned_ms": _min_median(0.01)}}
    steps = {"host_resize": {"step_ms": 3.0, "median_step_ms": 4.0},
             "device_resize": {"step_ms": 3.5, "median_step_ms": 4.25}}
    b = bench_hostpath.budget_table(host, transfers, steps)
    assert b["host_resize"] == {"resize_ms": 1.25, "h2d_ms": 0.5, "step_ms": 4.0,
                                "d2h_ms": 0.03, "unpack_ms": 0.02,
                                "total_ms": pytest.approx(5.8), "h2d_pinned_ms": 0.2}
    assert b["device_resize"] == {"resize_ms": 0.0, "h2d_ms": 2.0, "step_ms": 4.25,
                                  "d2h_ms": 0.03, "unpack_ms": 0.02,
                                  "total_ms": pytest.approx(6.3), "h2d_pinned_ms": 0.75}
    assert b["winner"] == "host_resize"
    transfers["h2d_raw"]["pageable_ms"] = _min_median(0.5)
    assert bench_hostpath.budget_table(host, transfers, steps)["winner"] == "device_resize"
    transfers["d2h_rows"]["pageable_ms"] = _min_median(None)  # not measured
    b = bench_hostpath.budget_table(host, transfers, steps)
    assert b["host_resize"]["total_ms"] is None and b["winner"] is None


def test_train_fixture_reads_back_through_the_train_loader(tmp_path):
    from streamyolo_torch.data.image_io import imread

    root = bench_hostpath.write_train_fixture(tmp_path, n_seqs=2, n_frames=3, hw=(128, 192))
    ann = json.loads((tmp_path / "Argoverse-HD" / "annotations" / "train.json").read_text())
    assert len(ann["images"]) == len(ann["annotations"]) == 6
    frame = imread(str(tmp_path / "Argoverse-1.1" / "tracking" / "seq1" / "f2.jpg"))
    assert frame.shape == (128, 192, 3) and frame.std() > 10  # textured, not flat
    loader = bench_hostpath.train_loader(root, 2, 0, False, True, (64, 96))
    images, (labels, support), *_ = next(iter(loader))
    assert images.shape == (2, 64, 96, 6) and images.dtype == np.uint8
    for lab in (labels, support):
        boxes = lab[lab[..., 3:].sum(-1) > 0]  # the annotated rows of both images
        assert len(boxes) >= 1 and lab.shape[0] == 2
        # one car a frame: 192 / 16 x 128 * 0.075 px, halved by the letterbox
        assert boxes[:, 0].tolist() == [2] * len(boxes)
        np.testing.assert_allclose(boxes[:, 3:5], [[6.0, 4.8]] * len(boxes), atol=1e-4)
