"""Serving from captured steps (``aot_dir``) and the package-free
``.safetensors`` path of the PyTorch port, on the CPU.

Depth 0.33, width 0.25 at 64x96 (``tests/test_torch_stream.py``'s size),
fp32, the JAX-initialised weights of that file converted into the port with
the obj/cls prediction biases lifted to 0 (so NMS has candidates); the int8
model is
the JAX package's quantization of the same weights (``packed=False``, so
that the stem quantizes in both packages). Tolerances:

  * ``_build_stream_step`` / ``_build_multi_stream_step`` over static
    tensors against the detectors' eager steps: bit for bit (the same
    operations on the same data), over a chain with a restart, and an
    all-False star mask against no mask;
  * against the JAX detectors on the same weights: the detector tolerance
    of ``tests/test_torch_stream.py`` (labels equal, boxes atol 1e-3 in
    pixels / in_scale, scores atol 1e-5), on each chain's frames up to and
    including the restart. That absolute bound sits at the float32 noise
    of these random weights (0.96e-3 px on the first frame, as in
    ``tests/test_torch_stream.py``); later frames of these chains cross it
    (1.08e-3 px at the sixth multi-stream step; two labels of a near-tie
    swap at the sixth ``device_preproc`` frame), with no growth along the
    chain, so it is not loosened here;
  * served from ``aot_dir`` in a fresh process against the exporting
    process's eager rows: bit for bit;
  * ``.safetensors``: tensors equal, names and dtypes equal.
"""

import logging
import os
import pickle
import runpy
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from streamyolo_tpu.models import DFPPAFPN as JDFPPAFPN
from streamyolo_tpu.models import StreamYOLO as JStreamYOLO
from streamyolo_tpu.models import TALHead as JTALHead
from streamyolo_tpu.quant import calibrate_activations as j_calibrate
from streamyolo_tpu.quant import quantize_variables
from streamyolo_tpu.stream import MultiStreamDetector as JMultiStreamDetector
from streamyolo_tpu.stream import TPUStreamDetector
from streamyolo_torch.models import DFPPAFPN, StreamYOLO, TALHead
from streamyolo_torch.stream import CUDAStreamDetector, MultiStreamDetector
from streamyolo_torch.stream import online
from streamyolo_torch.tools import export_safetensors as t_export
from streamyolo_torch.utils.weights import (jax_variables_to_state_dict, load_state_dict_file,
                                            read_safetensors, write_safetensors)

from . import _torch_aot_child as child
from .torch_port_helpers import lift_pred_biases, load_port, torch_threads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUT = (64, 96)
KW = dict(input_size=INPUT, in_scale=0.5, conf_thre=0.01, nms_thre=0.65,
          num_classes=8, pre_nms_topk=200, use_bf16=False)
STEP_KW = dict(num_classes=8, conf_thre=0.01, nms_thre=0.65, pre_nms_topk=200,
               compute_dtype=torch.float32)


@pytest.fixture
def one_thread():
    """One intra-op thread, as the fresh processes of ``_torch_aot_child``
    run (the suite runs in several worker processes). Not for the JAX
    comparisons: their float32 bound is met at the default thread count of
    ``tests/test_torch_stream.py``, whose oneDNN sums round differently."""
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def models():
    """(JAX model, float variables, int8 variables, port float, port int8)."""
    jmodel = JStreamYOLO(backbone=JDFPPAFPN(0.33, 0.25, packed=False),
                         head=JTALHead(num_classes=8, width=0.25))
    init = jax.jit(lambda key, x: jmodel.init(key, x, mode="off_pipe"))
    variables = lift_pred_biases(jax.tree_util.tree_map(
        np.asarray, init(jax.random.PRNGKey(1), jnp.zeros((1, *INPUT, 6), jnp.float32))))
    rng = np.random.default_rng(3)
    batches = [rng.uniform(0, 255, (2, *INPUT, 6)).astype(np.float32)]
    qvars = jax.tree_util.tree_map(np.asarray, quantize_variables(
        variables, j_calibrate(jmodel, variables, batches, mode="off_pipe")))
    port = load_port(StreamYOLO(DFPPAFPN(0.33, 0.25), TALHead(num_classes=8, width=0.25)),
                     variables)
    qport = load_port(StreamYOLO(DFPPAFPN(0.33, 0.25), TALHead(num_classes=8, width=0.25)),
                      qvars)
    return jmodel, variables, qvars, port, qport


def frames_of(seed, shape, steps):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, shape, np.uint8) for _ in range(steps)]


def same_bits(a, b):
    return a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))


def assert_detections_close(got, want):
    for (bb, sc, lb, m), (bb_r, sc_r, lb_r, m_r) in zip(got, want, strict=True):
        assert m is None and m_r is None
        np.testing.assert_array_equal(lb, lb_r)
        np.testing.assert_allclose(bb, bb_r, atol=1e-3, rtol=0)
        np.testing.assert_allclose(sc, sc_r, atol=1e-5, rtol=0)


# ------------------------------------------------- the static steps


@pytest.mark.parametrize("kind", ["float", "device_preproc", "int8"])
@torch.inference_mode()
def test_static_stream_step_equals_eager_and_jax(models, kind):
    """Seven frames with ``reset()`` before the fifth: the static step's rows
    equal ``CUDAStreamDetector``'s eager rows bit for bit, and up to the
    restart parse to the JAX ``TPUStreamDetector``'s detections within the
    detector tolerance."""
    jmodel, variables, qvars, port, qport = models
    model, jvars = (qport, qvars) if kind == "int8" else (port, variables)
    device_preproc = kind == "device_preproc"
    scale = 2 if device_preproc else 1
    eager = CUDAStreamDetector(model, device_preproc=device_preproc, device="cpu", **KW)
    ref = TPUStreamDetector(jmodel, jvars, device_preproc=device_preproc, **KW)
    step = online._build_stream_step(model, device_preproc=device_preproc, **STEP_KW)
    frames = frames_of(2, (scale * INPUT[0], scale * INPUT[1], 3), 7)
    image = torch.from_numpy(frames[0])[None].clone()
    _, cur = model(torch.zeros(1, *INPUT, 3), mode="on_pipe")
    buffer = tuple(torch.empty_like(c) for c in cur)
    out = torch.empty(1, 126, 8)  # K = every anchor of 64x96
    n_kept = 0
    for i, frame in enumerate(frames):
        if i == 4:
            eager.reset()
            ref.reset()
        want = eager(frame, preprocessed=True)
        image.copy_(torch.from_numpy(frame)[None])
        step(image, buffer, i in (0, 4), out)
        assert same_bits(out[0].numpy(), eager.last_rows), i
        if i <= 4:
            assert_detections_close([online._parse(out[0].numpy(), 0.5)],
                                    [ref(frame, preprocessed=True)])
        n_kept += len(want[2])
    assert n_kept > 0
    for b, e in zip(buffer, eager._buffer):
        assert torch.equal(b, e)


@torch.inference_mode()
def test_static_multi_stream_step_equals_eager_and_jax(models):
    """N = 3, six steps, ``reset(1)`` before the fourth: the static step
    (the star step, then the static mask on every step, all False but at
    the restart) equals ``MultiStreamDetector``'s eager rows bit for bit
    (which pass no mask when no stream restarts), and up to the restart the
    JAX detector's detections within the detector tolerance."""
    jmodel, variables, _, model, _ = models
    eager = MultiStreamDetector(model, 3, device="cpu", **KW)
    ref = JMultiStreamDetector(jmodel, variables, 3, **KW)
    step = online._build_multi_stream_step(model, **STEP_KW)
    batches = frames_of(3, (3, *INPUT, 3), 6)
    images = torch.from_numpy(batches[0]).clone()
    _, cur = model(images.float(), mode="on_pipe")
    buffer = tuple(torch.empty_like(c) for c in cur)
    out = torch.empty(3, 126, 8)
    mask = torch.zeros(3, dtype=torch.bool)
    for i, batch in enumerate(batches):
        if i == 3:
            eager.reset(1)
            ref.reset(1)
        eager(batch, preprocessed=True)
        images.copy_(torch.from_numpy(batch))
        mask.copy_(torch.tensor([False, i == 3, False]))
        step(images, buffer, i == 0, mask, out)
        assert same_bits(out.numpy(), eager.last_rows), i
        if i <= 3:
            assert_detections_close([online._parse(r, 0.5) for r in out.numpy()],
                                    ref(batch, preprocessed=True))
    assert (out[..., 7] > 0.5).sum() > 0


# ------------------------------------------------- the key


def test_key_semantics(models):
    """Stable; another value of any config part, the input shape, the
    compute dtype or a parameter's shape changes it; parameter values do
    not."""
    _, _, _, port, qport = models
    dev = torch.device("cpu")
    config = dict(num_classes=8, conf_thre=0.01, nms_thre=0.65, pre_nms_topk=200,
                  compute_dtype="torch.float32", device_preproc=False)
    shape = (1, *INPUT, 3)
    key = online._stream_aot_key(port, shape, dev, **config)
    assert key == online._stream_aot_key(port, shape, dev, **config)
    changed = {"num_classes": 7, "conf_thre": 0.02, "nms_thre": 0.5, "pre_nms_topk": 100,
               "compute_dtype": "torch.bfloat16", "device_preproc": True}
    for part, value in changed.items():
        assert online._stream_aot_key(port, shape, dev, **{**config, part: value}) != key, part
    assert online._stream_aot_key(port, (1, 32, 96, 3), dev, **config) != key
    assert online._stream_aot_key(port, shape, dev, kind="multi_stream_step", **config) != key
    assert online._stream_aot_key(qport, shape, dev, **config) != key  # the int8 buffers
    other = StreamYOLO(DFPPAFPN(0.33, 0.25), TALHead(num_classes=8, width=0.25)).eval()
    assert online._stream_aot_key(other, shape, dev, **config) == key  # other values
    assert online._stream_aot_key(other.to(torch.bfloat16), shape, dev, **config) != key
    wider = StreamYOLO(DFPPAFPN(0.33, 0.375), TALHead(num_classes=8, width=0.375)).eval()
    assert online._stream_aot_key(wider, shape, dev, **config) != key


# ------------------------------------------------- serving from aot_dir


def test_miss_warns_and_serves_eagerly(models, tmp_path, caplog, one_thread):
    _, _, _, port, _ = models
    online.export_stream_executables(port, str(tmp_path), device="cpu",
                                     **{k: v for k, v in KW.items() if k != "in_scale"})
    frames = frames_of(4, (*INPUT, 3), 3)
    with caplog.at_level(logging.WARNING, logger="streamyolo_torch"):
        det = CUDAStreamDetector(port, aot_dir=str(tmp_path), device="cpu",
                                 **{**KW, "conf_thre": 0.02})
    assert not det.aot_loaded and det.graphs is None
    assert any("no captured-graph manifests" in r.message for r in caplog.records)
    eager = CUDAStreamDetector(port, device="cpu", **{**KW, "conf_thre": 0.02})
    for frame in frames:
        det(frame, preprocessed=True)
        eager(frame, preprocessed=True)
        assert same_bits(det.last_rows, eager.last_rows)


def test_probe_that_differs_leaves_eager(models, tmp_path, caplog, monkeypatch, one_thread):
    """A captured step (the step over static tensors) whose rows differ from
    the eager step's is logged with its cause and not served."""
    _, _, _, port, _ = models
    kw = {k: v for k, v in KW.items() if k != "in_scale"}
    online.export_stream_executables(port, str(tmp_path), device="cpu", **kw)
    build = online._build_stream_step

    def off_by_one(model, **step_kw):
        step = build(model, **step_kw)

        def wrong(image, buffer, star, out=None):
            rows, buffer = step(image, buffer, star, out)
            if out is not None:
                out.add_(1)
            return rows, buffer

        return wrong

    monkeypatch.setattr(online, "_build_stream_step", off_by_one)
    with caplog.at_level(logging.WARNING, logger="streamyolo_torch"):
        det = CUDAStreamDetector(port, aot_dir=str(tmp_path), device="cpu", **KW)
    assert not det.aot_loaded and det.graphs is None
    assert any("differ from the eager steps in rows of probe step 0" in r.message
               for r in caplog.records)
    with pytest.raises(RuntimeError, match="differ from the eager steps"):
        online.export_stream_executables(port, str(tmp_path), device="cpu", **kw)


@pytest.mark.parametrize("n_streams", [None, 3])
def test_failed_capture_leaves_eager_and_reset(models, tmp_path, caplog, monkeypatch,
                                               n_streams, one_thread):
    """A capture that raises (after the probe's eager steps have set the
    carry) is logged and not served, and leaves the detector reset: its
    first frames equal a fresh eager detector's bit for bit, the first one
    a star step."""
    _, _, _, port, _ = models
    kw = {k: v for k, v in KW.items() if k != "in_scale"}
    if n_streams is None:
        online.export_stream_executables(port, str(tmp_path), device="cpu", **kw)
        make = lambda **extra: CUDAStreamDetector(port, device="cpu", **KW, **extra)
        frames = frames_of(7, (*INPUT, 3), 3)
    else:
        online.export_multi_stream_executables(port, str(tmp_path), n_streams=n_streams,
                                               device="cpu", **kw)
        make = lambda **extra: MultiStreamDetector(port, n_streams, device="cpu", **KW, **extra)
        frames = frames_of(7, (n_streams, *INPUT, 3), 3)

    def refused(*args, **kwargs):
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(online, "GraphSteps", refused)
    with caplog.at_level(logging.WARNING, logger="streamyolo_torch"):
        det = make(aot_dir=str(tmp_path))
    assert not det.aot_loaded and det.graphs is None
    assert any("failed to capture or probe (RuntimeError: operation not permitted"
               in r.message for r in caplog.records)
    assert det._buffer is None
    eager = make()
    for frame in frames:
        det(frame, preprocessed=True)
        eager(frame, preprocessed=True)
        assert same_bits(det.last_rows, eager.last_rows)


def test_export_and_serve_in_fresh_processes(models, tmp_path, one_thread):
    """One process exports (the single-stream host path and N = 3) and
    records its eager rows, another serves from the directory: the served
    rows equal the exporting process's bit for bit; so do the rows served
    in this process from the same directory."""
    _, _, _, port, _ = models
    frames = frames_of(5, (*INPUT, 3), 7)
    multi_frames = frames_of(6, (child.MULTI_N, *INPUT, 3), 6)
    torch.save({"state_dict": port.state_dict(), "kw": KW, "device": "cpu",
                "dtype": torch.float32, "device_preproc": False, "frames": frames,
                "multi_frames": multi_frames}, tmp_path / "setup.pt")
    child.run("export", tmp_path)
    assert len([p for p in os.listdir(tmp_path) if p.endswith(".json")]) == 4
    child.run("serve", tmp_path)
    want, got = np.load(tmp_path / "want.npz"), np.load(tmp_path / "got.npz")
    assert (want["rows"][..., 7] > 0.5).sum() > 0
    for name in ("rows", "mrows"):
        assert same_bits(got[name], want[name]), name

    single = CUDAStreamDetector(port, aot_dir=str(tmp_path), device="cpu", **KW)
    multi = MultiStreamDetector(port, child.MULTI_N, aot_dir=str(tmp_path), device="cpu", **KW)
    assert single.aot_loaded and multi.aot_loaded
    rows, mrows = child.run_chains(single, multi, frames, multi_frames)
    assert same_bits(rows, want["rows"]) and same_bits(mrows, want["mrows"])
    # the probe replayed each graph once (multi: the steady one twice)
    assert single.graphs.replays == [3, 6] and multi.graphs.replays == [2, 7]
    single.warmup(2)  # reset after: the next frame is a star again
    assert single._buffer is None


# ------------------------------------------------- .safetensors


def test_jax_safetensors_load_without_the_package(models, tmp_path, monkeypatch):
    """The JAX ``save_safetensors`` file loads through the port's reader,
    with the ``safetensors`` package unimportable, into the converted state
    dict, tensor for tensor."""
    from streamyolo_tpu.utils.checkpoint import save_safetensors as j_save

    _, variables, _, _, _ = models
    path = str(tmp_path / "j.safetensors")
    j_save(variables, path, torch_layout=True)
    for name in [n for n in sys.modules if n.split(".")[0] == "safetensors"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "safetensors", None)
    got = load_state_dict_file(path)
    want = jax_variables_to_state_dict(variables)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    assert sys.modules["safetensors"] is None


@pytest.mark.parametrize("names,quantized", [("torch", False), ("flax", False),
                                             ("flax", True)])
def test_export_safetensors_matches_jax_tool(models, tmp_path, names, quantized):
    """The port's tool on a ``.pth`` of the converted weights writes what the
    JAX tool writes from the JAX checkpoint, tensor for tensor (names,
    dtypes, shapes, values; ``format`` metadata), in both name modes; the
    int8 model in flax names too (the JAX tool's torch names do not carry
    the ``quant`` collection). One divergence, kept: the JAX tool writes a
    per-tensor ``act_scale`` (a scalar) as shape [1] (``np.ascontiguousarray``
    makes every 0-d leaf 1-d); the port writes it as the scalar it is."""
    _, variables, qvars, _, _ = models
    jvars = qvars if quantized else variables
    ckpt = tmp_path / "j.pkl"
    with open(ckpt, "wb") as f:
        pickle.dump({"model": jvars}, f)
    pth = tmp_path / "p.pth"
    torch.save({"model": jax_variables_to_state_dict(jvars)}, pth)
    flag = f"--{names}-names"
    saved = sys.argv
    sys.argv = ["export_safetensors.py", "-c", str(ckpt), "-o", str(tmp_path / "j.safetensors"),
                flag]
    try:
        runpy.run_path(os.path.join(REPO, "tools", "export_safetensors.py"), run_name="__main__")
    finally:
        sys.argv = saved
    n = t_export.main(["-c", str(pth), "-o", str(tmp_path / "p.safetensors"), flag])
    want, want_meta = read_safetensors(str(tmp_path / "j.safetensors"))
    got, got_meta = read_safetensors(str(tmp_path / "p.safetensors"))
    assert n == len(got) and sorted(got) == sorted(want)
    for k, v in want.items():
        if k.endswith("/act_scale") and got[k].ndim == 0:
            assert v.shape == (1,)
            v = v.reshape(())
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    assert got_meta["format"] == want_meta["format"] == ("pt" if names == "torch" else "flax")
    if quantized:
        assert any(k.startswith("quant/") for k in got)


def test_safetensors_package_reads_the_port_files(models, tmp_path):
    st = pytest.importorskip("safetensors.torch")
    _, _, _, _, qport = models
    sd = {k: v for k, v in qport.state_dict().items()}
    sd["flag"], sd["half"] = torch.tensor([True, False]), torch.ones(3, dtype=torch.bfloat16)
    path = str(tmp_path / "p.safetensors")
    assert write_safetensors(path, sd, {"format": "pt"}) == len(sd)
    got = st.load_file(path)
    for k, v in sd.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    mine, _ = read_safetensors(path)
    assert all(torch.equal(mine[k], v) for k, v in sd.items())


def test_malformed_safetensors_raise(tmp_path):
    path = tmp_path / "bad.safetensors"
    write_safetensors(str(path), {"a": torch.arange(4, dtype=torch.int32)})
    blob = path.read_bytes()
    path.write_bytes(blob[:-1])  # the data ends early
    with pytest.raises(ValueError, match="offsets"):
        read_safetensors(str(path))
    path.write_bytes(blob + b"x")  # bytes after the last tensor
    with pytest.raises(ValueError, match="after the last tensor"):
        read_safetensors(str(path))
    path.write_bytes((10 ** 9).to_bytes(8, "little") + blob[8:])
    with pytest.raises(ValueError, match="exceeds the file"):
        read_safetensors(str(path))
    path.write_bytes(blob.replace(b'"I32"', b'"U16"'))
    with pytest.raises(ValueError, match="dtype"):
        read_safetensors(str(path))
