"""The whole single-stream step of the PyTorch port (``CUDAStreamDetector``
on the CPU) against ``TPUStreamDetector``: same converted weights with the
obj/cls prediction biases lifted to 0 (so NMS has candidates), fp32, star
then steady frames. Boxes atol 1e-3 (pixels / in_scale), scores atol 1e-5;
labels and the kept sets must be equal.

The float64 anchor (ROADMAP C.5): that bound sits at float32's own noise
on this random model, so each package's float32 decoded candidates are also
held to the port's float64 over every anchor it scores above conf: boxes
within 2.5e-3 raw px, scores within 2.5e-6, about twice the largest gap of
either package at either thread count (1.03-1.33e-3 px, 0.67-1.14e-6:
``python -m tests.torch_detector_noise``).

Also: the default device raises without a GPU, and no file of the port (nor
``chip_smoke.py``) imports jax, flax or the JAX package."""

import ast
import copy
import logging
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from streamyolo_tpu.models import DFPPAFPN as JDFPPAFPN
from streamyolo_tpu.models import StreamYOLO as JStreamYOLO
from streamyolo_tpu.models import TALHead as JTALHead
from streamyolo_tpu.stream import TPUStreamDetector
from streamyolo_torch.models import DFPPAFPN, StreamYOLO, TALHead
from streamyolo_torch.ops.nms_cuda import nms_keep
from streamyolo_torch.ops.preproc import downsample2x
from streamyolo_torch.stream import CUDAStreamDetector

from .torch_port_helpers import lift_pred_biases, load_port, pin_threads

pytest.importorskip("cv2")

REPO = Path(__file__).resolve().parents[1]
INPUT = (64, 96)
KW = dict(input_size=INPUT, in_scale=0.5, conf_thre=0.01, nms_thre=0.65,
          num_classes=8, pre_nms_topk=200, use_bf16=False)


one_thread = pin_threads(1)


@pytest.fixture(scope="module")
def models():
    jmodel = JStreamYOLO(backbone=JDFPPAFPN(0.33, 0.25), head=JTALHead(num_classes=8, width=0.25))
    init = jax.jit(lambda key, x: jmodel.init(key, x, mode="off_pipe"))
    variables = lift_pred_biases(jax.tree_util.tree_map(
        np.asarray, init(jax.random.PRNGKey(1), jnp.zeros((1, 64, 96, 6), jnp.float32))))
    port = load_port(StreamYOLO(DFPPAFPN(0.33, 0.25), TALHead(num_classes=8, width=0.25)),
                     variables)
    return jmodel, variables, port


@pytest.mark.parametrize("device_preproc", [False, True])
def test_stream_detector_matches_tpu_detector(models, device_preproc):
    jmodel, variables, port = models
    ref = TPUStreamDetector(jmodel, variables, device_preproc=device_preproc, **KW)
    det = CUDAStreamDetector(port, device_preproc=device_preproc, device="cpu", **KW)
    rng = np.random.RandomState(2)
    launches = (nms_keep.launches, downsample2x.launches)
    n_kept = 0
    for _ in range(4):  # star, then three steady steps carrying the buffer
        raw = rng.randint(0, 256, (2 * INPUT[0], 2 * INPUT[1], 3), np.uint8)
        bb_r, sc_r, lb_r, m_r = ref(raw)
        bb, sc, lb, m = det(raw)
        assert m is None and m_r is None
        np.testing.assert_array_equal(lb, lb_r)
        np.testing.assert_allclose(bb, bb_r, atol=1e-3, rtol=0)
        np.testing.assert_allclose(sc, sc_r, atol=1e-5, rtol=0)
        n_kept += len(lb)
        assert det._buffer is not None
    assert n_kept > 0
    assert det.n_saturated == ref.n_saturated
    # CPU tensors take the plain versions: no kernel launch
    assert (nms_keep.launches, downsample2x.launches) == launches


def test_fp32_within_float64_anchor(models):
    jmodel, variables, port = models
    frames = [np.random.RandomState(2).randint(0, 256, (1, *INPUT, 3), np.uint8)
              for _ in range(4)]
    # one program for every frame: the star frame fuses with itself through
    # star_mask, as a buffer of None makes it
    apply = jax.jit(lambda v, x, b, star: jmodel.apply(
        v, x.astype(jnp.float32), buffer=b, mode="on_pipe", star_mask=star))
    buf = jax.tree_util.tree_map(lambda a: jnp.zeros(a.shape, a.dtype), jax.eval_shape(
        lambda v, x: jmodel.apply(v, x.astype(jnp.float32), mode="on_pipe")[1],
        variables, frames[0]))
    preds = {"jax": [], "port": [], "port64": []}
    for i, x in enumerate(frames):
        y, buf = apply(variables, x, buf, jnp.array([i == 0]))
        preds["jax"].append(np.asarray(y[0], np.float64))
    for name, dtype in (("port", torch.float32), ("port64", torch.float64)):
        model, buf = copy.deepcopy(port).to(dtype), None
        with torch.inference_mode():
            for x in frames:
                y, buf = model(torch.from_numpy(x).to(dtype), buffer=buf, mode="on_pipe")
                preds[name].append(y[0].double().numpy())
    preds = {k: np.stack(v) for k, v in preds.items()}
    ref = preds["port64"]
    keep = ref[..., 4] * ref[..., 5:].max(-1) > KW["conf_thre"]
    assert keep.sum() > 100
    for name in ("jax", "port"):
        box = np.abs(preds[name][keep][:, :4] - ref[keep][:, :4]).max() / KW["in_scale"]
        score = np.abs(preds[name][keep][:, 4] * preds[name][keep][:, 5:].max(-1)
                       - ref[keep][:, 4] * ref[keep][:, 5:].max(-1)).max()
        assert box <= 2.5e-3 and score <= 2.5e-6, (name, box, score)


def test_buffer_is_reused_in_place(models):
    _, _, port = models
    det = CUDAStreamDetector(port, device="cpu", **KW)
    frame = np.zeros((*INPUT, 3), np.uint8)
    det(frame, preprocessed=True)
    ptrs = [b.data_ptr() for b in det._buffer]
    det(frame + 7, preprocessed=True)
    assert [b.data_ptr() for b in det._buffer] == ptrs
    det.warmup(2)
    assert det._buffer is None


def test_device_preproc_rejects_other_shapes(models):
    det = CUDAStreamDetector(models[2], device_preproc=True, device="cpu", **KW)
    with pytest.raises(ValueError, match="device_preproc"):
        det(np.zeros((*INPUT, 3), np.uint8))


def test_use_bf16_with_fp32_model_warns(models, caplog):
    with caplog.at_level(logging.WARNING, logger="streamyolo_torch"):
        CUDAStreamDetector(models[2], device="cpu", **{**KW, "use_bf16": True})
    assert any("built fp32" in r.message for r in caplog.records)


def test_default_device_raises_without_gpu(models):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CUDAStreamDetector(models[2], **KW)


FORBIDDEN = ("jax", "flax", "streamyolo_tpu")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((REPO / "streamyolo_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, f"{os.path.relpath(path, REPO)}: {name}"
