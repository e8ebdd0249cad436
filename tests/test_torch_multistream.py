"""The N-camera batched path of the PyTorch port against the JAX package, on
the CPU: the model's per-row ``star_mask`` and ``MultiStreamDetector``.

Depth 0.33, width 0.25 at 64x96, fp32, JAX-initialised weights converted
into the port with the obj/cls prediction biases lifted to 0 (so NMS has
candidates). Tolerances:

  * ``star_mask`` inside the port: bit for bit against the port's unmasked
    buffer and star runs, row by row (the same programs on the same batch);
  * port against JAX: the model tolerance of ``test_torch_model.py`` (atol
    2e-3, rtol 1e-4) on the decoded outputs, and the detector tolerance of
    ``test_torch_stream.py`` (boxes atol 1e-3 in pixels / in_scale, scores
    atol 1e-5, labels equal) on the parsed detections.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from streamyolo_tpu.models import DFPPAFPN as JDFPPAFPN
from streamyolo_tpu.models import StreamYOLO as JStreamYOLO
from streamyolo_tpu.models import TALHead as JTALHead
from streamyolo_tpu.stream import MultiStreamDetector as JMultiStreamDetector
from streamyolo_torch.models import DFPPAFPN, StreamYOLO, TALHead
from streamyolo_torch.ops.nms_cuda import nms_keep
from streamyolo_torch.stream import CUDAStreamDetector, MultiStreamDetector

from .torch_port_helpers import lift_pred_biases, load_port, pin_threads

INPUT = (64, 96)
KW = dict(input_size=INPUT, in_scale=0.5, conf_thre=0.01, nms_thre=0.65,
          num_classes=8, pre_nms_topk=200, use_bf16=False)
MODEL_TOL = dict(atol=2e-3, rtol=1e-4)


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


def frames_of(seed, n, steps):
    """``steps`` batches of ``n`` distinct uint8 frames at the input size."""
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (n, *INPUT, 3), np.uint8) for _ in range(steps)]


def test_star_mask_row_semantics(models):
    """A True row fuses with its own current features, a False row with the
    buffer: bit for bit against the port's unmasked runs, and within the
    model tolerance of the JAX ``star_mask`` program."""
    jmodel, variables, port = models
    x0, x1 = (f.astype(np.float32) for f in frames_of(0, 2, 2))
    mask = np.array([False, True])
    with torch.no_grad():
        _, buf = port(torch.from_numpy(x0), mode="on_pipe")
        masked, _ = port(torch.from_numpy(x1), buffer=buf, mode="on_pipe",
                         star_mask=torch.from_numpy(mask))
        buffered, _ = port(torch.from_numpy(x1), buffer=buf, mode="on_pipe")
        starred, _ = port(torch.from_numpy(x1), mode="on_pipe")
        # without a buffer the mask changes nothing (every row is a star)
        star_masked, _ = port(torch.from_numpy(x1), mode="on_pipe",
                              star_mask=torch.from_numpy(mask))
    assert torch.equal(masked[0], buffered[0])
    assert torch.equal(masked[1], starred[1])
    assert not torch.equal(buffered[1], starred[1])
    assert torch.equal(star_masked, starred)

    _, jbuf = jmodel.apply(variables, jnp.asarray(x0), mode="on_pipe")
    jmasked, _ = jmodel.apply(variables, jnp.asarray(x1), buffer=jbuf, mode="on_pipe",
                              star_mask=jnp.asarray(mask))
    np.testing.assert_allclose(masked.numpy(), np.asarray(jmasked), **MODEL_TOL)


def test_star_mask_casts_buffer_to_current_dtype(models):
    """The buffer is cast to the current features' dtype before the select:
    a bf16 buffer fed to an fp32 model selects fp32 values."""
    _, _, port = models
    x0, x1 = (torch.from_numpy(f.astype(np.float32)) for f in frames_of(1, 2, 2))
    with torch.no_grad():
        _, buf = port(x0, mode="on_pipe")
        half = tuple(b.to(torch.bfloat16) for b in buf)
        got, _ = port(x1, buffer=half, mode="on_pipe", star_mask=torch.tensor([False, False]))
        want, _ = port(x1, buffer=tuple(b.float() for b in half), mode="on_pipe")
    assert got.dtype == torch.float32
    assert torch.equal(got, want)


def assert_detections_close(got, want):
    for (bb, sc, lb, m), (bb_r, sc_r, lb_r, m_r) in zip(got, want, strict=True):
        assert m is None and m_r is None
        np.testing.assert_array_equal(lb, lb_r)
        np.testing.assert_allclose(bb, bb_r, atol=1e-3, rtol=0)
        np.testing.assert_allclose(sc, sc_r, atol=1e-5, rtol=0)


def test_multi_stream_matches_jax(models):
    """N = 2, four steps, ``reset(1)`` before step 3 (index 2): the port's
    detections equal the JAX detector's within the detector tolerance, and
    no kernel launches for CPU tensors."""
    jmodel, variables, port = models
    ref = JMultiStreamDetector(jmodel, variables, 2, **KW)
    det = MultiStreamDetector(port, 2, device="cpu", **KW)
    launches = nms_keep.launches
    n_kept = 0
    for t, frames in enumerate(frames_of(2, 2, 4)):
        if t == 2:
            ref.reset(1)
            det.reset(1)
        want = ref(frames, preprocessed=True)
        got = det(frames, preprocessed=True)
        assert_detections_close(got, want)
        n_kept += sum(len(g[2]) for g in got)
        assert not det._pending_star.any()
    assert n_kept > 0
    assert det.n_saturated == ref.n_saturated
    assert det.last_rows.shape == (2, 8 * 12 + 4 * 6 + 2 * 3, 8)  # K = every anchor
    assert nms_keep.launches == launches


def test_single_stream_matches_cuda_stream_detector(models):
    """N = 1 reproduces ``CUDAStreamDetector`` on the same frames."""
    _, _, port = models
    single = CUDAStreamDetector(port, device="cpu", **KW)
    multi = MultiStreamDetector(port, 1, device="cpu", **KW)
    for frames in frames_of(3, 1, 3):
        want = single(frames[0], preprocessed=True)
        (got,) = multi(frames, preprocessed=True)
        assert len(want[2])
        assert_detections_close([got], [want])
        np.testing.assert_array_equal(multi.last_rows[0], single.last_rows)


def test_rows_fed_the_same_frames_are_identical(models):
    """The batched step is row-wise independent; a per-stream reset makes
    only the marked row diverge, and ``reset()`` drops the buffer."""
    _, _, port = models
    multi = MultiStreamDetector(port, 2, device="cpu", **KW)
    frames = [np.repeat(f, 2, axis=0) for f in frames_of(4, 1, 3)]
    for f in frames[:2]:
        multi(f, preprocessed=True)
        np.testing.assert_array_equal(multi.last_rows[0], multi.last_rows[1])
    multi.reset(1)
    multi(frames[2], preprocessed=True)
    assert not np.array_equal(multi.last_rows[0], multi.last_rows[1])
    assert multi._buffer is not None and not multi._pending_star.any()
    multi.reset()
    assert multi._buffer is None


def test_reset_before_first_call_is_absorbed(models):
    """A ``reset(i)`` before the first step is absorbed by the all-star first
    step: the output equals a detector that was never reset."""
    _, _, port = models
    a = MultiStreamDetector(port, 2, device="cpu", **KW)
    b = MultiStreamDetector(port, 2, device="cpu", **KW)
    a.reset(0)
    for frames in frames_of(5, 2, 2):
        a(frames, preprocessed=True)
        b(frames, preprocessed=True)
        np.testing.assert_array_equal(a.last_rows, b.last_rows)


def test_reset_bounds_and_frame_promotion(models):
    """``reset(i)`` rejects indices outside [0, N), negative ones included;
    a single HWC frame is promoted to a batch only when N == 1."""
    _, _, port = models
    multi = MultiStreamDetector(port, 2, device="cpu", **KW)
    for bad in (-1, 2, 7):
        with pytest.raises(IndexError):
            multi.reset(bad)
    multi.reset(1)
    frame = np.zeros((*INPUT, 3), np.uint8)
    with pytest.raises(AssertionError, match="expected 2 frames"):
        multi(frame, preprocessed=True)
    ((b, s, lb, m),) = MultiStreamDetector(port, 1, device="cpu", **KW)(frame, preprocessed=True)
    assert m is None and len(b) == len(s) == len(lb)
    with pytest.raises(ValueError, match="n_streams"):
        MultiStreamDetector(port, 0, device="cpu", **KW)


def test_buffer_is_updated_in_place(models):
    """Steady steps, a per-stream reset included, write the carried buffer
    in place: the same tensors, the same layout."""
    _, _, port = models
    multi = MultiStreamDetector(port, 2, device="cpu", **KW)
    batches = frames_of(6, 2, 4)
    multi(batches[0], preprocessed=True)
    ptrs = [b.data_ptr() for b in multi._buffer]
    strides = [b.stride() for b in multi._buffer]
    for t, frames in enumerate(batches[1:]):
        if t == 1:
            multi.reset(0)
        multi(frames, preprocessed=True)
        assert [b.data_ptr() for b in multi._buffer] == ptrs
        assert [b.stride() for b in multi._buffer] == strides
    multi.warmup(2)
    assert multi._buffer is None


def test_default_device_raises_without_gpu(models):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiStreamDetector(models[2], 2, **KW)
