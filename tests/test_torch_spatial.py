"""The row-sharded latency mode of the port (``parallel/spatial.py``,
``CUDAStreamDetector(mesh=...)``) on meshes of CPU devices (a device may
repeat: ``["cpu"] * n`` is the counterpart of the JAX tests' virtual CPU
mesh).

  * Partition and halo units: ``row_ranges``; the stride-2 conv on an odd
    height with empty shards, the SPP 13-pool whose halo reaches three
    shards away, ``Focus`` on an odd shard height, and the 5 -> 9 nearest
    resize, each sharded and gathered against the unsharded module bit for
    bit. The modules hold integer weights and exact BatchNorm (eps 0,
    identity statistics) with ReLU, so every value is an integer and any
    order of the float32 sums gives the same bits.
  * The sharded detector against the unsharded one, star and two steady
    frames, the JAX package's own bound for its mode (boxes atol 1e-4,
    scores 1e-5, labels and kept sets equal; ``tests/test_stream_detector.py
    ::test_spatial_mesh_matches_single_device``) at n = 2 on 72x96 (levels
    9 / 5 / 3: uneven, a non-integer upsample), n = 4 on 40x64 (empty
    shards at /32) and n = 8 on 120x64 (15 input rows a shard: ``Focus``
    straddles shards). The float model runs in float64: in float32 the CPU's
    convolutions sum in an order that depends on the slab's shape, which
    moves the random model's boxes (up to ~270 px) by up to 4e-4 px, 13
    float32 ulps, while the halo logic this test holds is the same code in
    either dtype. The int8 model (the int8 conv takes float32 or bf16 only)
    runs in float32: its convolutions are exact integer sums.
  * The sharded port against ``TPUStreamDetector(mesh=...)`` on the JAX
    virtual CPU mesh at n = 2 and n = 8 (see that test's docstring).
  * The rejections of the JAX detector, the sharded DFP buffer, the
    one-device mesh, ``aot_dir`` left unread, and the model copies that
    follow ``load_state_dict``.
"""

import copy
import logging

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from streamyolo_tpu.models import DFPPAFPN as JDFPPAFPN
from streamyolo_tpu.models import StreamYOLO as JStreamYOLO
from streamyolo_tpu.models import TALHead as JTALHead
from streamyolo_tpu.parallel.spatial import make_spatial_mesh as j_make_spatial_mesh
from streamyolo_tpu.stream import TPUStreamDetector
from streamyolo_torch.models import DFPPAFPN, StreamYOLO, TALHead
from streamyolo_torch.nn.blocks import BaseConv, Focus, SPPBottleneck
from streamyolo_torch.ops.nms_cuda import nms_keep
from streamyolo_torch.ops.resize import resize_nearest
from streamyolo_torch.parallel import make_spatial_mesh, row_sharding
from streamyolo_torch.parallel.spatial import Rows, replicated, resize_rows, row_ranges, run
from streamyolo_torch.quant import calibrate_activations, quantize_state_dict
from streamyolo_torch.stream import CUDAStreamDetector

from .torch_port_helpers import lift_pred_biases, load_port, pin_threads

KW = dict(in_scale=0.5, conf_thre=0.01, nms_thre=0.65, num_classes=8, pre_nms_topk=200,
          use_bf16=False)
SIZES = {2: (72, 96), 4: (40, 64), 8: (120, 64)}
FRAMES = 3  # the star frame, then two steady frames carrying the buffer
BOX_ATOL, SCORE_ATOL = 1e-4, 1e-5  # the JAX package's sharded-vs-unsharded bound


# One intra-op thread: the sharded steps run many small ops, and when
# the test workers share the cores each op's thread-pool hand-off costs
# more than the op (the file ran ~5x slower beside busy cores).
one_thread = pin_threads(1)


def cpu_mesh(n: int):
    return make_spatial_mesh(["cpu"] * n)


@pytest.fixture(scope="module")
def models():
    """(JAX model, its variables, the port in float32) with the same
    weights: the model of ``tests/test_torch_stream.py`` (JAX init from key
    1, the obj/cls prediction biases lifted to 0), for which the port-vs-JAX
    bound below was set."""
    jmodel = JStreamYOLO(backbone=JDFPPAFPN(0.33, 0.25), head=JTALHead(num_classes=8, width=0.25))
    init = jax.jit(lambda key, x: jmodel.init(key, x, mode="off_pipe"))
    variables = lift_pred_biases(jax.tree_util.tree_map(
        np.asarray, init(jax.random.PRNGKey(1), jnp.zeros((1, 64, 96, 6), jnp.float32))))
    port = load_port(StreamYOLO(DFPPAFPN(0.33, 0.25), TALHead(num_classes=8, width=0.25)),
                     variables)
    return jmodel, variables, port


@pytest.fixture(scope="module")
def port64(models):
    return copy.deepcopy(models[2]).double()


def frames(size, seed: int = 2):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (*size, 3), np.uint8) for _ in range(FRAMES)]


def assert_same_detections(got, want, box_atol: float, score_atol: float) -> int:
    """Labels and kept sets equal, boxes and scores within the bounds;
    returns the kept rows."""
    bb, sc, lb, m = got
    bb_r, sc_r, lb_r, m_r = want
    assert m is None and m_r is None
    np.testing.assert_array_equal(lb, lb_r)
    np.testing.assert_allclose(bb, bb_r, atol=box_atol, rtol=0)
    np.testing.assert_allclose(sc, sc_r, atol=score_atol, rtol=0)
    return len(lb)


# ------------------------------------------------ partition and halo units


def test_row_ranges_padded_split():
    sizes = [r1 - r0 for r0, r1 in row_ranges(19, 8)]
    assert sizes == [3] * 6 + [1, 0]
    assert [r1 - r0 for r0, r1 in row_ranges(600, 8)] == [75] * 8
    assert [r1 - r0 for r0, r1 in row_ranges(300, 8)] == [38] * 7 + [34]
    for h, n in ((19, 8), (5, 8), (38, 4), (9, 2)):
        ranges = row_ranges(h, n)
        assert ranges[0][0] == 0 and ranges[-1][1] == h
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


def integer_module(module: nn.Module, seed: int) -> nn.Module:
    """Integer conv weights in [-2, 2], BatchNorm with eps 0 on identity
    statistics (an exact identity), eval mode."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                m.weight.copy_(torch.randint(-2, 3, m.weight.shape, generator=gen))
            if isinstance(m, nn.BatchNorm2d):
                m.eps = 0.0
    return module.eval()


def sharded_against_plain(module, x: torch.Tensor, n: int):
    """(gathered sharded output, unsharded output) of ``module`` on ``x``."""
    sh = row_sharding(cpu_mesh(n))
    with torch.inference_mode():
        got = run(sh, [module] * n, Rows(sh.shard(x), x.shape[2]))
        return sh.gather(got.parts), module(x)


WINDOWED = {
    # 19 rows over 8 shards (3 x 6, 1, 0) -> 10 rows (2 x 5, then empty shards);
    # shard 1's output row 2 reads rows 3, 4, 5 (its slab starts on row 2)
    "conv_3x3_stride2_odd_height": (lambda: BaseConv(8, 16, 3, 2, act="relu"), (1, 8, 19, 6), 8),
    "conv_3x3_stride1_empty_shards": (lambda: BaseConv(8, 8, 3, 1, act="relu"),
                                      (1, 8, 5, 6), 4),
    # the 13-pool's 6-row halo over shards of 3 rows reaches three shards away
    "spp_13_pool": (lambda: SPPBottleneck(16, 16, activation="relu"), (1, 16, 19, 5), 8),
    # 30 rows over 2 shards of 15 (odd): space-to-depth output rows 0-7 and
    # 8-14, so shard 0 reads input row 15 of shard 1
    "focus_odd_shard_height": (lambda: Focus(3, 8, ksize=3, act="relu"), (1, 3, 30, 8), 2),
    # 120 rows over 8 shards of 15: every space-to-depth chunk straddles two
    "focus_straddles_8": (lambda: Focus(3, 8, ksize=3, act="relu"), (1, 3, 120, 8), 8),
}


@pytest.mark.parametrize("case", sorted(WINDOWED))
def test_windowed_op_bit_for_bit(case):
    make, shape, n = WINDOWED[case]
    module = integer_module(make(), seed=len(case))
    x = torch.randint(-3, 4, shape, generator=torch.Generator().manual_seed(1)).float()
    got, want = sharded_against_plain(module, x, n)
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_nearest_resize_uses_global_rows(n):
    """5 -> 9 rows (and 6 -> 11 columns): output row o reads input row
    floor(o * 5 / 9) of the global map, fetched from the shard that holds it
    (a slab resize would map rows by the slab's own sizes)."""
    x = torch.randn(1, 4, 5, 6, generator=torch.Generator().manual_seed(n))
    sh = row_sharding(cpu_mesh(n))
    got = resize_rows(sh, Rows(sh.shard(x), 5), (9, 11))
    assert [p.shape[2] for p in got.parts] == [r1 - r0 for r0, r1 in row_ranges(9, n)]
    assert torch.equal(sh.gather(got.parts), resize_nearest(x, (9, 11)))


# -------------------------------------------------- detector against detector


@pytest.mark.parametrize("n", sorted(SIZES))
def test_sharded_matches_unsharded(port64, n):
    size = SIZES[n]
    ref = CUDAStreamDetector(port64, input_size=size, device="cpu", **KW)
    det = CUDAStreamDetector(port64, input_size=size, mesh=cpu_mesh(n), **KW)
    launches = nms_keep.launches
    kept = 0
    for frame in frames(size):
        kept += assert_same_detections(det(frame, preprocessed=True),
                                       ref(frame, preprocessed=True), BOX_ATOL, SCORE_ATOL)
        np.testing.assert_array_equal(det.last_rows[:, 7], ref.last_rows[:, 7])
    assert kept > 0
    assert det.n_saturated == ref.n_saturated
    assert nms_keep.launches == launches  # CPU tensors take the plain versions


def test_sharded_buffer_layout(port64):
    """Each level of the carried buffer is one slab per mesh device, on it,
    in the canonical partition of the level's height, written in place."""
    n, size = 4, SIZES[4]
    mesh = cpu_mesh(n)
    det = CUDAStreamDetector(port64, input_size=size, mesh=mesh, **KW)
    fr = frames(size)
    det(fr[0], preprocessed=True)
    heights = [size[0] // 8]  # 5, then the stride-2 convs' 3 and 2
    heights += [(heights[0] + 1) // 2, (heights[0] + 3) // 4]
    assert len(det._buffer) == 3
    for level, h in zip(det._buffer, heights):
        assert len(level) == n
        assert [p.device for p in level] == list(mesh.devices)
        assert [p.shape[2] for p in level] == [r1 - r0 for r0, r1 in row_ranges(h, n)]
    assert [p.shape[2] for p in det._buffer[2]] == [1, 1, 0, 0]  # empty shards
    ptrs = [[p.data_ptr() for p in level] for level in det._buffer]
    det(fr[1], preprocessed=True)
    assert [[p.data_ptr() for p in level] for level in det._buffer] == ptrs
    det.reset()
    assert det._buffer is None


def test_int8_sharded_matches_unsharded(models):
    """An int8-quantized model (every CBS conv through ``ops/int8_conv.py``,
    here its plain version), n = 8 on 120x64, float32."""
    port = models[2]
    x6 = np.random.RandomState(0).randint(0, 256, (2, 64, 96, 6), np.uint8)
    q = quantize_state_dict(port.state_dict(), calibrate_activations(port, [x6]))
    qmodel = StreamYOLO(DFPPAFPN(0.33, 0.25), TALHead(num_classes=8, width=0.25))
    qmodel.load_state_dict(q, strict=True)
    assert sum(m.kernel_q is not None for m in qmodel.modules() if isinstance(m, BaseConv)) > 70
    size = SIZES[8]
    ref = CUDAStreamDetector(qmodel, input_size=size, device="cpu", **KW)
    det = CUDAStreamDetector(qmodel, input_size=size, mesh=cpu_mesh(8), **KW)
    kept = sum(assert_same_detections(det(f, preprocessed=True), ref(f, preprocessed=True),
                                      BOX_ATOL, SCORE_ATOL) for f in frames(size, seed=5))
    assert kept > 0


@pytest.mark.parametrize("n", [2, 8])
def test_sharded_matches_jax_mesh(models, port64, n):
    """The sharded port against ``TPUStreamDetector(mesh=...)`` on the
    first n of conftest's 8 virtual CPU devices (float32).

    Bound: boxes 1e-3 + 2 * 1e-4, scores 1e-5 + 2 * 1e-5. That is the
    port-vs-JAX bound of the unsharded detectors (``tests/test_torch_stream.
    py``: 1e-3, 1e-5) plus the bound each package allows its own sharded
    step against its unsharded one (``tests/test_stream_detector.py``:
    1e-4 on boxes, 1e-5 on scores), once for each side. Labels and kept
    sets must be equal. The port runs in float64 (ROADMAP §C.5: the
    float32 port and the float32 JAX package each keep the float64 answer
    to only ~1e-3 px, so two float32 runs may differ by their sum; with
    the float64 port as the reference the gap is the JAX package's own)."""
    jmodel, variables, _ = models
    size = SIZES[n]
    ref = TPUStreamDetector(jmodel, variables, input_size=size,
                            mesh=j_make_spatial_mesh(jax.devices()[:n]), **KW)
    det = CUDAStreamDetector(port64, input_size=size, mesh=cpu_mesh(n), **KW)
    kept = 0
    for frame in frames(size, seed=n):
        kept += assert_same_detections(det(frame, preprocessed=True), ref(frame),
                                       1e-3 + 2 * 1e-4, 1e-5 + 2 * 1e-5)
    assert kept > 0
    assert det.n_saturated == ref.n_saturated


# ---------------------------------------------------- construction, weights


def test_rejects_indivisible_height(models):
    with pytest.raises(ValueError, match="divisible"):
        CUDAStreamDetector(models[2], input_size=(40, 64), mesh=cpu_mesh(3), **KW)


def test_rejects_device_preproc(models):
    with pytest.raises(ValueError, match="spatial mesh"):
        CUDAStreamDetector(models[2], input_size=(40, 64), mesh=cpu_mesh(2),
                           device_preproc=True, **KW)


def test_default_mesh_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_spatial_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_spatial_mesh(["cuda:0", "cuda:0"])


def test_one_device_mesh_is_the_plain_detector(models):
    det = CUDAStreamDetector(models[2], input_size=(40, 64), mesh=cpu_mesh(1), **KW)
    assert det.mesh is None and det.device == torch.device("cpu")
    frame = frames((40, 64))[0]
    det(frame, preprocessed=True)
    assert all(isinstance(b, torch.Tensor) for b in det._buffer)


def test_mesh_serves_eagerly_without_reading_aot_dir(models, tmp_path, caplog):
    with caplog.at_level(logging.INFO, logger="streamyolo_torch"):
        det = CUDAStreamDetector(models[2], input_size=(40, 64), mesh=cpu_mesh(2),
                                 aot_dir=str(tmp_path / "missing"), **KW)
    assert not det.aot_loaded and det.graphs is None
    assert [r.message for r in caplog.records if "is not read" in r.message]
    assert not (tmp_path / "missing").exists()


def test_model_copies_follow_load_state_dict(models):
    """One copy per distinct device; ``load_state_dict`` on the model
    reaches every copy (two distinct CPU device names stand in for two
    cards), and a copy is no alias of the model."""
    model = copy.deepcopy(models[2])
    reps = replicated(make_spatial_mesh(["cpu", "cpu:0", "cpu"]), model)
    assert len(reps.copies) == 2 and reps["cpu"] is model
    other = reps["cpu:0"]
    assert other is not model
    assert [type(m) for m in reps.per_shard()] == [StreamYOLO] * 3
    state = {k: v + 1 if v.is_floating_point() else v for k, v in model.state_dict().items()}
    model.load_state_dict(state, strict=True)
    for k, v in other.state_dict().items():
        assert torch.equal(v, state[k]), k
    assert other.backbone.jian0.conv.weight.data_ptr() != model.backbone.jian0.conv.weight.data_ptr()
