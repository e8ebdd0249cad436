"""The port's int8 post-training quantization (``streamyolo_torch/quant``,
the quantized ``BaseConv`` and ``ops/int8_conv.py``'s plain version)
against the JAX package's (``streamyolo_tpu/quant``), on the CPU.

The model is the tiny one of ``tests/test_quant.py`` (depth 0.33, width
0.25, 8 classes, 32x48), JAX-initialised, BatchNorm statistics drawn from a
seed, obj/cls prediction biases lifted to 0. Bounds:

  * the int8 conv (quantize, int8 conv, dequantize) of the port's plain
    version against the JAX ``BaseConv._int8_conv``: equal in every element,
    float32 and bf16, on-grid, off-grid, ``.5`` ties and values beyond
    +-127, k 1 / 3, stride 1 / 2, groups 1 and C, per-tensor and per-channel;
  * calibration: the first conv (exact pixels) equal; elsewhere each conv's
    absmax (its per-tensor scale) within relative 1e-5 and every channel
    within 1e-5 of it (the float32 trunk rounds differently in the two
    packages, and BatchNorm scales amplify that in small channels);
  * from the same (JAX) calibration: ``kernel_q``, ``w_scale`` and
    ``act_scale`` equal in every element; the folded float entries equal;
  * the JAX-quantized model carried into the port, float32: decoded boxes
    within ``BOX_TOL`` px and scores within ``SCORE_TOL``. An int8 code
    flips where the float32 noise of the two packages (~1e-6) moves a value
    across a rounding boundary of its conv's input; one flip moves that
    conv's output by at most ``act_scale * w_scale`` per kernel tap, which
    the tolerance covers (measured: see the constants);
  * bf16 blocks: the ulp bounds of ``tests/test_torch_bf16_blocks.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from streamyolo_tpu.models import DFPPAFPN as JDFPPAFPN
from streamyolo_tpu.models import StreamYOLO as JStreamYOLO
from streamyolo_tpu.models import TALHead as JTALHead
from streamyolo_tpu.nn import blocks as jb
from streamyolo_tpu.quant import calibrate_activations as j_calibrate
from streamyolo_tpu.quant import quantize_variables
from streamyolo_tpu.stream import MultiStreamDetector as JMultiStreamDetector
from streamyolo_tpu.stream import TPUStreamDetector
from streamyolo_torch.models import DFPPAFPN, StreamYOLO, TALHead
from streamyolo_torch.nn import blocks as tb
from streamyolo_torch.ops.int8_conv import int8_conv, int8_conv_plain
from streamyolo_torch.quant import (
    calibrate_activations,
    flax_module_path,
    quantize_for_serving,
    quantize_state_dict,
)
from streamyolo_torch.stream import CUDAStreamDetector, MultiStreamDetector
from streamyolo_torch.utils.weights import flax_path_to_torch, jax_variables_to_state_dict

from .test_torch_bf16_blocks import assert_bf16_bounds, to_nhwc
from .torch_port_helpers import lift_pred_biases, nhwc_to_nchw, pin_threads, randomize_bn

INPUT = (32, 48)
BOX_TOL, SCORE_TOL = 1e-4, 1e-5
KW = dict(input_size=INPUT, in_scale=0.5, conf_thre=0.05, nms_thre=0.5,
          num_classes=8, pre_nms_topk=16, use_bf16=False)


one_thread = pin_threads(1)


def port_model():
    return StreamYOLO(DFPPAFPN(0.33, 0.25), TALHead(num_classes=8, width=0.25)).eval()


def to_port_absmax(calib):
    """The JAX calibration tree -> ``{torch module name: [C_in] tensor}``."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(calib):
        keys = tuple(p.key for p in path)
        assert keys[-1] == "in_absmax"
        name = flax_path_to_torch("params", keys[:-1] + ("bias",), 1)[0][: -len(".bias")]
        out[name] = torch.from_numpy(np.array(leaf, np.float32))
    return out


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, float variables, JAX-quantized variables, calibration
    batches, JAX calibration tree)."""
    jmodel = JStreamYOLO(backbone=JDFPPAFPN(depth=0.33, width=0.25, packed=False),
                         head=JTALHead(num_classes=8, width=0.25))
    init = jax.jit(lambda key, x: jmodel.init(key, x, mode="off_pipe"))
    variables = lift_pred_biases(randomize_bn(jax.tree_util.tree_map(
        np.asarray, init(jax.random.PRNGKey(0), jnp.zeros((1, *INPUT, 6), jnp.float32)))))
    rng = np.random.default_rng(3)
    batches = [rng.uniform(0, 255, (2, *INPUT, 6)).astype(np.float32) for _ in range(2)]
    calib = j_calibrate(jmodel, variables, batches, mode="off_pipe")
    qvars = quantize_variables(variables, calib)
    return jmodel, variables, qvars, batches, calib


# ---------------------------------------------------------------- the conv


def conv_case(rng, kind, c, per_channel):
    """(x NHWC float32, act_scale) of one case: 'grid' integers with act
    scale 1, 'ties' halves (every odd one a .5 tie) reaching +-150 with act
    scale 1, 'offgrid' normal values with the calibrated scale."""
    shape = (2, 9, 11, c)
    if kind == "grid":
        x = rng.integers(-127, 128, shape).astype(np.float32)
    elif kind == "ties":
        x = (rng.integers(-300, 301, shape) / 2).astype(np.float32)
    else:
        x = rng.normal(0, 2.0, shape).astype(np.float32)
    if per_channel:
        absmax = np.maximum(np.abs(x).max(axis=(0, 1, 2)), 1e-8)
        act = (absmax / 127.0).astype(np.float32)
        if kind != "offgrid":
            act = np.ones(c, np.float32)
            act[::2] = 0.5  # scaled ties: v / 0.5 is exact
    else:
        act = np.float32(1.0) if kind != "offgrid" else np.float32(np.abs(x).max() / 127.0)
    return x, act


CONV_CASES = [  # (kind, ksize, stride, groups, per_channel, dtype)
    ("grid", 3, 1, 1, False, "float32"),
    ("ties", 3, 1, 1, False, "float32"),
    ("ties", 1, 1, 1, False, "float32"),
    ("offgrid", 3, 2, 1, False, "float32"),
    ("offgrid", 1, 2, 1, True, "float32"),
    ("ties", 3, 2, 1, True, "float32"),
    ("offgrid", 3, 1, "C", False, "float32"),
    ("ties", 3, 2, "C", True, "float32"),
    ("offgrid", 3, 1, 1, False, "bfloat16"),
    ("ties", 3, 2, 1, True, "bfloat16"),
    ("offgrid", 1, 1, "C", False, "bfloat16"),
]


@pytest.mark.parametrize("kind,ksize,stride,groups,per_channel,dtype", CONV_CASES)
def test_int8_conv_plain_matches_jax(kind, ksize, stride, groups, per_channel, dtype):
    """The plain int8 conv equals the JAX ``BaseConv._int8_conv`` bit for bit."""
    rng = np.random.default_rng(ksize * 7 + stride)
    c, co = 16, 24
    groups = c if groups == "C" else groups
    co = c if groups == c else co
    x, act = conv_case(rng, kind, c, per_channel)
    kernel = rng.normal(0, 0.3, (ksize, ksize, c // groups, co)).astype(np.float32)
    w_scale = (np.maximum(np.abs(kernel).max(axis=(0, 1, 2)), 1e-8) / 127.0).astype(np.float32)
    kq = np.clip(np.round(kernel / w_scale), -127, 127).astype(np.int8)
    jdtype = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    block = jb.BaseConv(co, ksize, stride, groups=groups, dtype=jdtype)
    variables = {"params": {"conv": {"kernel": kernel}}, "quant": {
        "kernel_q": kq, "w_scale": w_scale, "act_scale": act}}
    xj = jnp.asarray(x, jdtype)
    want = np.asarray(block.apply(variables, xj, method=lambda m, v: m._int8_conv(
        v, (ksize - 1) // 2)).astype(jnp.float32))
    tdtype = getattr(torch, dtype)
    got = int8_conv(nhwc_to_nchw(x).to(tdtype), torch.from_numpy(kq.transpose(3, 2, 0, 1).copy()),
                    torch.from_numpy(w_scale), torch.as_tensor(act), stride=stride,
                    groups=groups)
    assert got.dtype == tdtype
    np.testing.assert_array_equal(to_nhwc(got), want)


def test_int8_conv_refuses_bad_operands():
    x = torch.zeros(1, 8, 4, 4)
    kq = torch.zeros(4, 8, 3, 3, dtype=torch.int8)
    ws, act = torch.ones(4), torch.tensor(1.0)
    with pytest.raises(TypeError, match="int8 kernel"):
        int8_conv(x, kq.float(), ws, act)
    with pytest.raises(TypeError, match="w_scale"):
        int8_conv(x, kq, ws.to(torch.bfloat16), act)
    with pytest.raises(TypeError, match="act_scale"):
        int8_conv(x, kq, ws, torch.ones(3))
    with pytest.raises(ValueError, match="groups"):
        int8_conv(x, kq, ws, act, groups=3)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        int8_conv(x.double(), kq, ws, act)
    with pytest.raises(ValueError, match="cpu or cuda"):
        int8_conv(x.to("meta"), kq, ws, act)


def test_plain_version_is_exact_at_the_largest_sum():
    """127 * 127 * 9 * 1024 (the widest 3x3 conv at full scale) is exact
    through the float64 conv and rounds once to float32."""
    x = torch.full((1, 1024, 3, 3), 127.0)
    kq = torch.full((1, 1024, 3, 3), 127, dtype=torch.int8)
    got = int8_conv_plain(x, kq, torch.ones(1), torch.tensor(1.0))
    assert float(got[0, 0, 1, 1]) == float(np.float32(127 * 127 * 9 * 1024))


# ------------------------------------------------------ calibrate, quantize


def test_calibration_matches_jax(tiny):
    jmodel, variables, _, batches, calib = tiny
    port = port_model()
    port.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    got = calibrate_activations(port, batches)
    want = to_port_absmax(calib)
    assert got.keys() == want.keys() and len(got) > 50
    stem = "backbone.backbone.stem.conv"
    assert torch.equal(got[stem], want[stem])
    for name in want:
        g, w = got[name].numpy(), want[name].numpy()
        np.testing.assert_allclose(g.max(), w.max(), rtol=1e-5, atol=0, err_msg=name)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * w.max(), err_msg=name)
    with pytest.raises(ValueError, match="at least one batch"):
        calibrate_activations(port, [])


@pytest.mark.parametrize("per_channel", [False, True])
def test_quantize_matches_jax(tiny, per_channel):
    """From the JAX calibration, the port's quantized state dict equals the
    JAX quantized variables converted."""
    _, variables, _, _, calib = tiny
    want = jax_variables_to_state_dict(
        quantize_variables(variables, calib, per_channel_act=per_channel))
    got = quantize_state_dict(jax_variables_to_state_dict(variables), to_port_absmax(calib),
                              per_channel_act=per_channel)
    assert got.keys() == want.keys()
    n_q = 0
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key
        n_q += key.endswith(".kernel_q")
    assert n_q > 50 and got["backbone.backbone.stem.conv.kernel_q"].dtype == torch.int8
    act_dims = {got[k].ndim for k in got if k.endswith(".act_scale")}
    assert act_dims == ({1} if per_channel else {0})


def test_quantize_skip_strip_and_fallbacks(tiny):
    """``skip`` selects the same convs as the JAX regexes (matched against
    the flax path), ``strip`` leaves the placeholder, a ``BaseConv`` at the
    root quantizes, a grouped conv keeps the per-tensor scale, and no match
    raises."""
    _, variables, _, _, calib = tiny
    sd, absmax = jax_variables_to_state_dict(variables), to_port_absmax(calib)
    assert flax_module_path("head.cls_convs.0.1") == "head/cls_convs_0_1"
    for skip in ([r"head"], [r"dark2_0/"], [r"backbone/backbone/dark3_1/m_0"]):
        want = jax_variables_to_state_dict(quantize_variables(variables, calib, skip=skip))
        got = quantize_state_dict(sd, absmax, skip=skip)
        assert {k for k in got if k.endswith("kernel_q")} \
            == {k for k in want if k.endswith("kernel_q")}, skip
    assert not any(k.startswith("head.") and k.endswith("kernel_q")
                   for k in quantize_state_dict(sd, absmax, skip=[r"head"]))
    stripped = quantize_state_dict(sd, absmax, strip=True)
    want = jax_variables_to_state_dict(quantize_variables(variables, calib, strip=True))
    assert stripped.keys() == want.keys()
    assert tuple(stripped["backbone.backbone.dark2.0.conv.weight"].shape) == (1, 1, 1, 1)
    assert stripped["head.cls_preds.0.weight"].numel() > 1  # not a CBS conv
    with pytest.raises(ValueError, match="no conv matched"):
        quantize_state_dict(sd, absmax, skip=[r"."])
    with pytest.raises(ValueError, match="no conv matched"):
        quantize_state_dict(sd, {})

    # a BaseConv at the root, stripped: the same entries as JAX's, and it loads
    rng = np.random.default_rng(6)
    xr = rng.normal(size=(2, 6, 6, 8)).astype(np.float32)
    jroot = jb.BaseConv(16, 3)
    vroot = randomize_bn(jax.tree_util.tree_map(
        np.asarray, jroot.init(jax.random.PRNGKey(0), jnp.asarray(xr))))
    croot = j_calibrate(jroot, vroot, [xr])
    want = jax_variables_to_state_dict(quantize_variables(vroot, croot, strip=True))
    got = quantize_state_dict(jax_variables_to_state_dict(vroot), to_port_absmax(croot),
                              strip=True)
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
    root = tb.BaseConv(8, 16, 3)
    root.load_state_dict(got, strict=True)
    assert root.kernel_q.is_contiguous(memory_format=torch.channels_last)

    dw = tb.DWConv(8, 16, 3).eval()
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 6, 6, 8)).astype(np.float32))
    q = quantize_state_dict(dw.state_dict(), _calibrate_plain(dw, x), per_channel_act=True)
    assert q["dconv.act_scale"].ndim == 0 and q["pconv.act_scale"].shape == (8,)
    dw.load_state_dict(q, strict=True)
    with torch.no_grad():
        assert torch.isfinite(dw(x.permute(0, 3, 1, 2))).all()


def _calibrate_plain(module, x_nhwc):
    """``calibrate_activations`` for a module whose forward takes NCHW."""
    class Wrap(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.m = module

        def forward(self, x, mode=None):
            return self.m(x.permute(0, 3, 1, 2))

    wrapped = calibrate_activations(Wrap().eval(), [x_nhwc])
    return {k[len("m."):]: v for k, v in wrapped.items()}


# ------------------------------------------------------- the quantized model


def quantized_port(qvars, dtype=torch.float32):
    port = port_model()
    port.load_state_dict(jax_variables_to_state_dict(qvars), strict=True)
    return port.to(dtype)


def gaps(got, want):
    """(max box gap in px, max score gap) of two decoded ``[B, N, 5+C]``."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    d = np.abs(got - want)
    return float((d[..., :4] / (np.abs(want[..., :4]) + 1.0)).max()), float(d[..., 4:].max())


def test_quantized_model_matches_jax(tiny):
    """JAX-quantized variables carried into the port: off_pipe, two
    on_pipe steps and seq within (``BOX_TOL``, ``SCORE_TOL``) of JAX."""
    jmodel, _, qvars, _, _ = tiny
    port = quantized_port(qvars)
    assert port.backbone.backbone.stem.conv.kernel_q.dtype == torch.int8
    x6 = np.random.default_rng(4).uniform(0, 255, (2, *INPUT, 6)).astype(np.float32)
    apply = jax.jit(jmodel.apply, static_argnames="mode")
    found = []
    with torch.no_grad():
        got = port(torch.from_numpy(x6), mode="off_pipe")
        found.append(gaps(got, apply(qvars, jnp.asarray(x6), mode="off_pipe")))
        buf = jbuf = None
        for t in range(2):
            frame = x6[..., 3 * t:3 * t + 3]
            got, buf = port(torch.from_numpy(frame), buffer=buf, mode="on_pipe")
            want, jbuf = apply(qvars, jnp.asarray(frame), buffer=jbuf, mode="on_pipe")
            found.append(gaps(got, want))
        shift = np.array([0, 1])
        frames = x6[..., :3]
        got, _ = port(torch.from_numpy(frames), mode="seq", support_shift=torch.from_numpy(shift))
        want, _ = apply(qvars, jnp.asarray(frames), mode="seq",
                        support_shift=jnp.asarray(shift.astype(np.int32)))
        found.append(gaps(got, want))
    assert all(b <= BOX_TOL and s <= SCORE_TOL for b, s in found), found


@pytest.mark.parametrize("ksize,stride,per_channel", [(3, 2, False), (1, 1, False),
                                                      (3, 1, True)])
def test_quantized_block_bf16(rng, ksize, stride, per_channel):
    """A bf16 quantized ``BaseConv`` within the 1-ulp bound of the float
    bf16 ``BaseConv``; the scales stay float32 and ``kernel_q`` int8 under
    ``.to(torch.bfloat16)``; training raises. (A chain of quantized convs
    has no ulp bound: one bf16 ulp of a conv's output, where the two
    packages round BN differently, is up to half an int8 step of the next
    conv's input, and so flips its code.)"""
    x = (rng.standard_normal((2, 13, 17, 8)) * 40 + 100).astype(np.float32)
    flax32 = jb.BaseConv(16, ksize, stride)
    flax16 = jb.BaseConv(16, ksize, stride, dtype=jnp.bfloat16)
    port, n_ulps = tb.BaseConv(8, 16, ksize, stride), 1
    variables = randomize_bn(jax.tree_util.tree_map(
        np.asarray, flax32.init(jax.random.PRNGKey(0), jnp.asarray(x))))
    qvars = quantize_variables(variables, j_calibrate(flax32, variables, [x]),
                               per_channel_act=per_channel)
    x16 = jnp.asarray(x, jnp.bfloat16)
    want16 = np.asarray(flax16.apply(qvars, x16).astype(jnp.float32))
    want32 = np.asarray(flax32.apply(qvars, x16.astype(jnp.float32)))
    port.load_state_dict(jax_variables_to_state_dict(qvars), strict=True)
    port = port.eval().to(torch.bfloat16)
    assert port.kernel_q.dtype == torch.int8 and port.bn.weight.dtype == torch.bfloat16
    assert port.w_scale.dtype == port.act_scale.dtype == torch.float32
    assert port.act_scale.ndim == int(per_channel)
    with torch.no_grad():
        got = port(nhwc_to_nchw(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert_bf16_bounds(to_nhwc(got), want16, want32, n_ulps)
    port.train()
    with pytest.raises(ValueError, match="serving-only"):
        port(nhwc_to_nchw(x).to(torch.bfloat16))


def assert_detections_close(got, want):
    for (bb, sc, lb, _), (bb_r, sc_r, lb_r, _) in zip(got, want, strict=True):
        np.testing.assert_array_equal(lb, lb_r)
        np.testing.assert_allclose(bb, bb_r, atol=1e-3, rtol=BOX_TOL)
        np.testing.assert_allclose(sc, sc_r, atol=SCORE_TOL, rtol=0)


def test_quantized_detectors_match_jax(tiny):
    """``CUDAStreamDetector`` and ``MultiStreamDetector`` (N = 2) on the
    CPU, serving the JAX-quantized model, against ``TPUStreamDetector`` and
    the JAX ``MultiStreamDetector`` with the same quantized variables."""
    jmodel, _, qvars, _, _ = tiny
    port = quantized_port(qvars)
    frames = np.random.default_rng(5).integers(0, 256, (3, 2, *INPUT, 3)).astype(np.uint8)
    single, jsingle = CUDAStreamDetector(port, device="cpu", **KW), TPUStreamDetector(
        jmodel, qvars, **KW)
    multi, jmulti = MultiStreamDetector(port, 2, device="cpu", **KW), JMultiStreamDetector(
        jmodel, qvars, 2, **KW)
    n_kept = 0
    for batch in frames:
        want = jsingle(batch[0], preprocessed=True)
        got = single(batch[0], preprocessed=True)
        assert_detections_close([got], [want])
        n_kept += len(got[2])
        assert_detections_close(multi(batch, preprocessed=True), jmulti(batch, preprocessed=True))
    assert n_kept > 0
    assert single.model.backbone.backbone.stem.conv.act_scale.dtype == torch.float32


def test_quantize_for_serving_loads_strict(tiny):
    """The port's own calibrate + quantize on a bf16 model: the float32
    state dict quantizes, the result loads strictly with and without
    ``strip``, and a float state dict makes the blocks float again."""
    _, variables, _, batches, _ = tiny
    sd = jax_variables_to_state_dict(variables)
    port = port_model()
    port.load_state_dict(sd, strict=True)
    port = port.to(torch.bfloat16)
    for strip in (False, True):
        q = quantize_for_serving(port, sd, batches[:1], strip=strip)
        assert all(v.dtype in (torch.float32, torch.int8, torch.int64) for v in q.values())
        port.load_state_dict(q, strict=True)
        stem = port.backbone.backbone.stem.conv
        assert stem.act_scale.dtype == torch.float32 and (stem.conv.weight.numel() == 1) == strip
        with torch.no_grad():
            out = port(torch.from_numpy(batches[0]), mode="off_pipe")
        assert torch.isfinite(out).all()
    port.load_state_dict(sd, strict=True)
    assert stem.kernel_q is None and stem.conv.weight.shape == (16, 12, 3, 3)
    assert "backbone.backbone.stem.conv.kernel_q" not in port.state_dict()
