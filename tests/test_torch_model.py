"""StreamYOLO of the PyTorch port against the JAX package: off_pipe eval
(6-channel and 3-channel self-duplicate), on_pipe star and on_pipe steady
with the DFP buffer carry. Depth 0.33, width 0.25 at 120x160 (the stride-16
level 8x10 upsamples to 15x20, a non-integer scale as at 600x960).
Tolerance as ``tests/test_model_parity.py``: atol 2e-3, rtol 1e-4 (decoded
xy/wh are in pixels, up to ~160)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from streamyolo_tpu.models import DFPPAFPN as JDFPPAFPN
from streamyolo_tpu.models import StreamYOLO as JStreamYOLO
from streamyolo_tpu.models import TALHead as JTALHead
from streamyolo_tpu.ops.resize import resize_nearest as j_resize_nearest
from streamyolo_torch.models import DFPPAFPN, StreamYOLO, TALHead
from streamyolo_torch.ops.resize import resize_nearest

from .torch_port_helpers import load_port, nhwc_to_nchw, pin_threads, randomize_bn

DEPTH, WIDTH, NCLS = 0.33, 0.25, 8
TOL = dict(atol=2e-3, rtol=1e-4)


one_thread = pin_threads(1)


@pytest.fixture(scope="module")
def pair():
    jmodel = JStreamYOLO(backbone=JDFPPAFPN(DEPTH, WIDTH),
                         head=JTALHead(num_classes=NCLS, width=WIDTH))
    init = jax.jit(lambda key, x: jmodel.init(key, x, mode="off_pipe"))
    variables = randomize_bn(jax.tree_util.tree_map(
        np.asarray, init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 96, 6), jnp.float32))))
    port = StreamYOLO(DFPPAFPN(DEPTH, WIDTH), TALHead(num_classes=NCLS, width=WIDTH))
    return jmodel, variables, load_port(port, variables)


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(0)
    return [rng.uniform(0, 255, (1, 120, 160, 3)).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("channels", [6, 3])
def test_off_pipe_eval(pair, frames, channels):
    jmodel, variables, port = pair
    x = np.concatenate(frames, -1)[..., :channels]
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), mode="off_pipe"))
    with torch.no_grad():
        got = port(torch.from_numpy(x), mode="off_pipe").numpy()
    assert got.shape == want.shape == (1, 15 * 20 + 8 * 10 + 4 * 5, 5 + NCLS)
    np.testing.assert_allclose(got, want, **TOL)


def test_on_pipe_star_then_steady(pair, frames):
    jmodel, variables, port = pair
    prev, cur = frames
    j_star, j_buf = jmodel.apply(variables, jnp.asarray(prev), mode="on_pipe")
    j_steady, _ = jmodel.apply(variables, jnp.asarray(cur), buffer=j_buf, mode="on_pipe")
    with torch.no_grad():
        star, buf = port(torch.from_numpy(prev), mode="on_pipe")
        steady, _ = port(torch.from_numpy(cur), buffer=buf, mode="on_pipe")
    np.testing.assert_allclose(star.numpy(), np.asarray(j_star), **TOL)
    np.testing.assert_allclose(steady.numpy(), np.asarray(j_steady), **TOL)
    # the buffer is the current frame's PAFPN output (NCHW in the port)
    for b, jb in zip(buf, j_buf):
        np.testing.assert_allclose(b.permute(0, 2, 3, 1).numpy(), np.asarray(jb), **TOL)


def test_uint8_input_is_cast(pair, frames):
    _, _, port = pair
    x8 = frames[0].astype(np.uint8)
    with torch.no_grad():
        a, _ = port(torch.from_numpy(x8), mode="on_pipe")
        b, _ = port(torch.from_numpy(x8.astype(np.float32)), mode="on_pipe")
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("src,dst", [((38, 60), (75, 120)), ((8, 10), (15, 20)),
                                     ((4, 5), (8, 10))])
def test_resize_nearest_exact(rng, src, dst):
    x = rng.standard_normal((1, *src, 3), dtype=np.float32)
    want = np.asarray(j_resize_nearest(jnp.asarray(x), dst))
    got = resize_nearest(nhwc_to_nchw(x), dst).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)
