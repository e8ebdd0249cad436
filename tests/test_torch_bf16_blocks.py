"""The port's bf16 conv blocks against the flax bf16 modules, on the CPU.

bf16 is the serving operating point (``stream_det`` builds bf16 modules
unless ``--fp32``), and the two packages round differently: the port casts
the whole module to bf16, BatchNorm parameters and statistics included,
where flax keeps them in float32 and normalises in float32. Same variables
(JAX init, BatchNorm statistics drawn from a seed), same input rounded to
bf16. ``ulp`` is one bf16 unit in the last place of the output's largest
magnitude, ``2 ** (floor(log2(max |y|)) - 7)``. Bounds:

  * the port's bf16 output within ``N`` ulps of the flax bf16 output, with
    ``N`` the block's depth of conv layers in series: 1 for ``BaseConv``,
    3 for ``CSPLayer`` (conv1, the bottlenecks' convs, conv3) and
    ``SPPBottleneck`` (conv1, conv2 around the pools), 2 for the DFP fuse
    (a 1x1 conv, then the add);
  * the port's bf16 output no farther from the flax float32 output than
    the flax bf16 output is, plus one ulp.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from streamyolo_tpu.models.dfp_pafpn import DFPPAFPN as JDFPPAFPN
from streamyolo_tpu.nn import blocks as jb
from streamyolo_torch.models.dfp_pafpn import DFPPAFPN
from streamyolo_torch.nn import blocks as tb

from .torch_port_helpers import load_port, nhwc_to_nchw, pin_threads, randomize_bn


one_thread = pin_threads(1)


def ulp_of(y):
    return 2.0 ** (np.floor(np.log2(np.abs(y).max())) - 7)


def to_nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


def assert_bf16_bounds(got, want16, want32, n_ulps):
    ulp = ulp_of(want32)
    gap = np.abs(got - want16).max()
    assert gap <= n_ulps * ulp, f"{gap / ulp:.3f} ulps of port bf16 vs flax bf16"
    assert np.abs(got - want32).max() <= np.abs(want16 - want32).max() + ulp


def run_block(flax16, flax32, port, x, n_ulps):
    variables = randomize_bn(jax.tree_util.tree_map(
        np.asarray, flax32.init(jax.random.PRNGKey(0), jnp.asarray(x))))
    x16 = jnp.asarray(x, jnp.bfloat16)
    want16 = np.asarray(flax16.apply(variables, x16).astype(jnp.float32))
    want32 = np.asarray(flax32.apply(variables, x16.astype(jnp.float32)))
    port = load_port(port, variables).to(torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in port.parameters())
    with torch.no_grad():
        got = port(nhwc_to_nchw(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert_bf16_bounds(to_nhwc(got), want16, want32, n_ulps)


@pytest.mark.parametrize("stride,ksize", [(1, 3), (2, 3), (1, 1)])
def test_baseconv_bf16(rng, stride, ksize):
    # a spread of input scales: raw-pixel-like statistics reach the stem
    x = (rng.standard_normal((2, 13, 17, 8)) * 40 + 100).astype(np.float32)
    run_block(jb.BaseConv(16, ksize, stride, dtype=jnp.bfloat16), jb.BaseConv(16, ksize, stride),
              tb.BaseConv(8, 16, ksize, stride), x, 1)


@pytest.mark.parametrize("width,shortcut", [(14, True), (14, False), (13, True)])
def test_csplayer_bf16(rng, width, shortcut):
    x = rng.standard_normal((2, 10, width, 16), dtype=np.float32)
    run_block(jb.CSPLayer(32, n=2, shortcut=shortcut, dtype=jnp.bfloat16),
              jb.CSPLayer(32, n=2, shortcut=shortcut),
              tb.CSPLayer(16, 32, n=2, shortcut=shortcut), x, 3)


def test_sppbottleneck_bf16(rng):
    x = rng.standard_normal((1, 19, 30, 32), dtype=np.float32)
    run_block(jb.SPPBottleneck(32, dtype=jnp.bfloat16), jb.SPPBottleneck(32),
              tb.SPPBottleneck(32, 32), x, 3)


def test_dfp_fuse_bf16(rng):
    """``concat(jian(cur), jian(sup)) + cur`` at the three levels of a
    width-0.25 PAFPN (64, 128, 256 channels)."""
    depth, width = 0.33, 0.25
    j16, j32 = JDFPPAFPN(depth, width, dtype=jnp.bfloat16), JDFPPAFPN(depth, width)
    variables = randomize_bn(jax.tree_util.tree_map(np.asarray, j32.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 64, 96, 6), jnp.float32))))
    shapes = [(1, 8, 12, 64), (1, 4, 6, 128), (1, 2, 3, 256)]
    cur = [jnp.asarray(rng.standard_normal(s) * 2, jnp.bfloat16) for s in shapes]
    sup = [jnp.asarray(rng.standard_normal(s) * 2, jnp.bfloat16) for s in shapes]
    want16 = j16.apply(variables, cur, sup, method=JDFPPAFPN._dfp_fuse)
    want32 = j32.apply(variables, [c.astype(jnp.float32) for c in cur],
                       [s.astype(jnp.float32) for s in sup], method=JDFPPAFPN._dfp_fuse)
    port = load_port(DFPPAFPN(depth, width), variables).to(torch.bfloat16)
    as_port = [nhwc_to_nchw(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)
               for a in cur + sup]
    with torch.no_grad():
        got = port._dfp_fuse(as_port[:3], as_port[3:])
    for g, w16, w32 in zip(got, want16, want32):
        assert g.dtype == torch.bfloat16
        assert_bf16_bounds(to_nhwc(g), np.asarray(w16.astype(jnp.float32)), np.asarray(w32), 2)
