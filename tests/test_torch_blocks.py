"""Every conv block of the PyTorch port against its flax module: the same
variables (JAX init, BatchNorm statistics drawn from a seed), converted with
the port's converter, the same numpy input. Tolerance: atol 1e-4 in fp32
(convs sum in another order in the two frameworks).

The legacy ``Darknet`` 21 / 53 and its ``ResLayer`` too.
``CSPLayer`` and ``CSPDarknet`` are held against JAX's packed default
(``nn/packed.py`` layouts, the same parameter tree) as well as its raw path."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from streamyolo_tpu.models.darknet import CSPDarknet as JCSPDarknet
from streamyolo_tpu.models.darknet import Darknet as JDarknet
from streamyolo_tpu.nn import blocks as jb
from streamyolo_torch.models.darknet import CSPDarknet, Darknet
from streamyolo_torch.nn import blocks as tb

from .torch_port_helpers import load_port, nhwc_to_nchw, pin_threads, randomize_bn

ATOL = 1e-4


one_thread = pin_threads(1)


def run_parity(flax_mod, port_mod, x_nhwc, atol=ATOL):
    variables = randomize_bn(jax.tree_util.tree_map(
        np.asarray, flax_mod.init(jax.random.PRNGKey(0), jnp.asarray(x_nhwc))))
    want = flax_mod.apply(variables, jnp.asarray(x_nhwc))
    load_port(port_mod, variables)
    with torch.no_grad():
        got = port_mod(nhwc_to_nchw(x_nhwc))
    if isinstance(want, dict):
        assert set(want) == set(got)
        pairs = [(np.asarray(want[k]), got[k]) for k in want]
    else:
        pairs = [(np.asarray(want), got)]
    for w, g in pairs:
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w, atol=atol, rtol=1e-5)


@pytest.mark.parametrize("stride,ksize", [(1, 3), (2, 3), (1, 1)])
def test_baseconv(rng, stride, ksize):
    x = rng.standard_normal((2, 13, 17, 8), dtype=np.float32)
    run_parity(jb.BaseConv(16, ksize, stride), tb.BaseConv(8, 16, ksize, stride), x)


def test_dwconv(rng):
    x = rng.standard_normal((1, 12, 12, 8), dtype=np.float32)
    run_parity(jb.DWConv(16, 3, 2), tb.DWConv(8, 16, 3, 2), x)


@pytest.mark.parametrize("shortcut", [True, False])
def test_bottleneck(rng, shortcut):
    x = rng.standard_normal((2, 9, 11, 16), dtype=np.float32)
    run_parity(jb.Bottleneck(16, shortcut=shortcut), tb.Bottleneck(16, 16, shortcut), x)


@pytest.mark.parametrize("width,shortcut", [
    (14, True),   # even W: JAX runs its packed CSP body
    (14, False),  # packed, no shortcut (the PAFPN's CSPs)
    (13, True),   # odd W: JAX's raw layout
])
def test_csplayer(rng, width, shortcut):
    x = rng.standard_normal((2, 10, width, 16), dtype=np.float32)
    run_parity(jb.CSPLayer(32, n=2, shortcut=shortcut),
               tb.CSPLayer(16, 32, n=2, shortcut=shortcut), x)


def test_csplayer_unpacked_jax(rng):
    x = rng.standard_normal((1, 8, 12, 16), dtype=np.float32)
    run_parity(jb.CSPLayer(32, n=1, packed=False), tb.CSPLayer(16, 32, n=1), x)


def test_spp(rng):
    x = rng.standard_normal((1, 19, 30, 32), dtype=np.float32)
    run_parity(jb.SPPBottleneck(32), tb.SPPBottleneck(32, 32), x)


@pytest.mark.parametrize("fast", [True, False])
def test_focus(rng, fast):
    """JAX's default runs the stem as the equivalent 6x6 stride-2 conv
    (``_FocusStemConv``); the port runs the literal space-to-depth."""
    x = rng.standard_normal((2, 24, 32, 3), dtype=np.float32)
    run_parity(jb.Focus(16, ksize=3, fast=fast), tb.Focus(3, 16, ksize=3), x)


def test_space_to_depth_order():
    x = torch.arange(16.0).reshape(1, 1, 4, 4)
    got = tb.space_to_depth_focus(x)[0, :, 0, 0].tolist()
    assert got == [0.0, 4.0, 1.0, 5.0]  # tl, bl, tr, br of the first 2x2


@pytest.mark.parametrize("packed", [True, False])
def test_cspdarknet(rng, packed):
    """Width 0.25 at 64x96: JAX's default packs the stem and all of dark2."""
    x = rng.standard_normal((1, 64, 96, 3), dtype=np.float32)
    run_parity(JCSPDarknet(0.33, 0.25, packed=packed), CSPDarknet(0.33, 0.25), x)


def test_reslayer(rng):
    x = rng.standard_normal((2, 9, 11, 16), dtype=np.float32)
    run_parity(jb.ResLayer(16), tb.ResLayer(16), x)


@pytest.mark.parametrize("depth", [21, 53])
def test_legacy_darknet(rng, depth):
    """The legacy plain Darknet at a narrow stem (8 channels, 256 at dark5),
    every stage's output; the SPP tail is ``dark5_spp`` in both trees."""
    x = rng.standard_normal((1, 64, 96, 3), dtype=np.float32)
    outs = ("stem", "dark2", "dark3", "dark4", "dark5")
    run_parity(JDarknet(depth, stem_out_channels=8, out_features=outs),
               Darknet(depth, stem_out_channels=8, out_features=outs), x)
