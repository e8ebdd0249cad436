"""The port's weight converter against the JAX package's exporter, and
strict loading of JAX-exported and released-format weights into the port."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from streamyolo_tpu.models import DFPPAFPN, StreamYOLO, TALHead
from streamyolo_tpu.utils.torch_import import variables_to_state_dict
from streamyolo_torch.models import build_streamyolo
from streamyolo_torch.utils.weights import (
    flax_path_to_torch,
    jax_variables_to_state_dict,
    load_state_dict_file,
)

from .torch_port_helpers import pin_threads, randomize_bn


one_thread = pin_threads(1)


@pytest.fixture(scope="module")
def jax_s_variables():
    """StreamYOLO-s (depth 0.33, width 0.50) as the JAX package builds it,
    initialised on a small canvas (conv params are shape-agnostic)."""
    model = StreamYOLO(backbone=DFPPAFPN(0.33, 0.50), head=TALHead(num_classes=8, width=0.50))
    init = jax.jit(lambda key, x: model.init(key, x, mode="off_pipe"))
    variables = init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 96, 6), jnp.float32))
    return randomize_bn(jax.tree_util.tree_map(np.asarray, variables))


def test_converter_matches_jax_exporter(jax_s_variables):
    ours = jax_variables_to_state_dict(jax_s_variables)
    theirs = variables_to_state_dict(jax_s_variables)
    for key, arr in theirs.items():
        assert key in ours, key
        np.testing.assert_array_equal(ours[key].numpy(), arr)
    extra = set(ours) - set(theirs)
    assert extra == {k.replace("running_mean", "num_batches_tracked")
                     for k in theirs if k.endswith(".running_mean")}
    assert all(int(ours[k]) == 0 for k in extra)


def test_jax_weights_load_strict_at_s_width(jax_s_variables):
    port = build_streamyolo("s", device="cpu")
    port.load_state_dict(jax_variables_to_state_dict(jax_s_variables), strict=True)
    sd = port.state_dict()
    np.testing.assert_array_equal(
        sd["backbone.backbone.dark2.0.conv.weight"].numpy(),
        jax_s_variables["params"]["backbone"]["backbone"]["dark2_0"]["conv"]["kernel"]
        .transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["head.cls_convs.0.1.bn.running_var"].numpy(),
        jax_s_variables["batch_stats"]["head"]["cls_convs_0_1"]["bn"]["var"])


@pytest.mark.parametrize("with_nbt", [True, False])
def test_released_pth_loads_strict(tmp_path, with_nbt):
    """A yolox-named ``.pth`` (trainer layout, weights under ``model``)
    loads strict, whether or not it carries ``num_batches_tracked``."""
    src = build_streamyolo("s", device="cpu", generator=torch.Generator().manual_seed(3))
    sd = {k: v for k, v in src.state_dict().items()
          if with_nbt or not k.endswith("num_batches_tracked")}
    path = tmp_path / "s_s50_one_x.pth"
    torch.save({"model": sd}, path)
    dst = build_streamyolo("s", device="cpu")
    dst.load_state_dict(load_state_dict_file(str(path)), strict=True)
    for key, value in src.state_dict().items():
        torch.testing.assert_close(dst.state_dict()[key], value, rtol=0, atol=0)


def test_safetensors_export_loads_strict(jax_s_variables, tmp_path):
    """The JAX package's ``.safetensors`` export (torch names, OIHW) loads
    strict into the port."""
    pytest.importorskip("safetensors")
    from streamyolo_tpu.utils.checkpoint import save_safetensors

    path = str(tmp_path / "s.safetensors")
    save_safetensors(jax_s_variables, path, torch_layout=True)
    port = build_streamyolo("s", device="cpu")
    port.load_state_dict(load_state_dict_file(path), strict=True)


@pytest.mark.parametrize("collection,path,ndim,want", [
    ("params", ("backbone", "backbone", "dark3_1", "m_0", "conv2", "conv", "kernel"), 4,
     ("backbone.backbone.dark3.1.m.0.conv2.conv.weight", (3, 2, 0, 1))),
    ("params", ("head", "cls_convs_0_1", "bn", "scale"), 1,
     ("head.cls_convs.0.1.bn.weight", None)),
    ("batch_stats", ("backbone", "C3_p4", "conv1", "bn", "var"), 1,
     ("backbone.C3_p4.conv1.bn.running_var", None)),
    ("params", ("head", "obj_preds_2", "bias"), 1, ("head.obj_preds.2.bias", None)),
])
def test_flax_path_to_torch_names(collection, path, ndim, want):
    assert flax_path_to_torch(collection, path, ndim) == want
