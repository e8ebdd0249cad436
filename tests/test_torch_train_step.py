"""The port's train step against the JAX package, on the CPU: BatchNorm
training statistics, the SGD decay groups, the LR schedules, the gradients
of the whole model, three SGD + EMA steps from one carried mid-training
state, and the multiscale ``preprocess``.

StreamYOLO-s cut to depth 0.33, width 0.25 (8 classes, TAL head), inputs
64x96, float32 on both sides, weights from the JAX init converted into the
port, inputs from a seed with NumPy. Tolerances:

  * BatchNorm output and running statistics: atol 1e-5;
  * ``lr(step)``: rtol 1e-6;
  * parameter gradients, per tensor: max |d| <= 1e-5 * max |g| + 1e-7;
  * three steps: losses rtol 1e-4; parameters, momentum, EMA and BatchNorm
    statistics atol 1e-5;
  * ``preprocess``: labels atol 1e-4, images atol 1e-3 grey levels.

Three bounds are loosened from the stated ones, each with its measured gap
and cause in the test's docstring: the parameter gradients, the three-step
momentum and loss terms, and the resized images.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from streamyolo_tpu.exp import get_exp as j_get_exp
from streamyolo_tpu.nn import blocks as jb
from streamyolo_tpu.train import build_lr_schedule as j_build_lr_schedule
from streamyolo_tpu.train import create_train_state as j_create_train_state
from streamyolo_tpu.train import make_train_step as j_make_train_step
from streamyolo_tpu.train.optimizer import _decay_mask
from streamyolo_torch.exp import get_exp
from streamyolo_torch.nn import blocks as tb
from streamyolo_torch.train import (
    build_lr_schedule,
    create_train_state,
    load_carried_state,
    make_train_step,
    param_groups,
)
from streamyolo_torch.utils.weights import (
    _flatten,
    flax_path_to_torch,
    jax_train_state_to_port,
    jax_variables_to_state_dict,
)

from .torch_port_helpers import pin_threads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "cfgs", "s_s50_onex_dfp_tal_flip.py")
NCLS = 8
SMALL = ["depth", "0.33", "width", "0.25"]


few_threads = pin_threads(2)


@pytest.fixture(scope="module")
def models():
    jexp = j_get_exp(CFG).merge(SMALL)
    jmodel = jexp.get_model()
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k, x: jmodel.init(k, x, mode="off_pipe"))(
            jax.random.PRNGKey(1), jnp.zeros((1, 64, 96, 6), jnp.float32)))
    return jmodel, variables


def port_model(variables):
    model = get_exp(CFG).merge(SMALL).get_model("cpu", dtype=torch.float32)
    model.load_state_dict(jax_variables_to_state_dict(variables))
    return model.train()


def make_batch(seed, b=2):
    rng = np.random.RandomState(seed)
    labels = np.zeros((b, 6, 5), np.float32)
    for i in range(b):
        k = 2 + i
        labels[i, :k, 0] = rng.randint(0, NCLS, k)
        labels[i, :k, 1:3] = rng.uniform(10, 50, (k, 2)) * [1.5, 1.0]
        labels[i, :k, 3:5] = rng.uniform(8, 30, (k, 2))
    support = labels.copy()
    support[..., 1:3] += rng.normal(0, 2, support[..., 1:3].shape).astype(np.float32)
    support[labels.sum(-1) == 0] = 0.0
    return {"images": rng.randint(0, 256, (b, 64, 96, 6)).astype(np.uint8),
            "labels": labels, "support_labels": support}


def t_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def j_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------- BatchNorm


def test_batchnorm_training_statistics_match_flax(rng):
    """Two training calls of a BaseConv: output and running statistics equal
    flax's. ``torch.nn.BatchNorm2d`` moves the running variance by the
    unbiased batch variance (n / (n - 1) of flax's) and fails here."""
    x1 = rng.standard_normal((2, 2, 3, 4), dtype=np.float32) * 3 + 1
    x2 = rng.standard_normal((2, 2, 3, 4), dtype=np.float32)
    jmod = jb.BaseConv(6, 1)
    variables = jax.tree_util.tree_map(np.asarray, jmod.init(jax.random.PRNGKey(0), x1))
    outs, bs = [], variables["batch_stats"]
    for x in (x1, x2):
        y, upd = jmod.apply({"params": variables["params"], "batch_stats": bs}, jnp.asarray(x),
                            train=True, mutable=["batch_stats"])
        outs.append(np.asarray(y))
        bs = upd["batch_stats"]
    want = jax_variables_to_state_dict({"params": variables["params"], "batch_stats": bs})

    def run(bn_cls):
        mod = tb.BaseConv(4, 6, 1)
        mod.load_state_dict(jax_variables_to_state_dict(variables))
        if bn_cls is not None:
            plain = bn_cls(6, eps=tb.BN_EPS, momentum=tb.BN_MOMENTUM)
            plain.load_state_dict(mod.bn.state_dict())
            mod.bn = plain
        mod.train()
        got = [mod(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())) for x in (x1, x2)]
        return mod, got

    mod, got = run(None)
    for g, w in zip(got, outs):
        np.testing.assert_allclose(g.detach().permute(0, 2, 3, 1).numpy(), w, atol=1e-5)
    for k in ("bn.running_mean", "bn.running_var"):
        np.testing.assert_allclose(mod.state_dict()[k].numpy(), want[k].numpy(), atol=1e-5)
    assert int(mod.bn.num_batches_tracked) == 2
    plain, _ = run(torch.nn.BatchNorm2d)
    gap = float((plain.state_dict()["bn.running_var"] - want["bn.running_var"]).abs().max())
    assert gap > 1e-3, gap  # n = 12 per channel: the unbiased step is 12/11 of flax's


def test_batchnorm_eval_unchanged(rng):
    """In eval mode the BN normalises with the running statistics and moves
    nothing."""
    mod = tb.BaseConv(4, 6, 1).eval()
    with torch.no_grad():
        mod.bn.running_mean.uniform_(-1, 1)
        mod.bn.running_var.uniform_(0.5, 2)
    before = {k: v.clone() for k, v in mod.state_dict().items()}
    x = torch.from_numpy(rng.standard_normal((2, 4, 5, 5), dtype=np.float32))
    with torch.no_grad():
        y = mod(x)
    ref = torch.nn.functional.batch_norm(mod.conv(x), before["bn.running_mean"],
                                         before["bn.running_var"], before["bn.weight"],
                                         before["bn.bias"], False, 0.0, tb.BN_EPS)
    assert torch.allclose(y, torch.nn.functional.silu(ref), atol=1e-6)
    assert all(torch.equal(before[k], v) for k, v in mod.state_dict().items())


# ---------------------------------------------------------------- SGD groups, LR


def test_decay_groups_match_jax_mask(models):
    """The decayed group is exactly the JAX package's masked leaves (flax
    ``kernel``s) by name; BN scales and biases are not decayed."""
    _, variables = models
    decayed, rest = set(), set()
    mask = _decay_mask(variables["params"])
    for (path, value), (_, m) in zip(_flatten(variables["params"]), _flatten(mask)):
        key, _ = flax_path_to_torch("params", path, np.ndim(value))
        (decayed if m else rest).add(key)
    model = port_model(variables)
    names = {id(p): n for n, p in model.named_parameters()}
    bn_w, conv_w, biases = param_groups(model)
    assert {names[id(p)] for p in conv_w} == decayed
    assert {names[id(p)] for p in bn_w + biases} == rest
    assert len(bn_w) + len(conv_w) + len(biases) == len(names)
    assert any(k.startswith("head.cls_preds") for k in decayed)  # the pred convs decay too
    assert all(".bn." in names[id(p)] for p in bn_w)
    opt = create_train_state(model).optimizer
    assert [g["weight_decay"] for g in opt.param_groups] == [0.0, 5e-4, 0.0]
    assert all(g["nesterov"] and g["momentum"] == 0.9 for g in opt.param_groups)


@pytest.mark.parametrize("scheduler", ["yoloxwarmcos", "warmcos", "constant"])
def test_lr_schedule_matches_jax(scheduler):
    kw = dict(lr=0.01, iters_per_epoch=7, max_epoch=5, warmup_epochs=1.5,
              warmup_lr_start=1e-4, min_lr_ratio=0.05, no_aug_epochs=2)
    want = j_build_lr_schedule(scheduler, **kw)
    got = build_lr_schedule(scheduler, **kw)
    steps = range(7 * 5 + 3)
    np.testing.assert_allclose([got(s) for s in steps], [float(want(s)) for s in steps],
                               rtol=1e-6)
    exp = get_exp(CFG)
    shipped = exp.get_lr_schedule(batch_size=32, iters_per_epoch=100)
    lr = 0.001 / 64 * 32
    assert shipped(0) == 0.0 and shipped(50) == pytest.approx(lr * 0.25)
    assert shipped(101) == pytest.approx(lr * 0.05) == shipped(1400)


# ---------------------------------------------------------------- gradients, steps


def test_parameter_gradients_match_jax(models):
    """d total_loss / d every parameter of the whole model (two train-mode
    pafpn passes, DFP fuse, TAL head, SimOTA, TAL loss).

    Bound, per tensor: max |d| <= 1e-3 * max |g| against JAX, loosened from
    1e-5 because 1e-5 is below the float32 noise of this computation: against
    the port run in float64, the port's float32 gradients are off by up to
    2.4e-4 * max |g| and the JAX package's by up to 5.7e-4, and the two by
    6.7e-4 (``tests/torch_train_gaps.py``; the random trunk's train-mode
    BatchNorm over 12 values per channel at the /32 level amplifies float32
    rounding). The port's float32 gradients are also held against its
    float64 ones at 5e-4."""
    jmodel, variables = models
    sched = j_build_lr_schedule("constant", 0.01, 10, 10)
    _, tx = j_create_train_state(variables, sched)
    jstep = j_make_train_step(jmodel, tx, NCLS, sched)
    batch = make_batch(0)
    (_, (jlosses, _)), jgrads = jax.value_and_grad(jstep.loss_fn, has_aux=True)(
        variables["params"], variables["batch_stats"], j_batch(batch))

    tstep = make_train_step(NCLS, build_lr_schedule("constant", 0.01, 10, 10))
    model, m64 = port_model(variables), port_model(variables).double()
    losses = tstep.loss_fn(model, t_batch(batch))
    losses["total_loss"].backward()
    batch64 = {k: (v.double() if v.is_floating_point() else v) for k, v in t_batch(batch).items()}
    tstep.loss_fn(m64, batch64)["total_loss"].backward()
    for k in jlosses:
        np.testing.assert_allclose(float(losses[k].detach()), float(jlosses[k]), rtol=1e-4,
                                   err_msg=k)
    want = jax_variables_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, jgrads),
                                        "batch_stats": {}})
    exact = dict(m64.named_parameters())
    n = 0
    for name, p in model.named_parameters():
        w, g, g64 = want[name].numpy(), p.grad.numpy(), exact[name].grad.numpy()
        scale = float(np.abs(w).max())
        assert float(np.abs(g - w).max()) <= 1e-3 * scale + 1e-7, name
        assert float(np.abs(g - g64).max()) <= 5e-4 * float(np.abs(g64).max()) + 1e-7, name
        n += 1
    assert n == len(want) and n > 100


def carried(jstate):
    return jax_train_state_to_port({
        "params": jstate.params, "batch_stats": jstate.batch_stats,
        "trace": jstate.opt_state[1].trace, "ema_params": jstate.ema_params,
        "ema_batch_stats": jstate.ema_batch_stats, "step": jstate.step})


def test_three_steps_from_a_carried_state_match_jax(models):
    """One JAX step makes a mid-training state (momentum, EMA and BN
    statistics off their init); it is carried into the port and both run
    three more steps under the shipped ``yoloxwarmcos`` at batch 2 (LR
    0.001 / 64 * 2: lr/4, lr, 0.05 lr).

    Bounds: total loss rtol 1e-4, each term rtol 2e-4 (the L1 term measured
    1.1e-4, ``tests/torch_train_gaps.py``); parameters atol 1e-5; BN statistics and
    EMA atol 1e-5 plus rtol 1e-5 (the stem's running variance of raw
    0..255 pixels is ~1e4, where a float32 ulp is ~1e-3); momentum per
    tensor max |d| <= 2e-3 * max |m| (it holds the gradients, whose float32
    noise is the parameter-gradient test's; measured 1.1e-3). A larger LR
    lets SimOTA's discrete choice flip on that noise and the two runs part."""
    jmodel, variables = models
    kw = dict(lr=0.001 / 64 * 2, iters_per_epoch=2, max_epoch=3, warmup_epochs=1,
              no_aug_epochs=3)
    jsched = j_build_lr_schedule("yoloxwarmcos", **kw)
    jstate, tx = j_create_train_state(variables, jsched)
    jstep = jax.jit(j_make_train_step(jmodel, tx, NCLS, jsched))
    jstate, _ = jstep(jstate, j_batch(make_batch(10)))

    model = port_model(variables)
    state = create_train_state(model)
    load_carried_state(state, carried(jax.tree_util.tree_map(np.asarray, jstate)))
    assert state.step == 1
    tstep = make_train_step(NCLS, build_lr_schedule("yoloxwarmcos", **kw))
    lrs = []
    for i in range(3):
        batch = make_batch(11 + i)
        jstate, jm = jstep(jstate, j_batch(batch))
        tm = tstep(state, t_batch(batch))
        lrs.append(tm["lr"])
        for k in jm:
            rtol = 1e-4 if k == "total_loss" else 2e-4
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=rtol,
                                       err_msg=f"step {i} {k}")
    assert lrs == pytest.approx([kw["lr"] / 4, kw["lr"], kw["lr"] * 0.05])
    want = carried(jax.tree_util.tree_map(np.asarray, jstate))
    assert state.step == want["step"] == 4
    got_model = model.state_dict()
    names = {id(p): n for n, p in model.named_parameters()}
    params = set(names.values())
    for k, v in want["model"].items():
        if k in params:
            np.testing.assert_allclose(got_model[k].numpy(), v.numpy(), atol=1e-5, rtol=0,
                                       err_msg=k)
        elif v.is_floating_point():  # running statistics
            np.testing.assert_allclose(got_model[k].numpy(), v.numpy(), atol=1e-5, rtol=1e-5,
                                       err_msg=k)
    for k, v in want["ema"].items():
        if v.is_floating_point():
            np.testing.assert_allclose(state.ema.state[k].numpy(), v.numpy(), atol=1e-5,
                                       rtol=1e-5, err_msg=f"ema {k}")
    for p, s in state.optimizer.state.items():
        m, w = s["momentum_buffer"].numpy(), want["momentum"][names[id(p)]].numpy()
        assert np.abs(m - w).max() <= 2e-3 * np.abs(w).max() + 1e-7, names[id(p)]
    assert len(state.optimizer.state) == len(want["momentum"]) == len(params)
    assert not torch.equal(state.ema.state["head.reg_preds.0.weight"],
                           model.head.reg_preds[0].weight)


def test_fp16_step_keeps_float32_master_weights(models):
    """A bf16-autocast step on the CPU: finite losses, weights, momentum and
    EMA stay float32, and the weights move."""
    _, variables = models
    model = port_model(variables)
    state = create_train_state(model)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = make_train_step(NCLS, build_lr_schedule("constant", 0.01, 10, 10), fp16=True)
    m = step(state, t_batch(make_batch(3)))
    assert all(np.isfinite(float(v)) for v in m.values())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(v.dtype == before[k].dtype for k, v in state.ema.state.items())
    assert all(s["momentum_buffer"].dtype == torch.float32 for s in state.optimizer.state.values())
    assert not torch.equal(before["head.reg_preds.0.weight"], model.head.reg_preds[0].weight)


def test_train_step_after_an_inference_eval_at_the_same_size(models):
    """The decode's cached grids made under ``torch.inference_mode`` (the
    per-epoch eval) serve the next epoch's loss under autograd."""
    _, variables = models
    model = port_model(variables).eval()
    batch = t_batch(make_batch(4))
    with torch.inference_mode():
        model(batch["images"], mode="off_pipe")
    state = create_train_state(model)
    metrics = make_train_step(NCLS, build_lr_schedule("constant", 0.01, 10, 10))(state, batch)
    assert np.isfinite(float(metrics["total_loss"]))


def test_overfit_fixed_batch_loss_decreases():
    """The learning signal of the JAX package's overfit recipe
    (tests/test_train.py, there marked slow): 60 SGD steps at a constant
    5e-3 on one fixed batch cut the total loss below half, from the port's
    own seeded init (catches a wrong stop-gradient, assignment drift or
    optimizer wiring)."""
    exp = get_exp(CFG).merge(SMALL)
    model = exp.get_model("cpu", dtype=torch.float32)
    model.load_state_dict(exp.init_model())
    rng = np.random.RandomState(0)
    labels = np.zeros((2, 8, 5), np.float32)
    labels[:, 0] = [2.0, 48.0, 32.0, 24.0, 18.0]
    labels[:, 1] = [5.0, 20.0, 50.0, 16.0, 12.0]
    batch = {"images": torch.from_numpy(rng.randint(0, 255, (2, 64, 96, 6)).astype(np.float32)),
             "labels": torch.from_numpy(labels), "support_labels": torch.from_numpy(labels.copy())}
    state = create_train_state(model)
    step = make_train_step(8, build_lr_schedule("constant", 5e-3, 10, 100))
    losses = [float(step(state, batch)["total_loss"]) for _ in range(60)]
    assert np.isfinite(losses[-1]) and losses[-1] < 0.5 * losses[0], (losses[0], losses[-1])


# ---------------------------------------------------------------- multiscale


def test_preprocess_matches_jax():
    """Images atol 1e-3 grey levels (loosened from 1e-4: ``F.interpolate``
    computes each tap's source coordinate in float32, the JAX resize in
    float64, and the weights' rounding times values up to 255 measured
    5.6e-4), labels atol 1e-4."""
    jexp, texp = j_get_exp(CFG), get_exp(CFG)
    jexp.input_size = texp.input_size = (48, 64)
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (2, 48, 64, 6)).astype(np.uint8)
    labels = rng.uniform(1, 40, (2, 5, 5)).astype(np.float32)
    for tsize in ((32, 48), (64, 96), (48, 64)):
        jimg, (jlab, jsup) = jexp.preprocess(jnp.asarray(images), (jnp.asarray(labels),
                                                                   jnp.asarray(labels)), tsize)
        timg, (tlab, tsup) = texp.preprocess(torch.from_numpy(images),
                                             (torch.from_numpy(labels),
                                              torch.from_numpy(labels)), tsize)
        assert tuple(timg.shape) == (2, *tsize, 6)
        np.testing.assert_allclose(np.asarray(timg, np.float32), np.asarray(jimg, np.float32),
                                   atol=1e-3, rtol=0)
        np.testing.assert_allclose(tlab.numpy(), np.asarray(jlab), atol=1e-4)
        np.testing.assert_allclose(tsup.numpy(), np.asarray(jsup), atol=1e-4)
    mine = torch.from_numpy(labels.copy())
    texp.preprocess(torch.from_numpy(images), (mine,), (32, 48))
    assert np.array_equal(mine.numpy(), labels)  # the caller's labels are not scaled in place


def test_random_resize_matches_jax():
    jexp, texp = j_get_exp(CFG), get_exp(CFG)
    for seed in (None, 3):
        jexp.seed = texp.seed = seed
        for window in range(40):
            for epoch in (0, 13, 14):
                assert texp.random_resize(window, epoch) == jexp.random_resize(window, epoch)
