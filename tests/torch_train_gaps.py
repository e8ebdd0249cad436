"""The float32 gaps that bound the train-step parity tests, printed as one
JSON line (CPU; imports the JAX package, so it lives beside the tests):

    JAX_PLATFORMS=cpu python -m tests.torch_train_gaps

On the model and batch of ``tests/test_torch_train_step.py``'s gradient
test: per parameter tensor, max |d| / max |g| of the port's float32
gradients against the JAX package's, and of each against the port run in
float64 (the exact answer the two float32 runs approximate). Then the
three-step run of the same file: the largest relative gap of each loss term
and of the momentum buffers.
"""

from __future__ import annotations

import json

import numpy as np
import torch

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

from tests import test_torch_train_step as T  # noqa: E402
from streamyolo_torch.train import (  # noqa: E402
    build_lr_schedule,
    create_train_state,
    load_carried_state,
    make_train_step,
)


def main() -> None:
    jmodel, variables = T.models.__wrapped__()
    sched = T.j_build_lr_schedule("constant", 0.01, 10, 10)
    _, tx = T.j_create_train_state(variables, sched)
    jstep = T.j_make_train_step(jmodel, tx, T.NCLS, sched)
    batch = T.make_batch(0)
    _, jgrads = jax.value_and_grad(jstep.loss_fn, has_aux=True)(
        variables["params"], variables["batch_stats"], T.j_batch(batch))
    want = T.jax_variables_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, jgrads),
                                          "batch_stats": {}})
    tstep = make_train_step(T.NCLS, build_lr_schedule("constant", 0.01, 10, 10))
    m32, m64 = T.port_model(variables), T.port_model(variables).double()
    tstep.loss_fn(m32, T.t_batch(batch))["total_loss"].backward()
    b64 = {k: (v.double() if v.is_floating_point() else v) for k, v in T.t_batch(batch).items()}
    tstep.loss_fn(m64, b64)["total_loss"].backward()
    exact = dict(m64.named_parameters())
    gaps = {"port_vs_jax": 0.0, "port_vs_float64": 0.0, "jax_vs_float64": 0.0}
    for name, p in m32.named_parameters():
        g, w, e = p.grad.numpy(), want[name].numpy(), exact[name].grad.numpy()
        gaps["port_vs_jax"] = max(gaps["port_vs_jax"], np.abs(g - w).max() / np.abs(w).max())
        gaps["port_vs_float64"] = max(gaps["port_vs_float64"],
                                      np.abs(g - e).max() / np.abs(e).max())
        gaps["jax_vs_float64"] = max(gaps["jax_vs_float64"], np.abs(w - e).max() / np.abs(e).max())

    kw = dict(lr=0.001 / 64 * 2, iters_per_epoch=2, max_epoch=3, warmup_epochs=1,
              no_aug_epochs=3)
    jsched = T.j_build_lr_schedule("yoloxwarmcos", **kw)
    jstate, tx = T.j_create_train_state(variables, jsched)
    jrun = jax.jit(T.j_make_train_step(jmodel, tx, T.NCLS, jsched))
    jstate, _ = jrun(jstate, T.j_batch(T.make_batch(10)))
    model = T.port_model(variables)
    state = create_train_state(model)
    load_carried_state(state, T.carried(jax.tree_util.tree_map(np.asarray, jstate)))
    trun = make_train_step(T.NCLS, build_lr_schedule("yoloxwarmcos", **kw))
    loss_gap = {}
    for i in range(3):
        b = T.make_batch(11 + i)
        jstate, jm = jrun(jstate, T.j_batch(b))
        tm = trun(state, T.t_batch(b))
        for k in jm:
            if k != "lr" and float(jm[k]):
                gap = abs(float(tm[k]) / float(jm[k]) - 1)
                loss_gap[k] = max(loss_gap.get(k, 0.0), gap)
    carried = T.carried(jax.tree_util.tree_map(np.asarray, jstate))
    names = {id(p): n for n, p in model.named_parameters()}
    momentum = max(float((s["momentum_buffer"] - carried["momentum"][names[id(p)]]).abs().max()
                         / carried["momentum"][names[id(p)]].abs().max())
                   for p, s in state.optimizer.state.items())
    print(json.dumps({"grad_rel_max": {k: float(v) for k, v in gaps.items()},
                      "three_steps_loss_rel_max": loss_gap,
                      "three_steps_momentum_rel_max": momentum}))


if __name__ == "__main__":
    torch.set_num_threads(4)
    main()
