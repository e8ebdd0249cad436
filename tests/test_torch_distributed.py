"""The port's data parallelism (``streamyolo_torch/parallel``) on the CPU:
real OS processes on gloo at 127.0.0.1 (``tests/_torch_dist_child.py``,
which imports no JAX), held against one process over the whole batch and
against the JAX package's step on a 2-device data mesh.

StreamYOLO-s cut to depth 0.33, width 0.25, float32, inputs 64x96, a global
batch of 4 (2 per rank), a carried mid-training state (JAX-initialised
weights, seeded BatchNorm statistics, momentum and EMA, step 2, where the schedule is at its peak) converted by
``utils/weights.py::jax_train_state_to_port``. Tolerances:

  * BatchNorm over two ranks against one process over the concatenated
    batch: output, input gradient, weight and bias gradients within
    ``1e-6 * max|ref| + 1e-6``; running statistics ``rtol 1e-6``;
  * the two-rank step against the one-process step: ``num_fg`` equal, the
    loss rel 1e-5, every tensor normwise 1e-3 (the bound of
    tests/test_distributed.py: only the reduction order differs); the ranks
    bitwise equal;
  * the two-rank rematerialised step (its re-run all-reduces BatchNorm's
    statistics again) against the two-rank plain step: bitwise equal, and
    the ranks bitwise equal;
  * against the JAX step on a 2-device mesh: the bounds of
    tests/test_torch_train_step.py::test_three_steps_from_a_carried_state_match_jax;
  * the sharded eval's AP against one process: equal, the rows as
    tests/test_torch_eval.py's (boxes atol 1e-3, scores 1e-5).

SimOTA's assignment is discrete: a different reduction order may flip it,
so every step comparison checks ``num_fg`` first and names a flip as such.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax

from streamyolo_tpu.exp import get_exp as j_get_exp
from streamyolo_tpu.parallel import make_mesh
from streamyolo_tpu.train import build_lr_schedule as j_build_lr_schedule
from streamyolo_tpu.train import create_train_state as j_create_train_state
from streamyolo_tpu.train import jit_train_step
from streamyolo_tpu.train import make_train_step as j_make_train_step
from streamyolo_torch import parallel
from streamyolo_torch.exp import get_exp
from streamyolo_torch.nn.blocks import BN_EPS, BN_MOMENTUM, BatchNorm2d
from streamyolo_torch.tools import eval as eval_tool
from streamyolo_torch.utils.weights import jax_train_state_to_port

from ._torch_dist_child import CFG, NCLS, SCHED, SMALL, run_step
from .torch_port_helpers import randomize_bn, torch_threads, write_textured_argoverse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "_torch_dist_child.py")
TIMEOUT_S = 300


class Ranks:
    """Child processes started together; their output goes to files (a pipe
    could fill and stall a rank), and ``wait`` kills any that outlive the
    timeout, so none is left holding a port."""

    def __init__(self, cmds, log_dir, tag):
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        self.procs, self.logs = [], []
        try:
            for r, cmd in enumerate(cmds):
                log = open(os.path.join(log_dir, f"{tag}_{r}.log"), "w+")
                self.logs.append(log)
                self.procs.append(subprocess.Popen([sys.executable, CHILD, *map(str, cmd)],
                                                   env=env, stdout=log,
                                                   stderr=subprocess.STDOUT, text=True))
        except BaseException:
            self.wait(0)
            raise

    def wait(self, timeout: float):
        """Wait for every child; returns their exit codes and logs."""
        deadline = time.monotonic() + timeout
        try:
            for p in self.procs:
                p.wait(timeout=max(deadline - time.monotonic(), 0))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=30)
        out = []
        for log in self.logs:
            log.seek(0)
            out.append(log.read())
            log.close()
        return [p.returncode for p in self.procs], out

    def wait_ok(self, timeout: float):
        """``wait``, and every child exited 0; returns their logs."""
        codes, logs = self.wait(timeout)
        for r, (code, log) in enumerate(zip(codes, logs)):
            assert code == 0, f"process {r} exited {code}:\n{log[-4000:]}"
        return logs


def make_batch(seed, b=4):
    rng = np.random.RandomState(seed)
    labels = np.zeros((b, 6, 5), np.float32)
    for i in range(b):
        k = 2 + i % 3
        labels[i, :k, 0] = rng.randint(0, NCLS, k)
        labels[i, :k, 1:3] = rng.uniform(10, 50, (k, 2)) * [1.5, 1.0]
        labels[i, :k, 3:5] = rng.uniform(8, 30, (k, 2))
    support = labels.copy()
    support[..., 1:3] += rng.normal(0, 2, support[..., 1:3].shape).astype(np.float32)
    support[labels.sum(-1) == 0] = 0.0
    return {"images": rng.randint(0, 256, (b, 64, 96, 6)).astype(np.uint8),
            "labels": labels, "support_labels": support}


def carried_jax_state(jmodel, sched):
    """A mid-training JAX state: JAX-initialised weights, seeded BatchNorm
    statistics, momentum and EMA, step 2 (the schedule's peak LR)."""
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k, x: jmodel.init(k, x, mode="off_pipe"))(
            jax.random.PRNGKey(1), np.zeros((1, 64, 96, 6), np.float32)))
    variables = randomize_bn(variables, seed=3)
    state, tx = j_create_train_state(variables, sched)
    rng = np.random.default_rng(4)

    def noisy(tree, scale):
        return jax.tree_util.tree_map(
            lambda a: (a + scale * (np.abs(a).mean() + 1e-3)
                       * rng.standard_normal(a.shape)).astype(np.float32), tree)

    trace = jax.tree_util.tree_map(
        lambda a: (1e-2 * rng.standard_normal(a.shape)).astype(np.float32), variables["params"])
    opt = list(state.opt_state)
    opt[1] = opt[1]._replace(trace=trace)
    opt[2] = opt[2]._replace(count=np.int32(2))  # the LR schedule's own step count
    state = state.replace(step=np.int32(2), opt_state=tuple(opt),
                          ema_params=noisy(variables["params"], 0.05),
                          ema_batch_stats=noisy(variables["batch_stats"], 0.05))
    return jax.tree_util.tree_map(np.asarray, state), tx


def to_port(jstate):
    return jax_train_state_to_port({
        "params": jstate.params, "batch_stats": jstate.batch_stats,
        "trace": jstate.opt_state[1].trace, "ema_params": jstate.ema_params,
        "ema_batch_stats": jstate.ema_batch_stats, "step": jstate.step})


def eval_weights():
    """The port's seeded init with the obj / cls prediction biases at 0, so
    the eval has detections."""
    state = get_exp(CFG).merge(SMALL).init_model()
    for k in state:
        if k.startswith(("head.obj_preds.", "head.cls_preds.")) and k.endswith(".bias"):
            state[k] = torch.zeros_like(state[k])
    return state


@pytest.fixture(scope="module")
def dp(tmp_path_factory, fake_argoverse):
    """Writes the inputs, starts the two ranks (``cases``) and the world-1
    process, runs the JAX mesh step and the one-process step meanwhile, and
    collects every result."""
    work = tmp_path_factory.mktemp("dp")
    jexp = j_get_exp(CFG).merge(SMALL)
    jmodel = jexp.get_model()
    jsched = j_build_lr_schedule("yoloxwarmcos", **SCHED)
    jstate, tx = carried_jax_state(jmodel, jsched)
    torch.save(to_port(jstate), work / "carried.pth")
    batch = make_batch(20)
    np.savez(work / "batch.npz", **batch)
    rng = np.random.default_rng(7)
    c = 6
    np.savez(work / "bn.npz",
             # a large mean: E[x^2] - E[x]^2 would cancel badly here
             x=(rng.standard_normal((4, c, 5, 7)) * 2 + 300).astype(np.float32),
             dy=rng.standard_normal((4, c, 5, 7)).astype(np.float32),
             weight=rng.uniform(0.5, 1.5, c).astype(np.float32),
             bias=rng.normal(0, 0.1, c).astype(np.float32),
             running_mean=rng.normal(0, 0.1, c).astype(np.float32),
             running_var=rng.uniform(0.5, 1.5, c).astype(np.float32))
    textured = write_textured_argoverse(tmp_path_factory.mktemp("textured"), (4, 3))
    (work / "eval.json").write_text(json.dumps({"fake": fake_argoverse, "textured": textured}))
    weights = eval_weights()
    torch.save(weights, work / "eval_weights.pth")

    port = parallel.free_local_port()
    ranks = Ranks([["cases", r, 2, port, work] for r in (0, 1)]
                  + [["world1", parallel.free_local_port(), work]], str(work), "dp")
    try:
        mesh = make_mesh(jax.devices()[:2])
        jstep = jit_train_step(j_make_train_step(jmodel, tx, NCLS, jsched), mesh=mesh,
                               donate=False)
        jnew, jm = jstep(jstate, batch)
        jax_out = {"state": to_port(jax.tree_util.tree_map(np.asarray, jnew)),
                   "metrics": {k: float(v) for k, v in jm.items()}}
        with torch_threads(2):
            single = run_step(str(work), 0, 1)
            exp = get_exp(CFG).merge(SMALL + ["data_dir", textured, "test_size", "(60, 96)",
                                              "data_num_workers", "0"])
            model = exp.get_model("cpu")
            model.load_state_dict(weights)
            evaluator = exp.get_evaluator(batch_size=2)
            (ap, ap50, _), rows = evaluator.evaluate(exp.get_forward_fn(model),
                                                     return_outputs=True)
    finally:
        ranks.wait_ok(TIMEOUT_S)
    out = {"work": work, "jax": jax_out, "single": single,
           "single_eval": {"ap": float(ap), "ap50": float(ap50), "rows": rows}}
    for r in (0, 1):
        out[f"bn{r}"] = torch.load(work / f"rank{r}_bn.pth")
        out[f"state{r}"] = torch.load(work / f"rank{r}_step.pth")
        out[f"metrics{r}"] = json.loads((work / f"rank{r}_step.json").read_text())
        out[f"remat_state{r}"] = torch.load(work / f"rank{r}_step_remat.pth")
        out[f"remat_metrics{r}"] = json.loads((work / f"rank{r}_step_remat.json").read_text())
        out[f"eval{r}"] = json.loads((work / f"rank{r}_eval.json").read_text())
    out["world1"] = torch.load(work / "world1.pth")
    return out


def state_tensors(state):
    """(name, tensor) of every float tensor the step updates."""
    for part in ("model", "ema", "momentum"):
        for k, v in state[part].items():
            if v.is_floating_point():
                yield f"{part}.{k}", v


# ---------------------------------------------------------------- helpers


def test_helpers_without_a_group():
    """No process group: rank 0 of 1, and every helper is trivial."""
    assert not torch.distributed.is_initialized()
    assert parallel.get_rank() == 0 and parallel.get_world_size() == 1
    assert parallel.is_main_process()
    obj = {"rows": [1, 2], "x": 3.5}
    assert parallel.all_gather_objects(obj) == [obj]
    stats = np.array([1.5, 2.0, 3.0])
    np.testing.assert_array_equal(parallel.psum_stats(stats), stats)
    assert parallel.synchronize() is None
    parallel.check_same_on_ranks(object(), "anything")  # nothing to compare
    assert parallel.local_batch_size(8) == 8
    batch = {"images": torch.arange(8).view(4, 2)}
    assert torch.equal(parallel.shard_batch(batch, 1, 2)["images"], batch["images"][2:])
    with pytest.raises(ValueError, match="does not split"):
        parallel.local_batch_size(7, 2)


# ---------------------------------------------------------------- BatchNorm


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_two_process_batchnorm_matches_concatenated_batch(dp, dtype):
    """Two ranks' global-batch BatchNorm against one process's BatchNorm2d
    (``F.batch_norm``) over the concatenated batch: in float32 against the
    same in float32 and float64, in float64 against float64. The input's
    mean is 300 and its spread 2, where float32 resolves x - mean only to
    ~ulp(300) = 3e-5. Bound: ``rel`` (1e-6 in float32, 1e-14 in float64)
    relative to the uncentred scale, ``rel * max|x| * max|w / sigma|`` for
    the output and ``rel * max|dy| * max|x| * max|w / sigma| / sigma`` for
    the input gradient (``max|x| / sigma ~ 150`` here); the weight and bias
    gradients ``rel * max|ref|`` plus the same output bound times the count;
    the running statistics ``rtol rel``. ``E[x^2] - E[x]^2`` in float32
    misses the output bound by ~10x at this mean."""
    dt = getattr(torch, dtype)
    rel = {"float32": 1e-6, "float64": 1e-14}[dtype]
    with np.load(dp["work"] / "bn.npz") as f:
        a = {k: torch.from_numpy(f[k]) for k in f.files}

    def one_process(dtype):
        bn = BatchNorm2d(a["x"].shape[1], eps=BN_EPS, momentum=BN_MOMENTUM).to(dtype)
        with torch.no_grad():
            for k in ("weight", "bias", "running_mean", "running_var"):
                getattr(bn, k).copy_(a[k])
        x = a["x"].to(dtype, copy=True).requires_grad_(True)
        y = bn.train()(x)
        (y * a["dy"].to(dtype)).sum().backward()
        return {"y": y.detach(), "dx": x.grad, "dweight": bn.weight.grad,
                "dbias": bn.bias.grad, "running_mean": bn.running_mean,
                "running_var": bn.running_var}

    bn0, bn1 = dp["bn0"][dtype], dp["bn1"][dtype]
    got = {k: torch.cat([bn0[k], bn1[k]]) for k in ("y", "dx")}
    for k in ("dweight", "dbias", "running_mean", "running_var"):
        assert torch.equal(bn0[k], bn1[k]), k  # the same bits on both ranks
        got[k] = bn0[k]
    assert all(v.dtype == dt for k, v in got.items()), {k: v.dtype for k, v in got.items()}
    assert int(bn0["num_batches_tracked"]) == 1
    x = a["x"].double()
    var = x.var(dim=(0, 2, 3), unbiased=False)
    scale = float((a["weight"].double() / (var + BN_EPS).sqrt()).max())
    sigma = float((var + BN_EPS).sqrt().min())
    y_bound = rel * float(x.abs().max()) * scale
    bound = {"y": y_bound, "dx": y_bound * float(a["dy"].abs().max()) / sigma}
    count = x.numel() // x.shape[1]
    refs = (torch.float32, torch.float64) if dt == torch.float32 else (torch.float64,)
    for ref in map(one_process, refs):
        for k in ("y", "dx"):
            err = float((got[k].double() - ref[k].double()).abs().max())
            assert err <= bound[k], (k, ref[k].dtype, err, bound[k])
        for k in ("dweight", "dbias"):
            err = float((got[k].double() - ref[k].double()).abs().max())
            lim = rel * float(ref[k].abs().max()) + count * float(a["dy"].abs().max()) * y_bound
            assert err <= lim, (k, ref[k].dtype, err, lim)
        for k in ("running_mean", "running_var"):
            np.testing.assert_allclose(got[k].double().numpy(), ref[k].double().numpy(),
                                       rtol=rel, err_msg=f"{k} {ref[k].dtype}")


# ---------------------------------------------------------------- the eval


def test_two_process_sharded_eval_gathers_both_halves(dp):
    """The strided shard splits the 7 images 4 / 3; both ranks hold the
    gathered rows of the whole set (ids 1, 2, 5 survive the ONEX rules ->
    rows at +1); COCOeval runs on rank 0 only."""
    r0, r1 = dp["eval0"], dp["eval1"]
    assert r0["n_local_images"] == 4 and r1["n_local_images"] == 3
    assert r0["image_ids"] == r1["image_ids"] == [2, 3, 6]
    assert r0["is_main_output"] and not r1["is_main_output"]
    assert r1["ap50"] == 0.0


def test_two_process_sharded_eval_ap_equals_single_process(dp):
    """The model's sharded, gathered eval (dual-frame forward) scores what
    one process scores with the same weights on the whole val set."""
    r0, r1 = dp["eval0"]["model"], dp["eval1"]["model"]
    single = dp["single_eval"]
    assert r0["n_local_images"] == 4 and r1["n_local_images"] == 3
    assert r0["is_main_output"] and not r1["is_main_output"] and r1["ap"] == 0.0
    assert r0["rows"] == r1["rows"]  # the gather lands on every rank

    def key(row):
        return (row["image_id"], row["category_id"], -row["score"], row["bbox"])

    got, want = sorted(r0["rows"], key=key), sorted(single["rows"], key=key)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g["image_id"], g["category_id"]) == (w["image_id"], w["category_id"])
        np.testing.assert_allclose(g["bbox"], w["bbox"], atol=1e-3, rtol=0)
        assert abs(g["score"] - w["score"]) <= 1e-5
    assert r0["ap"] == pytest.approx(single["ap"], abs=1e-9)
    assert r0["ap50"] == pytest.approx(single["ap50"], abs=1e-9)
    assert set(r0["times_ms"]) == {"forward", "NMS", "inference"}


# ---------------------------------------------------------------- the step


def test_two_process_train_step_ranks_agree_bitwise(dp):
    s0, s1 = dp["state0"], dp["state1"]
    assert s0["step"] == s1["step"] == 3
    names = [k for k, _ in state_tensors(s0)]
    assert names == [k for k, _ in state_tensors(s1)] and len(names) > 300
    for (k, a), (_, b) in zip(state_tensors(s0), state_tensors(s1)):
        assert torch.equal(a, b), k
    assert dp["metrics0"] == dp["metrics1"]


def test_two_process_remat_step_equals_plain_step(dp):
    """Each rank's rematerialised step from the carried state: the two
    ranks bitwise equal, and each bitwise equal to its plain step (the
    running statistics moved once, by the global batch; the count one per
    call)."""
    r0, r1 = dp["remat_state0"], dp["remat_state1"]
    assert r0["step"] == r1["step"] == dp["state0"]["step"] == 3
    assert dp["remat_metrics0"] == dp["remat_metrics1"] == dp["metrics0"]
    for r in (0, 1):
        got, want = dp[f"remat_state{r}"], dp[f"state{r}"]
        assert got["model"].keys() == want["model"].keys()
        for k, v in want["model"].items():  # num_batches_tracked too
            assert torch.equal(got["model"][k], v), (r, k)
        for (k, a), (_, b) in zip(state_tensors(got), state_tensors(want)):
            assert torch.equal(a, b), (r, k)


def test_two_process_train_step_matches_single_process(dp):
    """Two ranks of 2 images against one process over the 4: ``num_fg``
    equal, the loss rel 1e-5, every tensor normwise within 1e-3."""
    metrics, state = dp["single"][1], dp["single"][0]
    assert dp["metrics0"]["num_fg"] == metrics["num_fg"], "SimOTA's assignment flipped"
    for k, v in metrics.items():
        assert dp["metrics0"][k] == pytest.approx(v, rel=1e-5), k
    want = dict(state_tensors(state))
    got = dict(state_tensors(dp["state0"]))
    assert got.keys() == want.keys()
    worst = 0.0
    for k, w in want.items():
        rel = float((got[k].double() - w.double()).norm() / max(float(w.double().norm()), 1e-6))
        worst = max(worst, rel)
        assert rel < 1e-3, (k, rel)
    assert worst > 0.0  # a different reduction order, not the same program


def test_two_process_train_step_matches_jax_data_mesh(dp):
    """The two ranks against the JAX package's step on a 2-device data mesh
    from the same carried state and batch, at the bounds of the three-step
    test: losses rtol 1e-4 (terms 2e-4); parameters atol 1e-5; BatchNorm
    statistics and EMA atol 1e-5 plus rtol 1e-5; momentum per tensor
    ``max |d| <= 2e-3 * max |m|``."""
    jm, jstate = dp["jax"]["metrics"], dp["jax"]["state"]
    tm, tstate = dp["metrics0"], dp["state0"]
    assert tm["num_fg"] == pytest.approx(jm["num_fg"], rel=1e-6), "SimOTA's assignment flipped"
    for k in ("total_loss", "iou_loss", "conf_loss", "cls_loss", "l1_loss"):
        rtol = 1e-4 if k == "total_loss" else 2e-4
        np.testing.assert_allclose(tm[k], jm[k], rtol=rtol, err_msg=k)
    assert tm["lr"] == pytest.approx(jm["lr"], rel=1e-6)
    assert tstate["step"] == jstate["step"] == 3
    params = set(tstate["momentum"])
    for k, v in jstate["model"].items():
        if k in params:
            np.testing.assert_allclose(tstate["model"][k].numpy(), v.numpy(), atol=1e-5, rtol=0,
                                       err_msg=k)
        elif v.is_floating_point():
            np.testing.assert_allclose(tstate["model"][k].numpy(), v.numpy(), atol=1e-5,
                                       rtol=1e-5, err_msg=k)
    for k, v in jstate["ema"].items():
        if v.is_floating_point():
            np.testing.assert_allclose(tstate["ema"][k].numpy(), v.numpy(), atol=1e-5,
                                       rtol=1e-5, err_msg=f"ema {k}")
    assert tstate["momentum"].keys() == jstate["momentum"].keys()
    for k, w in jstate["momentum"].items():
        m = tstate["momentum"][k].numpy()
        assert np.abs(m - w.numpy()).max() <= 2e-3 * np.abs(w.numpy()).max() + 1e-7, k


def test_world_size_one_over_gloo_is_bitwise_no_group(dp):
    plain, grouped = dp["world1"]["plain"], dp["world1"]["grouped"]
    assert plain[1] == grouped[1]
    names = [k for k, _ in state_tensors(plain[0])]
    assert names == [k for k, _ in state_tensors(grouped[0])] and len(names) > 300
    for (k, a), (_, b) in zip(state_tensors(plain[0]), state_tensors(grouped[0])):
        assert torch.equal(a, b), k


# ---------------------------------------------------------------- the CLI


def test_cli_two_machines_over_gloo(tmp_path):
    """``tools/train.py --num_machines 2 --machine_rank r --dist-url ...
    --dist-backend gloo --device cpu`` in two processes, one epoch of 3
    steps at the global batch 2 on the textured fixture (the layout of
    ``fake_argoverse``, 7 frames): both ranks end with the same bits, only
    rank 0 writes the log and checkpoints, and the epoch's gathered AP
    equals a one-process ``tools/eval.py --no-dedup`` of the checkpoint."""
    root = write_textured_argoverse(tmp_path / "data", (4, 3))
    torch.save(eval_weights(), tmp_path / "init.pth")
    out_dir = tmp_path / "out"
    opts = ["depth", "0.33", "width", "0.25", "data_dir", root, "output_dir", str(out_dir),
            "input_size", "(60, 96)", "test_size", "(60, 96)", "random_size", "None",
            "data_num_workers", "0", "max_epoch", "1", "no_aug_epochs", "1",
            "print_interval", "1", "save_history_ckpt", "False", "seed", "3"]
    url = f"tcp://127.0.0.1:{parallel.free_local_port()}"
    ranks = Ranks([["cli", tmp_path / f"rank{r}.pth", "--", "-f", CFG, "-b", "2",
                    "--device", "cpu", "-expn", "run", "-c", tmp_path / "init.pth",
                    "--num_machines", 2, "--machine_rank", r, "--dist-url", url,
                    "--dist-backend", "gloo", *opts] for r in (0, 1)],
                  str(tmp_path), "cli")
    logs = ranks.wait_ok(TIMEOUT_S)
    r0, r1 = (torch.load(tmp_path / f"rank{r}.pth", weights_only=False) for r in (0, 1))
    assert r0["state"]["step"] == r1["state"]["step"] == 3
    for (k, a), (_, b) in zip(state_tensors(r0["state"]), state_tensors(r1["state"])):
        assert torch.equal(a, b), k
    run = out_dir / "run"
    names = sorted(p.name for p in run.iterdir())
    assert {"last_epoch_ckpt.pth", "latest_ckpt.pth", "train_log.txt"} <= set(names)
    assert set(names) - {"best_ckpt.pth", "last_epoch_ckpt.pth", "latest_ckpt.pth",
                         "train_log.txt"} <= {n for n in names if n.startswith("events.")}
    assert sum(n.startswith("events.") for n in names) <= 1  # one TensorBoard writer
    assert "Save weights to" in logs[0] and "Save weights to" not in logs[1]
    assert (run / "train_log.txt").read_text().count("Training starts") == 1
    ckpt = torch.load(run / "latest_ckpt.pth", weights_only=False)
    assert all(torch.equal(ckpt["ema"][k], v) for k, v in r0["state"]["ema"].items())
    (e0,), (e1,) = r0["eval_history"], r1["eval_history"]
    assert e1["ap"] == 0.0  # COCOeval on rank 0 only
    single = eval_tool.main(["-f", CFG, "-c", str(run / "latest_ckpt.pth"), "-b", "2",
                             "--device", "cpu", "--no-dedup", *opts])
    assert len(single["rows"]) > 0
    assert e0["ap"] == pytest.approx(single["ap"], abs=1e-9)
    assert e0["ap50"] == pytest.approx(single["ap50"], abs=1e-9)


def test_group_that_cannot_form_raises_within_its_timeout(tmp_path):
    """Rank 0 of 2 alone: ``init_distributed`` raises after its 3 s timeout;
    nothing carries on as one process."""
    t0 = time.monotonic()
    codes, logs = Ranks([["alone", parallel.free_local_port(), 3]], str(tmp_path), "alone").wait(120)
    assert codes[0] not in (0, None), logs[0][-2000:]
    assert "formed with one of two" not in logs[0]
    assert time.monotonic() - t0 < 90


def test_spawned_workers_fail_together(tmp_path):
    """``-d 2`` on the CPU spawns two workers; the one whose frames fail
    raises, and the launcher exits non-zero instead of waiting on it."""
    root = write_textured_argoverse(tmp_path / "data", (4, 3))
    t0 = time.monotonic()
    codes, logs = Ranks([["cli-fail", tmp_path / "unused.pth", "--", "-f", CFG, "-b", "2",
                          "--device", "cpu", "-d", 2, "--dist-backend", "gloo",
                          "depth", "0.33", "width", "0.25", "data_dir", root,
                          "output_dir", tmp_path / "out", "input_size", "(60, 96)",
                          "test_size", "(60, 96)", "random_size", "None",
                          "data_num_workers", "0", "max_epoch", "1", "no_aug_epochs", "1"]],
                        str(tmp_path), "spawn").wait(TIMEOUT_S)
    assert codes[0] not in (0, None), logs[0][-3000:]
    assert "frames of rank 1 fail" in logs[0], logs[0][-3000:]
    assert time.monotonic() - t0 < TIMEOUT_S - 30
