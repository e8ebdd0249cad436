"""The training slice as a whole, on the CPU: the port's ``Trainer`` (one
epoch of 3 steps at batch 2, then its EMA eval) against the JAX train step
run over the batches of the JAX package's own loader, the checkpoints and
``--resume``, and the train CLI with the eval CLI reading what it wrote.

StreamYOLO-s cut to depth 0.33, width 0.25, float32, on the textured
``write_fake_argoverse`` fixture (two sequences of 4 and 3 raw 60x96 frames,
trained and evaluated at 60x96), ``random_size None`` and ``data_num_workers 0`` (as the
JAX trainer's smoke test sets them), the shipped ``yoloxwarmcos`` schedule,
both packages starting from the same JAX-initialised weights (the port
fine-tunes from them with ``-c``). Tolerances: per-step losses rtol 1e-4;
the final EMA atol 1e-5 (BatchNorm statistics also rtol 1e-5: the stem's
running variance of raw pixels is ~1e3, where a float32 ulp is ~1e-4); the
eval's COCO rows as tests/test_torch_eval.py's: equal ids and categories, boxes atol
1e-3, scores atol 1e-5, AP within 0.1 points.
"""

import argparse
import logging
import os
import random
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from streamyolo_tpu.eval.seq_forward import SequentialDedupForward as JSequentialDedupForward
from streamyolo_tpu.exp import get_exp as j_get_exp
from streamyolo_tpu.train import create_train_state as j_create_train_state
from streamyolo_tpu.train import make_train_step as j_make_train_step
from streamyolo_tpu.utils.torch_import import state_dict_to_variables
from streamyolo_torch.exp import get_exp
from streamyolo_torch.tools import eval as eval_tool
from streamyolo_torch.tools import train as train_tool
from streamyolo_torch.utils import checkpoint
from streamyolo_torch.utils.weights import jax_variables_to_state_dict

from .conftest import FAKE_H, FAKE_W
from .torch_port_helpers import lift_pred_biases, torch_threads, write_textured_argoverse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "cfgs", "s_s50_onex_dfp_tal_flip.py")
SEED, BATCH = 3, 2
# the raw frame size (letterbox r = 1): the smallest level is 2x3, so the
# train-mode BatchNorm there sees 12 values per channel (at 30x48 it sees 4,
# and the float32 noise it amplifies flips SimOTA's choice within 3 steps)
SIZE = (FAKE_H, FAKE_W)


@pytest.fixture(scope="module", autouse=True)
def few_threads_no_tensorboard():
    """Two intra-op threads; the trainer runs without TensorBoard (its
    optional writer; importing it loads TensorFlow where that is installed)."""
    import sys

    saved = sys.modules.get("torch.utils.tensorboard")
    sys.modules["torch.utils.tensorboard"] = None
    with torch_threads(2):
        yield
    if saved is None:
        sys.modules.pop("torch.utils.tensorboard", None)
    else:
        sys.modules["torch.utils.tensorboard"] = saved


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return write_textured_argoverse(tmp_path_factory.mktemp("trainer"), (4, 3))


def opts(root, out_dir, **extra):
    kv = {"depth": 0.33, "width": 0.25, "data_dir": root, "output_dir": str(out_dir),
          "input_size": SIZE, "test_size": SIZE, "random_size": None,
          "data_num_workers": 0, "max_epoch": 1, "no_aug_epochs": 1, "eval_interval": 1,
          "save_history_ckpt": False, "print_interval": 1, "seed": SEED, **extra}
    return [str(x) for k, v in kv.items() for x in (k, v)]


@pytest.fixture(scope="module")
def jax_init(tmp_path_factory):
    """JAX-initialised weights, as variables and as a ``.pth`` state dict;
    obj/cls prediction biases lifted to 0 so the eval has detections."""
    jexp = j_get_exp(CFG).merge(["depth", "0.33", "width", "0.25"])
    jmodel = jexp.get_model()
    variables = lift_pred_biases(jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k, x: jmodel.init(k, x, mode="off_pipe"))(
            jax.random.PRNGKey(2), jnp.zeros((1, 64, 96, 6), jnp.float32))))
    path = tmp_path_factory.mktemp("init") / "init.pth"
    torch.save(jax_variables_to_state_dict(variables), path)
    return jmodel, variables, str(path)


def run_cli(root, out_dir, *args, **extra):
    random.seed(SEED)
    np.random.seed(SEED)
    return train_tool.main(["-f", CFG, "-b", str(BATCH), "--device", "cpu", "-expn", "run",
                            *args, *opts(root, out_dir, **extra)])


@pytest.fixture(scope="module")
def trained(root, jax_init, tmp_path_factory):
    """A CLI run (``-c`` the JAX init) with every step's loss recorded."""
    from streamyolo_torch.train import step as step_mod

    losses, make = [], step_mod.make_train_step

    def recording(*args, **kwargs):
        fn = make(*args, **kwargs)

        def train_step(state, batch):
            metrics = fn(state, batch)
            losses.append(float(metrics["total_loss"]))
            return metrics
        return train_step

    step_mod.make_train_step = recording
    try:
        out = tmp_path_factory.mktemp("out")
        trainer = run_cli(root, out, "-c", jax_init[2])
    finally:
        step_mod.make_train_step = make
    trainer.losses = losses
    return trainer, out


def test_trainer_epoch_matches_jax_step(root, jax_init, trained):
    """The port's epoch against the JAX step over the JAX loader's batches
    of the same seed: per-step losses and the final EMA."""
    trainer, _ = trained
    jmodel, variables, _ = jax_init
    jexp = j_get_exp(CFG).merge(opts(root, "unused"))
    random.seed(SEED)
    np.random.seed(SEED)
    loader = jexp.get_data_loader(batch_size=BATCH, no_aug=True)
    iters = len(jexp.dataset) // BATCH
    assert trainer.max_iter == iters == 3 and trainer.state.step == 3
    assert [(size, ms) for size, ms, _ in trainer.step_log] == [(SIZE, None)] * 3
    sched = jexp.get_lr_schedule(BATCH, iters)
    jstate, tx = j_create_train_state(variables, sched)
    step = jax.jit(j_make_train_step(jmodel, tx, 8, sched, gamma=jexp.tal_gamma,
                                     ignore_thr=jexp.tal_ignore_thr,
                                     ignore_value=jexp.tal_ignore_value))
    losses = []
    for _, raw in zip(range(iters), loader):
        batch = {"images": jnp.asarray(raw[0]), "labels": jnp.asarray(raw[1][0]),
                 "support_labels": jnp.asarray(raw[1][1])}
        jstate, m = step(jstate, batch)
        losses.append(float(m["total_loss"]))
    assert trainer.meter["total_loss"]._count == iters
    np.testing.assert_allclose(trainer.losses, losses, rtol=1e-4)

    want = jax_variables_to_state_dict(jax.tree_util.tree_map(np.asarray, {
        "params": jstate.ema_params, "batch_stats": jstate.ema_batch_stats}))
    ema = trainer.state.ema.state
    for k, v in want.items():
        if not v.is_floating_point():
            continue
        rtol = 1e-5 if "running" in k else 0.0
        np.testing.assert_allclose(ema[k].numpy(), v.numpy(), atol=1e-5, rtol=rtol, err_msg=k)


def test_trainer_eval_matches_jax_evaluator(root, trained):
    """The trainer's evaluator on its EMA model against the JAX ONEX
    evaluator (dedup forward) on the same EMA weights."""
    trainer, _ = trained
    variables = state_dict_to_variables({k: v.numpy() for k, v in trainer.state.ema.state.items()})
    jexp = j_get_exp(CFG).merge(opts(root, "unused"))
    jmodel = jexp.get_model()
    jev = jexp.get_evaluator(batch_size=BATCH)
    (ap_j, ap50_j, _), rows_j = jev.evaluate(
        JSequentialDedupForward(jmodel, variables, jev.dataloader.dataset), return_outputs=True)
    exp = trainer.exp
    fwd = exp.get_dedup_forward_fn(trainer.eval_model, trainer.evaluator.dataset)
    (ap_t, ap50_t, _), rows_t = trainer.evaluator.evaluate(fwd, return_outputs=True)
    assert len(rows_t) == len(rows_j) > 0
    for t, j in zip(rows_t, rows_j):
        assert (t["image_id"], t["category_id"]) == (j["image_id"], j["category_id"])
        np.testing.assert_allclose(t["bbox"], j["bbox"], atol=1e-3, rtol=0)
        assert abs(t["score"] - j["score"]) <= 1e-5
    assert abs(100 * ap_t - 100 * ap_j) <= 0.1 and abs(100 * ap50_t - 100 * ap50_j) <= 0.1
    assert [e["epoch"] for e in trainer.eval_history] == [1]
    assert trainer.eval_history[-1]["ap"] == pytest.approx(ap_t)


def test_checkpoints_under_reference_names(trained):
    trainer, out = trained
    run_dir = out / "run"
    names = sorted(p.name for p in run_dir.iterdir() if p.suffix in (".pth", ".tmp"))
    want = ["last_epoch_ckpt.pth", "latest_ckpt.pth"]
    if trainer.best_ap > 0:
        want.insert(0, "best_ckpt.pth")
    assert names == want  # no temporary file left behind
    ckpt = checkpoint.load_checkpoint(str(run_dir / "latest_ckpt.pth"))
    assert ckpt["start_epoch"] == 1 and ckpt["step"] == 3 and ckpt["best_ap"] == trainer.best_ap
    for k, v in trainer.state.ema.state.items():  # `model` is the EMA the eval reads
        assert torch.equal(ckpt["model"][k], v) and torch.equal(ckpt["ema"][k], v)
    assert set(ckpt) >= {"train_model", "optimizer"}
    assert os.path.isfile(run_dir / "train_log.txt")


def test_checkpoint_write_is_atomic(tmp_path, monkeypatch):
    """A crash in the middle of a write leaves the previous file intact (and
    loadable); a truncated file raises with its path; a JAX pickle is
    refused before it is read."""
    state = {"start_epoch": 1, "model": {"w": torch.arange(4.0)}}
    checkpoint.save_checkpoint(state, True, str(tmp_path), "latest")
    real_save = torch.save

    def crash(obj, f):
        real_save(obj, f)
        with open(f, "r+b") as fh:
            fh.truncate(10)
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", crash)
    with pytest.raises(OSError, match="disk full"):
        checkpoint.save_checkpoint({"start_epoch": 2, "model": {}}, False, str(tmp_path), "latest")
    monkeypatch.setattr(torch, "save", real_save)
    assert checkpoint.load_checkpoint(str(tmp_path / "latest_ckpt.pth"))["start_epoch"] == 1
    assert torch.equal(checkpoint.load_checkpoint(str(tmp_path / "best_ckpt.pth"))["model"]["w"],
                       torch.arange(4.0))
    with pytest.raises(RuntimeError, match="latest_ckpt.pth.tmp"):
        checkpoint.load_checkpoint(str(tmp_path / "latest_ckpt.pth.tmp"))
    pkl = tmp_path / "latest_ckpt.pkl"
    pkl.write_bytes(b"never read")
    with pytest.raises(ValueError, match="export_safetensors"):
        checkpoint.load_checkpoint(str(pkl))


def resumed(root, out, **extra):
    args = train_tool.make_parser().parse_args(
        ["-f", CFG, "-b", str(BATCH), "--device", "cpu", "-expn", "run", "--resume",
         *opts(root, out, **extra)])
    exp = get_exp(CFG).merge(args.opts)
    trainer = exp.get_trainer(args)
    trainer.before_train()
    return trainer


def test_resume_restores_the_train_state(root, trained, tmp_path):
    trainer, run = trained
    out = tmp_path / "copy"  # the resumed run trains on and writes there
    shutil.copytree(run / "run", out / "run")
    saved = checkpoint.load_checkpoint(str(out / "run" / "latest_ckpt.pth"))
    t2 = resumed(root, out, max_epoch=2, no_aug_epochs=2)
    assert t2.start_epoch == 1 and t2.state.step == 3 and t2.best_ap == saved["best_ap"]
    for k, v in t2.model.state_dict().items():
        assert torch.equal(v, saved["train_model"][k]), k
    for k, v in t2.state.ema.state.items():
        assert torch.equal(v, saved["ema"][k]), k
    names = {id(p): n for n, p in t2.model.named_parameters()}
    want = {names[id(p)]: s["momentum_buffer"] for p, s in trainer.state.optimizer.state.items()
            for names in [{id(q): n for n, q in trainer.model.named_parameters()}]}
    got = {names[id(p)]: s["momentum_buffer"] for p, s in t2.state.optimizer.state.items()}
    assert got.keys() == want.keys() and len(got) > 100
    assert all(torch.equal(got[k], want[k]) for k in got)
    # the resumed run trains on: one more epoch, then its eval
    t2.train_in_epoch()
    assert t2.state.step == 6 and np.isfinite(float(t2._last_metrics["total_loss"]))


def test_resume_after_width_change_is_tolerant(root, trained, caplog):
    _, out = trained
    with caplog.at_level(logging.WARNING, logger="streamyolo_torch"):
        t3 = resumed(root, out, width=0.375)
    assert t3.start_epoch == 1 and t3.state.step == 3
    assert "mismatches the current config" in caplog.text
    assert t3.model.backbone.jian2.conv.weight.shape[0] == int(0.375 * 256) // 2


def test_cli_trains_and_eval_reads_its_checkpoint(root, jax_init, tmp_path):
    """The CLI end to end on the CPU (fp16 autocast included), then the
    port's eval CLI ``-c latest_ckpt.pth`` scores what the trainer's own
    eval scored on the same EMA weights."""
    trainer = run_cli(root, tmp_path, "-c", jax_init[2], "--fp16", "--no-dedup")
    assert trainer.exp.compute_dtype == "bfloat16"
    assert trainer.eval_model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
    trainer32 = run_cli(root, tmp_path, "-c", jax_init[2], "-expn", "run32")
    ckpt = str(tmp_path / "run32" / "latest_ckpt.pth")
    out = eval_tool.main(["-f", CFG, "-c", ckpt, "-b", str(BATCH), "--device", "cpu",
                          *opts(root, tmp_path)])
    assert out["ap"] == pytest.approx(trainer32.eval_history[-1]["ap"], abs=1e-6)
    assert out["ap50"] == pytest.approx(trainer32.eval_history[-1]["ap50"], abs=1e-6)
    assert len(out["rows"]) > 0


def test_cli_refusals(root, tmp_path):
    """A JAX ``.pkl`` checkpoint is refused with a pointer to
    ``export_safetensors``. What was refused until the augmentation path
    and the wandb sink were ported trains: ``-l wandb`` (wandb absent: the
    no-op sink), ``--cache`` and the mosaic branch (``no_aug_epochs`` 0 <
    ``max_epoch`` 2: YOLOX closes the mosaic before epoch ``max_epoch -
    no_aug_epochs``, 1-based, so ``no_aug_epochs`` 0 leaves epoch 1 on the
    mosaic), with the last mosaic epoch's checkpoint written before epoch 2."""
    data = tmp_path / "data"
    shutil.copytree(root, data)  # the cache is written under data_dir
    trainer = run_cli(str(data), tmp_path, "-l", "wandb", "--cache", max_epoch=2,
                      no_aug_epochs=0, eval_interval=2)
    assert trainer.wandb_logger is not None and trainer.tb_writer is None
    assert trainer.state.step == 2 * trainer.iters_per_epoch and len(trainer.eval_history) == 1
    assert np.isfinite(float(trainer._last_metrics["total_loss"]))
    assert (data / "img_resized_cache_train.array").is_file()
    assert torch.load(tmp_path / "run" / "last_mosaic_epoch_ckpt.pth")["start_epoch"] == 2
    assert trainer.no_aug and not trainer.train_loader.dataset.enable_mosaic
    pkl = tmp_path / "latest_ckpt.pkl"
    pkl.write_bytes(b"never read")
    for args in (["-c", str(pkl)], ["--resume", "-c", str(pkl)]):
        with pytest.raises(ValueError, match="export_safetensors"):
            run_cli(root, tmp_path, *args)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_tool.main(["-f", CFG, *opts(root, tmp_path)])  # the card by default
    args = argparse.Namespace(experiment_name="x", device="cpu")
    assert get_exp(CFG).merge(opts(root, tmp_path)).get_trainer(args).device.type == "cpu"
