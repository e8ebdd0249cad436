"""One rank of the port's data-parallel tests (tests/test_torch_distributed.py).
Imports torch and the port, never JAX.

    python tests/_torch_dist_child.py cases RANK WORLD PORT WORKDIR
    python tests/_torch_dist_child.py world1 PORT WORKDIR
    python tests/_torch_dist_child.py cli OUT -- TRAIN_ARGV...
    python tests/_torch_dist_child.py cli-fail OUT -- TRAIN_ARGV...
    python tests/_torch_dist_child.py alone PORT TIMEOUT_S

``cases`` joins a gloo group at ``tcp://127.0.0.1:PORT`` and runs, on the
inputs the parent wrote to WORKDIR: BatchNorm2d in float32 and float64
on the rank's slice of ``bn.npz`` (forward, backward of ``sum(y * dy)``, the weight / bias
gradients summed over the ranks), one train step from ``carried.pth`` on
the rank's slice of ``batch.npz``, and the sharded ONEX eval (a fixed
one-box forward on ``eval.json``'s ``fake`` dataset, then the model of
``eval_weights.pth`` on its ``textured`` one). ``world1`` runs the train
step on the whole batch with no group and then in a gloo group of one.
``cli`` runs ``streamyolo_torch.tools.train.main`` and saves the trainer's
state; ``cli-fail`` runs it with frames that fail on rank 1. ``alone``
joins a group of two that nobody else joins. Results go to
``WORKDIR/rank{r}_*`` (``OUT`` for ``cli``).
"""

import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "cfgs", "s_s50_onex_dfp_tal_flip.py")
SMALL = ["depth", "0.33", "width", "0.25"]
NCLS = 8
# the LR schedule of the step: the shipped yoloxwarmcos at the global batch 4
SCHED = dict(lr=0.001 / 64 * 4, iters_per_epoch=2, max_epoch=3, warmup_epochs=1,
             no_aug_epochs=3)


class FailOnRank:
    """A ``load_frame`` (picklable, for spawned workers) whose frames fail
    on rank ``rank`` and are flat grey elsewhere."""

    def __init__(self, rank: int):
        self.rank = rank

    def __call__(self, img):
        from streamyolo_torch.parallel import get_rank

        if get_rank() == self.rank:
            raise RuntimeError(f"the frames of rank {self.rank} fail")
        return np.full((img["height"], img["width"], 3), 100, np.uint8)


def train_state_of(state):
    """The state a step updates, as CPU tensors by name."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    return {"model": {k: v.detach().clone() for k, v in state.model.state_dict().items()},
            "ema": {k: v.clone() for k, v in state.ema.state.items()},
            "momentum": {names[id(p)]: s["momentum_buffer"].clone()
                         for p, s in state.optimizer.state.items()},
            "step": state.step}


def run_step(workdir, rank, world):
    """One train step from the carried state on the rank's slice of the
    global batch; returns the new state and the metrics."""
    from streamyolo_torch.exp import get_exp
    from streamyolo_torch.parallel import shard_batch
    from streamyolo_torch.train import (
        build_lr_schedule,
        create_train_state,
        load_carried_state,
        make_train_step,
    )

    exp = get_exp(CFG).merge(SMALL)
    model = exp.get_model("cpu", dtype=torch.float32)
    state = create_train_state(model)
    load_carried_state(state, torch.load(os.path.join(workdir, "carried.pth")))
    with np.load(os.path.join(workdir, "batch.npz")) as f:
        batch = {k: torch.from_numpy(f[k]) for k in f.files}
    step = make_train_step(NCLS, build_lr_schedule("yoloxwarmcos", **SCHED))
    metrics = step(state, shard_batch(batch, rank, world))
    return train_state_of(state), {k: float(v) for k, v in metrics.items()}


def run_bn(workdir, rank, world, dtype):
    """BatchNorm2d in training, in ``dtype``, on the rank's slice; the
    weight and bias gradients summed over the ranks (as the step's
    all-reduce sums them)."""
    from streamyolo_torch.nn.blocks import BN_EPS, BN_MOMENTUM, BatchNorm2d
    from streamyolo_torch.parallel import all_reduce_sum_, local_batch_size

    with np.load(os.path.join(workdir, "bn.npz")) as f:
        arrays = {k: torch.from_numpy(f[k]).to(dtype) for k in f.files}
    n = local_batch_size(arrays["x"].shape[0], world)
    bn = BatchNorm2d(arrays["x"].shape[1], eps=BN_EPS, momentum=BN_MOMENTUM).to(dtype)
    with torch.no_grad():
        for k in ("weight", "bias", "running_mean", "running_var"):
            getattr(bn, k).copy_(arrays[k])
    bn.train()
    x = arrays["x"][rank * n:(rank + 1) * n].clone().requires_grad_(True)
    y = bn(x)
    (y * arrays["dy"][rank * n:(rank + 1) * n]).sum().backward()
    grads = torch.stack([bn.weight.grad, bn.bias.grad])
    all_reduce_sum_(grads)
    return {"y": y.detach(), "dx": x.grad, "dweight": grads[0], "dbias": grads[1],
            "running_mean": bn.running_mean.clone(), "running_var": bn.running_var.clone(),
            "num_batches_tracked": bn.num_batches_tracked.clone()}


def run_eval(workdir, rank):
    """The sharded ONEX eval: a fixed one-box forward on the flat fixture,
    then the model on the textured one."""
    from streamyolo_torch.data import (
        DataLoader,
        DoubleValTransform,
        ONE_ARGOVERSEDataset,
        ShardDataset,
    )
    from streamyolo_torch.eval import ONEX_COCOEvaluator
    from streamyolo_torch.exp import get_exp
    from streamyolo_torch.parallel import get_world_size

    with open(os.path.join(workdir, "eval.json")) as f:
        spec = json.load(f)
    ds = ONE_ARGOVERSEDataset(spec["fake"], "val.json", name="val", img_size=(30, 48),
                              preproc=DoubleValTransform())
    shard = ShardDataset(ds, rank, get_world_size())
    evaluator = ONEX_COCOEvaluator(DataLoader(shard, batch_size=2, num_workers=0,
                                              shuffle=False),
                                   img_size=(30, 48), confthre=0.3, nmsthre=0.5,
                                   num_classes=NCLS)

    def forward(images):
        # one high-confidence class-2 box per image: each surviving input
        # gives one COCO row under image_id + 1
        preds = torch.zeros((images.shape[0], 8, 5 + NCLS))
        preds[:, 0, :4] = torch.tensor([10.0, 22.0, 8.0, 6.0])
        preds[:, 0, 4] = 1.0
        preds[:, 0, 5 + 2] = 1.0
        return preds

    (_, ap50, info), rows = evaluator.evaluate(forward, return_outputs=True)
    out = {"n_local_images": len(shard), "image_ids": sorted(d["image_id"] for d in rows),
           "is_main_output": info is not None, "ap50": ap50}

    exp = get_exp(CFG).merge(SMALL + ["data_dir", spec["textured"], "test_size", "(60, 96)",
                                      "data_num_workers", "0"])
    model = exp.get_model("cpu")
    model.load_state_dict(torch.load(os.path.join(workdir, "eval_weights.pth")))
    evaluator = exp.get_evaluator(batch_size=2, is_distributed=True)
    (ap, ap50, info), rows = evaluator.evaluate(exp.get_forward_fn(model), return_outputs=True)
    out["model"] = {"ap": float(ap), "ap50": float(ap50), "rows": rows,
                    "n_local_images": len(evaluator.dataloader.dataset),
                    "times_ms": evaluator.last_times_ms, "is_main_output": info is not None}
    return out


def main(argv):
    torch.set_num_threads(1)
    mode = argv[0]
    from streamyolo_torch import parallel

    if mode == "cases":
        rank, world, port, workdir = int(argv[1]), int(argv[2]), argv[3], argv[4]
        parallel.init_distributed("gloo", f"tcp://127.0.0.1:{port}", world, rank,
                                  device="cpu", timeout_s=120)
        try:
            torch.save({str(dt).removeprefix("torch."): run_bn(workdir, rank, world, dt)
                        for dt in (torch.float32, torch.float64)},
                       os.path.join(workdir, f"rank{rank}_bn.pth"))
            state, metrics = run_step(workdir, rank, world)
            torch.save(state, os.path.join(workdir, f"rank{rank}_step.pth"))
            with open(os.path.join(workdir, f"rank{rank}_step.json"), "w") as f:
                json.dump(metrics, f)
            with open(os.path.join(workdir, f"rank{rank}_eval.json"), "w") as f:
                json.dump(run_eval(workdir, rank), f)
        finally:
            parallel.destroy()
    elif mode == "world1":
        port, workdir = argv[1], argv[2]
        plain = run_step(workdir, 0, 1)
        parallel.init_distributed("gloo", f"tcp://127.0.0.1:{port}", 1, 0, device="cpu",
                                  timeout_s=120)
        try:
            assert parallel.get_world_size() == 1
            grouped = run_step(workdir, 0, 1)
        finally:
            parallel.destroy()
        torch.save({"plain": plain, "grouped": grouped}, os.path.join(workdir, "world1.pth"))
    elif mode in ("cli", "cli-fail"):
        from streamyolo_torch.tools import train as train_tool
        from tests._torch_dist_child import FailOnRank  # pickled by this name

        out, train_argv = argv[1], argv[argv.index("--") + 1:]
        trainer = train_tool.main(train_argv, load_frame=FailOnRank(1) if mode == "cli-fail"
                                  else None)
        torch.save({"state": train_state_of(trainer.state),
                    "eval_history": trainer.eval_history}, out)
    elif mode == "alone":
        port, timeout_s = argv[1], float(argv[2])
        parallel.init_distributed("gloo", f"tcp://127.0.0.1:{port}", 2, 0, device="cpu",
                                  timeout_s=timeout_s)
        raise SystemExit("the group formed with one of two ranks")
    else:
        raise SystemExit(f"unknown mode {mode}")


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main(sys.argv[1:])
