"""The training loop, the counterpart of ``streamyolo_tpu/train/trainer.py``:
epochs of ``max_iter`` steps, multiscale every 10 steps, the EMA eval after
each epoch, checkpoints, meters.

  * The model trains in float32 (master weights) on ``args.device``
    (``cuda`` unless given); ``--fp16`` runs the forward under bf16
    autocast (``train/step.py``).
  * Batches come through ``DevicePrefetcher``; an exhausted prefetcher is
    restarted on a fresh loader iterator (its ``__init__`` is re-entrant).
  * The size of step s is ``exp.random_resize(s // 10, epoch)``; a batch of
    another size is resized on the card by ``exp.preprocess``.
  * After each epoch the EMA weights (``exp.ema``) are loaded into a
    separate eval model built by ``exp.get_model`` (bf16 modules under
    ``--fp16``, as ``tools/eval.py`` builds them) and evaluated through
    the sequential-dedup forward for ONE / TWO configs (its first-batch
    guard armed every epoch; ``--no-dedup`` for the dual-frame forward).
  * Checkpoints (``utils/checkpoint.py``): ``latest`` after every epoch,
    ``last_epoch`` after each eval, ``best_ckpt`` on a better AP, and
    ``epoch_N`` when ``save_history_ckpt``. ``--resume`` restores the model,
    the optimizer, the EMA, the step, the epoch and ``best_ap``; ``-c``
    alone is a shape-tolerant fine-tune.
  * ``step_log`` keeps (size, device ms, data wait ms) per step: the device
    time from CUDA events around the step on a card (read at the print
    interval and at the end of an epoch; None on the CPU), the data wait
    from the host clock around ``prefetcher.next()``.
  * Data parallel (``parallel/``; ``tools/train.py`` brings the process
    group up, one rank per card): every rank loads its slice of the global
    batch and steps (``train/step.py``); the ranks must start from the same
    state (checked once by a hash); the multiscale size, a function of
    seed and step, is checked equal on every rank when it is drawn; the
    per-epoch eval is sharded and gathered, through the dual-frame forward
    (the dedup forward needs the unsharded traversal); only rank 0 writes
    the log file, TensorBoard and checkpoints, and decides the best
    checkpoint from its AP. ``--resume`` reads the checkpoint on every
    rank.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from streamyolo_torch.parallel import (
    check_same_on_ranks,
    get_rank,
    get_world_size,
    is_main_process,
    tensors_digest,
)
from streamyolo_torch.utils.logger import get_logger, setup_logger
from streamyolo_torch.utils.meters import MeterBuffer, device_mem_usage_mb


class Trainer:
    def __init__(self, exp, args):
        from streamyolo_torch.utils.device import resolve_device

        self.exp = exp
        self.args = args
        self.max_epoch = exp.max_epoch
        self.input_size = tuple(exp.input_size)
        self.best_ap = 0.0
        self.start_epoch = 0
        self.device = resolve_device(getattr(args, "device", "cuda"))
        self.fp16 = bool(getattr(args, "fp16", False))
        # frames supplied by a callable (image dict -> BGR uint8) instead of
        # read from data_dir, for both the train and the val split
        self.load_frame = getattr(args, "load_frame", None)
        self.meter = MeterBuffer(window_size=exp.print_interval)
        self.file_name = os.path.join(exp.output_dir, args.experiment_name)
        self.world = get_world_size()
        self.is_main = is_main_process()
        if self.is_main:
            os.makedirs(self.file_name, exist_ok=True)
        setup_logger(self.file_name, distributed_rank=get_rank(), filename="train_log.txt")
        self.logger = get_logger()
        self.use_tal = exp.head_name == "tal"
        self.tb_writer = None
        self.wandb_logger = None
        self.step_log: List[Tuple[Tuple[int, int], Optional[float], float]] = []
        self._pending: List[Any] = []
        self._last_metrics: Dict[str, Any] = {}
        self.eval_history: List[Dict[str, Any]] = []  # one entry per eval

    # ------------------------------------------------------------------ setup

    def before_train(self):
        from streamyolo_torch.train.step import create_train_state, make_train_step

        exp, args = self.exp, self.args
        self.logger.info(f"args: {args}")
        self.logger.info(f"exp value:\n{exp}")
        backend = getattr(args, "logger", "tensorboard")
        if backend not in ("tensorboard", "wandb"):
            raise ValueError("logger must be either 'tensorboard' or 'wandb'")
        if self.fp16:
            exp.compute_dtype = "bfloat16"  # the eval model's modules

        state_dict = self.resume_train()
        self.model = exp.get_model(self.device, dtype=torch.float32)
        self.model.load_state_dict(state_dict)

        self.no_aug = self.start_epoch >= self.max_epoch - exp.no_aug_epochs
        self.train_loader = exp.get_data_loader(
            batch_size=args.batch_size, no_aug=self.no_aug,
            cache_img=getattr(args, "cache", False), load_frame=self.load_frame)
        self.iters_per_epoch = max(len(exp.dataset) // args.batch_size, 1)
        self.max_iter = self.iters_per_epoch

        self.lr_schedule = exp.get_lr_schedule(args.batch_size, self.iters_per_epoch)
        self.state = create_train_state(self.model, momentum=exp.momentum,
                                        weight_decay=exp.weight_decay)
        if self._resume_state is not None:
            self._restore_state(self._resume_state)
        self.train_step = make_train_step(
            exp.num_classes, self.lr_schedule, gamma=getattr(exp, "tal_gamma", 1.0),
            ignore_thr=getattr(exp, "tal_ignore_thr", 0.5),
            ignore_value=getattr(exp, "tal_ignore_value", 1.5),
            use_l1=True, use_tal=self.use_tal, fp16=self.fp16)

        self.eval_model = exp.get_model(self.device)
        self.evaluator = exp.get_evaluator(
            batch_size=getattr(args, "eval_batch_size", args.batch_size),
            load_frame=self.load_frame)
        if self.world > 1:
            check_same_on_ranks(tensors_digest(self._state_tensors()),
                                "the train state at the start")
        if self.is_main and backend == "tensorboard":
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb_writer = SummaryWriter(self.file_name)
            except Exception:  # tensorboard is optional, as in the JAX trainer
                self.tb_writer = None
        elif self.is_main:
            from streamyolo_torch.utils.wandb_logger import WandbLogger

            self.wandb_logger = WandbLogger.initialize_wandb_logger(args, exp)
        self.logger.info("Training starts...")

    def _state_tensors(self) -> List[torch.Tensor]:
        """The weights and BatchNorm statistics, the EMA, the momentum
        buffers, in a fixed order."""
        state = self.state
        momentum = [state.optimizer.state[p].get("momentum_buffer")
                    for p in self.model.parameters()]
        return (list(self.model.state_dict().values()) + list(state.ema.state.values())
                + [m for m in momentum if m is not None])

    def resume_train(self) -> Dict[str, torch.Tensor]:
        """The float32 state dict to train from: the config's seeded init,
        with ``--resume`` reading ``best_ap``, the epoch and the train state
        of a checkpoint (restored after the optimizer exists), or ``-c``
        alone merging its ``model`` weights shape-tolerantly (a fine-tune).
        The checkpoint is read, or refused, before anything is built."""
        from streamyolo_torch.utils.checkpoint import load_checkpoint, load_ckpt_tolerant

        args = self.args
        self._resume_state = None
        if getattr(args, "resume", False):
            ckpt_file = args.ckpt or os.path.join(self.file_name, "latest_ckpt.pth")
            ckpt = load_checkpoint(ckpt_file)
            self.best_ap = ckpt.get("best_ap", 0.0)
            start_epoch = getattr(args, "start_epoch", None)
            self.start_epoch = start_epoch - 1 if start_epoch else ckpt.get("start_epoch", 0)
            state_dict = self.exp.init_model()
            if "train_model" in ckpt:
                self._resume_state = ckpt
            else:
                state_dict = load_ckpt_tolerant(state_dict, ckpt["model"])
            self.logger.info(f"Resumed from {ckpt_file} at epoch {self.start_epoch}")
            return state_dict
        if getattr(args, "ckpt", None):
            ckpt = load_checkpoint(args.ckpt)
            self.logger.info(f"Fine-tuning from {args.ckpt}")
            return load_ckpt_tolerant(self.exp.init_model(), ckpt["model"])
        return self.exp.init_model()

    def _restore_state(self, saved: Dict[str, Any]) -> None:
        """Shape-tolerant restore of the train state: entries present in the
        checkpoint with the current shapes are taken (model, EMA, momentum
        buffers, step); the rest keep their fresh values, with one warning
        naming them (a raw load would crash on any config change between
        save and resume)."""
        state = self.state
        skipped, total = [], 0

        def merge(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor], prefix: str):
            nonlocal total
            for k, v in dst.items():
                total += 1
                s = src.get(k)
                if s is not None and tuple(s.shape) == tuple(v.shape):
                    v.copy_(s)
                else:
                    skipped.append(prefix + k)

        with torch.no_grad():
            merge(self.model.state_dict(), saved["train_model"], "model.")
            merge(state.ema.state, saved["ema"], "ema.")
        names = {id(p): n for n, p in self.model.named_parameters()}
        params = [p for g in state.optimizer.param_groups for p in g["params"]]
        opt = saved["optimizer"]
        saved_params = [i for g in opt["param_groups"] for i in g["params"]]
        for i, p in enumerate(params):
            total += 1
            buf = (opt["state"].get(saved_params[i], {}).get("momentum_buffer")
                   if len(saved_params) == len(params) else None)
            if buf is not None and tuple(buf.shape) == tuple(p.shape):
                state.optimizer.state[p]["momentum_buffer"] = buf.to(p.device, p.dtype).clone()
            else:
                skipped.append("momentum." + names[id(p)])
        total += 1
        state.step = int(saved.get("step", 0))
        if skipped:
            self.logger.warning(
                "Resume: checkpoint train state mismatches the current config for %d of %d "
                "leaves (kept init values): %s%s", len(skipped), total,
                ", ".join(skipped[:5]), ", ..." if len(skipped) > 5 else "")

    # ------------------------------------------------------------------ loop

    def train(self):
        self.before_train()
        try:
            self.train_in_epoch()
        finally:
            self.after_train()

    def train_in_epoch(self):
        from streamyolo_torch.data.loader import DevicePrefetcher

        for self.epoch in range(self.start_epoch, self.max_epoch):
            self.before_epoch()
            prefetcher = DevicePrefetcher(self.train_loader, self.device)
            try:
                for self.iter in range(self.max_iter):
                    self.train_one_iter(prefetcher)
            finally:
                prefetcher.close()
            self._collect_step_times()
            self.after_epoch()

    def before_epoch(self):
        exp = self.exp
        self.logger.info(f"---> start train epoch {self.epoch + 1}")
        if self.epoch + 1 == self.max_epoch - exp.no_aug_epochs and not self.no_aug:
            # the mosaic-off transition (a no-op with the shipped configs)
            self.logger.info("--->No mosaic aug now!")
            self.no_aug = True
            self.train_loader = exp.get_data_loader(
                batch_size=self.args.batch_size, no_aug=True, load_frame=self.load_frame)
            self.save_ckpt(ckpt_name="last_mosaic_epoch")

    def train_one_iter(self, prefetcher):
        iter_start = time.perf_counter()
        batch = prefetcher.next()
        if batch is None:
            prefetcher.__init__(self.train_loader, self.device)
            batch = prefetcher.next()
        data_end = time.perf_counter()

        step_idx = self.epoch * self.iters_per_epoch + self.iter
        tsize = tuple(self._current_size(step_idx))
        if self.world > 1 and step_idx % 10 == 0 and self.exp.random_size is not None:
            check_same_on_ranks(tsize, f"the multiscale size of step {step_idx}")
        if tsize != self.input_size:
            batch = self._resize_batch(batch, tsize)

        data_ms = 1e3 * (data_end - iter_start)
        if self.device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            metrics = self.train_step(self.state, batch)
            end.record()
            self._pending.append((tsize, (start, end), data_ms))
        else:
            metrics = self.train_step(self.state, batch)
            self._pending.append((tsize, None, data_ms))
        iter_end = time.perf_counter()
        self.meter.update(iter_time=iter_end - iter_start, data_time=data_end - iter_start)
        self._last_metrics = metrics

        if (self.iter + 1) % self.exp.print_interval == 0:
            self._collect_step_times()
            metrics_host = {k: float(v) for k, v in metrics.items()}
            self.meter.update(**{k: v for k, v in metrics_host.items() if k != "lr"})
            self._log_progress(metrics_host["lr"], tsize)

    def _collect_step_times(self):
        """Move the steps since the last read into ``step_log`` (reading their
        CUDA events)."""
        for tsize, events, data_ms in self._pending:
            device_ms = None
            if events is not None:
                events[1].synchronize()
                device_ms = events[0].elapsed_time(events[1])
                self.meter.update(step_time=device_ms / 1e3)
            self.step_log.append((tsize, device_ms, data_ms))
        self._pending = []

    def _current_size(self, step_idx: int):
        """The multiscale size of this step, re-drawn every 10 steps."""
        if self.exp.random_size is None:
            return self.input_size
        return self.exp.random_resize(step_idx // 10, self.epoch)

    def _resize_batch(self, batch: Dict[str, torch.Tensor], tsize):
        targets = (batch["labels"],) + (
            (batch["support_labels"],) if "support_labels" in batch else ())
        images, targets = self.exp.preprocess(batch["images"], targets, tsize)
        out = {"images": images, "labels": targets[0]}
        if len(targets) > 1:
            out["support_labels"] = targets[1]
        return out

    def _log_progress(self, lr: float, tsize):
        left_iter = self.max_iter - (self.iter + 1)
        left_epochs = self.max_epoch - (self.epoch + 1)
        eta_seconds = self.meter["iter_time"].global_avg * (left_iter + left_epochs * self.max_iter)
        eta = datetime.timedelta(seconds=int(eta_seconds))
        loss_meter = self.meter.get_filtered_meter("loss")
        loss_str = ", ".join(f"{k}: {v.latest:.1f}" for k, v in loss_meter.items())
        time_meter = self.meter.get_filtered_meter("time")
        time_str = ", ".join(f"{k}: {v.avg:.3f}s" for k, v in time_meter.items())
        self.logger.info(
            f"epoch: {self.epoch + 1}/{self.max_epoch}, iter: {self.iter + 1}/{self.max_iter}, "
            f"mem: {device_mem_usage_mb():.0f}MB, {time_str}, {loss_str}, "
            f"lr: {lr:.3e}, size: {tsize}, ETA: {eta}")
        if self.tb_writer is not None:
            step = self.epoch * self.max_iter + self.iter
            for k, v in loss_meter.items():
                self.tb_writer.add_scalar(f"train/{k}", v.latest, step)
            self.tb_writer.add_scalar("train/lr", lr, step)
        if self.wandb_logger is not None:
            self.wandb_logger.log_metrics({k: v.latest for k, v in loss_meter.items()})
            self.wandb_logger.log_metrics({"lr": lr})

    # ------------------------------------------------------------------ epoch end

    def after_epoch(self):
        self.save_ckpt(ckpt_name="latest")
        if (self.epoch + 1) % self.exp.eval_interval == 0:
            self.evaluate_and_save_model()

    def eval_weights(self) -> Dict[str, torch.Tensor]:
        """The weights that are evaluated and saved as ``model``: the EMA's
        when ``exp.ema``, else the training model's."""
        return self.state.ema.state if self.exp.ema else self.model.state_dict()

    def evaluate_and_save_model(self):
        exp = self.exp
        self.eval_model.load_state_dict(self.eval_weights())
        if (not getattr(self.args, "no_dedup", False) and self.world == 1
                and exp.evaluator_name in ("onex", "twox")):
            forward_fn = exp.get_dedup_forward_fn(self.eval_model, self.evaluator.dataset)
        else:
            forward_fn = exp.get_forward_fn(self.eval_model)
        # off rank 0 the gathered eval returns (0.0, 0.0, None)
        ap, ap50, summary = exp.eval(forward_fn, self.evaluator)
        self.eval_history.append({"epoch": self.epoch + 1, "ap": ap, "ap50": ap50,
                                  "ms_per_image": dict(self.evaluator.last_times_ms)})
        if summary is not None:
            self.logger.info(f"\n{summary}")
        if self.tb_writer is not None:
            self.tb_writer.add_scalar("val/COCOAP50", ap50, self.epoch + 1)
            self.tb_writer.add_scalar("val/COCOAP50_95", ap, self.epoch + 1)
        if self.wandb_logger is not None:
            self.wandb_logger.log_metrics({"val/COCOAP50": ap50, "val/COCOAP50_95": ap,
                                           "train/epoch": self.epoch + 1})
        update_best_ckpt = ap > self.best_ap
        self.best_ap = max(self.best_ap, ap)
        self.save_ckpt("last_epoch", update_best_ckpt)
        if exp.save_history_ckpt:
            self.save_ckpt(f"epoch_{self.epoch + 1}")

    def save_ckpt(self, ckpt_name: str, update_best_ckpt: bool = False):
        """Rank 0 writes; the state is the same on every rank."""
        from streamyolo_torch.utils.checkpoint import save_checkpoint

        if not self.is_main:
            return
        state = {
            "start_epoch": self.epoch + 1,
            "model": self.eval_weights(),
            "best_ap": self.best_ap,
            "train_model": self.model.state_dict(),
            "optimizer": self.state.optimizer.state_dict(),
            "ema": self.state.ema.state,
            "step": self.state.step,
        }
        self.logger.info(f"Save weights to {self.file_name} ({ckpt_name})")
        save_checkpoint(state, update_best_ckpt, self.file_name, ckpt_name)
        if self.wandb_logger is not None:
            self.wandb_logger.save_checkpoint(self.file_name, ckpt_name, update_best_ckpt)

    def after_train(self):
        self.logger.info(f"Training done, best AP: {self.best_ap * 100:.2f}")
        if self.tb_writer is not None:
            self.tb_writer.close()
        if self.wandb_logger is not None:
            self.wandb_logger.finish()
