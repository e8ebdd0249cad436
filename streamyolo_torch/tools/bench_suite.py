"""Supplementary benchmark suite on one NVIDIA GPU: the counterpart of
``tools/bench_suite.py``.

    python -m streamyolo_torch.tools.bench_suite {stream_fp32,stream_int8,stream_sweep,serve8,
        eval_fwd,eval_dedup,train_s,train_parts,all} [--batch N] [--batches 1,2,4,8,16,32]
        [--samples 8] [--steps N] [--int8] [--remat] [--depth D --width W] [--input H W]
        [--device cpu]

``tools/bench.py`` is the headline (one streaming step); this suite measures
every other row the same way: each sample is ``--steps`` calls and one
synchronize, the minimum over ``--samples`` samples is the value and the
median sits beside it. Cells:

* ``stream_fp32`` / ``serve8``: ``bench.py``'s chained step of StreamYOLO-l
  at 600x960, float32 at batch 1 / bf16 at batch 8; a batch above 1 is
  ``MultiStreamDetector.step`` (one step for N streams).
* ``stream_int8``: the same in bf16 after ``quant/ptq.py::
  quantize_for_serving`` with the JAX tool's synthetic calibration (one
  ``RandomState(1)`` 600x960x6 batch; the weights stripped): every CBS conv
  runs the int8 kernel.
* ``stream_sweep``: the bf16 (``--int8``: int8) step at each of
  ``--batches`` streams, and the 30 FPS capacity: the largest measured N
  whose step fits a 33.3 ms frame period.
* ``eval_fwd``: the offline dual-frame forward (``off_pipe`` on [B, 600,
  960, 6] uint8 from the host, ``StreamExp.get_forward_fn``) + NMS at K =
  1000 (kernel B1), B = 8, bf16 (``--int8``: quantized), cuDNN off as the
  eval runs it (``eval/seq_forward.py::per_image_convolution``).
* ``eval_dedup``: ``eval/seq_forward.py::SequentialDedupForward`` over one
  long sequence (support shift 1) + NMS at K = 1000, B = 8, cuDNN off.
* ``train_s``: ``train_sweep.py``'s full train step, StreamYOLO-s at
  600x960, batch 16, bf16 autocast (``--steps`` default 5, the JAX tool's R).
* ``train_parts``: the same step's forward, SimOTA assignment + loss,
  backward, SGD and EMA, each timed with CUDA events around it (as
  ``profile_train_step.py``).
* ``--remat`` (``train_s``, ``train_parts``): the rematerialised step
  (``make_train_step(remat=True)``), cells named with the JAX tool's
  ``_remat`` suffix. Its backward runs the forward again before its
  gradients, so ``train_parts``' ``backward`` holds the recomputed forward,
  and the work counted is the work the card executes: the backward 3x the
  forward's convolutions, the step 4x (what the JAX tool's XLA cost
  analysis counts of its ``jax.checkpoint`` step).
* ``all``: ``stream_fp32``, ``serve8``, ``eval_fwd``, ``eval_dedup``,
  ``train_s``.

Each cell reports ``ms_per_step`` (a batch of the eval, a train step),
``frames_per_sec`` or ``imgs_per_sec``, ``tflops``, ``gbytes``, ``mfu`` and
``hbm_share`` (``measure.py``: the convolutions counted from the model's
shapes against the card's data-sheet peaks; the train step 3x its forward,
4x under ``--remat``, SGD and EMA by the bytes of the tensors they read and
write). All cells go in one JSON dict on the last line, with ``device``
(the card's name and ``nvidia-smi`` power limit). ``--depth`` / ``--width`` set the model of
every cell (default StreamYOLO-l, and -s for the train cells); ``--input``
the frame size.

The JAX tool's ``--no-packed`` has no counterpart: the phase-packed
layouts are TPU lane layouts the port does not have (it runs the raw
layout, the JAX tool's ``_raw`` cells). Runs on ``cuda``; raises without a
card unless ``--device cpu``, where the same cells run at the size given
and every time, rate and share is null.
"""

from __future__ import annotations

import argparse
import json
import sys
import types
from typing import Optional, Sequence

import numpy as np
import torch

from streamyolo_torch.tools import bench, train_sweep
from streamyolo_torch.tools.measure import (card, count_work, meta_like, on_meta, roofline,
                                            scale_work, stats_ms, sync, tensor_bytes,
                                            time_samples)
from streamyolo_torch.utils.device import resolve_device

STREAM_STEPS = 50  # bench.py's K x R steps per sample
TRAIN_STEPS = 5  # the JAX tool's R train steps per sample
EVAL_TOPK = 1000  # postprocess_fixed's default, the evaluators' K
DEADLINE_MS = 1000.0 / 30.0
TRAIN_PARTS = ("forward", "assign_loss", "backward", "sgd", "ema")


def stream_model(dtype_name: str, device: torch.device, depth: float, width: float, size):
    """StreamYOLO at ``depth`` / ``width`` with ``bench.py``'s weights:
    ``fp32`` / ``bf16`` modules, or ``int8`` (calibrated in float32 on one
    ``RandomState(1)`` 6-channel batch at ``size``, quantized, stripped,
    bf16 modules)."""
    from streamyolo_torch.quant import quantize_for_serving

    exp = bench.seeded_exp(bench.CONFIG, depth, width)
    if dtype_name == "fp32":
        return bench.serving_model(exp, torch.float32, device)
    if dtype_name == "bf16":
        return bench.serving_model(exp, torch.bfloat16, device)
    state = bench.lifted_state(exp)
    m32 = bench.serving_model(exp, torch.float32, device, state)
    calib = [np.random.RandomState(1).randint(0, 255, (1, *size, 6)).astype(np.uint8)]
    q = quantize_for_serving(m32, state, calib, strip=True)
    del m32
    return bench.serving_model(exp, torch.bfloat16, device, q)


def stream_detector(model, batch: int, use_bf16: bool, size, device: torch.device):
    from streamyolo_torch.stream import CUDAStreamDetector, MultiStreamDetector

    kw = dict(input_size=size, conf_thre=bench.CONF_THRE, nms_thre=bench.NMS_THRE,
              num_classes=bench.NUM_CLASSES, pre_nms_topk=bench.PRE_NMS_TOPK,
              use_bf16=use_bf16, device=device)
    if batch == 1:
        return CUDAStreamDetector(model, **kw)
    return MultiStreamDetector(model, batch, **kw)


def cell(stats: dict, work: Optional[dict], device: torch.device, per_step: int,
         rate_key: str) -> dict:
    """A cell's entry: ms per step (min, median, max), ``rate_key`` (per
    step items per second, from the min) and ``roofline``'s keys."""
    ms = stats["min_ms"]
    entry = {"ms_per_step": ms, "median_ms_per_step": stats["median_ms"],
             "max_ms_per_step": stats["max_ms"],
             rate_key: per_step * 1e3 / ms if ms else None}
    if work is None:  # nothing counted in this part
        entry.update(tflops=None, gbytes=None, mfu=None, hbm_share=None)
    else:
        entry.update(roofline(work, ms / 1e3 if ms else None, device))
    return entry


def bench_stream(dtype_name: str, batch: int, args, device: torch.device) -> dict:
    """``bench.py``'s chained step at ``batch`` streams in ``dtype_name``
    (``fp32``, ``bf16`` or ``int8``)."""
    size = tuple(args.input)
    model = stream_model(dtype_name, device, args.depth or 1.0, args.width or 1.0, size)
    det = stream_detector(model, batch, dtype_name != "fp32", size, device)
    images = bench.frame_pool(batch, size, device)
    stats = bench.measure_stream(det, images, args.samples, args.steps or STREAM_STEPS)
    entry = cell(stats, bench.step_work(model, images[0].shape), device, batch,
                 "frames_per_sec")
    del det, model
    name = f"stream_{bench.size_tag(args.depth or 1.0, args.width or 1.0)}_{dtype_name}_b{batch}"
    if entry["ms_per_step"]:
        print(f"[{name}] {entry['ms_per_step']:.3f} ms/step (min over samples); "
              f"{entry['frames_per_sec']:.1f} frames/s", file=sys.stderr)
    return {name: entry}


def bench_stream_sweep(batches, int8: bool, args, device: torch.device) -> dict:
    """The batched step at each stream count, and the 30 FPS capacity: the
    largest measured N whose step fits one frame period (each stream gets
    one step per frame)."""
    results, rows = {}, []
    for b in batches:
        r = bench_stream("int8" if int8 else "bf16", b, args, device)
        results.update(r)
        (stats,) = r.values()
        rows.append((b, stats["ms_per_step"]))
    tag = "int8" if int8 else "bf16"
    fitting = [b for b, ms in rows if ms is not None and ms <= DEADLINE_MS]
    measured = all(ms is not None for _, ms in rows)
    results[f"capacity_30fps_{tag}"] = {
        "streams_per_card": (max(fitting) if fitting else 0) if measured else None,
        "deadline_ms": DEADLINE_MS, "batches": list(batches)}
    return results


def eval_work(model, images: np.ndarray) -> dict:
    return count_work(on_meta(model), meta_like(images), mode="off_pipe")


def bench_eval_fwd(args, device: torch.device) -> dict:
    """The dual-frame eval forward + NMS at K = 1000 on a [B, H, W, 6]
    uint8 batch from the host, cuDNN off (``StreamExp.get_forward_fn``)."""
    from streamyolo_torch.ops.nms import postprocess_fixed

    batch, size = args.batch or 8, tuple(args.input)
    depth, width = args.depth or 1.0, args.width or 1.0
    model = stream_model("int8" if args.int8 else "bf16", device, depth, width, size)
    forward = bench.seeded_exp(bench.CONFIG, depth, width).get_forward_fn(model)
    imgs = np.random.RandomState(0).randint(0, 255, (batch, *size, 6)).astype(np.uint8)

    def step():
        return postprocess_fixed(forward(imgs), bench.NUM_CLASSES, bench.CONF_THRE,
                                 bench.NMS_THRE, EVAL_TOPK)

    step()
    sync(device)
    stats = stats_ms(time_samples(step, args.samples, args.steps or STREAM_STEPS, device))
    name = (f"eval_fwd_d{depth}_w{width}_b{batch}" + ("_int8" if args.int8 else ""))
    return {name: cell(stats, eval_work(model, imgs), device, batch, "imgs_per_sec")}


def one_sequence(n: int):
    """A stand-in for a val dataset of one sequence of ``n`` frames (ONE
    pairing: support shift 1, 0 at the first and last frame), what
    ``SequentialDedupForward`` reads of a dataset."""
    images = [{"fid": i} for i in range(n)]
    return types.SimpleNamespace(ids=list(range(n)),
                                 coco=types.SimpleNamespace(dataset={"images": images}))


def bench_eval_dedup(args, device: torch.device) -> dict:
    """``SequentialDedupForward`` (one backbone pass per frame, the
    support features from the carry) + NMS at K = 1000, batches of one
    long sequence, cuDNN off."""
    from streamyolo_torch.eval.seq_forward import SequentialDedupForward
    from streamyolo_torch.ops.nms import postprocess_fixed

    batch, size = args.batch or 8, tuple(args.input)
    depth, width = args.depth or 1.0, args.width or 1.0
    steps = args.steps or STREAM_STEPS
    model = stream_model("bf16", device, depth, width, size)
    n_batches = 2 + args.samples * steps
    fwd = SequentialDedupForward(model, one_sequence(batch * n_batches))
    imgs = np.random.RandomState(0).randint(0, 255, (batch, *size, 6)).astype(np.uint8)
    ids = iter(range(0, batch * n_batches, batch))

    def step():
        first = next(ids)
        preds = fwd(imgs, list(range(first, first + batch)))
        return postprocess_fixed(preds, bench.NUM_CLASSES, bench.CONF_THRE, bench.NMS_THRE,
                                 EVAL_TOPK)

    step()  # the first batch, without a carry
    sync(device)
    stats = stats_ms(time_samples(step, args.samples, steps, device))
    meta = on_meta(model)
    x = meta_like(imgs[..., :3])
    shift = torch.ones(batch, dtype=torch.int64, device="meta")
    with torch.no_grad():
        _, carry = meta(x, mode="seq", support_shift=shift)
    work = count_work(meta, x, buffer=carry, mode="seq", support_shift=shift)
    return {f"eval_dedup_d{depth}_w{width}_b{batch}":
            cell(stats, work, device, batch, "imgs_per_sec")}


def remat_tag(args) -> str:
    return "_remat" if args.remat else ""


def bench_train(args, device: torch.device) -> dict:
    """``train_sweep.py``'s full train step at ``--batch`` (16)."""
    depth, width = args.depth or 0.33, args.width or 0.5
    batch = args.batch or 16
    point = train_sweep.measure(batch, device, depth, width, tuple(args.input), args.samples,
                                args.steps or TRAIN_STEPS, remat=args.remat)
    return {f"train_{bench.size_tag(depth, width)}_b{batch}{remat_tag(args)}": point}


def bench_train_parts(args, device: torch.device) -> dict:
    """The train step cut in five, each part between two CUDA events, the
    step's own ``forward`` and ``backward``: forward (train mode, bf16
    autocast; under ``--remat`` the first pass, without autograd), SimOTA
    assignment + loss, backward (under ``--remat`` with the re-run
    forward), SGD, EMA. Work: the forward's convolutions, 2x them in the
    backward (3x under ``--remat``); SGD reads the weight, gradient and
    momentum and writes the weight and momentum (5x the parameters' bytes),
    the EMA reads both copies and writes one (3x its tensors' bytes); the
    assignment is not counted."""
    from streamyolo_torch.models.losses import streamyolo_losses

    depth, width = args.depth or 0.33, args.width or 0.5
    batch = args.batch or 16
    exp, train_step, state, data = train_sweep.train_setup(batch, device, depth, width,
                                                           tuple(args.input), args.remat)
    model = state.model
    fwd = train_sweep.forward_work(model, data["images"])
    ema = [v for v in state.ema.state.values() if v.is_floating_point()]
    works = {"forward": fwd, "assign_loss": None,
             "backward": scale_work(fwd, 3 if args.remat else 2),
             "sgd": {"flops": 0, "int8_ops": 0, "ops_by_format": {},
                     "bytes": 5 * tensor_bytes(*model.parameters())},
             "ema": {"flops": 0, "int8_ops": 0, "ops_by_format": {},
                     "bytes": 3 * tensor_bytes(*ema)}}
    cuda = device.type == "cuda"
    times = {p: [] for p in TRAIN_PARTS}

    def step(record: bool):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(6)] if cuda else []
        mark = (lambda i: events[i].record()) if events else (lambda i: None)
        mark(0)
        outputs = train_step.forward(model, data["images"])
        mark(1)
        losses = streamyolo_losses(outputs, data["labels"], data["support_labels"],
                                   exp.num_classes, gamma=exp.tal_gamma,
                                   ignore_thr=exp.tal_ignore_thr,
                                   ignore_value=exp.tal_ignore_value)
        mark(2)
        state.optimizer.zero_grad(set_to_none=True)
        train_step.backward(model, data["images"], outputs, losses["total_loss"])
        mark(3)
        state.optimizer.step()
        mark(4)
        state.step += 1
        state.ema.update(state.step)
        mark(5)
        if record and events:
            events[5].synchronize()
            for i, p in enumerate(TRAIN_PARTS):
                times[p].append(events[i].elapsed_time(events[i + 1]) / 1e3)

    model.train()
    for g in state.optimizer.param_groups:
        g["lr"] = 0.001 / 64 * batch
    with train_sweep.cudnn_autotuned():
        for _ in range(2):
            step(False)
        sync(device)
        for _ in range(args.samples * (args.steps or TRAIN_STEPS)):
            step(True)
    tag = bench.size_tag(depth, width)
    return {f"train_parts_{tag}_{p}_b{batch}{remat_tag(args)}":
            cell(stats_ms(times[p] or None), works[p], device, batch, "imgs_per_sec")
            for p in TRAIN_PARTS}


def make_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("which", choices=[
        "stream_fp32", "stream_int8", "stream_sweep", "serve8", "eval_fwd",
        "eval_dedup", "train_s", "train_parts", "all"])
    p.add_argument("--batches", type=str, default="1,2,4,8,16,32",
                   help="stream_sweep only: comma-separated stream counts")
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--samples", type=int, default=8)
    p.add_argument("--steps", type=int, default=None,
                   help=f"calls per sample (default {STREAM_STEPS}; train {TRAIN_STEPS})")
    p.add_argument("--int8", action="store_true",
                   help="eval_fwd, stream_sweep: the int8 PTQ path")
    p.add_argument("--remat", action="store_true",
                   help="train_s, train_parts: the rematerialised train step")
    p.add_argument("--depth", type=float, default=None,
                   help="model depth (default 1.0; train cells 0.33)")
    p.add_argument("--width", type=float, default=None,
                   help="model width (default 1.0; train cells 0.50)")
    p.add_argument("--input", type=int, nargs=2, default=bench.INPUT, metavar=("H", "W"))
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = make_parser().parse_args(argv)
    device = resolve_device(args.device)
    which = args.which
    results = {"device": card(device)}
    if which == "train_parts":
        results.update(bench_train_parts(args, device))
    if which in ("stream_fp32", "all"):
        results.update(bench_stream("fp32", args.batch or 1, args, device))
    if which == "stream_int8":
        results.update(bench_stream("int8", args.batch or 1, args, device))
    if which == "stream_sweep":
        batches = [int(b) for b in args.batches.split(",")]
        results.update(bench_stream_sweep(batches, args.int8, args, device))
    if which in ("serve8", "all"):
        results.update(bench_stream("bf16", args.batch or 8, args, device))
    if which in ("eval_fwd", "all"):
        results.update(bench_eval_fwd(args, device))
    if which in ("eval_dedup", "all"):
        results.update(bench_eval_dedup(args, device))
    if which in ("train_s", "all"):
        results.update(bench_train(args, device))
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
