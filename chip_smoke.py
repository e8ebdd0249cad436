#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``streamyolo_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``streamyolo_torch/csrc``, holds each against
its plain PyTorch version on the card (edge cases included), holds the bf16
decode of the card against the CPU's, serves StreamYOLO-l at 600x960
through ``CUDAStreamDetector`` (host path and ``device_preproc``) with
random weights from a seed, checks the outputs (the card's fp32 step against
the CPU, bf16 against fp32), reads frames from disk without cv2 (phase
``image_io``: ``tests/torch_jpeg``'s JPEGs (baseline, progressive,
multi-scan, arithmetic-coded, lossless, CMYK, YCCK and RGB-coded) and PNGs
decoded and the JPEGs resized and encoded by the port's native code against
cv2's digests, the host path against ``device_preproc`` bit for bit,
``stream_det`` and ``offline_det`` reading the frames from disk,
``offline_det`` from the progressive and the arithmetic frames with the
baseline frames' rows, ``tools/vis_results.py``'s overlays drawn by the
port's ``vis/draw.py`` against the JAX tool's file digests, and the MP4s of
``vis.make_video`` and ``vis_results --video`` (the port's MPEG-4 encoder,
``vis/video.py``) against the digests the CPU tests pin), and times the
step and each kernel with CUDA events, one call at a time and back to back. Then it serves 8 camera streams
through ``MultiStreamDetector`` (one kernel-B1 launch per batched step, a
per-stream restart, fp32 rows against ``CUDAStreamDetector``), times the
batched step at 1, 8 and 56 streams, scores the port with the simulated-clock
sAP rehearsal (``streamyolo_torch/tools/sap_rehearsal.py``: 2 synthetic
sequences of 30 raw 1200x1920 frames, ``device_preproc``, measured latencies
replayed by ``SimClock``, pseudo ground truth, pairing, native COCOeval),
runs one sequence through the wall-clock streaming loop, and runs the offline
pseudo-streaming evaluation (``streamyolo_torch/tools/eval.py``'s path: the
port's ``Exp``, the val dataset and loader, the sequential-dedup forward with
its first-batch guard and the dual-frame forward, kernel B1 at K = 1000, the
ONEX evaluator, native COCOeval) on 2 in-memory synthetic sequences of 11 raw
1200x1920 frames in batches of 8; then (phase ``from_disk``) the port writes
those frames to disk as the JAX package's generator does with cv2 (each
file's sha256 held to cv2's), ``tools/eval.py``'s entry scores them from
disk with rows equal bit for bit to the same eval on the decoded frames in
memory, and ``tools/sap_rehearsal.py`` streams its default fixture, written
by the port, from disk. Last, it trains StreamYOLO-l at full width
through ``streamyolo_torch/tools/train.py``'s entry (bf16 autocast, batch 8,
2 epochs on 2 in-memory synthetic sequences of 24 raw 1200x1920 frames, the
first on the mosaic branch, which the loader workers build in NumPy without
cv2, its samples' digest held to cv2's bytes as the CPU tests pin them,
multiscale, the EMA eval after each epoch with kernel B1, checkpoints,
``--resume``, the eval CLI on the checkpoint), holds one float32 train step
of the card against the CPU, and checks the learning signal of a fixed-batch
overfit. Then it drives the real-time CLI (``streamyolo_torch/tools/
stream_det.py`` under the wall clock, with ``--sim-zoo`` and with
``--infinite``, then ``offline_det``, ``streaming_eval``, ``forecast_kf`` and
``collect_summary``) at full width on the rehearsal's frames, serves the
same frames through a ``Streamer`` whose detector lives in a spawned child
on the card, serves from captured CUDA graphs (phase ``aot_serve``:
``tools/precompile.py --serve`` in a child, a second child that cannot run
``nvcc`` serving from its directory bit for bit against eager detectors,
host path, ``device_preproc``, int8 and 8 streams, then ``stream_det
--aot-dir``), quantizes StreamYOLO-l to int8 (``streamyolo_torch/quant``:
calibration, BN fold, the int8 conv kernel ``csrc/int8_conv.cu`` held bit
for bit against its plain version at every conv shape of the step) and
serves it, serves StreamYOLO-l with each frame's rows sliced over 2 and 8
shards on the card (``parallel/spatial.py``, ``CUDAStreamDetector(mesh=...)``;
float64 rows and float32 predictions against the unsharded step, bf16 and
int8 reported, the int8 kernel at shard shapes, times; across cards where
there are two or more), trains a tiny StreamYOLO with the port on the
synthetic video and scores it offline (float and int8, each layer's int8
calibration range reported; the dedup eval's rows against the dual-frame
eval's, box-matched), streaming under the wall clock, in
simulation at the measured step and at 45 ms, and forecast; then (phase
``trained_bf16``) it serves the committed trained fixture
(``tests/torch_trained/``: that tiny model trained by the port on a CPU,
its weights as bf16) through ``CUDAStreamDetector`` in bf16
with ``device_preproc`` and in float32, and its 8 streams as one
``MultiStreamDetector`` batch, and holds the rows to the JAX package's own
(``golden.npz``) within the bounds the CPU tests state (ROADMAP C.2,
C.3). Last, it trains
data-parallel (``streamyolo_torch/parallel``): a float32 step of StreamYOLO-l
in two rank processes on the card over gloo against one process over the
same batch and a NCCL group of one, then ``tools/train.py`` as rank 0 and 1
of two machines (one epoch, the sharded eval with B1 in each rank, rank 0's
gathered rows against a one-process eval of its checkpoint); the ranks run
as ``chip_smoke.py --dp-rank ...``. Last (phase ``bench``), it runs the
port's measuring tools (``streamyolo_torch/tools/bench.py``, ``bench_suite.py``,
``train_sweep.py``, ``bench_hostpath.py``) once each at full width with few
samples, checks each JSON line (its keys, the card, every time finite and
above 0, ``0 < mfu <= 1.05``), holds the chain ``bench.py`` times to a
detector fed call by call, and the full-width work count to the step's 128
conv calls, runs ``bench_suite train_s --remat`` and holds one rematerialised
train step of StreamYOLO-s to the plain step (``remat_check``). Each phase prints
one JSON line; the line before the last lists the kernels, with their
launches on every path (from graphs: launches captured per graph x
replays), and the last line is ``{"ok": true, "device":
{...}}``. Any failed check raises, so the script exits non-zero and prints
no result. Imports nothing of JAX. ``--only train`` (or
``trained_e2e``, ``trained_bf16``, ``aot_serve``, ``data_parallel``,
``spatial``, ``image_io``, ``from_disk``, ``bench``) runs the build and that
phase alone.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import hashlib
import io
import itertools
import json
import pickle
import random
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SEED = 0
INPUT = (600, 960)  # the serving operating point of bench.py
CONF, NMS, TOPK, NCLS = 0.01, 0.65, 200, 8
STEADY_STEPS = 50
MULTI_N, MULTI_STEPS, MULTI_RESET_AT, MULTI_RESET_ROW = 8, 24, 10, 3
MULTI_TIMED_N = (1, 8, 56)
MODEL_SIZE = "l"
REHEARSAL_SEQS, REHEARSAL_FRAMES, REHEARSAL_SAMPLES = 2, 30, 20
# random weights score every box near sigmoid(0)^2 = 0.25: the pseudo ground
# truth keeps the oracle run's top tenth of scores instead of a fixed cut
PGT_SCORE_PERCENTILE = 90
EVAL_CONFIG, EVAL_SEQS, EVAL_FRAMES, EVAL_BATCH, EVAL_BIG_BATCH = (
    "l_s50_onex_dfp_tal_filp", 2, 11, 8, 64)
EVAL_TOPK = 1000  # postprocess_fixed's default, the evaluators' K
TRAIN_SEQS, TRAIN_FRAMES, TRAIN_BATCH, TRAIN_EPOCHS, TRAIN_WORKERS = 2, 24, 8, 2, 4
# the first epoch on the mosaic branch: YOLOX closes the mosaic before epoch
# max_epoch - no_aug_epochs (1-based), so 0 keeps it for epoch 1 of 2
TRAIN_NO_AUG_EPOCHS = 0
MOSAIC_TIMED_SAMPLES = 8  # mosaic pair items timed on the host, main process
GRAD_INPUT, GRAD_BATCH = (192, 320), 2  # the float32 card-vs-CPU train step
TRAIN_TEST_CONF = 1e-4
OVERFIT_STEPS, OVERFIT_LR = 60, 5e-3  # the JAX package's overfit recipe
STREAMER_EXACT_FRAMES = 5  # fp32, cuDNN off: the child's rows against the parent's
# trained_e2e: a tiny StreamYOLO (the s config at depth 0.33, width 0.25)
# trained on the synthetic video at its defaults (4 x 75 frames, raw 300x480,
# in_scale 0.5 -> 150x240) with objects of 1/8 to 1/4 of the frame, then
# scored offline, streaming under the wall clock, simulated at the measured
# step and at 45 ms, and forecast
E2E_SEQS, E2E_FRAMES, E2E_RAW, E2E_OBJ_FRAC = 4, 75, (300, 480), (1 / 8, 1 / 4)
# no loader workers: each epoch's prefetcher would spawn them anew (~28 s of
# start-up per epoch on the card's host), where rendering a 300x480 batch in
# the main process costs a few ms
E2E_BATCH, E2E_EPOCHS, E2E_LR_PER_IMG, E2E_WORKERS = 16, 22, 0.02 / 16, 0
E2E_EVAL_BATCH = 64  # the eval CLI's default batch: few batches, few cuDNN autotunes
# the int8 eval's calibration batches: the eval CLI's default, which covers
# the whole 300-frame val split at batch 64 (5 batches). The 2 of PRs 7-10
# run beside it, reported and not checked: their calibration missed the
# range of layers on the later sequences (ROADMAP C.4)
E2E_CALIB_BATCHES, E2E_CALIB_BATCHES_FEW = 8, 2
# ROADMAP C.1: dedup rows without a box-matched partner in the --no-dedup
# rows (and the reverse), at most this share of both runs' rows
E2E_UNMATCHED_MAX = 0.01
E2E_SLOW_S = 0.045  # a latency that misses frames at 30 fps
# trained_bf16: the committed trained fixture (tests/torch_trained/, written
# by `python -m tests.torch_trained_fixture`): trained_e2e's model trained
# by the port on the CPU, its weights as bf16, and the JAX package's rows and
# decoded candidates, bf16 and float32, on TRAINED_SEQS x TRAINED_OFFSETS
# streams of TRAINED_STEPS frames (sequence s from frame o: a star, then
# steady frames carrying the DFP buffer)
TRAINED_FIXTURE = Path(__file__).resolve().parent / "tests" / "torch_trained"
TRAINED_SEQS, TRAINED_OFFSETS, TRAINED_STEPS = (0, 1, 2, 3), (0, 40), 8
TRAINED_IN_SCALE = 0.5  # raw 300x480 -> the model's 150x240
# The bounds (ROADMAP C.2, C.3; tests/test_torch_trained_bf16.py states
# where each comes from). Rows: kept rows box-matched by matched_rows (IoU
# 0.9 within each (frame, class)); at most this share of both runs' rows
# unmatched, the largest box gap of a matched pair (px of the 150x240
# input) and score gap. bf16: the port's bf16 on the tests' CPU against JAX
# bf16 measured 0.0464 / 3.062 / 0.0434, plus half of JAX bf16's own gap to JAX
# float32 (0.0445 / 2.061 / 0.0338). float32: every row matched within
# tests/test_torch_stream.py's bounds (1e-3 raw px, 1e-5).
TRAINED_BF16_ROWS = {"unmatched_share": 0.07, "box_px": 4.1, "score": 0.061}
TRAINED_FP32_ROWS = {"unmatched_share": 0.0, "box_px": 5e-4, "score": 1e-5}
# candidates: a bf16 run's gap to JAX float32 at most 1 + this times JAX
# bf16's own (the CPU's port bf16 measured 0.51-1.16 of it)
TRAINED_CAND_MARGIN = 0.25
# a stream's unmatched share (about 60 rows; the CPU's port bf16 against JAX
# bf16 measured 0.0947 in its worst stream, the card's 0.1158, JAX bf16's
# own against JAX float32 0.1158)
TRAINED_STREAM_UNMATCHED = 0.15
# the card: cuDNN's bf16 allowance over the bf16 bounds, the card's bf16
# (cuDNN's heuristic algorithms) less the port's bf16 on the tests' CPU,
# rounded up (NVIDIA H100 80GB HBM3, 700.00 W: rows 0.0507 / 3.062 /
# 0.0532; candidates' ratios to JAX bf16's gap at most 0.035 above)
TRAINED_CUDNN_ALLOWANCE = {"unmatched_share": 0.005, "box_px": 0.0, "score": 0.01,
                           "candidates": 0.04}
# the multi-stream rows (N = 8, one batch) against the single-stream
# detector's on the card: measured equal bit for bit with the phase alone,
# 0 / 0.8125 / 0.0078 after the eval CLI's cudnn.benchmark had tuned the
# same shapes, plus half of JAX bf16's own gap to JAX float32
TRAINED_MULTI_ROWS = {"unmatched_share": 0.023, "box_px": 1.9, "score": 0.025}
# data_parallel: the step's global batch (2 per rank); a rank process's
# limit, and the process groups' timeout
DP_BATCH, DP_TIMEOUT_S = 4, 600
# data_parallel's steps: (carried state, dtype name) by case. "seeded" is
# the seeded init with seeded BatchNorm, "identity" with flax's identity
# BatchNorm, each after one step
DP_CASES = {"seeded_float32": ("seeded", "float32"), "seeded_float64": ("seeded", "float64"),
            "identity_float32": ("identity", "float32"),
            "identity_float64": ("identity", "float64")}
# the float64 steps' bound: normwise per tensor, every tensor (momentum too),
# 1,000 times below the float32 bound (the loss still runs in float32)
DP_FLOAT64_NORMWISE = 1e-6
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores, published
INT8_OPS_PER_S = 1979e12  # H100 SXM int8 tensor cores, dense, published
# int8 conv: per input value a divide, a round and two clamps (float32); per
# output value a convert and a multiply
INT8_QUANT_OPS, INT8_DEQUANT_OPS = 4, 2
INT8_CALIB_FRAMES = 4  # int8 phase: off_pipe calibration frames
INT8_HEAVIEST = 3  # shapes timed alone and also checked in float32
# the int8 float32 step, card against CPU: the fp32 bound of the float path
# (an int8 code flips where the two devices' float32 BN / SiLU straddle a
# rounding boundary; the CPU tests measured 2.9e-6 relative on boxes and
# 3e-7 on scores for the tiny model against the JAX package)
INT8_BOX_REL, INT8_PROB_ABS = 1e-3, 1e-4
# spatial: the row-sharded step (CUDAStreamDetector(mesh=...)) with every
# shard on cuda:0, held against the unsharded step over a star and
# SPATIAL_STEADY steady frames: at least SPATIAL_MATCHED_MIN of the unsharded
# kept rows matched at IoU SPATIAL_IOU (within each class), score gap at most
# SPATIAL_SCORE_GAP (float32, TF32 off); timed over SPATIAL_TIMED frames
SPATIAL_N, SPATIAL_STEADY, SPATIAL_TIMED = (2, 8), 4, 20
SPATIAL_IOU, SPATIAL_MATCHED_MIN, SPATIAL_SCORE_GAP = 0.99, 0.99, 1e-3
# image_io: the fixtures (cv2's digests beside them), host times' median count
JPEG_FIXTURES = Path(__file__).resolve().parent / "tests" / "torch_jpeg"
IMAGE_IO_TIMED, IMAGE_IO_SIZES = 20, ((600, 960), (601, 959))
# from_disk: the rehearsal's fixture written by the port (frames a
# sequence) and its measured latency samples
FROM_DISK_REHEARSAL_FRAMES, FROM_DISK_REHEARSAL_SAMPLES = 10, 5
# bench: the measuring tools at full width with few samples (samples, calls
# per sample), stream_sweep's stream counts, the train batch of train_sweep
# and bench_hostpath --train; the chain held to the detector (steps)
BENCH_SAMPLES, BENCH_STEPS, BENCH_SWEEP, BENCH_TRAIN_BATCH = 2, 10, "1,8", 8
BENCH_CHAIN_STEPS = 12
# IoU of one pair: 4 max/min, 2 sub, 2 clamp, 1 mul, 2 add/sub, 1 clamp, 1 div, 1 cmp
NMS_OPS_PER_IOU = 14
# per output pixel and channel: 3 adds, 1 mul, 1 add, floor, 2 clamps
PREPROC_OPS_PER_VALUE = 8


_T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One phase's JSON line, with the seconds since the script started."""
    elapsed = round(time.perf_counter() - _T0, 1)
    print(json.dumps({"phase": phase, "elapsed_s": elapsed, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_cuda(fn, iters: int, warmup: int = 3, device_only: bool = False) -> float:
    """Median over ``iters`` single calls of ``fn`` timed with CUDA events (ms).

    ``device_only``: the card first sleeps ~0.5 ms, so the host has queued
    the call before the start event fires and the span holds the kernel's
    device time alone, not the wrapper's submit time (use for calls that
    do not synchronise). The span still holds the card's own cost of one
    launch between two events (``floor_ms``)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_back_to_back(fn, calls: int = 100, reps: int = 10) -> float:
    """CUDA events around ``calls`` launches of ``fn`` in a row, divided by
    ``calls``; median of ``reps`` (ms). The card sleeps while the host
    queues the calls, so they run back to back and the span is device time
    with the launches pipelined. ``fn`` must not synchronise."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000 * calls)  # ~50 us of host time per queued call
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def nms_case(k: int, seed: int, ties: bool = False):
    """The cases of ``run_pallas_nms_selftest``: score-sorted boxes with 3
    class offsets, 80 % valid; ``ties`` sorts groups of 4 equal scores."""
    rng = np.random.RandomState(seed)
    cxy = rng.uniform(20, 500, (k, 2))
    wh = rng.uniform(5, 80, (k, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1)
    if ties:
        scores = np.repeat(rng.uniform(0.2, 1.0, k // 4), 4)
        boxes = boxes[np.argsort(-scores, kind="stable")]
    boxes += rng.randint(0, 3, (k, 1)) * 8192.0
    return boxes.astype(np.float32), rng.uniform(size=k) < 0.8


def nms_cases():
    """(label, boxes [B, K, 4], valid [B, K], thr) for the B1 checks: the
    self-test cases at every K the kernel's chunking distinguishes (1, one
    word short and over, the serving 200, the 1024 maximum), both
    thresholds, score ties, all boxes invalid, all boxes identical (one
    keeper and the longest suppression), and the multi-stream batch of 56."""
    def stack(k, seeds, ties=False):
        data = [nms_case(k, seed=1000 * k + s, ties=ties) for s in seeds]
        return np.stack([d[0] for d in data]), np.stack([d[1] for d in data])

    cases = [(f"K={k} thr={thr}", *stack(k, range(8)), thr)
             for k in (1, 31, 33, 64, 200, 1024) for thr in (0.45, 0.65)]
    cases.append(("K=200 ties", *stack(200, range(8), ties=True), 0.65))
    boxes, valid = stack(200, range(8))
    cases.append(("K=200 all invalid", boxes, np.zeros_like(valid), 0.65))
    same = np.broadcast_to(boxes[:, :1], boxes.shape).copy()
    cases.append(("K=200 all identical", same, np.ones_like(valid), 0.65))
    cases.append(("K=200 multi-stream", *stack(200, range(56)), 0.65))
    return cases


def iou_evaluations(boxes, valid, thr) -> int:
    """IoUs the greedy sweep of kernel B1 evaluates on these inputs: for each
    kept row i, the later rows still kept (the data-dependent work)."""
    from streamyolo_torch.ops.nms_cuda import _iou_matrix_xyxy, _thr32

    over = (_iou_matrix_xyxy(boxes.cpu()) > _thr32(thr)).numpy()
    total = 0
    for b in range(over.shape[0]):
        keep = valid[b].cpu().numpy().copy()
        for i in range(keep.shape[0]):
            if keep[i]:
                total += int(keep[i + 1:].sum())
                keep[i + 1:] &= ~over[b, i, i + 1:]
    return total


def bound_ms(n_bytes: float, n_ops: float, int8_ops: float = 0.0):
    """The card's least time (ms) for ``n_bytes`` of traffic, ``n_ops``
    float32 operations and ``int8_ops`` int8 tensor-core operations, and
    which of bytes and operations sets it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / FP32_OPS_PER_S + int8_ops / INT8_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def lift_pred_biases(model) -> None:
    """Zero the obj/cls prediction biases: with the prior-prob init every
    score is ~1e-4 < conf 0.01 and NMS would see no candidates."""
    import torch

    with torch.no_grad():
        for m in list(model.head.obj_preds) + list(model.head.cls_preds):
            m.bias.zero_()


def bf16_layer_errors(m32, m16, x) -> list:
    """Relative L2 error of every conv block of the bf16 model against the
    fp32 one, each run on the SAME fp32 input (cast to bf16 for the bf16
    block). Errors are local: a random-weight trunk amplifies any
    difference from layer to layer, so an end-to-end bf16 comparison on
    random weights measures that amplification, not the bf16 path."""
    import torch

    from streamyolo_torch.nn.blocks import BaseConv

    want = {n for n, m in m32.named_modules()
            if isinstance(m, BaseConv) or (n.startswith("head.") and isinstance(m, torch.nn.Conv2d)
                                           and m.bias is not None)}
    seen = {}
    hooks = [m.register_forward_hook(
        lambda mod, inp, out, n=n: seen.__setitem__(n, (inp[0], out)))
        for n, m in m32.named_modules() if n in want]
    with torch.inference_mode():
        m32(x, mode="on_pipe")
        for h in hooks:
            h.remove()
        mods16 = dict(m16.named_modules())
        errs = []
        for n, (inp, out) in seen.items():
            got = mods16[n](inp.to(torch.bfloat16))
            check(got.dtype == torch.bfloat16, f"{n} does not compute in bf16")
            errs.append(float((got.float() - out).norm() / out.norm().clamp(min=1e-12)))
    return errs

def fp32_errors(got, want) -> dict:
    """Box error relative to |box| + 1 and probability error, the stated
    fp32 card-vs-reference measures (bounds 1e-3 and 1e-4)."""
    box = float(((got[..., :4] - want[..., :4]).abs() / (want[..., :4].abs() + 1.0)).max())
    prob = float((got[..., 4:] - want[..., 4:]).abs().max())
    return {"box_rel_err": box, "prob_abs_err": prob}


def serving_pool() -> list:
    """16 seeded 600x960 frames: the multi-stream, int8 and spatial phases'."""
    return [np.random.RandomState(SEED + 1 + i).randint(0, 256, (*INPUT, 3), np.uint8)
            for i in range(16)]


def stream_batch(pool, t: int, n: int) -> np.ndarray:
    """Frames of step ``t`` for ``n`` streams: stream ``i`` shows
    ``pool[(t + 3 i) % len(pool)]``, so the sequences differ."""
    return np.stack([pool[(t + 3 * i) % len(pool)] for i in range(n)])


def phase_multi_stream(model, m32, pool, kw) -> dict:
    """8 streams through ``MultiStreamDetector`` (bf16, full width): a star
    step and ``MULTI_STEPS`` steady steps, ``reset(3)`` before step 10. Checks
    one B1 launch per step, stable buffer memory, the restarted row against
    a fresh star step and the other rows against their carry (bit for bit:
    same batch, same programs), the card's postprocess against the plain one
    on the same predictions, and one row of an fp32 multi-stream run
    against ``CUDAStreamDetector`` fed the same frames (TF32 off). Measures,
    without a bound (ROADMAP C.3), stream 0's bf16 rows against a bf16
    ``CUDAStreamDetector`` fed its frames, box-matched: with random weights
    at full width the trunk carries cuDNN's batch-row rounding into nearly
    tied scores (724 of 4,565 rows matched once), so a bound would measure
    the weights, not the port. The bound is phase ``trained_bf16``'s, on
    trained weights at the tiny width; one at full width waits for released
    weights in the repository."""
    import torch

    from streamyolo_torch.ops.nms import postprocess_fixed, select_candidates
    from streamyolo_torch.ops.nms_cuda import nms_keep
    from streamyolo_torch.stream import CUDAStreamDetector, MultiStreamDetector

    dev = next(model.parameters()).device
    multi = MultiStreamDetector(model, MULTI_N, device=dev, **kw)
    multi.warmup(2)

    def rows_of(preds):
        return postprocess_fixed(preds, NCLS, CONF, NMS, TOPK)

    nms_keep.launches = 0
    multi.reset()
    restart = {}
    stream0 = []
    for t in range(1 + MULTI_STEPS):
        frames = stream_batch(pool, t, MULTI_N)
        if t == MULTI_RESET_AT:
            multi.reset(MULTI_RESET_ROW)
            before = [b.clone() for b in multi._buffer]
        launched = nms_keep.launches
        multi(frames, preprocessed=True)
        check(nms_keep.launches == launched + 1,
              f"multi-stream step {t} launched B1 {nms_keep.launches - launched} times")
        rows = multi.last_rows
        check(rows.shape == (MULTI_N, TOPK, 8) and np.isfinite(rows).all(),
              f"multi-stream step {t}: rows not a finite [{MULTI_N}, {TOPK}, 8] block")
        stream0 += det_rows(rows[0], t)
        if t == 0:
            ptrs = [b.data_ptr() for b in multi._buffer]
            check(all(b.is_contiguous(memory_format=torch.channels_last)
                      for b in multi._buffer), "multi-stream buffer is not channels_last")
        check([b.data_ptr() for b in multi._buffer] == ptrs,
              f"multi-stream buffer reallocated at step {t}")
        if t == MULTI_RESET_AT:
            # verification launches are not the path's: restore the count
            saved = nms_keep.launches
            images = torch.from_numpy(frames).to(dev)
            with torch.inference_mode():
                star_p, _ = model(images, mode="on_pipe")
                carry_p, _ = model(images, buffer=tuple(before), mode="on_pipe")
                want_star, want_carry = rows_of(star_p).cpu(), rows_of(carry_p).cpu()
                plain = rows_of(carry_p.cpu())
                _, nms_boxes, nms_valid = select_candidates(carry_p, NCLS, CONF, TOPK)
            nms_keep.launches = saved
            got = torch.from_numpy(rows)
            r = MULTI_RESET_ROW
            check(torch.equal(got[r], want_star[r]),
                  "after reset(3), row 3 differs from a fresh star step")
            others = [i for i in range(MULTI_N) if i != r]
            check(torch.equal(got[others], want_carry[others]),
                  "after reset(3), the other rows lost their carry")
            check(not torch.equal(want_star[r], want_carry[r]),
                  "star and carry rows are equal: the reset check is vacuous")
            check(torch.equal(want_carry, plain),
                  "batched postprocess on the card differs from the plain one")
            restart = {"row": r, "at_step": t, "row_equals_fresh_star": True,
                       "other_rows_equal_carry": True,
                       "kernel_rows_equal_plain": True}
    launches = nms_keep.launches
    check(launches == 1 + MULTI_STEPS,
          f"B1 launched {launches} times in {1 + MULTI_STEPS} multi-stream steps")
    check(not multi._pending_star.any(), "pending stars were not cleared")
    kept = [int((multi.last_rows[i][:, 7] > 0.5).sum()) for i in range(MULTI_N)]

    # ROADMAP C.3, measured without a bound (see the docstring): stream 0's
    # bf16 rows at N = 8 against a single-stream bf16 detector fed the same frames
    single16 = CUDAStreamDetector(model, device=dev, **kw)
    single_rows = []
    for t in range(1 + MULTI_STEPS):
        single16(stream_batch(pool, t, 1)[0], preprocessed=True)
        single_rows += det_rows(single16.last_rows, t)
    c3 = matched_rows(stream0, single_rows)

    # fp32: row 5 of the batched detector against the single-stream one
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kw32 = {**kw, "use_bf16": False}
    multi32 = MultiStreamDetector(m32, MULTI_N, device=dev, **kw32)
    single = CUDAStreamDetector(m32, device=dev, **kw32)
    seen = []
    hook = m32.register_forward_hook(lambda mod, inp, out: seen.append(out[0].float()))
    row, errs = 5, []
    for t in range(4):
        frames = stream_batch(pool, t, MULTI_N)
        multi32(frames, preprocessed=True)
        single(frames[row], preprocessed=True)
        errs.append(fp32_errors(seen[-2][row].cpu(), seen[-1][0].cpu()))
    hook.remove()
    torch.backends.cudnn.allow_tf32 = True
    fp32 = {k: max(e[k] for e in errs) for k in errs[0]}
    # stated tolerance, as for the card against the CPU: cuDNN may pick other
    # algorithms at batch 8 than at batch 1
    check(fp32["box_rel_err"] < 1e-3 and fp32["prob_abs_err"] < 1e-4,
          f"fp32 multi-stream row vs CUDAStreamDetector out of bound: {fp32}")
    emit("multi_stream", model=f"StreamYOLO-{MODEL_SIZE}", input=list(INPUT), dtype="bfloat16",
         streams=MULTI_N, steps=1 + MULTI_STEPS, b1_launches=launches,
         b1_launches_per_step=launches / (1 + MULTI_STEPS), restart=restart,
         buffer_data_ptr_stable=True, kept_last_step=kept,
         fp32_row_vs_single_stream=dict(row=row, steps=len(errs), **fp32),
         bf16_stream0_vs_single_stream_matched=c3)
    return {"launches": launches, "nms_boxes": nms_boxes, "nms_valid": nms_valid}


def phase_multi_stream_times(model, pool, kw) -> None:
    """``MultiStreamDetector`` at N = 1, 8, 56: ``step`` device ms (CUDA
    events, median of 20), ``__call__`` wall ms on preprocessed frames
    (median of 20), frames/s = N * 1000 / wall, and the peak device memory."""
    import torch

    from streamyolo_torch.stream import MultiStreamDetector

    dev = torch.device("cuda")
    out = {}
    for n in MULTI_TIMED_N:
        det = MultiStreamDetector(model, n, **kw)
        frames = stream_batch(pool, 0, n)
        images = torch.from_numpy(frames).to(dev)
        torch.cuda.reset_peak_memory_stats()
        det.warmup(2)
        det.reset()
        det.step(images)  # star
        device_ms = time_cuda(lambda: det.step(images), iters=20)
        wall = []
        for _ in range(20):
            t = time.perf_counter()
            det(frames, preprocessed=True)  # ends in the [N, K, 8] D2H copy
            wall.append((time.perf_counter() - t) * 1e3)
        wall_ms = statistics.median(wall)
        out[f"n{n}"] = {"step_device_ms": device_ms, "call_wall_ms": wall_ms,
                        "frames_per_s": n * 1e3 / wall_ms,
                        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        del det, images
        torch.cuda.empty_cache()
    # largest activation at N = 56: the stem's [56, 64, 300, 480] bf16 map
    emit("multi_stream_times", model=f"StreamYOLO-{MODEL_SIZE}", input=list(INPUT), dtype="bfloat16",
         stem_map_gb_n56=56 * 64 * (INPUT[0] // 2) * (INPUT[1] // 2) * 2 / 1e9, **out)


def rehearsal_fixture():
    """The rehearsal's in-memory synthetic fixture at Argoverse-HD's raw size."""
    from streamyolo_torch.data import SyntheticArgoverse

    return SyntheticArgoverse(seq_lens=(REHEARSAL_FRAMES,) * REHEARSAL_SEQS,
                              size=(2 * INPUT[0], 2 * INPUT[1]), seed=SEED)


def phase_sap_rehearsal(out_dir, device="cuda"):
    """The simulated-clock sAP rehearsal through the tool's functions: an
    in-memory synthetic fixture at Argoverse-HD's raw size, a
    ``device_preproc`` StreamYOLO-l detector from seeded weights (B2 and
    B1), measured per-call walls replayed by ``SimClock``, pseudo ground
    truth from the detector's every-frame run, pairing and native COCOeval.
    Returns the detector, the fixture and the path's kernel launches."""
    from streamyolo_torch.data import COCO
    from streamyolo_torch.ops.nms_cuda import nms_keep
    from streamyolo_torch.ops.preproc import downsample2x
    from streamyolo_torch.stream import Empirical, SimClock, run_streaming_detection, streaming_eval
    from streamyolo_torch.tools import sap_rehearsal as reh

    raw_size = (2 * INPUT[0], 2 * INPUT[1])
    synth = rehearsal_fixture()
    db = COCO(synth.data)
    det = reh.build_detector(MODEL_SIZE, input_size=INPUT, seed=SEED, in_scale=0.5,
                             conf_thre=CONF, nms_thre=NMS, pre_nms_topk=TOPK,
                             device_preproc=True, device=device)
    lift_pred_biases(det.model)
    det.warmup(3)

    nms_keep.launches = 0
    downsample2x.launches = 0
    samples = reh.measure_per_call(det, synth.frame(db.dataset["images"][0]),
                                   REHEARSAL_SAMPLES)
    runtime_dist = Empirical(samples, seed=SEED)
    oracle = reh.offline_ccf(db, det, synth.frame)
    score_th = float(np.percentile([d["score"] for d in oracle], PGT_SCORE_PERCENTILE))
    gt_db = reh.pseudo_ground_truth(db, oracle, score_th, out_dir)
    run_dir = f"{out_dir}/stream_run"
    time_info = run_streaming_detection(
        gt_db, None, run_dir, det, clock=SimClock(), runtime_dist=runtime_dist,
        overwrite=True, load_frame=synth.frame)
    eval_summary, assoc = streaming_eval(gt_db, run_dir, out_dir=run_dir, overwrite=True)
    launches = {"nms": nms_keep.launches, "preproc": downsample2x.launches}
    # one launch of each per detector call; a streaming call that ends past
    # a sequence's horizon is made but not recorded
    calls = 1 + REHEARSAL_SAMPLES + len(db.imgs) + time_info["n_processed"]
    check(launches["nms"] == launches["preproc"]
          and calls <= launches["nms"] <= calls + REHEARSAL_SEQS,
          f"rehearsal: {launches} kernel launches for {calls} recorded detector calls")

    summary = reh.summarize(f"streamyolo_{MODEL_SIZE}", "oracle", 30.0, runtime_dist, len(samples),
                            1.0, time_info, assoc, eval_summary)
    stats = [float(v) for v in eval_summary["stats"]]
    n_total = REHEARSAL_SEQS * REHEARSAL_FRAMES
    check(time_info["n_total"] == n_total, "rehearsal lost frames")
    if max(samples) < 1.0 / 30:
        check(time_info["n_processed"] == n_total and assoc["miss"] == REHEARSAL_SEQS,
              f"sub-frame latencies but {time_info['n_processed']}/{n_total} "
              f"processed, miss {assoc['miss']}")
    check(all(np.isfinite(stats[:3])) and 0 <= 100 * stats[0] <= 100,
          f"sAP not finite in [0, 100]: {stats[:3]}")
    check(eval_summary["evaluator"] == "COCOeval_opt",
          f"scored by {eval_summary['evaluator']}, not the native COCOeval")
    emit("sap_rehearsal", fixture=f"{REHEARSAL_SEQS}x{REHEARSAL_FRAMES} frames "
         f"{raw_size[0]}x{raw_size[1]} synthetic, in memory", model=f"StreamYOLO-{MODEL_SIZE}",
         input=list(INPUT), dtype="bfloat16", device_preproc=True,
         latency_ms={"mean": 1e3 * runtime_dist.mean(), "min": 1e3 * runtime_dist.min(),
                     "max": 1e3 * runtime_dist.max(), "n_samples": len(samples)},
         frames={"processed": time_info["n_processed"], "total": time_info["n_total"]},
         association=assoc, sAP=100 * stats[0], sAP50=100 * stats[1], sAP75=100 * stats[2],
         pseudo_gt_score_th=score_th, pseudo_gt_annotations=len(gt_db.anns),
         oracle_detections=len(oracle), evaluator=eval_summary["evaluator"],
         summary=summary, launches=launches)
    return det, synth, launches


def phase_wallclock_stream(det, synth) -> dict:
    """One 30-frame sequence through ``stream_sequence`` with ``WallClock``:
    the production loop (about one second)."""
    from streamyolo_torch.ops.nms_cuda import nms_keep
    from streamyolo_torch.ops.preproc import downsample2x
    from streamyolo_torch.stream import WallClock, stream_sequence

    frames = [synth.frame(img) for img in synth.data["images"] if img["sid"] == 0]
    nms_keep.launches = 0
    downsample2x.launches = 0
    res = stream_sequence(frames, det, fps=30.0, clock=WallClock())
    launches = {"nms": nms_keep.launches, "preproc": downsample2x.launches}
    ts, fidx, rt = res["timestamps"], res["input_fidx"], res["runtime"]
    horizon = len(frames) / 30.0
    check(len(ts) > 0, "wall-clock stream processed no frame")
    check(all(b > a for a, b in zip(ts, ts[1:])) and ts[-1] < horizon,
          "wall-clock timestamps not increasing below the horizon")
    check(all(b >= a for a, b in zip(fidx, fidx[1:])), "input_fidx decreases")
    check(all(r > 0 for r in rt), "a runtime is not > 0")
    check(launches["nms"] == launches["preproc"] >= len(ts),
          f"wall-clock stream: kernel launches {launches} for {len(ts)} results")
    rt_ms = [1e3 * r for r in rt]
    emit("wallclock_stream", frames=len(frames), processed=len(ts),
         runtime_ms={"mean": statistics.mean(rt_ms), "median": statistics.median(rt_ms),
                     "min": min(rt_ms), "max": max(rt_ms)},
         launches=launches)
    return launches


def b1_exact(boxes, valid, thr, label: str) -> int:
    """B1 on the card against both plain versions (the fixed point on the
    card, the greedy sweep on the CPU); returns the entries compared.
    Restores the launch count: a check is no launch of the path."""
    import torch

    from streamyolo_torch.ops.nms_cuda import nms_keep, nms_padded, nms_padded_sequential

    saved = nms_keep.launches
    got = nms_keep(boxes, valid, thr)
    torch.cuda.synchronize()
    nms_keep.launches = saved
    bad = (int((got != nms_padded(boxes, valid, thr)).sum())
           + int((got.cpu() != nms_padded_sequential(boxes.cpu(), valid.cpu(), thr)).sum()))
    check(bad == 0, f"B1 keep mask differs from the plain versions at {label}: {bad} entries")
    return got.numel()


def phase_offline_eval(out_dir: Path, floor: dict) -> dict:
    """The offline pseudo-streaming evaluation through the port's ``Exp``
    (``l_s50_onex_dfp_tal_filp``, bf16 modules, seed-0 weights with the
    obj/cls biases lifted): an in-memory synthetic Argoverse-HD val set
    (annotation json under ``build/``, frames rendered by ``load_frame``, no
    cv2), batches of 8 with a padded tail, the default sequential-dedup
    forward with its first-batch guard armed, then the dual-frame forward
    (``--no-dedup``). Checks the guard, one B1 launch per batch, B1 bit-exact
    at K = 1000 on the eval's own candidates (B = 8 and B = 64), the two
    forwards' AP within 0.5 points and their COCO rows equal (both run
    cuDNN off on a card), and fp32 ``seq`` predictions on the card against
    the CPU's. Times each forward (the evaluator's meters on a second, warm
    run without the guard), the dual-frame forward with and without cuDNN,
    and B1 at K = 1000."""
    import torch

    from streamyolo_torch.data import SyntheticArgoverse
    from streamyolo_torch.data.loader import _numpy_collate
    from streamyolo_torch.eval.seq_forward import support_shifts
    from streamyolo_torch.exp import get_exp
    from streamyolo_torch.ops.nms import select_candidates
    from streamyolo_torch.ops.nms_cuda import nms_keep, nms_padded
    from streamyolo_torch.ops.preproc import downsample2x

    raw_size = (2 * INPUT[0], 2 * INPUT[1])
    synth = SyntheticArgoverse(seq_lens=(EVAL_FRAMES,) * EVAL_SEQS, size=raw_size, seed=SEED)
    ann_dir = out_dir / "Argoverse-HD" / "annotations"
    ann_dir.mkdir(parents=True, exist_ok=True)
    (ann_dir / "val.json").write_text(json.dumps(synth.data))

    exp = get_exp(exp_name=EVAL_CONFIG)
    exp.merge(["data_dir", str(out_dir), "data_num_workers", "0"])
    exp.compute_dtype = "bfloat16"
    state = exp.init_model()
    model = exp.get_model("cuda")
    model.load_state_dict(state)
    lift_pred_biases(model)
    check(model.dtype == torch.bfloat16, "the Exp built fp32 modules behind compute_dtype bf16")
    check(exp.test_size == INPUT and exp.test_conf == CONF and exp.nmsthre == NMS,
          f"{EVAL_CONFIG} is not at the serving operating point")

    runs, launches, rows_of = {}, {}, {}
    n_images = EVAL_SEQS * EVAL_FRAMES
    for name in ("dedup", "no_dedup"):
        for warm in (False, True):
            evaluator = exp.get_evaluator(EVAL_BATCH, load_frame=synth.frame)
            n_batches = len(evaluator.dataloader)
            if name == "dedup":
                fwd = exp.get_dedup_forward_fn(model, evaluator.dataset,
                                               verify_first_batch=not warm)
            else:
                fwd = exp.get_forward_fn(model)
            nms_keep.launches = 0
            downsample2x.launches = 0
            (ap, ap50, _), rows = evaluator.evaluate(fwd, return_outputs=True)
            if warm:
                runs[name]["ms_per_image_warm"] = evaluator.last_times_ms
                continue
            launches[name] = {"nms": nms_keep.launches, "preproc": downsample2x.launches}
            check(launches[name] == {"nms": n_batches, "preproc": 0},
                  f"offline eval ({name}): kernel launches {launches[name]} in "
                  f"{n_batches} batches")
            check(len(rows) > 0 and all(np.isfinite(r["bbox"]).all() and np.isfinite(r["score"])
                                        for r in rows), f"offline eval ({name}): no finite rows")
            rows_of[name] = rows
            runs[name] = {"AP": 100 * float(ap), "AP50": 100 * float(ap50),
                          "rows": len(rows), "batches": n_batches, "launches": launches[name],
                          "ms_per_image_first": evaluator.last_times_ms}
            if name == "dedup":
                check(fwd.last_guard is not None, "the first-batch guard did not run")
                runs[name]["guard"] = {"box_diff": fwd.last_guard[0],
                                       "score_diff": fwd.last_guard[1],
                                       "tolerance": list(exp.dedup_tolerance())}
    check(n_batches == -(-n_images // EVAL_BATCH) and n_images % EVAL_BATCH,
          "the fixture does not end in a padded batch")
    for k in ("AP", "AP50"):
        check(abs(runs["dedup"][k] - runs["no_dedup"][k]) <= 0.5,
              f"dedup and dual-frame {k} differ: {runs['dedup'][k]} vs {runs['no_dedup'][k]}")
    # random weights score AP = 0.0 against the synthetic boxes, so the AP
    # check cannot fail. Every batch's COCO rows must be equal: both eval
    # forwards run PyTorch's own convolution on the card (cuDNN off: one GEMM
    # per image, so an image rounds alike at every batch row; cuDNN's
    # split-K kernels do not, and the random trunk carries that far)
    check(rows_of["dedup"] == rows_of["no_dedup"],
          "the dedup forward's COCO rows differ from the dual-frame forward's")

    # the eval's own candidates: the first batch (B = 8), and 64 samples of
    # the fixture (cycled) through the dual-frame forward (B = 64)
    dataset = exp.get_eval_loader(EVAL_BATCH, load_frame=synth.frame).dataset
    samples = [dataset[i] for i in range(n_images)]
    imgs8, _, _, ids8 = _numpy_collate(samples[:EVAL_BATCH])
    imgs64 = np.stack([samples[i % n_images][0] for i in range(EVAL_BIG_BATCH)])
    off = exp.get_forward_fn(model)
    # what running the eval's convolutions without cuDNN costs: the
    # dual-frame forward at B = 8, ms per image, cuDNN on and off
    x8 = torch.from_numpy(imgs8).cuda()
    cudnn_cost = {}
    with torch.inference_mode():
        for name, on in (("cudnn_ms_per_image", True), ("cudnn_off_ms_per_image", False)):
            with torch.backends.cudnn.flags(enabled=on, benchmark=on):
                cudnn_cost[name] = time_cuda(lambda: model(x8, mode="off_pipe"),
                                             iters=5) / EVAL_BATCH
    cands = {}
    with torch.inference_mode():
        for b, imgs in ((EVAL_BATCH, imgs8), (EVAL_BIG_BATCH, imgs64)):
            _, boxes, valid = select_candidates(off(imgs), NCLS, CONF, EVAL_TOPK)
            check(boxes.shape == (b, EVAL_TOPK, 4), f"K = {boxes.shape[1]}, not {EVAL_TOPK}")
            cands[b] = (boxes, valid)
    checked = sum(b1_exact(*cands[b], NMS, f"eval K={EVAL_TOPK} B={b}") for b in cands)

    times = {}
    for b, (boxes, valid) in cands.items():
        nms_bound, nms_by = bound_ms(boxes.numel() * 4 + valid.numel() * 2,
                                     iou_evaluations(boxes, valid, NMS) * NMS_OPS_PER_IOU)
        single = time_cuda(lambda: nms_keep(boxes, valid, NMS), iters=200, device_only=True)
        b2b = time_back_to_back(lambda: nms_keep(boxes, valid, NMS))
        times[f"b{b}"] = {
            "shape": f"B={b} K={EVAL_TOPK} valid={int(valid.sum())}, candidates of the eval",
            "ms": single, "ms_back_to_back": b2b,
            "plain_ms": time_cuda(lambda: nms_padded(boxes, valid, NMS), iters=20),
            "bound_ms": nms_bound, "bound_by": nms_by,
            "bound_share_single": nms_bound / single, "bound_share_back_to_back": nms_bound / b2b,
            "floor_ms": floor}

    # fp32 on the card (TF32 off): the first-batch guard at the fp32
    # tolerance (1e-4 px, 1e-4), and seq predictions on a 2-frame batch
    # against the CPU's
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    exp32 = get_exp(exp_name=EVAL_CONFIG)
    m32 = exp32.get_model("cuda")
    m32.load_state_dict(state)
    lift_pred_biases(m32)
    m_cpu = exp32.get_model("cpu")
    m_cpu.load_state_dict(m32.state_dict())
    shifts = support_shifts(dataset)
    fwd32 = exp32.get_dedup_forward_fn(m32, dataset)
    with torch.inference_mode():
        fwd32(imgs8, ids8)  # raises beyond the fp32 guard
        x2 = torch.from_numpy(imgs8[:2, ..., :3].copy())
        s2 = torch.from_numpy(shifts[:2].astype(np.int64))
        g2, _ = m32(x2.cuda(), mode="seq", support_shift=s2.cuda())
        c2, _ = m_cpu(x2, mode="seq", support_shift=s2)
    torch.backends.cudnn.allow_tf32 = True
    seq_vs_cpu = fp32_errors(g2.cpu(), c2)
    check(seq_vs_cpu["box_rel_err"] < 1e-3 and seq_vs_cpu["prob_abs_err"] < 1e-4,
          f"fp32 seq on the card vs the CPU out of bound: {seq_vs_cpu}")
    fp32_guard = {"box_diff": fwd32.last_guard[0], "score_diff": fwd32.last_guard[1],
                  "tolerance": list(exp32.dedup_tolerance())}
    del m32, m_cpu, fwd32
    emit("offline_eval", config=EVAL_CONFIG, model=f"StreamYOLO-{MODEL_SIZE}", input=list(INPUT),
         dtype="bfloat16", fixture=f"{EVAL_SEQS}x{EVAL_FRAMES} frames {raw_size[0]}x{raw_size[1]} "
         "synthetic, in memory", batch=EVAL_BATCH, pre_nms_topk=EVAL_TOPK, runs=runs,
         rows_equal=True, dual_frame_forward_b8=cudnn_cost,
         b1_exact_entries=checked, fp32_guard_b8=fp32_guard,
         fp32_seq_card_vs_cpu=seq_vs_cpu)
    return {"launches": launches, "times": times}


class SplitFrames:
    """``load_frame`` over in-memory synthetic splits: an image dict's
    ``split`` key names the ``SyntheticArgoverse`` that renders it (a class,
    so that spawned loader workers can unpickle it)."""

    def __init__(self, **synths):
        self.synths = synths

    def __call__(self, img):
        return self.synths[img["split"]].frame(img)


def train_synths() -> dict:
    """The train phase's splits, in memory: 2x24 train and 2x11 val raw
    1200x1920 synthetic frames (seeds ``SEED + 1`` and ``SEED``)."""
    from streamyolo_torch.data import SyntheticArgoverse

    raw_size = (2 * INPUT[0], 2 * INPUT[1])
    return {"train": SyntheticArgoverse(seq_lens=(TRAIN_FRAMES,) * TRAIN_SEQS, size=raw_size,
                                        seed=SEED + 1),
            "val": SyntheticArgoverse(seq_lens=(EVAL_FRAMES,) * EVAL_SEQS, size=raw_size,
                                      seed=SEED)}


def train_fixture(out_dir: Path) -> "SplitFrames":
    """``train_synths``' annotation jsons under ``out_dir``; returns their
    ``load_frame``."""
    synths = train_synths()
    ann_dir = out_dir / "Argoverse-HD" / "annotations"
    ann_dir.mkdir(parents=True, exist_ok=True)
    for split, synth in synths.items():
        images = [dict(img, split=split) for img in synth.data["images"]]
        (ann_dir / f"{split}.json").write_text(json.dumps(dict(synth.data, images=images)))
    return SplitFrames(**synths)


def train_init(exp):
    """The training run's start: the config's seeded float32 state dict with
    the cls prediction biases 0, so the eval scores (obj ~0.01 x cls ~0.5)
    clear its conf. The obj biases keep their prior: at 0 every anchor's
    objectness loss is ~50x larger, and its gradient through the shared
    head dominates a short run."""
    import torch

    state = exp.init_model()
    for k in state:
        if k.startswith("head.cls_preds.") and k.endswith(".bias"):
            state[k] = torch.zeros_like(state[k])
    return state


def synthetic_labels(rng, b, hw, m=10):
    """[b, m, 5] (cls, cx, cy, w, h) current and support labels, 3..m boxes."""
    labels = np.zeros((b, m, 5), np.float32)
    for i in range(b):
        k = int(rng.randint(3, m + 1))
        labels[i, :k, 0] = rng.randint(0, NCLS, k)
        labels[i, :k, 1] = rng.uniform(0.1, 0.9, k) * hw[1]
        labels[i, :k, 2] = rng.uniform(0.1, 0.9, k) * hw[0]
        labels[i, :k, 3:5] = rng.uniform(0.05, 0.3, (k, 2)) * hw[0]
    support = labels.copy()
    support[..., 1:3] += rng.normal(0, 2, support[..., 1:3].shape).astype(np.float32)
    support[labels.sum(-1) == 0] = 0.0
    return labels, support


def overfit_ratio(model, batch, fp16: bool) -> dict:
    """The JAX package's overfit recipe (tests/test_train.py): one fixed
    batch, ``OVERFIT_STEPS`` SGD steps at a constant LR; the first and last
    total loss."""
    from streamyolo_torch.train import build_lr_schedule, create_train_state, make_train_step

    state = create_train_state(model.train())
    step = make_train_step(NCLS, build_lr_schedule("constant", OVERFIT_LR, 10, 100), fp16=fp16)
    losses = [float(step(state, batch)["total_loss"]) for _ in range(OVERFIT_STEPS)]
    finite = [v for v in losses if np.isfinite(v)]
    return {"first": losses[0], "last": losses[-1], "ratio": losses[-1] / losses[0],
            "min": min(finite), "finite_steps": len(finite)}


@contextlib.contextmanager
def eval_loaders_in_process():
    """Within: every ``StreamExp`` eval loader is built with no worker
    processes (the val frames are in memory, and a spawn of loader workers
    costs ~40 s on the card's host), while the train loader keeps its
    ``data_num_workers``."""
    from streamyolo_torch.exp.stream_exp import StreamExp

    build = StreamExp.get_eval_loader

    def in_process(self, *args, **kwargs):
        workers, self.data_num_workers = self.data_num_workers, 0
        try:
            return build(self, *args, **kwargs)
        finally:
            self.data_num_workers = workers

    StreamExp.get_eval_loader = in_process
    try:
        yield
    finally:
        StreamExp.get_eval_loader = build


def phase_train(out_dir: Path) -> dict:
    """Training through ``streamyolo_torch.tools.train``'s entry, in process:
    StreamYOLO-l at full width (``l_s50_onex_dfp_tal_filp``), ``--fp16``
    (bf16 autocast, float32 master weights), batch 8, 2 epochs of the
    config's multiscale sizes on 2x24 raw 1200x1920 synthetic train frames,
    the first on the mosaic branch (the loader workers build each item as
    four letterboxed pairs on a 1200x1920 canvas warped back to 600x960,
    in NumPy: the card's host has no cv2), the EMA eval after each epoch
    (sequential-dedup, guard armed) on the offline eval's 2x11 val frames,
    all in memory (annotation jsons under ``build/``). Before it, the host
    ms of a mosaic pair item at 600x960 and the SHA-256 of
    ``tools/augment_check.py``'s samples against the constant the CPU tests
    pin to cv2's bytes; after it, no cv2 in ``sys.modules``.
    Checks finite losses, B1 once per eval batch per epoch (B2 never), at
    least two input sizes, the checkpoints, ``--resume`` (step and epoch),
    and the eval CLI's COCO rows on ``latest_ckpt.pth`` against the
    trainer's own evaluator on its in-memory EMA model, both with cuDNN off.
    Then one float32 train step (TF32 off) of the card against the CPU, the
    overfit recipe on the card, and the times."""
    import torch

    from streamyolo_torch.exp import get_exp
    from streamyolo_torch.models.losses import assign_outputs, streamyolo_losses
    from streamyolo_torch.ops.nms_cuda import nms_keep
    from streamyolo_torch.ops.preproc import downsample2x
    from streamyolo_torch.tools import eval as eval_tool
    from streamyolo_torch.tools import train as train_tool

    raw_size = (2 * INPUT[0], 2 * INPUT[1])
    load_frame = train_fixture(out_dir)

    exp = get_exp(exp_name=EVAL_CONFIG).merge(["data_dir", str(out_dir), "data_num_workers", "0"])
    dataset = exp.get_data_loader(batch_size=2, no_aug=True, load_frame=load_frame).dataset

    def batch_of(indices):
        items = [dataset[i] for i in indices]
        return {"images": torch.from_numpy(np.stack([it[0] for it in items])).cuda(),
                "labels": torch.from_numpy(np.stack([it[1][0] for it in items])).cuda(),
                "support_labels": torch.from_numpy(np.stack([it[1][1] for it in items])).cuda()}

    # the mosaic on the card's host: items of the pair wrapper's mosaic
    # branch at 600x960 from the 1200x1920 frames, and the augment samples'
    # digest (mosaic + mixup + HSV, the perspective warp, --cache)
    from streamyolo_torch.tools import augment_check

    wrapper = exp.dataset  # the MosaicDetection under the loader's index unpacking
    wrapper.enable_mosaic = True
    random.seed(SEED)
    mosaic_ms = []
    for i in range(MOSAIC_TIMED_SAMPLES):
        t = time.perf_counter()
        item = wrapper[i]
        mosaic_ms.append(1e3 * (time.perf_counter() - t))
    check(item[0].shape == (*INPUT, 6), f"a mosaic item is {item[0].shape}")
    wrapper.enable_mosaic = False
    aug_dir = out_dir / "augment_check"
    if aug_dir.exists():
        import shutil

        shutil.rmtree(aug_dir)
    digest = augment_check.port_digest(str(aug_dir))
    check(digest == augment_check.AUGMENT_DIGEST,
          f"augment samples digest {digest} is not cv2's {augment_check.AUGMENT_DIGEST}")

    init = train_init(exp)
    torch.save(init, out_dir / "init.pth")
    cfg = f"cfgs/{EVAL_CONFIG}.py"
    # the eval keeps every candidate above 1e-4 (obj ~0.01 x cls ~0.5 at the
    # start), so the eval of the short run has rows to compare
    data_opts = ["data_dir", str(out_dir), "output_dir", str(out_dir / "runs"),
                 "test_conf", str(TRAIN_TEST_CONF)]
    train_opts = [*data_opts, "max_epoch", str(TRAIN_EPOCHS),
                  "no_aug_epochs", str(TRAIN_NO_AUG_EPOCHS),
                  "warmup_epochs", "1", "data_num_workers", str(TRAIN_WORKERS),
                  "save_history_ckpt", "False", "print_interval", "3", "seed", str(SEED)]
    run_dir = out_dir / "runs" / "train"

    nms_keep.launches = 0
    downsample2x.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with eval_loaders_in_process():
        trainer = train_tool.main(["-f", cfg, "-b", str(TRAIN_BATCH), "--fp16", "-d", "1",
                                   "-expn", "train", "-c", str(out_dir / "init.pth"),
                                   *train_opts], load_frame=load_frame)
    torch.cuda.synchronize()
    train_wall_s = time.perf_counter() - t0
    launches = {"nms": nms_keep.launches, "preproc": downsample2x.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_eval_batches = len(trainer.evaluator.dataloader)
    steps = TRAIN_EPOCHS * trainer.max_iter
    check(trainer.max_iter == TRAIN_SEQS * TRAIN_FRAMES // TRAIN_BATCH and trainer.state.step == steps,
          f"trained {trainer.state.step} steps, not {steps}")
    check(launches == {"nms": TRAIN_EPOCHS * n_eval_batches, "preproc": 0},
          f"train: kernel launches {launches} for {TRAIN_EPOCHS} evals of {n_eval_batches} batches")
    logged = list(trainer.meter["total_loss"]._deque) + [float(trainer._last_metrics["total_loss"])]
    check(all(np.isfinite(v) for v in logged), f"train: a loss is not finite: {logged}")
    check(all(p.dtype == torch.float32 for p in trainer.model.parameters())
          and trainer.eval_model.dtype == torch.bfloat16,
          "train: master weights not float32 or eval modules not bf16")
    by_size, data_ms = {}, []
    for size, ms, wait in trainer.step_log:
        by_size.setdefault(size, []).append(ms)
        data_ms.append(wait)
    check(len(by_size) >= 2 and tuple(INPUT) in by_size,
          f"multiscale ran the sizes {sorted(by_size)}, not two or more with {INPUT}")
    for name in ("latest_ckpt.pth", "last_epoch_ckpt.pth"):
        check((run_dir / name).is_file(), f"train: {name} not written")
    check(not list(run_dir.glob("*.tmp")), "train: a temporary checkpoint was left behind")
    check([e["epoch"] for e in trainer.eval_history] == list(range(1, TRAIN_EPOCHS + 1)),
          "train: not one eval per epoch")
    mosaic_epochs = torch.load(run_dir / "last_mosaic_epoch_ckpt.pth")["start_epoch"] - 1
    check(mosaic_epochs == TRAIN_EPOCHS - 1 and trainer.no_aug,
          f"train: {mosaic_epochs} mosaic epochs, not {TRAIN_EPOCHS - 1}")
    check("cv2" not in sys.modules or sys.modules["cv2"] is None,
          "train: cv2 was imported on the mosaic path")

    # --resume: step and epoch restored (max_epoch reached: no further step)
    with eval_loaders_in_process():
        resumed = train_tool.main(["-f", cfg, "-b", str(TRAIN_BATCH), "--fp16", "-d", "1",
                                   "-expn", "train", "--resume", *train_opts],
                                  load_frame=load_frame)
    check(resumed.start_epoch == TRAIN_EPOCHS and resumed.state.step == steps
          and resumed.best_ap == trainer.best_ap,
          f"--resume restored epoch {resumed.start_epoch}, step {resumed.state.step}")
    check(all(torch.equal(v, trainer.state.ema.state[k])
              for k, v in resumed.state.ema.state.items()), "--resume: the EMA differs")
    del resumed

    # the eval CLI on the checkpoint against the trainer's own evaluator on
    # its in-memory EMA model, both on PyTorch's own convolution (the eval
    # forwards run cuDNN off on a card: an image then rounds alike at every
    # batch row; eval/seq_forward.py::per_image_convolution)
    fwd = trainer.exp.get_dedup_forward_fn(trainer.eval_model, trainer.evaluator.dataset)
    (ap, _, _), rows_trainer = trainer.evaluator.evaluate(fwd, return_outputs=True)
    cli = eval_tool.main(["-f", cfg, "-c", str(run_dir / "latest_ckpt.pth"), "-b",
                          str(TRAIN_BATCH), "--fp16", "-expn", "eval_ckpt", *data_opts,
                          "data_num_workers", "0"], load_frame=load_frame)
    # random weights: the eval-mode trunk normalises each frame by running
    # statistics of other frames, and a random trunk amplifies that
    # difference until some boxes' exp(w, h) may overflow; scores stay
    # finite, and a NaN anywhere would fail the equality
    inf_rows = sum(not np.isfinite(r["bbox"]).all() for r in rows_trainer)
    check(len(rows_trainer) > 0 and all(np.isfinite(r["score"]) for r in rows_trainer)
          and not any(np.isnan(r["bbox"]).any() for r in rows_trainer),
          f"train: the eval's {len(rows_trainer)} rows hold a NaN or a non-finite score")
    check(cli["rows"] == rows_trainer,
          f"eval -c latest_ckpt.pth: {len(cli['rows'])} rows against the trainer's "
          f"{len(rows_trainer)}, not equal")

    warm = {f"{h}x{w}": ms[1:] for (h, w), ms in by_size.items()}
    step_ms = statistics.median(warm[f"{INPUT[0]}x{INPUT[1]}"])
    # the data wait's share of (wait + device step) per epoch, mosaic then
    # plain, over the steps after the first (which waits for the epoch's
    # loader workers to start)
    per_epoch = [trainer.step_log[e * trainer.max_iter + 1:(e + 1) * trainer.max_iter]
                 for e in range(TRAIN_EPOCHS)]
    wait_share = [sum(w for _, _, w in ep) / sum(w + ms for _, ms, w in ep) for ep in per_epoch]
    times = {"step_ms_600x960": step_ms,
             "images_per_s_600x960": TRAIN_BATCH * 1e3 / step_ms,
             "step_ms_warm_by_size": {k: statistics.median(v) for k, v in warm.items() if v},
             "steps_timed_by_size": {k: len(v) for k, v in warm.items()},
             "data_wait_ms_per_step": data_ms,
             "data_wait_ms_median": statistics.median(data_ms),
             "data_wait_share_mosaic_epoch": wait_share[0],
             "data_wait_share_plain_epoch": wait_share[-1],
             "data_wait_ms_median_mosaic_epoch": statistics.median(
                 w for _, _, w in per_epoch[0]),
             "data_wait_ms_median_plain_epoch": statistics.median(
                 w for _, _, w in per_epoch[-1]),
             "mosaic_host_ms_per_item": mosaic_ms,
             "mosaic_host_ms_per_item_median": statistics.median(mosaic_ms),
             "host_iter_ms_per_step": 1e3 * trainer.meter["iter_time"].global_avg,
             "peak_device_memory_gb": peak_gb,
             "eval_ms_per_image_by_epoch": [e["ms_per_image"] for e in trainer.eval_history],
             "train_wall_s": train_wall_s}
    del trainer, fwd
    torch.cuda.empty_cache()

    # float32 on the card against the CPU, TF32 off, cuDNN's deterministic
    # algorithms: one train step of the full-width model from the same
    # weights on a 192x320 batch of 2, and the card in float64 as the
    # reference both float32 runs approximate
    rng = np.random.RandomState(SEED)
    images = torch.from_numpy(rng.randint(0, 256, (GRAD_BATCH, *GRAD_INPUT, 6), np.uint8))
    labels, support = (torch.from_numpy(a) for a in synthetic_labels(rng, GRAD_BATCH, GRAD_INPUT))
    runs = {}
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        for name, dev, dtype in (("card", "cuda", torch.float32), ("card64", "cuda", torch.float64),
                                 ("cpu", "cpu", torch.float32)):
            model = exp.get_model(dev, dtype=dtype)
            model.load_state_dict(init)
            model.train()
            outputs = model(images.to(dev), mode="off_pipe")
            assign = assign_outputs(outputs, labels.to(dev), NCLS)
            losses = streamyolo_losses(outputs, labels.to(dev), support.to(dev), NCLS,
                                       gamma=exp.tal_gamma, ignore_thr=exp.tal_ignore_thr,
                                       ignore_value=exp.tal_ignore_value)
            losses["total_loss"].backward()
            runs[name] = {"fg": assign.fg_mask.cpu(),
                          "losses": {k: float(v.detach()) for k, v in losses.items()},
                          "grads": {n: p.grad.cpu().double() for n, p in model.named_parameters()}}
            del model, outputs, losses

    def grad_gaps(a, b):
        rel = {n: float((g - b[n]).abs().max() / b[n].abs().max().clamp(min=1e-30))
               for n, g in a.items()}
        worst = max(rel, key=rel.get)
        return {"max": rel[worst], "worst": worst, "median": statistics.median(rel.values())}

    gpu, cpu, ref = runs["card"], runs["cpu"], runs["card64"]
    loss_rel = {k: abs(gpu["losses"][k] - v) / max(abs(v), 1e-12) for k, v in cpu["losses"].items()}
    card_vs_cpu = {"fg_equal": bool(torch.equal(gpu["fg"], cpu["fg"])),
                   "fg_equal_float64": bool(torch.equal(gpu["fg"], ref["fg"])),
                   "num_fg": int(cpu["fg"].sum()), "loss_rel_max": max(loss_rel.values()),
                   "loss_rel": loss_rel, "grad_rel": grad_gaps(cpu["grads"], gpu["grads"]),
                   "card_vs_float64": grad_gaps(gpu["grads"], ref["grads"]),
                   "cpu_vs_float64": grad_gaps(cpu["grads"], ref["grads"]),
                   "grad_tensors": len(gpu["grads"])}
    del runs, gpu, cpu, ref

    # the learning signal: the JAX package's overfit recipe at its own size
    # (depth 0.33, width 0.25, 64x96, batch 2), float32 and bf16; last < 0.5 first
    small = get_exp(exp_name="s_s50_onex_dfp_tal_flip").merge(["depth", "0.33", "width", "0.25"])
    rng = np.random.RandomState(0)
    lab = np.zeros((2, 8, 5), np.float32)
    lab[:, 0] = [2.0, 48.0, 32.0, 24.0, 18.0]
    lab[:, 1] = [5.0, 20.0, 50.0, 16.0, 12.0]
    fixed = {"images": torch.from_numpy(rng.randint(0, 255, (2, 64, 96, 6)).astype(np.float32)),
             "labels": torch.from_numpy(lab), "support_labels": torch.from_numpy(lab.copy())}
    fixed = {k: v.cuda() for k, v in fixed.items()}
    overfit = {}
    for name, fp16 in (("float32", False), ("bf16", True)):
        torch.backends.cudnn.allow_tf32 = fp16
        torch.backends.cuda.matmul.allow_tf32 = False
        model = small.get_model("cuda", dtype=torch.float32)
        model.load_state_dict(small.init_model())
        overfit[name] = overfit_ratio(model, fixed, fp16)
    torch.backends.cudnn.allow_tf32 = True
    # once more at full width, on two letterboxed synthetic train frames
    model = exp.get_model("cuda", dtype=torch.float32)
    model.load_state_dict(init)
    overfit["full_width_bf16"] = overfit_ratio(model, batch_of((0, TRAIN_FRAMES + 5)), True)
    del model

    emit("train", config=EVAL_CONFIG, model=f"StreamYOLO-{MODEL_SIZE}", input=list(INPUT),
         dtype="bf16 autocast, float32 master weights", batch=TRAIN_BATCH, epochs=TRAIN_EPOCHS,
         steps=steps, data_num_workers=TRAIN_WORKERS,
         fixture=f"train {TRAIN_SEQS}x{TRAIN_FRAMES}, val {EVAL_SEQS}x{EVAL_FRAMES} frames "
                 f"{raw_size[0]}x{raw_size[1]} synthetic, in memory",
         no_aug_epochs=TRAIN_NO_AUG_EPOCHS, mosaic_epochs=mosaic_epochs,
         augment_digest=digest, augment_digest_equal=True, cv2_loaded=False,
         sizes=sorted(f"{h}x{w}" for h, w in by_size), losses_logged=logged,
         eval_batches=n_eval_batches, launches=launches, eval_ap=100 * float(ap),
         eval_rows=len(rows_trainer), eval_rows_infinite_box=inf_rows,
         ckpt_rows_equal_cudnn_off=True,
         resume={"start_epoch": TRAIN_EPOCHS, "step": steps}, times=times,
         fp32_step_card_vs_cpu=card_vs_cpu, overfit=overfit)
    check(card_vs_cpu["fg_equal"], "SimOTA fg_mask on the card differs from the CPU's")
    # stated bounds: losses rtol 1e-3, every gradient within 1e-2 of its max |g|
    check(card_vs_cpu["loss_rel_max"] <= 1e-3, f"train step losses card vs CPU: {loss_rel}")
    check(card_vs_cpu["grad_rel"]["max"] <= 1e-2,
          f"train step gradient card vs CPU: {card_vs_cpu['grad_rel']}")
    for name in ("float32", "bf16"):
        check(np.isfinite(overfit[name]["last"]) and overfit[name]["ratio"] < 0.5,
              f"overfit ({name}): loss {overfit[name]['first']} -> {overfit[name]['last']}")
    return {"launches": launches}


def dp_exp(data_dir: Path):
    from streamyolo_torch.exp import get_exp

    return get_exp(exp_name=EVAL_CONFIG).merge(["data_dir", str(data_dir),
                                                "data_num_workers", "0"])


def dp_state_of(state) -> dict:
    """The state a train step updates, on the host, by name."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    return {"model": {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()},
            "ema": {k: v.cpu().clone() for k, v in state.ema.state.items()},
            "momentum": {names[id(p)]: s["momentum_buffer"].cpu().clone()
                         for p, s in state.optimizer.state.items()},
            "step": state.step}


def dp_tensors(state: dict):
    """(name, tensor) of every float tensor a step updates, in a fixed order."""
    return [(f"{part}.{k}", v) for part in ("model", "ema", "momentum")
            for k, v in state[part].items() if v.is_floating_point()]


def dp_same(a: dict, b: dict) -> bool:
    """Two step results hold the same bits."""
    import torch

    ta, tb = dp_tensors(a), dp_tensors(b)
    return (a["step"] == b["step"] and [k for k, _ in ta] == [k for k, _ in tb]
            and all(torch.equal(x, y) for (_, x), (_, y) in zip(ta, tb)))


def dp_digest(state: dict) -> str:
    """A hash of a step result's step count and float tensors."""
    from streamyolo_torch.parallel import tensors_digest

    return f"{state['step']}:{tensors_digest([v for _, v in dp_tensors(state)])}"


def dp_step(work: Path, device, rank: int = 0, world: int = 1, dtype: str = "float32",
            carried: str = "seeded", order=None, repeat: bool = True) -> dict:
    """One train step (TF32 off, cuDNN deterministic) of StreamYOLO-l in
    ``dtype`` from ``work/carried_{carried}.pth`` on the rank's slice of
    ``work/batch.npz`` (its rows in ``order`` first, if given); with
    ``repeat`` run twice from the same state (the first warms up and shows
    whether the step repeats bit for bit). The last run's state, its
    digest, metrics and CUDA-event ms."""
    import torch

    from streamyolo_torch.parallel import shard_batch
    from streamyolo_torch.train import (
        build_lr_schedule,
        create_train_state,
        load_carried_state,
        make_train_step,
    )

    exp = dp_exp(work)
    carried = torch.load(work / f"carried_{carried}.pth")
    with np.load(work / "batch.npz") as f:
        batch = {k: torch.from_numpy(f[k] if order is None else f[k][list(order)])
                 for k in f.files}
    batch = {k: v.to(device) for k, v in shard_batch(batch, rank, world).items()}
    step = make_train_step(NCLS, build_lr_schedule("constant", exp.basic_lr_per_img * DP_BATCH,
                                                   10, 10),
                           gamma=exp.tal_gamma, ignore_thr=exp.tal_ignore_thr,
                           ignore_value=exp.tal_ignore_value)
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = []
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        model = exp.get_model(device, dtype=getattr(torch, dtype))
        state = create_train_state(model)
        for _ in range(2 if repeat else 1):
            load_carried_state(state, carried)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            metrics = step(state, batch)
            end.record()
            end.synchronize()
            runs.append({"state": dp_state_of(state), "ms": start.elapsed_time(end),
                         "metrics": {k: float(v) for k, v in metrics.items()}})
    torch.backends.cuda.matmul.allow_tf32 = True
    out = runs[-1]
    out["digest"] = dp_digest(out["state"])
    out["repeats_bitwise"] = dp_same(runs[0]["state"], runs[-1]["state"]) if repeat else None
    out["first_ms"] = runs[0]["ms"]
    return out


def dp_normwise(a: dict, b: dict) -> dict:
    """Per tensor ``||a - b|| / ||b||`` (in float64) of two step results."""
    rel = {}
    for (k, x), (_, y) in zip(dp_tensors(a), dp_tensors(b)):
        x, y = x.double(), y.double()
        rel[k] = float((x - y).norm() / max(float(y.norm()), 1e-6))
    return rel


def dp_spread(rel: dict) -> dict:
    """Percentiles of the momentum buffers' gaps, and how many pass 1e-3."""
    v = np.array([x for k, x in rel.items() if k.startswith("momentum.")])
    return {q: float(np.percentile(v, q)) for q in (50, 90, 99, 100)} | {
        "over_1e-3": int((v > 1e-3).sum()), "tensors": int(v.size)}


def dp_seeded_bn(state: dict) -> dict:
    """``state`` with every BatchNorm's weight, bias and running statistics
    drawn from a seeded generator (the CPU parity tests' ``randomize_bn``)."""
    import torch

    rng = np.random.RandomState(SEED + 8)
    draw = {"weight": lambda n: rng.uniform(0.5, 1.5, n), "bias": lambda n: rng.normal(0, 0.1, n),
            "running_mean": lambda n: rng.normal(0, 0.1, n),
            "running_var": lambda n: rng.uniform(0.5, 1.5, n)}
    out = dict(state)
    for k, v in state.items():
        part = k.rsplit(".", 1)
        if ".bn." in k and part[1] in draw:
            out[k] = torch.from_numpy(draw[part[1]](v.numel()).astype(np.float32)).view(v.shape)
    return out


def dp_train_argv(work: Path, rank: int, port: int) -> list:
    """``tools/train.py`` as a user calls it on one rank of two machines."""
    return ["-f", f"cfgs/{EVAL_CONFIG}.py", "-b", str(TRAIN_BATCH), "--fp16", "-d", "1",
            "--num_machines", "2", "--machine_rank", str(rank),
            "--dist-url", f"tcp://127.0.0.1:{port}", "--dist-backend", "gloo",
            "-expn", "dp", "-c", str(work / "init.pth"),
            "data_dir", str(work), "output_dir", str(work / "runs"),
            "test_conf", str(TRAIN_TEST_CONF), "max_epoch", "1", "no_aug_epochs", "1",
            "warmup_epochs", "1", "data_num_workers", "0", "random_size", "None",
            "save_history_ckpt", "False", "print_interval", "3", "seed", str(SEED)]


def dp_rank_main(argv) -> int:
    """One rank process of phase ``data_parallel``:
    ``chip_smoke.py --dp-rank RANK WORK BACKEND CARD STEP_PORT [TRAIN_PORT EVAL_PORT]``.
    Joins a group of two over ``BACKEND`` on card ``CARD`` and runs the
    step of every case of ``DP_CASES`` (``dp_step``; rank 1 keeps only the
    digests of its states); with the train ports, then runs
    ``tools/train.py`` as rank RANK of two machines (its own group) and the
    sharded eval of its EMA model once more (a third group) to gather the
    COCO rows. Writes ``WORK/rank{RANK}_{BACKEND}.pth``."""
    import torch

    from streamyolo_torch import parallel
    from streamyolo_torch.ops.nms_cuda import nms_keep
    from streamyolo_torch.tools import train as train_tool

    rank, work, backend, card, step_port = (int(argv[0]), Path(argv[1]), argv[2], int(argv[3]),
                                            int(argv[4]))
    device = parallel.init_distributed(backend, f"tcp://127.0.0.1:{step_port}", 2, rank,
                                       local_rank=card, timeout_s=DP_TIMEOUT_S)
    out = {"steps": {}}
    try:
        for case, (carried, dtype) in DP_CASES.items():
            step = dp_step(work, device, rank, 2, dtype=dtype, carried=carried,
                           repeat=case == "seeded_float32")
            if rank:
                del step["state"]
            out["steps"][case] = step
            torch.cuda.empty_cache()
    finally:
        parallel.destroy()
    if len(argv) > 5:
        train_port, eval_port = int(argv[5]), int(argv[6])
        load_frame = SplitFrames(**train_synths())  # the parent wrote the jsons
        nms_keep.launches = 0
        t0 = time.perf_counter()
        trainer = train_tool.main(dp_train_argv(work, rank, train_port), load_frame=load_frame)
        torch.cuda.synchronize()
        out["train"] = {"wall_s": time.perf_counter() - t0, "b1_launches": nms_keep.launches,
                        "eval_batches": len(trainer.evaluator.dataloader),
                        "eval_images": len(trainer.evaluator.dataloader.dataset),
                        "eval_history": trainer.eval_history, "steps": trainer.state.step,
                        "step_ms": [ms for _, ms, _ in trainer.step_log],
                        "state": dp_state_of(trainer.state)}
        parallel.init_distributed("gloo", f"tcp://127.0.0.1:{eval_port}", 2, rank,
                                  local_rank=card, timeout_s=DP_TIMEOUT_S)
        try:
            fwd = trainer.exp.get_forward_fn(trainer.eval_model)
            (ap, ap50, _), rows = trainer.evaluator.evaluate(fwd, return_outputs=True)
        finally:
            parallel.destroy()
        out["gathered"] = {"ap": float(ap), "ap50": float(ap50), "rows": rows}
    torch.save(out, work / f"rank{rank}_{backend}.pth")
    return 0


def dp_ranks(work: Path, backend: str, cards, train: bool) -> list:
    """Run the two rank processes of ``dp_rank_main`` to their end (their
    output in ``work/rank{r}_{backend}.log``); any non-zero exit or a
    timeout fails; returns their results and logs."""
    from streamyolo_torch.parallel import free_local_port

    ports = [str(free_local_port()) for _ in range(3 if train else 1)]
    procs, logs = [], []
    try:
        for rank in (0, 1):
            log = open(work / f"rank{rank}_{backend}.log", "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--dp-rank", str(rank),
                 str(work), backend, str(cards[rank]), *ports],
                cwd=str(Path(__file__).resolve().parent), stdout=log,
                stderr=subprocess.STDOUT, text=True))
        deadline = time.monotonic() + DP_TIMEOUT_S
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
    texts = []
    for log in logs:
        log.seek(0)
        texts.append(log.read())
        log.close()
    for rank, (p, text) in enumerate(zip(procs, texts)):
        check(p.returncode == 0, f"data_parallel: {backend} rank {rank} exited {p.returncode}:\n"
                                 f"{text[-3000:]}")
    import torch

    return [torch.load(work / f"rank{r}_{backend}.pth", weights_only=False) for r in (0, 1)], texts


def dp_compare(ranks: list, case: str, single: dict, single64: dict) -> dict:
    """The two ranks' step of ``case`` against each other (bitwise) and
    against one process over the whole batch in the same dtype (``single``):
    ``num_fg``, the loss, and per tensor normwise. The weights, BatchNorm
    statistics and EMA (``state_*``) apart from the momentum buffers (this
    step's gradients), which are also held by their distance from the
    float64 step (``single64``) beside the one process's
    (``momentum_excess``)."""
    s0, s1 = ranks[0]["steps"][case], ranks[1]["steps"][case]
    ref = single["metrics"]
    rel = dp_normwise(s0["state"], single["state"])
    state_rel = {k: v for k, v in rel.items() if not k.startswith("momentum.")}
    mom_rel = {k: v for k, v in rel.items() if k.startswith("momentum.")}
    dp64 = dp_normwise(s0["state"], single64["state"])
    one64 = dp_normwise(single["state"], single64["state"])
    excess = {k: dp64[k] - one64[k] for k in mom_rel}
    worst, worst_m, worst_e = (max(d, key=d.get) for d in (state_rel, mom_rel, excess))
    return {"ranks_bitwise": s0["digest"] == s1["digest"] and s0["metrics"] == s1["metrics"],
            "num_fg_equal": s0["metrics"]["num_fg"] == ref["num_fg"],
            "num_fg": ref["num_fg"],
            "loss_rel": abs(s0["metrics"]["total_loss"] - ref["total_loss"])
            / abs(ref["total_loss"]),
            "state_normwise_max": state_rel[worst], "state_normwise_worst": worst,
            "state_tensors": len(state_rel),
            "momentum_normwise_max": mom_rel[worst_m], "momentum_normwise_worst": worst_m,
            "momentum_excess_max": excess[worst_e], "momentum_excess_worst": worst_e,
            "momentum_vs_float64": [dp64[worst_e], one64[worst_e]],
            "momentum_tensors": len(mom_rel),
            "normwise_median": statistics.median(rel.values()),
            "step_ms_by_rank": [s0["ms"], s1["ms"]],
            "repeats_bitwise_by_rank": [s0["repeats_bitwise"], s1["repeats_bitwise"]]}


def dp_ok(c: dict) -> bool:
    """The stated bounds of a two-rank float32 step: ``num_fg`` equal, the
    loss rel 1e-4, the weights, BatchNorm statistics and EMA normwise 1e-3,
    the momentum no more than 1e-3 farther from float64 than one process's,
    the ranks bitwise equal."""
    return (c["num_fg_equal"] and c["loss_rel"] <= 1e-4 and c["state_normwise_max"] <= 1e-3
            and c["momentum_excess_max"] <= 1e-3 and c["ranks_bitwise"])


def dp_ok64(c: dict) -> bool:
    """The stated bounds of a two-rank float64 step: ``num_fg`` equal, the
    loss rel 1e-4, every tensor, the momentum buffers too, normwise within
    ``DP_FLOAT64_NORMWISE`` of one float64 process, the ranks bitwise
    equal."""
    return (c["num_fg_equal"] and c["loss_rel"] <= 1e-4 and c["ranks_bitwise"]
            and max(c["state_normwise_max"], c["momentum_normwise_max"]) <= DP_FLOAT64_NORMWISE)


def phase_data_parallel(work: Path, smi: str) -> dict:
    """Data-parallel training through ``streamyolo_torch/parallel`` at full
    width (StreamYOLO-l, 600x960) on the card.

    (a) One step (TF32 off) over a global batch of 4 letterboxed synthetic
    train frames from each of two carried states (the seeded init with
    seeded or with identity BatchNorm, after one step), in float32 and in
    float64: two rank processes on the one card over gloo (2 images each)
    against one process over the 4; and a NCCL group of one on the card.
    Every case: ``num_fg`` equal, the loss within rel 1e-4, the ranks
    bitwise equal. Float64: every tensor, momentum buffers too, normwise
    within ``DP_FLOAT64_NORMWISE`` of one process (the data-parallel
    algorithm apart from float32 rounding). Float32 from the seeded state:
    the weights, BatchNorm statistics and EMA normwise within 1e-3 per
    tensor, each momentum buffer within 1e-3 of the one-process step's
    distance from the same step in float64 (the one process with its batch
    reordered already parts from itself by more than 1e-3 on the momentum
    buffers, reported as ``float32_noise``); from the identity state the
    float32 gaps are reported. NCCL at world 1 bitwise the step with no
    group. Over NCCL across two cards where there are two, else reported
    not run.
    (b) ``tools/train.py`` as a user calls it, in each of two rank
    processes (``--num_machines 2 --dist-backend gloo -d 1 -b 8 --fp16``):
    one epoch at 600x960 on the train phase's frames, the sharded per-epoch
    eval (B1 in every rank), checkpoints and log from rank 0 only, and rank
    0's gathered COCO rows against a one-process ``tools/eval.py
    --no-dedup`` of the checkpoint (both cuDNN off)."""
    import torch

    from streamyolo_torch import parallel
    from streamyolo_torch.tools import eval as eval_tool
    from streamyolo_torch.train import build_lr_schedule, create_train_state, make_train_step

    work.mkdir(parents=True, exist_ok=True)
    load_frame = train_fixture(work)
    exp = dp_exp(work)
    init = train_init(exp)
    torch.save(init, work / "init.pth")
    dataset = exp.get_data_loader(batch_size=2, no_aug=True, load_frame=load_frame).dataset
    random.seed(SEED)  # the pair's mirror coin
    items = [dataset[i] for i in (0, 5, TRAIN_FRAMES, TRAIN_FRAMES + 5)]
    np.savez(work / "batch.npz", images=np.stack([it[0] for it in items]),
             labels=np.stack([it[1][0] for it in items]),
             support_labels=np.stack([it[1][1] for it in items]))

    # the carried states: the seeded init with seeded or identity
    # BatchNorm, after one float32 step at 192x320
    rng = np.random.RandomState(SEED + 7)
    images = torch.from_numpy(rng.randint(0, 256, (GRAD_BATCH, *GRAD_INPUT, 6), np.uint8))
    labels, support = (torch.from_numpy(a) for a in synthetic_labels(rng, GRAD_BATCH, GRAD_INPUT))
    for name, weights in (("seeded", dp_seeded_bn(init)), ("identity", init)):
        model = exp.get_model("cuda", dtype=torch.float32)
        model.load_state_dict(weights)
        state = create_train_state(model)
        torch.backends.cuda.matmul.allow_tf32 = False
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                        allow_tf32=False):  # the same bits whatever ran before
            make_train_step(NCLS, build_lr_schedule("constant", exp.basic_lr_per_img * DP_BATCH,
                                                    10, 10))(
                state, {"images": images.cuda(), "labels": labels.cuda(),
                        "support_labels": support.cuda()})
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.save(dp_state_of(state), work / f"carried_{name}.pth")
        del model, state
        torch.cuda.empty_cache()

    # (a) one process over the 4 images in each case, then a NCCL group of one
    card = torch.device("cuda", 0)
    single = {case: dp_step(work, card, dtype=dtype, carried=carried,
                            repeat=case == "seeded_float32")
              for case, (carried, dtype) in DP_CASES.items()}
    torch.cuda.empty_cache()
    parallel.init_distributed("nccl", f"tcp://127.0.0.1:{parallel.free_local_port()}", 1, 0,
                              timeout_s=DP_TIMEOUT_S)
    try:
        nccl1 = dp_step(work, card)
        # the step runs no collective at world 1; one all-reduce on the card
        probe = torch.arange(1024, dtype=torch.float32, device="cuda")
        nccl1_sum_ok = torch.equal(parallel.all_reduce_sum_(probe.clone()), probe)
    finally:
        parallel.destroy()
    # the float32 noise of the step itself: the same 4 images in another order
    reordered = dp_step(work, card, order=(2, 3, 0, 1), repeat=False)
    torch.cuda.empty_cache()
    gloo, logs = dp_ranks(work, "gloo", (0, 0), train=True)
    one32, one64 = single["seeded_float32"], single["seeded_float64"]
    noise = {f"{name}_vs_float64": dp_spread(dp_normwise(state, one64["state"]))
             for name, state in (("ranks", gloo[0]["steps"]["seeded_float32"]["state"]),
                                 ("one", one32["state"]), ("reordered", reordered["state"]))}
    noise["reordered_vs_one"] = dp_spread(dp_normwise(reordered["state"], one32["state"]))
    noise["num_fg"] = {"reordered": reordered["metrics"]["num_fg"],
                       "float64": one64["metrics"]["num_fg"]}

    def compare(ranks):
        return {case: dp_compare(ranks, case, single[case],
                                 single[f"{DP_CASES[case][0]}_float64"]) for case in DP_CASES}

    a = {"gloo_one_card": compare(gloo),
         "one_process": {case: {"num_fg": r["metrics"]["num_fg"],
                                "total_loss": r["metrics"]["total_loss"], "step_ms": r["ms"],
                                "repeats_bitwise": r["repeats_bitwise"]}
                         for case, r in single.items()},
         "nccl_world1_bitwise_no_group": nccl1["digest"] == one32["digest"]
         and nccl1["metrics"] == one32["metrics"], "nccl_world1_step_ms": nccl1["ms"],
         "nccl_world1_all_reduce_ok": nccl1_sum_ok, "float32_noise": noise}
    del single, reordered, nccl1
    if torch.cuda.device_count() >= 2:
        nccl2, _ = dp_ranks(work, "nccl", (0, 1), train=False)
        a["nccl_two_cards"] = compare(nccl2)
    else:
        a["nccl_two_cards"] = "not run: one card"
        print("data_parallel: NCCL across two cards not run (one card)", flush=True)

    # (b) the CLI: writes from rank 0 only; the gathered rows against one process
    run_dir = work / "runs" / "dp"
    names = sorted(p.name for p in run_dir.iterdir())
    train0, train1 = gloo[0]["train"], gloo[1]["train"]
    cli = eval_tool.main(["-f", f"cfgs/{EVAL_CONFIG}.py", "-c", str(run_dir / "latest_ckpt.pth"),
                          "-b", str(TRAIN_BATCH), "--fp16", "--no-dedup", "-expn", "dp_eval",
                          "data_dir", str(work), "output_dir", str(work / "runs"),
                          "test_conf", str(TRAIN_TEST_CONF), "data_num_workers", "0"],
                         load_frame=load_frame)

    def key(row):
        return (row["image_id"], row["category_id"], -row["score"], row["bbox"])

    rows0 = sorted(gloo[0]["gathered"]["rows"], key=key)
    rows_one = sorted(cli["rows"], key=key)
    rows_equal = rows0 == rows_one
    exp16 = dp_exp(work)
    exp16.compute_dtype = "bfloat16"
    box_tol, score_tol = exp16.dedup_tolerance()
    gap = matched_rows(rows0, rows_one)
    gap["box_max_model_px"] = gap["box_max_abs"] / (2 * INPUT[1] / exp16.test_size[1])
    b = {"steps": train0["steps"], "eval_images_by_rank": [train0["eval_images"],
                                                           train1["eval_images"]],
         "b1_launches_by_rank": [train0["b1_launches"], train1["b1_launches"]],
         "eval_batches_by_rank": [train0["eval_batches"], train1["eval_batches"]],
         "run_dir": names, "rank0_wrote": "Save weights to" in logs[0],
         "rank1_wrote": "Save weights to" in logs[1],
         "ranks_bitwise": dp_same(train0["state"], train1["state"]),
         "epoch_ap": [train0["eval_history"][-1]["ap"], train1["eval_history"][-1]["ap"]],
         "gathered_ap": gloo[0]["gathered"]["ap"], "one_process_ap": cli["ap"],
         "rows": len(rows0), "rows_one_process": len(rows_one), "rows_equal": rows_equal,
         "rows_matched": gap,
         "step_ms_by_rank": [statistics.median(train0["step_ms"][1:]),
                             statistics.median(train1["step_ms"][1:])],
         "wall_s_by_rank": [train0["wall_s"], train1["wall_s"]]}
    emit("data_parallel", config=EVAL_CONFIG, model=f"StreamYOLO-{MODEL_SIZE}",
         input=list(INPUT), nvidia_smi=smi,
         step={"dtype": "float32 and float64, TF32 off, cuDNN deterministic",
               "global_batch": DP_BATCH, "ranks": 2, "float64_bound": DP_FLOAT64_NORMWISE, **a},
         cli={"flags": "--num_machines 2 --dist-backend gloo -d 1 -b 8 --fp16", **b},
         note="gloo on one card stages every collective through the host and runs two "
              "processes on one card: its step times are no measure of scaling")

    for where, cases in (("gloo on one card", a["gloo_one_card"]),
                         ("NCCL across two cards", a["nccl_two_cards"])):
        if not isinstance(cases, dict):
            continue
        for case, c in cases.items():
            what = f"data_parallel: {where}, {case}: {c}"
            check(c["num_fg_equal"], f"{what}: SimOTA's num_fg flipped")
            check(c["ranks_bitwise"] and c["loss_rel"] <= 1e-4, what)
            if case.endswith("float64"):
                check(dp_ok64(c), what)
        check(dp_ok(cases["seeded_float32"]), f"data_parallel: {where}: {cases['seeded_float32']}")
    check(a["nccl_world1_bitwise_no_group"] and a["nccl_world1_all_reduce_ok"],
          "data_parallel: NCCL at world 1 differs from no group")
    check(b["steps"] == TRAIN_SEQS * TRAIN_FRAMES // TRAIN_BATCH, f"data_parallel: {b['steps']} steps")
    check(b["ranks_bitwise"], "data_parallel: the CLI's ranks end with different states")
    check(b["b1_launches_by_rank"] == b["eval_batches_by_rank"] and min(b["eval_batches_by_rank"]) > 0,
          f"data_parallel: B1 launches {b['b1_launches_by_rank']} for eval batches "
          f"{b['eval_batches_by_rank']}")
    check(sum(b["eval_images_by_rank"]) == EVAL_SEQS * EVAL_FRAMES,
          f"data_parallel: the eval shards hold {b['eval_images_by_rank']} images")
    check(b["rank0_wrote"] and not b["rank1_wrote"]
          and {"latest_ckpt.pth", "last_epoch_ckpt.pth", "train_log.txt"} <= set(names),
          f"data_parallel: writes {names}, rank 0 {b['rank0_wrote']}, rank 1 {b['rank1_wrote']}")
    check(b["epoch_ap"][1] == 0.0 and b["epoch_ap"][0] == b["gathered_ap"],
          f"data_parallel: epoch AP {b['epoch_ap']} against the gathered {b['gathered_ap']}")
    check(len(rows0) > 0 and (rows_equal or (gap["box_max_model_px"] <= box_tol
                                             and gap["score_max_abs"] <= score_tol
                                             and gap["unmatched_share"] <= E2E_UNMATCHED_MAX)),
          f"data_parallel: gathered rows against one process: {gap}")
    return {"launches": sum(b["b1_launches_by_rank"]),
            "launches_by_rank": b["b1_launches_by_rank"]}


def lifted_state(exp):
    """The config's seeded float32 state dict with the obj/cls prediction
    biases 0 (as ``lift_pred_biases``: NMS then sees candidates)."""
    import torch

    state = exp.init_model()
    for k in state:
        if k.startswith(("head.obj_preds.", "head.cls_preds.")) and k.endswith(".bias"):
            state[k] = torch.zeros_like(state[k])
    return state


def serving_detector(fp32: bool):
    """StreamYOLO-l at 600x960 with ``device_preproc`` (B2, then B1), the
    seeded weights of ``EVAL_CONFIG`` with the prediction biases lifted, on
    the card; bf16 modules unless ``fp32``."""
    from streamyolo_torch.exp import get_exp
    from streamyolo_torch.stream import CUDAStreamDetector

    exp = get_exp(exp_name=EVAL_CONFIG)
    exp.compute_dtype = "float32" if fp32 else "bfloat16"
    model = exp.get_model("cuda")
    model.load_state_dict(lifted_state(exp))
    return CUDAStreamDetector(model, input_size=INPUT, in_scale=0.5, conf_thre=CONF,
                              nms_thre=NMS, num_classes=NCLS, pre_nms_topk=TOPK,
                              use_bf16=not fp32, device_preproc=True)


def streamer_detector(fp32: bool, cudnn: bool):
    """Makes the ``Streamer``'s detector; runs in the spawned child.
    ``serving_detector(fp32)`` with cuDNN on or off (and TF32 off), warmed
    up. Its ``detect`` returns the parse tuple with the child's kernel
    launches since the warm-up in the 4th slot (``Streamer`` reads
    ``result[:3]``)."""
    import torch

    from streamyolo_torch.ops.nms_cuda import nms_keep
    from streamyolo_torch.ops.preproc import downsample2x

    torch.backends.cudnn.enabled = cudnn
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    det = serving_detector(fp32)
    det.warmup(2)
    nms_keep.launches = 0
    downsample2x.launches = 0

    def detect(frame):
        bboxes, scores, labels, _ = det(frame)
        return bboxes, scores, labels, {"nms": nms_keep.launches,
                                        "preproc": downsample2x.launches}

    return detect


def read_pkl(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def run_summary(run_dir: Path, n_seqs: int, fps: float = 30.0) -> dict:
    """Checks of a ``stream_det`` run directory (the per-sequence pkls and
    ``time_info.pkl``; timestamps increasing below each sequence's horizon);
    returns its runtimes and counts."""
    seqs = [f"seq{sid:02d}" for sid in range(n_seqs)]
    ti = read_pkl(run_dir / "time_info.pkl")
    processed = 0
    for seq in seqs:
        res = read_pkl(run_dir / f"{seq}.pkl")
        ts = res["timestamps"]
        horizon = ti["n_total"] / n_seqs / fps
        check(len(ts) > 0 and all(b > a for a, b in zip(ts, ts[1:])) and ts[-1] < horizon,
              f"{run_dir.name}/{seq}: timestamps not increasing below the horizon")
        check(len(res["results_parsed"]) == len(ts) == len(res["input_fidx"]),
              f"{run_dir.name}/{seq}: ragged results")
        processed += len(ts)
    check(processed == ti["n_processed"], f"{run_dir.name}: time_info counts "
          f"{ti['n_processed']} results, the pkls {processed}")
    rt_ms = [1e3 * r for r in ti["runtime_all"]]
    return {"processed": ti["n_processed"], "total": ti["n_total"],
            "runtime_ms": {"mean": statistics.mean(rt_ms), "median": statistics.median(rt_ms),
                           "max": max(rt_ms)},
            "share_under_one_frame": ti["n_small_runtime"] / max(ti["n_processed"], 1)}


def same_runs(a: Path, b: Path, n_seqs: int) -> bool:
    """Equal per-sequence pkls: timestamps, frames, runtimes and rows."""
    for sid in range(n_seqs):
        x, y = read_pkl(a / f"seq{sid:02d}.pkl"), read_pkl(b / f"seq{sid:02d}.pkl")
        if any(x[k] != y[k] for k in ("timestamps", "input_fidx", "runtime")):
            return False
        if len(x["results_parsed"]) != len(y["results_parsed"]):
            return False
        for p, q in zip(x["results_parsed"], y["results_parsed"]):
            if not all(np.array_equal(u, v) for u, v in zip(p[:3], q[:3])):
                return False
    return True


def stats_of(summary) -> dict:
    s = [100 * float(v) for v in summary["stats"]] if summary else [float("nan")] * 3
    return {"sAP": s[0], "sAP50": s[1], "sAP75": s[2]}


def phase_stream_cli(out_dir: Path, synth) -> dict:
    """The real-time CLI at full width, in process: StreamYOLO-l at 600x960,
    bf16, seeded weights saved as a ``.pth``, ``--device-preproc``, on the
    rehearsal's 2 x 30 in-memory 1200x1920 frames. ``stream_det`` under the
    wall clock; again with ``--sim-zoo`` (the zoo made from that run's
    ``time_info.pkl``), twice, which must give equal pkls; with
    ``--infinite``; ``offline_det`` (every frame; its detections above their
    90th score percentile are the pseudo ground truth); ``streaming_eval``
    and ``forecast_kf`` on the wall-clock run; ``collect_summary`` over the
    run directories. Each run's kernel launches are counted from 0 just
    before it; ``stream_det`` warms up ``WARMUP_FRAMES`` first (one launch
    of each kernel per frame), and a call whose result lands past a
    sequence's horizon is made but not recorded."""
    import torch

    from streamyolo_torch.data import pseudo_gt_from_detections
    from streamyolo_torch.exp import get_exp
    from streamyolo_torch.ops.nms_cuda import nms_keep
    from streamyolo_torch.ops.preproc import downsample2x
    from streamyolo_torch.stream import add_to_runtime_zoo
    from streamyolo_torch.tools import collect_summary, forecast_kf, offline_det, stream_det
    from streamyolo_torch.tools import streaming_eval

    out_dir.mkdir(parents=True, exist_ok=True)
    n_seqs = len(synth.data["sequences"])
    n_frames = len(synth.data["images"])
    annot = out_dir / "val.json"
    annot.write_text(json.dumps(synth.data))
    weights = out_dir / "l_seed0.pth"
    torch.save(lifted_state(get_exp(exp_name=EVAL_CONFIG)), weights)
    common = ["--data-root", str(out_dir), "--annot-path", str(annot),
              "-f", f"cfgs/{EVAL_CONFIG}.py", "-c", str(weights), "--device-preproc"]
    runs, launches = {}, {}

    def counted(name, fn):
        nms_keep.launches = 0
        downsample2x.launches = 0
        out = fn()
        launches[name] = {"nms": nms_keep.launches, "preproc": downsample2x.launches}
        return out

    def det_run(name, *extra):
        return counted(name, lambda: stream_det.main(
            [*common, "--out-dir", str(out_dir / name), "--overwrite", *extra],
            load_frame=synth.frame))

    det_run("wall")
    zoo = out_dir / "zoo.pkl"
    add_to_runtime_zoo(str(out_dir / "wall" / "time_info.pkl"), str(zoo), "wall")
    sim = ["--sim-zoo", str(zoo), "--sim-name", "wall"]
    det_run("sim_zoo", *sim)
    det_run("sim_zoo_again", *sim)
    inf = det_run("infinite", *sim, "--infinite")
    off = counted("offline_det", lambda: offline_det.main(
        [*common, "--out-dir", str(out_dir / "offline"), "--no-eval"], load_frame=synth.frame))

    for name in ("wall", "sim_zoo"):
        runs[name] = run_summary(out_dir / name, n_seqs)
        called = launches[name]["nms"] - stream_det.WARMUP_FRAMES
        check(launches[name]["nms"] == launches[name]["preproc"]
              and runs[name]["processed"] <= called <= runs[name]["processed"] + n_seqs,
              f"stream_det {name}: {launches[name]} kernel launches after "
              f"{stream_det.WARMUP_FRAMES} warm-up frames for {runs[name]['processed']} "
              "results")
        runs[name]["calls_after_warmup"] = called
    check(same_runs(out_dir / "sim_zoo", out_dir / "sim_zoo_again", n_seqs),
          "two --sim-zoo runs of the same zoo wrote different pkls")
    n_inf = sum(len(r["timestamps"]) for r in inf.values())
    check(launches["infinite"] == {"nms": stream_det.WARMUP_FRAMES + n_frames,
                                   "preproc": stream_det.WARMUP_FRAMES + n_frames},
          f"--infinite: {launches['infinite']} kernel launches for {n_frames} frames")
    check(launches["offline_det"] == {"nms": n_frames, "preproc": n_frames},
          f"offline_det: {launches['offline_det']} kernel launches for {n_frames} frames")
    check({r["image_id"] for r in off["results_ccf"]} == set(range(n_frames)),
          "offline_det left a frame without detections")

    # pseudo ground truth: the every-frame run's top tenth of scores
    score_th = float(np.percentile([d["score"] for d in off["results_ccf"]],
                                   PGT_SCORE_PERCENTILE))
    pgt = out_dir / "pseudo_gt.json"
    pseudo_gt_from_detections(synth.data, off["results_ccf"], score_th, out_path=str(pgt))
    scores = {}
    for name in ("wall", "sim_zoo", "infinite"):
        summary, assoc = streaming_eval.main(["--annot-path", str(pgt), "--result-dir",
                                              str(out_dir / name), "--overwrite"])
        scores[name] = {**stats_of(summary), "association": assoc}
        check(np.isfinite(scores[name]["sAP"]), f"{name}: sAP not finite")
    fk = forecast_kf.main(["--annot-path", str(pgt), "--in-dir", str(out_dir / "wall"),
                           "--out-dir", str(out_dir / "forecast")])
    scores["forecast_kf"] = {**stats_of(fk["summary"]), "association": fk["assoc"]}
    dirs = [str(out_dir / d) for d in ("wall", "sim_zoo", "infinite", "forecast")]
    rows = collect_summary.main([*dirs, "--out", str(out_dir / "summary.csv")])
    check(len(rows) == len(dirs) and [r["name"] for r in rows] ==
          ["wall", "sim_zoo", "infinite", "forecast"],
          f"collect_summary: {len(rows)} rows for {len(dirs)} directories")
    emit("stream_cli", config=EVAL_CONFIG, model=f"StreamYOLO-{MODEL_SIZE}", input=list(INPUT),
         dtype="bfloat16", device_preproc=True,
         fixture=f"{n_seqs}x{n_frames // n_seqs} frames {synth.backgrounds[0].shape[0]}x"
                 f"{synth.backgrounds[0].shape[1]} synthetic, in memory",
         warmup_frames=stream_det.WARMUP_FRAMES, runs=runs, infinite_results=n_inf,
         sim_zoo_runs_equal=True, pseudo_gt_score_th=score_th,
         offline_detections=len(off["results_ccf"]), scores=scores,
         csv_rows=len(rows), launches=launches)
    return launches


def phase_streamer(synth) -> dict:
    """The detector in a spawned child (``stream/forecast.py::Streamer``):
    StreamYOLO-l at 600x960, bf16, ``device_preproc``, built on the card in
    the child. Frames of one 30-frame sequence are offered at 30 fps (a
    frame the busy detector cannot take is dropped) while the parent folds
    the results into the Kalman forecaster and forecasts half a frame ahead
    at every frame; results must come back in order, and the child's B1
    and B2 launches (returned in the parse tuple's 4th slot) must equal the
    results. A frame of the wrong size makes the child raise, which must
    surface as ``RuntimeError``. Then, in float32 with cuDNN off in both
    processes, the child's rows of the first ``STREAMER_EXACT_FRAMES``
    frames must equal an in-process detector's."""
    import torch

    from streamyolo_torch.stream import Streamer

    frames = [synth.frame(img) for img in synth.data["images"] if img["sid"] == 0]
    h, w = frames[0].shape[:2]
    got, forecast_boxes, submitted = [], [], 0
    t_start = time.perf_counter()
    with Streamer(functools.partial(streamer_detector, False, True)) as s:
        startup_s = time.perf_counter() - t_start
        t0 = time.perf_counter()
        for fidx, frame in enumerate(frames):
            while time.perf_counter() - t0 < fidx / 30.0:
                done = s.poll(timeout=0.001)
                if done is not None:
                    got.append(done)
            done = s.poll()
            if done is not None:
                got.append(done)
            submitted += s.submit(fidx, frame, fidx / 30.0)
            forecast_boxes.append(len(s.forecast((fidx + 0.5) / 30.0, w, h)[0]))
        while len(got) < submitted:
            done = s.poll(timeout=1.0)
            if done is not None:
                got.append(done)
        child_launches = s.last_result[3]
        check(got == sorted(set(got)) and len(got) == submitted > 1,
              f"Streamer results out of order or lost: {got} of {submitted} submitted")
        check(child_launches == {"nms": len(got), "preproc": len(got)},
              f"Streamer child: {child_launches} kernel launches for {len(got)} results")
        check(max(forecast_boxes) > 0, "the forecaster never produced a box")
        s.submit(len(frames), np.zeros((100, 100, 3), np.uint8), 1.0)
        try:
            for _ in range(120):
                s.poll(timeout=0.5)
            raised = False
        except RuntimeError as e:
            raised = "device_preproc expects raw" in str(e)
        check(raised, "the child's exception did not surface as RuntimeError")

    # float32, cuDNN off in both processes: the same rows
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
        mine = serving_detector(True)
        mine.warmup(2)
        equal = []
        with Streamer(functools.partial(streamer_detector, True, False)) as s:
            for fidx in range(STREAMER_EXACT_FRAMES):
                s.submit(fidx, frames[fidx], fidx / 30.0)
                back = None
                for _ in range(600):
                    back = s.poll(timeout=0.1)
                    if back is not None:
                        break
                check(back == fidx, f"fp32 Streamer: frame {fidx} came back as {back}")
                want = mine(frames[fidx])
                equal.append(all(np.array_equal(a, b) for a, b in zip(s.last_result[:3],
                                                                       want[:3])))
        del mine
    check(all(equal), f"fp32, cuDNN off: the child's rows differ from the parent's: {equal}")
    emit("streamer", model=f"StreamYOLO-{MODEL_SIZE}", input=list(INPUT), dtype="bfloat16",
         device_preproc=True, frames_offered=len(frames), submitted=submitted,
         results=len(got), result_fidx=got, forecast_boxes_max=max(forecast_boxes),
         child_startup_s=startup_s, child_exception_surfaced=True,
         fp32_cudnn_off_frames_equal=len(equal), launches=child_launches)
    torch.cuda.empty_cache()
    return child_launches


AOT_FRAMES, AOT_RESET_AT = 50, 25  # aot_serve: chained frames, reset() before this one
AOT_MULTI_STEPS = 20  # aot_serve: N = MULTI_N steps, reset(MULTI_RESET_ROW) half-way
AOT_PROFILE_FRAMES = 10  # aot_serve: frames traced for the host's CUDA runtime calls


def aot_models():
    """The serving models of phase ``aot_serve``: StreamYOLO-l of
    ``EVAL_CONFIG`` with ``lifted_state``, bf16 modules on the card, and its
    int8 quantization (``int8_state`` on the main path's seeded frames)."""
    from streamyolo_torch.exp import get_exp

    exp = get_exp(exp_name=EVAL_CONFIG)
    rng = np.random.RandomState(SEED)
    frames = [rng.randint(0, 256, (*INPUT, 3), np.uint8) for _ in range(INT8_CALIB_FRAMES)]
    q, m32, _ = int8_state(exp, frames)
    del m32
    exp.compute_dtype = "bfloat16"
    model, int8_model = exp.get_model("cuda"), exp.get_model("cuda")
    model.load_state_dict(lifted_state(exp), strict=True)
    int8_model.load_state_dict(q, strict=True)
    return model, int8_model


def aot_export_main(aot_dir: str) -> int:
    """Phase ``aot_serve``'s exporting process: ``precompile --serve DIR
    --streams MULTI_N`` of ``EVAL_CONFIG`` (host path, ``device_preproc``,
    N streams), then the int8 model's host-path graphs. Prints one JSON
    line."""
    from streamyolo_torch.stream import export_stream_executables
    from streamyolo_torch.tools import precompile

    t0 = time.perf_counter()
    out = precompile.main(["-f", f"cfgs/{EVAL_CONFIG}.py", "--serve", aot_dir, "--streams",
                           str(MULTI_N), "-b", "1", "--conf", str(CONF), "--nms", str(NMS),
                           "--topk", str(TOPK)])
    out["seconds"]["precompile"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, int8_model = aot_models()
    out["serve"] += export_stream_executables(
        int8_model, aot_dir, input_size=INPUT, conf_thre=CONF, nms_thre=NMS, num_classes=NCLS,
        pre_nms_topk=TOPK, use_bf16=True)
    out["seconds"]["int8_export"] = time.perf_counter() - t0
    print("AOT_EXPORT " + json.dumps(out), flush=True)
    return 0


def host_calls(det, pool) -> dict:
    """``AOT_PROFILE_FRAMES`` frames of ``det`` under ``torch.profiler``: per
    frame, the host's CUDA runtime launch calls (kernel and graph launches)
    and each runtime call, the device kernels and their busy ms, over the
    traced wall."""
    import torch

    from streamyolo_torch.tools.profile_step import _kernel_stats

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(AOT_PROFILE_FRAMES):
            det(pool[i % len(pool)], preprocessed=True)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / AOT_PROFILE_FRAMES
    runtime = {e.key: e.count / AOT_PROFILE_FRAMES for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CPU
               and re.match(r"cu(da)?[A-Z]", e.key)}
    busy_us, n_kernels, _ = _kernel_stats(prof)
    busy_ms = busy_us / 1e3 / AOT_PROFILE_FRAMES
    return {"launch_calls_per_frame": sum(n for k, n in runtime.items() if "Launch" in k),
            "runtime_calls_per_frame": runtime,
            "device_kernels_per_frame": n_kernels / AOT_PROFILE_FRAMES,
            "device_busy_ms_per_frame": busy_ms, "traced_wall_ms_per_frame": wall_ms,
            "idle_share": 1.0 - busy_ms / wall_ms}


def aot_pair(name, graph, eager, pool, device_image) -> dict:
    """One detector served from graphs against its eager twin: the first
    served frame, ``AOT_FRAMES`` chained frames (``reset()`` before
    ``AOT_RESET_AT``) bit for bit with the graph path's kernel launches
    (captured per graph x replays), the median wall (host clock around
    ``__call__``, ending in the D2H) and device ms (CUDA events around
    ``.step`` on a frame already on the card) of ``STEADY_STEPS`` steady
    frames, and the host's runtime calls per frame."""
    check(graph.aot_loaded, f"aot_serve {name}: the detector did not serve from graphs")
    t0 = time.perf_counter()
    graph(pool[0], preprocessed=True)
    first_ms = (time.perf_counter() - t0) * 1e3
    graph.graphs.replays = [0, 0]
    graph.reset()
    eager.reset()
    for i in range(AOT_FRAMES):
        if i == AOT_RESET_AT:
            graph.reset()
            eager.reset()
        graph(pool[i % len(pool)], preprocessed=True)
        eager(pool[i % len(pool)], preprocessed=True)
        check(graph.last_rows.shape == (TOPK, 8) and np.isfinite(graph.last_rows).all(),
              f"aot_serve {name}: rows not a finite [{TOPK}, 8] block")
        check(np.array_equal(graph.last_rows.view(np.int32), eager.last_rows.view(np.int32)),
              f"aot_serve {name}: graph rows differ from eager rows at frame {i}")
    launches = graph.graphs.launches()
    star, steady = graph.graphs.captured
    check(graph.graphs.replays == [2, AOT_FRAMES - 2] and launches["nms"] == AOT_FRAMES,
          f"aot_serve {name}: {graph.graphs.replays} replays, {launches} launches")
    times = {}
    for side, det in (("graph", graph), ("eager", eager)):
        det.reset()
        det.step(device_image)  # star
        times[f"{side}_device_ms"] = time_cuda(lambda: det.step(device_image), STEADY_STEPS)
        walls = []
        for i in range(STEADY_STEPS):
            t0 = time.perf_counter()
            det(pool[i % len(pool)], preprocessed=True)
            walls.append((time.perf_counter() - t0) * 1e3)
        times[f"{side}_wall_ms"] = statistics.median(walls)
        times[f"{side}_host"] = host_calls(det, pool)
    return {"first_frame_ms": first_ms, "capture_s": graph.graphs.capture_seconds,
            "captured_launches": {"star": star, "steady": steady}, "frames": AOT_FRAMES,
            "frames_bit_equal": AOT_FRAMES, "launches": launches, **times}


def aot_serve_main(aot_dir: str) -> int:
    """Phase ``aot_serve``'s serving process. Its ``ops/_build.py`` has no
    build directory and no ``nvcc``, so every kernel comes from ``aot_dir``.
    Serves StreamYOLO-l from graphs (host path, ``device_preproc``, int8,
    ``MULTI_N`` streams) against eager detectors of the same models, bit for
    bit, times both, and checks that another conf misses. Prints one JSON
    line."""
    import tempfile

    import torch

    from streamyolo_torch.ops import _build
    from streamyolo_torch.stream import CUDAStreamDetector, MultiStreamDetector

    _build.BUILD_DIR = Path(tempfile.mkdtemp()) / "no_builds"

    def no_nvcc():
        raise RuntimeError("the serving process must not run nvcc")

    _build.nvcc_path = no_nvcc
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model, int8_model = aot_models()
    models_s = time.perf_counter() - t0
    kw = dict(input_size=INPUT, in_scale=0.5, conf_thre=CONF, nms_thre=NMS, num_classes=NCLS,
              pre_nms_topk=TOPK, use_bf16=True)
    rng = np.random.RandomState(SEED + 7)
    frames = [rng.randint(0, 256, (*INPUT, 3), np.uint8) for _ in range(4)]
    raws = [rng.randint(0, 256, (2 * INPUT[0], 2 * INPUT[1], 3), np.uint8) for _ in range(4)]
    out = {"models_s": models_s}
    for name, mdl, pool, extra in (("host", model, frames, {}),
                                   ("device_preproc", model, raws, {"device_preproc": True}),
                                   ("int8", int8_model, frames, {})):
        t0 = time.perf_counter()
        graph = CUDAStreamDetector(mdl, aot_dir=aot_dir, **kw, **extra)
        construct_s = time.perf_counter() - t0
        eager = CUDAStreamDetector(mdl, **kw, **extra)
        image = torch.from_numpy(pool[0]).to(dev)[None]
        out[name] = {"construct_s": construct_s, **aot_pair(name, graph, eager, pool, image)}
        del graph, eager
    check(out["device_preproc"]["launches"]["preproc"] == AOT_FRAMES
          and out["int8"]["launches"]["int8_conv"] > 0 and out["host"]["launches"]["int8_conv"]
          == out["host"]["launches"]["preproc"] == 0,
          "aot_serve: graph launches "
          f"{[out[k]['launches'] for k in ('host', 'device_preproc', 'int8')]}")

    t0 = time.perf_counter()
    graph = MultiStreamDetector(model, MULTI_N, aot_dir=aot_dir, **kw)
    construct_s = time.perf_counter() - t0
    eager = MultiStreamDetector(model, MULTI_N, **kw)
    check(graph.aot_loaded, "aot_serve multi-stream: the detector did not serve from graphs")
    graph.graphs.replays = [0, 0]
    pool = [np.random.RandomState(SEED + 1 + i).randint(0, 256, (MULTI_N, *INPUT, 3), np.uint8)
            for i in range(4)]
    for t in range(AOT_MULTI_STEPS):
        if t == AOT_MULTI_STEPS // 2:
            graph.reset(MULTI_RESET_ROW)
            eager.reset(MULTI_RESET_ROW)
        graph(pool[t % len(pool)], preprocessed=True)
        eager(pool[t % len(pool)], preprocessed=True)
        check(np.array_equal(graph.last_rows.view(np.int32), eager.last_rows.view(np.int32)),
              f"aot_serve multi-stream: graph rows differ from eager rows at step {t}")
    out["multi_stream"] = {"n_streams": MULTI_N, "steps": AOT_MULTI_STEPS,
                           "reset_row": MULTI_RESET_ROW, "construct_s": construct_s,
                           "capture_s": graph.graphs.capture_seconds,
                           "launches": graph.graphs.launches()}
    check(out["multi_stream"]["launches"]["nms"] == AOT_MULTI_STEPS,
          f"aot_serve multi-stream: {out['multi_stream']['launches']} graph launches")
    del graph, eager
    miss = CUDAStreamDetector(model, aot_dir=aot_dir, **{**kw, "conf_thre": 2 * CONF})
    check(not miss.aot_loaded, "aot_serve: a detector with another conf did not miss")
    out["miss_with_other_conf"] = True
    print("AOT_SERVE " + json.dumps(out), flush=True)
    return 0


def aot_child(flag: str, aot_dir: Path) -> dict:
    """Run ``chip_smoke.py <flag> aot_dir`` in a fresh process; its JSON line."""
    tag = {"--aot-export": "AOT_EXPORT ", "--aot-serve": "AOT_SERVE "}[flag]
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), flag, str(aot_dir)],
                          capture_output=True, text=True, timeout=600)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(tag)]
    check(proc.returncode == 0 and len(lines) == 1,
          f"aot_serve {flag} child: exit {proc.returncode}\n{proc.stdout[-2000:]}\n"
          f"{proc.stderr[-4000:]}")
    return json.loads(lines[0][len(tag):])


def phase_aot_serve(out_dir: Path, synth, smi: str) -> dict:
    """Serving from captured CUDA graphs (``aot_dir``) at StreamYOLO-l,
    600x960, bf16, seeded weights, conf 0.01 / NMS 0.65 / top-k 200: a
    fresh process runs ``precompile --serve DIR --streams MULTI_N`` and
    exports the int8 model's graphs; a second fresh process, which cannot
    run ``nvcc``, serves from DIR (``aot_serve_main``); then ``stream_det
    --aot-dir DIR --device-preproc`` runs under the wall clock on the
    rehearsal's frames in this process and must serve from the graphs.
    Returns the graph path's kernel launches by path (launches captured per
    graph x replays; a replay moves no wrapper counter)."""
    import shutil

    import torch

    from streamyolo_torch.exp import get_exp
    from streamyolo_torch.tools import stream_det

    t_phase = time.perf_counter()
    shutil.rmtree(out_dir, ignore_errors=True)
    aot_dir = out_dir / "aot"
    exported = aot_child("--aot-export", aot_dir)
    check(len(exported["serve"]) == 8 and all(Path(p).is_file() for p in exported["serve"]),
          f"aot_serve: precompile wrote {exported['serve']}")
    libs = sorted(p.name.split("-")[0] for p in aot_dir.glob("*.so"))
    check(libs == ["int8_conv", "nms", "preproc"], f"aot_serve: libraries {libs} in {aot_dir}")
    served = aot_child("--aot-serve", aot_dir)

    # stream_det --aot-dir on the rehearsal's frames, under the wall clock
    n_seqs = len(synth.data["sequences"])
    annot = out_dir / "val.json"
    annot.write_text(json.dumps(synth.data))
    weights = out_dir / "l_seed0.pth"
    torch.save(lifted_state(get_exp(exp_name=EVAL_CONFIG)), weights)
    made = []
    build = stream_det.build_detector
    stream_det.build_detector = lambda *a, **k: made.append(build(*a, **k)) or made[-1]
    try:
        stream_det.main(["--data-root", str(out_dir), "--annot-path", str(annot), "-f",
                         f"cfgs/{EVAL_CONFIG}.py", "-c", str(weights), "--device-preproc",
                         "--aot-dir", str(aot_dir), "--out-dir", str(out_dir / "wall")],
                        load_frame=synth.frame)
    finally:
        stream_det.build_detector = build
    det = made[-1]
    check(det.aot_loaded, "aot_serve: stream_det --aot-dir did not serve from graphs")
    run = run_summary(out_dir / "wall", n_seqs)
    star, steady = det.graphs.captured
    calls = sum(det.graphs.replays) - 2 - stream_det.WARMUP_FRAMES  # the probe, the warm-up
    check(run["processed"] <= calls <= run["processed"] + n_seqs,
          f"stream_det --aot-dir: {det.graphs.replays} replays for {run['processed']} results")
    cli = {"run": run, "replays": det.graphs.replays, "calls_after_warmup": calls,
           "launches": {k: det.graphs.launches()[k] - star[k] - steady[k] for k in star}}
    del det, made
    torch.cuda.empty_cache()
    emit("aot_serve", nvidia_smi=smi, model=f"StreamYOLO-{MODEL_SIZE}", input=list(INPUT),
         dtype="bfloat16", conf=CONF, nms=NMS, topk=TOPK, export=exported, serve=served,
         stream_det=cli, phase_s=time.perf_counter() - t_phase)
    by_path = {f"aot_serve_{k}": served[k]["launches"]
               for k in ("host", "device_preproc", "int8", "multi_stream")}
    by_path["aot_stream_det"] = cli["launches"]
    return by_path

def _iou_xywh(a, b) -> float:
    ax2, ay2, bx2, by2 = a[0] + a[2], a[1] + a[3], b[0] + b[2], b[1] + b[3]
    iw = max(0.0, min(ax2, bx2) - max(a[0], b[0]))
    ih = max(0.0, min(ay2, by2) - max(a[1], b[1]))
    inter = iw * ih
    union = a[2] * a[3] + b[2] * b[3] - inter
    return inter / union if union > 0 else 0.0


def matched_rows(rows, rows_ref, iou_min: float = 0.9) -> dict:
    """Two evaluations' COCO rows matched by box within each (image, class)
    cell: the reference rows in score order each take the unmatched row of
    the other run with the highest IoU, if it is >= ``iou_min``. Returns the
    matched pairs' largest box gap (px) and score gap, and the rows left
    unmatched on either side (a box that crossed the confidence threshold or
    an NMS decision that flipped) and their share of both runs' rows. Two
    near-tied rows that swap places in score order still pair with their
    own boxes."""
    def cells(rs):
        out = {}
        for r in rs:
            out.setdefault((r["image_id"], r["category_id"]), []).append(r)
        return out

    a, b = cells(rows), cells(rows_ref)
    out = {"rows": len(rows), "rows_ref": len(rows_ref), "pairs": 0, "unmatched": 0,
           "box_max_abs": 0.0, "score_max_abs": 0.0}
    for key in set(a) | set(b):
        free = list(a.get(key, []))
        for q in sorted(b.get(key, []), key=lambda r: -r["score"]):
            ious = [_iou_xywh(r["bbox"], q["bbox"]) for r in free]
            best = int(np.argmax(ious)) if ious else -1
            if best < 0 or ious[best] < iou_min:
                out["unmatched"] += 1
                continue
            r = free.pop(best)
            out["pairs"] += 1
            out["box_max_abs"] = max(out["box_max_abs"], float(
                np.abs(np.subtract(r["bbox"], q["bbox"])).max()))
            out["score_max_abs"] = max(out["score_max_abs"], abs(r["score"] - q["score"]))
        out["unmatched"] += len(free)
    out["unmatched_share"] = out["unmatched"] / max(1, len(rows) + len(rows_ref))
    return out


def det_rows(rows, image_id) -> list:
    """A detector's ``[K, 8]`` block as COCO-style rows (kept rows only,
    xywh boxes, score = obj * cls) for ``matched_rows``."""
    kept = rows[rows[:, 7] > 0.5]
    return [{"image_id": image_id, "category_id": int(r[6]),
             "bbox": [float(r[0]), float(r[1]), float(r[2] - r[0]), float(r[3] - r[1])],
             "score": float(r[4] * r[5])} for r in kept]


def conv_calls(model, images, buffer) -> list:
    """The ``BaseConv`` calls of one steady on_pipe step, in order:
    (n, c, h, w, c_out, k, stride, groups) of each."""
    import torch

    from streamyolo_torch.nn.blocks import BaseConv

    seen = []

    def record(mod, args):
        c = mod.conv
        seen.append((*args[0].shape, c.out_channels, c.kernel_size[0], c.stride[0], c.groups))

    hooks = [m.register_forward_pre_hook(record) for m in model.modules()
             if isinstance(m, BaseConv)]
    with torch.inference_mode():
        model(images, buffer=buffer, mode="on_pipe")
    for h in hooks:
        h.remove()
    return seen


def conv_work(shape, elem_bytes: int):
    """(MACs, bytes, float32 operations) of one int8 conv call: the float
    input read once, the int8 kernel and the scales, the output written
    once; a quantize per input and a dequantize per output value."""
    n, c, h, w, co, k, stride, groups = shape
    pad = (k - 1) // 2
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    macs = n * ho * wo * co * (c // groups) * k * k
    n_bytes = (n * c * h * w * elem_bytes + co * (c // groups) * k * k + 4 * co + 4 * c
               + n * co * ho * wo * elem_bytes)
    return macs, n_bytes, n * c * h * w * INT8_QUANT_OPS + n * co * ho * wo * INT8_DEQUANT_OPS


def int8_operands(shape, dtype, per_channel: bool, seed: int):
    """Seeded card operands of one conv shape: a ``channels_last`` input
    (normal, scale 2), an int8 ``channels_last`` kernel, ``w_scale`` and a
    per-tensor (the input's absmax / 127) or per-channel ``act_scale``."""
    import torch

    n, c, h, w, co, k, stride, groups = shape
    gen = torch.Generator().manual_seed(seed)
    cl = torch.channels_last
    x = (torch.randn(n, c, h, w, generator=gen) * 2).to(dtype)
    kq = torch.randint(-127, 128, (co, c // groups, k, k), generator=gen, dtype=torch.int8)
    ws = torch.rand(co, generator=gen) * 1e-2 + 1e-4
    act = (torch.rand(c, generator=gen) * 0.05 + 0.01) if per_channel \
        else torch.tensor(float(x.float().abs().max()) / 127.0)
    return (x.cuda().contiguous(memory_format=cl), kq.cuda().contiguous(memory_format=cl),
            ws.cuda(), act.cuda())


def int8_exact(x, kq, ws, act, stride: int, groups: int, label: str) -> int:
    """The int8 kernel against its plain version on the card, every element
    equal; returns the elements compared. Restores the launch count: a
    check is no launch of the path."""
    import torch

    from streamyolo_torch.ops.int8_conv import int8_conv, int8_conv_plain

    saved = int8_conv.launches
    got = int8_conv(x, kq, ws, act, stride=stride, groups=groups)
    torch.cuda.synchronize()
    int8_conv.launches = saved
    want = int8_conv_plain(x, kq, ws, act, stride, groups)
    check(got.dtype == x.dtype and got.is_contiguous(memory_format=torch.channels_last),
          f"int8 conv output at {label} is not channels_last {x.dtype}")
    bad = int((got != want).sum())
    check(bad == 0, f"int8 conv differs from its plain version at {label}: {bad} elements")
    return got.numel()


def int8_state(exp, frames):
    """(the int8 serving state dict, the float32 model on the card it was
    calibrated with, the seconds of calibration and quantization):
    ``lifted_state(exp)`` calibrated off_pipe on ``INT8_CALIB_FRAMES`` pairs
    of ``frames`` and quantized."""
    from streamyolo_torch.quant import calibrate_activations, quantize_state_dict

    state = lifted_state(exp)
    m32 = exp.get_model("cuda")
    m32.load_state_dict(state, strict=True)
    x6 = np.stack([np.concatenate([frames[i], frames[(i + 1) % len(frames)]], -1)
                   for i in range(INT8_CALIB_FRAMES)])
    t0 = time.perf_counter()
    q = quantize_state_dict(state, calibrate_activations(m32, [x6]))
    return q, m32, time.perf_counter() - t0


def phase_int8(frames, bf16_steps: dict, floor: dict) -> dict:
    """StreamYOLO-l at 600x960 through the int8 PTQ serving path. The
    seeded weights of ``EVAL_CONFIG`` with the prediction biases lifted
    (``lifted_state``), calibrated off_pipe on ``INT8_CALIB_FRAMES`` frames
    by a float32 model on the card, quantized (BN folded, every CBS conv
    int8), served bf16 through ``CUDAStreamDetector``.

    Checks: the kernel against its plain version, every element equal, at
    every distinct ``BaseConv`` shape of the steady step (found by hooks;
    bf16; the ``INT8_HEAVIEST`` that carry the most MACs over the step also
    float32 and per-channel; the list held to ``int8_conv_times.STEP_SHAPES``)
    and at edge cases (C_in 12, depthwise, batch 8, an all-zero input at the
    scale floor, .5 ties and values past +-127); one kernel launch per
    quantized conv call and one B1 launch per step; the scales float32
    after ``_place``; the float32 int8 step of the card against the CPU's
    (the stem's int8 conv, which sees exact pixels, equal; decoded outputs
    within ``INT8_BOX_REL`` / ``INT8_PROB_ABS``). Times: the step (device
    and wall, beside the bf16 step of this process), the heaviest shapes
    alone and back to back, every shape back to back with its calls per
    step and plan, the whole step's convs against their bound, the plain
    version and the library yardsticks (cuDNN's bf16 convolution of the
    same layer; ``torch._int_mm`` for the 1x1 stride-1 layers)."""
    import torch

    from streamyolo_torch.exp import get_exp
    from streamyolo_torch.nn.blocks import BaseConv
    from streamyolo_torch.ops.int8_conv import int8_conv, int8_conv_plain, plan_int8_conv
    from streamyolo_torch.ops.nms_cuda import nms_keep
    from streamyolo_torch.stream import CUDAStreamDetector
    from streamyolo_torch.tools.int8_conv_times import STEP_SHAPES, layer_times

    dev = torch.device("cuda")
    exp = get_exp(exp_name=EVAL_CONFIG)
    q, m32, quantize_s = int8_state(exp, frames)
    n_quantized = sum(k.endswith(".kernel_q") for k in q)

    exp.compute_dtype = "bfloat16"
    m16 = exp.get_model("cuda")
    m16.load_state_dict(q, strict=True)
    det = CUDAStreamDetector(m16, input_size=INPUT, in_scale=0.5, conf_thre=CONF, nms_thre=NMS,
                             num_classes=NCLS, pre_nms_topk=TOPK, use_bf16=True)
    blocks = [m for m in det.model.modules() if isinstance(m, BaseConv)]
    check(len(blocks) == n_quantized and all(
        m.kernel_q.dtype == torch.int8 and m.w_scale.dtype == m.act_scale.dtype == torch.float32
        and m.kernel_q.is_cuda and m.bn.weight.dtype == torch.bfloat16 for m in blocks),
        "int8: a quantized block lost its int8 kernel or float32 scales in _place")
    det.warmup(3)
    img = torch.from_numpy(frames[0]).to(dev)[None]
    det.reset()
    det.step(img)
    calls = conv_calls(det.model, img, det._buffer)
    star_calls = conv_calls(det.model, img, None)
    check(len(calls) >= n_quantized, f"int8: {len(calls)} conv calls for {n_quantized} blocks")

    # the main path: a star and STEADY_STEPS steady steps
    int8_conv.launches = 0
    nms_keep.launches = 0
    det.reset()
    kept = []
    for i in range(1 + STEADY_STEPS):
        launched = int8_conv.launches
        _, _, labels, _ = det(frames[i % len(frames)], preprocessed=True)
        want = len(star_calls if i == 0 else calls)
        check(int8_conv.launches - launched == want,
              f"int8 step {i}: {int8_conv.launches - launched} kernel launches for "
              f"{want} quantized conv calls")
        check(np.isfinite(det.last_rows).all(), f"int8 step {i}: rows not finite")
        kept.append(len(labels))
    launches = {"int8_conv": int8_conv.launches, "nms": nms_keep.launches}
    check(launches["nms"] == 1 + STEADY_STEPS,
          f"int8: B1 launched {launches['nms']} times for {1 + STEADY_STEPS} steps")

    # the step's times beside the bf16 step of this process
    det.reset()
    det.step(img)
    step_device_ms = time_cuda(lambda: det.step(img), iters=STEADY_STEPS)
    wall = []
    for i in range(STEADY_STEPS):
        t = time.perf_counter()
        det(frames[i % len(frames)], preprocessed=True)
        wall.append((time.perf_counter() - t) * 1e3)
    step = {"int8_device_ms": step_device_ms, "int8_wall_ms": statistics.median(wall),
            "bf16_device_ms": bf16_steps["host_device_ms"],
            "bf16_wall_ms": bf16_steps["host_wall_ms"]}
    del det, m16

    # float32 int8 step: the card against the CPU (TF32 off)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    m32.load_state_dict(q, strict=True)
    m32 = m32.to(memory_format=torch.channels_last)
    exp.compute_dtype = "float32"
    mcpu = exp.get_model("cpu")
    mcpu.load_state_dict(q, strict=True)
    stem_in = {}
    hooks = [m.backbone.backbone.stem.conv.register_forward_pre_hook(
        lambda mod, args, key=key: stem_in.setdefault(key, args[0]))
        for key, m in (("gpu", m32), ("cpu", mcpu))]
    x0, x1 = (torch.from_numpy(f)[None] for f in frames[:2])
    with torch.inference_mode():
        c_star, c_buf = mcpu(x0, mode="on_pipe")
        c_steady, _ = mcpu(x1, buffer=c_buf, mode="on_pipe")
        g_star, g_buf = m32(x0.to(dev), mode="on_pipe")
        g_steady, _ = m32(x1.to(dev), buffer=g_buf, mode="on_pipe")
    for h in hooks:
        h.remove()
    stem = m32.backbone.backbone.stem.conv
    check(torch.equal(stem_in["gpu"].cpu(), stem_in["cpu"]), "int8: the stem inputs differ")
    stem_elems = int8_exact(stem_in["gpu"], stem.kernel_q, stem.w_scale, stem.act_scale, 1, 1,
                            "the stem (exact pixels)")
    saved = int8_conv.launches
    stem_card = int8_conv(stem_in["gpu"], stem.kernel_q, stem.w_scale, stem.act_scale).cpu()
    int8_conv.launches = saved
    stem_cpu = int8_conv_plain(stem_in["cpu"], *(t.cpu() for t in (
        stem.kernel_q, stem.w_scale, stem.act_scale)))
    check(torch.equal(stem_card, stem_cpu), "int8: the stem's conv on the card differs from "
          "the plain version on the CPU")
    card_vs_cpu = {name: fp32_errors(g.cpu(), c) for name, c, g in (
        ("star", c_star, g_star), ("steady", c_steady, g_steady))}
    torch.backends.cudnn.allow_tf32 = True
    del m32, mcpu
    for name, err in card_vs_cpu.items():
        check(err["box_rel_err"] < INT8_BOX_REL and err["prob_abs_err"] < INT8_PROB_ABS,
              f"int8 float32 step, card vs CPU ({name}): {err}")

    # the kernel against its plain version at every distinct shape of the
    # step; the heaviest carry the most MACs over the step (calls x MACs)
    counts = {s: calls.count(s) for s in set(calls)}
    check(sorted(counts.items()) == sorted((s, c) for c, s in STEP_SHAPES),
          "int8: the step's conv shapes differ from tools/int8_conv_times.py STEP_SHAPES")
    distinct = sorted(counts, key=lambda s: -counts[s] * conv_work(s, 2)[0])
    heaviest = distinct[:INT8_HEAVIEST]
    compared, cases = 0, []
    for i, shape in enumerate(distinct):
        n, c, h, w, co, k, stride, groups = shape
        variants = [(torch.bfloat16, False)]
        if shape in heaviest or c == 12:
            variants += [(torch.float32, False), (torch.bfloat16, True)]
        for dtype, per_channel in variants:
            ops = int8_operands(shape, dtype, per_channel, seed=i)
            compared += int8_exact(*ops, stride, groups, f"{shape} {dtype} pc={per_channel}")
        cases.append(f"{n}x{c}x{h}x{w}->{co} k{k} s{stride}")
    edge = [(8, 64, 75, 120, 64, 3, 2, 1), (2, 128, 38, 60, 128, 3, 1, 128),
            (1, 256, 19, 30, 256, 3, 2, 256)]
    for j, shape in enumerate(edge):
        ops = int8_operands(shape, torch.bfloat16, j == 1, seed=100 + j)
        compared += int8_exact(*ops, shape[6], shape[7], f"edge {shape}")
    x, kq, ws, _ = int8_operands((2, 64, 19, 30, 64, 3, 1, 1), torch.float32, False, seed=7)
    ties = (torch.randint(-300, 301, x.shape, device=dev) / 2.0).contiguous(
        memory_format=torch.channels_last)
    for label, xi, act in (("all zero, scale floor", torch.zeros_like(x), 1e-8 / 127.0),
                           (".5 ties, past +-127", ties, 1.0),
                           (".5 ties, scale 0.5", ties, 0.5)):
        compared += int8_exact(xi, kq, ws, torch.tensor(act, device=dev), 1, 1, label)
        compared += int8_exact(xi.to(torch.bfloat16), kq, ws, torch.tensor(act, device=dev),
                               1, 1, label + " bf16")

    # times: the shapes that carry the most MACs over the step alone, and
    # every shape back to back, summed over the step's calls
    per_layer = [{"shape": list(s), "calls": counts[s],
                  **layer_times(s, single=True, reps=5, plain=True)} for s in heaviest]
    per_shape = []
    whole = {"calls": len(calls), "distinct_shapes": len(distinct), "macs": 0, "ms": 0.0,
             "cudnn_bf16_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_bytes_ms": 0.0,
             "bound_ops_ms": 0.0, "int_mm_ms_1x1": 0.0, "kernel_ms_1x1": 0.0}
    for s, cnt in counts.items():
        t = layer_times(s, single=False, reps=3, plain=True)
        plan = plan_int8_conv(*s)
        per_shape.append({"shape": list(s), "calls": cnt, **t, "plan": None if plan is None else {
            f: getattr(plan, f) for f in ("flat", "mw", "bn", "splits", "grid")}})
        macs, n_bytes, fops = conv_work(s, 2)
        whole["macs"] += cnt * macs
        whole["ms"] += cnt * t["ms_back_to_back"]
        whole["cudnn_bf16_ms"] += cnt * t["cudnn_bf16_ms_back_to_back"]
        whole["plain_ms"] += cnt * t["plain_ms"]
        whole["bound_ms"] += cnt * t["bound_ms"]
        whole["bound_bytes_ms"] += cnt * n_bytes / HBM_BYTES_PER_S * 1e3
        whole["bound_ops_ms"] += cnt * (fops / FP32_OPS_PER_S + 2 * macs / INT8_OPS_PER_S) * 1e3
        if "int_mm_ms_back_to_back" in t:
            whole["int_mm_ms_1x1"] += cnt * t["int_mm_ms_back_to_back"]
            whole["kernel_ms_1x1"] += cnt * t["ms_back_to_back"]
    whole["bound_by"] = "bytes" if whole["bound_bytes_ms"] >= whole["bound_ops_ms"] \
        else "operations"
    emit("int8", model=f"StreamYOLO-{MODEL_SIZE}", input=list(INPUT), dtype="bfloat16",
         calibration=f"{INT8_CALIB_FRAMES} frames, off_pipe, float32 model on the card",
         quantize_s=quantize_s, quantized_blocks=n_quantized, conv_calls_per_step=len(calls),
         distinct_shapes=cases, elements_compared=compared, exact=True,
         stem_elements_card_vs_cpu=stem_elems,
         stem_input_channels_last=stem_in["gpu"].is_contiguous(memory_format=torch.channels_last),
         launches=launches,
         launches_per_step=launches["int8_conv"] / (1 + STEADY_STEPS),
         kept_min=min(kept), kept_max=max(kept), step=step,
         fp32_card_vs_cpu=card_vs_cpu, heaviest=per_layer, per_shape=per_shape,
         whole_step_convs=whole, floor_ms=floor)
    return {"launches": launches, "compared": compared, "heaviest": per_layer, "whole": whole,
            "step": step, "q": q}


def spatial_run(det, pool) -> list:
    """A star and ``SPATIAL_STEADY`` steady frames of ``pool`` through
    ``det``: their kept rows as ``det_rows``."""
    det.reset()
    rows = []
    for i in range(1 + SPATIAL_STEADY):
        det(pool[i % len(pool)], preprocessed=True)
        check(np.isfinite(det.last_rows).all(), f"spatial: frame {i} rows not finite")
        rows += det_rows(det.last_rows, i)
    return rows


def spatial_gap(rows, rows_ref) -> dict:
    """``matched_rows`` at ``SPATIAL_IOU`` and the reference's matched share
    (pairs match within a class: a matched row's label is equal)."""
    gap = matched_rows(rows, rows_ref, SPATIAL_IOU)
    gap["matched_share"] = gap["pairs"] / max(1, len(rows_ref))
    # a box of zero area has no IoU with any box, its twin included
    gap["zero_area_rows_ref"] = sum(r["bbox"][2] * r["bbox"][3] == 0 for r in rows_ref)
    return gap


def spatial_ok(gap: dict) -> bool:
    return (gap["rows_ref"] > 0 and gap["matched_share"] >= SPATIAL_MATCHED_MIN
            and gap["score_max_abs"] <= SPATIAL_SCORE_GAP)


def spatial_preds(det, pool) -> dict:
    """``fp32_errors`` of the sharded model's decoded predictions against
    the unsharded model's, every anchor of a star and a steady frame."""
    import torch

    x0, x1 = (torch.from_numpy(f).cuda()[None].float() for f in pool[:2])
    sp = det.spatial
    with torch.inference_mode():
        a0, buf = det.model(x0, mode="on_pipe")
        a1, _ = det.model(x1, buffer=buf, mode="on_pipe")
        b0, buf = sp(sp.sharding.shard(x0, dim=1))
        b1, _ = sp(sp.sharding.shard(x1, dim=1), buffer=buf)
    return {"star": fp32_errors(b0, a0), "steady": fp32_errors(b1, a1)}


def spatial_times(det, pool, img) -> dict:
    """Medians of ``SPATIAL_TIMED`` steady frames: CUDA events around
    ``.step`` on a frame already on the card (device ms; eager, the span
    holds the host's launches too) and the host clock around ``__call__``
    on a host frame (wall ms, ending in the rows' D2H)."""
    det.reset()
    det.step(img)
    device_ms = time_cuda(lambda: det.step(img), iters=SPATIAL_TIMED)
    wall = []
    for i in range(SPATIAL_TIMED):
        t = time.perf_counter()
        det(pool[i % len(pool)], preprocessed=True)
        wall.append((time.perf_counter() - t) * 1e3)
    return {"device_ms": device_ms, "wall_ms": statistics.median(wall)}


def phase_spatial(pool, q: dict, smi: str) -> dict:
    """The row-sharded latency mode (``parallel/spatial.py``,
    ``CUDAStreamDetector(mesh=...)``): StreamYOLO-l at 600x960, the seeded
    weights of ``EVAL_CONFIG`` with the prediction biases lifted, frames of
    ``pool`` passed preprocessed (the host path; ``device_preproc`` is
    refused with a mesh). Every shard on cuda:0: work division on one card,
    which proves the halo exchange and the kernels at shard shapes, not a
    gain in latency.

    At n = 2 and 8, against the unsharded step:

    * float32 (TF32 off), the counted path (n = 8): B1 once per frame, its
      rows on the primary device, B2 never, the DFP buffer n slabs a level
      on the card; the decoded predictions of every anchor of a star and a
      steady frame within the stated float32 bound of phase
      ``correctness`` (box 1e-3 relative to |box| + 1, probability 1e-4).
      The kept rows' matched share is reported beside the unsharded step's
      own share against itself with cuDNN off: the random trunk decodes
      boxes of up to ~1e25 px, 2,640 candidates above conf overlap, and
      float32 sum-order noise (~3e-4 relative, either way) flips NMS;
    * float64: the kept rows held to the bound, at least
      ``SPATIAL_MATCHED_MIN`` matched at IoU ``SPATIAL_IOU`` with equal
      labels, scores within ``SPATIAL_SCORE_GAP``.

    Then bf16 and the int8 model (``q``, served bf16) at n = 8, reported as
    matched shares (ROADMAP §C.3): the int8 conv kernel launched at every
    quantized conv call of the sharded step, at shard heights, and held bit
    for bit against its plain version at the shard shape with the most MACs
    that the unsharded step lacks. Times (bf16): device and wall ms at n =
    1, 2, 8; with two or more cards, n = 2 and n = every card (at most 8)
    again, one shard a card (the float64 bound, bf16 times)."""
    import torch

    from streamyolo_torch.exp import get_exp
    from streamyolo_torch.nn.blocks import BaseConv
    from streamyolo_torch.ops.int8_conv import int8_conv
    from streamyolo_torch.ops.nms_cuda import nms_keep
    from streamyolo_torch.ops.preproc import downsample2x
    from streamyolo_torch.parallel import make_spatial_mesh
    from streamyolo_torch.stream import CUDAStreamDetector

    t_phase = time.perf_counter()
    kw = dict(input_size=INPUT, in_scale=0.5, conf_thre=CONF, nms_thre=NMS,
              num_classes=NCLS, pre_nms_topk=TOPK)
    exp = get_exp(exp_name=EVAL_CONFIG)
    state = lifted_state(exp)
    models = {}
    for name, dtype in (("float32", torch.float32), ("float64", torch.float64),
                        ("bfloat16", torch.bfloat16)):
        models[name] = exp.get_model("cuda", dtype=dtype)
        models[name].load_state_dict(state, strict=True)
    models["int8"] = exp.get_model("cuda", dtype=torch.bfloat16)
    models["int8"].load_state_dict(q, strict=True)
    del state

    def detector(name, devices=None):
        mesh = None if devices is None else make_spatial_mesh(devices)
        return CUDAStreamDetector(models[name], use_bf16=name in ("bfloat16", "int8"),
                                  mesh=mesh, **kw)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = detector("float32")
    rows_ref = spatial_run(ref, pool)
    with torch.backends.cudnn.flags(enabled=False):
        control = spatial_gap(spatial_run(ref, pool), rows_ref)
    del ref
    rows64_ref = spatial_run(detector("float64"), pool)
    fp32, preds32, fp64, launches = {}, {}, {}, {}
    for n in SPATIAL_N:
        det = detector("float32", ["cuda:0"] * n)
        det.warmup(2)
        torch.cuda.synchronize()
        nms_keep.launches = 0
        downsample2x.launches = 0
        rows = spatial_run(det, pool)
        torch.cuda.synchronize()
        launches[n] = {"nms": nms_keep.launches, "preproc": downsample2x.launches}
        check(launches[n] == {"nms": 1 + SPATIAL_STEADY, "preproc": 0},
              f"spatial n={n}: launches {launches[n]} for {1 + SPATIAL_STEADY} frames")
        check(all(p.is_cuda for level in det._buffer for p in level)
              and [len(level) for level in det._buffer] == [n] * 3,
              f"spatial n={n}: the DFP buffer is not {n} slabs a level on the card")
        saved = nms_keep.launches
        out = det.step(torch.from_numpy(pool[0])[None])
        nms_keep.launches = saved
        check(out.device == det.mesh.devices[0], f"spatial n={n}: rows on {out.device}")
        fp32[n] = spatial_gap(rows, rows_ref)
        preds32[n] = spatial_preds(det, pool)
        del det
        fp64[n] = spatial_gap(spatial_run(detector("float64", ["cuda:0"] * n), pool), rows64_ref)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True

    # bf16 and int8 at n = 8: matched shares, reported
    reported = {}
    for name in ("bfloat16", "int8"):
        ref_rows = spatial_run(detector(name), pool)
        det = detector(name, ["cuda:0"] * SPATIAL_N[-1])
        det.warmup(2)
        if name == "int8":
            shapes = []
            hooks = [m.register_forward_pre_hook(
                lambda mod, args: shapes.append(
                    (*args[0].shape, mod.kernel_q.shape[0], mod.kernel_q.shape[-1],
                     mod.conv.stride[0], mod.conv.groups)))
                for m in det.model.modules() if isinstance(m, BaseConv)]
            int8_conv.launches = 0
        rows = spatial_run(det, pool)
        if name == "int8":
            for h in hooks:
                h.remove()
            torch.cuda.synchronize()
            launches["int8_conv"] = int8_conv.launches
            check(int8_conv.launches == len(shapes) > 0,
                  f"spatial int8: {int8_conv.launches} kernel launches for {len(shapes)} "
                  "quantized conv calls")
            plain = detector("int8")
            plain.reset()
            img = torch.from_numpy(pool[0]).cuda()[None]
            plain.step(img)
            unsharded = set(conv_calls(plain.model, img.to(torch.bfloat16), plain._buffer))
            shard_only = sorted(set(shapes) - unsharded, key=lambda s: -conv_work(s, 2)[0])
            check(bool(shard_only), "spatial int8: no conv call at a shard shape")
            shard_shape = shard_only[0]
            ops = int8_operands(shard_shape, torch.bfloat16, False, seed=11)
            elems = int8_exact(*ops, shard_shape[6], shard_shape[7],
                               f"the shard shape {shard_shape}")
            del plain
        reported[name] = spatial_gap(rows, ref_rows)
        del det

    # times, bf16: n = 1 (the plain detector), 2 and 8 on cuda:0
    img = torch.from_numpy(pool[0]).cuda()[None]
    times = {}
    for n in (1, *SPATIAL_N):
        det = detector("bfloat16", ["cuda:0"] * n)
        det.warmup(2)
        times[f"n{n}"] = spatial_times(det, pool, img)
        del det

    # across cards: n = 2 and n = every card (at most 8), each shard on its own
    cards = torch.cuda.device_count()
    across = {}
    for n in sorted({2, min(cards, 8)}) if cards >= 2 else ():
        devices = [f"cuda:{i}" for i in range(n)]
        det = detector("float64", devices)
        across[f"n{n}"] = {"float64": spatial_gap(spatial_run(det, pool), rows64_ref)}
        det = detector("bfloat16", devices)
        det.warmup(2)
        across[f"n{n}"]["times_bf16"] = spatial_times(det, pool, img)
        del det
    del models
    torch.cuda.empty_cache()
    emit("spatial", model=f"StreamYOLO-{MODEL_SIZE}", input=list(INPUT), nvidia_smi=smi,
         cards=cards, shards_on="cuda:0", frames=1 + SPATIAL_STEADY,
         bound={"iou": SPATIAL_IOU, "matched_share_min": SPATIAL_MATCHED_MIN,
                "score_gap_max": SPATIAL_SCORE_GAP, "dtype": "float64",
                "float32_preds": {"box_rel_err": 1e-3, "prob_abs_err": 1e-4}},
         float64={f"n{n}": g for n, g in fp64.items()},
         float32_preds={f"n{n}": e for n, e in preds32.items()},
         float32_rows_reported={**{f"n{n}": g for n, g in fp32.items()},
                                "unsharded_cudnn_off": control},
         launches=launches,
         reported_n8={"bfloat16": reported["bfloat16"], "int8": reported["int8"]},
         int8_shard_shape=list(shard_shape), int8_shard_shape_elements=elems,
         int8_conv_calls_at_shard_shapes=sum(s not in unsharded for s in shapes),
         times_bf16=times, across_cards=across or "not run: one card",
         phase_s=time.perf_counter() - t_phase)
    for n in SPATIAL_N:
        check(spatial_ok(fp64[n]), f"spatial n={n}, float64, against the unsharded step: "
                                   f"{fp64[n]}")
        for frame, err in preds32[n].items():
            check(err["box_rel_err"] < 1e-3 and err["prob_abs_err"] < 1e-4,
                  f"spatial n={n}, float32 predictions ({frame}): {err}")
    for n, run in across.items():
        check(spatial_ok(run["float64"]), f"spatial {n} across cards: {run['float64']}")
    return {"nms": launches[SPATIAL_N[-1]]["nms"], "preproc": launches[SPATIAL_N[-1]]["preproc"],
            "int8_conv": launches["int8_conv"]}


E2E_CONFIG = '''"""StreamYOLO-s at depth 0.33, width 0.25, 150x240: the tiny model that
chip_smoke.py trains on the synthetic video."""

from streamyolo_torch.cfgs.s_s50_onex_dfp_tal_flip import Exp as SmallExp


class Exp(SmallExp):
    def __init__(self):
        super().__init__()
        self.depth = 0.33
        self.width = 0.25
        self.input_size = (150, 240)
        self.test_size = (150, 240)
        self.random_size = None
'''


def calibration_ranges(cfg: Path, ckpt: str, load_frame, data_opts) -> dict:
    """ROADMAP C.4: each quantized layer's calibration absmax (its input's,
    as ``quant/ptq.py::calibrate_activations`` observes it: the bf16 model
    of ``tools/eval.py --fp16``, ``off_pipe``) over the first
    ``E2E_CALIB_BATCHES_FEW`` val batches, against its absmax over every
    val batch, which the int8 eval meets: a ratio above 1 is a range the
    per-tensor scale clips. The layers by ratio, worst first."""
    from streamyolo_torch.exp import get_exp
    from streamyolo_torch.quant.ptq import calibrate_activations, flax_module_path
    from streamyolo_torch.tools.eval import load_checkpoint
    from streamyolo_torch.utils.weights import merge_state_dict

    exp = get_exp(str(cfg)).merge(data_opts)
    exp.compute_dtype = "bfloat16"
    model = exp.get_model("cuda")
    model.load_state_dict(merge_state_dict(exp.init_model(), load_checkpoint(ckpt), strict=True))
    batches = [b[0] for b in exp.get_evaluator(E2E_EVAL_BATCH, load_frame=load_frame).dataloader]
    few = calibrate_activations(model, batches[:E2E_CALIB_BATCHES_FEW])
    full = calibrate_activations(model, batches)
    layers = sorted(({"layer": flax_module_path(n), "calib": float(few[n].max()),
                      "all": float(full[n].max()),
                      "ratio": float(full[n].max()) / max(float(few[n].max()), 1e-30)}
                     for n in full), key=lambda r: -r["ratio"])
    return {"batches": len(batches), "calib_batches": E2E_CALIB_BATCHES_FEW,
            "layers": len(layers), "clipped": sum(r["ratio"] > 1 for r in layers),
            "worst": layers[:8]}


def phase_trained_e2e(out_dir: Path) -> dict:
    """Train a tiny StreamYOLO with the port and score it five ways (the
    done criterion of ROADMAP item 9). The synthetic video at its defaults
    (4 x 75 frames, raw 300x480, 150x240 model input) with objects of 1/8 to
    1/4 of the frame is the train AND the val split (``make_synthetic_argoverse``
    writes every split from one video): this shows that the pipeline learns
    and keeps its accuracy through streaming, not that it generalises.
    ``tools/train.py`` trains ``E2E_EPOCHS`` epochs at batch ``E2E_BATCH``
    under bf16 autocast (SGD, LR ``E2E_LR_PER_IMG`` per image, a one-epoch
    warmup and a cosine to 0.05 of it; no per-epoch eval: (a) scores the
    EMA). Then, on the EMA weights: (a) ``tools/eval.py`` (dedup and
    ``--no-dedup``, float and ``--int8``), (b) ``stream_det`` under the wall
    clock with ``--device-preproc`` and ``streaming_eval`` against the
    annotations, (c) ``--sim-zoo`` at (b)'s measured runtimes, (d) at
    ``E2E_SLOW_S``, (e) ``forecast_kf`` on (d). The int8 eval calibrates
    on ``E2E_CALIB_BATCHES``; one on ``E2E_CALIB_BATCHES_FEW`` and each
    layer's calibration range against the eval's are reported beside it
    (ROADMAP C.4). Checks: (a) AP50 >= 20, the
    int8 AP50 within 5 and AP within 8 points of the float eval's, and
    (ROADMAP C.1) the dedup rows against the ``--no-dedup`` rows,
    box-matched, within the guard's bf16 tolerance with at most
    ``E2E_UNMATCHED_MAX`` of the rows unmatched, float and int8; (d) sAP <
    (c) sAP; (b) and (c) within 2 sAP."""
    import torch

    from streamyolo_torch.data import SyntheticArgoverse
    from streamyolo_torch.exp import get_exp
    from streamyolo_torch.ops.int8_conv import int8_conv
    from streamyolo_torch.ops.nms_cuda import nms_keep
    from streamyolo_torch.ops.preproc import downsample2x
    from streamyolo_torch.stream import add_to_runtime_zoo
    from streamyolo_torch.tools import eval as eval_tool
    from streamyolo_torch.tools import forecast_kf, stream_det, streaming_eval
    from streamyolo_torch.tools import train as train_tool

    synth = SyntheticArgoverse(seq_lens=(E2E_FRAMES,) * E2E_SEQS, size=E2E_RAW, seed=SEED,
                               obj_frac=E2E_OBJ_FRAC)
    ann_dir = out_dir / "Argoverse-HD" / "annotations"
    ann_dir.mkdir(parents=True, exist_ok=True)
    for split in ("train.json", "val.json"):
        (ann_dir / split).write_text(json.dumps(synth.data))
    annot = str(ann_dir / "val.json")
    cfg = out_dir / "tiny_s.py"
    cfg.write_text(E2E_CONFIG)
    # no loader workers in the evals either: each eval's loader (and the int8
    # calibration's) would spawn them anew, ~40 s each on the card's host
    data_opts = ["data_dir", str(out_dir), "output_dir", str(out_dir / "runs"),
                 "data_num_workers", str(E2E_WORKERS)]
    launches = {}

    def counted(name, fn):
        nms_keep.launches = 0
        downsample2x.launches = 0
        int8_conv.launches = 0
        out = fn()
        launches[name] = {"nms": nms_keep.launches, "preproc": downsample2x.launches,
                          "int8_conv": int8_conv.launches}
        return out

    t0 = time.perf_counter()
    trainer = counted("train", lambda: train_tool.main(
        ["-f", str(cfg), "-b", str(E2E_BATCH), "--fp16", "-d", "1", "-expn", "tiny", *data_opts,
         "max_epoch", str(E2E_EPOCHS), "no_aug_epochs", str(E2E_EPOCHS),
         "eval_interval", str(E2E_EPOCHS + 1), "warmup_epochs", "1", "scheduler", "warmcos",
         "basic_lr_per_img", str(E2E_LR_PER_IMG), "save_history_ckpt", "False",
         "print_interval", "9", "seed", str(SEED)],
        load_frame=synth.frame))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    steps = trainer.state.step
    losses = [float(v) for v in trainer.meter["total_loss"]._deque]
    warm_ms = [ms for _, ms, _ in trainer.step_log[1:] if ms is not None]
    del trainer
    ckpt = str(out_dir / "runs" / "tiny" / "latest_ckpt.pth")

    # (a) the offline pseudo-streaming eval through the eval CLI, dedup and
    # dual-frame, float and int8 PTQ (calibrated on the first
    # E2E_CALIB_BATCHES val batches)
    offline = {}
    int8_args = ["--int8", "--calib-batches", str(E2E_CALIB_BATCHES)]
    few_args = ["--int8", "--calib-batches", str(E2E_CALIB_BATCHES_FEW)]
    for name, extra in (("dedup", []), ("no_dedup", ["--no-dedup"]), ("int8", int8_args),
                        ("int8_no_dedup", [*int8_args, "--no-dedup"]),
                        ("int8_calib_few", few_args)):
        res = counted(f"eval_{name}", lambda extra=extra: eval_tool.main(
            ["-f", str(cfg), "-c", ckpt, "-b", str(E2E_EVAL_BATCH), "--fp16", "-expn",
             f"eval_{name}", *extra, *data_opts], load_frame=synth.frame))
        offline[name] = res
    a = {k: {"AP": 100 * offline[k]["ap"], "AP50": 100 * offline[k]["ap50"],
             "rows": len(offline[k]["rows"])} for k in offline}
    int8_gaps = {k: {"AP": a["dedup"]["AP"] - a[k]["AP"], "AP50": a["dedup"]["AP50"] - a[k]["AP50"]}
                 for k in ("int8", "int8_calib_few")}
    ranges = calibration_ranges(cfg, ckpt, synth.frame, data_opts)
    # ROADMAP C.1: every batch of the dedup eval against the dual-frame
    # eval, box-matched, within the guard's bf16 tolerance at the model's
    # input scale
    e2e_exp = get_exp(str(cfg))
    e2e_exp.compute_dtype = "bfloat16"
    box_tol, score_tol = e2e_exp.dedup_tolerance()
    px = E2E_RAW[1] / e2e_exp.test_size[1]  # raw pixels per model-input pixel
    c1 = {}
    for name, dedup, dual in (("float", "dedup", "no_dedup"), ("int8", "int8", "int8_no_dedup")):
        gap = matched_rows(offline[dedup]["rows"], offline[dual]["rows"])
        gap["box_max_model_px"] = gap["box_max_abs"] / px
        c1[name] = gap

    # (b)-(d) the real-time CLI on the same weights, (e) the forecast
    common = ["--data-root", str(out_dir), "--annot-path", annot, "-f", str(cfg), "-c", ckpt,
              "--device-preproc", "--overwrite"]
    zoo = out_dir / "zoo.pkl"
    with open(zoo, "wb") as f:
        pickle.dump({"slow": {"type": "empirical", "samples": [E2E_SLOW_S]}}, f)
    scored = {}

    def scored_run(name, *extra):
        run_dir = out_dir / name
        counted(name, lambda: stream_det.main([*common, "--out-dir", str(run_dir), *extra],
                                              load_frame=synth.frame))
        summary, assoc = streaming_eval.main(["--annot-path", annot, "--result-dir",
                                              str(run_dir), "--overwrite"])
        scored[name] = {**stats_of(summary), **run_summary(run_dir, E2E_SEQS),
                        "association": assoc}

    scored_run("wall")
    add_to_runtime_zoo(str(out_dir / "wall" / "time_info.pkl"), str(zoo), "measured")
    scored_run("sim_measured", "--sim-zoo", str(zoo), "--sim-name", "measured")
    scored_run("sim_45ms", "--sim-zoo", str(zoo), "--sim-name", "slow")
    fk = forecast_kf.main(["--annot-path", annot, "--in-dir", str(out_dir / "sim_45ms"),
                           "--out-dir", str(out_dir / "forecast_45ms")])
    scored["forecast_45ms"] = {**stats_of(fk["summary"]), "association": fk["assoc"]}

    n_frames = E2E_SEQS * E2E_FRAMES
    table = [{"run": "(a) tools/eval.py, dedup", "sAP": a["dedup"]["AP"],
              "sAP50": a["dedup"]["AP50"], "frames": f"{n_frames}/{n_frames}"}]
    for key, label in (("wall", "(b) stream_det, wall clock"),
                       ("sim_measured", "(c) --sim-zoo at the measured step"),
                       ("sim_45ms", "(d) --sim-zoo at 45 ms"),
                       ("forecast_45ms", "(e) forecast_kf on (d)")):
        r = scored[key]
        frames = r.get("processed", scored["sim_45ms"]["processed"])  # (e) forecasts (d)
        table.append({"run": label, "sAP": r["sAP"], "sAP50": r["sAP50"],
                      "frames": f"{frames}/{n_frames}"})
    emit("trained_e2e", config="s_s50_onex_dfp_tal_flip depth 0.33 width 0.25, 150x240",
         fixture=f"{E2E_SEQS}x{E2E_FRAMES} frames {E2E_RAW[0]}x{E2E_RAW[1]} synthetic, "
                 f"obj_frac {list(E2E_OBJ_FRAC)}, train = val",
         recipe={"batch": E2E_BATCH, "epochs": E2E_EPOCHS, "steps": steps,
                 "lr": E2E_LR_PER_IMG * E2E_BATCH, "scheduler": "warmcos, 1 warmup epoch",
                 "fp16": "bf16 autocast", "workers": E2E_WORKERS,
                 "eval_batch": E2E_EVAL_BATCH},
         train_s=train_s, train_step_ms_median=statistics.median(warm_ms) if warm_ms else None,
         losses_last_window=losses, table=table,
         offline_eval=a, int8_calib_batches={"checked": E2E_CALIB_BATCHES,
                                             "reported": E2E_CALIB_BATCHES_FEW},
         int8_gap_points=int8_gaps, calibration_ranges=ranges,
         dedup_vs_no_dedup_rows_cudnn=c1, scores=scored,
         launches=launches)
    check(all(np.isfinite(losses)), f"trained_e2e: a loss is not finite: {losses}")
    check(a["dedup"]["AP50"] >= 20.0, f"trained_e2e: offline AP50 {a['dedup']['AP50']} < 20")
    check(abs(a["dedup"]["AP"] - a["no_dedup"]["AP"]) <= 0.5,
          f"trained_e2e: dedup and dual-frame AP differ: {a}")
    for name, gap in c1.items():
        check(gap["box_max_model_px"] <= box_tol and gap["score_max_abs"] <= score_tol
              and gap["unmatched_share"] <= E2E_UNMATCHED_MAX,
              f"trained_e2e C.1 ({name}): dedup rows against --no-dedup rows: {gap}")
    check(a["int8"]["AP50"] >= a["dedup"]["AP50"] - 5.0 and a["int8"]["AP"] >= a["dedup"]["AP"] - 8.0,
          f"trained_e2e: int8 loses more than 5 AP50 / 8 AP points: {a}")
    check(launches["eval_int8"]["int8_conv"] > 0, "trained_e2e: the int8 eval launched no kernel")
    check(scored["sim_45ms"]["sAP"] < scored["sim_measured"]["sAP"],
          "trained_e2e: sAP at 45 ms is not below sAP at the measured step")
    check(abs(scored["wall"]["sAP"] - scored["sim_measured"]["sAP"]) <= 2.0,
          "trained_e2e: wall-clock and simulated sAP differ by more than 2 points")
    for name in ("wall", "sim_measured", "sim_45ms"):
        called = launches[name]["nms"] - stream_det.WARMUP_FRAMES
        check(launches[name]["nms"] == launches[name]["preproc"]
              and scored[name]["processed"] <= called <= scored[name]["processed"] + E2E_SEQS,
              f"trained_e2e {name}: {launches[name]} kernel launches for "
              f"{scored[name]['processed']} results")
    return launches


def trained_exp():
    """The port's ``Exp`` of ``E2E_CONFIG``, the trained fixture's model."""
    scope = {}
    exec(E2E_CONFIG, scope)
    return scope["Exp"]()


def trained_streams() -> np.ndarray:
    """The trained fixture's raw frames, ``[streams, TRAINED_STEPS, 300,
    480, 3]`` uint8, cut from phase ``trained_e2e``'s synthetic video made
    from ``SEED``: stream ``(s, o)`` shows sequence ``s`` from frame ``o``."""
    from streamyolo_torch.data import SyntheticArgoverse

    synth = SyntheticArgoverse(seq_lens=(E2E_FRAMES,) * E2E_SEQS, size=E2E_RAW, seed=SEED,
                               obj_frac=E2E_OBJ_FRAC)
    images = synth.data["images"]  # in sequence, then frame order
    return np.stack([np.stack([synth.frame(img) for img in
                               [i for i in images if i["sid"] == s][o:o + TRAINED_STEPS]])
                     for s in TRAINED_SEQS for o in TRAINED_OFFSETS])


def trained_model(dtype, device):
    """``trained_exp``'s model in ``dtype`` on ``device`` holding the
    fixture's bf16 weights (exact in every dtype)."""
    from streamyolo_torch.utils.weights import load_state_dict_file

    model = trained_exp().get_model(device, dtype=dtype)
    model.load_state_dict(load_state_dict_file(str(TRAINED_FIXTURE / "weights.safetensors")),
                          strict=True)
    return model


def detector_streams(det, frames: np.ndarray):
    """``frames`` ``[S, T, H, W, 3]`` through ``det`` (a
    ``CUDAStreamDetector``, reset before each stream, or a
    ``MultiStreamDetector`` of ``S`` streams fed one step of every stream
    at a time): the rows ``[S, T, K, 8]`` and the model's decoded
    predictions ``[S, T, anchors, 5 + C]`` as float64."""
    seen = []
    hook = det.model.register_forward_hook(
        lambda mod, inp, out: seen.append(out[0].double().cpu().numpy()))
    rows = []
    try:
        if hasattr(det, "n_streams"):
            det.reset()
            for t in range(frames.shape[1]):
                det(frames[:, t])
                rows.append(det.last_rows)
            rows, preds = np.stack(rows, 1), np.stack(seen, 1)
        else:
            for stream in frames:
                det.reset()
                for frame in stream:
                    det(frame)
                    rows.append(det.last_rows)
            shape = frames.shape[:2]
            rows = np.stack(rows).reshape(*shape, *rows[0].shape)
            preds = np.concatenate(seen).reshape(*shape, *seen[0].shape[1:])
    finally:
        hook.remove()
    return rows, preds


def block_rows(blocks: np.ndarray) -> list:
    """``[..., K, 8]`` row blocks as ``det_rows``, one image id per block
    (in C order), for ``matched_rows``."""
    flat = blocks.reshape(-1, *blocks.shape[-2:])
    return [r for i, b in enumerate(flat) for r in det_rows(b, i)]


def golden_candidates(preds: np.ndarray, golden) -> tuple:
    """Decoded predictions ``[S, T, anchors, 5 + C]`` at the golden
    anchors (those the JAX float32 model scores above ``CONF``): boxes (cx,
    cy, w, h in raw pixels) and scores (obj x the largest class
    probability), as the golden file holds them."""
    flat = preds.reshape(-1, *preds.shape[2:])[golden["cand_image"], golden["cand_anchor"]]
    return flat[:, :4] / TRAINED_IN_SCALE, flat[:, 4] * flat[:, 5:].max(-1)


def candidate_gaps(box, score, ref_box, ref_score) -> dict:
    """The largest and the mean box gap (raw px) and score gap of two
    runs' candidates."""
    db, ds = np.abs(box - ref_box), np.abs(score - ref_score)
    return {"candidates": int(len(ds)), "box_px": float(db.max()),
            "box_px_mean": float(db.mean()), "score": float(ds.max()),
            "score_mean": float(ds.mean())}


def golden_gaps(golden, dtype: str, box, score) -> dict:
    """``candidate_gaps`` of ``box``, ``score`` against the golden
    candidates of ``dtype`` (``float32`` or ``bfloat16``)."""
    return candidate_gaps(box, score, golden[f"cand_box_{dtype}"], golden[f"cand_score_{dtype}"])


def rows_within(gap: dict, bound: dict) -> bool:
    """A ``matched_rows`` result within a bound of the unmatched share, the
    largest box gap (px) and the largest score gap."""
    return (gap["unmatched_share"] <= bound["unmatched_share"]
            and gap["box_max_abs"] <= bound["box_px"] and gap["score_max_abs"] <= bound["score"])


def candidates_within(gap: dict, jax_gap: dict, allowance: float = 0.0) -> bool:
    """ROADMAP C.2 on decoded candidates: each statistic of a bf16 run's gap
    to JAX float32 (largest and mean, box and score) at most
    ``1 + TRAINED_CAND_MARGIN + allowance`` times JAX bf16's gap to JAX
    float32."""
    scale = 1.0 + TRAINED_CAND_MARGIN + allowance
    return all(gap[k] <= scale * jax_gap[k] for k in ("box_px", "box_px_mean", "score",
                                                      "score_mean"))


def phase_trained_bf16(smi: str) -> dict:
    """ROADMAP C.2 and C.3 on the card, against the committed trained
    fixture (``TRAINED_FIXTURE``): the port's rows in the precision the card
    serves in, held to the JAX package's own bf16 rows, which ``python -m
    tests.torch_trained_fixture`` wrote on a CPU with the JAX package and
    ``tests/test_torch_trained_bf16.py`` re-derives there. No training here.
    Checks: the weights' and the frames' sha256 (the frames made here from
    ``SEED``) as ``meta.json`` holds them; (C.2) ``CUDAStreamDetector`` in
    bf16 with ``device_preproc`` (B1 and B2 once a frame) against the golden
    JAX bf16 rows within ``TRAINED_BF16_ROWS`` widened by
    ``TRAINED_CUDNN_ALLOWANCE``, its decoded candidates within
    ``candidates_within`` (the same allowance); in float32 (TF32 off,
    ``device_preproc``) against the golden float32 rows within
    ``TRAINED_FP32_ROWS``; (C.3) ``MultiStreamDetector`` at N = 8 in bf16,
    the 8 streams as one batch (one B1 launch a step): all rows and each
    stream's against the golden bf16 rows (the same bound; a stream's
    unmatched share within ``TRAINED_STREAM_UNMATCHED``), and against the
    single-stream detector within ``TRAINED_MULTI_ROWS``. Reported: the
    card's bf16 against the port's bf16 on this host's CPU (what the
    allowance measures) and the CPU's against JAX bf16."""
    import torch

    from streamyolo_torch.ops.nms_cuda import nms_keep
    from streamyolo_torch.ops.preproc import downsample2x
    from streamyolo_torch.stream import CUDAStreamDetector, MultiStreamDetector

    t_phase = time.perf_counter()
    meta = json.loads((TRAINED_FIXTURE / "meta.json").read_text())
    weights = hashlib.sha256((TRAINED_FIXTURE / "weights.safetensors").read_bytes()).hexdigest()
    frames = trained_streams()
    check(weights == meta["weights_sha256"], "trained_bf16: the weights differ from meta.json's")
    check(hashlib.sha256(frames.tobytes()).hexdigest() == meta["frames_sha256"],
          "trained_bf16: the frames made here differ from the fixture's")
    with np.load(TRAINED_FIXTURE / "golden.npz") as f:
        golden = dict(f)
    kw = dict(input_size=tuple(trained_exp().test_size), in_scale=TRAINED_IN_SCALE,
              conf_thre=CONF, nms_thre=NMS, num_classes=NCLS, pre_nms_topk=TOPK)

    def single(dtype, device, **extra):
        return CUDAStreamDetector(trained_model(dtype, device), use_bf16=dtype == torch.bfloat16,
                                  device=device, **kw, **extra)

    launches, runs = {}, {}

    def counted(name, make):
        det = make()
        nms_keep.launches = 0
        downsample2x.launches = 0
        runs[name] = detector_streams(det, frames)
        launches[name] = {"nms": nms_keep.launches, "preproc": downsample2x.launches}

    # cuDNN's heuristic algorithms, as a detector serves (an earlier phase's
    # eval CLI leaves cudnn.benchmark on, which picks them by timing)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False):
        counted("card_bf16", lambda: single(torch.bfloat16, "cuda", device_preproc=True))
        matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            with torch.backends.cudnn.flags(enabled=True, benchmark=False, allow_tf32=False):
                counted("card_fp32", lambda: single(torch.float32, "cuda", device_preproc=True))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
        counted("card_multi_bf16", lambda: MultiStreamDetector(
            trained_model(torch.bfloat16, "cuda"), len(frames), device="cuda", **kw))
    runs["cpu_bf16"] = detector_streams(single(torch.bfloat16, "cpu"), frames)

    rows = {k: block_rows(v[0]) for k, v in runs.items()}
    jax16, jax32 = block_rows(golden["rows_bfloat16"]), block_rows(golden["rows_float32"])
    gaps = {"card_bf16 vs jax_bf16": matched_rows(rows["card_bf16"], jax16),
            "card_fp32 vs jax_fp32": matched_rows(rows["card_fp32"], jax32),
            "multi_bf16 vs jax_bf16": matched_rows(rows["card_multi_bf16"], jax16),
            "multi_bf16 vs card_bf16": matched_rows(rows["card_multi_bf16"], rows["card_bf16"]),
            "card_bf16 vs cpu_bf16": matched_rows(rows["card_bf16"], rows["cpu_bf16"]),
            "cpu_bf16 vs jax_bf16": matched_rows(rows["cpu_bf16"], jax16)}
    streams = [{"vs_jax_bf16": matched_rows(block_rows(runs["card_multi_bf16"][0][s]),
                                            block_rows(golden["rows_bfloat16"][s])),
                "vs_single": matched_rows(block_rows(runs["card_multi_bf16"][0][s]),
                                          block_rows(runs["card_bf16"][0][s]))}
               for s in range(len(frames))]
    jax_cand = golden_gaps(golden, "float32", golden["cand_box_bfloat16"],
                           golden["cand_score_bfloat16"])
    cand = {k: golden_gaps(golden, "float32", *golden_candidates(runs[k][1], golden))
            for k in ("card_bf16", "card_fp32", "card_multi_bf16", "cpu_bf16")}
    allow = TRAINED_CUDNN_ALLOWANCE
    bf16_bound = {k: round(TRAINED_BF16_ROWS[k] + allow[k], 6) for k in TRAINED_BF16_ROWS}
    steps = TRAINED_STEPS * len(frames)
    emit("trained_bf16", nvidia_smi=smi, config="E2E_CONFIG, 150x240, trained fixture",
         fixture={"weights_sha256": weights, "training": meta["training"]},
         streams=len(frames), steps=TRAINED_STEPS,
         bounds={"bf16_rows": bf16_bound, "cudnn_allowance": allow,
                 "fp32_rows": TRAINED_FP32_ROWS, "stream_unmatched": TRAINED_STREAM_UNMATCHED,
                 "multi_vs_single": TRAINED_MULTI_ROWS,
                 "candidates_scale": 1 + TRAINED_CAND_MARGIN + allow["candidates"]},
         rows=gaps, multi_streams=streams, candidates_vs_jax_fp32=cand,
         jax_bf16_candidates_vs_jax_fp32=jax_cand, launches=launches,
         phase_s=time.perf_counter() - t_phase)
    check(launches["card_bf16"] == launches["card_fp32"] == {"nms": steps, "preproc": steps},
          f"trained_bf16: {launches} kernel launches for {steps} frames")
    check(launches["card_multi_bf16"] == {"nms": TRAINED_STEPS, "preproc": 0},
          f"trained_bf16: the multi-stream run launched {launches['card_multi_bf16']}")
    for name in ("card_bf16 vs jax_bf16", "multi_bf16 vs jax_bf16"):
        check(rows_within(gaps[name], bf16_bound), f"trained_bf16 C.2/C.3 {name}: {gaps[name]}")
    check(gaps["card_fp32 vs jax_fp32"]["unmatched"] == 0
          and rows_within(gaps["card_fp32 vs jax_fp32"], TRAINED_FP32_ROWS),
          f"trained_bf16 float32 rows: {gaps['card_fp32 vs jax_fp32']}")
    for name in ("card_bf16", "card_multi_bf16"):
        check(candidates_within(cand[name], jax_cand, allow["candidates"]),
              f"trained_bf16 C.2 candidates {name}: {cand[name]} against JAX bf16's {jax_cand}")
    check(rows_within(gaps["multi_bf16 vs card_bf16"], TRAINED_MULTI_ROWS),
          f"trained_bf16 C.3 multi against single: {gaps['multi_bf16 vs card_bf16']}")
    for s, gap in enumerate(streams):
        check(rows_within(gap["vs_jax_bf16"], {**bf16_bound,
                                               "unmatched_share": TRAINED_STREAM_UNMATCHED})
              and rows_within(gap["vs_single"], {**TRAINED_MULTI_ROWS,
                                                 "unmatched_share": TRAINED_STREAM_UNMATCHED}),
              f"trained_bf16 C.3 stream {s}: {gap}")
    return {"nms": sum(c["nms"] for c in launches.values()),
            "preproc": sum(c["preproc"] for c in launches.values()), "by_run": launches}


def new_path_launches(kernel: str, cli: dict, streamer: dict, trained: dict) -> dict:
    """``launches_by_path`` entries of the streaming CLI, the Streamer's
    child and the trained model's runs for one kernel (``nms``, ``preproc``)."""
    out = {f"stream_cli_{k}": v[kernel] for k, v in cli.items()}
    out["streamer_child"] = streamer[kernel]
    out.update({f"trained_e2e_{k}": v[kernel] for k, v in trained.items()})
    return out


def host_ms(fn, iters: int = IMAGE_IO_TIMED) -> float:
    """Median over ``iters`` calls of ``fn`` on the host clock (ms), after
    one call that is not timed."""
    fn()
    times = []
    for _ in range(iters):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def image_digest(arr) -> dict:
    """Shape and sha256 of an array's bytes, as ``tests/torch_jpeg/digests.json``
    holds cv2's."""
    arr = np.ascontiguousarray(arr)
    return {"shape": list(arr.shape), "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}


def phase_image_io(out_dir: Path, smi: str, device: str = "cuda") -> dict:
    """Frames from disk on the card's host, which has no cv2
    (``data/image_io.py`` over ``native/image_io.cpp``, ``resize_u8``):
    every committed fixture of ``tests/torch_jpeg`` decodes, and each
    1200x1920 frame resizes to 600x960 and 601x959, to the bytes whose
    digests cv2 wrote there (the progressive and multi-scan fixtures of
    ``progressive/`` and the arithmetic-coded, lossless, CMYK, YCCK and
    RGB-coded ones of ``codings/`` included; their 1200x1920 progressive and
    arithmetic frames to the baseline frames' digests; frame 0 made a CMYK
    and a YCCK frame by ``tests/torch_jpeg_codings.py::four_component_frame``
    to cv2's ``derived`` digests); the decode and resize times (median of
    ``IMAGE_IO_TIMED``, the NumPy twin once; a progressive, an arithmetic
    (SOF9 and SOF10) and the CMYK frame's decode beside the baseline
    frame's); StreamYOLO-l at 600x960, bf16,
    the seeded weights of ``EVAL_CONFIG``, over the three frames (a star and
    two steady): ``CUDAStreamDetector``'s host path against
    ``device_preproc`` rows bit for bit, ``MultiStreamDetector(3)`` fed the
    raw frames against its feed of ``resize_u8_reference`` frames; then the
    frames as one sequence from disk (``db_from_img_folder``) through
    ``stream_det`` under the wall clock and with ``--infinite``, and
    ``offline_det``, host path, no ``load_frame``, and ``offline_det`` again
    from the folders of progressive and of arithmetic frames, whose rows
    must equal the baseline folder's bit for bit; last the detection
    overlays of ``tools/vis_results.py`` drawn without cv2 against the JAX
    tool's file digests, and the time to label a frame (``draw_overlays``).
    Kernel launches are counted from 0 before
    each run and read after it. ``device="cpu"`` rehearses the phase
    without a card."""
    import torch

    from streamyolo_torch.data import db_from_img_folder
    from streamyolo_torch.data.cv2_ops import resize_u8, resize_u8_reference
    from streamyolo_torch.data.image_io import image_size, imdecode, imencode, imread
    from streamyolo_torch.exp import get_exp
    from streamyolo_torch.ops.nms_cuda import nms_keep
    from streamyolo_torch.ops.preproc import downsample2x
    from streamyolo_torch.stream import CUDAStreamDetector, MultiStreamDetector, add_to_runtime_zoo
    from streamyolo_torch.tools import offline_det, stream_det
    from tests.torch_jpeg_codings import four_component_frame

    t_phase = time.perf_counter()
    out_dir.mkdir(parents=True, exist_ok=True)
    digests = json.loads((JPEG_FIXTURES / "digests.json").read_text())
    frames = {}
    for rel, want in sorted(digests["decode"].items()):
        img = imread(JPEG_FIXTURES / rel)
        check(image_digest(img) == want, f"image_io: {rel} decodes to other bytes than cv2's")
        check(list(image_size(JPEG_FIXTURES / rel)) == want["shape"][:2],
              f"image_io: image_size of {rel} is not cv2's")
        if rel in digests["resize"]:
            frames[rel] = img
            for key, d in digests["resize"][rel].items():
                oh, ow = map(int, key.split("x"))
                check(image_digest(resize_u8(img, oh, ow)) == d,
                      f"image_io: resize of {rel} to {key} differs from cv2's")
    raws = [frames[k] for k in sorted(frames)]
    check(len(raws) == 3, f"image_io: {len(raws)} full-size frames in the fixtures")
    progressive = sorted(rel for rel in digests["decode"] if rel.startswith("progressive/"))
    prog_frames = [rel for rel in progressive if rel.startswith("progressive/frames/")]
    check(len(prog_frames) == 3 and all(
        digests["decode"][rel] == digests["decode"][rel[len("progressive/"):]]
        for rel in prog_frames),
        "image_io: the progressive frames' digests are not the baseline frames'")
    codings = sorted(rel for rel in digests["decode"] if rel.startswith("codings/"))
    arith_frames = [rel for rel in codings if rel.startswith("codings/frames/")]
    check(len(arith_frames) == 3 and all(
        digests["decode"][rel] == digests["decode"][rel[len("codings/"):]]
        for rel in arith_frames),
        "image_io: the arithmetic frames' digests are not the baseline frames'")
    # frame 0 as a 4-component (CMYK, YCCK) frame, against cv2's digests
    four = {name: four_component_frame((JPEG_FIXTURES / sorted(frames)[0]).read_bytes(), t)
            for name, t in (("cmyk_frame", 0), ("ycck_frame", 2))}
    for name, data in four.items():
        check(image_digest(imdecode(data)) == digests["derived"][name],
              f"image_io: the {name} decodes to other bytes than cv2's")
    # the encoder: each frame at quality 90 and 95 to cv2.imencode's bytes
    for rel, by_quality in sorted(digests["encode"].items()):
        for key, want in by_quality.items():
            data = imencode(frames[rel], int(key[1:]))
            check(len(data) == want["size"]
                  and hashlib.sha256(data).hexdigest() == want["sha256"],
                  f"image_io: imencode of {rel} at {key} differs from cv2.imencode")
    # PNG: each committed file decodes to cv2.imread's bytes
    for rel, want in sorted(digests["png"].items()):
        check(image_digest(imread(JPEG_FIXTURES / rel)) == want
              and list(image_size(JPEG_FIXTURES / rel)) == want["shape"][:2],
              f"image_io: {rel} decodes to other bytes or size than cv2's")
    first = sorted(frames)[0]
    data = (JPEG_FIXTURES / first).read_bytes()
    prog_data = (JPEG_FIXTURES / prog_frames[0]).read_bytes()
    arith_data = (JPEG_FIXTURES / arith_frames[0]).read_bytes()
    arith_prog_data = (JPEG_FIXTURES / arith_frames[2]).read_bytes()
    check(b"\xff\xc9" in arith_data and b"\xff\xca" in arith_prog_data,
          "image_io: the arithmetic frames are not SOF9 and SOF10")
    times = {"decode_ms": host_ms(lambda: imdecode(data)),
             "imread_ms": host_ms(lambda: imread(JPEG_FIXTURES / first)),
             "progressive_decode_ms": host_ms(lambda: imdecode(prog_data)),
             "progressive_imread_ms": host_ms(lambda: imread(JPEG_FIXTURES / prog_frames[0])),
             "arithmetic_decode_ms": host_ms(lambda: imdecode(arith_data)),
             "arithmetic_progressive_decode_ms": host_ms(lambda: imdecode(arith_prog_data)),
             "cmyk_decode_ms": host_ms(lambda: imdecode(four["cmyk_frame"])),
             **{f"resize_{h}x{w}_ms": host_ms(lambda: resize_u8(raws[0], h, w))
                for h, w in IMAGE_IO_SIZES}}
    t = time.perf_counter()
    resize_u8_reference(raws[0], *INPUT)
    times["reference_resize_600x960_ms"] = (time.perf_counter() - t) * 1e3

    exp = get_exp(exp_name=EVAL_CONFIG)
    exp.compute_dtype = "bfloat16"
    state = lifted_state(exp)
    model = exp.get_model(device)
    model.load_state_dict(state)
    kw = dict(input_size=INPUT, in_scale=0.5, conf_thre=CONF, nms_thre=NMS,
              num_classes=NCLS, pre_nms_topk=TOPK, use_bf16=True, device=device)
    launches, rows = {}, {}

    def counted(name, fn):
        nms_keep.launches = 0
        downsample2x.launches = 0
        out = fn()
        launches[name] = {"nms": nms_keep.launches, "preproc": downsample2x.launches}
        return out

    def serve(det, feed, preprocessed=False):
        det.reset()
        out = []
        for batch in feed:
            det(batch, preprocessed=preprocessed)
            out.append(det.last_rows.copy())
        return out

    host = CUDAStreamDetector(model, **kw)
    devpre = CUDAStreamDetector(model, device_preproc=True, **kw)
    multi_raw = MultiStreamDetector(model, len(raws), **kw)
    multi_pre = MultiStreamDetector(model, len(raws), **kw)
    for det in (host, devpre, multi_raw, multi_pre):
        det.warmup(2)
    batches = [[raws[(s + t) % len(raws)] for s in range(len(raws))] for t in range(len(raws))]
    reference = [np.stack([resize_u8_reference(f, *INPUT) for f in b]) for b in batches]
    rows["host"] = counted("host", lambda: serve(host, raws))
    rows["device_preproc"] = counted("device_preproc", lambda: serve(devpre, raws))
    rows["multi_stream_raw"] = counted("multi_stream_raw", lambda: serve(multi_raw, batches))
    rows["multi_stream_preprocessed"] = counted(
        "multi_stream_preprocessed", lambda: serve(multi_pre, reference, preprocessed=True))
    n = len(raws)
    k = n if device == "cuda" else 0  # a kernel's wrapper launches it only on a card
    check(all(np.array_equal(a, b) for a, b in zip(rows["host"], rows["device_preproc"])),
          "image_io: host-path rows differ from device_preproc rows")
    check(all(np.array_equal(a, b) for a, b in zip(rows["multi_stream_raw"],
                                                  rows["multi_stream_preprocessed"])),
          "image_io: MultiStreamDetector on raw frames differs from its preprocessed feed")
    check(launches == {"host": {"nms": k, "preproc": 0},
                       "device_preproc": {"nms": k, "preproc": k},
                       "multi_stream_raw": {"nms": k, "preproc": 0},
                       "multi_stream_preprocessed": {"nms": k, "preproc": 0}},
          f"image_io: kernel launches {launches} for {n} steps a detector")
    kept = [int((r[..., 7] > 0.5).sum()) for r in rows["host"]]
    times["host_path_wall_ms"] = host_ms(lambda: host(raws[1]))
    times["device_preproc_wall_ms"] = host_ms(lambda: devpre(raws[1]))

    annot = out_dir / "frames.json"
    db = db_from_img_folder(str(JPEG_FIXTURES / "frames"), out_path=str(annot))
    check([(i["name"], i["height"], i["width"]) for i in db["images"]]
          == [(Path(k).name, *frames[k].shape[:2]) for k in sorted(frames)],
          "image_io: db_from_img_folder does not list the frames at their sizes")
    weights = out_dir / "l_seed0.pth"
    torch.save(state, weights)
    common = ["--data-root", str(JPEG_FIXTURES / "frames"), "--annot-path", str(annot),
              "-f", f"cfgs/{EVAL_CONFIG}.py", "-c", str(weights), "--device", device]
    cli_s = {}

    def cli(name, tool, *extra):
        t = time.perf_counter()
        out = counted(name, lambda: tool.main(
            [*common, "--out-dir", str(out_dir / name), *extra]))
        cli_s[name] = time.perf_counter() - t
        return out

    cli("wall", stream_det, "--overwrite")
    zoo = str(out_dir / "zoo.pkl")
    add_to_runtime_zoo(str(out_dir / "wall" / "time_info.pkl"), zoo, "wall")
    inf = cli("infinite", stream_det, "--sim-zoo", zoo, "--sim-name", "wall", "--infinite")
    off = cli("offline_det", offline_det, "--no-eval")
    prog_root = JPEG_FIXTURES / "progressive" / "frames"
    prog_annot = out_dir / "progressive_frames.json"
    check(db_from_img_folder(str(prog_root), out_path=str(prog_annot))["images"] == db["images"],
          "image_io: db_from_img_folder of the progressive frames differs from the baseline's")
    off_prog = cli("offline_det_progressive", offline_det, "--no-eval",
                   "--data-root", str(prog_root), "--annot-path", str(prog_annot))
    check(off_prog["results_ccf"] == off["results_ccf"]
          and launches["offline_det_progressive"] == {"nms": k, "preproc": 0},
          "image_io: offline_det from the progressive frames: rows differ from the baseline "
          f"folder's, or launches {launches['offline_det_progressive']}")
    arith_root = JPEG_FIXTURES / "codings" / "frames"
    arith_annot = out_dir / "arithmetic_frames.json"
    check(db_from_img_folder(str(arith_root), out_path=str(arith_annot))["images"]
          == db["images"],
          "image_io: db_from_img_folder of the arithmetic frames differs from the baseline's")
    off_arith = cli("offline_det_arithmetic", offline_det, "--no-eval",
                    "--data-root", str(arith_root), "--annot-path", str(arith_annot))
    check(off_arith["results_ccf"] == off["results_ccf"]
          and launches["offline_det_arithmetic"] == {"nms": k, "preproc": 0},
          "image_io: offline_det from the arithmetic frames: rows differ from the baseline "
          f"folder's, or launches {launches['offline_det_arithmetic']}")
    wall = run_summary(out_dir / "wall", 1)
    check(wall["processed"] >= 1 and launches["wall"]["preproc"] == 0,
          f"image_io: stream_det from disk: {wall}, launches {launches['wall']}")
    # --infinite calls the detector on every frame (a result that lands
    # past the 3 frames' horizon is not recorded)
    warm = stream_det.WARMUP_FRAMES if device == "cuda" else 0
    check(len(inf["seq00"]["timestamps"]) >= 1
          and launches["infinite"] == {"nms": warm + k, "preproc": 0},
          f"image_io: stream_det --infinite from disk: launches {launches['infinite']}")
    check({r["image_id"] for r in off["results_ccf"]} == set(range(n))
          and launches["offline_det"] == {"nms": k, "preproc": 0},
          f"image_io: offline_det from disk: launches {launches['offline_det']}")
    drawing = draw_overlays(out_dir / "vis", raws[0])
    cv2_loaded = sys.modules.get("cv2") is not None
    check(not cv2_loaded, "image_io: cv2 was imported")
    emit("image_io", fixtures=len(digests["decode"]), png_fixtures=len(digests["png"]),
         progressive_fixtures=len(progressive), codings_fixtures=len(codings),
         encodes=sum(len(v) for v in digests["encode"].values()), digests_equal=True,
         progressive_frames_equal_baseline=True, arithmetic_frames_equal_baseline=True,
         four_component_frames_equal_cv2=sorted(four),
         frame="1200x1920 baseline 4:2:0 q90 (the JAX generator's)",
         progressive_frame="the same pixels, cv2's progressive script at q90",
         arithmetic_frames="the baseline frames' coefficients arithmetic-coded: SOF9, SOF9 "
                           "with DAC and restarts, SOF10 (libjpeg's progressive script)",
         cmyk_frame="frame 0 with a fourth component (a second scan, K 128) and Adobe "
                    "transform 0",
         times=times, nvidia_smi=smi,
         model=f"StreamYOLO-{MODEL_SIZE}", input=list(INPUT), dtype="bfloat16",
         host_rows_equal_device_preproc=True, multi_stream_raw_equal_preprocessed=True,
         kept_rows=kept, stream_det_wall=wall,
         infinite_results=len(inf["seq00"]["timestamps"]),
         offline_detections=len(off["results_ccf"]),
         offline_det_progressive_rows_equal=True, offline_det_arithmetic_rows_equal=True,
         cli_s=cli_s, launches=launches, drawing=drawing,
         cv2_loaded=cv2_loaded, seconds=time.perf_counter() - t_phase)
    return launches


def draw_overlays(out_dir: Path, frame: np.ndarray) -> dict:
    """The port's ``tools/vis_results.py`` without cv2 on the committed
    overlay fixture (``tests/torch_vis``: seeded detection rows on the three
    1200x1920 frames, runs plain, ``--vis-scale 0.75`` and ``--contrast``
    with the swing divider): every written file's sha256 must be the JAX
    tool's (cv2's ``rectangle``, ``putText`` and ``imwrite``), pinned in
    ``digests.json`` by the CPU tests. Then the host time to label one frame
    (``vis.draw_detections`` of frame 0's rows at ``--score-th 0.3``,
    median of ``IMAGE_IO_TIMED``). Last the videos (``tests/torch_video``):
    ``vis.make_video`` on the seeded sequences and the plain run again with
    ``--video``, each MP4's sha256 against ``digests.json`` (the bytes cv2
    reads back within bounds of the JAX package's file on the CPU), and the
    host time to encode one 1200x1920 frame (``VideoWriter.write`` of frame
    0 rolled 7 px a call, mostly P-VOPs, median of ``IMAGE_IO_TIMED``)."""
    from streamyolo_torch.data.argoverse_classes import ARGOVERSE_CLASSES
    from streamyolo_torch.vis import draw_detections
    from streamyolo_torch.vis.video import VideoWriter
    from streamyolo_torch.tools import vis_results
    from tests.torch_video import fixture as video_fixture
    from tests.torch_vis import fixture

    pinned = json.loads(fixture.DIGESTS.read_text())
    results = fixture.write_results(out_dir / "results")
    with contextlib.redirect_stdout(io.StringIO()):
        for run in fixture.RUNS:
            vis_results.main(fixture.tool_args(run, out_dir / run, results))
    for run in fixture.RUNS:
        got = fixture.file_digests(out_dir / run)
        check(got == pinned[run], f"image_io: vis_results {run} wrote {got}, the JAX tool "
                                  f"{pinned[run]}")
    rows = [r for r in json.loads(fixture.DETECTIONS.read_text()) if r["image_id"] == 0]
    boxes = [[x, y, x + w, y + h] for x, y, w, h in (r["bbox"] for r in rows)]
    labels = [r["category_id"] for r in rows]
    scores = [r["score"] for r in rows]
    label = lambda: draw_detections(frame, boxes, labels, ARGOVERSE_CLASSES, scores=scores,
                                    score_th=0.3)
    label_ms = host_ms(label)
    pinned_videos = json.loads(video_fixture.DIGESTS.read_text())
    t = time.perf_counter()
    videos = video_fixture.write_port_videos(out_dir / "video")
    videos_s = time.perf_counter() - t
    check(videos == pinned_videos, f"image_io: make_video wrote {videos}, pinned {pinned_videos}")
    rolled = itertools.cycle([np.roll(frame, 7 * i, axis=1) for i in range(5)])
    with VideoWriter(str(out_dir / "video" / "timed.mp4"), 30.0, frame.shape[1::-1]) as writer:
        encode_ms = host_ms(lambda: writer.write(next(rolled)))
    return {"vis_results_files": sum(len(v) for v in pinned.values()),
            "vis_results_digests_equal_jax_tool": True,
            "label_frame_ms": label_ms, "labels_per_frame": sum(s >= 0.3 for s in scores),
            "frame": list(frame.shape[:2]), "videos": sorted(videos),
            "video_digests_equal_pinned": True, "make_videos_s": videos_s,
            "encode_ms_per_frame": encode_ms}


def png_of(frame: np.ndarray) -> bytes:
    """A [H, W, 3] BGR frame as an RGB PNG whose rows all use the Paeth
    filter (the costliest to undo), deflated by ``zlib``: a file to time the
    port's PNG reading on, built without an encoder."""
    import struct
    import zlib

    rgb = frame[..., ::-1].astype(np.int16).reshape(frame.shape[0], -1)
    a = np.zeros_like(rgb)
    a[:, 3:] = rgb[:, :-3]  # the left neighbour, one pixel (3 bytes) back
    b = np.zeros_like(rgb)
    b[1:] = rgb[:-1]  # the row above
    c = np.zeros_like(rgb)
    c[1:, 3:] = rgb[:-1, :-3]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    rows = np.concatenate([np.full((len(rgb), 1), 4, np.uint8),
                           ((rgb - pred) & 0xFF).astype(np.uint8)], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    h, w = frame.shape[:2]
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def phase_from_disk(out_dir: Path, smi: str, device: str = "cuda") -> dict:
    """The Argoverse-HD layout written and read on the card's host, which has
    no cv2. ``make_synthetic_argoverse`` writes the offline eval's fixture
    (``EVAL_SEQS`` x ``EVAL_FRAMES`` frames of 1200x1920, quality 90,
    ``SEED``) with the port's JPEG encoder, each file's sha256 held to what
    the JAX package writes with cv2 (``tests/torch_jpeg/digests.json``);
    ``tools/eval.py``'s entry scores StreamYOLO-l at 600x960 (bf16, batch
    ``EVAL_BATCH``, the seeded weights of ``EVAL_CONFIG``) from those files
    with no ``load_frame``, and its COCO rows must equal bit for bit the
    same eval fed ``imdecode(imencode(frame, 90))`` in memory; then
    ``tools/sap_rehearsal.py`` without ``--in-memory`` writes its own
    ``REHEARSAL_SEQS`` x ``FROM_DISK_REHEARSAL_FRAMES`` fixture under this
    phase's directory and streams it from disk (host path, measured
    latencies, the annotations as ground truth). Times ``imencode`` of a
    frame at quality 90 and the PNG decode of a 1200x1920 frame (medians of
    ``IMAGE_IO_TIMED``, host clock). Kernel launches are counted from 0
    before each run and read after it. ``device="cpu"`` rehearses the
    phase without a card."""
    import shutil

    import torch

    from streamyolo_torch.data import SyntheticArgoverse, make_synthetic_argoverse
    from streamyolo_torch.data.image_io import imdecode, imencode
    from streamyolo_torch.exp import get_exp
    from streamyolo_torch.ops.nms_cuda import nms_keep
    from streamyolo_torch.ops.preproc import downsample2x
    from streamyolo_torch.tools import eval as eval_tool
    from streamyolo_torch.tools import sap_rehearsal

    t_phase = time.perf_counter()
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    want = json.loads((JPEG_FIXTURES / "digests.json").read_text())["from_disk"]
    raw_size = (2 * INPUT[0], 2 * INPUT[1])
    params = dict(seq_lens=(EVAL_FRAMES,) * EVAL_SEQS, size=raw_size, seed=SEED)
    check(want["params"] == json.loads(json.dumps(params)),
          f"from_disk: digests.json holds the files of {want['params']}, not {params}")
    launches = {}

    def counted(name, fn):
        nms_keep.launches = 0
        downsample2x.launches = 0
        out = fn()
        launches[name] = {"nms": nms_keep.launches, "preproc": downsample2x.launches}
        return out

    # 1. the fixture, written by the port
    data_dir = out_dir / "argoverse"
    t = time.perf_counter()
    make_synthetic_argoverse(str(data_dir), **params)
    write_s = time.perf_counter() - t
    files = {p.relative_to(data_dir).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
             for p in sorted(data_dir.rglob("*.jpg"))}
    check(files == want["sha256"],
          f"from_disk: {sum(files.get(k) != v for k, v in want['sha256'].items())} of "
          f"{len(want['sha256'])} written files differ from cv2's")

    # 2-3. the eval CLI from the files, then fed the same frames in memory
    exp = get_exp(exp_name=EVAL_CONFIG)
    weights = out_dir / "l_seed0.pth"
    torch.save(lifted_state(exp), weights)

    def argv(name):
        return ["-f", f"cfgs/{EVAL_CONFIG}.py", "-c", str(weights), "-b", str(EVAL_BATCH),
                "--fp16", "--device", device, "-expn", name, "data_dir", str(data_dir),
                "output_dir", str(out_dir / "runs"), "data_num_workers", "0",
                "test_size", str(INPUT)]

    synth = SyntheticArgoverse(**params)
    n_batches = -(-EVAL_SEQS * EVAL_FRAMES // EVAL_BATCH)
    k = n_batches if device == "cuda" else 0  # a kernel's wrapper launches it only on a card
    t = time.perf_counter()
    disk = counted("eval", lambda: eval_tool.main(argv("disk")))
    eval_s = time.perf_counter() - t
    memory = counted("eval_in_memory", lambda: eval_tool.main(
        argv("memory"), load_frame=lambda img: imdecode(imencode(synth.frame(img), 90))))
    check(len(disk["rows"]) > 0 and disk["rows"] == memory["rows"],
          f"from_disk: the eval's {len(disk['rows'])} rows from disk differ from its "
          f"{len(memory['rows'])} rows on the decoded frames in memory")
    check(launches["eval"] == launches["eval_in_memory"] == {"nms": k, "preproc": 0},
          f"from_disk: eval launches {launches} for {n_batches} batches")

    # 4. the sAP rehearsal's default disk fixture, written and read by the port
    reh_dir = out_dir / "rehearsal"
    t = time.perf_counter()
    summary = counted("sap_rehearsal", lambda: sap_rehearsal.main(
        ["-f", f"cfgs/{EVAL_CONFIG}.py", "--weights", str(weights), "--out-dir", str(reh_dir),
         "--device", device, "--seqs", str(REHEARSAL_SEQS),
         "--frames", str(FROM_DISK_REHEARSAL_FRAMES), "--frame-size", *map(str, raw_size),
         "--measure", str(FROM_DISK_REHEARSAL_SAMPLES), "--gt", "annotations",
         "--seed", str(SEED)]))
    rehearsal_s = time.perf_counter() - t
    n_frames = REHEARSAL_SEQS * FROM_DISK_REHEARSAL_FRAMES
    written = sorted(reh_dir.glob("fixture/Argoverse-1.1/tracking/*/*.jpg"))
    check(len(written) == n_frames, f"from_disk: the rehearsal wrote {len(written)} frames")
    check(summary["frames"]["total"] == n_frames and summary["frames"]["processed"] >= 1
          and summary["sAP"] is not None and 0 <= summary["sAP"] <= 100,
          f"from_disk: the rehearsal from disk summarised {summary}")
    calls = summary["frames"]["processed"]  # each a detector call, so a B1 launch
    check(launches["sap_rehearsal"]["preproc"] == 0
          and (device != "cuda" or launches["sap_rehearsal"]["nms"] >= calls),
          f"from_disk: rehearsal launches {launches['sap_rehearsal']} for {calls} results")

    # host times: the encoder at quality 90, the PNG reader, a 1200x1920 frame
    frame = synth.frame(synth.data["images"][0])
    png = png_of(frame)
    check(np.array_equal(imdecode(png), frame), "from_disk: the PNG frame decodes to other bytes")
    times = {"imencode_q90_ms": host_ms(lambda: imencode(frame, 90)),
             "png_decode_ms": host_ms(lambda: imdecode(png)), "png_bytes": len(png),
             "write_fixture_s": write_s, "eval_from_disk_s": eval_s,
             "rehearsal_s": rehearsal_s}
    cv2_loaded = sys.modules.get("cv2") is not None
    check(not cv2_loaded, "from_disk: cv2 was imported")
    emit("from_disk", nvidia_smi=smi, fixture=f"{EVAL_SEQS}x{EVAL_FRAMES} frames "
         f"{raw_size[0]}x{raw_size[1]} q90, written by the port", files=len(files),
         files_equal_cv2=True, model=f"StreamYOLO-{MODEL_SIZE}", input=list(INPUT),
         dtype="bfloat16", eval_rows=len(disk["rows"]), rows_equal_in_memory=True,
         AP=100 * disk["ap"], rehearsal={k: summary[k] for k in ("frames", "sAP", "latency_ms")},
         rehearsal_fixture=f"{REHEARSAL_SEQS}x{FROM_DISK_REHEARSAL_FRAMES} frames, written "
         "by the port", times=times, launches=launches, cv2_loaded=cv2_loaded,
         seconds=time.perf_counter() - t_phase)
    return launches


def tool_line(tool, argv) -> dict:
    """Run a measuring tool's ``main(argv)`` in this process and parse the
    one JSON line it prints last."""
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tool.main(argv)
    lines = out.getvalue().strip().splitlines()
    check(rc == 0 and bool(lines), f"{tool.__name__} {argv}: exit {rc}, no output")
    return json.loads(lines[-1])


def json_leaves(obj, path: str = "", key=None):
    """(path, key, value) of every value in a tool's line that is neither a
    dict nor a list (a list's items carry the list's key)."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from json_leaves(v, f"{path}.{k}" if path else k, k)
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            yield from json_leaves(v, f"{path}[{i}]", key)
    else:
        yield path, key, obj


def bench_times(line: dict):
    """(path, value) of every measured time in a tool's line: the numbers
    under keys that name milliseconds (``step_ms``, ``ms_per_step``,
    ``min_ms``, ...) and the seconds of the fixture and the captures."""
    return [(p, v) for p, k, v in json_leaves(line)
            if isinstance(v, (int, float)) and not isinstance(v, bool)
            and (re.search(r"(^|_)ms(_|$)", k) or k in ("fixture_write_s", "capture_s"))]


def bench_check(name: str, line: dict, keys, kind: str, smi: str, required_mfu) -> dict:
    """A tool's line on the card: ``keys`` present, ``device`` this card
    with ``nvidia-smi``'s line, every measured time finite and above 0
    (the budget's device-resize row has no resize: 0 by definition), every
    ``mfu`` given in (0, 1.05] and those at ``required_mfu`` given."""
    missing = [k for k in keys if k not in line]
    check(not missing, f"bench: {name} lacks {missing}")
    dev = line["device"]
    check(dev.get("kind") == kind and dev.get("nvidia_smi") == smi,
          f"bench: {name} ran on {dev}, not {kind} / {smi}")
    times = [(p, v) for p, v in bench_times(line) if p != "budget.device_resize.resize_ms"]
    bad = [(p, v) for p, v in times if not (np.isfinite(v) and v > 0)]
    check(bool(times) and not bad, f"bench: {name} times not finite and > 0: {bad[:5]}")
    mfus = {p: v for p, k, v in json_leaves(line) if k == "mfu"}
    check(all(mfus.get(p) is not None for p in required_mfu),
          f"bench: {name} lacks mfu at {[p for p in required_mfu if mfus.get(p) is None]}")
    out = {p: v for p, v in mfus.items() if v is not None and not 0 < v <= 1.05}
    check(not out, f"bench: {name} mfu outside (0, 1.05]: {out}")
    return {"times_checked": len(times), "mfu": {p: v for p, v in mfus.items() if v is not None}}


def remat_check() -> dict:
    """``streamyolo_torch/tools/remat_steps.py`` at batch
    ``BENCH_TRAIN_BATCH``: two plain steps and one rematerialised step of
    StreamYOLO-s at 600x960 from one seeded state, bf16 autocast, cuDNN's
    autotuner on, at a step where the LR is not 0. The remat step's running
    statistics and ``num_batches_tracked`` equal the plain step's bit for
    bit, and its metrics, weights, gradients, momentum and EMA part from
    the first plain step's by at most what the second plain step's do (not
    at all where those are equal). Returns the line's remat entry and each
    step's peak memory."""
    from streamyolo_torch.tools import remat_steps

    line = tool_line(remat_steps, ["--batch", str(BENCH_TRAIN_BATCH)])
    remat = line["steps"]["remat"]
    check(line["plain"]["lr"] > 0, "remat: the steps ran at LR 0")
    check(not remat["stats_differ"],
          f"remat: running statistics differ from the plain step's: {remat['stats_differ'][:5]}")
    check(remat["above_plain_gap"] == 0,
          f"remat: {remat['above_plain_gap']} of {line['tensors']} tensors part from the plain "
          f"step by more than two plain steps do: {remat['above_plain_gap_first']}")
    return {"tensors": line["tensors"], "remat": remat,
            "plain_again_differ": line["steps"]["plain_again"]["differ"],
            "plain_peak_memory_gb": line["plain"]["peak_memory_gb"]}


def phase_bench(smi: str) -> dict:
    """The port's measuring tools (``streamyolo_torch/tools/bench.py``,
    ``bench_suite.py``, ``train_sweep.py``, ``bench_hostpath.py``), each run
    once at full width through its ``main`` with few samples, each JSON line
    checked (``bench_check``). Then the chain ``bench.py`` times, held to the
    detector: the [K, 8] rows of the chain's last step equal, bit for bit,
    a ``CUDAStreamDetector`` fed the same frames call by call; and the
    full-width ``count_work`` of the steady step: 128 ``BaseConv`` calls of
    ``int8_conv_times.STEP_SHAPES``. The kernel launches of the whole phase
    (counts set to 0 before it; the graphs' replays from ``bench.py``'s
    line) go to the ``kernels`` line; B1, B2 and the int8 conv each launch."""
    import torch

    from streamyolo_torch.ops.int8_conv import int8_conv
    from streamyolo_torch.ops.nms_cuda import nms_keep
    from streamyolo_torch.ops.preproc import downsample2x
    from streamyolo_torch.stream import CUDAStreamDetector
    from streamyolo_torch.tools import bench, bench_hostpath, bench_suite, train_sweep
    from streamyolo_torch.tools.int8_conv_times import STEP_SHAPES

    t_phase = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    few = ["--samples", str(BENCH_SAMPLES)]
    counters = (nms_keep, downsample2x, int8_conv)
    for c in counters:
        c.launches = 0
    lines, checked, seconds = {}, {}, {}

    def run(name, tool, argv, keys, required_mfu):
        t0 = time.perf_counter()
        lines[name] = tool_line(tool, argv)
        seconds[name] = time.perf_counter() - t0
        checked[name] = bench_check(name, lines[name], keys, kind, smi, required_mfu)
        torch.cuda.empty_cache()

    run("bench", bench, few + ["--steps", str(BENCH_STEPS)],
        ("metric", "value", "unit", "vs_baseline", "operating_point", "device", "mfu",
         "step_ms", "median_step_ms", "graphs"), ("mfu", "graphs.mfu"))
    check(lines["bench"]["graphs"]["aot_loaded"], "bench: the graph detector serves eagerly")
    cell_keys = ("ms_per_step", "tflops", "gbytes", "mfu", "hbm_share")
    suite_steps = ["--steps", str(BENCH_STEPS)]
    remat_s = ["--remat", "--batch", str(BENCH_TRAIN_BATCH)]
    for which, extra in (("all", []), ("stream_int8", []),
                         ("stream_sweep", ["--batches", BENCH_SWEEP]), ("train_parts", []),
                         ("train_s", remat_s)):
        label = f"bench_suite {which}" + (" --remat" if "--remat" in extra else "")
        run(label, bench_suite, [which] + few + suite_steps + extra, ("device",), ())
        cells = {k: v for k, v in lines[label].items()
                 if k != "device" and not k.startswith("capacity_")}
        check(bool(cells) and all(all(k in v for k in cell_keys) for v in cells.values()),
              f"{label}: a cell lacks one of {cell_keys}")
        check(all(v["mfu"] is not None for v in cells.values() if v["tflops"]),
              f"{label}: a cell with operations has no mfu")
    check(list(lines["bench_suite train_s --remat"]) == [
        "device", f"train_{bench.size_tag(0.33, 0.5)}_b{BENCH_TRAIN_BATCH}_remat"],
        "bench_suite train_s --remat: not the one _remat cell")
    t0 = time.perf_counter()
    remat = remat_check()
    seconds["remat_check"] = time.perf_counter() - t0
    run("train_sweep", train_sweep, [str(BENCH_TRAIN_BATCH), "--samples", str(BENCH_SAMPLES),
                                     "--chain", "2"],
        ("model", "device", "points"), ("points[0].mfu",))
    check(lines["train_sweep"]["points"][0]["peak_memory_gb"] > 0,
          "train_sweep: no peak memory")
    run("bench_hostpath", bench_hostpath, ["--samples", "10", "--step-samples",
                                           str(BENCH_SAMPLES), "--steps", str(BENCH_STEPS)],
        ("device", "host", "transfers", "step", "budget"),
        ("step.host_resize.mfu", "step.device_resize.mfu"))
    check(lines["bench_hostpath"]["budget"]["winner"] is not None, "bench_hostpath: no winner")
    run("bench_hostpath --train", bench_hostpath,
        ["--train", "--train-batch", str(BENCH_TRAIN_BATCH), "--train-batches", "2",
         "--train-frames", "4", "--train-workers", "0", "--train-no-cache-row"],
        ("device", "train"), ("train.train_step.mfu",))
    check(lines["bench_hostpath --train"]["train"]["loader_w0"]["imgs_per_sec"] > 0,
          "bench_hostpath --train: the loader gave nothing")
    graph_launches = lines["bench"]["graphs"].get("launches", {})
    launches = {"nms": nms_keep.launches + graph_launches.get("nms", 0),
                "preproc": downsample2x.launches + graph_launches.get("preproc", 0),
                "int8_conv": int8_conv.launches + graph_launches.get("int8_conv", 0)}
    check(all(v > 0 for v in launches.values()), f"bench: a kernel never launched: {launches}")

    # the chain bench.py times against the detector fed call by call
    dev = torch.device("cuda")
    model = bench.serving_model(bench.seeded_exp(bench.CONFIG), torch.bfloat16, dev)
    kw = dict(input_size=INPUT, conf_thre=CONF, nms_thre=NMS, num_classes=NCLS,
              pre_nms_topk=TOPK, use_bf16=True)
    pool = bench.frame_pool(1, INPUT, dev)
    saved = [c.launches for c in counters]
    chained = CUDAStreamDetector(model, **kw)
    rows = bench.chain(chained, pool, BENCH_CHAIN_STEPS)[0].cpu().numpy()
    called = CUDAStreamDetector(model, **kw)
    for i in range(BENCH_CHAIN_STEPS):
        called(pool[i % len(pool)][0].cpu().numpy(), preprocessed=True)
    for c, n in zip(counters, saved):
        c.launches = n  # a check is no launch of the tools
    check(np.array_equal(rows, called.last_rows),
          f"bench: the chain's rows after {BENCH_CHAIN_STEPS} steps differ from the "
          "detector's fed call by call")
    work = bench.step_work(model, (1, *INPUT, 3))
    blocks = [tuple(r["shape"]) for r in work["calls"] if r["base_conv"]]
    counts = {sh: blocks.count(sh) for sh in set(blocks)}
    check(len(blocks) == sum(n for n, _ in STEP_SHAPES) == 128
          and sorted(counts.items()) == sorted((sh, n) for n, sh in STEP_SHAPES),
          "bench: count_work's BaseConv calls differ from int8_conv_times.STEP_SHAPES")
    del chained, called, model
    torch.cuda.empty_cache()

    b, g = lines["bench"], lines["bench"]["graphs"]
    emit("bench", nvidia_smi=smi, model=f"StreamYOLO-{MODEL_SIZE}", input=list(INPUT),
         headline={"value": b["value"], "unit": b["unit"], "step_ms": b["step_ms"],
                   "median_step_ms": b["median_step_ms"], "mfu": b["mfu"],
                   "hbm_share": b["hbm_share"], "tflops": b["tflops"],
                   "host_path_ms": b["host_path_ms"]},
         graphs={k: g[k] for k in ("step_ms", "median_step_ms", "frames_per_sec", "mfu",
                                   "hbm_share")},
         chain_rows_equal_detector=True, chain_steps=BENCH_CHAIN_STEPS,
         chain_kept=int((rows[:, 7] > 0.5).sum()),
         step_work={"base_conv_calls": len(blocks), "distinct_shapes": len(counts),
                    "tflops": work["flops"] / 1e12, "gbytes": work["bytes"] / 1e9},
         remat_check=remat, checked=checked, seconds=seconds, launches=launches, lines=lines,
         elapsed_phase_s=time.perf_counter() - t_phase)
    return launches


def main(only: str = None) -> int:
    """The whole script; ``only`` (``"data_parallel"``, ``"aot_serve"``,
    ``"train"``, ``"trained_e2e"``, ``"trained_bf16"``, ``"image_io"``,
    ``"from_disk"``, ``"bench"`` or ``"spatial"``, which
    calibrates its int8 model first) runs the device line, the build and that phase alone
    (for work on it), and prints no result."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    from streamyolo_torch.models import build_streamyolo
    from streamyolo_torch.models.heads import eval_outputs
    from streamyolo_torch.ops import _build
    from streamyolo_torch.ops.nms import candidate_counts, postprocess_fixed, select_candidates
    from streamyolo_torch.ops.nms_cuda import nms_keep, nms_padded, nms_padded_sequential
    from streamyolo_torch.ops.preproc import downsample2x, downsample2x_plain
    from streamyolo_torch.stream import CUDAStreamDetector
    from streamyolo_torch.tools.int8_conv_times import ptxas_by_kernel

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, name=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)
    dev = torch.device("cuda")

    # 2. build
    t0 = time.perf_counter()
    report = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {name: ptxas_by_kernel(r["log"]) for name, r in report.items()}
    emit("build", seconds=build_s, per_source={n: r["seconds"] for n, r in report.items()},
         ptxas=ptxas)
    if only == "data_parallel":
        phase_data_parallel(Path(__file__).resolve().parent / "build" / "chip_smoke_dp", smi)
        return 0
    if only == "aot_serve":
        phase_aot_serve(Path(__file__).resolve().parent / "build" / "chip_smoke_aot",
                        rehearsal_fixture(), smi)
        return 0
    if only == "train":
        phase_train(Path(__file__).resolve().parent / "build" / "chip_smoke_train")
        return 0
    if only == "trained_e2e":
        phase_trained_e2e(Path(__file__).resolve().parent / "build" / "chip_smoke_trained")
        return 0
    if only == "trained_bf16":
        phase_trained_bf16(smi)
        return 0
    if only == "image_io":
        phase_image_io(Path(__file__).resolve().parent / "build" / "chip_smoke_image_io", smi)
        return 0
    if only == "from_disk":
        phase_from_disk(Path(__file__).resolve().parent / "build" / "chip_smoke_from_disk", smi)
        return 0
    if only == "bench":
        phase_bench(smi)
        return 0
    if only == "spatial":
        from streamyolo_torch.exp import get_exp

        pool = serving_pool()
        q, m32, _ = int8_state(get_exp(exp_name=EVAL_CONFIG), pool)
        del m32
        phase_spatial(pool, q, smi)
        return 0

    # 3. B1 against its plain versions (fixed point on the card, sweep on the CPU)
    nms_checked, nms_mismatch, nms_err = 0, 0, 0.0
    labels = []
    for label, boxes, valid, thr in nms_cases():
        boxes, valid = torch.from_numpy(boxes).to(dev), torch.from_numpy(valid).to(dev)
        got = nms_keep(boxes, valid, thr)
        torch.cuda.synchronize()
        want_fp = nms_padded(boxes, valid, thr)
        want_seq = nms_padded_sequential(boxes.cpu(), valid.cpu(), thr)
        bad = int((got != want_fp).sum()) + int((got.cpu() != want_seq).sum())
        nms_err = max(nms_err, float((got.cpu().float() - want_seq.float()).abs().max()))
        check(bad == 0, f"B1 keep mask differs from the plain versions at {label}: {bad} entries")
        if label.endswith("all identical"):
            check(bool(got[:, 0].all()) and not bool(got[:, 1:].any()),
                  "B1 kept more than the first of identical boxes")
        if label.endswith("all invalid"):
            check(not bool(got.any()), "B1 kept an invalid box")
        nms_mismatch += bad
        nms_checked += got.numel()
        labels.append(f"{label} B={boxes.shape[0]}")
    emit("b1_vs_plain", cases=labels, entries_checked=nms_checked,
         mismatches=nms_mismatch, max_abs_err=nms_err, exact=True)

    # 4. B2 against its plain version, raw and fused, float32 and bf16, at
    # the serving frame, small and ragged widths, and frames whose data_ptr
    # is off the 16-byte grid (the kernel's per-pixel path)
    pre_err, shapes = 0.0, []
    for h, w, offset in ((64, 96, 0), (60, 32, 0), (2, 2, 0), (2, 34, 0), (1200, 1920, 0),
                         (1200, 1922, 0), (64, 96, 1), (1200, 1920, 1)):
        frame = torch.from_numpy(
            np.random.RandomState(h + w).randint(0, 256, (h, w, 3), np.uint8)).to(dev)
        if offset:
            store = torch.empty(frame.numel() + 16, dtype=torch.uint8, device=dev)
            frame = store[offset:offset + frame.numel()].view(h, w, 3).copy_(frame)
            check(frame.data_ptr() % 16 != 0, "the offset frame is 16-byte aligned")
        for dtype in (torch.float32, torch.bfloat16):
            for fused in (False, True):
                got = downsample2x(frame, out_dtype=dtype, fused=fused)
                want = downsample2x_plain(frame, dtype, fused)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                check(torch.equal(got, want) and got.dtype == dtype,
                      f"B2 differs from its plain version at {h}x{w}+{offset} {dtype} "
                      f"fused={fused}")
                pre_err = max(pre_err, err)
        shapes.append(f"{h}x{w}" + (f" data_ptr+{offset}" if offset else ""))
    emit("b2_vs_plain", shapes=shapes, modes=["raw", "fused"],
         dtypes=["float32", "bfloat16"], max_abs_err=pre_err, exact=True)

    # 4b. the head's decode on the card against the CPU on the same bf16 maps
    # (serving level shapes). Both round the sigmoid and exp to bf16 as the
    # JAX package does; the card's exp may round differently from the CPU's
    # in rare cases, so the bound is one bf16 ulp of the larger value.
    rng = np.random.RandomState(SEED)
    maps = [torch.from_numpy(rng.normal(0, 2, (1, 5 + NCLS, h, w)).astype(np.float32))
            .to(torch.bfloat16) for h, w in ((75, 120), (38, 60), (19, 30))]
    dec_gpu = eval_outputs([m.to(dev) for m in maps], (8, 16, 32)).cpu()
    dec_cpu = eval_outputs(maps, (8, 16, 32))
    larger = torch.maximum(dec_gpu.abs(), dec_cpu.abs())
    ulp = torch.ldexp(torch.ones_like(larger), torch.frexp(larger).exponent - 8)
    in_ulps = (dec_gpu - dec_cpu).abs() / ulp
    check(dec_gpu.dtype == torch.float32 and bool((in_ulps <= 1).all()),
          f"bf16 decode on the card differs from the CPU by {float(in_ulps.max())} bf16 ulps")
    emit("bf16_decode_card_vs_cpu", entries=dec_cpu.numel(),
         differing=int((dec_gpu != dec_cpu).sum()), max_bf16_ulps=float(in_ulps.max()))

    # 5. main path: StreamYOLO-l at 600x960, bf16, host path then device_preproc.
    # Weights: seeded LeCun-normal convs, identity BN statistics, obj/cls
    # prediction biases 0; fp32 on the card, its bf16 and CPU copies.
    rng = np.random.RandomState(SEED)
    frames = [rng.randint(0, 256, (*INPUT, 3), np.uint8) for _ in range(4)]
    raws = [rng.randint(0, 256, (2 * INPUT[0], 2 * INPUT[1], 3), np.uint8) for _ in range(4)]
    m_gpu = build_streamyolo(MODEL_SIZE, NCLS, device=dev, generator=torch.Generator().manual_seed(SEED))
    lift_pred_biases(m_gpu)
    m_cpu = copy.deepcopy(m_gpu).cpu()
    model = copy.deepcopy(m_gpu).to(torch.bfloat16)
    kw = dict(input_size=INPUT, in_scale=0.5, conf_thre=CONF, nms_thre=NMS,
              num_classes=NCLS, pre_nms_topk=TOPK, use_bf16=True)
    host = CUDAStreamDetector(model, **kw)
    devpre = CUDAStreamDetector(model, device_preproc=True, **kw)
    host.warmup(3)
    devpre.warmup(3)
    torch.cuda.synchronize()

    nms_keep.launches = 0
    downsample2x.launches = 0
    runs = {}
    for name, det, pool in (("host", host, frames), ("device_preproc", devpre, raws)):
        det.reset()
        counts, kept = [], []
        for i in range(1 + STEADY_STEPS):
            bboxes, scores, labels, _ = det(pool[i % len(pool)], preprocessed=name == "host")
            rows = det.last_rows
            check(rows.shape == (TOPK, 8) and np.isfinite(rows).all(),
                  f"{name}: rows not a finite [{TOPK}, 8] block")
            counts.append(int(candidate_counts(rows, CONF)))
            kept.append(len(labels))
        runs[name] = dict(steps=1 + STEADY_STEPS, candidates_min=min(counts),
                          candidates_max=max(counts), kept_min=min(kept), kept_max=max(kept))
        check(min(counts) > 0, f"{name}: NMS saw no candidates")
    launches = {"nms": nms_keep.launches, "preproc": downsample2x.launches}
    check(launches["nms"] == 2 * (1 + STEADY_STEPS),
          f"B1 launched {launches['nms']} times for {2 * (1 + STEADY_STEPS)} steps")
    check(launches["preproc"] == 1 + STEADY_STEPS,
          f"B2 launched {launches['preproc']} times for {1 + STEADY_STEPS} steps")
    emit("main_path", model="StreamYOLO-l", input=list(INPUT), dtype="bfloat16",
         conf=CONF, nms=NMS, topk=TOPK, runs=runs, launches=launches)

    # 5b. fp32 on the card against fp32 on the CPU (same weights), TF32 off;
    # one star and one steady step through the model
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    m_gpu = m_gpu.to(memory_format=torch.channels_last)
    x0, x1 = (torch.from_numpy(f)[None] for f in frames[:2])
    with torch.inference_mode():
        c_star, c_buf = m_cpu(x0, mode="on_pipe")
        c_steady, _ = m_cpu(x1, buffer=c_buf, mode="on_pipe")
        g_star, g_buf = m_gpu(x0.to(dev), mode="on_pipe")
        g_steady, _ = m_gpu(x1.to(dev), buffer=g_buf, mode="on_pipe")
        # the same check with the bf16 model (modules cast, not only the input)
        b_star, _ = model(x0.to(dev), mode="on_pipe")
    fp32_err = {}
    for name, c, g in (("star", c_star, g_star), ("steady", c_steady, g_steady)):
        err = fp32_err[name] = fp32_errors(g.cpu(), c)
        # stated tolerance: cuDNN and the CPU sum in different orders through
        # ~100 fp32 layers; 1e-3 relative on boxes, 1e-4 absolute on probabilities
        check(err["box_rel_err"] < 1e-3 and err["prob_abs_err"] < 1e-4,
              f"fp32 card vs CPU {name}: {err}")
    with torch.inference_mode():
        rows_kernel = postprocess_fixed(g_steady, NCLS, CONF, NMS, TOPK)
        rows_plain = postprocess_fixed(g_steady.cpu(), NCLS, CONF, NMS, TOPK)
        rows_cpu = postprocess_fixed(c_steady, NCLS, CONF, NMS, TOPK)
    check(torch.equal(rows_kernel.cpu(), rows_plain),
          "postprocess on the card differs from the plain postprocess on the same predictions")
    # keep masks of the two runs over the leading candidates whose order is
    # unambiguous: no score within 1e-4 of the next one or of the threshold
    scores = (c_steady[0, :, 4] * c_steady[0, :, 5:].max(-1).values)
    top = torch.sort(scores, descending=True).values[:TOPK + 1].double()
    close = ((top[:-1] - top[1:]) <= 1e-4) | ((top[:-1] - CONF).abs() <= 1e-4)
    prefix = int(close.nonzero()[0, 0]) if bool(close.any()) else TOPK
    check(torch.equal(rows_kernel[0, :prefix, 7].cpu(), rows_cpu[0, :prefix, 7]),
          f"keep mask of the card's fp32 step differs from the CPU's in the first {prefix} rows")
    # bf16 against fp32 on the card, layer by layer on the same inputs
    layer_errs = bf16_layer_errors(m_gpu, model, x0.to(dev))
    size = g_star[..., 2:4].max(-1, keepdim=True).values.clamp(min=1.0)
    b_err = {"layers": len(layer_errs), "layer_rel_l2_max": max(layer_errs),
             "layer_rel_l2_median": statistics.median(layer_errs),
             "end_to_end_box_err_over_size_p99": float(torch.quantile(
                 ((b_star[..., :4] - g_star[..., :4]).abs() / size).flatten(), 0.99)),
             "end_to_end_prob_abs_max": float((b_star[..., 4:] - g_star[..., 4:]).abs().max())}
    # stated bf16 bound: each layer within 5 % relative L2 of fp32 (bf16 keeps
    # 8 mantissa bits, ~0.4 % per rounding; a conv block rounds a few times)
    check(b_err["layer_rel_l2_max"] < 0.05, f"bf16 vs fp32 on the card out of bound: {b_err}")
    emit("correctness", fp32_card_vs_cpu=fp32_err,
         rows_kernel_equal_plain=True, keep_mask_rows_compared=prefix,
         bf16_vs_fp32=b_err)
    torch.backends.cudnn.allow_tf32 = True
    del m_cpu

    # 5c. frames from disk without cv2: the fixtures against cv2's digests,
    # the host path against device_preproc, stream_det / offline_det from disk
    image_io = phase_image_io(Path(__file__).resolve().parent / "build" / "chip_smoke_image_io",
                              smi)

    # 6. times (CUDA events, median of >= 50 after warmup)
    img_host = torch.from_numpy(frames[0]).to(dev)[None]
    img_raw = torch.from_numpy(raws[0]).to(dev)[None]
    steps = {}
    for name, det, img, pool in (("host", host, img_host, frames),
                                 ("device_preproc", devpre, img_raw, raws)):
        det.reset()
        det.step(img)  # star
        steps[name + "_device_ms"] = time_cuda(lambda: det.step(img), iters=STEADY_STEPS)
        wall = []
        for i in range(STEADY_STEPS):
            t = time.perf_counter()
            det(pool[i % len(pool)], preprocessed=name == "host")  # ends in the D2H copy
            wall.append((time.perf_counter() - t) * 1e3)
        steps[name + "_wall_ms"] = statistics.median(wall)
    steps["host_fps"] = 1e3 / steps["host_wall_ms"]
    emit("step_times", **steps)

    # 7. the N-camera batched step, its times, the sAP rehearsal and the
    # wall-clock streaming loop; each path's kernel launches are counted
    # from 0 just before it and read just after
    pool = serving_pool()
    multi = phase_multi_stream(model, m_gpu, pool, kw)
    del m_gpu
    phase_multi_stream_times(model, pool, kw)

    # 7a. the committed trained fixture's bf16 and float32 rows against the
    # JAX package's (B1 and B2 every frame, B1 every multi-stream step),
    # before any eval CLI leaves cudnn.benchmark's tuned algorithms behind
    trained_bf16 = phase_trained_bf16(smi)
    out_dir = Path(__file__).resolve().parent / "build" / "chip_smoke_rehearsal"
    rehearsal_det, synth, rehearsal_launches = phase_sap_rehearsal(str(out_dir))
    wallclock_launches = phase_wallclock_stream(rehearsal_det, synth)
    del rehearsal_det
    root = Path(__file__).resolve().parent / "build"

    # 7b. the real-time CLI and the Streamer on the same frames
    cli = phase_stream_cli(root / "chip_smoke_stream_cli", synth)
    streamer = phase_streamer(synth)

    # 7c. serving from captured CUDA graphs: precompile --serve, a fresh
    # serving process without nvcc, stream_det --aot-dir
    aot = phase_aot_serve(root / "chip_smoke_aot", synth, smi)
    del synth

    # Kernel times two ways: one call between two events after a sleep
    # (time_cuda, device_only) and a run of calls back to back divided by
    # the count (time_back_to_back). floor_ms is a one-element torch kernel
    # timed the same two ways: the card's own cost of a launch between events.
    one = torch.zeros(1, device=dev)
    floor = {"single": time_cuda(lambda: one.add_(1), iters=200, device_only=True),
             "back_to_back": time_back_to_back(lambda: one.add_(1))}

    # 7d. the int8 PTQ serving path: calibrate, quantize, serve, the kernel
    # against its plain version at every conv shape of the step, times
    int8 = phase_int8(frames, steps, floor)

    # 7e. the row-sharded latency mode: shards on cuda:0 against the unsharded step
    spatial = phase_spatial(pool, int8.pop("q"), smi)

    # 8. the offline pseudo-streaming evaluation (B1 at K = 1000)
    offline = phase_offline_eval(Path(__file__).resolve().parent / "build" / "chip_smoke_eval",
                                 floor)

    # 8b. the Argoverse-HD layout written by the port and read from disk:
    # the eval CLI (rows against the decoded frames in memory) and the
    # rehearsal's default disk fixture
    from_disk = phase_from_disk(root / "chip_smoke_from_disk", smi)

    # 9. training through tools/train.py (B1 in the per-epoch EMA eval)
    train = phase_train(Path(__file__).resolve().parent / "build" / "chip_smoke_train")

    # 10. a tiny model trained by the port, scored offline, streaming and forecast
    trained = phase_trained_e2e(root / "chip_smoke_trained")

    # 11. data-parallel training: two rank processes (B1 in each rank's eval)
    dp = phase_data_parallel(root / "chip_smoke_dp", smi)

    # 12. the measuring tools at full width (B1, B2 and the int8 conv)
    bench_launches = phase_bench(smi)

    # B1 at the serving shapes: the candidates of a real steady step
    with torch.inference_mode():
        preds, _ = model(img_host.to(torch.bfloat16), buffer=host._buffer, mode="on_pipe")
        _, nms_boxes, nms_valid = select_candidates(preds, NCLS, CONF, TOPK)
    b1_ms = time_cuda(lambda: nms_keep(nms_boxes, nms_valid, NMS), iters=200,
                      device_only=True)
    b1_b2b_ms = time_back_to_back(lambda: nms_keep(nms_boxes, nms_valid, NMS))
    b1_plain_ms = time_cuda(lambda: nms_padded(nms_boxes, nms_valid, NMS), iters=50)
    b1_bound, b1_by = bound_ms(
        nms_boxes.numel() * 4 + nms_valid.numel() * 2,
        iou_evaluations(nms_boxes, nms_valid, NMS) * NMS_OPS_PER_IOU)
    # and at the multi-stream batch of 56 (self-test boxes, K = 200)
    many = [nms_case(TOPK, seed=s) for s in range(56)]
    many_boxes = torch.from_numpy(np.stack([c[0] for c in many])).to(dev)
    many_valid = torch.from_numpy(np.stack([c[1] for c in many])).to(dev)
    b1_b56_ms = time_cuda(lambda: nms_keep(many_boxes, many_valid, NMS), iters=200,
                          device_only=True)

    # and at B = 8 on the candidates of a real multi-stream step
    b8_boxes, b8_valid = multi["nms_boxes"], multi["nms_valid"]
    b1_b8_ms = time_cuda(lambda: nms_keep(b8_boxes, b8_valid, NMS), iters=200,
                         device_only=True)
    b1_b8_b2b_ms = time_back_to_back(lambda: nms_keep(b8_boxes, b8_valid, NMS))
    b1_b8_plain_ms = time_cuda(lambda: nms_padded(b8_boxes, b8_valid, NMS), iters=50)
    b1_b8_bound, b1_b8_by = bound_ms(
        b8_boxes.numel() * 4 + b8_valid.numel() * 2,
        iou_evaluations(b8_boxes, b8_valid, NMS) * NMS_OPS_PER_IOU)

    # B2 at 1200x1920 -> 600x960 bf16; ten frames (69 MB > the 50 MB L2) in turn
    pool = itertools.cycle([torch.from_numpy(raws[i % len(raws)]).to(dev) for i in range(10)])
    b2_ms = time_cuda(lambda: downsample2x(next(pool), out_dtype=torch.bfloat16, fused=True),
                      iters=200, device_only=True)
    b2_b2b_ms = time_back_to_back(
        lambda: downsample2x(next(pool), out_dtype=torch.bfloat16, fused=True))
    b2_plain_ms = time_cuda(lambda: downsample2x_plain(next(pool), torch.bfloat16, True),
                            iters=50)
    as_float = itertools.cycle([f.permute(2, 0, 1)[None].float() for f in
                                (next(pool) for _ in range(10))])
    b2_lib_ms = time_cuda(lambda: torch.nn.functional.avg_pool2d(next(as_float), 2), iters=200,
                          device_only=True)
    b2_lib_b2b_ms = time_back_to_back(lambda: torch.nn.functional.avg_pool2d(next(as_float), 2))
    h, w = raws[0].shape[:2]
    n_out = (h // 2) * (w // 2) * 3
    b2_bound, b2_by = bound_ms(h * w * 3 + n_out * 2, n_out * PREPROC_OPS_PER_VALUE)

    def graph_launches(kernel: str) -> dict:
        """Phase ``aot_serve``'s launches of ``kernel`` by path: launches
        captured per graph x its replays (a replay moves no wrapper counter)."""
        return {path: counts[kernel] for path, counts in aot.items() if counts.get(kernel)}

    graph_note = "aot_* entries: launches captured per graph x replays, added to launches"
    kernels = [
        {"name": "nms_keep (B1)", "route": "cuda", "source": "streamyolo_torch/csrc/nms.cu",
         "replaces": "streamyolo_tpu/ops/nms_pallas.py:26",
         "launches": launches["nms"] + spatial["nms"] + sum(graph_launches("nms").values())
         + sum(c["nms"] for c in image_io.values())
         + sum(c["nms"] for c in from_disk.values()) + bench_launches["nms"]
         + trained_bf16["nms"],
         "max_abs_err": nms_err, "ms": b1_ms,
         "plain_ms": b1_plain_ms, "bound_ms": b1_bound, "bound_by": b1_by, "library_ms": None,
         "max_abs_diff_vs_plain": nms_err, "kernel_ms": b1_ms,
         "ms_back_to_back": b1_b2b_ms, "ms_batch56": b1_b56_ms, "floor_ms": floor,
         "ptxas": ptxas.get("nms"),
         "shape": f"B=1 K={nms_boxes.shape[1]} valid={int(nms_valid.sum())}",
         "launches_by_path": {"main_path": launches["nms"], "multi_stream": multi["launches"],
                              "sap_rehearsal": rehearsal_launches["nms"],
                              "wallclock_stream": wallclock_launches["nms"],
                              "offline_eval_dedup": offline["launches"]["dedup"]["nms"],
                              "offline_eval_no_dedup": offline["launches"]["no_dedup"]["nms"],
                              "train": train["launches"]["nms"],
                              **new_path_launches("nms", cli, streamer, trained),
                              "data_parallel_eval": dp["launches"],
                              "spatial_n8_float32": spatial["nms"],
                              **{f"image_io_{k}": c["nms"] for k, c in image_io.items()},
                              **{f"from_disk_{k}": c["nms"] for k, c in from_disk.items()},
                              "data_parallel_eval_by_rank": dp["launches_by_rank"],
                              "bench": bench_launches["nms"],
                              **{f"trained_bf16_{k}": c["nms"]
                                 for k, c in trained_bf16["by_run"].items()},
                              **graph_launches("nms")},
         "graph_launches": graph_note,
         "eval_k1000": offline["times"],
         "batch8": {"shape": f"B=8 K={b8_boxes.shape[1]} valid={int(b8_valid.sum())}, "
                             "candidates of a real multi-stream step",
                    "ms": b1_b8_ms, "ms_back_to_back": b1_b8_b2b_ms,
                    "plain_ms": b1_b8_plain_ms, "bound_ms": b1_b8_bound,
                    "bound_by": b1_b8_by}},
        {"name": "downsample2x (B2)", "route": "cuda",
         "source": "streamyolo_torch/csrc/preproc.cu",
         "replaces": "streamyolo_tpu/ops/preproc_pallas.py:33",
         "launches": launches["preproc"] + sum(graph_launches("preproc").values())
         + sum(c["preproc"] for c in image_io.values())
         + sum(c["preproc"] for c in from_disk.values()) + bench_launches["preproc"]
         + trained_bf16["preproc"],
         "max_abs_err": pre_err, "ms": b2_ms,
         "plain_ms": b2_plain_ms, "bound_ms": b2_bound, "bound_by": b2_by,
         "library_ms": b2_lib_ms, "max_abs_diff_vs_plain": pre_err, "kernel_ms": b2_ms,
         "ms_back_to_back": b2_b2b_ms, "library_ms_back_to_back": b2_lib_b2b_ms,
         "floor_ms": floor, "ptxas": ptxas.get("preproc"),
         "shape": f"{h}x{w}x3 uint8 -> {h // 2}x{w // 2}x3 bf16 fused",
         "launches_by_path": {"main_path": launches["preproc"], "multi_stream": 0,
                              "sap_rehearsal": rehearsal_launches["preproc"],
                              "wallclock_stream": wallclock_launches["preproc"],
                              "offline_eval_dedup": offline["launches"]["dedup"]["preproc"],
                              "offline_eval_no_dedup":
                                  offline["launches"]["no_dedup"]["preproc"],
                              "train": train["launches"]["preproc"],
                              **new_path_launches("preproc", cli, streamer, trained),
                              "spatial_n8_float32": spatial["preproc"],
                              **{f"image_io_{k}": c["preproc"] for k, c in image_io.items()},
                              **{f"from_disk_{k}": c["preproc"] for k, c in from_disk.items()},
                              "bench": bench_launches["preproc"],
                              **{f"trained_bf16_{k}": c["preproc"]
                                 for k, c in trained_bf16["by_run"].items()},
                              **graph_launches("preproc")},
         "graph_launches": graph_note},
        {"name": "int8_conv", "route": "cuda", "source": "streamyolo_torch/csrc/int8_conv.cu",
         "replaces": "streamyolo_tpu/nn/blocks.py:123",
         "launches": int8["launches"]["int8_conv"] + spatial["int8_conv"]
         + sum(graph_launches("int8_conv").values()) + bench_launches["int8_conv"],
         "max_abs_err": 0.0,
         "ms": int8["whole"]["ms"], "plain_ms": int8["whole"]["plain_ms"],
         "bound_ms": int8["whole"]["bound_ms"], "bound_by": int8["whole"]["bound_by"],
         "library_ms": int8["whole"]["cudnn_bf16_ms"],
         "shape": f"the {int8['whole']['calls']} conv calls of one steady StreamYOLO-l step "
                  "at 600x960, bf16, summed (each shape timed back to back, times its count)",
         "library": "cuDNN bf16 F.conv2d of the same layers (no quantize)",
         "elements_compared": int8["compared"], "heaviest": int8["heaviest"],
         "int_mm_ms_1x1": int8["whole"]["int_mm_ms_1x1"],
         "kernel_ms_1x1": int8["whole"]["kernel_ms_1x1"], "step": int8["step"],
         "floor_ms": floor, "ptxas": ptxas.get("int8_conv"),
         "launches_by_path": {"int8_serving": int8["launches"]["int8_conv"],
                              "int8_eval": trained["eval_int8"]["int8_conv"],
                              "int8_eval_no_dedup": trained["eval_int8_no_dedup"]["int8_conv"],
                              "int8_eval_calib_few":
                                  trained["eval_int8_calib_few"]["int8_conv"],
                              "spatial_int8_n8": spatial["int8_conv"],
                              "bench": bench_launches["int8_conv"],
                              **graph_launches("int8_conv")},
         "graph_launches": graph_note},
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--dp-rank":  # a rank of phase data_parallel
        sys.exit(dp_rank_main(sys.argv[2:]))
    if len(sys.argv) == 3 and sys.argv[1] == "--aot-export":  # phase aot_serve's children
        sys.exit(aot_export_main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--aot-serve":
        sys.exit(aot_serve_main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--only" and sys.argv[2] in (
            "data_parallel", "aot_serve", "train", "trained_e2e", "trained_bf16", "spatial",
            "image_io", "from_disk", "bench"):
        sys.exit(main(only=sys.argv[2]))
    sys.exit(main())
