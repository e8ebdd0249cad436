#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``streamyolo_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``streamyolo_torch/csrc``, holds each against
its plain PyTorch version on the card (edge cases included), holds the bf16
decode of the card against the CPU's, serves StreamYOLO-l at 600x960
through ``CUDAStreamDetector`` (host path and ``device_preproc``) with
random weights from a seed, checks the outputs (the card's fp32 step against
the CPU, bf16 against fp32), and times the step and each kernel with CUDA
events, one call at a time and back to back. Then it serves 8 camera streams
through ``MultiStreamDetector`` (one kernel-B1 launch per batched step, a
per-stream restart, fp32 rows against ``CUDAStreamDetector``), times the
batched step at 1, 8 and 56 streams, scores the port with the simulated-clock
sAP rehearsal (``streamyolo_torch/tools/sap_rehearsal.py``: 2 synthetic
sequences of 30 raw 1200x1920 frames, ``device_preproc``, measured latencies
replayed by ``SimClock``, pseudo ground truth, pairing, native COCOeval), and
runs one sequence through the wall-clock streaming loop. Each phase prints
one JSON line; the line before the last lists the kernels, with their
launches on every path, and the last line is ``{"ok": true, "device":
{...}}``. Any failed check raises, so the script exits non-zero and prints
no result. Imports nothing of JAX.
"""

from __future__ import annotations

import copy
import itertools
import json
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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores, published
# IoU of one pair: 4 max/min, 2 sub, 2 clamp, 1 mul, 2 add/sub, 1 clamp, 1 div, 1 cmp
NMS_OPS_PER_IOU = 14
# per output pixel and channel: 3 adds, 1 mul, 1 add, floor, 2 clamps
PREPROC_OPS_PER_VALUE = 8


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
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
    against ``CUDAStreamDetector`` fed the same frames (TF32 off)."""
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
         fp32_row_vs_single_stream=dict(row=row, steps=len(errs), **fp32))
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


def phase_sap_rehearsal(out_dir, device="cuda"):
    """The simulated-clock sAP rehearsal through the tool's functions: an
    in-memory synthetic fixture at Argoverse-HD's raw size, a
    ``device_preproc`` StreamYOLO-l detector from seeded weights (B2 and
    B1), measured per-call walls replayed by ``SimClock``, pseudo ground
    truth from the detector's every-frame run, pairing and native COCOeval.
    Returns the detector, the fixture and the path's kernel launches."""
    from streamyolo_torch.data import COCO, SyntheticArgoverse
    from streamyolo_torch.ops.nms_cuda import nms_keep
    from streamyolo_torch.ops.preproc import downsample2x
    from streamyolo_torch.stream import Empirical, SimClock, run_streaming_detection, streaming_eval
    from streamyolo_torch.tools import sap_rehearsal as reh

    raw_size = (2 * INPUT[0], 2 * INPUT[1])
    synth = SyntheticArgoverse(seq_lens=(REHEARSAL_FRAMES,) * REHEARSAL_SEQS,
                               size=raw_size, seed=SEED)
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


def main() -> int:
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
    ptxas = {name: [ln.strip() for ln in r["log"].splitlines()
                    if "registers" in ln or "bytes smem" in ln or "spill" in ln]
             for name, r in report.items()}
    emit("build", seconds=build_s, per_source={n: r["seconds"] for n, r in report.items()},
         ptxas=ptxas)

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
    pool = [np.random.RandomState(SEED + 1 + i).randint(0, 256, (*INPUT, 3), np.uint8)
            for i in range(16)]
    multi = phase_multi_stream(model, m_gpu, pool, kw)
    del m_gpu
    phase_multi_stream_times(model, pool, kw)
    out_dir = Path(__file__).resolve().parent / "build" / "chip_smoke_rehearsal"
    rehearsal_det, synth, rehearsal_launches = phase_sap_rehearsal(str(out_dir))
    wallclock_launches = phase_wallclock_stream(rehearsal_det, synth)
    del rehearsal_det, synth

    # Kernel times two ways: one call between two events after a sleep
    # (time_cuda, device_only) and a run of calls back to back divided by
    # the count (time_back_to_back). floor_ms is a one-element torch kernel
    # timed the same two ways: the card's own cost of a launch between events.
    one = torch.zeros(1, device=dev)
    floor = {"single": time_cuda(lambda: one.add_(1), iters=200, device_only=True),
             "back_to_back": time_back_to_back(lambda: one.add_(1))}

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

    kernels = [
        {"name": "nms_keep (B1)", "route": "cuda", "source": "streamyolo_torch/csrc/nms.cu",
         "replaces": "streamyolo_tpu/ops/nms_pallas.py:26",
         "launches": launches["nms"], "max_abs_err": nms_err, "ms": b1_ms,
         "plain_ms": b1_plain_ms, "bound_ms": b1_bound, "bound_by": b1_by, "library_ms": None,
         "max_abs_diff_vs_plain": nms_err, "kernel_ms": b1_ms,
         "ms_back_to_back": b1_b2b_ms, "ms_batch56": b1_b56_ms, "floor_ms": floor,
         "ptxas": ptxas.get("nms"),
         "shape": f"B=1 K={nms_boxes.shape[1]} valid={int(nms_valid.sum())}",
         "launches_by_path": {"main_path": launches["nms"], "multi_stream": multi["launches"],
                              "sap_rehearsal": rehearsal_launches["nms"],
                              "wallclock_stream": wallclock_launches["nms"]},
         "batch8": {"shape": f"B=8 K={b8_boxes.shape[1]} valid={int(b8_valid.sum())}, "
                             "candidates of a real multi-stream step",
                    "ms": b1_b8_ms, "ms_back_to_back": b1_b8_b2b_ms,
                    "plain_ms": b1_b8_plain_ms, "bound_ms": b1_b8_bound,
                    "bound_by": b1_b8_by}},
        {"name": "downsample2x (B2)", "route": "cuda",
         "source": "streamyolo_torch/csrc/preproc.cu",
         "replaces": "streamyolo_tpu/ops/preproc_pallas.py:33",
         "launches": launches["preproc"], "max_abs_err": pre_err, "ms": b2_ms,
         "plain_ms": b2_plain_ms, "bound_ms": b2_bound, "bound_by": b2_by,
         "library_ms": b2_lib_ms, "max_abs_diff_vs_plain": pre_err, "kernel_ms": b2_ms,
         "ms_back_to_back": b2_b2b_ms, "library_ms_back_to_back": b2_lib_b2b_ms,
         "floor_ms": floor, "ptxas": ptxas.get("preproc"),
         "shape": f"{h}x{w}x3 uint8 -> {h // 2}x{w // 2}x3 bf16 fused",
         "launches_by_path": {"main_path": launches["preproc"], "multi_stream": 0,
                              "sap_rehearsal": rehearsal_launches["preproc"],
                              "wallclock_stream": wallclock_launches["preproc"]}},
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
