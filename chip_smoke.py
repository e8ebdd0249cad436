#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``streamyolo_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``streamyolo_torch/csrc``, holds each against
its plain PyTorch version on the card, serves StreamYOLO-l at 600x960
through ``CUDAStreamDetector`` (host path and ``device_preproc``) with
random weights from a seed, checks the outputs (the card's fp32 step against
the CPU, bf16 against fp32), and times the step and each kernel with CUDA
events. Each phase prints one JSON line; the line before the last lists the
kernels, and the last line is ``{"ok": true, "device": {...}}``. Any failed
check raises, so the script exits non-zero and prints no result. Imports
nothing of JAX.
"""

from __future__ import annotations

import copy
import itertools
import json
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 0
INPUT = (600, 960)  # the serving operating point of bench.py
CONF, NMS, TOPK, NCLS = 0.01, 0.65, 200, 8
STEADY_STEPS = 50
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
    do not synchronise)."""
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    from streamyolo_torch.models import build_streamyolo
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
                    if "registers" in ln or "bytes smem" in ln]
             for name, r in report.items()}
    emit("build", seconds=build_s, per_source={n: r["seconds"] for n, r in report.items()},
         ptxas=ptxas)

    # 3. B1 against its plain versions (fixed point on the card, sweep on the CPU)
    nms_checked, nms_mismatch, nms_err = 0, 0, 0.0
    cases = [(k, thr, False) for k in (64, 200, 1024) for thr in (0.45, 0.65)]
    cases.append((200, 0.65, True))
    for k, thr, ties in cases:
        data = [nms_case(k, seed=1000 * k + s, ties=ties) for s in range(8)]
        boxes = torch.from_numpy(np.stack([d[0] for d in data])).to(dev)
        valid = torch.from_numpy(np.stack([d[1] for d in data])).to(dev)
        got = nms_keep(boxes, valid, thr)
        torch.cuda.synchronize()
        want_fp = nms_padded(boxes, valid, thr)
        want_seq = nms_padded_sequential(boxes.cpu(), valid.cpu(), thr)
        bad = int((got != want_fp).sum()) + int((got.cpu() != want_seq).sum())
        nms_err = max(nms_err, float((got.cpu().float() - want_seq.float()).abs().max()))
        check(bad == 0, f"B1 keep mask differs from the plain versions at K={k} thr={thr}"
              f" ties={ties}: {bad} entries")
        nms_mismatch += bad
        nms_checked += got.numel()
    emit("b1_vs_plain", cases=len(cases), batch=8, entries_checked=nms_checked,
         mismatches=nms_mismatch, max_abs_err=nms_err, exact=True)

    # 4. B2 against its plain version, raw and fused, float32 and bf16
    pre_err = 0.0
    for h, w in ((64, 96), (60, 32), (1200, 1920)):
        frame = torch.from_numpy(
            np.random.RandomState(h).randint(0, 256, (h, w, 3), np.uint8)).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            for fused in (False, True):
                got = downsample2x(frame, out_dtype=dtype, fused=fused)
                want = downsample2x_plain(frame, dtype, fused)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                check(torch.equal(got, want) and got.dtype == dtype,
                      f"B2 differs from its plain version at {h}x{w} {dtype} fused={fused}")
                pre_err = max(pre_err, err)
    emit("b2_vs_plain", shapes=["64x96", "60x32", "1200x1920"], modes=["raw", "fused"],
         dtypes=["float32", "bfloat16"], max_abs_err=pre_err, exact=True)

    # 5. main path: StreamYOLO-l at 600x960, bf16, host path then device_preproc.
    # Weights: seeded LeCun-normal convs, identity BN statistics, obj/cls
    # prediction biases 0; fp32 on the card, its bf16 and CPU copies.
    rng = np.random.RandomState(SEED)
    frames = [rng.randint(0, 256, (*INPUT, 3), np.uint8) for _ in range(4)]
    raws = [rng.randint(0, 256, (2 * INPUT[0], 2 * INPUT[1], 3), np.uint8) for _ in range(4)]
    m_gpu = build_streamyolo("l", NCLS, device=dev, generator=torch.Generator().manual_seed(SEED))
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
        g = g.cpu()
        box_err = float(((g[..., :4] - c[..., :4]).abs() / (c[..., :4].abs() + 1.0)).max())
        prob_err = float((g[..., 4:] - c[..., 4:]).abs().max())
        fp32_err[name] = {"box_rel_err": box_err, "prob_abs_err": prob_err}
        # stated tolerance: cuDNN and the CPU sum in different orders through
        # ~100 fp32 layers; 1e-3 relative on boxes, 1e-4 absolute on probabilities
        check(box_err < 1e-3 and prob_err < 1e-4,
              f"fp32 card vs CPU {name}: box rel {box_err:.3g}, prob {prob_err:.3g}")
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
    del m_gpu, m_cpu

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

    # B1 at the serving shapes: the candidates of a real steady step
    with torch.inference_mode():
        preds, _ = model(img_host.to(torch.bfloat16), buffer=host._buffer, mode="on_pipe")
        _, nms_boxes, nms_valid = select_candidates(preds, NCLS, CONF, TOPK)
    b1_ms = time_cuda(lambda: nms_keep(nms_boxes, nms_valid, NMS), iters=200,
                      device_only=True)
    b1_plain_ms = time_cuda(lambda: nms_padded(nms_boxes, nms_valid, NMS), iters=50)
    b1_bound, b1_by = bound_ms(
        nms_boxes.numel() * 4 + nms_valid.numel() * 2,
        iou_evaluations(nms_boxes, nms_valid, NMS) * NMS_OPS_PER_IOU)

    # B2 at 1200x1920 -> 600x960 bf16; ten frames (69 MB > the 50 MB L2) in turn
    pool = itertools.cycle([torch.from_numpy(raws[i % len(raws)]).to(dev) for i in range(10)])
    b2_ms = time_cuda(lambda: downsample2x(next(pool), out_dtype=torch.bfloat16, fused=True),
                      iters=200, device_only=True)
    b2_plain_ms = time_cuda(lambda: downsample2x_plain(next(pool), torch.bfloat16, True),
                            iters=50)
    as_float = itertools.cycle([f.permute(2, 0, 1)[None].float() for f in
                                (next(pool) for _ in range(10))])
    b2_lib_ms = time_cuda(lambda: torch.nn.functional.avg_pool2d(next(as_float), 2), iters=200,
                          device_only=True)
    h, w = raws[0].shape[:2]
    n_out = (h // 2) * (w // 2) * 3
    b2_bound, b2_by = bound_ms(h * w * 3 + n_out * 2, n_out * PREPROC_OPS_PER_VALUE)

    kernels = [
        {"name": "nms_keep (B1)", "route": "cuda", "source": "streamyolo_torch/csrc/nms.cu",
         "replaces": "streamyolo_tpu/ops/nms_pallas.py:26",
         "launches": launches["nms"], "max_abs_err": nms_err, "ms": b1_ms,
         "plain_ms": b1_plain_ms, "bound_ms": b1_bound, "bound_by": b1_by, "library_ms": None,
         "max_abs_diff_vs_plain": nms_err, "kernel_ms": b1_ms,
         "shape": f"B=1 K={nms_boxes.shape[1]} valid={int(nms_valid.sum())}"},
        {"name": "downsample2x (B2)", "route": "cuda",
         "source": "streamyolo_torch/csrc/preproc.cu",
         "replaces": "streamyolo_tpu/ops/preproc_pallas.py:33",
         "launches": launches["preproc"], "max_abs_err": pre_err, "ms": b2_ms,
         "plain_ms": b2_plain_ms, "bound_ms": b2_bound, "bound_by": b2_by,
         "library_ms": b2_lib_ms, "max_abs_diff_vs_plain": pre_err, "kernel_ms": b2_ms,
         "shape": f"{h}x{w}x3 uint8 -> {h // 2}x{w // 2}x3 bf16 fused"},
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
