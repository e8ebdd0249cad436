"""Open-loop serving of N cameras at a fixed frame rate.

Traffic parameters: ``cameras`` (N), ``fps``, ``pool_per_camera`` (the
seeded frames each camera cycles through), ``detail`` / ``noise`` (the
frames' texture, ``traffic.frames``), ``warmup_ticks``, ``check_ticks``
(ticks whose rows are judged), ``reference_block`` (frames the reference
runs at once).

Every 1 / fps seconds N frames fall due, one per camera: host uint8 BGR
frames at the configuration's input size, handed as a list to the
detector's ``__call__(frames, preprocessed=True)``, which returns each
camera's detections on the host. Ticks are never dropped: a late tick
starts when the previous one ends, and its frames' latency counts from
their due time. The window opens on every camera's star frame (the
detector is reset after the warm-up) and carries the DFP buffer from
there.

Record (``rec``) for the metric readers: ``frame_latency_s`` (one entry
per frame), ``frames_done``, ``rate_window_s`` (the window, or longer when
the last tick ended after it), ``late_s`` (how late each tick started;
``notes`` prints a summary on standard error), ``ticks``, and in the
traced run ``trace`` (``trace.summary``), ``frame_work`` (the frozen count of one frame's
steady step), ``nms`` (kernel B1's images per launch and K).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch
from torch.profiler import record_function

from streambench import count, program, trace, traffic, weights
from streambench.reference import judge
from streambench.reference.model import PlainOps
from streambench.reference.precision import float32_exact

CALIBRATION_FRAMES = 4  # BatchNorm's statistics: the first frame of up to 4 cameras
SPIN_S = 0.0015  # the last stretch before a due time is spun, not slept


def _frames_at(pool: np.ndarray, index: np.ndarray, t: int):
    return [pool[c, index[t, c]] for c in range(pool.shape[0])]


def _wait_until(due: float) -> None:
    left = due - time.perf_counter()
    if left > SPIN_S:
        time.sleep(left - SPIN_S)
    while time.perf_counter() < due:
        pass


def run(cell, seed: int, seconds: float, trace_on: bool, device: torch.device,
        t_start: float, system=None) -> dict:
    """Set up, serve the window, judge the rows; returns the record."""
    cfg, tr = cell.config, cell.traffic
    n = tr["cameras"]
    pool = traffic.frames(seed, "frames", n * tr["pool_per_camera"], cfg["input_size"], device,
                          tr["detail"], tr["noise"]).reshape(
        n, tr["pool_per_camera"], *cfg["input_size"], 3)
    state = weights.calibrated(count.model_of(cfg), seed, device, count.DTYPES[cfg["dtype"]],
                               pool[:CALIBRATION_FRAMES, 0])
    det = (system or program.multi_stream_detector)(cfg, state, device, n)
    plan = traffic.camera_plan(tr, seed, seconds)
    cuda = device.type == "cuda"

    for t in range(tr["warmup_ticks"]):  # the star step and the steady step's shapes
        det(_frames_at(pool, plan.index, t), preprocessed=True)
    det.reset()
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)

    rec = {"kind": "cameras"}
    due = np.empty(plan.ticks)
    started = np.empty(plan.ticks)
    done = np.empty(plan.ticks)
    delivered = 0
    saved = {}
    rec["setup_s"] = time.perf_counter() - t_start
    with trace.Tracer(trace_on) as tracer:
        t0 = time.perf_counter()
        for t in range(plan.ticks):
            due[t] = t0 + t / plan.fps
            frames = _frames_at(pool, plan.index, t)
            with record_function("bench.wait"):
                _wait_until(due[t])
            started[t] = time.perf_counter()
            with record_function("bench.call"):
                out = det(frames, preprocessed=True)
            done[t] = time.perf_counter()
            delivered += len(out) if len(out) == n else 0
            if t in plan.check:
                saved[t] = np.array(det.last_rows, copy=True)
    if cuda:
        torch.cuda.synchronize(device)
    end = float(done[-1] - t0)
    late = started - due
    rec.update(ticks=plan.ticks, attempted=plan.ticks * n, failed=plan.ticks * n - delivered,
               frames_done=delivered, rate_window_s=max(seconds, end),
               frame_latency_s=np.repeat(done - due, n), late_s=late,
               notes=[f"generator: {int((late > 1e-3).sum())} of {plan.ticks} ticks started "
                      f"over 1 ms late, the latest by {float(late.max()) * 1e3!r} ms"],
               memory_peak_bytes=int(torch.cuda.max_memory_allocated(device)) if cuda else 0)
    if trace_on:
        if cuda:
            rec["trace"] = trace.summary(tracer)
        rec["frame_work"] = count.count(cfg, 1, count.serve_step)
        rec["nms"] = {"images_per_launch": n, "k": cfg["pre_nms_topk"]}
    del det
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    rec["readings"] = check(cell, state, pool, plan, saved, device)
    return rec


def check(cell, state, pool, plan, saved, device) -> dict:
    """Judge the saved ticks' rows against the reference, which works out
    each camera's DFP buffer again from its previous frame (the star tick
    fuses a frame with itself)."""
    cfg, tr = cell.config, cell.traffic
    ref = count.model_of(cfg)
    ops = PlainOps()
    p = weights.as_float32(state)
    block = tr["reference_block"]
    margin = cell.limits["score_margin"] if cell.limits else 0.0
    readings = []
    with float32_exact():
        for t in plan.check:
            for c0 in range(0, pool.shape[0], block):
                cams = range(c0, min(c0 + block, pool.shape[0]))

                def feats(tick):
                    x = torch.from_numpy(np.stack([pool[c, plan.index[tick, c]] for c in cams]))
                    return ref.pafpn(p, ops, ref.frames_in(x.to(device)))

                cur = feats(t)
                sup = cur if t == 0 else feats(t - 1)
                pred = ref.detect(p, ops, ref.fuse(p, ops, cur, sup))
                hw = [tuple(f.shape[-2:]) for f in cur]
                readings.append(judge.judge(saved[t][c0:c0 + len(cams)], pred, hw,
                                            cfg["num_classes"], cfg["conf_thre"],
                                            cfg["nms_thre"], margin))
    return judge.worst(readings)
