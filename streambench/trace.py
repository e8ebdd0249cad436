"""The traced run's reading of ``torch.profiler``: device busy time, kernel
time by name, launch calls, and the idle gaps by what the host was doing.

The runner wraps its window in ``Tracer`` and marks the host's phases with
``torch.profiler.record_function`` spans named ``bench.*`` (``bench.wait``:
the open loop waits for the next due time; ``bench.call``: inside the
program's call). ``summary`` reads the raw profiler events once:

* ``busy_s``: the union of the device's operation intervals (kernels,
  copies, sets) inside the traced window; ``window_s`` the window's length;
* ``compute_s``: the same union without the copies between host and
  device (``Memcpy HtoD`` / ``DtoH``): the time the device spent on the
  program's own work;
* ``device_ops``: seconds by operation name;
* ``launches``: host calls that launch a kernel or a graph;
* ``idle_gaps``: the seconds the device stood idle between operations,
  by the outermost ``bench.*`` span and the innermost host operation open
  at the middle of each gap.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Tuple

import torch
from torch.profiler import ProfilerActivity, profile

LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch", "cuGraphLaunch")
HOST_COPIES = ("HtoD", "DtoH")  # in the profiler's names of copies to and from the host
NAME_CHARS = 120  # device operation names are cut to this length in the breakdown


class Tracer:
    """``with Tracer(on) as t:`` profiles the block when ``on``."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None

    def __enter__(self):
        if self.on:
            cuda = [ProfilerActivity.CUDA] if torch.cuda.is_available() else []
            self.prof = profile(activities=[ProfilerActivity.CPU, *cuda])
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.on:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.prof.__exit__(*exc)
        return False


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def summary(tracer: Tracer) -> Dict:
    """The traced window's numbers (module docstring); times in seconds."""
    events = tracer.prof.profiler.kineto_results.events()
    device, host, marks = [], [], []
    launches = 0
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not (e.is_user_annotation() or name.startswith("bench.")):
                device.append((s, s + d, name))  # not the bench spans' device mirror
            continue
        if name.startswith(LAUNCH_CALLS):
            launches += 1
        if name.startswith("bench."):
            marks.append((s, s + d, name, e.start_thread_id()))
        host.append((s, s + d, name, e.start_thread_id()))
    ops, counts = Counter(), Counter()
    for s, e, name in device:
        ops[name[:NAME_CHARS]] += (e - s) * 1e-9
        counts[name[:NAME_CHARS]] += 1
    if marks:  # the window: from the first bench span's start to the last's end
        lo, hi = min(m[0] for m in marks), max(m[1] for m in marks)
    else:
        lo = min((s for s, _, _ in device), default=0)
        hi = max((e for _, e, _ in device), default=0)
    def inside(ops):
        return [(max(s, lo), min(e, hi)) for s, e in _merge([(s, e) for s, e, _ in ops])
                if e > lo and s < hi]

    busy = inside(device)
    busy_s = sum(e - s for s, e in busy) * 1e-9
    compute = inside([op for op in device
                      if not (op[2].startswith("Memcpy") and any(c in op[2] for c in HOST_COPIES))])
    compute_s = sum(e - s for s, e in compute) * 1e-9
    window_s = (hi - lo) * 1e-9
    gaps = []  # (middle, seconds) of each idle stretch inside the window
    for (_, a), (b, _) in zip([(lo, lo)] + busy, busy + [(hi, hi)]):
        if b > a:
            gaps.append(((a + b) // 2, (b - a) * 1e-9))
    main = Counter(m[3] for m in marks).most_common(1)[0][0] if marks else None
    stack_events = sorted((h for h in host if h[3] == main), key=lambda h: (h[0], -h[1]))
    by_host = Counter()
    stack: list = []
    i = 0
    for mid, secs in sorted(gaps):
        while i < len(stack_events) and stack_events[i][0] <= mid:
            while stack and stack[-1][1] <= stack_events[i][0]:
                stack.pop()
            stack.append(stack_events[i])
            i += 1
        while stack and stack[-1][1] <= mid:
            stack.pop()
        open_ = [h for h in stack if h[1] > mid]
        outer = next((h[2] for h in open_ if h[2].startswith("bench.")), "outside bench spans")
        inner = open_[-1][2] if open_ else "no host op"
        by_host[outer if inner == outer else f"{outer} > {inner}"] += secs
    return {"busy_s": busy_s, "compute_s": compute_s, "window_s": window_s, "launches": launches,
            "device_ops": dict(ops), "device_op_counts": dict(counts), "idle_gaps": dict(by_host),
            "device_events": len(device), "host_events": len(host)}


def kernel_seconds(summ: Dict, fragment: str) -> Tuple[float, int]:
    """(seconds, launches) of the device operations whose name holds
    ``fragment``."""
    names = [k for k in summ["device_ops"] if fragment in k]
    return (sum(summ["device_ops"][k] for k in names),
            sum(summ["device_op_counts"][k] for k in names))


def breakdown(summ: Dict, top: int = 10) -> Dict:
    """The result line's ``breakdown``: the device operations that took most
    time and the longest idle gaps by host activity, each [name, seconds]."""
    return {"device_ops": [[k, v] for k, v in Counter(summ["device_ops"]).most_common(top)],
            "idle_gaps": [[k, v] for k, v in Counter(summ["idle_gaps"]).most_common(top)]}
