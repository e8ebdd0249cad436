"""Serving from captured CUDA graphs, the counterpart of
``streamyolo_tpu/utils/aot.py``.

A JAX serving step is one compiled executable, written to a file and loaded
by a later process. On the card the counterpart of that executable is a
``torch.cuda.CUDAGraph`` of the step, but torch cannot write a graph to a
file, so the artifact splits in two:

  * on disk (``stream/online.py::export_stream_executables``): a manifest
    per graph (the key and its parts, the configuration, the seconds the
    capture took, the digests of the kernel libraries) and the kernel
    libraries that the graph launches, which a serving process loads
    instead of running ``nvcc``;
  * in the serving process: the graphs, captured at construction from
    static tensors (``capture_graphs``) and probed before they serve.

There is no counterpart of ``enable_compilation_cache``: the port compiles
nothing but its kernels, and ``ops/_build.py`` already caches their builds
by content under ``build/kernels/``; torch keeps no cache of cuDNN's
algorithm choices across processes.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

MANIFEST_FORMAT = 1
# Runs of each function before its capture: the first does the one-time
# host work a capture must not see (lazy ctypes loads, the kernels'
# cudaFuncSetAttribute opt-ins, the int8 plans, cuDNN / cuBLAS handles of
# the side stream); the second runs as the graph will, with all of it done.
CAPTURE_WARMUP = 2


def kernel_launches() -> Dict[str, int]:
    """The launch counters of the port's kernel wrappers, by source name."""
    from streamyolo_torch.ops.int8_conv import int8_conv
    from streamyolo_torch.ops.nms_cuda import nms_keep
    from streamyolo_torch.ops.preproc import downsample2x

    return {"nms": nms_keep.launches, "preproc": downsample2x.launches,
            "int8_conv": int8_conv.launches}


def environment(device: torch.device) -> Dict[str, object]:
    """Everything of the process that invalidates a captured step: torch and
    its CUDA, the device's name, compute capability and count, and the
    digests of the kernel sources."""
    from streamyolo_torch.ops import _build

    env: Dict[str, object] = {"torch_version": torch.__version__,
                              "torch_cuda": torch.version.cuda,
                              "platform": device.type, "kernels": _build.digests()}
    if device.type == "cuda":
        env.update(device_name=torch.cuda.get_device_name(device),
                   capability=torch.cuda.get_device_capability(device),
                   n_devices=torch.cuda.device_count())
    else:
        env.update(device_name=device.type, capability=None, n_devices=1)
    return env


def executable_key(device: torch.device, **parts) -> str:
    """Stable content key of a captured step: the caller's parts (shapes,
    thresholds, model hash, ...) plus ``environment(device)``. Any mismatch
    yields another key, so a stale artifact is never found (the detector
    then serves eagerly)."""
    parts = dict(parts, **environment(device))
    canon = ";".join(f"{k}={parts[k]!r}" for k in sorted(parts))
    return hashlib.sha256(canon.encode()).hexdigest()


def time_synchronized() -> float:
    """A timestamp after the card has finished its queued work (the
    ``yolox.utils.time_synchronized`` role)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return time.perf_counter()


def capture_graphs(fns: Sequence[Callable[[], object]], device: torch.device
                   ) -> Tuple[List[torch.cuda.CUDAGraph], List[float], List[Dict[str, int]]]:
    """Capture each of ``fns`` (functions over static tensors that allocate
    nothing that outlives them) into a CUDA graph, all in one memory pool:
    each runs ``CAPTURE_WARMUP`` times on a side stream first, then is
    captured on the same stream. Returns the graphs, the seconds of
    each capture, and the kernel launches recorded into each graph (the
    wrappers count a launch when it is captured; a replay does not).

    The pool is shared: nothing a function allocates survives its capture,
    so the graphs may replay in any order, one at a time."""
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        for fn in fns:
            for _ in range(CAPTURE_WARMUP):
                fn()
    stream.synchronize()
    pool = torch.cuda.graph_pool_handle()
    graphs, seconds, launches = [], [], []
    for fn in fns:
        graph = torch.cuda.CUDAGraph()
        before = kernel_launches()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, pool=pool, stream=stream):
            fn()
        seconds.append(time_synchronized() - t0)
        after = kernel_launches()
        launches.append({k: after[k] - before[k] for k in after})
        graphs.append(graph)
    torch.cuda.current_stream(device).wait_stream(stream)
    return graphs, seconds, launches


def file_digest(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def save_manifest(manifest: Dict[str, object], path: str) -> None:
    """Write a graph's manifest as JSON, atomically (a temporary file in the
    same directory and ``os.replace``)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(dict(manifest, format=MANIFEST_FORMAT), f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def load_manifest(path: str, key: str) -> Optional[Dict[str, object]]:
    """The manifest at ``path`` when it exists, parses and was written for
    ``key``; else None (a miss)."""
    if not os.path.isfile(path):
        return None
    try:
        with open(path) as f:
            manifest = json.load(f)
    except (OSError, UnicodeDecodeError, json.JSONDecodeError) as e:
        from streamyolo_torch.utils.logger import get_logger

        get_logger().warning("graph manifest %s unreadable (%s)", path, e)
        return None
    if not isinstance(manifest, dict) or manifest.get("key") != key \
            or manifest.get("format") != MANIFEST_FORMAT:
        return None
    return manifest
