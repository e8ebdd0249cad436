"""Build and load the port's CUDA kernels (``streamyolo_torch/csrc/*.cu``).

Each source compiles once, with ``nvcc`` for ``sm_90a``, into its own shared
library with a plain C interface under ``build/kernels/`` of the checkout,
named by a hash of the source and the flags, and is loaded with ``ctypes``.
All sources build in parallel (one ``nvcc`` each), and each once across
processes (data-parallel ranks, loader workers, a serving child): an
``flock`` on ``<target>.lock`` beside the library is held while it
compiles, and a process that finds a source locked waits and then loads the
other's library (or, if that build failed, builds it itself). There is no
fallback: a missing ``nvcc`` or a failed build raises.

Flags: no ``--use_fast_math``; ``-fmad=false`` and IEEE division / square
root, so that float arithmetic rounds step by step as the plain PyTorch
versions do (the NMS keep mask and the int8 conv must be bit-identical to
them).
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("nms", "preproc", "int8_conv")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-prec-div=true",
    "-prec-sqrt=true", "-ftz=false", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_paths: Dict[str, str] = {}  # the file each loaded library came from


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels of "
        "streamyolo_torch cannot be built on this host")


def digest(name: str) -> str:
    """The build's identity: a hash of ``csrc/<name>.cu`` and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    return hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]


def digests() -> Dict[str, str]:
    """``digest`` of every source, by name."""
    return {name: digest(name) for name in SOURCES}


def _target(name: str) -> Path:
    return BUILD_DIR / f"{name}-{digest(name)}.so"


def build_all() -> Dict[str, dict]:
    """Compile every source not built yet, all ``nvcc`` processes at once.
    Returns ``{name: {"path", "seconds", "log"}}``; ``log`` holds ptxas's
    register / shared-memory report, or ``"cached"`` where the library was
    there already or another process built it (``seconds`` then counts the
    wait). Raises on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    report: Dict[str, dict] = {}
    t0 = time.perf_counter()
    # first pass: compile what no other process holds; second: wait for the
    # rest, locks taken in SOURCES order, and compile what is still missing
    for blocking in (False, True):
        with contextlib.ExitStack() as held:
            procs = {}
            for name in SOURCES:
                out = _target(name)
                if name in report:
                    continue
                if not out.exists():
                    lock = held.enter_context(open(out.with_name(out.name + ".lock"), "a"))
                    try:
                        fcntl.flock(lock, fcntl.LOCK_EX | (0 if blocking else fcntl.LOCK_NB))
                    except BlockingIOError:
                        continue  # another process compiles it: wait in the second pass
                if out.exists():
                    report[name] = {"path": str(out), "seconds": time.perf_counter() - t0,
                                    "log": "cached"}
                    continue
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
                procs[name] = (subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
            failed = []
            for name, (proc, tmp, out) in procs.items():
                log, _ = proc.communicate()
                if proc.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
                    continue
                os.replace(tmp, out)
                report[name] = {"path": str(out), "seconds": time.perf_counter() - t0,
                                "log": log}
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        if len(report) == len(SOURCES):
            break
    return report


def load_from(name: str, path: str) -> ctypes.CDLL:
    """Load ``csrc/<name>.cu``'s library from ``path`` (a copy that
    ``stream/online.py``'s export put beside its graphs), so that ``load``
    returns it and never runs ``nvcc``. A library of ``name`` loaded before
    stays: the caller has checked that ``path`` holds the same build."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(path))
            _paths[name] = str(path)
        return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _target(name)
            if not path.exists():
                build_all()
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
            _paths[name] = str(path)
        return lib


def library_path(name: str) -> str:
    """The file of ``csrc/<name>.cu``'s library, loaded (built) first."""
    load(name)
    return _paths[name]
