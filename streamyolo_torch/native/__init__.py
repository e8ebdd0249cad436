"""ctypes binding of the host-side native library: the port's own binding of
``native/streamyolo_native.cpp`` (the file the JAX package binds too).

The library is built with ``g++`` at first use, not at import, into
``build/native/`` of the checkout, named by a hash of the source and the
flags; a process-wide lock makes the build happen once, and the result is
written to a temporary name and renamed, so parallel processes never load a
half-written file. A failed build raises ``NativeBuildError`` with the
compiler's output.

Bound here: ``cocoeval_run`` (the whole COCO evaluate + accumulate pass, for
``eval/cocoeval_ext.py::COCOeval_opt``), ``iou_assoc_greedy`` (the greedy
track association of ``stream/track.py``) and ``bbox_iou_ltwh``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "streamyolo_native.cpp"
BUILD_DIR = ROOT / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None


class NativeBuildError(RuntimeError):
    """``g++`` is missing or failed on ``native/streamyolo_native.cpp``."""


def _target() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"streamyolo_native-{digest.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise NativeBuildError("g++ not found: cannot build native/streamyolo_native.cpp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(
            f"g++ failed on {SOURCE.name} (exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)


_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def load() -> ctypes.CDLL:
    """The loaded native library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = _target()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            lib.cocoeval_run.argtypes = [
                ctypes.c_int64, ctypes.c_int64,
                _i64p, _i64p,
                _f64p, _f64p, _f64p,        # dt: scores, boxes, areas
                _f64p, _f64p, _u8p, _u8p,   # gt: boxes, areas, crowd, ignore
                _f64p, ctypes.c_int64,      # iou_thrs, T
                _f64p, ctypes.c_int64,      # rec_thrs, R
                _f64p, ctypes.c_int64,      # area_rng, A
                _i64p, ctypes.c_int64,      # max_dets, M
                _f64p, _f64p, _f64p,        # precision, recall, scores
            ]
            lib.cocoeval_run.restype = None
            lib.iou_assoc_greedy.argtypes = [
                _f64p, ctypes.c_int64, ctypes.c_int64,
                _i64p, _i64p, ctypes.c_double,
                _i64p, _i64p, _i64p,
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ]
            lib.iou_assoc_greedy.restype = None
            lib.bbox_iou_ltwh.argtypes = [
                _f64p, ctypes.c_int64, _f64p, ctypes.c_int64, _u8p, _f64p,
            ]
            lib.bbox_iou_ltwh.restype = None
            _lib = lib
        return _lib


def cocoeval_run_cpp(
    K, I, dt_off, gt_off, dt_scores, dt_boxes, dt_areas,
    gt_boxes, gt_areas, gt_crowd, gt_ign0,
    iou_thrs, rec_thrs, area_rng, max_dets,
):
    """The whole COCO evaluate + accumulate in one native call over flat
    k-major cells (``K`` categories x ``I`` images, ``*_off`` the cell
    offsets). Returns (precision [T,R,K,A,M], recall [T,K,A,M],
    scores [T,R,K,A,M])."""
    lib = load()
    T, R, A, M = len(iou_thrs), len(rec_thrs), len(area_rng), len(max_dets)
    precision = np.full((T, R, K, A, M), -1.0)
    recall = np.full((T, K, A, M), -1.0)
    scores = np.full((T, R, K, A, M), -1.0)
    lib.cocoeval_run(
        K, I,
        np.ascontiguousarray(dt_off, np.int64),
        np.ascontiguousarray(gt_off, np.int64),
        np.ascontiguousarray(dt_scores, np.float64),
        np.ascontiguousarray(np.asarray(dt_boxes, np.float64).reshape(-1)),
        np.ascontiguousarray(dt_areas, np.float64),
        np.ascontiguousarray(np.asarray(gt_boxes, np.float64).reshape(-1)),
        np.ascontiguousarray(gt_areas, np.float64),
        np.ascontiguousarray(gt_crowd, np.uint8),
        np.ascontiguousarray(gt_ign0, np.uint8),
        np.ascontiguousarray(iou_thrs, np.float64), T,
        np.ascontiguousarray(rec_thrs, np.float64), R,
        np.ascontiguousarray(np.asarray(area_rng, np.float64).reshape(-1)), A,
        np.ascontiguousarray(max_dets, np.int64), M,
        precision.reshape(-1), recall.reshape(-1), scores.reshape(-1),
    )
    return precision, recall, scores


def iou_assoc_greedy_cpp(ious: np.ndarray, labels1: np.ndarray, labels2: np.ndarray,
                         match_iou_th: float):
    """Greedy association on a precomputed [m, n] IoU matrix: each new
    detection j in turn claims the free previous box of its label with the
    highest IoU >= ``match_iou_th`` (ties to the highest row). Returns
    (matched1, matched2, unmatched2) index lists."""
    lib = load()
    ious = np.ascontiguousarray(ious, np.float64)
    m, n = ious.shape
    labels1 = np.ascontiguousarray(labels1, np.int64).reshape(-1)
    labels2 = np.ascontiguousarray(labels2, np.int64).reshape(-1)
    if labels1.shape != (m,) or labels2.shape != (n,):
        raise ValueError(f"labels {labels1.shape}, {labels2.shape} do not fit ious {ious.shape}")
    matched1 = np.zeros(n, np.int64)
    matched2 = np.zeros(n, np.int64)
    unmatched2 = np.zeros(n, np.int64)
    n_matched = ctypes.c_int64(0)
    n_unmatched2 = ctypes.c_int64(0)
    lib.iou_assoc_greedy(ious, m, n, labels1, labels2, float(match_iou_th),
                         matched1, matched2, unmatched2,
                         ctypes.byref(n_matched), ctypes.byref(n_unmatched2))
    nm, nu = n_matched.value, n_unmatched2.value
    return matched1[:nm].tolist(), matched2[:nm].tolist(), unmatched2[:nu].tolist()


def bbox_iou_ltwh_cpp(dt: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """[n, 4] x [m, 4] ltwh boxes -> [n, m] IoU (intersection over the dt
    area for a crowd gt)."""
    lib = load()
    dt = np.ascontiguousarray(np.asarray(dt, np.float64).reshape(-1, 4))
    gt = np.ascontiguousarray(np.asarray(gt, np.float64).reshape(-1, 4))
    iscrowd = np.ascontiguousarray(iscrowd, np.uint8).reshape(-1)
    if iscrowd.shape != (len(gt),):
        raise ValueError(f"iscrowd {iscrowd.shape} does not fit {len(gt)} gt boxes")
    out = np.zeros((len(dt), len(gt)), np.float64)
    lib.bbox_iou_ltwh(dt, len(dt), gt, len(gt), iscrowd, out)
    return out
