"""ctypes bindings of the port's host-side native libraries:

  * ``native/streamyolo_native.cpp`` (the file the JAX package binds too):
    ``cocoeval_run`` (the whole COCO evaluate + accumulate pass, for
    ``eval/cocoeval_ext.py::COCOeval_opt``), ``iou_assoc_greedy`` (the
    greedy track association of ``stream/track.py``) and ``bbox_iou_ltwh``;
  * ``streamyolo_torch/native/image_io.cpp``: ``jpeg_header`` /
    ``jpeg_decode`` (sequential, progressive and lossless JPEG, Huffman- or
    arithmetic-coded, gray, YCbCr, RGB, CMYK or YCCK, bit-exact with
    ``cv2.imread``),
    ``jpeg_encode`` (byte-exact with ``cv2.imencode('.jpg')``),
    ``png_data_size`` / ``png_decode`` (a PNG's inflated pixel data, as
    ``cv2.imread`` reads it), ``exif_orientation_tag`` and ``resize_linear_u8`` (``cv2.resize`` with ``INTER_LINEAR``),
    for ``data/image_io.py`` and ``data/cv2_ops.py``;
  * ``streamyolo_torch/native/draw.cpp``: ``draw_text`` / ``text_extent``
    (``cv2.putText`` / ``cv2.getTextSize`` with ``FONT_HERSHEY_SIMPLEX``:
    cv2 5.0's TrueType rendering of the Rubik variable font) and
    ``draw_rectangle`` (``cv2.rectangle``), bit-exact, for ``vis/draw.py``.

Each library is built with ``g++`` at first use, not at import, into
``build/native/`` of the checkout, named by a hash of its source and flags;
a process-wide lock makes each build happen once in a process, and the
result is written to a temporary name and renamed, so parallel processes
(test workers, spawned loader workers) never load a half-written file and
later ones load the finished one. A missing ``g++`` or a failed build
raises ``NativeBuildError`` with the compiler's output; nothing stands in
for a library that does not build.
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
IMAGE_IO_SOURCE = Path(__file__).resolve().parent / "image_io.cpp"
BUILD_DIR = ROOT / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
# the resize's float map must round as NumPy's does (no fused multiply-add);
# corrupt JPEG coefficients wrap rather than overflow into undefined behaviour
IMAGE_IO_FLAGS = CXX_FLAGS + ("-ffp-contract=off", "-fwrapv")
DRAW_SOURCE = Path(__file__).resolve().parent / "draw.cpp"
# the rasteriser's float arithmetic must round as cv2's build does (no fused
# multiply-add)
DRAW_FLAGS = CXX_FLAGS + ("-ffp-contract=off",)

_lock = threading.Lock()
_libs: dict = {}


class NativeBuildError(RuntimeError):
    """``g++`` is missing or failed on a native source."""


def _target(source: Path = SOURCE, flags=CXX_FLAGS) -> Path:
    digest = hashlib.sha256(source.read_bytes() + " ".join(flags).encode())
    return BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:16]}.so"


def _build(source: Path, flags, out: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise NativeBuildError(f"g++ not found: cannot build {source.name}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *flags, str(source), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(
            f"g++ failed on {source.name} (exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)


def _load(source: Path, flags, declare) -> ctypes.CDLL:
    """``source`` built with ``flags`` (once), loaded, its signatures set by
    ``declare(lib)``."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            path = _target(source, flags)
            if not path.exists():
                _build(source, flags, path)
            lib = ctypes.CDLL(str(path))
            declare(lib)
            _libs[source] = lib
        return lib


_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


def _declare_native(lib: ctypes.CDLL) -> None:
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


def _declare_image_io(lib: ctypes.CDLL) -> None:
    lib.jpeg_header.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, _i64p,  # data, size, info[3]
        ctypes.c_char_p, ctypes.c_int64,         # error message buffer
    ]
    lib.jpeg_header.restype = ctypes.c_int
    lib.jpeg_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, _u8p,   # data, size, out [h, w, 3]
        ctypes.c_int64, ctypes.c_int64,          # h, w
        ctypes.c_char_p, ctypes.c_int64,
    ]
    lib.jpeg_decode.restype = ctypes.c_int
    lib.resize_linear_u8.argtypes = [
        _u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # src, h, w, c
        _u8p, ctypes.c_int64, ctypes.c_int64,                  # dst, out_h, out_w
    ]
    lib.resize_linear_u8.restype = None
    lib.jpeg_encode.argtypes = [
        _u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # img, h, w, channels
        ctypes.c_int64, _u8p, ctypes.c_int64,                  # quality, out, capacity
        ctypes.c_char_p, ctypes.c_int64,
    ]
    lib.jpeg_encode.restype = ctypes.c_int64
    lib.png_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,                       # inflated IDAT, size
        ctypes.c_int64, ctypes.c_int64,                        # h, w
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,        # depth, colour type, interlaced
        _u8p, _u8p,                                            # palette [256, 3], out [h, w, 3]
        ctypes.c_char_p, ctypes.c_int64,
    ]
    lib.png_decode.restype = ctypes.c_int
    lib.png_data_size.argtypes = [
        ctypes.c_int64, ctypes.c_int64,                        # h, w
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,        # depth, colour type, interlaced
        ctypes.c_char_p, ctypes.c_int64,
    ]
    lib.png_data_size.restype = ctypes.c_int64
    lib.exif_orientation_tag.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.exif_orientation_tag.restype = ctypes.c_int


def _declare_draw(lib: ctypes.CDLL) -> None:
    lib.draw_text.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,                       # font, size
        _u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # img, h, w, channels
        _i32p, ctypes.c_int64,                                 # code points, n
        ctypes.c_int64, ctypes.c_int64,                        # org x, y
        ctypes.c_int64, ctypes.c_int64, _i32p,                 # pixel size, weight, colour
        ctypes.c_char_p, ctypes.c_int64,
    ]
    lib.draw_text.restype = ctypes.c_int
    lib.text_extent.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, _i32p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, _i64p,                 # size, weight, out[3]
        ctypes.c_char_p, ctypes.c_int64,
    ]
    lib.text_extent.restype = ctypes.c_int
    lib.draw_rectangle.argtypes = [
        _u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # img, h, w, channels
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # x1, y1, x2, y2
        _i32p, ctypes.c_int64,                                 # colour, thickness
    ]
    lib.draw_rectangle.restype = None


def load() -> ctypes.CDLL:
    """The loaded ``native/streamyolo_native.cpp`` library, built on first use."""
    return _load(SOURCE, CXX_FLAGS, _declare_native)


def load_image_io() -> ctypes.CDLL:
    """The loaded ``image_io.cpp`` library, built on first use."""
    return _load(IMAGE_IO_SOURCE, IMAGE_IO_FLAGS, _declare_image_io)


def load_draw() -> ctypes.CDLL:
    """The loaded ``draw.cpp`` library, built on first use."""
    return _load(DRAW_SOURCE, DRAW_FLAGS, _declare_draw)


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
