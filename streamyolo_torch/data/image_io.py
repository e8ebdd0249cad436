"""Reading frames without cv2: the port's counterpart of the JAX package's
``cv2.imread``, for a host (the card's) that has no cv2, PIL or
torchvision.

  * ``imdecode(buf)``: baseline JPEG bytes -> [H, W, 3] BGR uint8, equal bit
    for bit to ``cv2.imdecode(buf, cv2.IMREAD_COLOR)``;
  * ``imread(path)``: the file's bytes through ``imdecode``, equal to
    ``cv2.imread(path)``;
  * ``image_size(path)``: (height, width) of what ``imread`` returns, from
    the frame header alone.

The decoder is native (``native/image_io.cpp``, built with ``g++`` at first
use): libjpeg-turbo's default decompression, as cv2 runs it, transcribed
(the islow IDCT, fancy upsampling, its YCbCr -> RGB tables). cv2 applies an
Exif Orientation tag, and so does ``imdecode``, here in NumPy. It reads
baseline and extended-sequential Huffman files with one scan of 1 or 3
components at 8 bits, any integral sampling factors, restart intervals and
files without a DHT (libjpeg's standard tables). Anything else (progressive,
lossless, arithmetic, 12-bit, CMYK, an RGB-coded file, multiple scans, PNG)
raises ``OSError`` naming it. Where libjpeg meets corrupt or truncated
entropy-coded data it warns, fills the rest with zeros and returns an
image; ``imdecode`` raises ``OSError`` instead.
"""

from __future__ import annotations

import ctypes
import os
from typing import Tuple

import numpy as np

from streamyolo_torch.native import load_image_io

_ERR_LEN = 256


def _header(buf: bytes):
    """(height, width, orientation) of the undecoded image; OSError for a
    file the decoder refuses."""
    lib = load_image_io()
    info = np.zeros(3, np.int64)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if lib.jpeg_header(buf, len(buf), info, err, _ERR_LEN) != 0:
        raise OSError(err.value.decode(errors="replace"))
    return int(info[0]), int(info[1]), int(info[2])


def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """cv2's ``ApplyExifOrientation`` for tag values 1..8 (others: as is):
    5-8 transpose, then 2, 3, 6, 7 flip left-right and 3, 4, 7, 8 upside
    down."""
    if orientation in (5, 6, 7, 8):
        img = img.transpose(1, 0, 2)
    if orientation in (2, 3, 6, 7):
        img = img[:, ::-1]
    if orientation in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


def imdecode(buf: bytes) -> np.ndarray:
    """Baseline JPEG bytes -> [H, W, 3] BGR uint8, as
    ``cv2.imdecode(buf, cv2.IMREAD_COLOR)``; ``OSError`` where the data is
    not such a file or is corrupt."""
    buf = bytes(buf)
    h, w, orientation = _header(buf)
    out = np.empty((h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if load_image_io().jpeg_decode(buf, len(buf), out, h, w, err, _ERR_LEN) != 0:
        raise OSError(err.value.decode(errors="replace"))
    return _orient(out, orientation)


def imread(path) -> np.ndarray:
    """``cv2.imread(path)`` for a JPEG file: [H, W, 3] BGR uint8. Raises
    ``OSError`` naming ``path`` where cv2 would return None."""
    path = os.fspath(path)
    try:
        with open(path, "rb") as f:
            buf = f.read()
        return imdecode(buf)
    except OSError as e:
        raise OSError(f"cannot read {path}: {e}") from e


def image_size(path) -> Tuple[int, int]:
    """(height, width) of ``imread(path)``, from the segments before the
    scan, without decoding."""
    path = os.fspath(path)
    try:
        with open(path, "rb") as f:
            buf = f.read()
        h, w, orientation = _header(buf)
    except OSError as e:
        raise OSError(f"cannot read {path}: {e}") from e
    return (w, h) if orientation in (5, 6, 7, 8) else (h, w)
