"""PNG files built chunk by chunk, for ``tests/test_torch_image_write.py``
and ``tests/torch_jpeg/make_fixtures.py``: every colour type and bit depth,
tRNS, Adam7 and a chosen filter type per row, which cv2's writer does not
offer, and damaged files."""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def chunk(kind: bytes, data: bytes, crc: int = None) -> bytes:
    """One chunk: length, type, data and its CRC (or ``crc`` as given)."""
    crc = zlib.crc32(kind + data) if crc is None else crc
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc & 0xFFFFFFFF)


def pack_row(samples: np.ndarray, depth: int) -> bytes:
    """One row of samples ([w, channels] integers) as PNG bytes: sub-byte
    depths packed from the high bits, 16-bit big-endian."""
    flat = np.asarray(samples).reshape(-1)
    if depth == 16:
        return flat.astype(">u2").tobytes()
    if depth == 8:
        return flat.astype(np.uint8).tobytes()
    per = 8 // depth
    out = bytearray(-(-len(flat) // per))
    for i, v in enumerate(flat):
        out[i // per] |= int(v) << (8 - depth * (i % per + 1))
    return bytes(out)


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def filter_row(row: bytes, prev: bytes, bpp: int, kind: int) -> bytes:
    """``row`` filtered with filter ``kind`` (0-4) against the row above."""
    out = bytearray([kind])
    for i, x in enumerate(row):
        a = row[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[kind]
        out.append((x - pred) & 0xFF)
    return bytes(out)


def raw_data(samples: np.ndarray, depth: int, interlace: bool, filters=(0,)) -> bytes:
    """The uncompressed image data of ``samples`` ([h, w, channels]): each
    row of each pass filtered with ``filters[row % len(filters)]``."""
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    out, k = bytearray(), 0
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        prev = bytes(len(pack_row(sub[0], depth)))
        for r in range(sub.shape[0]):
            row = pack_row(sub[r], depth)
            out += filter_row(row, prev, bpp, filters[k % len(filters)])
            prev, k = row, k + 1
    return bytes(out)


def png_file(samples: np.ndarray, depth: int, color_type: int, interlace: bool = False,
             filters=(0,), palette: bytes = None, trns: bytes = None, before=(), after=(),
             level: int = 6, raw: bytes = None) -> bytes:
    """A PNG of ``samples`` ([h, w, channels]), or of the image data ``raw``
    as given; ``before`` / ``after`` are chunks placed before the PLTE and
    after the IDAT chunk."""
    samples = np.asarray(samples)
    h, w = samples.shape[:2]
    if raw is None:
        raw = raw_data(samples.reshape(h, w, -1), depth, interlace, filters)
    out = SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0,
                                                 int(interlace)))
    out += b"".join(before)
    if palette is not None:
        out += chunk(b"PLTE", palette)
    if trns is not None:
        out += chunk(b"tRNS", trns)
    out += chunk(b"IDAT", zlib.compress(raw, level)) + b"".join(after)
    return out + chunk(b"IEND", b"")


def exif(orientation: int, big_endian: bool = False) -> bytes:
    """TIFF-structured Exif data (an eXIf chunk's body) whose IFD0 holds one
    tag, Orientation."""
    e = ">" if big_endian else "<"
    return ((b"MM\x00*" if big_endian else b"II*\x00") + struct.pack(e + "IH", 8, 1)
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack(e + "I", 0))
