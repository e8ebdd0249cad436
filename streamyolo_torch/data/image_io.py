"""Reading and writing frames without cv2: the port's counterpart of the JAX
package's ``cv2.imread`` / ``cv2.imwrite``, for a host (the card's) that has
no cv2, PIL or torchvision.

  * ``imdecode(buf)``: JPEG (baseline, extended sequential, progressive
    or lossless, Huffman- or arithmetic-coded, one scan or several; gray,
    YCbCr, RGB, CMYK or YCCK) or PNG bytes -> [H, W, 3] BGR uint8, equal
    bit for bit to ``cv2.imdecode(buf, cv2.IMREAD_COLOR)``;
  * ``imread(path)``: the file's bytes through ``imdecode``, equal to
    ``cv2.imread(path)``;
  * ``image_size(path)``: (height, width) of what ``imread`` returns, from
    the headers alone;
  * ``imencode(img, fmt)``: [H, W, 3] BGR or [H, W] gray uint8 -> the
    bytes of ``cv2.imencode('.jpg', img, [IMWRITE_JPEG_QUALITY, fmt])``,
    byte for byte, for a quality ``fmt``; a PNG for ``fmt=".png"``;
  * ``imwrite(path, img, quality)``: those bytes to a ``.jpg`` / ``.jpeg``
    or ``.png`` file.

The codecs are native (``native/image_io.cpp``, built with ``g++`` at first
use). The JPEG decoder transcribes libjpeg-turbo's default decompression, as
cv2 runs it (the islow IDCT, fancy upsampling, its colour conversions); it
reads files of 1, 3 or 4 components at 8 bits, any integral sampling
factors, restart intervals and files without a DHT (libjpeg's standard
tables): baseline and extended sequential (SOF0 / SOF1) with one scan or
several (a scan of part of the components), progressive (SOF2: spectral
selection and successive approximation, libjpeg's block smoothing where the
last refinement scans are missing), the same two arithmetic-coded (SOF9 /
SOF10: jdarith.c's QM decoder, a DAC segment's conditioning) and lossless
frames (SOF3: predictors 1-7, point transforms, 2 to 8 bits, replicated
upsampling). A file read in several scans goes through a whole-image
coefficient buffer, as in libjpeg. The colour space is libjpeg's: a JFIF
segment, an Adobe segment's transform or the component ids make three
components YCbCr or RGB and four CMYK or YCCK, and CMYK becomes BGR as
OpenCV converts it. Lossless arithmetic-coded and hierarchical files,
12-bit samples, lossless gray, YCbCr and YCCK frames (libjpeg converts no
colour in lossless mode), 2 or 5 components and scan parameters libjpeg
refuses raise ``OSError`` naming them, as cv2 returns None for them. Where
libjpeg meets corrupt or truncated entropy-coded data it warns, fills the
rest with zeros and returns an image; ``imdecode`` raises ``OSError``
instead. The encoder transcribes libjpeg-turbo's default compression
(baseline, 4:2:0 for colour, standard Huffman tables, JFIF 1.01).

PNG writing is what cv2's defaults do with libpng: 8-bit RGB or gray, the
Sub filter on every row (None on rows of one pixel), a ``zlib`` stream at level 1 with the run-length
strategy (its header's window size cut to the image, as libpng's
``optimize_cmf`` does), IDAT chunks of 8192 bytes. Where Python's zlib
deflates as cv2's does (zlib 1.2.13 and cv2 5.0 in the tests), the bytes
equal ``cv2.imencode('.png')``'s.

A PNG's chunks are parsed here (CRCs checked with ``zlib.crc32``, a bad one
drops an ancillary chunk as libpng does and refuses the file in a critical
one) and its data inflated with ``zlib``; the native code undoes the filters
and the Adam7 interlace and converts as cv2 asks libpng to: 16-bit samples
to their high byte, 1/2/4-bit gray scaled to 0..255, gray replicated, the
palette expanded, alpha (and so tRNS) dropped without compositing, RGB to
BGR. Files for which cv2 returns None (a bad CRC in a critical chunk, a
truncated or corrupt data stream, a bad filter type, no IEND) raise
``OSError``, as do animated PNGs and unknown critical chunks.

cv2 applies an Exif Orientation tag (a JPEG's APP1 segment, a PNG's eXIf
chunk), and so do ``imdecode`` and ``image_size``, here in NumPy.
"""

from __future__ import annotations

import ctypes
import os
import struct
import zlib
from typing import NamedTuple, Tuple

import numpy as np

from streamyolo_torch.native import load_image_io

_ERR_LEN = 256
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> the bit depths the PNG specification allows for it
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
_PNG_MAX_SIDE, _PNG_MAX_PIXELS = 1_000_000, 1 << 30  # libpng's and cv2's limits
_JPEG_EXTENSIONS = (".jpg", ".jpeg")
_PNG_IDAT_SIZE = 8192  # libpng's compression buffer, the size of each IDAT chunk


def _header(buf: bytes):
    """(height, width, orientation) of the undecoded JPEG; OSError for a
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


class _Png(NamedTuple):
    height: int
    width: int
    depth: int
    color_type: int
    interlaced: bool
    palette: bytes  # the PLTE chunk's RGB triples (palette images only)
    data: bytes  # the IDAT chunks' concatenated (deflated) bytes
    orientation: int  # of the first eXIf chunk, 0 if none


def _png_chunks(buf: bytes) -> _Png:
    """The chunks of a PNG file that cv2's reading depends on; OSError
    where cv2 returns None, or for what this reader does not support."""
    n, pos = len(buf), len(_PNG_SIGNATURE)
    ihdr = palette = None
    idat, orientation, plte_seen = [], None, False
    idat_done = False  # a chunk other than IDAT followed the IDAT chunks
    while True:
        if n - pos < 8:
            raise OSError("truncated PNG: no IEND chunk")
        length, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        name = kind.decode("latin-1")
        if length > n - pos - 12:
            raise OSError(f"truncated PNG: the {name} chunk ends past the file")
        data = buf[pos + 8:pos + 8 + length]
        crc = int.from_bytes(buf[pos + 8 + length:pos + 12 + length], "big")
        pos += 12 + length
        if ihdr is None and kind != b"IHDR":
            raise OSError(f"PNG: the first chunk is {name}, not IHDR")
        critical = not kind[0] & 0x20
        if zlib.crc32(kind + data) != crc:
            if critical:
                raise OSError(f"PNG {name} chunk: CRC mismatch")
            continue  # libpng drops an ancillary chunk with a bad CRC
        if kind == b"IHDR":
            if ihdr is not None:
                raise OSError("PNG: more than one IHDR chunk")
            if length != 13:
                raise OSError(f"PNG IHDR chunk of {length} bytes, not 13")
            ihdr = struct.unpack(">IIBBBBB", data)
        elif kind == b"PLTE":
            if plte_seen:
                raise OSError("PNG: more than one PLTE chunk")
            plte_seen = True
            if not idat:  # libpng reads a palette only before the data
                palette = data
        elif kind == b"IDAT":
            if idat_done:
                raise OSError("PNG: IDAT chunks that are not consecutive")
            idat.append(data)
        elif kind == b"IEND":
            break
        elif kind == b"eXIf":
            if orientation is None:
                orientation = load_image_io().exif_orientation_tag(data, len(data))
        elif kind in (b"acTL", b"fcTL", b"fdAT"):
            raise OSError(f"animated PNG ({name} chunk) is not supported")
        elif critical:
            raise OSError(f"PNG: unknown critical chunk {name}")
        if idat and kind != b"IDAT":
            idat_done = True
    width, height, depth, color_type, compression, filter_method, interlace = ihdr
    if not (1 <= width <= _PNG_MAX_SIDE and 1 <= height <= _PNG_MAX_SIDE
            and width * height <= _PNG_MAX_PIXELS):
        raise OSError(f"PNG size {height}x{width} is outside what cv2 reads")
    if depth not in _PNG_DEPTHS.get(color_type, ()):
        raise OSError(f"PNG: bit depth {depth} with colour type {color_type} is not valid")
    if compression or filter_method or interlace > 1:
        raise OSError(f"PNG: compression {compression}, filter method {filter_method}, "
                      f"interlace {interlace}: not valid")
    if not idat:
        raise OSError("PNG: no IDAT chunk")
    if color_type == 3:
        if palette is None:
            raise OSError("PNG: palette image without a PLTE chunk before its data")
        if not palette or len(palette) % 3 or len(palette) > 768:
            raise OSError(f"PNG PLTE chunk of {len(palette)} bytes")
    return _Png(height, width, depth, color_type, interlace == 1, palette or b"",
                b"".join(idat), orientation or 0)


def _png_decode(buf: bytes) -> np.ndarray:
    png = _png_chunks(buf)
    lib = load_image_io()
    err = ctypes.create_string_buffer(_ERR_LEN)
    need = lib.png_data_size(png.height, png.width, png.depth, png.color_type,
                             int(png.interlaced), err, _ERR_LEN)
    if need < 0:
        raise OSError(err.value.decode(errors="replace"))
    inflate = zlib.decompressobj()
    try:
        raw = inflate.decompress(png.data, need)
        while not inflate.eof:  # the stream must end; data past the image is dropped
            more = inflate.decompress(inflate.unconsumed_tail, 1 << 20)
            if not more and not inflate.unconsumed_tail:
                break
    except zlib.error as e:
        raise OSError(f"PNG: corrupt IDAT data stream ({e})") from e
    if not inflate.eof:
        raise OSError("PNG: truncated IDAT data stream")
    if len(raw) < need:
        raise OSError(f"PNG: {len(raw)} bytes of image data, {need} needed")
    palette = np.zeros(768, np.uint8)
    palette[:len(png.palette)] = np.frombuffer(png.palette, np.uint8)
    out = np.empty((png.height, png.width, 3), np.uint8)
    if lib.png_decode(raw, len(raw), png.height, png.width, png.depth, png.color_type,
                      int(png.interlaced), palette, out, err, _ERR_LEN) != 0:
        raise OSError(err.value.decode(errors="replace"))
    return _orient(out, png.orientation)


def imdecode(buf: bytes) -> np.ndarray:
    """JPEG or PNG bytes -> [H, W, 3] BGR uint8, as
    ``cv2.imdecode(buf, cv2.IMREAD_COLOR)``; ``OSError`` where the data is
    not such a file, is a kind cv2 does not read, or is corrupt."""
    buf = bytes(buf)
    if buf.startswith(_PNG_SIGNATURE):
        return _png_decode(buf)
    h, w, orientation = _header(buf)
    out = np.empty((h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if load_image_io().jpeg_decode(buf, len(buf), out, h, w, err, _ERR_LEN) != 0:
        raise OSError(err.value.decode(errors="replace"))
    return _orient(out, orientation)


def imread(path) -> np.ndarray:
    """``cv2.imread(path)`` for a JPEG or PNG file: [H, W, 3] BGR uint8.
    Raises ``OSError`` naming ``path`` where cv2 would return None."""
    path = os.fspath(path)
    try:
        with open(path, "rb") as f:
            buf = f.read()
        return imdecode(buf)
    except OSError as e:
        raise OSError(f"cannot read {path}: {e}") from e


def image_size(path) -> Tuple[int, int]:
    """(height, width) of ``imread(path)``, from the segments before a
    JPEG's scan or a PNG's chunks, without decoding."""
    path = os.fspath(path)
    try:
        with open(path, "rb") as f:
            buf = f.read()
        if buf.startswith(_PNG_SIGNATURE):
            png = _png_chunks(buf)
            h, w, orientation = png.height, png.width, png.orientation
        else:
            h, w, orientation = _header(buf)
    except OSError as e:
        raise OSError(f"cannot read {path}: {e}") from e
    return (w, h) if orientation in (5, 6, 7, 8) else (h, w)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def _png_encode(img: np.ndarray) -> bytes:
    """A [H, W, 3] BGR or [H, W] gray uint8 image as an 8-bit RGB or gray
    PNG, as cv2 writes it by default."""
    h, w = img.shape[:2]
    channels = 1 if img.ndim == 2 else 3
    rows = (img if channels == 1 else img[..., ::-1]).reshape(h, w * channels)
    filtered = np.empty((h, 1 + w * channels), np.uint8)
    # Sub: each byte less the byte one pixel to its left; None (the same
    # bytes) for rows of one pixel, as libpng writes them
    filtered[:, 0] = 1 if w > 1 else 0
    filtered[:, 1:1 + channels] = rows[:, :channels]
    np.subtract(rows[:, channels:], rows[:, :-channels], out=filtered[:, 1 + channels:])
    wbits = 15  # png_deflate_claim: a window no larger than the image needs
    while filtered.size <= 16384 and filtered.size + 262 <= 1 << (wbits - 1) and wbits > 9:
        wbits -= 1
    deflate = zlib.compressobj(1, zlib.DEFLATED, wbits, 8, zlib.Z_RLE)
    data = bytearray(deflate.compress(filtered.tobytes()) + deflate.flush())
    if filtered.size <= 16384:  # optimize_cmf: the header claims the least window that holds it
        cinfo = data[0] >> 4
        while cinfo > 0 and filtered.size <= 1 << (cinfo + 7):
            cinfo -= 1
        data[0] = (data[0] & 0x0F) | (cinfo << 4)
        flags = data[1] & 0xE0
        data[1] = flags + 0x1F - ((data[0] << 8) + flags) % 0x1F
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0 if channels == 1 else 2, 0, 0, 0)
    return b"".join([_PNG_SIGNATURE, _png_chunk(b"IHDR", ihdr),
                     *(_png_chunk(b"IDAT", bytes(data[i:i + _PNG_IDAT_SIZE]))
                       for i in range(0, len(data), _PNG_IDAT_SIZE)),
                     _png_chunk(b"IEND", b"")])


def imencode(img: np.ndarray, fmt=95) -> bytes:
    """``cv2.imencode('.jpg', img, [cv2.IMWRITE_JPEG_QUALITY, fmt])[1]`` as
    bytes, byte for byte, for a JPEG quality ``fmt`` (an int in 0..100);
    ``fmt`` ``".jpg"`` / ``".jpeg"`` is quality 95, ``".png"`` a PNG as
    cv2 writes it by default. ``img`` is [H, W, 3] BGR or [H, W] (or
    [H, W, 1]) gray uint8."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"JPEG and PNG write uint8 images, not {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"JPEG and PNG write [H, W, 3] BGR or [H, W] gray images, not {img.shape}")
    quality = fmt
    if isinstance(fmt, str):
        if fmt.lower() == ".png":
            if img.size == 0:
                raise ValueError(f"PNG size {img.shape[0]}x{img.shape[1]} is empty")
            return _png_encode(np.ascontiguousarray(img))
        if fmt.lower() not in _JPEG_EXTENSIONS:
            raise ValueError(f"imencode writes JPEG (.jpg, .jpeg) and PNG (.png), not '{fmt}'")
        quality = 95
    if not (isinstance(quality, (int, np.integer)) and 0 <= quality <= 100):
        raise ValueError(f"JPEG quality {quality!r} is not an int in 0..100")
    img = np.ascontiguousarray(img)
    h, w = img.shape[:2]
    channels = 1 if img.ndim == 2 else 3
    lib = load_image_io()
    err = ctypes.create_string_buffer(_ERR_LEN)
    cap = 4096 + img.size // 2
    while True:
        out = np.empty(cap, np.uint8)
        size = lib.jpeg_encode(img.reshape(-1), h, w, channels, int(quality), out, cap,
                               err, _ERR_LEN)
        if size < 0:
            raise ValueError(err.value.decode(errors="replace"))
        if size <= cap:
            return out[:size].tobytes()
        cap = size


def imwrite(path, img: np.ndarray, quality: int = 95) -> None:
    """``cv2.imwrite(path, img, [cv2.IMWRITE_JPEG_QUALITY, quality])`` for a
    ``.jpg`` / ``.jpeg`` path, ``cv2.imwrite(path, img)`` for ``.png``: the
    bytes of ``imencode``. Any other extension raises ``ValueError``."""
    path = os.fspath(path)
    ext = os.path.splitext(path)[1].lower()
    if ext not in (*_JPEG_EXTENSIONS, ".png"):
        raise ValueError(f"imwrite writes JPEG (.jpg, .jpeg) and PNG (.png), not '{ext}': {path}")
    data = imencode(img, ".png" if ext == ".png" else quality)
    with open(path, "wb") as f:
        f.write(data)
