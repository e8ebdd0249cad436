#!/usr/bin/env python3
"""Writes the JPEG and PNG fixtures that ``tests/test_torch_image_io.py``,
``tests/test_torch_image_write.py`` and ``chip_smoke.py``'s phases
``image_io`` and ``from_disk`` read, and cv2's digests of them:

  * ``frames/seq00/00000{0,1,2}.jpg``: frames 0-2 of sequence ``seq00`` of
    the JAX package's ``make_synthetic_argoverse`` at 1200x1920, seed 0
    (cv2, quality 90: baseline, 4:2:0, standard tables);
  * ``small/*.jpg``: crops of frame 0 written by cv2 in each sampling
    factor, grayscale, with a restart interval, with optimised Huffman
    tables, with an Exif orientation and without its DHT segments;
  * ``progressive/frames/seq00/00000{0,1,2}.jpg``: the same three frames'
    pixels (the port's ``SyntheticArgoverse``, draw for draw the JAX
    generator's) written by cv2 progressive at quality 90, which read to
    the baseline frames' bytes;
  * ``progressive/small/*.jpg``: the crops of ``small/`` written by cv2
    progressive in each sampling factor, grayscale, with optimised tables
    and with a restart interval; the 120x161 crop cut after its third scan
    (an incomplete file, which libjpeg smooths); and three files of
    ``tests/torch_jpeg_scans.py``: sequential non-interleaved scans, a
    spectral-selection script with a restart interval, and one whose bands
    stop at coefficient 9;
  * ``png/*.png``: crops of frame 0 written by cv2 (BGR, BGRA 16-bit, gray)
    and PNGs built chunk by chunk (``tests/torch_png.py``: a 4-bit palette
    with tRNS and Adam7, 2-bit gray with every filter type, 16-bit RGB with
    Adam7, an eXIf orientation);
  * ``digests.json``: the sha256 and shape of ``cv2.imread`` of every JPEG
    (``decode``) and PNG (``png``), of ``cv2.resize`` (``INTER_LINEAR``) of each frame to
    600x960 and 601x959 (``resize``), the sha256 of ``cv2.imencode('.jpg')``
    of each frame at quality 90 and 95 (``encode``), and of each file of
    the JAX package's ``make_synthetic_argoverse`` at 2 x 11 frames of
    1200x1920, seed 0 (``from_disk``: what ``chip_smoke.py``'s phase
    ``from_disk`` writes with the port).

    JAX_PLATFORMS=cpu python tests/torch_jpeg/make_fixtures.py

Needs cv2 and the JAX package. The files are committed; run this again
only to change them, then commit the new digests with them.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import struct
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
RESIZES = ((600, 960), (601, 959))
ENCODE_QUALITIES = (90, 95)
FROM_DISK = dict(seq_lens=(11, 11), size=(1200, 1920), seed=0)
SAMPLINGS = {"s411": 0x411111, "s420": 0x221111, "s422": 0x211111, "s440": 0x121111,
             "s444": 0x111111}


def digest(arr) -> dict:
    import numpy as np

    arr = np.ascontiguousarray(arr)
    return {"shape": list(arr.shape), "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}


def with_orientation(buf: bytes, orientation: int) -> bytes:
    """``buf`` with an Exif APP1 segment (IFD0: Orientation) after SOI."""
    tiff = (b"II*\x00" + struct.pack("<IH", 8, 1)
            + struct.pack("<HHII", 0x0112, 3, 1, orientation) + struct.pack("<I", 0))
    seg = b"Exif\x00\x00" + tiff
    return buf[:2] + b"\xff\xe1" + struct.pack(">H", len(seg) + 2) + seg + buf[2:]


def without_dht(buf: bytes) -> bytes:
    """``buf`` with its DHT segments removed (a decoder then uses the
    standard tables, which are what cv2 writes without optimisation)."""
    out, p = bytearray(buf[:2]), 2
    while buf[p + 1] != 0xDA:
        length = struct.unpack(">H", buf[p + 2:p + 4])[0]
        if buf[p + 1] != 0xC4:
            out += buf[p:p + 2 + length]
        p += 2 + length
    return bytes(out + buf[p:])


def first_scans(buf: bytes, k: int) -> bytes:
    """``buf`` up to the end of its k-th scan's data, then EOI."""
    p, scans = 2, 0
    while True:
        marker = buf[p + 1]
        p += 2 + struct.unpack(">H", buf[p + 2:p + 4])[0]
        if marker != 0xDA:
            continue
        while not (buf[p] == 0xFF and buf[p + 1] != 0 and not 0xD0 <= buf[p + 1] <= 0xD7):
            p += 1
        scans += 1
        if scans == k:
            return buf[:p] + b"\xff\xd9"


def main() -> None:
    import cv2
    import numpy as np

    sys.path.insert(0, str(HERE.parents[1]))
    from streamyolo_tpu.data.dbcode import make_synthetic_argoverse
    from streamyolo_torch.data.dbcode import SyntheticArgoverse
    from tests.torch_jpeg_scans import random_coefficients, write_jpeg
    from tests.torch_png import chunk, exif, png_file

    frames_dir = HERE / "frames" / "seq00"
    small_dir = HERE / "small"
    png_dir = HERE / "png"
    prog_frames, prog_small = HERE / "progressive" / "frames" / "seq00", HERE / "progressive" / "small"
    shutil.rmtree(HERE / "progressive", ignore_errors=True)
    for d in (frames_dir, small_dir, png_dir, prog_frames, prog_small):
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
    with tempfile.TemporaryDirectory() as tmp:
        make_synthetic_argoverse(tmp, seq_lens=(3,), size=(1200, 1920), seed=0)
        src = Path(tmp) / "Argoverse-1.1" / "tracking" / "seq00"
        for name in sorted(os.listdir(src)):
            shutil.copy(src / name, frames_dir / name)

    frame = cv2.imread(str(frames_dir / "000000.jpg"))
    crop = frame[560:680, 880:1041].copy()  # 120x161
    crop[30:70, 40:100] = (40, 200, 250)  # a chroma edge inside every crop
    files = {}
    for name, sf in SAMPLINGS.items():
        for h, w in ((37, 53), (17, 9), (1, 1)):
            files[f"{name}_{h}x{w}.jpg"] = (crop[:h, :w], [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sf])
    files["gray_37x53.jpg"] = (cv2.cvtColor(crop[:37, :53], cv2.COLOR_BGR2GRAY), [])
    files["restart_120x161.jpg"] = (crop, [cv2.IMWRITE_JPEG_RST_INTERVAL, 3])
    files["optimized_120x161.jpg"] = (crop, [cv2.IMWRITE_JPEG_OPTIMIZE, 1])
    for name, (img, params) in files.items():
        for out_dir, extra in ((small_dir, []), (prog_small, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])):
            ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90, *params, *extra])
            assert ok, name
            (out_dir / name).write_bytes(buf.tobytes())
    synth = SyntheticArgoverse(seq_lens=(3,), size=(1200, 1920), seed=0)
    for im in synth.data["images"]:
        ok, buf = cv2.imencode(".jpg", synth.frame(im), [cv2.IMWRITE_JPEG_QUALITY, 90,
                                                         cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
        assert ok, im["name"]
        (prog_frames / im["name"]).write_bytes(buf.tobytes())
    whole = (prog_small / "restart_120x161.jpg").read_bytes()
    (prog_small / "incomplete_3scans_120x161.jpg").write_bytes(first_scans(whole, 3))
    rng = np.random.default_rng(0)
    s420 = [(2, 2), (1, 1), (1, 1)]
    coefs = random_coefficients(rng, 37, 53, s420)
    quant = [rng.integers(1, 9, 64) for _ in s420]
    for name, progressive, script, restart in (
            ("scans_sequential_37x53.jpg", False, [([2], 0, 63), ([0], 0, 63), ([1], 0, 63)], 0),
            ("scans_spectral_restart_37x53.jpg", True,
             [([0, 1, 2], 0, 0), ([0], 1, 5), ([2], 1, 63), ([1], 1, 63), ([0], 6, 63)], 3),
            ("scans_incomplete_37x53.jpg", True, [([0, 1, 2], 0, 0), ([0], 1, 9)], 0)):
        (prog_small / name).write_bytes(write_jpeg(coefs, 37, 53, s420, quant, script,
                                                   progressive, restart))
    plain = (small_dir / "s420_37x53.jpg").read_bytes()
    (small_dir / "exif6_37x53.jpg").write_bytes(with_orientation(plain, 6))
    (small_dir / "no_dht_37x53.jpg").write_bytes(without_dht(plain))

    small = crop[:37, :53]
    wide = small.astype(np.uint16) * 257
    alpha = np.full((37, 53, 1), 40000, np.uint16)
    pngs = {"bgr_c9_37x53.png": (small, 9), "bgra16_c1_37x53.png": (
        np.concatenate([wide, alpha], -1), 1), "gray_c0_17x9.png": (small[:17, :9, 1], 0)}
    for name, (img, level) in pngs.items():
        ok, buf = cv2.imencode(".png", img, [cv2.IMWRITE_PNG_COMPRESSION, level])
        assert ok, name
        (png_dir / name).write_bytes(buf.tobytes())
    rng = np.random.default_rng(0)
    rgb = small[..., ::-1].astype(np.int64)
    (png_dir / "palette4_trns_adam7_37x53.png").write_bytes(png_file(
        rgb[..., :1] // 16, 4, 3, interlace=True, filters=(0, 1, 2, 3, 4),
        palette=rng.integers(0, 256, 48, np.uint8).tobytes(), trns=bytes(range(0, 160, 20))))
    (png_dir / "gray2_filters_37x53.png").write_bytes(png_file(
        rgb[..., 1:2] // 64, 2, 0, filters=(0, 1, 2, 3, 4)))
    (png_dir / "rgb16_adam7_17x9.png").write_bytes(png_file(
        rgb[:17, :9] * 257 + 128, 16, 2, interlace=True, filters=(4, 3, 1)))
    (png_dir / "exif6_17x9.png").write_bytes(png_file(
        rgb[:17, :9], 8, 2, filters=(4,), before=[chunk(b"eXIf", exif(6))]))

    decode, resize, encode, png = {}, {}, {}, {}
    for path in sorted([*HERE.glob("*/**/*.jpg"), *HERE.glob("png/*.png")]):
        rel = path.relative_to(HERE).as_posix()
        img = cv2.imread(str(path))
        assert img is not None, rel
        (png if rel.endswith(".png") else decode)[rel] = digest(img)
        if rel.startswith("frames/"):
            resize[rel] = {f"{h}x{w}": digest(cv2.resize(img, (w, h),
                                                          interpolation=cv2.INTER_LINEAR))
                           for h, w in RESIZES}
            encode[rel] = {}
            for q in ENCODE_QUALITIES:
                ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, q])
                assert ok, rel
                encode[rel][f"q{q}"] = {"size": len(buf),
                                        "sha256": hashlib.sha256(buf.tobytes()).hexdigest()}
    from_disk = {}
    with tempfile.TemporaryDirectory() as tmp:
        make_synthetic_argoverse(tmp, **FROM_DISK)
        for path in sorted(Path(tmp).rglob("*.jpg")):
            from_disk[path.relative_to(tmp).as_posix()] = hashlib.sha256(
                path.read_bytes()).hexdigest()
    with open(HERE / "digests.json", "w") as f:
        json.dump({"cv2": cv2.__version__, "decode": decode, "resize": resize, "png": png,
                   "encode": encode, "from_disk": {"params": FROM_DISK, "sha256": from_disk}},
                  f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
