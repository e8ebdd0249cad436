#!/usr/bin/env python3
"""Writes the JPEG fixtures that ``tests/test_torch_image_io.py`` and
``chip_smoke.py``'s phase ``image_io`` read, and cv2's digests of them:

  * ``frames/seq00/00000{0,1,2}.jpg``: frames 0-2 of sequence ``seq00`` of
    the JAX package's ``make_synthetic_argoverse`` at 1200x1920, seed 0
    (cv2, quality 90: baseline, 4:2:0, standard tables);
  * ``small/*.jpg``: crops of frame 0 written by cv2 in each sampling
    factor, grayscale, with a restart interval, with optimised Huffman
    tables, with an Exif orientation and without its DHT segments;
  * ``digests.json``: the sha256 and shape of ``cv2.imread`` of every file,
    and of ``cv2.resize`` (``INTER_LINEAR``) of each frame to 600x960 and
    601x959.

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


def main() -> None:
    import cv2
    import numpy as np

    sys.path.insert(0, str(HERE.parents[1]))
    from streamyolo_tpu.data.dbcode import make_synthetic_argoverse

    frames_dir = HERE / "frames" / "seq00"
    small_dir = HERE / "small"
    for d in (frames_dir, small_dir):
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
        ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90, *params])
        assert ok, name
        (small_dir / name).write_bytes(buf.tobytes())
    plain = (small_dir / "s420_37x53.jpg").read_bytes()
    (small_dir / "exif6_37x53.jpg").write_bytes(with_orientation(plain, 6))
    (small_dir / "no_dht_37x53.jpg").write_bytes(without_dht(plain))

    decode, resize = {}, {}
    for path in sorted(HERE.glob("*/**/*.jpg")):
        rel = path.relative_to(HERE).as_posix()
        img = cv2.imread(str(path))
        assert img is not None, rel
        decode[rel] = digest(img)
        if rel.startswith("frames/"):
            resize[rel] = {f"{h}x{w}": digest(cv2.resize(img, (w, h),
                                                          interpolation=cv2.INTER_LINEAR))
                           for h, w in RESIZES}
    with open(HERE / "digests.json", "w") as f:
        json.dump({"cv2": cv2.__version__, "decode": decode, "resize": resize}, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
