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
  * ``codings/frames/seq00/00000{0,1,2}.jpg``: the three baseline frames'
    own quantized coefficients arithmetic-coded (``tests/torch_jpeg_codings.py``):
    sequential (SOF9), sequential with a DAC segment and a restart interval,
    and libjpeg's progressive script (SOF10); they read to the baseline
    frames' bytes;
  * ``codings/small/*.jpg``: crops of frame 0 in each sampling factor as
    arithmetic-coded transcodes of ``small/`` (sequential, progressive, with
    DAC and restarts; gray; a progressive file cut after its fourth scan),
    lossless RGB frames (SOF3, a predictor each), CMYK (Adobe transform 0)
    and YCCK (transform 2) frames, RGB-coded frames (Adobe transform 0, ids
    'R', 'G', 'B'), and PIL's CMYK and RGB files;
  * ``png/*.png``: crops of frame 0 written by cv2 (BGR, BGRA 16-bit, gray)
    and PNGs built chunk by chunk (``tests/torch_png.py``: a 4-bit palette
    with tRNS and Adam7, 2-bit gray with every filter type, 16-bit RGB with
    Adam7, an eXIf orientation);
  * ``digests.json``: the sha256 and shape of ``cv2.imread`` of every JPEG
    (``decode``) and PNG (``png``), of ``cv2.imdecode`` of frame 0 made a
    4-component frame by ``tests/torch_jpeg_codings.py::four_component_frame``
    (``derived``: CMYK and YCCK, which ``chip_smoke.py`` builds and times),
    of ``cv2.resize`` (``INTER_LINEAR``) of each frame to
    600x960 and 601x959 (``resize``), the sha256 of ``cv2.imencode('.jpg')``
    of each frame at quality 90 and 95 (``encode``), and of each file of
    the JAX package's ``make_synthetic_argoverse`` at 2 x 11 frames of
    1200x1920, seed 0 (``from_disk``: what ``chip_smoke.py``'s phase
    ``from_disk`` writes with the port).

    JAX_PLATFORMS=cpu python tests/torch_jpeg/make_fixtures.py

Needs cv2, PIL and the JAX package. The files are committed; run this
again only to change them, then commit the new digests with them.
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


# (h, v) of the first and the middle components of each sampling (the
# fourth component of a CMYK or YCCK frame is sampled as the first)
CODING_SAMPLINGS = {"s411": ((4, 1), (1, 1)), "s420": ((2, 2), (1, 1)), "s422": ((2, 1), (1, 1)),
                    "s440": ((1, 2), (1, 1)), "s444": ((1, 1), (1, 1))}
DAC = {("dc", 0): (1, 4), ("dc", 1): (0, 2), ("ac", 0): 12, ("ac", 1): 3}


def write_codings(out: Path, frames_dir: Path, small_dir: Path, crop) -> None:
    """The files of ``codings/`` (see the module's docstring)."""
    import io

    import numpy as np
    from PIL import Image

    from tests.torch_jpeg_codings import (SIMPLE_PROGRESSION_1, SIMPLE_PROGRESSION_3,
                                          dct_coefficients, read_coefficients, write_arith,
                                          write_lossless)
    from tests.torch_jpeg_scans import geometry, write_jpeg

    shutil.rmtree(out, ignore_errors=True)
    (out / "frames" / "seq00").mkdir(parents=True)
    (out / "small").mkdir(parents=True)
    seq = [([0, 1, 2], 0, 63, 0, 0)]
    for name, kw in (("000000.jpg", {}), ("000001.jpg", {"restart": 60, "dac": DAC}),
                     ("000002.jpg", {})):
        h, w, samp, quant, coefs = read_coefficients((frames_dir / name).read_bytes())
        progressive = name == "000002.jpg"
        (out / "frames" / "seq00" / name).write_bytes(write_arith(
            coefs, h, w, samp, quant, SIMPLE_PROGRESSION_3 if progressive else seq, progressive,
            **kw))

    def small(name: str, data: bytes) -> None:
        (out / "small" / name).write_bytes(data)

    img = crop[:37, :53].astype(np.int64)
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    # jccolor.c's YCbCr of the pixels, and a K plane
    y = np.round(0.299 * r + 0.587 * g + 0.114 * b)
    cb = np.round(128 - 0.168736 * r - 0.331264 * g + 0.5 * b)
    cr = np.round(128 + 0.5 * r - 0.418688 * g - 0.081312 * b)
    k = 255 - (np.maximum(np.maximum(r, g), b) // 2)
    rng = np.random.default_rng(0)
    quant = [rng.integers(2, 12, 64) for _ in range(4)]

    def dct_file(planes, samp, writer, **kw):
        geo, hmax, vmax = geometry(37, 53, samp)
        coefs = [dct_coefficients(p[::vmax // v, ::hmax // h], quant[c], (bh, bw))
                 for c, (p, (h, v), (_, _, bw, bh)) in enumerate(zip(planes, samp, geo))]
        comps = list(range(len(samp)))
        if writer == "arith":
            return write_arith(coefs, 37, 53, samp, quant[:len(samp)], [(comps, 0, 63, 0, 0)],
                               False, **kw)
        return write_jpeg(coefs, 37, 53, samp, quant[:len(samp)], [(comps, 0, 63)], False, **kw)

    for psv, (sname, (first, middle)) in enumerate(sorted(CODING_SAMPLINGS.items()), 1):
        h, w, samp, qt, coefs = read_coefficients((small_dir / f"{sname}_37x53.jpg").read_bytes())
        small(f"arith_seq_{sname}_37x53.jpg", write_arith(coefs, h, w, samp, qt, seq, False))
        small(f"arith_prog_{sname}_37x53.jpg",
              write_arith(coefs, h, w, samp, qt, SIMPLE_PROGRESSION_3, True))
        small(f"arith_dac_restart_{sname}_37x53.jpg",
              write_arith(coefs, h, w, samp, qt, seq, False, restart=2, dac=DAC))
        samp3, samp4 = [first, middle, middle], [first, middle, middle, first]
        hmax, vmax = max(a for a, _ in samp3), max(a for _, a in samp3)
        planes = [p[::vmax // v, ::hmax // hh][:-(-37 * v // vmax), :-(-53 * hh // hmax)]
                  for p, (hh, v) in zip((r, g, b), samp3)]
        small(f"lossless_p{psv}_{sname}_37x53.jpg", write_lossless(
            planes, 37, 53, samp3, 8, psv, pt=psv % 3, restart_rows=psv % 2))
        small(f"cmyk_{sname}_37x53.jpg", dct_file((r, g, b, k), samp4, "huffman", adobe=0))
        small(f"ycck_{sname}_37x53.jpg", dct_file((y, cb, cr, k), samp4, "huffman", adobe=2))
        small(f"rgb_adobe_{sname}_37x53.jpg", dct_file((r, g, b), samp3, "huffman", adobe=0))
        small(f"rgb_ids_{sname}_37x53.jpg", dct_file((r, g, b), samp3, "huffman",
                                                     ids=[82, 71, 66]))
    small("arith_ycck_s420_37x53.jpg", dct_file(
        (y, cb, cr, k), [(2, 2), (1, 1), (1, 1), (2, 2)], "arith", adobe=2))
    small("lossless_cmyk_37x53.jpg", write_lossless((r, g, b, k), 37, 53, [(1, 1)] * 4, 8, 7,
                                                    adobe=0))
    h, w, samp, qt, coefs = read_coefficients((small_dir / "gray_37x53.jpg").read_bytes())
    small("arith_seq_gray_37x53.jpg", write_arith(coefs, h, w, samp, qt, [([0], 0, 63, 0, 0)],
                                                  False))
    small("arith_prog_gray_37x53.jpg", write_arith(coefs, h, w, samp, qt, SIMPLE_PROGRESSION_1,
                                                   True))
    h, w, samp, qt, coefs = read_coefficients((small_dir / "restart_120x161.jpg").read_bytes())
    small("arith_restart_120x161.jpg", write_arith(coefs, h, w, samp, qt, seq, False, restart=3))
    whole = write_arith(coefs, h, w, samp, qt, SIMPLE_PROGRESSION_3, True, restart=3)
    small("arith_incomplete_4scans_120x161.jpg", first_scans(whole, 4))
    pil = Image.fromarray(np.ascontiguousarray(crop[..., ::-1]))
    for name, im, kw in (("pil_cmyk_q90_120x161.jpg", pil.convert("CMYK"), {}),
                         ("pil_cmyk_s420_q90_120x161.jpg", pil.convert("CMYK"),
                          {"subsampling": 2}),
                         ("pil_rgb_q90_120x161.jpg", pil, {"keep_rgb": True})):
        data = io.BytesIO()
        im.save(data, "JPEG", quality=90, **kw)
        small(name, data.getvalue())


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
    write_codings(HERE / "codings", frames_dir, small_dir, crop)

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
    from tests.torch_jpeg_codings import four_component_frame

    frame0 = (frames_dir / "000000.jpg").read_bytes()
    derived = {name: digest(cv2.imdecode(np.frombuffer(four_component_frame(frame0, t), np.uint8),
                                         cv2.IMREAD_COLOR))
               for name, t in (("cmyk_frame", 0), ("ycck_frame", 2))}
    from_disk = {}
    with tempfile.TemporaryDirectory() as tmp:
        make_synthetic_argoverse(tmp, **FROM_DISK)
        for path in sorted(Path(tmp).rglob("*.jpg")):
            from_disk[path.relative_to(tmp).as_posix()] = hashlib.sha256(
                path.read_bytes()).hexdigest()
    with open(HERE / "digests.json", "w") as f:
        json.dump({"cv2": cv2.__version__, "decode": decode, "derived": derived,
                   "resize": resize, "png": png,
                   "encode": encode, "from_disk": {"params": FROM_DISK, "sha256": from_disk}},
                  f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
