"""The port's JPEG and PNG writing and PNG reading without cv2
(``streamyolo_torch/data/image_io.py`` over ``native/image_io.cpp``)
against cv2 5.x and the JAX package, on the CPU. Everything is compared for
equality; there is no tolerance.

  * ``imencode`` gives the bytes of ``cv2.imencode('.jpg')`` at qualities 0
    to 100, sizes 1x1 to 300x480 and a 1200x1920 frame, BGR and gray, and
    ``imdecode`` of them equals cv2's decode;
  * the port's ``make_synthetic_argoverse`` writes the JAX package's files
    byte for byte, and ``imwrite`` the files of ``tests/conftest.py``'s
    ``write_fake_argoverse``;
  * ``imdecode`` / ``imread`` / ``image_size`` of PNGs equal cv2's: files
    cv2 writes (gray, BGR, BGRA, 16-bit, compression 0 / 1 / 9), files built
    chunk by chunk (palettes at 1/2/4/8 bits with tRNS, 1/2/4-bit gray, gray
    with alpha, Adam7, every filter type, eXIf orientations), and damaged
    files, which raise ``OSError`` wherever cv2 returns None;
  * ``db_from_img_folder`` over PNG frames equals the JAX package's;
  * ``imencode(img, ".png")`` / ``imwrite`` of a ``.png`` give
    ``cv2.imencode('.png')``'s bytes, which cv2 and the port read back to
    the input.
"""

import hashlib
import json
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest

from streamyolo_tpu.data import dbcode as jdbcode
from streamyolo_torch.data import dbcode as tdbcode
from streamyolo_torch.data.image_io import image_size, imdecode, imencode, imread, imwrite
from tests import conftest
from tests.torch_png import chunk, exif, png_file, raw_data

cv2 = pytest.importorskip("cv2")

FIXTURES = Path(__file__).resolve().parent / "torch_jpeg"
QUALITIES = (0, 1, 10, 50, 75, 90, 95, 100)
SIZES = ((1, 1), (9, 17), (37, 53), (16, 16), (300, 480))


def textured(rng, h, w, channels=3):
    """Smooth colour regions with noise and a hard edge: every coefficient
    band carries data."""
    base = rng.integers(0, 256, (max(1, h // 8), max(1, w // 8), channels), np.uint8)
    img = cv2.resize(base, (w, h), interpolation=cv2.INTER_LINEAR).reshape(h, w, channels)
    noise = rng.integers(-12, 13, img.shape)
    img = np.clip(img.astype(np.int32) + noise, 0, 255).astype(np.uint8)
    img[h // 3:h // 2, w // 4:w // 2] = rng.integers(0, 256, channels)
    return img if channels > 1 else img[..., 0]


def cv2_encode(img, quality) -> bytes:
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert ok
    return buf.tobytes()


def cv2_decode(buf: bytes):
    return cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)


# ---------------------------------------------------------------- JPEG writing


@pytest.mark.parametrize("quality", QUALITIES)
def test_imencode_equals_cv2(quality):
    """Byte for byte at every size (1x1, sizes off the 16-pixel MCU grid)
    in colour and gray, on textured and on random images."""
    rng = np.random.default_rng(quality)
    for h, w in SIZES:
        for channels in (3, 1):
            for img in (textured(rng, h, w, channels),
                        rng.integers(0, 256, (h, w, channels)[:2 + (channels > 1)], np.uint8)):
                assert imencode(img, quality) == cv2_encode(img, quality), (h, w, channels)


def test_frame_encodes_and_round_trips_as_cv2():
    """A 1200x1920 frame of the JAX generator at quality 90 (and the
    default 95): cv2's bytes, and the committed digest of cv2's bytes; the
    round trip ``imdecode(imencode(x))`` equals cv2's, for it and for small
    colour and gray images."""
    digests = json.loads((FIXTURES / "digests.json").read_text())["encode"]
    rel = "frames/seq00/000000.jpg"
    frame = imread(FIXTURES / rel)
    got = imencode(frame, 90)
    assert got == cv2_encode(frame, 90)
    assert hashlib.sha256(got).hexdigest() == digests[rel]["q90"]["sha256"]
    assert imencode(frame) == cv2_encode(frame, 95)
    np.testing.assert_array_equal(imdecode(got), cv2_decode(got))
    rng = np.random.default_rng(1)
    for img in (textured(rng, 37, 53), textured(rng, 37, 53, 1), textured(rng, 1, 1)):
        for q in (10, 90):
            np.testing.assert_array_equal(imdecode(imencode(img, q)),
                                          cv2_decode(cv2_encode(img, q)))


def test_imwrite_refusals(tmp_path):
    img = np.zeros((8, 8, 3), np.uint8)
    imwrite(tmp_path / "a.JPEG", img, quality=50)
    assert (tmp_path / "a.JPEG").read_bytes() == cv2_encode(img, 50)
    for name in ("a.bmp", "noext"):
        with pytest.raises(ValueError, match="JPEG"):
            imwrite(tmp_path / name, img)
    with pytest.raises(ValueError, match="PNG"):
        imencode(img, ".bmp")
    for bad, what in ((img.astype(np.float32), "uint8"), (np.zeros((4, 4, 4), np.uint8), "BGR"),
                      (np.zeros((0, 4, 3), np.uint8), "size")):
        with pytest.raises(ValueError, match=what):
            imencode(bad)
    for q in (-1, 101, 9.5):
        with pytest.raises(ValueError, match="quality"):
            imencode(img, q)


@pytest.mark.parametrize("channels", [3, 1])
def test_png_writing_reads_back_and_equals_cv2(tmp_path, channels):
    """``imencode(img, ".png")`` and ``imwrite`` of a ``.png``: read back by
    ``cv2.imread`` and by the port's own PNG reader, the pixels are the
    input; the bytes are ``cv2.imencode('.png')``'s (cv2's default Sub
    filter, zlib level 1 with the run-length strategy, 8192-byte IDATs)."""
    rng = np.random.default_rng(channels)
    for h, w in ((1, 1), (1, 5), (5, 1), *SIZES, (1200, 1920)):
        for img in (textured(rng, h, w, channels), np.zeros((h, w, channels), np.uint8)):
            img = img.reshape(h, w, channels)[..., 0] if channels == 1 else img
            data = imencode(img, ".png")
            assert data == cv2.imencode(".png", img)[1].tobytes(), (h, w)
            want = img if channels == 3 else np.repeat(img[..., None], 3, -1)
            np.testing.assert_array_equal(imdecode(data), want)
            path = tmp_path / "frame.png"
            imwrite(path, img)
            assert path.read_bytes() == data
            np.testing.assert_array_equal(cv2.imread(str(path), cv2.IMREAD_UNCHANGED), img)
            np.testing.assert_array_equal(imread(path), want)
            assert image_size(path) == (h, w)


def tree(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_synthetic_argoverse_files_equal_jax(tmp_path):
    """The port's ``make_synthetic_argoverse`` (no cv2) against the JAX
    package's (``cv2.imwrite`` at quality 90): file for file, byte for
    byte, the annotation json included."""
    kw = dict(seq_lens=(3, 2), size=(300, 480), seed=3, splits=("val.json", "train.json"))
    jdbcode.make_synthetic_argoverse(str(tmp_path / "jax"), **kw)
    tdbcode.make_synthetic_argoverse(str(tmp_path / "port"), **kw)
    want, got = tree(tmp_path / "jax"), tree(tmp_path / "port")
    assert sorted(got) == sorted(want) and len(want) == 7
    assert all(got[k] == want[k] for k in want)


@pytest.mark.parametrize("draw_boxes", [False, True])
def test_imwrite_equals_write_fake_argoverse(tmp_path, monkeypatch, draw_boxes):
    """Each frame ``tests/conftest.py::write_fake_argoverse`` writes with
    ``cv2.imwrite`` (default quality 95), written again by the port."""
    frames = []
    real = cv2.imwrite

    def recording(path, img, *args):
        frames.append((path, img.copy()))
        return real(path, img, *args)

    monkeypatch.setattr(cv2, "imwrite", recording)
    conftest.write_fake_argoverse(tmp_path / "cv2", draw_boxes=draw_boxes)
    assert len(frames) == 7
    for path, img in frames:
        imwrite(tmp_path / "port.jpg", img)
        assert (tmp_path / "port.jpg").read_bytes() == Path(path).read_bytes(), path


# ---------------------------------------------------------------- PNG reading


def assert_reads_as_cv2(tmp_path, data: bytes, match: str = None):
    """``imdecode``, ``imread`` and ``image_size`` of ``data`` equal cv2's;
    where cv2 returns None, or where ``match`` names a refusal, they raise
    ``OSError`` (matching ``match``)."""
    want = cv2_decode(data)
    path = tmp_path / "img.png"
    path.write_bytes(data)
    if want is None or match is not None:
        with pytest.raises(OSError, match=match):
            imdecode(data)
        with pytest.raises(OSError, match="img.png"):
            imread(path)
        return
    np.testing.assert_array_equal(imdecode(data), want)
    np.testing.assert_array_equal(imread(path), want)
    assert image_size(path) == want.shape[:2]


@pytest.mark.parametrize("level", [0, 1, 9])
def test_cv2_written_png_equals_cv2(tmp_path, level):
    """Files cv2 writes (libpng's adaptive filters): gray, BGR, BGRA and
    16-bit gray / BGR / BGRA, at compression 0, 1 and 9."""
    rng = np.random.default_rng(level)
    for h, w in ((1, 1), (37, 53), (64, 80)):
        bgr = textured(rng, h, w)
        wide = (bgr.astype(np.uint16) * 257 + rng.integers(0, 257, bgr.shape)).astype(np.uint16)
        alpha = rng.integers(0, 256, (h, w, 1), np.uint8)
        for img in (bgr, bgr[..., 0], np.concatenate([bgr, alpha], -1), wide[..., 1], wide,
                    np.concatenate([wide, alpha.astype(np.uint16) * 257], -1)):
            ok, buf = cv2.imencode(".png", img, [cv2.IMWRITE_PNG_COMPRESSION, level])
            assert ok
            assert_reads_as_cv2(tmp_path, buf.tobytes())


def built_case(name: str) -> bytes:
    """A PNG built chunk by chunk: colour types, depths, palettes with tRNS,
    Adam7 and filters cv2's writer does not produce."""
    rng = np.random.default_rng(sum(map(ord, name)))
    kind, depth = name.split("_")[0], int(name.split("_")[1])
    interlace = "adam7" in name
    filters = (0, 1, 2, 3, 4) if "filters" in name else (4, 1)
    h, w = (1, 1) if "1x1" in name else ((5, 3) if "5x3" in name else (37, 53))
    top = (1 << depth) - 1
    if kind == "palette":
        n = 1 << depth if depth < 8 else 200
        palette = rng.integers(0, 256, 3 * n, np.uint8).tobytes()
        trns = rng.integers(0, 256, max(1, n // 2), np.uint8).tobytes()
        idx = rng.integers(0, n + (depth == 8) * 20, (h, w, 1))  # depth 8: past PLTE too
        return png_file(idx, depth, 3, interlace, filters, palette=palette, trns=trns)
    channels, color_type = {"gray": (1, 0), "grayalpha": (2, 4), "rgb": (3, 2),
                            "rgba": (4, 6)}[kind]
    samples = rng.integers(0, top + 1, (h, w, channels))
    trns = None
    if "trns" in name:  # one (gray) or three (RGB) 16-bit sample values
        vals = rng.integers(0, top + 1, 3 if kind == "rgb" else 1)
        trns = struct.pack(f">{len(vals)}H", *vals)
    return png_file(samples, depth, color_type, interlace, filters, trns=trns)


BUILT = ["palette_1_trns", "palette_2_trns", "palette_4_trns", "palette_8_trns",
         "gray_1", "gray_2", "gray_4", "gray_8_trns", "gray_16", "grayalpha_8", "grayalpha_16",
         "rgb_8_trns", "rgb_16", "rgba_8", "rgba_16",
         "gray_1_adam7", "gray_4_adam7_5x3", "palette_2_adam7_1x1", "rgb_16_adam7",
         "rgba_8_adam7", "grayalpha_8_adam7_5x3",
         "gray_1_filters", "gray_8_filters", "grayalpha_8_filters", "rgb_8_filters",
         "rgba_16_filters", "palette_4_adam7_filters"]


@pytest.mark.parametrize("name", BUILT)
def test_built_png_equals_cv2(tmp_path, name):
    assert_reads_as_cv2(tmp_path, built_case(name))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_png_exif_orientation_as_cv2(tmp_path, orientation):
    """cv2 applies a PNG's eXIf Orientation (before or after the data, in
    either byte order), and so do ``imdecode``, ``imread`` and
    ``image_size``; an eXIf chunk with a bad CRC is dropped."""
    samples = np.random.default_rng(orientation).integers(0, 256, (5, 3, 3))
    for big_endian in (False, True):
        tag = chunk(b"eXIf", exif(orientation, big_endian))
        assert_reads_as_cv2(tmp_path, png_file(samples, 8, 2, before=[tag]))
        assert_reads_as_cv2(tmp_path, png_file(samples, 8, 2, after=[tag]))
    bad = chunk(b"eXIf", exif(orientation), crc=1)
    assert_reads_as_cv2(tmp_path, png_file(samples, 8, 2, before=[bad]))


def damaged_png(case: str) -> bytes:
    samples = np.random.default_rng(0).integers(0, 256, (6, 7, 3))
    raw = raw_data(samples, 8, False, (0, 1, 2, 3, 4))
    good = png_file(samples, 8, 2, raw=raw)
    idat = good.index(b"IDAT")
    idat_len = int.from_bytes(good[idat - 4:idat], "big")
    text = chunk(b"tEXt", b"k\x00v")
    comp = zlib.compress(raw)
    split = [chunk(b"IDAT", comp[:9]), chunk(b"IDAT", comp[9:])]
    ihdr = good[8:33]
    end = chunk(b"IEND", b"")
    sig = good[:8]
    return {
        "ancillary chunk with a bad CRC": png_file(samples, 8, 2, raw=raw,
                                                   before=[chunk(b"tEXt", b"k\x00v", crc=7)]),
        "IDAT with a bad CRC": good[:idat + 4 + idat_len] + b"\x00\x00\x00\x00"
        + good[idat + 8 + idat_len:],
        "IHDR with a bad CRC": good[:29] + b"\x00\x00\x00\x00" + good[33:],
        "truncated IDAT": good[:idat + 4 + idat_len // 2],
        "no IEND": good[:-12],
        "bytes after IEND": good + b"trailing bytes",
        "truncated data stream": sig + ihdr + chunk(b"IDAT", comp[:-6]) + end,
        "corrupt data stream": sig + ihdr + chunk(b"IDAT", comp[:-1] + bytes([comp[-1] ^ 1]))
        + end,
        "image data too short": png_file(samples, 8, 2, raw=raw[:-3]),
        "image data too long": png_file(samples, 8, 2, raw=raw + bytes(9)),
        "bad filter type": png_file(samples, 8, 2, raw=bytes([5]) + raw[1:]),
        "IDAT in two chunks": sig + ihdr + b"".join(split) + end,
        "IDAT chunks apart": sig + ihdr + split[0] + text + split[1] + end,
        "unknown critical chunk": png_file(samples, 8, 2, raw=raw, before=[chunk(b"ABCD", b"")]),
        "unknown ancillary chunk": png_file(samples, 8, 2, raw=raw, before=[chunk(b"abCD", b"")]),
        "IHDR not first": sig + text + ihdr + split[0] + split[1] + end,
        "no IDAT": sig + ihdr + end,
        "palette without PLTE": png_file(samples[..., :1] % 4, 8, 3),
        "bit depth 3": sig + chunk(b"IHDR", ihdr[8:16] + bytes([3, 2, 0, 0, 0])) + split[0]
        + split[1] + end,
        "interlace method 2": sig + chunk(b"IHDR", ihdr[8:20] + bytes([2])) + split[0]
        + split[1] + end,
        "signature only": sig,
    }[case]


@pytest.mark.parametrize("case", [
    "ancillary chunk with a bad CRC", "IDAT with a bad CRC", "IHDR with a bad CRC",
    "truncated IDAT", "no IEND", "bytes after IEND", "truncated data stream",
    "corrupt data stream", "image data too short", "image data too long", "bad filter type",
    "IDAT in two chunks", "IDAT chunks apart", "unknown critical chunk",
    "unknown ancillary chunk", "IHDR not first", "no IDAT", "palette without PLTE",
    "bit depth 3", "interlace method 2", "signature only"])
def test_damaged_png_as_cv2_or_refused(tmp_path, case):
    """Where cv2 reads a damaged PNG the port gives the same image; where
    cv2 returns None the port raises ``OSError``."""
    assert_reads_as_cv2(tmp_path, damaged_png(case))


def test_animated_png_refused_by_name(tmp_path):
    samples = np.zeros((4, 4, 3), np.int64)
    actl = chunk(b"acTL", (1).to_bytes(4, "big") + (0).to_bytes(4, "big"))
    assert_reads_as_cv2(tmp_path, png_file(samples, 8, 2, before=[actl]), match="animated PNG")


def test_db_from_img_folder_over_png_equals_jax(tmp_path):
    """A folder of PNG sequences (cv2-written, built, one with an eXIf
    orientation that swaps its sides) beside JPEGs: the JAX package reads
    each with ``cv2.imread``, the port from its headers."""
    rng = np.random.default_rng(5)
    for seq, (h, w) in (("a", (20, 30)), ("b", (7, 11))):
        d = tmp_path / seq
        d.mkdir()
        for i in range(3):
            cv2.imwrite(str(d / f"{i:03d}.png"), textured(rng, h, w))
        (d / "003.png").write_bytes(png_file(rng.integers(0, 4, (h, w, 1)), 2, 0, True))
        (d / "004.PNG").write_bytes(png_file(rng.integers(0, 256, (h, w, 3)), 8, 2,
                                             before=[chunk(b"eXIf", exif(6))]))
        cv2.imwrite(str(d / "005.jpg"), textured(rng, h, w))
    want = jdbcode.db_from_img_folder(str(tmp_path))
    got = tdbcode.db_from_img_folder(str(tmp_path))
    assert got == want
    assert (got["images"][4]["height"], got["images"][4]["width"]) == (30, 20)


def test_committed_png_fixtures_decode_to_cv2_digests():
    """``tests/torch_jpeg/png`` (what ``chip_smoke.py``'s phase
    ``image_io`` reads on a host without cv2): cv2's digests, and the
    port's decode of each file equal to them."""
    digests = json.loads((FIXTURES / "digests.json").read_text())["png"]
    pngs = sorted(p.relative_to(FIXTURES).as_posix() for p in FIXTURES.glob("png/*.png"))
    assert pngs == sorted(digests) and len(pngs) == 7
    for rel in pngs:
        for img in (cv2.imread(str(FIXTURES / rel)), imread(FIXTURES / rel)):
            assert list(img.shape) == digests[rel]["shape"]
            assert hashlib.sha256(img.tobytes()).hexdigest() == digests[rel]["sha256"], rel
