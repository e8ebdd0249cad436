"""The port's reading of progressive and multi-scan JPEGs without cv2
(``streamyolo_torch/data/image_io.py`` over ``native/image_io.cpp``)
against cv2 5.x and the JAX package, on the CPU. Everything is compared for
equality; there is no tolerance.

  * ``imdecode`` equals ``cv2.imdecode(buf, IMREAD_COLOR)`` for cv2's
    progressive files (its 10-scan script: DC first, AC first, DC and AC
    refinement) at qualities 5 / 50 / 90 / 100 in each sampling factor,
    plain, with optimised tables and with a restart interval, and
    ``image_size`` equals the shape cv2 reads;
  * a progressive file cut after each of its scans (EOI kept) decodes to
    cv2's block-smoothed image; a complete one to the baseline file's
    image at the same quality and sampling (it does not smooth);
  * files of ``tests/torch_jpeg_scans.py`` (scan scripts cv2 never writes:
    sequential non-interleaved scans, DC scans of part of the components,
    AC bands split anywhere or left out, EOB runs across restart
    intervals) decode as cv2 decodes them;
  * parameters libjpeg refuses (``JERR_BAD_PROGRESSION``, an undefined
    table, a component not in the frame) raise ``OSError`` where cv2
    returns None, those it only warns about decode as cv2 decodes them,
    and the formats still not read are refused by name;
  * the committed progressive fixtures (``tests/torch_jpeg/progressive``)
    hold cv2's digests, the 1200x1920 frames those of the baseline frames;
    the port's ``db_from_img_folder`` + ``imread`` over a folder of
    progressive frames equal the JAX package's (cv2).
"""

import json
import struct
from pathlib import Path

import numpy as np
import pytest

from streamyolo_tpu.data import dbcode as jdbcode
from streamyolo_torch.data import dbcode as tdbcode
from streamyolo_torch.data.image_io import image_size, imdecode, imread
from tests.torch_jpeg_scans import random_coefficients, write_jpeg

cv2 = pytest.importorskip("cv2")

FIXTURES = Path(__file__).resolve().parent / "torch_jpeg"
SAMPLINGS = {"411": 0x411111, "420": 0x221111, "422": 0x211111, "440": 0x121111,
             "444": 0x111111}
VARIANTS = {"plain": [], "optimised": [cv2.IMWRITE_JPEG_OPTIMIZE, 1],
            "restart": [cv2.IMWRITE_JPEG_RST_INTERVAL, 2]}
SIZES = ((1, 1), (17, 9), (9, 17), (37, 53), (120, 161))
# (h, v) per component of the scan writer's files
WRITER_SAMPLINGS = {"420": [(2, 2), (1, 1), (1, 1)], "411": [(4, 1), (1, 1), (1, 1)],
                    "422": [(2, 1), (1, 1), (1, 1)], "440": [(1, 2), (1, 1), (1, 1)],
                    "444": [(1, 1)] * 3, "gray": [(1, 1)]}


def textured(rng, h, w):
    """Gradients, a hard colour edge and noise: every block has AC energy."""
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 7 + y * 3, x * 2 + y * 5 + 40, (x - y) * 4], -1) % 256
    img[h // 3:, w // 2:] = (30, 220, 250)
    return np.clip(img + rng.integers(-25, 26, (h, w, 3)), 0, 255).astype(np.uint8)


def encode(img, quality, sampling=None, extra=(), progressive=True) -> bytes:
    flags = [cv2.IMWRITE_JPEG_QUALITY, quality, *extra]
    if progressive:
        flags += [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    if sampling is not None:
        flags += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling]
    ok, buf = cv2.imencode(".jpg", img, flags)
    assert ok
    return buf.tobytes()


def cv2_decode(buf: bytes):
    return cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)


def segments(buf: bytes):
    """(offset, marker, end of its payload) of each segment up to EOI; an
    SOS's end is the end of its entropy-coded data."""
    out, p = [], 2
    while buf[p + 1] != 0xD9:
        marker = buf[p + 1]
        end = p + 2 + struct.unpack(">H", buf[p + 2:p + 4])[0]
        if marker == 0xDA:
            while not (buf[end] == 0xFF and buf[end + 1] != 0 and not 0xD0 <= buf[end + 1] <= 0xD7):
                end += 1
        out.append((p, marker, end))
        p = end
    return out


def scan_ends(buf: bytes):
    return [end for _, marker, end in segments(buf) if marker == 0xDA]


def assert_reads_as_cv2(buf: bytes, tmp_path=None, what=""):
    want = cv2_decode(buf)
    assert want is not None, what
    got = imdecode(buf)
    assert got.dtype == np.uint8 and got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)
    if tmp_path is not None:
        path = tmp_path / "frame.jpg"
        path.write_bytes(buf)
        assert image_size(path) == want.shape[:2], what


# ---------------------------------------------------------------- cv2's files


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("quality", [5, 50, 90, 100])
@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
def test_progressive_equals_cv2(tmp_path, sampling, quality, variant):
    """Every size, on a textured image and on uniform noise; and gray."""
    rng = np.random.default_rng(quality)
    for h, w in SIZES:
        for img in (textured(rng, h, w), rng.integers(0, 256, (h, w, 3), np.uint8)):
            buf = encode(img, quality, SAMPLINGS[sampling], VARIANTS[variant])
            assert buf[2:].find(b"\xff\xc2") >= 0
            assert_reads_as_cv2(buf, tmp_path, f"{h}x{w}")
        gray = encode(cv2.cvtColor(img, cv2.COLOR_BGR2GRAY), quality, None, VARIANTS[variant])
        assert_reads_as_cv2(gray, tmp_path, f"gray {h}x{w}")


@pytest.mark.parametrize("sampling", [*sorted(SAMPLINGS), "gray"])
def test_incomplete_progressive_as_cv2(sampling):
    """cv2's script cut after scan k = 1 .. n-1, EOI kept: libjpeg's block
    smoothing (the 5x5 DC estimates of ``decompress_smooth_data``) at each
    point. Complete, the file equals the baseline file of the same quality
    and sampling: its coefficients are final, so nothing is smoothed."""
    rng = np.random.default_rng(7)
    for h, w in ((17, 9), (9, 17), (37, 53), (120, 161)):
        img = textured(rng, h, w)
        sf = SAMPLINGS.get(sampling)
        if sf is None:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        for extra in ([], VARIANTS["restart"]):
            buf = encode(img, 90, sf, extra)
            ends = scan_ends(buf)
            assert len(ends) == (10 if sf else 6)
            for k, end in enumerate(ends[:-1], 1):
                assert_reads_as_cv2(buf[:end] + b"\xff\xd9", what=f"{h}x{w} {k} scans")
            np.testing.assert_array_equal(
                imdecode(buf), cv2_decode(encode(img, 90, sf, extra, progressive=False)))


# ---------------------------------------------------------------- other scan scripts


def writer_scripts(ncomp: int) -> dict:
    """(progressive, [(components, Ss, Se), ...]) by name."""
    if ncomp == 1:
        return {"sequential": (False, [([0], 0, 63)]),
                "dc_then_bands": (True, [([0], 0, 0), ([0], 1, 5), ([0], 6, 63)]),
                "bands_left_out": (True, [([0], 0, 0), ([0], 1, 2)])}
    return {
        "sequential_each": (False, [([2], 0, 63), ([0], 0, 63), ([1], 0, 63)]),
        "sequential_y_then_cbcr": (False, [([0], 0, 63), ([1, 2], 0, 63)]),
        "sequential_cr_cb": (False, [([0], 0, 63), ([2, 1], 0, 63)]),
        "spectral": (True, [([0, 1, 2], 0, 0), ([0], 1, 5), ([2], 1, 63), ([1], 1, 20),
                            ([0], 6, 63), ([1], 21, 63)]),
        "dc_split": (True, [([0], 0, 0), ([1, 2], 0, 0), ([0], 1, 63), ([1], 1, 63),
                            ([2], 1, 63)]),
        "one_coefficient_bands": (True, [([0, 1, 2], 0, 0)]
                                  + [([c], k, k) for c in range(3) for k in range(1, 64)]),
        "bands_left_out": (True, [([0, 1, 2], 0, 0), ([0], 1, 9), ([2], 1, 3)]),
    }


@pytest.mark.parametrize("sampling", sorted(WRITER_SAMPLINGS))
def test_scan_scripts_equal_cv2(tmp_path, sampling):
    """Random coefficients in sequential multi-scan and spectral-selection
    progressive scripts, with and without a restart interval of 3 MCUs,
    at odd sizes (dummy blocks in the interleaved scans, none in the
    others)."""
    rng = np.random.default_rng(len(sampling))
    samp = WRITER_SAMPLINGS[sampling]
    for h, w in SIZES[:4]:
        coefs = random_coefficients(rng, h, w, samp)
        quant = [rng.integers(1, 9, 64) for _ in samp]
        for name, (progressive, script) in writer_scripts(len(samp)).items():
            for restart in (0, 3):
                buf = write_jpeg(coefs, h, w, samp, quant, script, progressive, restart)
                assert_reads_as_cv2(buf, tmp_path, f"{h}x{w} {name} restart {restart}")


def test_long_eob_runs_across_restarts():
    """Mostly empty blocks: EOB runs of hundreds of blocks, cut at each
    restart marker, one ending exactly at one."""
    rng = np.random.default_rng(3)
    samp = WRITER_SAMPLINGS["444"]
    coefs = random_coefficients(rng, 120, 161, samp, empty_share=0.97)
    quant = [rng.integers(1, 9, 64) for _ in samp]
    script = [([0, 1, 2], 0, 0), ([0], 1, 63), ([1], 1, 10), ([2], 1, 63)]
    for restart in (0, 7, 21 * 15):
        assert_reads_as_cv2(write_jpeg(coefs, 120, 161, samp, quant, script, True, restart),
                            what=f"restart {restart}")


# ---------------------------------------------------------------- refusals


def with_scan_header(buf: bytes, scan: int, edit) -> bytes:
    """``buf`` with the header of its ``scan``-th SOS replaced by
    ``edit(ns, [(id, tables)], ss, se, ah, al)``'s bytes."""
    sos = [(p, end) for p, marker, end in segments(buf) if marker == 0xDA][scan]
    p = sos[0]
    length = struct.unpack(">H", buf[p + 2:p + 4])[0]
    body = buf[p + 4:p + 2 + length]
    ns = body[0]
    comps = [(body[1 + 2 * i], body[2 + 2 * i]) for i in range(ns)]
    ss, se, a = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns]
    new = edit(ns, comps, ss, se, a >> 4, a & 15)
    return buf[:p] + b"\xff\xda" + struct.pack(">H", len(new) + 2) + new + buf[p + 2 + length:]


def sos_bytes(comps, ss, se, ah, al) -> bytes:
    return bytes([len(comps), *[b for c in comps for b in c], ss, se, (ah << 4) | al])


BAD_SCANS = {
    # (scan index of cv2's 10-scan script, edit, what the error names)
    "Ss > Se": (1, lambda ns, c, ss, se, ah, al: sos_bytes(c, 5, 3, ah, al), "progression"),
    "Se > 63": (2, lambda ns, c, ss, se, ah, al: sos_bytes(c, 1, 64, ah, al), "progression"),
    "DC scan with Se 5": (0, lambda ns, c, ss, se, ah, al: sos_bytes(c, 0, 5, ah, al),
                          "progression"),
    "AC scan of 3 components": (
        0, lambda ns, c, ss, se, ah, al: sos_bytes(c, 1, 5, 0, 0), "progression"),
    "Al 14": (1, lambda ns, c, ss, se, ah, al: sos_bytes(c, ss, se, 0, 14), "progression"),
    "Ah 2 with Al 0": (5, lambda ns, c, ss, se, ah, al: sos_bytes(c, ss, se, 2, 0),
                       "progression"),
    "undefined table": (1, lambda ns, c, ss, se, ah, al: sos_bytes(
        [(c[0][0], 0x33)], ss, se, ah, al), "Huffman table 3 not defined"),
    "component not in the frame": (2, lambda ns, c, ss, se, ah, al: sos_bytes(
        [(9, c[0][1])], ss, se, ah, al), "not in the frame"),
}


@pytest.mark.parametrize("case", sorted(BAD_SCANS))
def test_bad_scans_refused_as_cv2(case):
    """Where libjpeg raises an error (cv2 returns None), ``imdecode``
    raises ``OSError`` naming it."""
    buf = encode(textured(np.random.default_rng(0), 37, 53), 90, SAMPLINGS["420"])
    scan, edit, reason = BAD_SCANS[case]
    data = with_scan_header(buf, scan, edit)
    assert cv2_decode(data) is None
    with pytest.raises(OSError, match=reason):
        imdecode(data)


def test_bogus_progression_reads_as_cv2():
    """libjpeg only warns (``JWRN_BOGUS_PROGRESSION``) for a DC scan read
    twice, an AC scan before any DC scan, or a refinement of bits never
    sent: cv2 returns an image, and so does the port, the same."""
    buf = encode(textured(np.random.default_rng(1), 37, 53), 90, SAMPLINGS["420"])
    segs = segments(buf)
    sos = [i for i, (_, marker, _) in enumerate(segs) if marker == 0xDA]
    sof = next(i for i, (_, marker, _) in enumerate(segs) if marker == 0xC2)
    # each scan with the DHT segments before it
    starts = [segs[(sos[k - 1] if k else sof) + 1][0] for k in range(len(sos))]
    pieces = [buf[starts[k]:segs[sos[k]][2]] for k in range(len(sos))]
    head, tail = buf[:starts[0]], b"\xff\xd9"
    cases = {"DC twice": [pieces[0], *pieces],
             "AC before DC": [pieces[2], pieces[0], pieces[1], *pieces[3:]],
             "refinement first": [pieces[0], pieces[5], *pieces[1:5], *pieces[6:]]}
    for name, order in cases.items():
        assert_reads_as_cv2(head + b"".join(order) + tail, what=name)


def with_frame_header(buf: bytes, marker: int, precision: int = 8, ncomp=None) -> bytes:
    p = next(p for p, m, _ in segments(buf) if 0xC0 <= m <= 0xC2)
    out = bytearray(buf)
    out[p + 1] = marker
    out[p + 4] = precision
    if ncomp is not None:
        out[p + 9] = ncomp
    return bytes(out)


# the cases keep the ids they were first collected under, when arithmetic
# coding, lossless frames and four components were refused whole
@pytest.mark.parametrize("case,marker,precision,ncomp,reason", [
    ("arithmetic SOF9", 0xC9, 12, None, "12-bit precision"),
    ("arithmetic SOF10", 0xCA, 12, None, "12-bit precision"),
    ("lossless SOF3", 0xC3, 8, None, "lossless YCbCr JPEG"),
    ("hierarchical SOF5", 0xC5, 8, None, "hierarchical JPEG \\(SOF5\\)"),
    ("12-bit", 0xC2, 12, None, "12-bit precision"),
    ("CMYK", 0xC2, 8, 4, "short SOF segment"),
], ids=[r"arithmetic SOF9-201-8-None-arithmetic-coded JPEG \(SOF9\)",
        r"arithmetic SOF10-202-8-None-arithmetic-coded JPEG \(SOF10\)",
        r"lossless SOF3-195-8-None-lossless JPEG \(SOF3\)",
        r"hierarchical SOF5-197-8-None-hierarchical JPEG \(SOF5\)",
        "12-bit-194-12-None-12-bit precision", "CMYK-194-8-4-4-component"])
def test_formats_still_refused(case, marker, precision, ncomp, reason):
    """Frame types and sample formats outside the decoder, on a progressive
    file's header (12-bit arithmetic-coded frames, a lossless frame of
    JFIF's YCbCr, which libjpeg does not convert in lossless mode, four
    components declared over three components' header): cv2 returns None,
    ``imdecode`` raises ``OSError`` naming the reason."""
    buf = encode(textured(np.random.default_rng(2), 16, 16), 90, SAMPLINGS["444"])
    data = with_frame_header(buf, marker, precision, ncomp)
    assert cv2_decode(data) is None
    with pytest.raises(OSError, match=reason):
        imdecode(data)


# ---------------------------------------------------------------- fixtures and the JAX package


def digest(arr) -> dict:
    import hashlib

    arr = np.ascontiguousarray(arr)
    return {"shape": list(arr.shape), "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}


def test_progressive_fixtures_hold_cv2s_digests():
    """The committed progressive and multi-scan fixtures are in
    ``digests.json`` (cv2's reading, held for every fixture by
    ``test_fixture_digests_are_cv2s``); the three progressive 1200x1920
    frames read to the baseline frames' digests, since cv2 encoded the same
    pixels at the same quality."""
    with open(FIXTURES / "digests.json") as f:
        digests = json.load(f)["decode"]
    files = sorted(p.relative_to(FIXTURES).as_posix()
                   for p in (FIXTURES / "progressive").glob("**/*.jpg"))
    assert files and set(files) <= set(digests)
    frames = [f for f in files if f.startswith("progressive/frames/")]
    assert len(frames) == 3
    for rel in frames:
        baseline = rel[len("progressive/"):]
        assert digests[rel] == digests[baseline], rel
        assert (FIXTURES / rel).read_bytes()[2:].find(b"\xff\xc2") >= 0
        assert digest(imread(FIXTURES / rel)) == digests[baseline], rel


def test_folder_of_progressive_frames_equals_the_jax_package(tmp_path):
    """A folder of progressive frames (two sequences): the JAX package's
    ``db_from_img_folder`` and its frame read (``cv2.imread``) against the
    port's ``db_from_img_folder`` and ``imread``."""
    synth = tdbcode.SyntheticArgoverse(seq_lens=(2, 2), size=(120, 192), seed=4)
    root = tmp_path / "frames"
    for img in synth.data["images"]:
        d = root / synth.data["seq_dirs"][img["sid"]]
        d.mkdir(parents=True, exist_ok=True)
        sf = (SAMPLINGS["420"], SAMPLINGS["444"])[img["sid"]]
        (d / img["name"]).write_bytes(encode(synth.frame(img), 90, sf))
    want = jdbcode.db_from_img_folder(str(root))
    got = tdbcode.db_from_img_folder(str(root))
    assert got == want and len(got["images"]) == 4
    for im in got["images"]:
        path = root / got["seq_dirs"][im["sid"]] / im["name"]
        np.testing.assert_array_equal(imread(path), cv2.imread(str(path)))
