"""The port's reading of the JPEG codings and colour models that libjpeg's
default compression never writes (``streamyolo_torch/data/image_io.py``
over ``native/image_io.cpp``), against cv2 5.x and the JAX package, on the
CPU. Everything is compared for equality; there is no tolerance.

  * arithmetic coding (``tests/torch_jpeg_codings.py``): sequential (SOF9)
    and progressive (SOF10, successive approximation included) scripts in
    each sampling factor and gray, with a DAC segment's conditioning, a
    restart interval, table slots shared or not, and progressive files cut
    after each scan (libjpeg's block smoothing): ``imdecode`` equals
    ``cv2.imdecode``, and a complete file the Huffman-coded file of the same
    coefficients; cv2's own files transcoded keep their pixels;
  * lossless frames (SOF3): predictors 1-7, point transforms, restart
    intervals, sampling factors (replicated, not fancy, upsampling),
    precisions 2-8, samples outside the precision, RGB-coded and CMYK, one
    interleaved scan or one scan a component;
  * colour models: CMYK and YCCK (Adobe transforms 0, 2 and the others, no
    Adobe segment), RGB-coded (Adobe transform 0, ids 'R', 'G', 'B'), a
    JFIF segment beside them, in each sampling factor, Huffman and
    arithmetic; PIL's CMYK and RGB files;
  * the kinds cv2 returns None for (12-bit frames, lossless arithmetic,
    hierarchical frames, lossless gray, YCbCr and YCCK, lossless precisions
    outside 2-8, 2 and 5 components, bad DAC segments): ``imdecode``
    raises ``OSError`` naming them;
  * the committed fixtures of ``tests/torch_jpeg/codings`` hold cv2's
    digests, and the arithmetic transcodes of the three 1200x1920 frames
    the baseline frames' pixels; the JAX package's dataset reader
    (``cv2.imread``) and the port's over a folder of them;
  * ``vis_det``, ``vis_track`` and ``tools/vis_results.py`` write
    ``cv2.imwrite``'s bytes for ``.jpg`` and ``.png`` names and refuse any
    other extension.
"""

import hashlib
import io
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from streamyolo_tpu.data import datasets as jdatasets
from streamyolo_tpu.data import dbcode as jdbcode
from streamyolo_torch import vis as tvis
from streamyolo_torch.data import datasets as tdatasets
from streamyolo_torch.data.image_io import image_size, imdecode, imread
from tests.torch_jpeg_codings import (SIMPLE_PROGRESSION_1, SIMPLE_PROGRESSION_3,
                                      four_component_frame, read_coefficients, write_arith,
                                      write_lossless)
from tests.torch_jpeg_scans import random_coefficients, segment, write_jpeg

cv2 = pytest.importorskip("cv2")

FIXTURES = Path(__file__).resolve().parent / "torch_jpeg"
# (h, v) of the first, the middle two and the fourth component
SAMPLINGS = {"420": ((2, 2), (1, 1)), "411": ((4, 1), (1, 1)), "422": ((2, 1), (1, 1)),
             "440": ((1, 2), (1, 1)), "444": ((1, 1), (1, 1)), "h1v2": ((1, 1), (1, 2))}
SIZES = ((1, 1), (17, 9), (9, 17), (37, 53))
JFIF = segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
DAC = {("dc", 0): (2, 5), ("dc", 1): (0, 0), ("ac", 0): 12, ("ac", 1): 1}


def sampling_of(name: str, ncomp: int):
    first, middle = SAMPLINGS[name]
    return {1: [(1, 1)], 3: [first, middle, middle], 4: [first, middle, middle, first]}[ncomp]


def cv2_decode(buf: bytes):
    return cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)


def assert_reads_as_cv2(buf: bytes, what: str = "", want=None):
    """``imdecode`` equals cv2's image of ``buf`` (and ``want`` where given)."""
    got_cv2 = cv2_decode(buf)
    assert got_cv2 is not None, what
    if want is not None:
        np.testing.assert_array_equal(got_cv2, want, err_msg=f"cv2: {what}")
    got = imdecode(buf)
    assert got.dtype == np.uint8 and got.shape == got_cv2.shape, what
    np.testing.assert_array_equal(got, got_cv2, err_msg=what)


def quant_tables(rng, n):
    return [rng.integers(1, 9, 64) for _ in range(n)]


def scan_ends(buf: bytes):
    """The end of each scan's entropy-coded data."""
    out, p = [], 2
    while buf[p + 1] != 0xD9:
        marker = buf[p + 1]
        end = p + 2 + int.from_bytes(buf[p + 2:p + 4], "big")
        if marker == 0xDA:
            while not (buf[end] == 0xFF and buf[end + 1] != 0 and not 0xD0 <= buf[end + 1] <= 0xD7):
                end += 1
            out.append(end)
        p = end
    return out


# ---------------------------------------------------------------- arithmetic coding


def arith_scripts(ncomp: int) -> dict:
    """(progressive, [(components, Ss, Se, Ah, Al), ...]) by name."""
    if ncomp == 1:
        return {"sequential": (False, [([0], 0, 63, 0, 0)]),
                "progression": (True, SIMPLE_PROGRESSION_1)}
    return {"sequential": (False, [([0, 1, 2], 0, 63, 0, 0)]),
            "sequential_each": (False, [([2], 0, 63, 0, 0), ([0], 0, 63, 0, 0),
                                        ([1], 0, 63, 0, 0)]),
            "progression": (True, SIMPLE_PROGRESSION_3),
            "spectral": (True, [([0], 0, 0, 0, 0), ([1, 2], 0, 0, 0, 0), ([0], 1, 9, 0, 0),
                                ([2], 1, 63, 0, 0), ([1], 1, 63, 0, 0), ([0], 10, 63, 0, 0)])}


@pytest.mark.parametrize("sampling", [*sorted(SAMPLINGS), "gray"])
def test_arithmetic_equals_cv2(sampling):
    """Random coefficients in each script, with and without a restart
    interval of 2 MCUs and a DAC segment (DC conditioning L, U other than 0,
    1, AC Kx other than 5), each component's statistics of its own slot or
    libjpeg's (Y 0, chroma 1): cv2's image, and the Huffman-coded file's of
    the same coefficients."""
    ncomp = 1 if sampling == "gray" else 3
    samp = sampling_of("444" if sampling == "gray" else sampling, ncomp)
    rng = np.random.default_rng(len(sampling) + 11)
    for h, w in SIZES:
        coefs = random_coefficients(rng, h, w, samp)
        quant = quant_tables(rng, ncomp)
        want = cv2_decode(write_jpeg(coefs, h, w, samp, quant, [(list(range(ncomp)), 0, 63)],
                                     False))
        for name, (progressive, script) in arith_scripts(ncomp).items():
            for restart, dac, tables in ((0, None, None), (2, DAC, None),
                                         (0, DAC, list(range(ncomp))), (1, None, None)):
                buf = write_arith(coefs, h, w, samp, quant, script, progressive, restart, dac,
                                  tables)
                assert_reads_as_cv2(buf, f"{h}x{w} {name} restart {restart} dac {bool(dac)}",
                                    want)


@pytest.mark.parametrize("sampling", ["420", "422", "gray"])
def test_incomplete_arithmetic_progression_as_cv2(sampling):
    """libjpeg's progression cut after each scan, EOI kept: block
    smoothing over the arithmetic-coded coefficients, as cv2 smooths."""
    ncomp = 1 if sampling == "gray" else 3
    samp = sampling_of("444" if sampling == "gray" else sampling, ncomp)
    rng = np.random.default_rng(5)
    script = SIMPLE_PROGRESSION_1 if ncomp == 1 else SIMPLE_PROGRESSION_3
    for h, w in ((17, 9), (37, 53)):
        coefs = random_coefficients(rng, h, w, samp)
        buf = write_arith(coefs, h, w, samp, quant_tables(rng, ncomp), script, True, 3)
        for k, end in enumerate(scan_ends(buf)[:-1], 1):
            assert_reads_as_cv2(buf[:end] + b"\xff\xd9", f"{h}x{w} {k} scans")


def test_cv2_files_transcoded_to_arithmetic():
    """The coefficients of cv2's files (every sampling, gray, a restart
    interval, optimised tables) recoded arithmetically, sequential and
    progressive: the pixels of the Huffman-coded file."""
    for path in sorted((FIXTURES / "small").glob("*.jpg")):
        if path.name.startswith(("exif", "no_dht")):  # copies of s420_37x53's coefficients
            continue
        buf = path.read_bytes()
        h, w, samp, quant, coefs = read_coefficients(buf)
        want = cv2_decode(buf)
        scripts = arith_scripts(len(samp))
        for name in ("sequential", "progression"):
            progressive, script = scripts[name]
            assert_reads_as_cv2(write_arith(coefs, h, w, samp, quant, script, progressive),
                                f"{path.name} {name}", want)


# ---------------------------------------------------------------- lossless


def planes_at(img_planes, height, width, samp):
    """Each plane decimated to its component's size."""
    hmax, vmax = max(h for h, _ in samp), max(v for _, v in samp)
    out = []
    for p, (h, v) in zip(img_planes, samp):
        ch, cw = -(-height * v // vmax), -(-width * h // hmax)
        out.append(np.asarray(p)[::vmax // v, ::hmax // h][:ch, :cw])
    return out


def crop(h=37, w=53):
    frame = cv2.imread(str(FIXTURES / "frames" / "seq00" / "000000.jpg"))
    return frame[560:560 + h, 880:880 + w].astype(np.int64)


@pytest.mark.parametrize("psv", range(1, 8))
def test_lossless_equals_cv2(psv):
    """Predictor ``psv`` on RGB planes in each sampling (replicated
    upsampling), with point transforms 0 and 3, restart intervals of 0, 1
    and 2 MCU rows, one interleaved scan or one scan a component; CMYK; the
    precisions 2 and 5."""
    img = crop()
    rgb = [img[..., 2], img[..., 1], img[..., 0]]
    cmyk = [*rgb, 255 - img[..., 1]]
    for name in sorted(SAMPLINGS):
        for ids, adobe in ((None, None), ([82, 71, 66], None), (None, 0)):
            samp = sampling_of(name, 3)
            planes = planes_at(rgb, 37, 53, samp)
            for pt, restart_rows, scans in ((0, 0, None), (3, 2, None), (1, 1, [[2], [0], [1]])):
                buf = write_lossless(planes, 37, 53, samp, 8, psv, pt, restart_rows, ids, adobe,
                                     scans)
                assert_reads_as_cv2(buf, f"{name} ids {ids} Pt {pt} restart {restart_rows}")
        samp = sampling_of(name, 4)
        assert_reads_as_cv2(write_lossless(planes_at(cmyk, 37, 53, samp), 37, 53, samp, 8, psv,
                                           restart_rows=2, adobe=0), f"CMYK {name}")
    for precision in (2, 5):
        planes = [p >> (8 - precision) for p in rgb]
        assert_reads_as_cv2(write_lossless(planes, 37, 53, [(1, 1)] * 3, precision, psv,
                                           pt=precision // 2),
                            f"precision {precision}", np.stack(planes[::-1], -1) >> (
                                precision // 2) << (precision // 2))


def test_lossless_samples_outside_the_precision_as_cv2():
    """Differences that carry a sample past the precision (mod 2^16): cv2
    keeps the sample's low 8 bits, and predicts on from the whole value."""
    img = crop()
    rgb = [img[..., 2].copy(), img[..., 1].copy(), img[..., 0].copy()]
    rgb[0][5, 5], rgb[1][6, 6], rgb[2][7, 7], rgb[2][0, 0] = 300, 1000, -5, 40000
    for psv in (1, 4, 7):
        assert_reads_as_cv2(write_lossless(rgb, 37, 53, [(1, 1)] * 3, 8, psv), f"psv {psv}")
    low = [p >> 1 for p in crop().transpose(2, 0, 1)[::-1]]
    low[0][3, 4] = 200  # above 7 bits
    assert_reads_as_cv2(write_lossless(low, 37, 53, [(1, 1)] * 3, 7, 2), "precision 7")


# ---------------------------------------------------------------- colour models


def colour_cases():
    """(ncomp, Adobe transform, ids, JFIF) by name."""
    return {"cmyk_adobe0": (4, 0, None, False), "cmyk_no_adobe": (4, None, None, False),
            "ycck_adobe2": (4, 2, None, False), "cmyk_adobe1_as_ycck": (4, 1, None, False),
            "cmyk_adobe5_as_ycck": (4, 5, None, False), "rgb_adobe0": (3, 0, None, False),
            "rgb_ids": (3, None, [82, 71, 66], False), "jfif_over_adobe0": (3, 0, None, True),
            "jfif_over_rgb_ids": (3, None, [82, 71, 66], True),
            "ycc_adobe2": (3, 2, None, False), "ycc_adobe5": (3, 5, None, False),
            "ycc_other_ids": (3, None, [0, 1, 2], False)}


@pytest.mark.parametrize("case", sorted(colour_cases()))
def test_colour_models_equal_cv2(case):
    """Random coefficients (so every colour conversion clamps somewhere),
    Huffman sequential, arithmetic sequential and Huffman progressive, in
    each sampling factor and size."""
    ncomp, adobe, ids, jfif = colour_cases()[case]
    rng = np.random.default_rng(len(case))
    for name in sorted(SAMPLINGS):
        samp = sampling_of(name, ncomp)
        if sum(h * v for h, v in samp) > 10:  # libjpeg's limit of blocks an MCU
            continue
        for h, w in SIZES:
            coefs = random_coefficients(rng, h, w, samp, dc_range=120)
            quant = quant_tables(rng, ncomp)
            comps = list(range(ncomp))
            for buf in (write_jpeg(coefs, h, w, samp, quant, [(comps, 0, 63)], False, ids=ids,
                                   adobe=adobe),
                        write_arith(coefs, h, w, samp, quant, [(comps, 0, 63, 0, 0)], False,
                                    ids=ids, adobe=adobe),
                        write_jpeg(coefs, h, w, samp, quant, [(comps, 0, 0)] + [
                            ([c], 1, 63) for c in comps], True, ids=ids, adobe=adobe)):
                if jfif:
                    buf = buf[:2] + JFIF + buf[2:]
                assert_reads_as_cv2(buf, f"{name} {h}x{w}")


@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_pil_cmyk_and_rgb_files_equal_cv2(subsampling):
    """Files as PIL writes them: ``convert('CMYK')`` (Adobe transform 0,
    Photoshop's inverted CMYK; PIL's ``subsampling`` samples the first
    component 1x1, 2x1 or 2x2) and ``keep_rgb=True`` (Adobe transform 0,
    ids 'R', 'G', 'B'), at qualities 50 and 95."""
    Image = pytest.importorskip("PIL.Image")
    img = Image.fromarray(crop(120, 161)[..., ::-1].astype(np.uint8))
    for quality in (50, 95):
        for im, extra in ((img.convert("CMYK"), {}), (img, {"keep_rgb": True})):
            if extra and subsampling:  # PIL subsamples no RGB-coded file
                continue
            out = io.BytesIO()
            im.save(out, "JPEG", quality=quality, subsampling=subsampling, **extra)
            assert_reads_as_cv2(out.getvalue(), f"{im.mode} q{quality}")


# ---------------------------------------------------------------- refusals


def _refused():
    """name -> (bytes cv2 returns None for, what the error names)."""
    rng = np.random.default_rng(9)
    s420 = sampling_of("420", 3)
    coefs = random_coefficients(rng, 17, 9, s420)
    quant = quant_tables(rng, 3)
    wide = random_coefficients(rng, 17, 9, s420, dc_range=900, ac_scale=300, ac_limit=1500)
    img = crop(17, 9)
    rgb = [img[..., 2], img[..., 1], img[..., 0]]
    seq = [([0, 1, 2], 0, 63)]
    base = write_jpeg(coefs, 17, 9, s420, quant, seq, False)

    def frame_marker(buf, marker):
        p = buf.index(b"\xff\xc0") if b"\xff\xc0" in buf else buf.index(b"\xff\xc3")
        return buf[:p + 1] + bytes([marker]) + buf[p + 2:]

    def dac(buf, body):
        p = buf.index(b"\xff\xda")
        return buf[:p] + segment(0xCC, body) + buf[p:]

    cases = {
        "12-bit SOF1": (write_jpeg(wide, 17, 9, s420, quant, seq, False, precision=12),
                        "12-bit precision"),
        "12-bit SOF2": (write_jpeg(wide, 17, 9, s420, quant, [([0, 1, 2], 0, 0), ([0], 1, 63),
                                                              ([1], 1, 63), ([2], 1, 63)], True,
                                   precision=12), "12-bit precision"),
        "12-bit SOF9": (write_arith(wide, 17, 9, s420, quant, [([0, 1, 2], 0, 63, 0, 0)], False,
                                    precision=12), "12-bit precision"),
        "lossless arithmetic SOF11": (frame_marker(write_lossless(rgb, 17, 9, [(1, 1)] * 3, 8, 1),
                                                   0xCB), "lossless arithmetic-coded JPEG"),
        "lossless gray": (write_lossless([rgb[1]], 17, 9, [(1, 1)], 8, 1), "lossless grayscale"),
        "lossless JFIF": ((lambda b: b[:2] + JFIF + b[2:])(
            write_lossless(rgb, 17, 9, [(1, 1)] * 3, 8, 1)), "lossless YCbCr"),
        "lossless Adobe 1": (write_lossless(rgb, 17, 9, [(1, 1)] * 3, 8, 1, adobe=1),
                             "lossless YCbCr"),
        "lossless YCCK": (write_lossless([*rgb, rgb[0]], 17, 9, [(1, 1)] * 4, 8, 1, adobe=2),
                          "lossless YCCK"),
        "lossless 1-bit": (write_lossless([p >> 7 for p in rgb], 17, 9, [(1, 1)] * 3, 1, 1),
                           "1-bit lossless"),
        "lossless 12-bit": (write_lossless([p * 16 for p in rgb], 17, 9, [(1, 1)] * 3, 12, 1),
                            "12-bit lossless"),
        "lossless 16-bit": (write_lossless([p * 256 for p in rgb], 17, 9, [(1, 1)] * 3, 16, 1),
                            "16-bit lossless"),
        "2 components": (write_jpeg(coefs[:2], 17, 9, s420[:2], quant[:2], [([0, 1], 0, 63)],
                                    False), "2-component"),
        "5 components": (write_jpeg([*coefs, *coefs[1:]], 17, 9, [*s420, *s420[1:]],
                                    [*quant, quant[1]], [([0, 1, 2], 0, 63), ([3, 4], 0, 63)],
                                    False), "5-component"),
        "DAC L above U": (dac(write_arith(coefs, 17, 9, s420, quant, [([0, 1, 2], 0, 63, 0, 0)],
                                          False), bytes([0, 0x25])), "L above U"),
        "DAC table 32": (dac(write_arith(coefs, 17, 9, s420, quant, [([0, 1, 2], 0, 63, 0, 0)],
                                         False), bytes([32, 5])), "table index 32"),
    }
    for m in (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF):
        cases[f"hierarchical SOF{m - 0xC0}"] = (frame_marker(base, m),
                                                f"hierarchical JPEG \\(SOF{m - 0xC0}\\)")
    return cases


REFUSED = _refused()


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_as_cv2(tmp_path, case):
    """Where cv2 returns None, ``imdecode`` (and ``imread``, naming the
    path) raises ``OSError`` naming the kind."""
    data, reason = REFUSED[case]
    assert cv2_decode(data) is None
    with pytest.raises(OSError, match=reason):
        imdecode(data)
    path = tmp_path / "frame.jpg"
    path.write_bytes(data)
    with pytest.raises(OSError, match="frame.jpg"):
        imread(path)


# ---------------------------------------------------------------- fixtures and the JAX package


def digest(arr) -> dict:
    arr = np.ascontiguousarray(arr)
    return {"shape": list(arr.shape), "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}


def test_codings_fixtures_hold_cv2s_digests():
    """Every file of ``tests/torch_jpeg/codings`` has cv2's digest in
    ``digests.json``, cv2 and the port read it to that digest and
    ``image_size`` to its shape; the three arithmetic 1200x1920 frames
    (SOF9, SOF9 with DAC and restarts, SOF10) read to the baseline frames'
    digests."""
    with open(FIXTURES / "digests.json") as f:
        digests = json.load(f)["decode"]
    files = sorted(p.relative_to(FIXTURES).as_posix()
                   for p in (FIXTURES / "codings").glob("**/*.jpg"))
    assert len(files) >= 40 and set(files) <= set(digests)
    for rel in files:
        want = digests[rel]
        assert digest(cv2.imread(str(FIXTURES / rel))) == want, rel
        assert digest(imread(FIXTURES / rel)) == want, rel
        assert list(image_size(FIXTURES / rel)) == want["shape"][:2], rel
    frames = [f for f in files if f.startswith("codings/frames/")]
    assert len(frames) == 3
    markers = set()
    for rel in frames:
        assert digests[rel] == digests[rel[len("codings/"):]], rel
        buf = (FIXTURES / rel).read_bytes()
        markers.add(next(m for m in (0xC9, 0xCA) if bytes([0xFF, m]) in buf))
    assert markers == {0xC9, 0xCA}


@pytest.mark.parametrize("name,transform", [("cmyk_frame", 0), ("ycck_frame", 2)])
def test_four_component_frames_hold_cv2s_digests(name, transform):
    """The baseline frame 0 made a 1200x1920 CMYK or YCCK frame
    (``four_component_frame``, which ``chip_smoke.py`` builds and times):
    cv2 and the port read it to ``digests.json``'s ``derived`` digest."""
    with open(FIXTURES / "digests.json") as f:
        want = json.load(f)["derived"][name]
    buf = four_component_frame((FIXTURES / "frames" / "seq00" / "000000.jpg").read_bytes(),
                               transform)
    assert digest(cv2_decode(buf)) == want
    assert digest(imdecode(buf)) == want


def test_folder_of_arithmetic_frames_equals_the_jax_package(tmp_path):
    """The JAX package's generator's sequence at 1200x1920 with its three
    frames replaced by their arithmetic transcodes: the JAX dataset's frame
    read and letterbox resize (``cv2.imread``, ``cv2.resize``) against the
    port's, and against the baseline frames."""
    jdbcode.make_synthetic_argoverse(str(tmp_path), seq_lens=(3,), size=(1200, 1920), seed=0)
    seq = tmp_path / "Argoverse-1.1" / "tracking" / "seq00"
    for path in sorted((FIXTURES / "codings" / "frames" / "seq00").glob("*.jpg")):
        assert (seq / path.name).read_bytes() == (
            FIXTURES / "frames" / "seq00" / path.name).read_bytes()
        shutil.copy(path, seq / path.name)
    jds = jdatasets.ONE_ARGOVERSEDataset(str(tmp_path), "val.json", name="val",
                                         img_size=(600, 960))
    tds = tdatasets.ONE_ARGOVERSEDataset(str(tmp_path), "val.json", name="val",
                                         img_size=(600, 960))
    images = tds.coco.dataset["images"]
    assert len(images) == 3
    for im_ann in images:
        got = tds._read_resized(im_ann)
        np.testing.assert_array_equal(got, jds._read_resized(tds._file_name(im_ann)))
        baseline = FIXTURES / "frames" / "seq00" / im_ann["name"]
        np.testing.assert_array_equal(imread(tds._file_name(im_ann)), cv2.imread(str(baseline)))


# ---------------------------------------------------------------- vis writes


@pytest.mark.parametrize("ext", [".jpg", ".png", ".jpeg"])
def test_vis_writes_cv2s_bytes(tmp_path, ext):
    """``vis_det`` and ``vis_track`` write through the port's ``imwrite``:
    the bytes of ``cv2.imwrite`` (JPEG at its default quality 95)."""
    img = crop(64, 96).astype(np.uint8)
    for fn, extra in ((tvis.vis_det, {}), (tvis.vis_track, {"tracks": [7]})):
        out = tmp_path / fn.__name__ / f"frame{ext}"
        canvas = fn(img, [[10, 10, 40, 40]], labels=[2], class_names=["a", "b", "car"],
                    scores=[0.9], out_file=str(out), **extra)
        ref = tmp_path / f"cv2{ext}"
        assert cv2.imwrite(str(ref), canvas)
        assert out.read_bytes() == ref.read_bytes(), fn.__name__


def test_vis_refuses_other_extensions(tmp_path):
    img = crop(16, 16).astype(np.uint8)
    with pytest.raises(ValueError, match="'.bmp'"):
        tvis.vis_det(img, [[1, 1, 8, 8]], [0], ["a"], out_file=str(tmp_path / "x" / "f.bmp"))


def test_vis_results_writes_without_cv2(tmp_path, monkeypatch):
    """The port's ``vis_results`` writes its frames through ``imwrite``:
    with ``cv2.imwrite`` failing, the frames are written all the same, each
    the bytes cv2 writes for its canvas."""
    import pickle

    from streamyolo_torch.tools import vis_results

    data = tmp_path / "d"
    jdbcode.make_synthetic_argoverse(str(data), seq_lens=(2,), size=(60, 96), seed=1)
    calls = []
    monkeypatch.setattr(cv2, "imwrite", lambda *a, **k: calls.append(a) or False)
    annot = data / "Argoverse-HD" / "annotations" / "val.json"
    with open(annot) as f:
        db = json.load(f)
    dets = [{"image_id": im["id"], "bbox": [5.0, 6.0, 20.0, 15.0], "score": 0.9,
             "category_id": 1} for im in db["images"]]
    with open(tmp_path / "r.pkl", "wb") as f:
        pickle.dump(dets, f)
    root = data / "Argoverse-1.1" / "tracking"
    vis_results.main(["--data-root", str(root), "--annot-path", str(annot),
                      "--results", str(tmp_path / "r.pkl"), "--out-dir", str(tmp_path / "o")])
    assert not calls
    names = [c["name"] for c in db["categories"]]
    for im, det in zip(db["images"], dets):
        seq = db["sequences"][im["sid"]]
        canvas = vis_results._render(imread(root / db["seq_dirs"][im["sid"]] / im["name"]),
                                     [det], names, 0.3, 1.0, tvis.vis_det)
        ok, buf = cv2.imencode(".jpg", canvas)
        assert ok and (tmp_path / "o" / seq / im["name"]).read_bytes() == buf.tobytes()
