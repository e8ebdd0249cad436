"""The port's drawing (``streamyolo_torch/vis/draw.py`` over
``native/draw.cpp``) against cv2 5.0 and the JAX package, on the CPU.
Everything is compared for equality; there is no tolerance.

  * the font: ``tests/torch_vis/extract_font.py`` inflates the committed
    ``Rubik.ttf`` (and its licence note) from the installed cv2's binary;
  * ``FONT_HERSHEY_SIMPLEX``'s size and weight: cv2's Hershey text equals
    its ``FontFace('sans')`` text at ``hershey_simplex_font``'s size and
    weight over a grid of scales (the rounding ties among them) and
    thicknesses;
  * ``put_text`` against ``cv2.putText``: every printable ASCII glyph alone
    at six (scale, thickness) pairs, every glyph of the font at the label's
    and the video stamp's, every Argoverse class name with a score and a
    track id on random backgrounds in the 8 palette colours, every ordered
    pair of a kerning-heavy set, newlines, gray images, text running off
    each edge, seeded random strings; ``text_size`` against
    ``cv2.getTextSize``; a code point the font lacks raises and draws
    nothing;
  * ``rectangle`` against ``cv2.rectangle``: boxes over each edge, wholly
    outside, of zero width or height, inverted, thickness -1 to 10;
  * ``draw_detections`` / ``vis_det`` / ``vis_track`` at ``out_scale`` 1.0
    and 0.75, and ``tools/vis_results.py`` on the committed overlay fixture
    (``tests/torch_vis/fixture.py``), drawn by the port in a child process
    in which cv2 cannot be imported, against the JAX package's (cv2): the
    same arrays and the same file bytes; the JAX tool's files against the
    digests ``chip_smoke.py`` holds the card's host to.
"""

import hashlib
import json
import os
import string
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from streamyolo_torch.data.argoverse_classes import ARGOVERSE_CLASSES
from streamyolo_torch.vis import _PALETTE
from streamyolo_torch.vis.draw import FONT_PATH, hershey_simplex_font, put_text, rectangle, text_size
from tests.torch_vis import extract_font, fixture

cv2 = pytest.importorskip("cv2")

REPO = Path(__file__).resolve().parents[1]
HERSHEY = cv2.FONT_HERSHEY_SIMPLEX
PRINTABLE = string.printable[:95]  # letters, digits, punctuation, the space


def cv2_text(img, text, org, scale, colour, thickness, line=cv2.LINE_AA):
    out = img.copy()
    cv2.putText(out, text, org, HERSHEY, scale, colour, thickness, line)
    return out


def port_text(img, text, org, scale, colour, thickness):
    out = img.copy()
    put_text(out, text, org, scale, colour, thickness)
    return out


def assert_same(a, b, what):
    assert a.shape == b.shape, what
    if not np.array_equal(a, b):
        bad = np.argwhere(a != b)
        pytest.fail(f"{what}: {len(bad)} values differ, first at {bad[0].tolist()}")


def test_font_is_extracted_from_cv2(tmp_path):
    written = extract_font.extract(tmp_path)
    assert written.read_bytes() == FONT_PATH.read_bytes()
    assert hashlib.sha256(FONT_PATH.read_bytes()).hexdigest() == extract_font.SHA256
    note = (tmp_path / "LICENSE.txt").read_text()
    assert note == (FONT_PATH.parent / "LICENSE.txt").read_text()
    assert "SIL Open Font License, Version 1.1" in note


@pytest.mark.parametrize("thickness", [0, 1, 2, 5])
def test_hershey_scale_maps_to_size_and_weight(thickness):
    face = cv2.FontFace("sans")
    ties = [(n - 0.5) * 0.037 for n in range(6, 60, 7)]
    for scale in [*np.round(np.arange(0.2, 3.0, 0.07), 4), *ties]:
        want = np.zeros((120, 260), np.uint8)
        cv2.putText(want, "Hg5", (10, 90), HERSHEY, float(scale), (255,), thickness)
        size, weight = hershey_simplex_font(scale, thickness)
        got = np.zeros_like(want)
        cv2.putText(got, "Hg5", (10, 90), (255,), face, size, weight)
        assert_same(got, want, f"scale {scale} thickness {thickness} -> {size}, {weight}")


@pytest.mark.parametrize("scale,thickness",
                         [(0.5, 1), (1.0, 2), (0.75, 1), (0.3, 1), (2.0, 3), (1.3, 0)])
def test_every_printable_glyph_alone(scale, thickness):
    rng = np.random.default_rng(int(scale * 10) + thickness)
    for i, ch in enumerate(PRINTABLE):
        bg = rng.integers(0, 256, (110, 90, 3), dtype=np.uint8)
        colour = _PALETTE[i % len(_PALETTE)]
        assert_same(port_text(bg, ch, (20, 70), scale, colour, thickness),
                    cv2_text(bg, ch, (20, 70), scale, colour, thickness), repr(ch))


@pytest.mark.parametrize("scale,thickness", [(0.5, 1), (1.0, 2)])
def test_every_glyph_of_the_font(scale, thickness):
    """Composite glyphs (the accented letters) and glyphs whose deltas need
    IUP included."""
    TTFont = pytest.importorskip("fontTools.ttLib").TTFont
    codes = sorted(c for c in TTFont(str(FONT_PATH)).getBestCmap() if c != 10)
    bg = np.zeros((80, 110), np.uint8)
    for c in codes:
        assert_same(port_text(bg, chr(c), (30, 55), scale, (255,), thickness),
                    cv2_text(bg, chr(c), (30, 55), scale, (255,), thickness), f"U+{c:04X}")


def test_class_labels_on_random_backgrounds():
    """Every label draw_detections writes: each class name, with a score and
    with a track id, in each palette colour, as the label and the stamp."""
    rng = np.random.default_rng(3)
    labels = []
    for name in (*ARGOVERSE_CLASSES, "8"):
        score = float(rng.uniform())
        labels += [name, f"{name} {score:.2f}", f"{name} {score:.2f} #{int(rng.integers(0, 999))}"]
    for label in labels:
        for colour in _PALETTE:
            bg = rng.integers(0, 256, (40, 240, 3), dtype=np.uint8)
            assert_same(port_text(bg, label, (3, 25), 0.5, colour, 1),
                        cv2_text(bg, label, (3, 25), 0.5, colour, 1), f"{label!r} {colour}")
    bg = rng.integers(0, 256, (60, 160, 3), dtype=np.uint8)
    for stamp in ("0", "17", "123", "4096"):
        assert_same(port_text(bg, stamp, (10, 30), 1.0, (0, 255, 255), 2),
                    cv2_text(bg, stamp, (10, 30), 1.0, (0, 255, 255), 2), stamp)


@pytest.mark.parametrize("scale,thickness", [(0.5, 1), (1.0, 2)])
def test_every_ordered_pair_of_a_kerning_set(scale, thickness):
    chars = "AVTWYafjoy.,-0123456789"
    text = "\n".join(" ".join(a + b for b in chars) for a in chars)
    bg = np.random.default_rng(4).integers(0, 256, (1100, 1400, 3), dtype=np.uint8)
    assert_same(port_text(bg, text, (5, 30), scale, (219, 68, 55), thickness),
                cv2_text(bg, text, (5, 30), scale, (219, 68, 55), thickness), "pairs")


def test_newlines_and_gray_images():
    bg = np.random.default_rng(5).integers(0, 256, (150, 200), dtype=np.uint8)
    for text in ("a\nb", "\nabc", "\n\nH\n\nH", " \nH", "H\n", "Hg\nHgHg\n\nx", "\n"):
        for scale, thickness in ((0.5, 1), (1.0, 2)):
            assert_same(port_text(bg, text, (10, 30), scale, 200, thickness),
                        cv2_text(bg, text, (10, 30), scale, 200, thickness), repr(text))


def test_text_off_each_edge():
    bg = np.random.default_rng(6).integers(0, 256, (60, 120, 3), dtype=np.uint8)
    text = "person 0.87 #12"
    for org in ((-30, 30), (90, 30), (10, 4), (10, 70), (10, -3), (200, 30), (-400, 30),
                (10, 58), (110, 59)):
        for scale, thickness in ((0.5, 1), (1.0, 2)):
            assert_same(port_text(bg, text, org, scale, (66, 133, 244), thickness),
                        cv2_text(bg, text, org, scale, (66, 133, 244), thickness), f"{org}")


@pytest.mark.parametrize("seed", range(4))
def test_random_text_and_sizes(seed):
    rng = np.random.default_rng(100 + seed)
    for _ in range(60):
        h, w = (int(v) for v in rng.integers(20, 160, 2))
        bg = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        text = "".join(rng.choice(list(PRINTABLE + "\n"), int(rng.integers(1, 16))))
        scale = float(rng.choice([0.01, 0.3, 0.45, 0.5, 0.75, 1.0, 1.6]))
        thickness = int(rng.integers(0, 4))
        org = (int(rng.integers(-40, w + 10)), int(rng.integers(-10, h + 30)))
        colour = tuple(int(v) for v in rng.integers(0, 256, 3))
        line = int(rng.choice([cv2.LINE_8, cv2.LINE_4, cv2.LINE_AA]))
        assert_same(port_text(bg, text, org, scale, colour, thickness),
                    cv2_text(bg, text, org, scale, colour, thickness, line), repr(text))
        assert text_size(text, scale, thickness) == cv2.getTextSize(text, HERSHEY, scale, thickness)
    assert text_size("", 0.5) == cv2.getTextSize("", HERSHEY, 0.5, 1)


def test_missing_code_point_raises_and_draws_nothing():
    bg = np.zeros((40, 100, 3), np.uint8)
    for text in ("car 中", "\U0001F600"):
        img = bg.copy()
        with pytest.raises(ValueError, match=f"U\\+{ord(text[-1]):04X}"):
            put_text(img, text, (5, 30), 0.5, (255, 255, 255))
        assert not img.any()
        with pytest.raises(ValueError):
            text_size(text, 0.5)
    with pytest.raises(TypeError):
        put_text(bg, "a", (5.0, 30.0), 0.5, (255, 255, 255))
    with pytest.raises(ValueError):
        put_text(bg[:, ::2], "a", (5, 30), 0.5, (255, 255, 255))


@pytest.mark.parametrize("thickness", [-1, 0, 1, 2, 3, 4, 7, 10])
def test_rectangles_equal_cv2(thickness):
    rng = np.random.default_rng(200 + thickness)
    fixed = [((10, 10), (40, 30)), ((-5, -5), (20, 20)), ((50, 5), (90, 25)), ((5, 50), (30, 70)),
             ((-30, -30), (-10, -10)), ((100, 100), (140, 130)), ((20, 10), (20, 40)),
             ((10, 20), (40, 20)), ((15, 15), (15, 15)), ((40, 30), (10, 10)), ((-10, 30), (90, 35))]
    cases = fixed + [(tuple(int(v) for v in rng.integers(-20, 100, 2)),
                      tuple(int(v) for v in rng.integers(-20, 100, 2))) for _ in range(150)]
    for p1, p2 in cases:
        bg = rng.integers(0, 256, (60, 80, 3), dtype=np.uint8)
        colour = _PALETTE[int(rng.integers(0, len(_PALETTE)))]
        want = bg.copy()
        cv2.rectangle(want, p1, p2, colour, thickness)
        got = rectangle(bg.copy(), p1, p2, colour, thickness)
        assert_same(got, want, f"{p1} {p2}")
        gray = bg[..., 0].copy()
        want = gray.copy()
        cv2.rectangle(want, p1, p2, 99, thickness)
        assert_same(rectangle(gray, p1, p2, 99, thickness), want, f"gray {p1} {p2}")


@pytest.fixture(scope="module")
def port_side(tmp_path_factory):
    """The port's drawings, made in a child that cannot import cv2."""
    out = tmp_path_factory.mktemp("port_vis")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, "-m", "tests.torch_vis.port_child", str(out)], cwd=REPO,
                   env=env, check=True, stdout=subprocess.DEVNULL)
    report = json.loads((out / "report.json").read_text())
    assert report["cv2_loaded"] is False
    return out, report


@pytest.mark.parametrize("out_scale", [1.0, 0.75])
def test_detections_equal_jax_without_cv2(port_side, tmp_path, out_scale):
    from streamyolo_tpu import vis as jvis
    from tests.torch_vis.port_child import detection_cases

    out, _ = port_side
    arrays = np.load(out / "arrays.npz")
    cases = [c for c in detection_cases() if c[-1] == out_scale]
    assert len(cases) == 3
    for name, img, boxes, labels, names, scores, tracks, scale in cases:
        kw = dict(scores=scores, out_scale=scale)
        assert_same(arrays[f"draw_{name}"],
                    jvis.draw_detections(img, boxes, labels, names, tracks=tracks, score_th=0.3,
                                         **kw), f"draw_detections {name}")
        if tracks is None:
            path = tmp_path / f"vis_det_{name}.jpg"
            want = jvis.vis_det(img, boxes, labels, names, score_th=0.3, out_file=str(path), **kw)
            assert_same(arrays[f"vis_det_{name}"], want, f"vis_det {name}")
        else:
            path = tmp_path / f"vis_track_{name}.png"
            want = jvis.vis_track(img, boxes, tracks, labels, names, out_file=str(path), **kw)
            assert_same(arrays[f"vis_track_{name}"], want, f"vis_track {name}")
        assert (out / "files" / path.name).read_bytes() == path.read_bytes(), path.name


def test_vis_results_equals_jax_tool_and_pinned_digests(port_side, tmp_path, monkeypatch):
    """The JAX tool (cv2) on the committed overlay fixture writes the
    committed digests; the port's tool, without cv2, the same bytes."""
    sys.path.insert(0, str(REPO / "tools"))
    import vis_results as jtool

    _, report = port_side
    pinned = json.loads(fixture.DIGESTS.read_text())
    results = fixture.write_results(tmp_path / "results")
    assert set(pinned) == set(fixture.RUNS)
    for run in fixture.RUNS:
        monkeypatch.setattr(sys, "argv", ["vis_results.py",
                                          *fixture.tool_args(run, tmp_path / run, results)])
        jtool.main()
        assert fixture.file_digests(tmp_path / run) == pinned[run], run
        assert report["tool"][run] == pinned[run], run
