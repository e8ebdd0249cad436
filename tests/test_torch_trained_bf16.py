"""The port's whole-model serving rows against the JAX package's own on a
trained model, on the CPU (ROADMAP C.2, C.5).

The fixture, ``tests/torch_trained/`` (``python -m
tests.torch_trained_fixture``): phase ``trained_e2e``'s tiny model
(``chip_smoke.py::E2E_CONFIG``, 150x240) trained by the port on the CPU
(396 steps, AP50 96.96 on the synthetic val split), its weights stored as
bf16 (exact in every dtype); ``golden.npz``: the JAX package's
``TPUStreamDetector`` rows, bf16 and float32, on 8 streams of a star and 7
steady frames (``chip_smoke.py::trained_streams``), and its decoded
candidates (every anchor the JAX float32 model scores above conf 0.01).
Random weights amplify any rounding through the trunk; trained weights make
the scores decisive. ``meta.json`` holds every measurement quoted here (the
tests' CPU; the port with one torch thread, which its rows do not depend
on). Rows are compared box-matched (``torch_port_helpers.matched_rows``,
the card's rule: IoU >= 0.9 within each (frame, class)), in pixels of the
150x240 input; candidates in raw pixels.

Bounds:

  * integrity: the weights' and the frames' sha256 as in ``meta.json``; the
    frames equal the JAX package's generator's; stream 0's bf16 rows
    re-derived here through the JAX package's ``TPUStreamDetector`` pair
    every kept row with a committed row of its label, within the JAX run's
    own noise across XLA thread pools (``NOISE``; ``meta.json``'s
    ``jax_thread_noise``: every stream re-derived pinned to 1, 2 and 4
    cores, with the tests' 8 virtual devices bit for bit, with XLA's one
    default device up to 2.58 px / 0.0095 in bf16). The float32 rows are
    held through the port: its float32 rows to them and their candidates
    to its float64 (below), and the port's float32 to the JAX package's by
    ``tests/test_torch_stream.py``;
  * C.2, decoded candidates: the port's bf16 no farther from JAX float32
    than JAX bf16 is, plus a quarter of that gap
    (``chip_smoke.TRAINED_CAND_MARGIN``), for the largest and the mean box
    and score gap (measured: 0.51, 0.84, 1.16 and 0.78 of JAX bf16's
    3.709 px, 0.224 px, 0.0840 and 0.0074);
  * C.2, rows: the port's bf16 against JAX bf16 within
    ``chip_smoke.TRAINED_BF16_ROWS``: unmatched share 0.07, box 4.1 px,
    score 0.061 (measured 0.0464 / 3.062 / 0.0434, plus half of JAX
    bf16's own gap to JAX float32, 0.0445 / 2.061 / 0.0338);
  * float32 rows: the port's against JAX float32 all matched within
    ``chip_smoke.TRAINED_FP32_ROWS`` (5e-4 px = 1e-3 raw px, score 1e-5:
    ``tests/test_torch_stream.py``'s bounds; measured 3.8e-5 / 3.9e-6);
  * C.5, the float64 anchor: the port's float32 and JAX float32 each
    within ``C5_BOUNDS`` of the port in float64 over every golden candidate
    (raw px, score): 2.5e-4 / 1e-5, about twice the largest of either
    package at either thread count (measured at most 1.23e-4 / 3.9e-6:
    ``python -m tests.torch_detector_noise --trained`` and ``meta.json``).
    ``tests/test_torch_stream.py`` holds the random model the same way and
    keeps, with ``tests/test_torch_multistream.py``, its 1e-3 px bound
    against JAX.
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from streamyolo_tpu.data import dbcode as jdbcode

from . import torch_trained_fixture as fixture
from .torch_port_helpers import chip_smoke, matched_rows

SMOKE = chip_smoke()
# the JAX bf16 run's own noise across XLA thread pools (meta.json jax_thread_noise)
NOISE = {"box_px": 2.6, "score": 0.0096}
C5_BOUNDS = {"box_px": 2.5e-4, "score": 1e-5}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def meta():
    return json.loads(fixture.META.read_text())


@pytest.fixture(scope="module")
def golden():
    return fixture.load_golden()


@pytest.fixture(scope="module")
def frames():
    return SMOKE.trained_streams()


@pytest.fixture(scope="module")
def port(frames):
    return fixture.port_runs(frames)


def test_fixture_files_match_meta(meta, frames):
    assert hashlib.sha256(fixture.WEIGHTS.read_bytes()).hexdigest() == meta["weights_sha256"]
    assert hashlib.sha256(frames.tobytes()).hexdigest() == meta["frames_sha256"]
    assert meta["training"]["eval"]["AP50"] >= 20.0
    assert sum(p.stat().st_size for p in fixture.FIXTURE.iterdir()) < 6 * 2 ** 20


def test_frames_equal_jax_generator(frames, tmp_path, monkeypatch):
    """The JAX package's generator draws the same frames (caught at its
    ``cv2.imwrite``, before the JPEG encoding)."""
    want = {(f"seq{s:02d}", f"{o + t:06d}.jpg"): (i, t)
            for i, (s, o) in enumerate((s, o) for s in SMOKE.TRAINED_SEQS
                                       for o in SMOKE.TRAINED_OFFSETS)
            for t in range(SMOKE.TRAINED_STEPS)}
    got = np.zeros_like(frames)
    seen = set()

    def imwrite(path, frame, params=None):
        key = (os.path.basename(os.path.dirname(path)), os.path.basename(path))
        if key in want:
            got[want[key]] = frame
            seen.add(key)
        return True

    monkeypatch.setattr(jdbcode.cv2, "imwrite", imwrite)
    jdbcode.make_synthetic_argoverse(
        str(tmp_path), seq_lens=(SMOKE.E2E_FRAMES,) * SMOKE.E2E_SEQS, size=SMOKE.E2E_RAW,
        seed=SMOKE.SEED, obj_frac=SMOKE.E2E_OBJ_FRAC)
    assert seen == set(want)
    np.testing.assert_array_equal(got, frames)


def test_golden_stream_rederived_from_jax(golden, frames):
    rows = fixture.jax_rows(True, frames[:1], fixture.jax_variables())
    gap = matched_rows(rows, golden["rows_bfloat16"][:1])
    assert gap["unmatched"] == 0 and gap["pairs"] == gap["rows_ref"] > 0, gap
    assert gap["box_max_abs"] <= NOISE["box_px"], gap
    assert gap["score_max_abs"] <= NOISE["score"], gap


def test_bf16_candidates_no_farther_from_jax_fp32_than_jax_bf16(golden, port):
    gap = SMOKE.golden_gaps(golden, "float32", *SMOKE.golden_candidates(port["bfloat16"][1],
                                                                         golden))
    jax_gap = SMOKE.golden_gaps(golden, "float32", golden["cand_box_bfloat16"],
                                golden["cand_score_bfloat16"])
    assert gap["candidates"] == len(golden["cand_anchor"]) > 1000
    assert SMOKE.candidates_within(gap, jax_gap), (gap, jax_gap)


def test_bf16_rows_match_jax_bf16(golden, port):
    gap = matched_rows(port["bfloat16"][0], golden["rows_bfloat16"])
    assert gap["pairs"] > 400 and SMOKE.rows_within(gap, SMOKE.TRAINED_BF16_ROWS), gap


def test_fp32_rows_match_jax_fp32(golden, port):
    gap = matched_rows(port["float32"][0], golden["rows_float32"])
    assert gap["pairs"] == gap["rows"] == gap["rows_ref"] > 400, gap
    assert SMOKE.rows_within(gap, SMOKE.TRAINED_FP32_ROWS), gap


def test_fp32_within_float64_anchor(golden, port):
    ref = SMOKE.golden_candidates(port["float64"][1], golden)
    runs = {"port": SMOKE.golden_candidates(port["float32"][1], golden),
            "jax": (golden["cand_box_float32"], golden["cand_score_float32"])}
    for name, (box, score) in runs.items():
        gap = SMOKE.candidate_gaps(box, score, *ref)
        assert gap["box_px"] <= C5_BOUNDS["box_px"], (name, gap)
        assert gap["score"] <= C5_BOUNDS["score"], (name, gap)


def test_matched_rows_cases():
    """The shared matcher: near-tied rows that swap places in score order
    pair with their own boxes; a row whose class differs, a row only one
    run has and a row of another frame stay unmatched; unkept rows are
    ignored."""
    def row(x, y, score, label, keep=1.0):
        return [x, y, x + 40, y + 40, 1.0, score, label, keep]

    pad = row(0, 0, 0.5, 0, keep=0.0)
    ref = np.array([[row(10, 10, 0.90, 1), row(12, 12, 0.89, 1), row(100, 100, 0.8, 2), pad],
                    [row(10, 10, 0.90, 1), pad, pad, pad]], np.float32)
    got = np.array([[row(10.5, 10, 0.89, 1), row(12, 12, 0.90, 1), row(100, 100, 0.8, 3),
                     row(200, 10, 0.7, 0)],
                    [pad, pad, pad, pad]], np.float32)
    gap = matched_rows(got, ref)
    assert (gap["rows"], gap["rows_ref"], gap["pairs"], gap["unmatched"]) == (4, 4, 2, 4)
    assert gap["unmatched_share"] == 0.5
    assert gap["box_max_abs"] == 0.5 and gap["score_max_abs"] == pytest.approx(0.01)
    assert matched_rows(ref, ref)["unmatched"] == 0
