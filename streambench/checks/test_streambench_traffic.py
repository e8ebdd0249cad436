"""The traffic generator gives the same inputs for the same seed, other
inputs for another, and the same sizes and arrivals for every seed."""

import numpy as np
import pytest

from streambench import seeds, traffic

CAMS = {"kind": "cameras", "cameras": 5, "fps": 30, "pool_per_camera": 4, "check_ticks": 6}
BIG = 2 ** 31 + 987_654_321


@pytest.mark.parametrize("seed", [0, 17, BIG, 2 ** 62 + 3])
def test_frames_repeat_for_a_seed(seed):
    a = traffic.frames(seed, "frames", 3, (40, 56), "cpu")
    b = traffic.frames(seed, "frames", 3, (40, 56), "cpu")
    assert a.dtype == np.uint8 and a.shape == (3, 40, 56, 3)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, traffic.frames(seed + 1, "frames", 3, (40, 56), "cpu"))
    assert not np.array_equal(a[0], a[1])


def test_frames_are_not_flat():
    f = traffic.frames(BIG, "frames", 2, (64, 96), "cpu").astype(np.float32)
    assert 30 < f.std() < 120


@pytest.mark.parametrize("seed", [1, BIG])
def test_camera_plan(seed):
    a = traffic.camera_plan(CAMS, seed, 20.0)
    b = traffic.camera_plan(CAMS, seed, 20.0)
    assert a.ticks == 600 and a.index.shape == (600, 5)
    assert np.array_equal(a.index, b.index) and a.check == b.check
    assert 0 in a.check and a.ticks - 1 in a.check and len(a.check) == CAMS["check_ticks"]
    assert (a.index[1:] != a.index[:-1]).all()  # a camera's consecutive frames differ
    other = traffic.camera_plan(CAMS, seed + 1, 20.0)
    assert other.ticks == a.ticks  # every seed: the same arrivals


def test_seed_streams_independent_and_large_seeds():
    assert seeds.derive(BIG, "a") != seeds.derive(BIG, "b")
    assert seeds.derive(BIG, "a") == seeds.derive(BIG, "a")
    assert 0 <= seeds.derive(2 ** 70, "a") < 2 ** 63
    with pytest.raises(ValueError):
        seeds.derive(-1, "a")
