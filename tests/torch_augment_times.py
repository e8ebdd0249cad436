"""Host times of the port's NumPy augmentation against cv2 on this machine's
CPU: a mosaic pair item of ``MosaicDetection`` at 600x960 from 1200x1920
synthetic frames (``chip_smoke.py`` phase ``train``'s fixture and config),
and the calls it makes (the 1200x1920 -> 600x960 warp of a mosaic canvas,
the 2x letterbox, a general resize, the HSV round trip) beside cv2's.

    python -m tests.torch_augment_times

prints one JSON line of medians in ms. A measurement, not a test; host
CPU times only, never a device figure."""

import json
import random
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np


def median_ms(fn, reps: int) -> float:
    out = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        out.append(1e3 * (time.perf_counter() - t))
    return statistics.median(out)


def main() -> None:
    import cv2

    repo = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(repo))
    import chip_smoke
    from streamyolo_torch.data import cv2_ops
    from streamyolo_torch.data.transforms import _sample_warp_matrix
    from streamyolo_torch.exp import get_exp

    work = Path(tempfile.mkdtemp())
    load_frame = chip_smoke.train_fixture(work)
    exp = get_exp(exp_name=chip_smoke.EVAL_CONFIG).merge(
        ["data_dir", str(work), "data_num_workers", "0"])
    exp.get_data_loader(batch_size=2, no_aug=True, load_frame=load_frame)
    wrapper = exp.dataset
    plain_ms = median_ms(lambda: wrapper[0], 5)
    wrapper.enable_mosaic = True
    random.seed(0)
    items = iter(range(10 ** 6))
    mosaic_ms = median_ms(lambda: wrapper[next(items) % len(wrapper)], 8)

    rng = np.random.RandomState(0)
    canvas = np.full((1200, 1920, 3), 114, np.uint8)
    canvas[150:1050, 200:1700] = rng.randint(0, 256, (900, 1500, 3), np.uint8)
    random.seed(1)
    matrix, _ = _sample_warp_matrix((1200, 1920), (600, 960), 10.0, 0.1, (0.1, 2.0), 2.0)
    frame = rng.randint(0, 256, (1200, 1920, 3), np.uint8)
    small = rng.randint(0, 256, (600, 960, 3), np.uint8)
    pairs = {
        "warp_affine_1200x1920_to_600x960": (
            lambda: cv2_ops.warp_affine_u8(canvas, matrix[:2], (600, 960)),
            lambda: cv2.warpAffine(canvas, matrix[:2], (960, 600), borderValue=(114,) * 3)),
        "resize_2x_1200x1920": (lambda: cv2_ops.resize_u8(frame, 600, 960),
                                lambda: cv2.resize(frame, (960, 600))),
        "resize_600x960_to_331x530": (lambda: cv2_ops.resize_u8(small, 331, 530),
                                      lambda: cv2.resize(small, (530, 331))),
        "hsv_round_trip_600x960": (
            lambda: cv2_ops.hsv2bgr_u8(cv2_ops.bgr2hsv_u8(small)),
            lambda: cv2.cvtColor(cv2.cvtColor(small, cv2.COLOR_BGR2HSV), cv2.COLOR_HSV2BGR)),
    }
    calls = {name: {"numpy_ms": median_ms(ours, 5), "cv2_ms": median_ms(theirs, 5)}
             for name, (ours, theirs) in pairs.items()}
    print(json.dumps({"mosaic_pair_item_ms": mosaic_ms, "plain_pair_item_ms": plain_ms,
                      "calls": calls}))


if __name__ == "__main__":
    main()
