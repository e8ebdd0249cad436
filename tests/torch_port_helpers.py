"""Shared pieces of the ``test_torch_*.py`` parity tests: JAX variables with
non-trivial BatchNorm statistics, their conversion into the PyTorch port,
the textured Argoverse-HD fixture of the eval tests, the box matcher of two
detectors' rows, the guard for tests that need a CUDA card, and the pin of
torch's intra-op threads (the suite runs in several worker processes, whose
thread pools would otherwise each take every core)."""

from __future__ import annotations

import contextlib
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from streamyolo_torch.utils.weights import jax_variables_to_state_dict


@contextlib.contextmanager
def torch_threads(n: int):
    """``torch.set_num_threads(n)`` inside the block, the count before it
    after."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def pin_threads(n: int = 1):
    """A module-scoped autouse fixture that runs the module's tests with
    ``n`` intra-op threads; bind it to a name in the test module
    (``threads = pin_threads(1)``). Tiny tensors: threads spinning against
    the other workers' cost more than they parallelise."""

    @pytest.fixture(scope="module", autouse=True)
    def pinned():
        with torch_threads(n):
            yield n

    return pinned


def child_env(n: int, env=None) -> dict:
    """``env`` (default ``os.environ``) for a child process whose torch is
    to run ``n`` intra-op threads, as a pinned parent does: a child inherits
    no ``torch.set_num_threads``."""
    env = dict(os.environ if env is None else env)
    env["OMP_NUM_THREADS"] = env["MKL_NUM_THREADS"] = str(n)
    return env


def randomize_bn(variables, seed: int = 0):
    """Copy of flax ``variables`` with every BatchNorm's scale/bias/mean/var
    drawn from a seeded numpy generator (init leaves them at identity, which
    would hide a wrong eps or a swapped statistic)."""
    rng = np.random.default_rng(seed)

    def walk(tree, collection, in_bn=False):
        out = {}
        for key, value in tree.items():
            if isinstance(value, dict):
                out[key] = walk(value, collection, in_bn=(key == "bn"))
                continue
            arr = np.asarray(value, np.float32)
            if in_bn and key == "scale":
                arr = rng.uniform(0.5, 1.5, arr.shape).astype(np.float32)
            elif in_bn and key == "bias" and collection == "params":
                arr = rng.normal(0, 0.1, arr.shape).astype(np.float32)
            elif key == "mean":
                arr = rng.normal(0, 0.1, arr.shape).astype(np.float32)
            elif key == "var":
                arr = rng.uniform(0.5, 1.5, arr.shape).astype(np.float32)
            out[key] = arr
        return out

    return {c: walk(dict(v), c) for c, v in variables.items()}


def load_port(module: torch.nn.Module, variables) -> torch.nn.Module:
    """Load converted JAX ``variables`` into the port ``module`` (strict)."""
    module.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    return module.eval()


def lift_pred_biases(variables):
    """Zero the obj/cls prediction biases (prior-prob init puts every score
    near 1e-4, so NMS would see no candidates)."""
    out = {c: dict(v) for c, v in variables.items()}
    head = dict(out["params"]["head"])
    for name, leaf in head.items():
        if name.startswith(("obj_preds_", "cls_preds_")):
            head[name] = {**leaf, "bias": np.zeros_like(np.asarray(leaf["bias"]))}
    out["params"]["head"] = head
    return out


def nhwc_to_nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def tiny_model(dtype):
    """Depth 0.33, width 0.25, seeded weights, obj/cls prediction biases 0
    (so NMS sees candidates), on the card."""
    from streamyolo_torch.models import DFPPAFPN, StreamYOLO, TALHead, init_weights

    model = init_weights(StreamYOLO(DFPPAFPN(0.33, 0.25), TALHead(num_classes=8, width=0.25)),
                         torch.Generator().manual_seed(0))
    with torch.no_grad():
        for m in list(model.head.obj_preds) + list(model.head.cls_preds):
            m.bias.zero_()
    return model.to(device="cuda", dtype=dtype).eval()


def chip_smoke():
    """The repository's ``chip_smoke.py`` as a module (its shared
    constants and comparison helpers import nothing but numpy)."""
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke as module

    return module


def matched_rows(blocks, blocks_ref, iou_min: float = 0.9) -> dict:
    """The kept rows of two detectors' ``[..., K, 8]`` row blocks (one
    frame per block, in C order) box-matched within each (frame, class) by
    ``chip_smoke.py::matched_rows``'s rule, which the card's checks use:
    the reference rows in score order each take the other run's unmatched
    row of the highest IoU if it is >= ``iou_min``. Returns the pairs, the
    rows left unmatched on either side and their share of both runs' rows,
    and the matched pairs' largest box gap (px of the blocks) and score gap
    (obj x cls)."""
    module = chip_smoke()
    return module.matched_rows(module.block_rows(np.asarray(blocks)),
                               module.block_rows(np.asarray(blocks_ref)), iou_min)


def require_cuda():
    """Skip the calling test unless a CUDA card and nvcc are present."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: pytest -m cuda)")


def write_textured_argoverse(root, seq_lens):
    """``tests/conftest.py::write_fake_argoverse`` (raw 60x96 frames) with the
    flat frames replaced by seeded noise JPEGs: flat frames make every
    spatial location score alike, which leaves NMS to tie-breaks."""
    import cv2

    from .conftest import FAKE_H, FAKE_W, write_fake_argoverse

    write_fake_argoverse(root, seq_lens=seq_lens)
    rng = np.random.RandomState(sum(seq_lens))
    for path in sorted((root / "Argoverse-1.1" / "tracking").rglob("*.jpg")):
        cv2.imwrite(str(path), rng.randint(0, 256, (FAKE_H, FAKE_W, 3), np.uint8))
    return str(root)


def make_toy_detector():
    """Makes a ``Streamer``'s detector (top-level, so that a spawned child
    imports it by reference): one fixed 10x8 box at x = frame[0][0]."""

    def detect(frame):
        x = float(frame[0][0])
        return ([[x, 20.0, x + 10.0, 28.0]], [0.9], [2])

    return detect


def make_failing_detector():
    """Makes a ``Streamer``'s detector that raises on its first frame."""

    def detect(frame):
        raise ValueError(f"toy detector refuses frame {frame!r}")

    return detect


def make_cuda_detector():
    """Makes a ``Streamer``'s detector: a bf16 ``CUDAStreamDetector``
    (``tiny_model``, 128x192, ``device_preproc``) on the card in the child.
    Its ``detect`` returns the child's (B1, B2) launch counts since the
    build in the parse tuple's 4th slot."""
    from streamyolo_torch.ops.nms_cuda import nms_keep
    from streamyolo_torch.ops.preproc import downsample2x
    from streamyolo_torch.stream import CUDAStreamDetector

    det = CUDAStreamDetector(tiny_model(torch.bfloat16), input_size=(128, 192),
                             device_preproc=True)
    nms_keep.launches = 0
    downsample2x.launches = 0

    def detect(frame):
        bboxes, scores, labels, _ = det(frame)
        return bboxes, scores, labels, (nms_keep.launches, downsample2x.launches)

    return detect
