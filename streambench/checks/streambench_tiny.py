"""Tiny cells for the harness's CPU tests: a copy of the benchmark's data
files in a temporary directory, with a float32 configuration at depth 0.33,
width 0.25 and 64x96 frames (126 anchors, of which the top 24 are served,
so that the selection matters), and a camera cell that uses the real
cell's limits. ``harness.ROOT`` / ``HERE`` point at the copy while a test
runs, so the runs read it as the checkout's."""

from __future__ import annotations

import contextlib
import io
import json
import shutil
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from streambench import harness, run

REPO = Path(__file__).resolve().parents[2]
TINY = {"depth": 0.33, "width": 0.25, "input_size": [64, 96], "dtype": "float32",
        "pre_nms_topk": 24}
# name: (traffic file, changes to it, the metrics it reports besides setup_s);
# each takes l-cams-rt's limits
CELLS = {"tiny-cams": ("cams13_30fps", {"cameras": 3, "reference_block": 2},
                       ("frame_latency_p95_ms", "frames_per_s"))}
LIMITS = "l-cams-rt"
SEED = 2 ** 31 + 4_000_000_017  # above 32 bits, as large seeds are


def copy_bench(dst: Path) -> dict:
    """``BENCHMARK.json`` and the data files of ``streambench/`` copied to
    ``dst``; returns the copied ``BENCHMARK.json``."""
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(REPO / "streambench" / sub, dst / "streambench" / sub)
    shutil.copy(REPO / "BENCHMARK.json", dst)
    return harness.load_json(dst / "BENCHMARK.json")


def add_tiny_cells(dst: Path, bench: dict) -> dict:
    """Adds the tiny configuration and cells to the copy at ``dst`` as new
    files and entries only."""
    sb = dst / "streambench"
    cfg = harness.load_json(sb / "configs" / "streamyolo-l.json")
    cfg.update(TINY, name="tiny")
    (sb / "configs" / "tiny.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "tiny", "source": "https://example.org/tiny",
                             "file": "streambench/configs/tiny.json", "reduced": ["depth"],
                             "why": "CPU test size"})
    for name, (traffic, changes, metrics) in CELLS.items():
        tr = harness.load_json(sb / "traffic" / f"{traffic}.json")
        tr.update(changes)
        (sb / "traffic" / f"{name}.json").write_text(json.dumps(tr))
        shutil.copy(sb / "limits" / f"{LIMITS}.json", sb / "limits" / f"{name}.json")
        bench["workloads"].append({"name": name, "config": "tiny", "traffic": name, "chips": 1,
                                   "why": "CPU test"})
        for m in bench["end_to_end"]:
            if m["name"] in metrics:
                m["workloads"].append(name)
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench


@contextlib.contextmanager
def checkout(dst: Path):
    """The harness reads ``dst`` as the checkout while the block runs."""
    before = harness.ROOT, harness.HERE
    harness.ROOT, harness.HERE = dst, dst / "streambench"
    try:
        yield
    finally:
        harness.ROOT, harness.HERE = before


def run_cell(workload: str, system=None, seconds: float = 1.0, trace: int = 0) -> dict:
    """One run of ``workload`` on the CPU (the card check skipped); returns
    the parsed result line."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = run.main(["--workload", workload, "--seed", str(SEED), "--seconds", str(seconds),
                       "--trace", str(trace)], system=system, device=torch.device("cpu"))
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


# --- faults planted in the program's timed path -----------------------------

class DetectorFault:
    """Wraps the port's ``MultiStreamDetector``; a subclass breaks it."""

    def __init__(self, det):
        self.det = det

    def reset(self):
        self.det.reset()

    def __call__(self, frames, preprocessed=False):
        return self.det(frames, preprocessed=preprocessed)

    @property
    def last_rows(self):
        return self.det.last_rows


class StaleState(DetectorFault):
    """The step returns its state unchanged: the DFP buffer keeps the star
    frame's features."""

    first = None

    def reset(self):
        super().reset()
        self.first = None

    def __call__(self, frames, preprocessed=False):
        out = super().__call__(frames, preprocessed)
        with torch.inference_mode():  # the detector's buffer is an inference tensor
            buf = self.det._buffer
            if self.first is None:
                self.first = tuple(b.clone() for b in buf)
            else:
                for b, f in zip(buf, self.first):
                    b.copy_(f)
        return out


class AlteredRows(DetectorFault):
    """The served rows altered by ``alter`` where they are produced."""

    def __init__(self, det, alter):
        super().__init__(det)
        self.alter = alter

    @property
    def last_rows(self):
        return self.alter(self.det.last_rows.copy())



def wrong_selection(right, resort: bool):
    """A stand-in for the port's ``select_candidates`` (``right``) that ranks
    by obj alone instead of obj x cls_conf; with ``resort`` the K chosen
    are then served in descending score, so only which candidates were
    served is wrong."""

    def select(prediction, num_classes, conf_thre, pre_nms_topk, class_agnostic=False):
        top, boxes, valid = right(prediction, num_classes, conf_thre, prediction.shape[1],
                                  class_agnostic)
        key = torch.where(valid, top[..., 4], torch.full_like(top[..., 4], -1.0))
        order = torch.sort(-key, dim=-1, stable=True).indices[:, :pre_nms_topk]
        if resort:
            score = torch.where(valid, top[..., 4] * top[..., 5], torch.full_like(key, -1.0))
            order = order.gather(1, torch.sort(-score.gather(1, order), dim=-1,
                                               stable=True).indices)
        return (top.gather(1, order[..., None].expand(-1, -1, top.shape[-1])),
                boxes.gather(1, order[..., None].expand(-1, -1, 4)).contiguous(),
                valid.gather(1, order).contiguous())

    return select


class WrongSelection(DetectorFault):
    """The program's candidate selection replaced by ``wrong_selection``
    while the detector runs (on the CPU it runs eagerly)."""

    def __init__(self, det, resort: bool):
        super().__init__(det)
        self.resort = resort

    def __call__(self, frames, preprocessed=False):
        from streamyolo_torch.ops import nms

        select = wrong_selection(nms.select_candidates, self.resort)
        with mock.patch.object(nms, "select_candidates", select):
            return super().__call__(frames, preprocessed)


def detector_fault(cls, *args):
    """A ``system`` for the cameras runner: the port's detector wrapped in
    ``cls``."""
    from streambench import program

    return lambda cfg, state, device, n: cls(
        program.multi_stream_detector(cfg, state, device, n), *args)


def half_batch_rows(rows: np.ndarray) -> np.ndarray:
    """Half of the batch left out: the later images get the earlier ones'
    rows."""
    half = (len(rows) + 1) // 2
    rows[half:] = rows[:len(rows) - half]
    return rows


def altered_box_rows(rows: np.ndarray) -> np.ndarray:
    """The first image's first row moved by 16 pixels."""
    rows[0, 0, [0, 2]] += 16.0
    return rows


def flipped_keep_rows(rows: np.ndarray) -> np.ndarray:
    """One keep flag flipped."""
    rows[0, 1, 7] = 1.0 - rows[0, 1, 7]
    return rows
