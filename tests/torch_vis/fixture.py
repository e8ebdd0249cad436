#!/usr/bin/env python3
"""The committed overlay fixture of ``tools/vis_results.py``: seeded
detection rows (``detections.json``, CCF rows: the thresholded ones and
ones below ``--score-th``, boxes over each edge, wholly outside, zero-width
and inverted, labels clamped to the top) on the three 1200x1920 frames of
``tests/torch_jpeg/frames/seq00`` (``annotations.json``), and the sha256 of
every file the JAX package's tool writes from them (``digests.json``), one
set per run of ``RUNS``: plain, ``--vis-scale 0.75``, and ``--contrast``
with the swing divider.

``tests/test_torch_vis_draw.py`` holds the JAX tool to these digests and
the port's tool, with cv2 blocked, to the same; ``chip_smoke.py`` phase
``image_io`` runs the port's tool on the card's host against them.

    JAX_PLATFORMS=cpu python -m tests.torch_vis.fixture

rewrites the three files (needs cv2 and the JAX package); commit them
together.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parents[1]
FRAMES_ROOT = REPO / "tests" / "torch_jpeg" / "frames"
ANNOTATIONS = HERE / "annotations.json"
DETECTIONS = HERE / "detections.json"
DIGESTS = HERE / "digests.json"
FRAME_HW = (1200, 1920)
CLASSES = ("person", "bicycle", "car", "motorcycle", "bus", "truck", "traffic_light",
           "stop_sign")
# tool arguments after --data-root, --annot-path, --results and --out-dir;
# "{contrast}" is the second experiment's pkl
RUNS = {
    "plain": ["--score-th", "0.3"],
    "scale075": ["--score-th", "0.3", "--vis-scale", "0.75"],
    "contrast": ["--score-th", "0.3", "--contrast", "{contrast}", "--split-animation", "swing",
                 "--fps", "0.45"],
}


def make_annotations() -> dict:
    names = sorted(p.name for p in (FRAMES_ROOT / "seq00").glob("*.jpg"))
    images = [dict(id=i, width=FRAME_HW[1], height=FRAME_HW[0], sid=0, fid=i, name=name)
              for i, name in enumerate(names)]
    return dict(images=images, annotations=[],
                categories=[dict(id=i, name=n) for i, n in enumerate(CLASSES)],
                seq_dirs=["seq00"], sequences=["seq00"])


def make_detections(seed: int = 0, per_frame: int = 40) -> list:
    """CCF rows: ltwh boxes with fractional corners over the frame, scores
    either side of 0.3, and in each frame a box at the top (its label
    clamped to y = 10), boxes over each edge, one wholly outside, one of
    zero width and one inverted (negative width and height)."""
    rng = np.random.default_rng(seed)
    h, w = FRAME_HW
    rows = []
    for image_id in range(3):
        boxes = []
        for _ in range(per_frame):
            bw, bh = rng.uniform(8, 400), rng.uniform(8, 300)
            boxes.append([rng.uniform(-60, w - bw + 60), rng.uniform(-40, h - bh + 40), bw, bh])
        boxes += [[100.3, 2.6, 80.0, 50.0], [-30.4, 300.2, 90.0, 60.0], [w - 45.5, 500.0, 90.0, 70.0],
                  [600.0, -20.7, 120.0, 45.0], [900.0, h - 25.2, 140.0, 60.0],
                  [w + 50.0, h + 50.0, 40.0, 40.0], [1000.2, 700.0, 0.0, 80.0],
                  [1500.0, 900.0, -60.0, -40.0], [w - 8.0, 8.0, 30.0, 20.0]]
        for box in boxes:
            rows.append(dict(image_id=image_id, category_id=int(rng.integers(0, len(CLASSES))),
                             bbox=[round(float(v), 2) for v in box],
                             score=round(float(rng.uniform(0.05, 1.0)), 4)))
    return rows


def write_results(out_dir: Path) -> dict:
    """The committed rows as the tool's pkls: ``a`` every row, ``b`` (the
    contrast experiment) the rows of every other box, shifted 6 px."""
    rows = json.loads(DETECTIONS.read_text())
    other = [dict(r, bbox=[r["bbox"][0] + 6, r["bbox"][1] + 6, *r["bbox"][2:]])
             for r in rows[::2]]
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, data in (("a", rows), ("b", other)):
        paths[name] = out_dir / f"{name}.pkl"
        with open(paths[name], "wb") as f:
            pickle.dump(data, f)
    return paths


def tool_args(run: str, out_dir: Path, results: dict) -> list:
    extra = [a.format(contrast=results["b"]) for a in RUNS[run]]
    return ["--data-root", str(FRAMES_ROOT), "--annot-path", str(ANNOTATIONS),
            "--results", str(results["a"]), "--out-dir", str(out_dir), *extra]


def file_digests(out_dir: Path) -> dict:
    """sha256 of every JPEG under out_dir, by path relative to it."""
    return {p.relative_to(out_dir).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(Path(out_dir).rglob("*.jpg"))}


def run_jax_tool(run: str, out_dir: Path, results: dict) -> dict:
    """The JAX package's ``tools/vis_results.py`` (cv2) for ``run``."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, str(REPO / "tools" / "vis_results.py"),
                    *tool_args(run, out_dir, results)], check=True, env=env,
                   stdout=subprocess.DEVNULL)
    return file_digests(out_dir)


def main():
    import tempfile

    ANNOTATIONS.write_text(json.dumps(make_annotations(), indent=1) + "\n")
    DETECTIONS.write_text(json.dumps(make_detections(), indent=0) + "\n")
    with tempfile.TemporaryDirectory() as tmp:
        results = write_results(Path(tmp) / "results")
        digests = {run: run_jax_tool(run, Path(tmp) / run, results) for run in RUNS}
    DIGESTS.write_text(json.dumps(digests, indent=1, sort_keys=True) + "\n")
    print(f"wrote {ANNOTATIONS}, {DETECTIONS}, {DIGESTS}")


if __name__ == "__main__":
    main()
