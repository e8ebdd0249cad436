#!/usr/bin/env python3
"""The video fixture of ``vis.make_video``: seeded frame sequences made with
NumPy and the sha256 of every MP4 the port writes from them
(``digests.json``).

  * ``synthetic``: 240x384, 26 frames (three GOPs) at 30 fps: a textured
    background panning 3 px a frame under four boxes, each moving its own
    way;
  * ``odd``: 121x161, 5 frames at 30 fps (cv2 crops an odd size);
  * ``ntsc``: the first 5 synthetic frames at 29.97 fps;
  * ``vis_results_plain``: ``tools/vis_results.py --video`` on the overlay
    fixture of ``tests/torch_vis`` (the plain run, three 1200x1920 frames,
    30 fps).

``tests/test_torch_video.py`` holds what cv2 reads back from each file
against the JAX package's ``make_video`` (cv2's ``mp4v`` writer) on the
same frame files, and the bytes, written in a child without cv2
(``port_child.py``), against ``digests.json``; ``chip_smoke.py`` phase
``image_io`` holds the card's host to the same digests.

    JAX_PLATFORMS=cpu python -m tests.torch_video.fixture

rewrites ``digests.json`` from a cv2-blocked run of the port; a change of
the encoder changes the digests, and the read-back bounds of the tests must
still hold.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parents[1]
DIGESTS = HERE / "digests.json"
# name -> (frame size, frames, fps, seed); ntsc reuses synthetic's frames
SEQUENCES = {
    "synthetic": ((240, 384), 26, 30.0, 0),
    "odd": ((121, 161), 5, 30.0, 1),
    "ntsc": ((240, 384), 5, 29.97, 0),
}
VIDEOS = (*SEQUENCES, "vis_results_plain")
PAN = 3


def _box_blur(a: np.ndarray, k: int) -> np.ndarray:
    """The k x k mean (floored) of each window of a [h, w, c] array: the
    result is (h - k + 1) x (w - k + 1)."""
    c = np.pad(a.astype(np.int64).cumsum(0).cumsum(1), ((1, 0), (1, 0), (0, 0)))
    s = c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]
    return s // (k * k)


def make_frames(name: str) -> list:
    """The [h, w, 3] uint8 BGR frames of a sequence."""
    (h, w), n, _, seed = SEQUENCES[name]
    rng = np.random.default_rng(seed)
    width = w + PAN * n
    coarse = rng.integers(0, 256, (h // 8 + 3, width // 8 + 3, 3))
    texture = _box_blur(np.kron(coarse, np.ones((8, 8, 1), np.int64)), 9)[:h, :width]
    background = np.clip(texture + rng.integers(-10, 11, (h, width, 3)), 0, 255).astype(np.uint8)
    boxes = [(rng.integers(0, h - 40), rng.integers(0, w - 60), rng.integers(12, 40),
              rng.integers(16, 60), rng.integers(0, 256, 3), rng.integers(-3, 4),
              rng.integers(-4, 5)) for _ in range(4)]
    frames = []
    for t in range(n):
        frame = background[:, PAN * t:PAN * t + w].copy()
        for y, x, bh, bw, colour, vy, vx in boxes:
            y0, x0 = int(np.clip(y + vy * t, 0, h - bh)), int(np.clip(x + vx * t, 0, w - bw))
            frame[y0:y0 + bh, x0:x0 + bw] = colour
        frames.append(frame)
    return frames


def write_frames(out_dir: Path) -> dict:
    """Each sequence's frames as PNG files under ``out_dir/frames/<name>``;
    returns name -> (paths, fps)."""
    from streamyolo_torch.data.image_io import imwrite

    inputs = {}
    for name, (_, n, fps, _) in SEQUENCES.items():
        source = "synthetic" if name == "ntsc" else name
        folder = out_dir / "frames" / source
        if not folder.exists():
            folder.mkdir(parents=True)
            for i, frame in enumerate(make_frames(source)):
                imwrite(str(folder / f"{i:06d}.png"), frame)
        inputs[name] = (sorted(str(p) for p in folder.glob("*.png"))[:n], fps)
    return inputs


def video_path(out_dir: Path, name: str) -> Path:
    if name == "vis_results_plain":
        return out_dir / "tool" / "plain" / "seq00.mp4"
    return out_dir / "videos" / f"{name}.mp4"


def tool_frames(out_dir: Path) -> list:
    """The frames the port's ``vis_results`` drew for its video."""
    return sorted(str(p) for p in (out_dir / "tool" / "plain" / "seq00").glob("*.jpg"))


def write_port_videos(out_dir: Path) -> dict:
    """The port's ``make_video`` on each sequence and its ``vis_results
    --video`` on the overlay fixture, under ``out_dir``; returns the
    files' sha256 by name."""
    import contextlib
    import io

    from streamyolo_torch.tools import vis_results
    from streamyolo_torch.vis import make_video
    from tests.torch_vis import fixture as overlay

    for name, (paths, fps) in write_frames(out_dir).items():
        make_video(paths, str(video_path(out_dir, name)), fps=fps)
    results = overlay.write_results(out_dir / "results")
    with contextlib.redirect_stdout(io.StringIO()):
        vis_results.main(overlay.tool_args("plain", out_dir / "tool" / "plain", results)
                         + ["--video"])
    return {name: hashlib.sha256(video_path(out_dir, name).read_bytes()).hexdigest()
            for name in VIDEOS}


def run_port_child(out_dir: Path) -> dict:
    """``port_child.py`` in a child process (cv2 blocked); its report."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, "-m", "tests.torch_video.port_child", str(out_dir)],
                   cwd=REPO, env=env, check=True, stdout=subprocess.DEVNULL)
    return json.loads((out_dir / "report.json").read_text())


def main():
    with tempfile.TemporaryDirectory() as tmp:
        report = run_port_child(Path(tmp))
    assert report["cv2_loaded"] is False
    DIGESTS.write_text(json.dumps(report["videos"], indent=1, sort_keys=True) + "\n")
    print(f"wrote {DIGESTS}")


if __name__ == "__main__":
    main()
