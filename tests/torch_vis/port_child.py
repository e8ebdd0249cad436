"""The port's side of ``tests/test_torch_vis_draw.py``'s comparisons, run
in a child process in which cv2 cannot be imported:

    python -m tests.torch_vis.port_child OUT_DIR

draws the ``DETECTION_CASES`` with ``draw_detections``, ``vis_det`` and
``vis_track`` (arrays to ``OUT_DIR/arrays.npz``, files under
``OUT_DIR/files``), runs the port's ``tools/vis_results.py`` for every run
of ``fixture.RUNS`` (under ``OUT_DIR/tool``) and writes
``OUT_DIR/report.json`` with the files' digests and whether cv2 was
loaded."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np


def detection_cases():
    """(name, image, boxes, labels, scores, tracks, out_scale): a noisy
    480x640 frame under boxes over every edge, zero-width, inverted and
    outside ones, every class name, labels clamped to the top."""
    from streamyolo_torch.data.argoverse_classes import ARGOVERSE_CLASSES

    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
    boxes = [[10.4, 5.2, 120.6, 80.1], [-20.0, 100.0, 60.0, 160.0], [600.2, 200.7, 700.0, 260.0],
             [300.0, -15.0, 380.0, 30.0], [200.0, 450.0, 260.0, 520.0], [700.0, 500.0, 760.0, 560.0],
             [50.0, 300.0, 50.0, 340.0], [420.0, 400.0, 380.0, 360.0], [630.0, 12.0, 700.0, 40.0]]
    boxes += [[float(x), float(y), float(x + w), float(y + h)]
              for x, y, w, h in zip(rng.uniform(0, 600, 12), rng.uniform(0, 440, 12),
                                    rng.uniform(4, 200, 12), rng.uniform(4, 150, 12))]
    labels = [i % (len(ARGOVERSE_CLASSES) + 1) for i in range(len(boxes))]  # one past the names
    scores = [round(float(s), 3) for s in rng.uniform(0.0, 1.0, len(boxes))]
    tracks = [int(t) for t in rng.integers(0, 1000, len(boxes))]
    names = list(ARGOVERSE_CLASSES)
    for out_scale in (1.0, 0.75):
        yield f"plain_{out_scale}", img, boxes, labels, names, None, None, out_scale
        yield f"scored_{out_scale}", img, boxes, labels, names, scores, None, out_scale
        yield f"tracked_{out_scale}", img, boxes, labels, names, scores, tracks, out_scale


def main(out_dir: Path) -> None:
    sys.modules["cv2"] = None  # the port must not need it
    from streamyolo_torch import vis
    from streamyolo_torch.tools import vis_results
    from tests.torch_vis import fixture

    arrays = {}
    for name, img, boxes, labels, names, scores, tracks, out_scale in detection_cases():
        kw = dict(scores=scores, out_scale=out_scale)
        arrays[f"draw_{name}"] = vis.draw_detections(img, boxes, labels, names, tracks=tracks,
                                                     score_th=0.3, **kw)
        if tracks is None:
            arrays[f"vis_det_{name}"] = vis.vis_det(
                img, boxes, labels, names, score_th=0.3,
                out_file=str(out_dir / "files" / f"vis_det_{name}.jpg"), **kw)
        else:
            arrays[f"vis_track_{name}"] = vis.vis_track(
                img, boxes, tracks, labels, names,
                out_file=str(out_dir / "files" / f"vis_track_{name}.png"), **kw)
    np.savez(out_dir / "arrays.npz", **arrays)
    results = fixture.write_results(out_dir / "results")
    tool = {}
    for run in fixture.RUNS:
        vis_results.main(fixture.tool_args(run, out_dir / "tool" / run, results))
        tool[run] = fixture.file_digests(out_dir / "tool" / run)
    report = dict(tool=tool, cv2_loaded=sys.modules.get("cv2") is not None)
    (out_dir / "report.json").write_text(json.dumps(report))


if __name__ == "__main__":
    main(Path(sys.argv[1]))
