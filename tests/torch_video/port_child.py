"""The port's side of ``tests/test_torch_video.py``, run in a child process
in which cv2 cannot be imported:

    python -m tests.torch_video.port_child OUT_DIR

writes every video of ``fixture.VIDEOS`` under ``OUT_DIR`` (the frames
first) and ``OUT_DIR/report.json`` with the files' sha256 and whether cv2
was loaded."""

from __future__ import annotations

import json
import sys
from pathlib import Path


def main(out_dir: Path) -> None:
    sys.modules["cv2"] = None  # the port must not need it
    from tests.torch_video import fixture

    videos = fixture.write_port_videos(out_dir)
    report = dict(videos=videos, cv2_loaded=sys.modules.get("cv2") is not None)
    (out_dir / "report.json").write_text(json.dumps(report))


if __name__ == "__main__":
    main(Path(sys.argv[1]))
