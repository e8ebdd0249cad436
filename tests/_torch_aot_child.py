"""A fresh process of ``tests/test_torch_aot*.py``: export the serving graphs
of a tiny model, or serve from them (imports neither JAX nor the JAX
package, so it also runs on the card's machine).

    python tests/_torch_aot_child.py export|serve DIR [--poison-nvcc]

``DIR/setup.pt`` holds the state dict, the detector keywords, the device
and the frames. ``export`` writes the graph manifests (and, on a card, the
kernel libraries) for one stream and for ``MULTI_N`` streams, then the
eager detectors' rows of the chains to ``DIR/want.npz``. ``serve`` builds
detectors with ``aot_dir=DIR``, requires ``aot_loaded``, and writes their
rows to ``DIR/got.npz``. ``--poison-nvcc``: ``ops/_build.py`` finds no
build directory and no ``nvcc``, so every kernel must come from ``DIR``.
Prints ``CHILD_OK`` at the end.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

MULTI_N, SINGLE_RESET_AT, MULTI_RESET_AT, MULTI_RESET_ROW = 3, 4, 3, 1


def run(mode, aot_dir, *flags) -> None:
    """Run this script as ``mode`` on ``aot_dir`` in a fresh interpreter;
    raises ``AssertionError`` with its output unless it ends ``CHILD_OK``."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["OMP_NUM_THREADS"] = "1"  # tiny tensors; the suite runs in several workers
    proc = subprocess.run([sys.executable, __file__, mode, str(aot_dir), *flags], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0 and "CHILD_OK" in proc.stdout, (proc.stdout, proc.stderr[-3000:])


def tiny_port(state_dict):
    from streamyolo_torch.models import DFPPAFPN, StreamYOLO, TALHead

    model = StreamYOLO(DFPPAFPN(0.33, 0.25), TALHead(num_classes=8, width=0.25))
    model.load_state_dict(state_dict, strict=True)
    return model.eval()


def run_chains(single, multi, frames, multi_frames):
    """Rows of the single-stream chain (``reset()`` before frame
    ``SINGLE_RESET_AT``) and of the multi-stream chain (``reset(1)`` before
    step ``MULTI_RESET_AT``), each [steps, ...] float32."""
    rows = []
    single.reset()
    for i, frame in enumerate(frames):
        if i == SINGLE_RESET_AT:
            single.reset()
        single(frame, preprocessed=True)
        rows.append(single.last_rows.copy())
    mrows = []
    multi.reset()
    for i, batch in enumerate(multi_frames):
        if i == MULTI_RESET_AT:
            multi.reset(MULTI_RESET_ROW)
        multi(batch, preprocessed=True)
        mrows.append(multi.last_rows.copy())
    return np.stack(rows), np.stack(mrows)


def main(argv) -> int:
    mode, aot_dir = argv[0], argv[1]
    if "--poison-nvcc" in argv:
        from streamyolo_torch.ops import _build

        _build.BUILD_DIR = Path(tempfile.mkdtemp()) / "no_builds"

        def no_nvcc():
            raise RuntimeError("nvcc is not to be run in the serving process")

        _build.nvcc_path = no_nvcc
    from streamyolo_torch.stream import (CUDAStreamDetector, MultiStreamDetector,
                                         export_multi_stream_executables,
                                         export_stream_executables)

    setup = torch.load(os.path.join(aot_dir, "setup.pt"), weights_only=False)
    kw, device = setup["kw"], setup["device"]
    model = tiny_port(setup["state_dict"]).to(setup["dtype"])
    single_kw = dict(kw, device_preproc=setup["device_preproc"])
    if mode == "export":
        exp_kw = {k: v for k, v in kw.items() if k != "in_scale"}
        export_stream_executables(model, aot_dir, device=device,
                                  device_preproc=setup["device_preproc"], **exp_kw)
        export_multi_stream_executables(model, aot_dir, n_streams=MULTI_N, device=device,
                                        **exp_kw)
        single = CUDAStreamDetector(model, device=device, **single_kw)
        multi = MultiStreamDetector(model, MULTI_N, device=device, **kw)
        out = "want.npz"
    else:
        single = CUDAStreamDetector(model, device=device, aot_dir=aot_dir, **single_kw)
        multi = MultiStreamDetector(model, MULTI_N, device=device, aot_dir=aot_dir, **kw)
        if not (single.aot_loaded and multi.aot_loaded):
            print(f"aot_loaded: single {single.aot_loaded}, multi {multi.aot_loaded}")
            return 1
        out = "got.npz"
    rows, mrows = run_chains(single, multi, setup["frames"], setup["multi_frames"])
    np.savez(os.path.join(aot_dir, out), rows=rows, mrows=mrows)
    print("CHILD_OK")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
