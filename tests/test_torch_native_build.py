"""The port's libraries build once across processes.

Three processes started together each load a library into one fresh build
directory, with a wrapper of the compiler first on ``PATH`` that logs every
call: ``g++`` for ``streamyolo_torch/native`` (here on the CPU), a stand-in
``nvcc`` for the lock of ``ops/_build.py::build_all`` (here), and the real
``nvcc`` on the card (``-m cuda``). One process compiles while the others
wait on its ``flock`` and then load its file; a build that fails raises in
every process and leaves no library or temporary file behind.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from .torch_port_helpers import child_env, require_cuda

REPO = Path(__file__).resolve().parents[1]
N_PROCS = 3

# each process imports, says it is ready, and calls ``load`` once all are
CHILD = """
import json, os, sys, time
from pathlib import Path
import numpy as np
kind, build_dir, ready = sys.argv[1], Path(sys.argv[2]), Path(sys.argv[3])
if kind == "native":
    from streamyolo_torch import native as mod
else:
    from streamyolo_torch.ops import _build as mod
mod.BUILD_DIR = build_dir
(ready / str(os.getpid())).touch()
while len(os.listdir(ready)) < int(sys.argv[4]):
    time.sleep(0.01)
try:
    if kind == "native":
        lib = mod.load()
        iou = mod.bbox_iou_ltwh_cpp(np.array([[0.0, 0.0, 10.0, 10.0]]),
                                    np.array([[5.0, 0.0, 10.0, 10.0]]), np.zeros(1))
        out = {"path": lib._name, "iou": iou.tolist()}
    elif kind == "nvcc_stand_in":
        out = {"paths": {n: r["path"] for n, r in mod.build_all().items()}}
    else:
        out = {"paths": {n: mod.library_path(n) for n in mod.SOURCES}}
except Exception as e:
    out = {"error": type(e).__name__, "message": str(e)}
print(json.dumps(out))
"""

# logs its arguments, then runs the real compiler ("run"), writes a
# partial output file and fails ("fail"), or writes a placeholder ("stub")
WRAPPER = """#!/bin/sh
echo "$@" >> {log}
out=""; prev=""
for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done
case {mode} in
  fail) printf partial > "$out"; echo "{name}: simulated failure" >&2; exit 1 ;;
  stub) sleep 1; printf stub > "$out" ;;
  *) exec {real} "$@" ;;
esac
"""


def wrapper_path(tmp_path, name: str, mode: str, real: str = ""):
    """A directory holding the wrapper ``name``, and the wrapper's log."""
    bin_dir, log = tmp_path / "bin", tmp_path / f"{name}.log"
    bin_dir.mkdir()
    wrapper = bin_dir / name
    wrapper.write_text(WRAPPER.format(log=log, name=name, mode=mode, real=real))
    wrapper.chmod(0o755)
    return bin_dir, log


def run_together(tmp_path, kind: str, bin_dir: Path, timeout: int = 600):
    """``N_PROCS`` children of ``CHILD`` loading into ``tmp_path/build``;
    returns their JSON lines."""
    build_dir, ready = tmp_path / "build", tmp_path / "ready"
    ready.mkdir()
    env = child_env(1)
    env["PATH"] = f"{bin_dir}{os.pathsep}{env['PATH']}"
    env.pop("PYTHONSTARTUP", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD, kind, str(build_dir), str(ready), str(N_PROCS)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(N_PROCS)]
    outs = []
    for proc in procs:
        stdout, stderr = proc.communicate(timeout=timeout)
        assert proc.returncode == 0, stderr[-3000:]
        outs.append(json.loads(stdout.strip().splitlines()[-1]))
    return outs, build_dir


def compiles(log: Path) -> list:
    return log.read_text().splitlines() if log.exists() else []


def test_native_library_builds_once_for_three_processes(tmp_path):
    """One ``g++`` for three processes; all load its file, and it works."""
    bin_dir, log = wrapper_path(tmp_path, "g++", "run", shutil.which("g++"))
    outs, build_dir = run_together(tmp_path, "native", bin_dir)
    assert len(compiles(log)) == 1, compiles(log)
    assert all("error" not in o for o in outs), outs
    paths = {o["path"] for o in outs}
    assert len(paths) == 1 and Path(paths.pop()).parent == build_dir
    assert all(o["iou"] == [[pytest.approx(1 / 3, abs=1e-12)]] for o in outs)
    assert not list(build_dir.glob("*.tmp"))


def test_failed_native_build_raises_in_every_process(tmp_path):
    """Each process, finding no library once the lock is free, builds it
    itself (one at a time) and raises the compiler's error."""
    bin_dir, log = wrapper_path(tmp_path, "g++", "fail")
    outs, build_dir = run_together(tmp_path, "native", bin_dir)
    assert [o.get("error") for o in outs] == ["NativeBuildError"] * N_PROCS, outs
    assert all("g++: simulated failure" in o["message"] for o in outs)
    assert len(compiles(log)) == N_PROCS
    assert not list(build_dir.glob("*.so")) and not list(build_dir.glob("*.tmp"))


def test_kernel_build_lock_with_a_stand_in_nvcc(tmp_path):
    """``build_all``'s lock on the CPU: a stand-in ``nvcc`` that writes a
    placeholder file (``build_all`` compiles and renames; it loads nothing).
    One compile per source for three processes, the same files for all."""
    from streamyolo_torch.ops import _build

    bin_dir, log = wrapper_path(tmp_path, "nvcc", "stub")
    outs, build_dir = run_together(tmp_path, "nvcc_stand_in", bin_dir)
    assert all("error" not in o for o in outs), outs
    sources = sorted(line.split()[-1] for line in compiles(log))
    assert sources == sorted(str(_build.CSRC / f"{n}.cu") for n in _build.SOURCES)
    assert len({json.dumps(o["paths"], sort_keys=True) for o in outs}) == 1
    assert sorted(p.name for p in build_dir.glob("*.so")) == sorted(
        Path(p).name for p in outs[0]["paths"].values())
    assert not list(build_dir.glob("*.tmp"))


@pytest.mark.cuda
def test_kernels_build_once_for_three_processes_on_the_card(tmp_path):
    """The real ``nvcc``: three processes loading every kernel run one
    ``nvcc`` per source between them and load the same files."""
    require_cuda()
    from streamyolo_torch.ops import _build

    bin_dir, log = wrapper_path(tmp_path, "nvcc", "run", _build.nvcc_path())
    outs, build_dir = run_together(tmp_path, "kernels", bin_dir, timeout=900)
    assert all("error" not in o for o in outs), outs
    assert len(compiles(log)) == len(_build.SOURCES), compiles(log)
    assert len({json.dumps(o["paths"], sort_keys=True) for o in outs}) == 1
    assert not list(build_dir.glob("*.tmp"))
