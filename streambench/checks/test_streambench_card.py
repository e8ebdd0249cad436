"""Every cell of ``BENCHMARK.json`` once on the card, a short window each:
the command exits 0 and its result line says ``correct``. Needs an NVIDIA
card (and ``nvcc`` for the port's kernels); skipped without one:

    python -m pytest streambench/checks/test_streambench_card.py -m cuda
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run(
        [sys.executable, "-m", "streambench.run", "--workload", workload,
         "--seed", str(2 ** 32 + 7), "--seconds", "3", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
