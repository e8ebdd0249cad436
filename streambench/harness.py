"""What every cell's run shares: reading ``BENCHMARK.json`` and the cell's
files, the card check, the metric readers, and the result line.

A cell names a configuration (``streambench/configs/<file>``), a traffic
mix (``streambench/traffic/<traffic>.json``, whose ``kind`` names the
runner ``streambench/kinds/<kind>.py``) and has its correctness limits in
``streambench/limits/<workload>.json`` (``compare``: each compared number's
limit; ``score_margin``: the rounding of the served scores that
``reference/judge.py`` allows a candidate's selection). Each metric, end-to-end or
per-layer, is read by ``streambench/metrics/<name>.py``'s ``read(rec)``
from the record the runner fills; a reader that finds nothing to read
returns None and the metric is left out of the line.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict, Optional

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "streamyolo_tpu")


class NoCard(SystemExit):
    """The run needs more cards than this machine shows: exit 2, no result."""

    def __init__(self, msg: str):
        print(msg, file=sys.stderr, flush=True)
        super().__init__(2)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    limits: Optional[dict]


def load_cell(bench: dict, workload: str) -> Cell:
    """The cell ``workload`` of ``bench`` with its configuration, traffic
    and limits read from their files."""
    by_name = {w["name"]: w for w in bench["workloads"]}
    if workload not in by_name:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    w = by_name[workload]
    config_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(ROOT / config_entry["file"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    limits_file = HERE / "limits" / f"{workload}.json"
    limits = load_json(limits_file) if limits_file.exists() else None
    return Cell(w, config, traffic, limits)


def require_cards(n: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise NoCard("no CUDA card: the benchmark measures the card and does not run elsewhere")
    if torch.cuda.device_count() < n:
        raise NoCard(f"the cell needs {n} cards, this machine shows "
                     f"{torch.cuda.device_count()}")


def runner(kind: str):
    """The module ``streambench.kinds.<kind>``."""
    return importlib.import_module(f"streambench.kinds.{kind}")


def reader(name: str) -> Callable[[dict], Optional[float]]:
    """``read`` of ``streambench/metrics/<name>.py`` (names hold dots, so
    the file is loaded by its path)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"streambench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics_of(bench: dict, workload: str, trace: bool):
    """The metric entries this cell reports: its end-to-end metrics, or with
    ``trace`` its per-layer ones (those that list the cell, or list no
    cells and move an end-to-end metric the cell reports)."""
    def applies(m):
        return workload in m["workloads"] if "workloads" in m else True

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]


def read_metrics(entries, rec: dict) -> Dict[str, dict]:
    out = {}
    for m in entries:
        value = reader(m["name"])(rec)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is the JAX
    package's or one of JAX's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def device_info(device, chips: int) -> dict:
    import torch

    index = device.index or 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    lines = smi.stdout.strip().splitlines()
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(index), "count": chips,
            "nvidia_smi": lines[index] if index < len(lines) else smi.stderr.strip()}


def checks(readings: Dict[str, float], limits: Optional[dict]):
    """(all within their limits, {name: {value, limit}}) of the numbers the
    cell's limits name; a number not read, or not finite, fails, and a cell
    without limits is not correct."""
    if not limits:
        return False, {}
    out, ok = {}, True
    for name, limit in limits["compare"].items():
        value = readings.get(name, float("nan"))
        out[name] = {"value": value, "limit": limit}
        if not math.isfinite(value) or value > limit:
            ok = False
    return ok, out


def emit(result: dict, compared: Dict[str, dict]) -> None:
    """The compared numbers beside their limits as the last lines on
    standard error, then the result line (``checks`` its last key) as the
    last line on standard output."""
    for name, c in compared.items():
        if not math.isfinite(c["value"]):
            c["value"] = repr(c["value"])  # JSON has no NaN or infinity
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps({**result, "checks": compared}), flush=True)
