"""``BENCHMARK.json`` against the benchmark's contract, and every file it
names present."""

import json
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "projection", "head", "expansion",
               "width")
CELLS = {w["name"]: w for w in BENCH["workloads"]}


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) for p in BENCH["paths"])
    assert all(not p.startswith("/") and ".." not in p.split("/") for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32 and all(one_line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_run_seconds_fit_a_full_check_of_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and one_line(entry["why"]) and one_line(entry["source"])
    assert entry["source"].startswith("https://")
    assert (REPO / entry["file"]).is_file()
    assert any(entry["file"].startswith(p + "/") for p in BENCH["paths"])
    assert len(entry["reduced"]) <= 16
    assert not any(w in k for k in entry["reduced"] for w in WIDTH_WORDS)
    assert not any(k.endswith(("_dim", "_rank")) for k in entry["reduced"])
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])
    assert json.loads((REPO / entry["file"]).read_text())["name"] == entry["name"]


def test_config_files_distinct():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"]) and one_line(cell["why"])
    assert cell["chips"] in (1, 4)
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}
    sb = REPO / "streambench"
    traffic = json.loads((sb / "traffic" / f"{cell['traffic']}.json").read_text())
    assert (sb / "kinds" / f"{traffic['kind']}.py").is_file()
    assert (sb / "limits" / f"{cell['name']}.json").is_file()
    e2e = [m["name"] for m in BENCH["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(cell["name"] in m.get("workloads", []) for m in BENCH["per_layer"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_limits_file(cell):
    """Each compared number has a finite limit >= 0; the counts are exact."""
    limits = json.loads((REPO / "streambench" / "limits" / f"{cell['name']}.json").read_text())
    assert set(limits) == {"compare", "score_margin"} and limits["score_margin"] > 0
    assert all(isinstance(v, (int, float)) and v >= 0 for v in limits["compare"].values())
    for count in ("keep_mismatch", "order_breaks", "missed_candidates"):
        assert limits["compare"][count] == 0


def test_cells_and_names_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for group in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[group]]
        assert len(set(names)) == len(names)
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("metric", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(metric):
    assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25
    assert all(w in CELLS for w in metric.get("workloads", []))
    assert (REPO / "streambench" / "metrics" / f"{metric['name']}.py").is_file()


def test_setup_metric_present():
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert setup and "workloads" not in setup[0] and setup[0]["bound"] <= 0.25


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric(metric):
    assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"]) and one_line(metric["layer"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    moved = {m["name"]: m for m in BENCH["end_to_end"]}[metric["moves"]]
    for cell in metric["workloads"]:  # each cell reports the metric it moves
        assert cell in CELLS
        assert cell in moved.get("workloads", [cell])
    if "roofline" in metric["name"] or "mfu" in metric["name"]:
        assert metric["unit"] == "%"
    assert (REPO / "streambench" / "metrics" / f"{metric['name']}.py").is_file()


def test_layers_named_alike():
    """Metrics of one layer give it the same name, letter for letter."""
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert len({x.lower() for x in layers}) == len(layers)


def test_command_names_only_files_under_paths():
    for word in BENCH["command"][1:]:
        if "/" in word or word.endswith(".py"):
            assert any(word.startswith(p + "/") for p in BENCH["paths"])
    assert BENCH["command"][-1].split(".")[0] in BENCH["paths"]
