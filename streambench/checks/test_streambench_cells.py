"""Whole runs of tiny cells on the CPU, the card check skipped: a cell
added from new files alone runs; the sound program comes out correct; the
control (the reference in float8 in the program's place) and every fault
planted in the timed path come out not correct."""

import json

import pytest

import streambench_tiny as tiny
from streambench.reference.control import Fp8Ops
from streambench.reference.model import PlainOps
from streambench.control import stand_in


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    d = tmp_path_factory.mktemp("checkout")
    before = {p: p.read_bytes() for p in (tiny.REPO / "streambench").rglob("*") if p.is_file()}
    tiny.add_tiny_cells(d, tiny.copy_bench(d))
    after = {p: p.read_bytes() for p in (tiny.REPO / "streambench").rglob("*") if p.is_file()}
    assert before == after  # the cells were added to the copy, nothing of the repo edited
    with tiny.checkout(d):
        yield d


@pytest.mark.parametrize("workload", sorted(tiny.CELLS))
@pytest.mark.parametrize("trace", [0, 1])
def test_new_cell_runs_from_files_alone(checkout, workload, trace):
    res = tiny.run_cell(workload, trace=trace)
    assert set(res) >= {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert list(res)[-1] == "checks"
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    if not trace:
        names = {m["name"] for m in bench["end_to_end"]
                 if workload in m.get("workloads", [workload])}
        assert set(res["metrics"]) == names
    else:  # no card: no device metric is written
        assert res["metrics"] == {}


@pytest.mark.parametrize("ops,correct", [(PlainOps(), True), (Fp8Ops(), False)],
                         ids=["cams-plain", "cams-fp8"])
def test_control_fails(checkout, ops, correct):
    res = tiny.run_cell("tiny-cams", system=stand_in("cameras", ops))
    assert res["correct"] is correct, res["checks"]


FAULTS = {
    "tiny-cams": {
        "state unchanged": tiny.detector_fault(tiny.StaleState),
        "half the batch": tiny.detector_fault(tiny.AlteredRows, tiny.half_batch_rows),
        "box altered": tiny.detector_fault(tiny.AlteredRows, tiny.altered_box_rows),
        "keep flipped": tiny.detector_fault(tiny.AlteredRows, tiny.flipped_keep_rows),
        "sort key obj": tiny.detector_fault(tiny.WrongSelection, False),
        "candidates by obj": tiny.detector_fault(tiny.WrongSelection, True)},
}
# the number each fault has to fail, besides coming out not correct
FAILS = {"sort key obj": "order_breaks", "candidates by obj": "missed_candidates"}


@pytest.mark.parametrize("workload,fault", [(w, f) for w in FAULTS for f in FAULTS[w]])
def test_fault_fails(checkout, workload, fault):
    res = tiny.run_cell(workload, system=FAULTS[workload][fault])
    assert res["correct"] is False, res["checks"]
    if fault in FAILS:
        c = res["checks"][FAILS[fault]]
        assert c["value"] > c["limit"], res["checks"]
