"""The benchmark of ``streamyolo_torch`` on NVIDIA cards: one run of one cell.

    python3 -m streambench.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. Reads the cell from ``BENCHMARK.json``, builds
the port's system with seeded weights on the card, warms up the cell's
shapes (set-up, ``setup_s``), measures for ``--seconds``, then judges what
the timed path produced against the plain float32 reference
(``reference/``). Prints, as the last line of standard output, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks`` (each compared number
with its limit, also the last lines of standard error, after one line of
every reading of the comparison, compared or not).

Without a CUDA card, or with fewer than the cell asks for, it exits 2 and
prints no result. It exits 3 and prints no result if JAX or the JAX package
was loaded. Every cache it builds lies in the checkout (the port's kernels
under ``build/kernels/``).
"""

import time

T_START = time.perf_counter()  # set-up counts from here, before torch is imported

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, system=None, device=None) -> int:
    """One run. ``system`` and ``device`` are for the harness's own tests,
    which drive a run on the CPU with a stand-in for the program."""
    args = parse(argv)
    from streambench import harness

    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = harness.load_cell(bench, args.workload)
    import torch

    if device is None:
        harness.require_cards(cell.workload["chips"])
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    rec = harness.runner(cell.traffic["kind"]).run(
        cell, args.seed, args.seconds, bool(args.trace), device, T_START, system)

    found = harness.forbidden_modules()
    if found:
        print(f"JAX or the JAX package was loaded: {found}", file=sys.stderr, flush=True)
        return 3
    if device.type == "cuda":
        dev = harness.device_info(device, cell.workload["chips"])
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1}
    dev["memory_peak_bytes"] = rec["memory_peak_bytes"]
    entries = harness.metrics_of(bench, args.workload, bool(args.trace))
    result = {"attempted": rec["attempted"], "failed": rec["failed"],
              "metrics": harness.read_metrics(entries, rec), "device": dev}
    if args.trace and "trace" in rec:
        from streambench import trace

        dev["busy_s"] = rec["trace"]["busy_s"]
        dev["window_s"] = rec["trace"]["window_s"]
        result["breakdown"] = trace.breakdown(rec["trace"])
    ok, compared = harness.checks(rec["readings"], cell.limits)
    result = {"correct": ok and rec["failed"] == 0, **result}
    for line in rec.get("notes", []):
        print(line, file=sys.stderr)
    print(f"readings {json.dumps(rec['readings'])}", file=sys.stderr)  # compared or not
    harness.emit(result, compared)
    return 0


if __name__ == "__main__":
    sys.exit(main())
