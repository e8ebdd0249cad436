"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program. Names are compared by their whole
top-level part: ``streamyolo_torch`` begins with ``streamyolo_t``, and is
no match of ``streamyolo_tpu``."""

import subprocess
import sys
from pathlib import Path

from streambench import harness

REPO = Path(__file__).resolve().parents[2]


def test_forbidden_names_compared_whole(monkeypatch):
    fake = dict.fromkeys(["jaxtyping", "streamyolo_torch.ops", "flaxen", "jaxlib_x"])
    monkeypatch.setattr(sys, "modules", {**sys.modules, **fake})
    found = harness.forbidden_modules()
    assert not set(found) & set(fake)
    monkeypatch.setattr(sys, "modules", {**sys.modules, "jax.numpy": None,
                                         "streamyolo_tpu.ops": None, "flax": None})
    assert {"jax.numpy", "streamyolo_tpu.ops", "flax"} <= set(harness.forbidden_modules())


def _loaded_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=REPO, capture_output=True, text=True, timeout=300, check=True)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_program():
    top = _loaded_after("import streambench.reference.model, streambench.reference.judge, "
                        "streambench.reference.postprocess, streambench.reference.control, "
                        "streambench.reference.precision")
    assert not top & {"streamyolo_torch", "streamyolo_tpu", "jax", "jaxlib", "flax"}


def test_reference_sources_name_no_program():
    for path in (REPO / "streambench" / "reference").glob("*.py"):
        src = path.read_text()
        assert "import streamyolo" not in src and "from streamyolo" not in src, path


def test_a_run_loads_no_jax():
    """A whole tiny run on the CPU, the port included, in a fresh process."""
    code = ("import tempfile, pathlib, sys\n"
            "sys.path.insert(0, 'streambench/checks')\n"
            "import streambench_tiny as t\n"
            "d = pathlib.Path(tempfile.mkdtemp())\n"
            "t.add_tiny_cells(d, t.copy_bench(d))\n"
            "with t.checkout(d):\n"
            "    assert t.run_cell('tiny-cams')['correct']\n")
    top = _loaded_after(code)
    assert "streamyolo_torch" in top
    assert not top & set(harness.FORBIDDEN)
