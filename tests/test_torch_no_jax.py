"""The port imports neither JAX nor the JAX package, nor cv2 (which the
card's machine lacks): a fresh interpreter in which ``import jax``,
``import flax``, ``import streamyolo_tpu`` and ``import cv2`` fail imports
every module of ``streamyolo_torch`` (``parallel``, ``parallel/spatial.py``,
``utils/aot.py``, ``tools/precompile.py``, ``tools/export_safetensors.py``, the augmentation
path's ``data/cv2_ops.py``, ``vis`` and ``tools/vis_results.py`` among
them), ``chip_smoke.py`` and the tests' fresh-process helper
``tests/_torch_aot_child.py``."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = """
import importlib, pkgutil, sys
for name in ("jax", "flax", "streamyolo_tpu", "cv2"):
    sys.modules[name] = None  # any import of them raises ImportError
import streamyolo_torch
names = sorted(m.name for m in pkgutil.walk_packages(streamyolo_torch.__path__, "streamyolo_torch."))
assert {"streamyolo_torch.parallel", "streamyolo_torch.parallel.multihost",
        "streamyolo_torch.parallel.spatial",
        "streamyolo_torch.utils.aot", "streamyolo_torch.tools.precompile",
        "streamyolo_torch.tools.export_safetensors", "streamyolo_torch.data.cv2_ops",
        "streamyolo_torch.data.mosaic", "streamyolo_torch.vis",
        "streamyolo_torch.tools.vis_results", "streamyolo_torch.tools.augment_check",
        "streamyolo_torch.utils.wandb_logger", "streamyolo_torch.version"} <= set(names), names
for name in names:
    importlib.import_module(name)
import chip_smoke
sys.path.insert(0, "tests")
import _torch_aot_child
leaked = sorted(n for n in sys.modules
                if n.split(".")[0] in ("jax", "jaxlib", "flax", "streamyolo_tpu", "cv2")
                and sys.modules[n] is not None)
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) > 40  # every module was walked
