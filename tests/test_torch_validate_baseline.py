"""The port's ``tools/eval.py --int8`` and ``tools/validate_baseline.py``
against the JAX package's tools, on the CPU, on the textured fake
Argoverse-HD fixture (raw 60x96, test size 30x48; its annotations are the
float model's own top detections) with the same ``.pth`` weights
(JAX-initialised, depth 0.33, width 0.25, obj/cls prediction biases lifted
to 0). Bounds: the float path's AP, AP50 and sAP75 within 0.1 points of the
JAX tools', the bound of ``tests/test_torch_eval.py``; the int8 path's AP50
within 0.1 and AP within ``INT8_AP_TOL`` points.

Why int8's AP gets a wider bound: each package calibrates with its own
float32 trunk, and their absmax values differ in the last bits (within 1e-5,
``tests/test_torch_quant.py``). An ``act_scale`` one ulp apart flips the int8
code of every input that lies within that ulp of a rounding boundary, and
the random weights' scores all sit near 0.25, where such flips reorder rows
and flip NMS decisions. Measured on this fixture: AP50 equal, AP 70.28
against 70.71, 5 of 128 rows unmatched on each side (box-matched, IoU 0.9).
One detection crossing one IoU threshold among the fixture's 24 boxes moves
AP by 1 / 24 / 10 = 0.42 points. Carried over with the JAX package's own
calibration, the port's rows equal JAX's within 1.6e-5 px
(``tests/test_torch_quant.py`` holds the model to that).

The JAX tools run in one fresh interpreter (``run_jax_tools``): the same
environment (``JAX_PLATFORMS``, ``XLA_FLAGS``), float32 matmul precision
pinned as ``tests/conftest.py`` pins it, and nothing of the test worker's
own state (JAX configuration and compilation cache directory, the tools'
modules under their bare names, Python and NumPy state left by earlier
test files on the same worker). On this fixture a last-bit difference in
the JAX trunk reorders scores that all sit near 0.25 and moves AP by
points: in one run under ``pytest-xdist`` the JAX side read float AP
93.25 against the port's 100.0, and int8 AP 65.55 against 70.28, where a
process of its own reads within the bounds."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from streamyolo_tpu.models import DFPPAFPN as JDFPPAFPN
from streamyolo_tpu.models import StreamYOLO as JStreamYOLO
from streamyolo_tpu.models import TALHead as JTALHead
from streamyolo_torch.ops.int8_conv import int8_conv
from streamyolo_torch.tools import eval as tool
from streamyolo_torch.tools import validate_baseline as vb
from streamyolo_torch.utils.weights import jax_variables_to_state_dict

from .torch_port_helpers import lift_pred_biases, write_textured_argoverse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "cfgs", "s_s50_onex_dfp_tal_flip.py")
OPTS = ["depth", "0.33", "width", "0.25", "test_size", "(30, 48)", "data_num_workers", "0"]
# the JAX configs default to the TPU's phase-packed layout, whose Focus stem
# stays float under int8; the port has the raw layout, where it quantizes
JAX_OPTS = OPTS + ["packed", "False"]
INT8_AP_TOL = 0.5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


JAX_CHILD = """
import contextlib, importlib, io, json, sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")
sys.path.insert(0, {tools!r})
results = {{}}
for name, (tool, argv) in {jobs!r}.items():
    sys.argv = [tool + ".py", *argv]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = importlib.import_module(tool).main()
    results[name] = [rc or 0, out.getvalue()]
print(json.dumps(results))
"""


def run_jax_tools(jobs):
    """{name: (exit code, stdout)} of ``tools/<tool>.py`` run with each
    job's argv, in order, in one fresh interpreter (the JAX package's own
    tools, on the CPU)."""
    code = JAX_CHILD.format(tools=os.path.join(REPO, "tools"), jobs=jobs)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return {k: tuple(v) for k, v in json.loads(proc.stdout.strip().splitlines()[-1]).items()}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A ``.pth`` both packages read (JAX through its torch importer)."""
    jmodel = JStreamYOLO(backbone=JDFPPAFPN(0.33, 0.25), head=JTALHead(num_classes=8, width=0.25))
    init = jax.jit(lambda key, x: jmodel.init(key, x, mode="off_pipe"))
    variables = lift_pred_biases(jax.tree_util.tree_map(
        np.asarray, init(jax.random.PRNGKey(3), jnp.zeros((1, 64, 96, 6), jnp.float32))))
    path = tmp_path_factory.mktemp("w") / "s_s50_one_x.pth"
    torch.save(jax_variables_to_state_dict(variables), path)
    return str(path)


@pytest.fixture(scope="module")
def root(tmp_path_factory, weights):
    """The textured fixture, its annotations replaced by the float model's
    own top 3 detections per image (pseudo ground truth), so that AP is far
    from 0 and int8's flips show in it."""
    root = write_textured_argoverse(tmp_path_factory.mktemp("vb"), (5, 3))
    rows = tool.main(["-f", CFG, "-c", weights, "-b", "3", "--device", "cpu", *OPTS,
                      "data_dir", root, "output_dir", str(tmp_path_factory.mktemp("pgt"))])["rows"]
    by_image = {}
    for r in sorted(rows, key=lambda r: -r["score"]):
        by_image.setdefault(r["image_id"], []).append(r)
    anns = [dict(id=i, image_id=r["image_id"], category_id=r["category_id"],
                 bbox=[float(v) for v in r["bbox"]], area=float(r["bbox"][2] * r["bbox"][3]),
                 iscrowd=0)
            for i, r in enumerate(r for rs in by_image.values() for r in rs[:3])]
    for split in ("train.json", "val.json"):
        path = os.path.join(root, "Argoverse-HD", "annotations", split)
        data = json.load(open(path))
        data["annotations"] = anns
        with open(path, "w") as f:
            json.dump(data, f)
    return root


def int8_eval_args(weights, root):
    return ["-c", weights, "-b", "3", "--int8", "--calib-batches", "1", "data_dir", root]


def vb_args(weights_dir, root, weights, expected, int8):
    return ["--weights-dir", str(weights_dir), "--data-dir", root, "-b", "3", "--models", "s",
            "--weights", f"s={weights}", "--expected-json", str(expected),
            "--tolerance", "0.5"] + (["--int8", "--calib-batches", "1"] if int8 else [])


@pytest.fixture(scope="module")
def jax_side(root, weights, tmp_path_factory):
    """The JAX tools on the fixture, in one fresh interpreter: the eval
    CLI's (AP, AP50) under ``--int8``, and ``validate_baseline``'s exit
    code and table with and without ``--int8`` (expected row 29.8)."""
    d = tmp_path_factory.mktemp("jax")
    expected = d / "expected.json"
    expected.write_text(json.dumps({"s": [29.8, 50.3, 29.8]}))
    jobs = {"eval_int8": ("eval", ["-f", CFG, *int8_eval_args(weights, root), *JAX_OPTS,
                                   "output_dir", str(d / "eval")])}
    for int8 in (False, True):
        jobs[f"vb_{int8}"] = ("validate_baseline", [*vb_args(d, root, weights, expected, int8),
                                                    *JAX_OPTS, "output_dir", str(d / "out")])
    side = run_jax_tools(jobs)
    log = open(os.path.join(d, "eval", "s_s50_onex_dfp_tal_flip", "val_log.txt")).read()
    ap, ap50 = re.findall(r"AP: ([0-9.]+)  AP50: ([0-9.]+)", log)[-1]
    side["eval_int8"] = (float(ap), float(ap50))
    return side


def test_eval_int8_matches_jax(root, weights, jax_side, tmp_path):
    """``--int8 --calib-batches 1`` (dedup, its guard armed) within 0.1 AP
    points of the JAX eval CLI; ``--speed --int8`` calibrates on the timed
    batch and runs; no kernel launches for CPU tensors."""
    args = int8_eval_args(weights, root)
    want = jax_side["eval_int8"]
    launches = int8_conv.launches
    got = tool.main(["-f", CFG, "--device", "cpu", *args, *OPTS,
                     "output_dir", str(tmp_path / "port")])
    assert int8_conv.launches == launches
    assert got["ap"] > 0.3 and abs(100 * got["ap"] - 100 * want[0]) <= INT8_AP_TOL \
        and abs(100 * got["ap50"] - 100 * want[1]) <= 0.1, (got["ap"], got["ap50"], want)
    speed = tool.main(["-f", CFG, "--device", "cpu", "-b", "2", "--speed", "--int8", *OPTS,
                       "output_dir", str(tmp_path / "port")])
    assert speed["speed_s_per_batch"] > 0


def parse_table(text):
    """{model: (sAP, sAP50, sAP75, status)} of a printed table."""
    rows = {}
    for line in text.splitlines()[2:]:
        f = line.split()
        rows[f[0]] = (float(f[1]), float(f[4]), float(f[6]), f[8]) if f[-1] != "ERROR" \
            else (None, None, None, "ERROR")
    return rows


@pytest.mark.parametrize("int8", [False, True])
def test_validate_baseline_matches_jax(root, weights, jax_side, tmp_path, capsys, int8):
    """The table of the port's ``validate_baseline`` (``s`` row, with and
    without ``--int8``) against the JAX tool's on the same weights; the
    exit code on a miss and on a hit; a missing weight file is an ERROR
    row and exit 1."""
    expected = tmp_path / "expected.json"
    expected.write_text(json.dumps({"s": [29.8, 50.3, 29.8]}))
    common = vb_args(tmp_path, root, weights, expected, int8)
    opts = OPTS + ["output_dir", str(tmp_path / "out")]
    rc, out = jax_side[f"vb_{int8}"]
    assert rc == 1  # the fixture's AP misses the published 29.8
    want = parse_table(out)["s"]
    assert vb.main([*common, "--device", "cpu", *opts]) == 1
    got = parse_table(capsys.readouterr().out)["s"]
    assert got[3] == want[3] == "FAIL"
    for g, w, tol in zip(got[:3], want[:3], (INT8_AP_TOL if int8 else 0.1, 0.1, 0.1)):
        assert abs(g - w) <= tol, (got, want)

    expected.write_text(json.dumps({"s": list(got[:3])}))
    assert vb.main([*common, "--device", "cpu", *opts]) == 0
    assert parse_table(capsys.readouterr().out)["s"][3] == "OK"

    missing = ["--weights-dir", str(tmp_path / "nope"), "--data-dir", root, "--models", "s",
               "--device", "cpu", *opts]
    assert vb.main(missing) == 1
    assert parse_table(capsys.readouterr().out)["s"][3] == "ERROR"
    assert vb.main(["--weights-dir", "x", "--data-dir", root, "--models", "q"]) == 2
