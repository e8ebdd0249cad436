"""The float32 noise floor of the detector-level JAX comparison: the model
of ``tests/test_torch_stream.py`` (StreamYOLO-s at depth 0.33, width 0.25,
JAX init from key 1, obj/cls biases lifted to 0, 64x96, fp32) runs a star
and three steady ``on_pipe`` frames in five fresh processes: the JAX
package at its default thread count and at one thread, the port likewise,
and the port in float64. Each pair is compared on the decoded boxes (raw
pixels: model pixels / ``in_scale`` 0.5, as the detectors return them) and
scores of every anchor the float64 run scores above the detectors' conf
0.01.

    python -m tests.torch_detector_noise

prints one JSON line: per pair, the worst box gap (px) and score gap over
the four frames, and per frame. A measurement, not a test."""

import json
import os
import subprocess
import sys
import tempfile

import numpy as np

INPUT = (64, 96)
IN_SCALE, CONF, FRAMES = 0.5, 0.01, 4
RUNS = {"jax": ("jax", None), "jax_1thread": ("jax", 1), "port": ("port", None),
        "port_1thread": ("port", 1), "port_float64": ("port64", None)}
PAIRS = [("jax", "jax_1thread"), ("port", "port_1thread"), ("jax", "port"),
         ("jax_1thread", "port_1thread"), ("jax", "port_float64"),
         ("jax_1thread", "port_float64"), ("port", "port_float64"),
         ("port_1thread", "port_float64")]


def frames():
    rng = np.random.RandomState(2)
    return [rng.randint(0, 256, (1, *INPUT, 3), np.uint8) for _ in range(FRAMES)]


def run_child(kind: str, out: str) -> None:
    """The decoded outputs [FRAMES, anchors, 13] of one run, saved to ``out``."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    from streamyolo_tpu.models import DFPPAFPN as JDFPPAFPN
    from streamyolo_tpu.models import StreamYOLO as JStreamYOLO
    from streamyolo_tpu.models import TALHead as JTALHead

    from .torch_port_helpers import lift_pred_biases, load_port

    jmodel = JStreamYOLO(backbone=JDFPPAFPN(0.33, 0.25), head=JTALHead(num_classes=8, width=0.25))
    init = jax.jit(lambda key, x: jmodel.init(key, x, mode="off_pipe"))
    variables = lift_pred_biases(jax.tree_util.tree_map(
        np.asarray, init(jax.random.PRNGKey(1), jnp.zeros((1, *INPUT, 6), jnp.float32))))
    outs = []
    if kind == "jax":
        buf = None
        for x in frames():
            y, buf = jmodel.apply(variables, jnp.asarray(x, jnp.float32), buffer=buf,
                                  mode="on_pipe")
            outs.append(np.asarray(y[0], np.float64))
    else:
        import torch

        from streamyolo_torch.models import DFPPAFPN, StreamYOLO, TALHead

        port = load_port(StreamYOLO(DFPPAFPN(0.33, 0.25), TALHead(num_classes=8, width=0.25)),
                         variables).eval()
        dtype = torch.float64 if kind == "port64" else torch.float32
        port = port.to(dtype)
        buf = None
        with torch.inference_mode():
            for x in frames():
                y, buf = port(torch.from_numpy(x).to(dtype), buffer=buf, mode="on_pipe")
                outs.append(y[0].double().numpy())
    np.save(out, np.stack(outs))


def gaps(a: np.ndarray, b: np.ndarray, ref: np.ndarray) -> dict:
    """Worst |box| (raw px) and |score| gaps of ``a`` and ``b`` over the
    anchors that ``ref`` scores above ``CONF``, per frame."""
    score = lambda o: o[..., 4] * o[..., 5:].max(-1)  # noqa: E731
    per_frame = []
    for f in range(FRAMES):
        keep = score(ref[f]) > CONF
        per_frame.append({
            "anchors": int(keep.sum()),
            "box_px": float(np.abs(a[f, keep, :4] - b[f, keep, :4]).max() / IN_SCALE),
            "score": float(np.abs(score(a[f])[keep] - score(b[f])[keep]).max())})
    return {"box_px_max": max(p["box_px"] for p in per_frame),
            "score_max": max(p["score"] for p in per_frame), "per_frame": per_frame}


def main() -> None:
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    outs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (kind, threads) in RUNS.items():
            env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
            env["JAX_PLATFORMS"] = "cpu"
            if threads:
                env["XLA_FLAGS"] = ("--xla_cpu_multi_thread_eigen=false "
                                    "intra_op_parallelism_threads=1")
                env["OMP_NUM_THREADS"] = env["MKL_NUM_THREADS"] = "1"
            path = os.path.join(tmp, name + ".npy")
            subprocess.run([sys.executable, "-m", "tests.torch_detector_noise", "--child",
                            kind, path], cwd=repo, env=env, check=True)
            outs[name] = np.load(path)
    ref = outs["port_float64"]
    print(json.dumps({"threads_default": os.cpu_count(),
                      "pairs": {f"{a} vs {b}": gaps(outs[a], outs[b], ref) for a, b in PAIRS}}))


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--child":
        run_child(sys.argv[2], sys.argv[3])
    else:
        main()
