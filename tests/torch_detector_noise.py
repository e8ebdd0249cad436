"""The float32 noise floor of the detector-level JAX comparison: the model
of ``tests/test_torch_stream.py`` (StreamYOLO-s at depth 0.33, width 0.25,
JAX init from key 1, obj/cls biases lifted to 0, 64x96, fp32) runs a star
and three steady ``on_pipe`` frames in five fresh processes: the JAX
package at its default thread count and at one thread, the port likewise,
and the port in float64. Each pair is compared on the decoded boxes (raw
pixels: model pixels / ``in_scale``, as the detectors return them) and
scores of every anchor the float64 run scores above the detectors' conf
0.01.

``--trained``: the same five runs on the trained fixture
(``tests/torch_trained/``: ``chip_smoke.py``'s ``E2E_CONFIG`` model with
the fixture's weights, its 8 streams of a star and 7 steady frames of the
synthetic video at 150x240, each stream from a fresh star).

    python -m tests.torch_detector_noise [--trained]

prints one JSON line: per pair, the worst box gap (px) and score gap over
the frames, and per frame (the random model's four only). A measurement,
not a test."""

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


def random_models():
    """The random model of ``tests/test_torch_stream.py``: the flax module,
    its variables, a function building the port's copy, and its one stream
    of frames."""
    import jax
    import jax.numpy as jnp

    from streamyolo_tpu.models import DFPPAFPN as JDFPPAFPN
    from streamyolo_tpu.models import StreamYOLO as JStreamYOLO
    from streamyolo_tpu.models import TALHead as JTALHead

    from .torch_port_helpers import lift_pred_biases, load_port

    jmodel = JStreamYOLO(backbone=JDFPPAFPN(0.33, 0.25), head=JTALHead(num_classes=8, width=0.25))
    init = jax.jit(lambda key, x: jmodel.init(key, x, mode="off_pipe"))
    variables = lift_pred_biases(jax.tree_util.tree_map(
        np.asarray, init(jax.random.PRNGKey(1), jnp.zeros((1, *INPUT, 6), jnp.float32))))

    def port():
        from streamyolo_torch.models import DFPPAFPN, StreamYOLO, TALHead

        return load_port(StreamYOLO(DFPPAFPN(0.33, 0.25), TALHead(num_classes=8, width=0.25)),
                         variables)

    return jmodel, variables, port, [frames()]


def trained_models():
    """The trained fixture's flax module (float32), its variables, a
    function building the port's copy, and the streams of frames
    preprocessed to 150x240."""
    from streamyolo_torch.data.cv2_ops import resize_u8

    from . import torch_trained_fixture as fixture
    from .torch_port_helpers import chip_smoke

    smoke = chip_smoke()
    size = smoke.trained_exp().test_size
    streams = [[resize_u8(f, *size)[None] for f in stream] for stream in smoke.trained_streams()]
    return (fixture.jax_model(False), fixture.jax_variables(),
            lambda: smoke.trained_model(None, "cpu"), streams)


def run_child(kind: str, out: str, trained: bool) -> None:
    """The decoded outputs [frames, anchors, 13] of one run, saved to ``out``."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    jmodel, variables, port_model, streams = trained_models() if trained else random_models()
    outs = []
    if kind == "jax":
        for stream in streams:
            buf = None
            for x in stream:
                y, buf = jmodel.apply(variables, jnp.asarray(x, jnp.float32), buffer=buf,
                                      mode="on_pipe")
                outs.append(np.asarray(y[0], np.float64))
    else:
        import torch

        dtype = torch.float64 if kind == "port64" else torch.float32
        port = port_model().eval().to(dtype)
        with torch.inference_mode():
            for stream in streams:
                buf = None
                for x in stream:
                    y, buf = port(torch.from_numpy(x).to(dtype), buffer=buf, mode="on_pipe")
                    outs.append(y[0].double().numpy())
    np.save(out, np.stack(outs))


def gaps(a: np.ndarray, b: np.ndarray, ref: np.ndarray, per_frame: bool) -> dict:
    """Worst |box| (raw px) and |score| gaps of ``a`` and ``b`` over the
    anchors that ``ref`` scores above ``CONF``, per frame."""
    score = lambda o: o[..., 4] * o[..., 5:].max(-1)  # noqa: E731
    frames_ = []
    for f in range(len(ref)):
        keep = score(ref[f]) > CONF
        frames_.append({
            "anchors": int(keep.sum()),
            "box_px": float(np.abs(a[f, keep, :4] - b[f, keep, :4]).max() / IN_SCALE),
            "score": float(np.abs(score(a[f])[keep] - score(b[f])[keep]).max())})
    out = {"box_px_max": max(p["box_px"] for p in frames_),
           "score_max": max(p["score"] for p in frames_),
           "anchors": sum(p["anchors"] for p in frames_)}
    return {**out, "per_frame": frames_} if per_frame else out


def main(trained: bool) -> None:
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
                            kind, path, *(["--trained"] if trained else [])],
                           cwd=repo, env=env, check=True)
            outs[name] = np.load(path)
    ref = outs["port_float64"]
    print(json.dumps({"model": "trained fixture" if trained else "random",
                      "threads_default": os.cpu_count(),
                      "pairs": {f"{a} vs {b}": gaps(outs[a], outs[b], ref, not trained)
                                for a, b in PAIRS}}))


if __name__ == "__main__":
    if len(sys.argv) >= 4 and sys.argv[1] == "--child":
        run_child(sys.argv[2], sys.argv[3], sys.argv[4:] == ["--trained"])
    else:
        main(sys.argv[1:] == ["--trained"])
