"""Regenerates ``tests/torch_trained/``, the trained fixture that holds the
port's bf16 serving rows to the JAX package's own
(``tests/test_torch_trained_bf16.py`` on the CPU, ``chip_smoke.py`` phase
``trained_bf16`` on the card).

    JAX_PLATFORMS=cpu python -m tests.torch_trained_fixture [--stage train|golden|measure|all]

``train``: the port trains the tiny model of ``chip_smoke.py`` phase
``trained_e2e`` (``E2E_CONFIG``: StreamYOLO-s at depth 0.33, width 0.25, 8
classes, TAL head, 150x240) on the CPU in float32 through
``streamyolo_torch/tools/train.py``, on the synthetic video at that phase's
defaults (``SyntheticArgoverse``, 4 x 75 frames, raw 300x480, objects of
1/8 to 1/4 of the frame, train = val) with its schedule (batch 16, 22
epochs, LR 0.02, one warmup epoch and a cosine), then scores the EMA
weights, rounded to bf16, with the port's eval CLI (float32, dedup) and
writes them as bf16 with ``utils/weights.py::save_safetensors``
(``weights.safetensors``): bf16 values are exact in float32, float64 and
bf16, so every comparison measures the computation's rounding, not the
weights'.

``golden``: the JAX package's answer on the fixture's 8 streams
(``chip_smoke.py::trained_streams``: sequence ``s`` from frame ``o`` for
``s`` in 0..3 and ``o`` in 0, 40, 8 frames each, a star frame and then
steady frames carrying the DFP buffer): ``TPUStreamDetector`` (host path,
conf 0.01, NMS 0.65, top-k 200) with the model built by the JAX ``Exp`` in
bf16 and in float32 gives each frame's ``[K, 8]`` rows, and the same
model's ``on_pipe`` chain gives the decoded candidates: every anchor that
the float32 model scores above conf, its box in raw pixels (cx, cy, w, h /
``in_scale``) and score (obj x the largest class probability) in each
dtype.

``measure``: the gaps that set the bounds of ``chip_smoke.py``'s
``TRAINED_*`` constants (the port on the CPU in bf16, float32 and float64
against the golden rows and candidates, ``measured``) and the JAX run's
own thread-count noise (the golden rows and candidates re-derived in child
processes pinned to 1, 2 and 4 cores, with the tests' 8 virtual XLA
devices and with XLA's default one), written into ``meta.json`` beside
the seed, the configuration, the training's steps, seconds and AP, and the
sha256 of the weights and of the frames. Needs JAX and flax (``golden``,
``measure``); the card reads only the files.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from .torch_port_helpers import chip_smoke

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "torch_trained"
WEIGHTS, GOLDEN, META = (FIXTURE / "weights.safetensors", FIXTURE / "golden.npz",
                         FIXTURE / "meta.json")
EVAL_BATCH = 64
NOISE_CORES = (1, 2, 4)  # measure: the JAX children's core counts


def sha256_of(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def write_layout(work: Path, synth) -> Path:
    """The annotations of both splits and the config file under ``work``;
    returns the config's path."""
    ann = work / "Argoverse-HD" / "annotations"
    ann.mkdir(parents=True, exist_ok=True)
    for split in ("train.json", "val.json"):
        (ann / split).write_text(json.dumps(synth.data))
    cfg = work / "tiny_s.py"
    cfg.write_text(chip_smoke().E2E_CONFIG)
    return cfg


def train(work: Path) -> dict:
    """Train on the CPU on phase ``trained_e2e``'s synthetic video (made
    from its seed), round the EMA weights to bf16, score them, write
    ``weights.safetensors``; returns the training's record."""
    import torch

    from streamyolo_torch.data import SyntheticArgoverse
    from streamyolo_torch.tools import eval as eval_tool
    from streamyolo_torch.tools import train as train_tool
    from streamyolo_torch.utils.weights import save_safetensors

    c = chip_smoke()
    synth = SyntheticArgoverse(seq_lens=(c.E2E_FRAMES,) * c.E2E_SEQS, size=c.E2E_RAW,
                               seed=c.SEED, obj_frac=c.E2E_OBJ_FRAC)
    cfg = write_layout(work, synth)
    data_opts = ["data_dir", str(work), "output_dir", str(work / "runs"), "data_num_workers", "0"]
    t0 = time.perf_counter()
    trainer = train_tool.main(
        ["-f", str(cfg), "-b", str(c.E2E_BATCH), "--device", "cpu", "-expn", "tiny", *data_opts,
         "max_epoch", str(c.E2E_EPOCHS), "no_aug_epochs", str(c.E2E_EPOCHS),
         "eval_interval", str(c.E2E_EPOCHS + 1), "warmup_epochs", "1", "scheduler", "warmcos",
         "basic_lr_per_img", str(c.E2E_LR_PER_IMG), "save_history_ckpt", "False",
         "print_interval", "20", "seed", str(c.SEED)], load_frame=synth.frame)
    train_s = time.perf_counter() - t0
    steps = int(trainer.state.step)
    ckpt = torch.load(work / "runs" / "tiny" / "latest_ckpt.pth", map_location="cpu",
                      weights_only=False)
    state = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
             for k, v in ckpt["model"].items()}
    FIXTURE.mkdir(parents=True, exist_ok=True)
    save_safetensors(state, str(WEIGHTS))
    res = eval_tool.main(["-f", str(cfg), "-c", str(WEIGHTS), "-b", str(EVAL_BATCH), "--device",
                          "cpu", "-expn", "eval", *data_opts], load_frame=synth.frame)
    return {"steps": steps, "train_s": round(train_s, 1), "epochs": c.E2E_EPOCHS,
            "batch": c.E2E_BATCH, "lr": c.E2E_LR_PER_IMG * c.E2E_BATCH,
            "dtype": "float32 (CPU)", "torch_threads": torch.get_num_threads(),
            "eval": {"AP": 100 * res["ap"], "AP50": 100 * res["ap50"],
                     "weights": "EMA rounded to bf16, evaluated float32, dedup",
                     "split": "val (= train)"}}


def jax_model(use_bf16: bool):
    """The JAX package's model of ``E2E_CONFIG``, built by its ``Exp`` with
    bf16 or float32 modules (its serving default, the packed layout)."""
    from streamyolo_tpu.exp import get_exp

    port = chip_smoke().trained_exp()
    exp = get_exp(exp_name="s_s50_onex_dfp_tal_flip")
    exp.depth, exp.width, exp.num_classes = port.depth, port.width, port.num_classes
    exp.input_size, exp.test_size = port.input_size, port.test_size
    exp.compute_dtype = "bfloat16" if use_bf16 else "float32"
    return exp.get_model()


def jax_variables():
    """The fixture's weights as flax variables, through the JAX package's
    ``state_dict_to_variables``."""
    from streamyolo_tpu.utils.torch_import import state_dict_to_variables
    from streamyolo_torch.utils.weights import load_state_dict_file

    return state_dict_to_variables(
        {k: v.float() for k, v in load_state_dict_file(str(WEIGHTS)).items()})


def jax_rows(use_bf16: bool, frames: np.ndarray, variables) -> np.ndarray:
    """``frames`` ``[S, T, H, W, 3]`` through ``TPUStreamDetector`` (host
    path, reset before each stream): its ``[S, T, K, 8]`` rows, observed at
    its two programs' outputs."""
    from streamyolo_tpu.stream import TPUStreamDetector

    c = chip_smoke()
    det = TPUStreamDetector(jax_model(use_bf16), variables,
                            input_size=tuple(c.trained_exp().test_size),
                            in_scale=c.TRAINED_IN_SCALE, conf_thre=c.CONF, nms_thre=c.NMS,
                            num_classes=c.NCLS, pre_nms_topk=c.TOPK, use_bf16=use_bf16)
    blocks = []

    def observed(program):
        def run(*args):
            dets, buffer = program(*args)
            blocks.append(np.asarray(dets)[0])
            return dets, buffer
        return run

    det._step_star, det._step_buf = observed(det._step_star), observed(det._step_buf)
    for stream in frames:
        det.reset()
        for frame in stream:
            det(frame)
    return np.stack(blocks).reshape(*frames.shape[:2], *blocks[0].shape)


def jax_preds(use_bf16: bool, frames: np.ndarray, variables) -> np.ndarray:
    """The decoded predictions ``[S, T, anchors, 13]`` (float64) of the
    JAX model's ``on_pipe`` chain on the frames as ``TPUStreamDetector``
    preprocesses them (``cv2.resize``; cast to the compute dtype)."""
    import cv2
    import jax
    import jax.numpy as jnp

    model = jax_model(use_bf16)
    dtype = jnp.bfloat16 if use_bf16 else jnp.float32
    apply = jax.jit(lambda v, x, b: model.apply(v, x.astype(dtype), buffer=b, mode="on_pipe"))
    h, w = chip_smoke().trained_exp().test_size
    preds = []
    for stream in frames:
        buffer = None
        for frame in stream:
            x = cv2.resize(frame, (w, h), interpolation=cv2.INTER_LINEAR)[None]
            y, buffer = apply(variables, x, buffer)
            preds.append(np.asarray(y[0], np.float64))
    return np.stack(preds).reshape(*frames.shape[:2], *preds[0].shape)


def golden_arrays(frames: np.ndarray) -> dict:
    """``golden.npz``'s arrays: ``rows_{float32,bfloat16}`` ``[S, T, K,
    8]``; the candidates (``cand_image`` = s * T + t, ``cand_anchor``:
    every anchor the float32 model scores above conf) with
    ``cand_box_{dtype}`` (cx, cy, w, h in raw pixels) and
    ``cand_score_{dtype}``."""
    c = chip_smoke()
    variables = jax_variables()
    runs = {name: (jax_rows(bf16, frames, variables), jax_preds(bf16, frames, variables))
            for name, bf16 in (("float32", False), ("bfloat16", True))}
    flat32 = runs["float32"][1].reshape(-1, *runs["float32"][1].shape[2:])
    image, anchor = np.nonzero(flat32[..., 4] * flat32[..., 5:].max(-1) > c.CONF)
    out = {"cand_image": image.astype(np.int16), "cand_anchor": anchor.astype(np.int16)}
    for name, (rows, preds) in runs.items():
        box, score = c.golden_candidates(preds, out)
        out[f"rows_{name}"] = rows.astype(np.float32)
        out[f"cand_box_{name}"] = box.astype(np.float32)
        out[f"cand_score_{name}"] = score.astype(np.float32)
    return out


def load_golden() -> dict:
    with np.load(GOLDEN) as f:
        return dict(f)


def port_runs(frames: np.ndarray, dtypes=("bfloat16", "float32", "float64")) -> dict:
    """The port's ``CUDAStreamDetector`` on the CPU over ``frames`` with the
    fixture's weights built in each dtype (host path): dtype name -> (rows,
    decoded predictions), ``chip_smoke.py::detector_streams``."""
    import torch

    from streamyolo_torch.stream import CUDAStreamDetector

    c = chip_smoke()
    out = {}
    for name in dtypes:
        dtype = getattr(torch, name)
        det = CUDAStreamDetector(
            c.trained_model(dtype, "cpu"), input_size=tuple(c.trained_exp().test_size),
            in_scale=c.TRAINED_IN_SCALE, conf_thre=c.CONF, nms_thre=c.NMS,
            num_classes=c.NCLS, pre_nms_topk=c.TOPK, use_bf16=name == "bfloat16",
            device="cpu")
        out[name] = c.detector_streams(det, frames)
    return out


def measured(golden: dict, runs: dict) -> dict:
    """The gaps that set the bounds (``port_runs`` against the golden
    file): rows (``matched_rows``) and candidates (``candidate_gaps``) of
    bf16 and float32, and the float64 anchor of ROADMAP C.5."""
    c = chip_smoke()
    rows = {k: c.block_rows(v) for k, v in (("jax_bf16", golden["rows_bfloat16"]),
                                             ("jax_fp32", golden["rows_float32"]),
                                             ("port_bf16", runs["bfloat16"][0]),
                                             ("port_fp32", runs["float32"][0]))}
    cand = {"jax_bf16": (golden["cand_box_bfloat16"], golden["cand_score_bfloat16"]),
            "jax_fp32": (golden["cand_box_float32"], golden["cand_score_float32"])}
    for name in ("bfloat16", "float32", "float64"):
        cand[f"port_{name}"] = c.golden_candidates(runs[name][1], golden)
    return {
        "rows": {f"{a} vs {b}": c.matched_rows(rows[a], rows[b])
                 for a, b in (("port_bf16", "jax_bf16"), ("jax_bf16", "jax_fp32"),
                              ("port_bf16", "jax_fp32"), ("port_fp32", "jax_fp32"))},
        "candidates": {f"{a} vs {b}": c.candidate_gaps(*cand[a], *cand[b])
                       for a, b in (("port_bfloat16", "jax_fp32"), ("jax_bf16", "jax_fp32"),
                                    ("port_bfloat16", "jax_bf16"),
                                    ("port_float32", "port_float64"),
                                    ("jax_fp32", "port_float64"))}}


def thread_noise(golden: dict) -> dict:
    """The JAX run's own noise: the golden rows and candidates re-derived in
    a child pinned to each of ``NOISE_CORES`` cores (XLA sizes its thread
    pool by them), with the tests' 8 virtual devices and with XLA's default
    one, against the golden file (``matched_rows`` per stream,
    ``candidate_gaps``)."""
    c = chip_smoke()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for devices in (8, 1):
            env = {**os.environ, "XLA_FLAGS": f"--xla_force_host_platform_device_count={devices}"}
            for cores in NOISE_CORES:
                path = os.path.join(tmp, f"{devices}_{cores}.npz")
                subprocess.run([sys.executable, "-m", "tests.torch_trained_fixture",
                                "--noise-child", str(cores), path], cwd=REPO, env=env, check=True)
                with np.load(path) as f:
                    got = dict(f)
                for name in ("bfloat16", "float32"):
                    per = [c.matched_rows(c.block_rows(got[f"rows_{name}"][s]),
                                          c.block_rows(golden[f"rows_{name}"][s]))
                           for s in range(len(got[f"rows_{name}"]))]
                    cand = c.golden_gaps(golden, name,
                                         *c.golden_candidates(got[f"preds_{name}"], golden))
                    out[f"{name}, {cores} cores, {devices} devices"] = {
                        "rows_unmatched": [p["unmatched"] for p in per],
                        "rows_box_max_abs": [p["box_max_abs"] for p in per],
                        "rows_score_max_abs": [p["score_max_abs"] for p in per],
                        "candidates": cand}
    return out


def noise_child(cores: int, out: str) -> None:
    """One ``thread_noise`` run: pin this process to ``cores`` cores before
    JAX starts, then the JAX rows and predictions of both dtypes."""
    os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[:cores])
    configure_jax()
    frames = chip_smoke().trained_streams()
    variables = jax_variables()
    np.savez(out, **{f"{kind}_{name}": fn(bf16, frames, variables)
                     for name, bf16 in (("float32", False), ("bfloat16", True))
                     for kind, fn in (("rows", jax_rows), ("preds", jax_preds))})


def describe() -> dict:
    """``meta.json``'s fixed entries: the seed, the configuration, the data
    and the streams."""
    c = chip_smoke()
    exp = c.trained_exp()
    return {"seed": c.SEED,
            "config": {"exp": "chip_smoke.py::E2E_CONFIG (s_s50_onex_dfp_tal_flip)",
                       "depth": exp.depth, "width": exp.width, "num_classes": exp.num_classes,
                       "head": exp.head_name, "test_size": list(exp.test_size)},
            "data": {"generator": "SyntheticArgoverse", "seq_lens": [c.E2E_FRAMES] * c.E2E_SEQS,
                     "size": list(c.E2E_RAW), "obj_frac": list(c.E2E_OBJ_FRAC)},
            "streams": {"sequences": list(c.TRAINED_SEQS), "offsets": list(c.TRAINED_OFFSETS),
                        "steps": c.TRAINED_STEPS, "in_scale": c.TRAINED_IN_SCALE,
                        "conf": c.CONF, "nms": c.NMS, "topk": c.TOPK}}


def configure_jax() -> None:
    """JAX as ``tests/conftest.py`` configures it for the tests: the CPU
    with 8 virtual devices, float32 convolutions at full precision."""
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = f"{flags} --xla_force_host_platform_device_count=8".strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")


def main() -> None:
    configure_jax()
    parser = argparse.ArgumentParser()
    parser.add_argument("--stage", choices=("train", "golden", "measure", "all"), default="all")
    args = parser.parse_args()
    meta = {**(json.loads(META.read_text()) if META.exists() else {}), **describe()}
    if args.stage in ("train", "all"):
        with tempfile.TemporaryDirectory() as tmp:
            meta["training"] = train(Path(tmp))
        meta["weights_sha256"] = sha256_of(WEIGHTS.read_bytes())
        META.write_text(json.dumps(meta, indent=1) + "\n")
        print(json.dumps(meta["training"]), flush=True)
    frames = chip_smoke().trained_streams()
    if args.stage in ("golden", "all"):
        t0 = time.perf_counter()
        np.savez_compressed(GOLDEN, **golden_arrays(frames))
        meta["golden_s"] = round(time.perf_counter() - t0, 1)
        meta["frames_sha256"] = sha256_of(frames.tobytes())
        META.write_text(json.dumps(meta, indent=1) + "\n")
    if args.stage in ("measure", "all"):
        import torch

        torch.set_num_threads(1)  # as the test runs; the port's rows do not depend on it
        golden = load_golden()
        meta["measured"] = measured(golden, port_runs(frames))
        meta["jax_thread_noise"] = thread_noise(golden)
        META.write_text(json.dumps(meta, indent=1) + "\n")


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--noise-child":
        noise_child(int(sys.argv[2]), sys.argv[3])
    else:
        main()
