"""End-to-end streaming benchmark of StreamYOLO-l on one NVIDIA GPU: the
counterpart of ``bench.py``.

    python -m streamyolo_torch.tools.bench [--device cpu] [--samples 10] [--steps 50]
        [--depth 1.0 --width 1.0 --input 600 960]

Measures the steady per-frame streaming step of the headline variant
(StreamYOLO-l: depth 1.0, width 1.0, 8 classes, TAL head) at the
reference's 600x960 input, bf16 modules, seeded weights with the obj/cls
prediction biases 0 (``chip_smoke.py``'s), at the deployed operating point
(conf 0.01, NMS 0.65, pre-NMS top-k 200): uint8 frame on the card -> cast ->
backbone once -> DFP fuse with the carried buffer -> head -> decode ->
fixed-shape NMS (kernel B1), ``CUDAStreamDetector.step``. Against the 30 FPS
real-time bar the reference's README sets on a V100.

Measurement: the input lies on the card (4 seeded frames, taken in turn);
each sample runs ``--steps`` (K x R = 50, ``bench.py``'s) steps chained
through the DFP buffer (each step reads the buffer the previous one wrote)
and synchronizes once; the value
is the minimum over ``--samples`` (10) samples, as ``bench.py`` has it, and
the median and max go to stderr and into the line (``median_step_ms``).
The headline is the detector as built by default, which serves eagerly;
``graphs`` holds the same measurement of a detector serving from captured
CUDA graphs (``aot_dir``: ``export_stream_executables``, then
``CUDAStreamDetector(aot_dir=...)``). The host path (``bench.py``'s
relay-bound loop) is 20 ``__call__``s on numpy frames: H2D, step, the
[K, 8] D2H and the parse, host clock (stderr, and ``host_path_ms``).

``mfu`` and ``hbm_share`` price the step's convolutions, counted from the
model's shapes (``measure.py::count_work`` on a meta copy), against the
card's data-sheet peaks (``measure.py::roofline``).

Prints ONE JSON line: ``bench.py``'s keys (``metric``, ``value``, ``unit``,
``vs_baseline``, ``operating_point``) and ``device`` (the card's name and
``nvidia-smi`` power limit), ``step_ms``, ``median_step_ms``, ``mfu``,
``graphs``. Runs on ``cuda``; raises without a card unless ``--device cpu``,
where the same steps run at the size given and every time, rate and share
is null.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import tempfile
from typing import List, Optional, Sequence

import numpy as np
import torch

from streamyolo_torch.tools.measure import (card, count_work, on_meta, roofline, stats_ms, sync,
                                            time_samples)
from streamyolo_torch.utils.device import resolve_device

V100_BASELINE_FPS = 30.0  # the reference's real-time bar (README, V100)
STEPS_PER_SAMPLE = 50  # bench.py's K x R: steps chained between two syncs
N_SAMPLES = 10
HOST_CALLS = 20
POOL = 4  # distinct frames the chain steps through
CONF_THRE, NMS_THRE, PRE_NMS_TOPK, NUM_CLASSES = 0.01, 0.65, 200, 8
INPUT = (600, 960)
CONFIG = "l_s50_onex_dfp_tal_filp"  # StreamYOLO-l, TAL head


def size_tag(depth: float, width: float) -> str:
    return {(0.33, 0.5): "s", (0.67, 0.75): "m", (1.0, 1.0): "l"}.get(
        (depth, width), f"d{depth}_w{width}")


def seeded_exp(config: str, depth: Optional[float] = None, width: Optional[float] = None):
    """The shipped config ``config`` at ``depth`` / ``width`` (its own when
    None)."""
    from streamyolo_torch.exp import get_exp

    exp = get_exp(exp_name=config)
    if depth is not None:
        exp.depth = depth
    if width is not None:
        exp.width = width
    return exp


def lifted_state(exp) -> dict:
    """The config's seeded float32 state dict with the obj/cls prediction
    biases 0: with the prior-prob init every score is ~1e-4, below conf
    0.01, and NMS would see no candidates (``chip_smoke.py``'s weights)."""
    state = exp.init_model()
    for k in state:
        if k.startswith(("head.obj_preds.", "head.cls_preds.")) and k.endswith(".bias"):
            state[k] = torch.zeros_like(state[k])
    return state


def serving_model(exp, dtype: torch.dtype, device: torch.device, state=None):
    """``exp``'s model with ``state`` (``lifted_state`` when None), its
    modules in ``dtype``, on ``device``."""
    model = exp.get_model(device, dtype=dtype)
    model.load_state_dict(lifted_state(exp) if state is None else state, strict=True)
    return model


def frames(shape, seed: int = 0) -> np.ndarray:
    """Seeded uint8 frames of ``shape``."""
    return np.random.RandomState(seed).randint(0, 255, shape, dtype=np.uint8)


def frame_pool(batch: int, size, device: torch.device) -> List[torch.Tensor]:
    """``POOL`` seeded [batch, H, W, 3] uint8 inputs on ``device``: the
    chain steps through them in turn, so that every step's DFP buffer holds
    another frame's features than its own."""
    return [torch.from_numpy(f).to(device) for f in frames((POOL, batch, *size, 3))]


def chain(det, images: Sequence[torch.Tensor], steps: int) -> torch.Tensor:
    """``steps`` steps of ``det`` over ``images`` in turn, each reading the
    DFP buffer the one before wrote; returns the last step's rows (on the
    device)."""
    rows = None
    for i in range(steps):
        rows = det.step(images[i % len(images)])
    return rows


def measure_stream(det, images: Sequence[torch.Tensor], n_samples: int, steps: int) -> dict:
    """The chained-step measurement of a detector (``CUDAStreamDetector`` or
    ``MultiStreamDetector``) over ``images`` in turn: a star step, one
    sample's steps to warm up, then ``n_samples`` samples of ``steps`` steps
    and one synchronize each. Returns ``stats_ms`` of the per-step times
    (None values off the card)."""
    pool = itertools.cycle(images)
    det.reset()
    det.step(next(pool))  # the star builds the buffer
    for _ in range(steps):
        det.step(next(pool))
    sync(det.device)
    samples = time_samples(lambda: det.step(next(pool)), n_samples, steps, det.device)
    if samples:
        s = stats_ms(samples)
        print(f"[info] per-step samples (ms): min={s['min_ms']:.3f} "
              f"median={s['median_ms']:.3f} max={s['max_ms']:.3f}", file=sys.stderr)
    return stats_ms(samples)


def step_work(model, image_shape) -> dict:
    """``count_work`` of one steady ``on_pipe`` step of ``model`` on uint8
    frames of ``image_shape`` (a star step on the meta copy makes the
    buffer)."""
    meta = on_meta(model)
    x = torch.empty(image_shape, dtype=torch.uint8, device="meta")
    with torch.no_grad():
        _, buf = meta(x, mode="on_pipe")
    return count_work(meta, x, buffer=buf, mode="on_pipe")


def step_entry(stats: dict, work: dict, device: torch.device, frames_per_step: int) -> dict:
    """A measured step as the tools report it: ms (min and median), frames
    per second and the 30 FPS ratio from the min, and the roofline."""
    ms = stats["min_ms"]
    fps = frames_per_step * 1e3 / ms if ms else None
    return {"step_ms": ms, "median_step_ms": stats["median_ms"], "max_step_ms": stats["max_ms"],
            "frames_per_sec": fps, "vs_baseline": fps / V100_BASELINE_FPS if fps else None,
            **roofline(work, ms / 1e3 if ms else None, device)}


def host_path_ms(det, frame: np.ndarray, calls: int) -> Optional[float]:
    """Median host wall of ``calls`` ``det(frame, preprocessed=True)``: the
    H2D, the step, the [K, 8] D2H and the parse (None off the card)."""
    det.reset()
    det(frame, preprocessed=True)
    samples = time_samples(lambda: det(frame, preprocessed=True), calls, 1, det.device)
    return stats_ms(samples)["median_ms"]


def make_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--samples", type=int, default=N_SAMPLES)
    p.add_argument("--steps", type=int, default=STEPS_PER_SAMPLE,
                   help="chained steps per sample (one synchronize each)")
    p.add_argument("--depth", type=float, default=1.0)
    p.add_argument("--width", type=float, default=1.0)
    p.add_argument("--input", type=int, nargs=2, default=INPUT, metavar=("H", "W"))
    return p


def run(args, device: torch.device) -> dict:
    from streamyolo_torch.stream import CUDAStreamDetector
    from streamyolo_torch.stream.online import export_stream_executables

    h, w = args.input
    model = serving_model(seeded_exp(CONFIG, args.depth, args.width), torch.bfloat16, device)
    kw = dict(input_size=(h, w), conf_thre=CONF_THRE, nms_thre=NMS_THRE,
              num_classes=NUM_CLASSES, pre_nms_topk=PRE_NMS_TOPK, use_bf16=True, device=device)
    images = frame_pool(1, (h, w), device)
    work = step_work(model, images[0].shape)

    det = CUDAStreamDetector(model, **kw)
    eager = step_entry(measure_stream(det, images, args.samples, args.steps), work, device, 1)
    host_ms = host_path_ms(det, images[0][0].cpu().numpy(), HOST_CALLS)
    del det

    with tempfile.TemporaryDirectory(prefix="streamyolo_bench_aot_") as aot_dir:
        export_stream_executables(model, aot_dir, **kw)
        gdet = CUDAStreamDetector(model, aot_dir=aot_dir, **kw)
        graphs = {"aot_loaded": gdet.aot_loaded,
                  **step_entry(measure_stream(gdet, images, args.samples, args.steps), work,
                               device, 1)}
        if gdet.graphs is not None:
            graphs["capture_s"] = gdet.graphs.capture_seconds
            graphs["launches"] = gdet.graphs.launches()
        del gdet

    if eager["step_ms"]:
        print(f"[info] on-device step: {eager['step_ms']:.3f} ms eager, "
              f"{graphs['step_ms']:.3f} ms from graphs; host path "
              f"({HOST_CALLS} __call__s, median): {host_ms:.3f} ms", file=sys.stderr)
    tag = size_tag(args.depth, args.width)
    return {
        "metric": f"streamyolo_{tag}_stream_step_fps_{h}x{w}",
        "value": eager["frames_per_sec"],
        "unit": "frames/sec/card",
        "vs_baseline": eager["vs_baseline"],
        "operating_point": {
            "conf_thre": CONF_THRE, "nms_thre": NMS_THRE, "pre_nms_topk": PRE_NMS_TOPK,
            "dtype": "bf16", "layout": "raw", "path": "eager (the default detector)",
            "step_ms": eager["step_ms"], "steps_per_sample": args.steps,
            "samples": args.samples, "statistic": "min over samples"},
        "device": card(device),
        **{k: v for k, v in eager.items() if k not in ("frames_per_sec", "vs_baseline")},
        "host_path_ms": host_ms,
        "host_path_calls": HOST_CALLS,
        "graphs": graphs,
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = make_parser().parse_args(argv)
    device = resolve_device(args.device)
    print(json.dumps(run(args, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
