"""Train-step batch-size sweep on one NVIDIA GPU: the counterpart of
``tools/train_sweep.py``.

    python -m streamyolo_torch.tools.train_sweep [B ...] [--device cpu]
        [--samples 6] [--chain 4] [--depth 0.33 --width 0.5 --input 600 960]

Times the full train step (``train/step.py::make_train_step``: the forward
in train mode over the current and the support frame, SimOTA + the TAL loss,
backward, SGD, EMA) of StreamYOLO-s at 600x960, bf16 autocast over float32
weights, cuDNN's autotuner on as the trainer has it, on one synthetic batch
(``tools/train_sweep.py``'s: 8 objects per image, the label ranges scaled
to the input), for each batch B (default 8, 16, 32). A sample is
``--chain`` steps and one synchronize; per B: min / median / max ms per
step, images/s from the min, ``torch.cuda.max_memory_allocated()`` over the
timed steps after ``reset_peak_memory_stats()``, and the step's work: 3x
the forward's convolutions (``measure.py::count_work`` on a bf16 meta copy
in train mode; the backward's input and weight gradients are each a
convolution of the forward's size) priced by ``measure.py::roofline``.

``train_setup`` and ``measure`` take ``remat`` (the rematerialised step,
``make_train_step(remat=True)``, whose backward runs the forward again: 4x
the forward's convolutions); ``bench_suite.py train_s --remat`` reaches it,
and the JAX tool's ``--remat`` flag has no counterpart on this CLI. Prints
ONE JSON line. Runs on ``cuda``; raises without a card unless ``--device
cpu``, where the same steps run at the size given and every time, rate,
share and memory figure is null.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from streamyolo_torch.tools.bench import seeded_exp, size_tag
from streamyolo_torch.tools.measure import (card, count_work, on_meta, roofline, scale_work,
                                            stats_ms, sync, time_samples)
from streamyolo_torch.utils.device import resolve_device

CONFIG = "s_s50_onex_dfp_tal_flip"  # StreamYOLO-s
BATCHES = (8, 16, 32)
INPUT = (600, 960)
MAX_LABELS, OBJECTS = 50, 8


def synthetic_batch(batch: int, size, device: torch.device, seed: int = 0) -> dict:
    """``tools/train_sweep.py``'s batch at ``size``: random uint8 6-channel
    frames, 8 objects per image (class, cx in 100..860, cy in 100..500, w
    and h in 20..120 at 600x960, scaled to ``size``), the support labels
    equal to the labels, on ``device``."""
    h, w = size
    rs = np.random.RandomState(seed)
    images = rs.randint(0, 255, (batch, h, w, 6), dtype=np.uint8)
    labels = np.zeros((batch, MAX_LABELS, 5), np.float32)
    labels[:, :OBJECTS, 0] = rs.randint(0, 8, (batch, OBJECTS))
    labels[:, :OBJECTS, 1] = rs.uniform(100, 860, (batch, OBJECTS)) * w / INPUT[1]
    labels[:, :OBJECTS, 2] = rs.uniform(100, 500, (batch, OBJECTS)) * h / INPUT[0]
    labels[:, :OBJECTS, 3] = rs.uniform(20, 120, (batch, OBJECTS)) * w / INPUT[1]
    labels[:, :OBJECTS, 4] = rs.uniform(20, 120, (batch, OBJECTS)) * h / INPUT[0]
    return {"images": torch.from_numpy(images).to(device),
            "labels": torch.from_numpy(labels).to(device),
            "support_labels": torch.from_numpy(labels.copy()).to(device)}


@contextlib.contextmanager
def cudnn_autotuned():
    """cuDNN's autotuner on, as ``tools/train.py`` sets it, restored after."""
    before = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = before


def train_setup(batch: int, device: torch.device, depth: Optional[float] = None,
                width: Optional[float] = None, size=INPUT, remat: bool = False):
    """(exp, train step, state, batch) of StreamYOLO-s (or ``depth`` /
    ``width``): float32 master weights from the config's seed, SGD + EMA,
    ``tools/train_sweep.py``'s schedule (yoloxwarmcos, lr 0.001 / 64 per
    image), bf16 autocast, the forward rematerialised if ``remat``."""
    from streamyolo_torch.train import build_lr_schedule, create_train_state, make_train_step

    exp = seeded_exp(CONFIG, depth, width)
    model = exp.get_model(device, dtype=torch.float32)
    model.load_state_dict(exp.init_model(), strict=True)
    state = create_train_state(model, exp.momentum, exp.weight_decay)
    lr = build_lr_schedule("yoloxwarmcos", 0.001 / 64 * batch, iters_per_epoch=100,
                           max_epoch=15, warmup_epochs=1, no_aug_epochs=15)
    step = make_train_step(exp.num_classes, lr, gamma=exp.tal_gamma,
                           ignore_thr=exp.tal_ignore_thr, ignore_value=exp.tal_ignore_value,
                           fp16=True, remat=remat)
    return exp, step, state, synthetic_batch(batch, size, device)


def forward_work(model: torch.nn.Module, images: torch.Tensor) -> dict:
    """``count_work`` of the train-mode forward on ``images`` (a bf16 meta
    copy: autocast runs the convolutions in bf16)."""
    meta = on_meta(model).to(torch.bfloat16).train()
    x = torch.empty(images.shape, dtype=images.dtype, device="meta")
    return count_work(meta, x, mode="off_pipe")


def measure(batch: int, device: torch.device, depth=None, width=None, size=INPUT,
            samples: int = 6, chain: int = 4, remat: bool = False) -> dict:
    """One point of the sweep (module docstring)."""
    _, step, state, data = train_setup(batch, device, depth, width, size, remat)
    work = scale_work(forward_work(state.model, data["images"]), 4 if remat else 3)
    cuda = device.type == "cuda"
    with cudnn_autotuned():
        for _ in range(2):  # the autotuner's first choices
            step(state, data)
        sync(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        times = time_samples(lambda: step(state, data), samples, chain, device)
    s = stats_ms(times)
    ms = s["min_ms"]
    out = {"batch": batch, "remat": remat, "ms_per_step": ms,
           "median_ms_per_step": s["median_ms"], "max_ms_per_step": s["max_ms"],
           "imgs_per_sec": batch * 1e3 / ms if ms else None,
           "peak_memory_gb": torch.cuda.max_memory_allocated(device) / 1e9 if cuda else None,
           "samples": samples, "steps_per_sample": chain,
           **roofline(work, ms / 1e3 if ms else None, device)}
    if ms:
        print(f"B={batch}: {ms:.3f} ms/step, {out['imgs_per_sec']:.1f} imgs/s "
              f"(median {s['median_ms']:.3f}, max {s['max_ms']:.3f}); peak "
              f"{out['peak_memory_gb']:.2f} GB", file=sys.stderr, flush=True)
    del state, data
    if cuda:
        torch.cuda.empty_cache()
    return out


def make_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("batches", type=int, nargs="*", default=list(BATCHES))
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--samples", type=int, default=6)
    p.add_argument("--chain", type=int, default=4, help="steps per sample")
    p.add_argument("--depth", type=float, default=0.33)
    p.add_argument("--width", type=float, default=0.5)
    p.add_argument("--input", type=int, nargs=2, default=INPUT, metavar=("H", "W"))
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = make_parser().parse_args(argv)
    device = resolve_device(args.device)
    points = [measure(b, device, args.depth, args.width, tuple(args.input), args.samples,
                      args.chain) for b in args.batches]
    print(json.dumps({"model": f"StreamYOLO-{size_tag(args.depth, args.width)}",
                      "input": list(args.input), "dtype": "bf16 autocast, float32 weights",
                      "device": card(device), "points": points}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
