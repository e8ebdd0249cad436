"""Streaming host-path latency budget on one NVIDIA GPU: the counterpart of
``tools/bench_hostpath.py``.

    python -m streamyolo_torch.tools.bench_hostpath [--device cpu] [--samples 50]
        [--step-samples 10] [--steps 50] [--depth D --width W] [--input 600 960]
    python -m streamyolo_torch.tools.bench_hostpath --train [--train-batch 16]
        [--train-batches 8] [--train-frames 24] [--train-workers 0,1,2]
        [--train-aug] [--train-no-cache-row]

Measures every piece of a frame's work outside the model step, and the
step, in one process, and decides between the two ways to feed the card
(the real-time loop of the reference, ``streamyolo_det.py:152-195``):

  host-resize   -- the port's native ``INTER_LINEAR`` resize
                   (``data/cv2_ops.py::resize_u8``) of the raw 1200x1920
                   frame on the host, H2D of the 600x960 uint8 input
  device-resize -- H2D of the raw frame, kernel B2's 0.5x downsample on the
                   card (``CUDAStreamDetector(device_preproc=True)``)

then, for both, the step, the D2H of the [K, 8] rows and their unpack. On
the card every piece is measured directly (host clock, synchronized; min,
median and max of ``--samples``): the resize and the unpack; H2D of the input
and of the raw frame, each from pageable memory (what the detectors copy
from) and from pinned memory; the D2H of the rows, to pageable and pinned
memory; and the chained steady step of both detectors (``bench.py``'s
measurement, ``--step-samples`` samples of ``--steps`` steps). ``budget_table``
adds them up per configuration (pageable copies, medians; the pinned
copies beside them). There is no assumed link bandwidth and no assumed
step time.

``--train`` measures the training input pipeline instead: images/s
through the port's train loader (``DoubleTrainTransform``, the mosaic with
``--train-aug``) on an Argoverse-HD-layout fixture of JPEGs at the real
1200x1920 camera size written by the port's ``data/image_io.py::imwrite``
(``write_train_fixture``), against worker count and ``--cache``; then the
overlap through ``DevicePrefetcher`` while a sleep stands for the train
step, and the workers needed to keep up with it. That step is
``train_sweep.py``'s, StreamYOLO-s at ``--train-batch``, measured on the
card in the same process (``--depth`` / ``--width`` set the model of the
step measured: StreamYOLO-l by default, -s with ``--train``).

Sizes follow ``--input``: the raw frame is twice it. Prints ONE JSON line
with ``device`` (the card's name and ``nvidia-smi`` power limit). Runs on
``cuda``; raises without a card unless ``--device cpu``, where the same
steps run at the size given and every time, rate and share is null.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import shutil
import sys
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch

from streamyolo_torch.tools import bench, train_sweep
from streamyolo_torch.tools.measure import card, stats_ms, time_samples
from streamyolo_torch.utils.device import resolve_device

K_ROWS = bench.PRE_NMS_TOPK


def bench_host(samples: int, size, device: torch.device) -> dict:
    """The host's pieces: the native resize of the raw frame to ``size``
    and the numpy unpack of the [K, 8] rows (timed only when the tool runs
    on the card; min, median and max)."""
    from streamyolo_torch.data.cv2_ops import resize_u8

    h, w = size
    rng = np.random.RandomState(0)
    frame = rng.randint(0, 256, (2 * h, 2 * w, 3), np.uint8)
    rows = rng.uniform(0, 1, (K_ROWS, 8)).astype(np.float32)
    rows[:, 7] = (rng.uniform(size=K_ROWS) > 0.5).astype(np.float32)

    def unpack():
        kept = rows[rows[:, 7] > 0.5]
        bboxes = kept[:, :4] / 0.5
        scores = kept[:, 4] * kept[:, 5]
        labels = kept[:, 6].astype(np.int32)
        (rows[:, 4] * rows[:, 5] >= bench.CONF_THRE).sum()  # the saturation check
        return bboxes, scores, labels

    return {"resize_ms": stats_ms(time_samples(lambda: resize_u8(frame, h, w), samples, 1,
                                                  device)),
            "unpack_ms": stats_ms(time_samples(unpack, samples, 1, device)),
            "raw_hw": [2 * h, 2 * w], "input_hw": [h, w]}


def bench_transfers(samples: int, size, device: torch.device) -> dict:
    """H2D of the input and of the raw frame, from pageable and from pinned
    host memory, and D2H of the [1, K, 8] rows to pageable and pinned
    memory, each synchronized (min, median and max)."""
    h, w = size
    rng = np.random.RandomState(0)
    cuda = device.type == "cuda"
    out = {}
    for name, shape in (("h2d_input", (h, w, 3)), ("h2d_raw", (2 * h, 2 * w, 3))):
        pageable = torch.from_numpy(rng.randint(0, 256, shape, np.uint8))
        pinned = pageable.pin_memory() if cuda else pageable
        out[name] = {
            "hw": list(shape[:2]), "mbytes": pageable.numel() / 1e6,
            "pageable_ms": stats_ms(time_samples(lambda: pageable.to(device), samples, 1,
                                                    device)),
            "pinned_ms": stats_ms(time_samples(
                lambda: pinned.to(device, non_blocking=True), samples, 1, device))}
    rows = torch.from_numpy(rng.uniform(0, 1, (1, K_ROWS, 8)).astype(np.float32)).to(device)
    host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=cuda)
    out["d2h_rows"] = {
        "mbytes": rows.numel() * 4 / 1e6,
        "pageable_ms": stats_ms(time_samples(lambda: rows.cpu(), samples, 1, device)),
        "pinned_ms": stats_ms(time_samples(lambda: host.copy_(rows, non_blocking=True),
                                              samples, 1, device))}
    return out


def bench_steps(args, device: torch.device) -> dict:
    """``bench.py``'s chained step of the default detector (host path) and
    of ``device_preproc`` (raw frames, kernel B2), in this process."""
    from streamyolo_torch.stream import CUDAStreamDetector

    h, w = args.input
    model = bench.serving_model(bench.seeded_exp(bench.CONFIG, args.depth or 1.0,
                                                 args.width or 1.0), torch.bfloat16, device)
    work = bench.step_work(model, (1, h, w, 3))
    out = {}
    for name, scale in (("host_resize", 1), ("device_resize", 2)):
        det = CUDAStreamDetector(model, input_size=(h, w), conf_thre=bench.CONF_THRE,
                                 nms_thre=bench.NMS_THRE, num_classes=bench.NUM_CLASSES,
                                 pre_nms_topk=bench.PRE_NMS_TOPK, use_bf16=True,
                                 device_preproc=scale == 2, device=device)
        images = bench.frame_pool(1, (scale * h, scale * w), device)
        stats = bench.measure_stream(det, images, args.step_samples, args.steps)
        out[name] = bench.step_entry(stats, work, device, 1)
        del det
    return out


def budget_table(host: dict, transfers: dict, steps: dict) -> dict:
    """Per-frame budget of both configurations from the measured medians:
    resize (host-resize only), H2D from pageable memory (the input, or the
    raw frame), the chained step (``median_step_ms``), the D2H of the rows
    and the unpack; ``total_ms``
    their sum, ``h2d_pinned_ms`` beside it. ``winner``: the smaller total.
    Any piece not measured leaves the totals and the winner None."""

    def median(entry):
        return entry["median_ms"]

    d2h, unpack = median(transfers["d2h_rows"]["pageable_ms"]), median(host["unpack_ms"])
    cfg = {
        "host_resize": {"resize_ms": median(host["resize_ms"]),
                        "h2d_ms": median(transfers["h2d_input"]["pageable_ms"]),
                        "step_ms": steps["host_resize"]["median_step_ms"], "d2h_ms": d2h,
                        "unpack_ms": unpack},
        "device_resize": {"resize_ms": 0.0,
                          "h2d_ms": median(transfers["h2d_raw"]["pageable_ms"]),
                          "step_ms": steps["device_resize"]["median_step_ms"], "d2h_ms": d2h,
                          "unpack_ms": unpack},
    }
    for c in cfg.values():
        parts = list(c.values())
        c["total_ms"] = None if None in parts else sum(parts)
    for name, key in (("host_resize", "h2d_input"), ("device_resize", "h2d_raw")):
        cfg[name]["h2d_pinned_ms"] = median(transfers[key]["pinned_ms"])
    hr, dr = cfg["host_resize"]["total_ms"], cfg["device_resize"]["total_ms"]
    cfg["winner"] = None if None in (hr, dr) else (
        "device_resize" if dr < hr else "host_resize")
    return cfg


def write_train_fixture(root, n_seqs: int = 2, n_frames: int = 24, hw=(1200, 1920),
                        quality: int = 90) -> str:
    """An Argoverse-HD-layout fixture under ``root`` (``train.json`` and
    ``val.json``, one moving box a frame) of street-like JPEGs at ``hw``,
    written by the port's ``imwrite``: a sky-to-road ramp, 40 textured
    rectangles and mild noise a frame, so that decoding costs what a camera
    frame costs (flat frames compress to nearly nothing)."""
    from streamyolo_torch.data.image_io import imwrite

    h, w = hw
    ann_dir = os.path.join(root, "Argoverse-HD", "annotations")
    os.makedirs(ann_dir, exist_ok=True)
    rng = np.random.RandomState(0)
    yy = np.linspace(0, 1, h, dtype=np.float32)[:, None, None]
    base = (80 + 120 * yy) * np.ones((h, w, 3), np.float32)
    images, annotations = [], []
    seq_dirs = [f"seq{s}" for s in range(n_seqs)]

    def px(v):  # the JAX tool's sizes, which are for 1200 rows
        return max(int(v * h / 1200), 1)

    for sid in range(n_seqs):
        d = os.path.join(root, "Argoverse-1.1", "tracking", seq_dirs[sid])
        os.makedirs(d, exist_ok=True)
        for fid in range(n_frames):
            frame = base.copy()
            r = np.random.RandomState(1000 * sid + fid)
            for _ in range(40):  # buildings and vehicles: textured rectangles
                x0, y0 = r.randint(0, w - px(64)), r.randint(0, h - px(64))
                x1 = min(x0 + r.randint(px(32), px(256)), w)
                y1 = min(y0 + r.randint(px(32), px(192)), h)
                tex = r.uniform(0, 60, (y1 - y0, x1 - x0, 3)).astype(np.float32)
                frame[y0:y1, x0:x1] = r.uniform(40, 200) + tex
            frame += rng.uniform(-6, 6, frame.shape).astype(np.float32)
            name = f"f{fid}.jpg"
            imwrite(os.path.join(d, name), np.clip(frame, 0, 255).astype(np.uint8),
                    quality=quality)
            bx, by, bw, bh = w * (100 + 4 * fid) / 1920, h * 0.25, w / 16, h * 0.075
            images.append(dict(id=len(images), width=w, height=h, sid=sid, fid=fid,
                               name=name))
            annotations.append(dict(id=len(annotations), image_id=len(images) - 1,
                                    category_id=2, bbox=[bx, by, bw, bh], area=bw * bh,
                                    iscrowd=0))
    categories = [dict(id=i, name=n) for i, n in enumerate(
        "person bicycle car motorcycle bus truck traffic_light stop_sign".split())]
    data = dict(images=images, annotations=annotations, categories=categories,
                seq_dirs=seq_dirs, sequences=seq_dirs)
    for split in ("train.json", "val.json"):
        with open(os.path.join(ann_dir, split), "w") as f:
            json.dump(data, f)
    return str(root)


def train_loader(data_dir: str, batch: int, workers: int, cache: bool, no_aug: bool, size):
    """The port's train loader of ``s_s50_onex_dfp_tal_flip`` over
    ``data_dir`` at ``size``."""
    exp = bench.seeded_exp(train_sweep.CONFIG)
    exp.data_dir = data_dir
    exp.data_num_workers = workers
    exp.input_size = tuple(size)
    return exp.get_data_loader(batch_size=batch, no_aug=no_aug, cache_img=cache)


def time_loader(loader, n_batches: int, device: torch.device, warmup: int = 2,
                step_s: float = 0.0, prefetch: bool = False) -> dict:
    """Batches through ``loader`` (through ``DevicePrefetcher`` with
    ``prefetch``), each followed by a ``step_s`` sleep that stands for the
    train step (no CPU, so the workers can overlap it). ms per batch and
    images/s on the card; None elsewhere."""
    from streamyolo_torch.data.loader import DevicePrefetcher

    src = DevicePrefetcher(loader, device) if prefetch else None
    it = None if prefetch else iter(loader)

    def pull():
        return src.next() if prefetch else next(it)

    try:
        batch = None
        for _ in range(warmup):
            batch = pull()
        n_imgs = (batch["images"] if prefetch else batch[0]).shape[0]
        t0 = time.perf_counter()
        for _ in range(n_batches):
            pull()
            if step_s:
                time.sleep(step_s)
        per_batch = (time.perf_counter() - t0) / n_batches
    finally:
        if src is not None:
            src.close()
    if device.type != "cuda":
        return {"ms_per_batch": None, "imgs_per_sec": None}
    return {"ms_per_batch": per_batch * 1e3, "imgs_per_sec": n_imgs / per_batch}


def bench_train(args, device: torch.device) -> dict:
    """The training input pipeline against the measured train step."""
    h, w = args.input
    out = {"host_cores": multiprocessing.cpu_count(), "batch": args.train_batch,
           "raw_hw": [2 * h, 2 * w], "input_hw": [h, w]}
    step = train_sweep.measure(args.train_batch, device, args.depth or 0.33,
                               args.width or 0.5, (h, w), samples=3, chain=2)
    out["train_step"] = step
    step_ms = step["ms_per_step"]
    fixture = tempfile.mkdtemp(prefix="streamyolo_trainfix_")
    try:
        t0 = time.perf_counter()
        write_train_fixture(fixture, n_frames=args.train_frames, hw=(2 * h, 2 * w))
        write_s = time.perf_counter() - t0
        out["fixture_write_s"] = write_s if device.type == "cuda" else None
        jpg = os.path.join(fixture, "Argoverse-1.1", "tracking", "seq0", "f0.jpg")
        out["jpeg_mbytes"] = os.path.getsize(jpg) / 1e6
        workers = [int(x) for x in args.train_workers.split(",")]
        for cache in (False,) if args.train_no_cache_row else (False, True):
            for n in workers:
                loader = train_loader(fixture, args.train_batch, n, cache, not args.train_aug,
                                      (h, w))
                out[f"loader_w{n}" + ("_cache" if cache else "")] = time_loader(
                    loader, args.train_batches, device)
                del loader
        # overlap: the widest worker row through the prefetcher, a sleep of
        # the measured step after each batch; wall per batch should be
        # max(host, step), not their sum
        host_ms = out[f"loader_w{workers[-1]}"]["ms_per_batch"]
        loader = train_loader(fixture, args.train_batch, workers[-1], False,
                              not args.train_aug, (h, w))
        r = time_loader(loader, args.train_batches, device,
                        step_s=(step_ms or 0.0) / 1e3, prefetch=True)
        del loader
        timed = None not in (host_ms, step_ms, r["ms_per_batch"])
        ideal = max(host_ms, step_ms) if timed else None
        serial = host_ms + step_ms if timed else None
        out["overlap"] = {
            "step_ms": step_ms, "host_ms_per_batch": host_ms,
            "wall_ms_per_batch": r["ms_per_batch"], "ideal_overlap_ms": ideal,
            "no_overlap_ms": serial,
            "overlap_efficiency": (serial - r["ms_per_batch"]) / max(serial - ideal, 1e-9)
            if timed else None}
        # one worker's rate: the row with the fewest workers (0: the main
        # process does one worker's work); a host with more cores scales
        # about linearly to its core count
        per_worker = out[f"loader_w{min(workers)}"]["imgs_per_sec"]
        dev_rate = args.train_batch * 1e3 / step_ms if step_ms else None
        out["sizing"] = {
            "per_worker_imgs_per_sec": per_worker, "train_step_imgs_per_sec": dev_rate,
            "workers_to_sustain": int(np.ceil(dev_rate / per_worker))
            if per_worker and dev_rate else None}
    finally:
        shutil.rmtree(fixture, ignore_errors=True)
    return out


def make_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--host-only", action="store_true",
                   help="skip the transfers and the steps")
    p.add_argument("--samples", type=int, default=50)
    p.add_argument("--step-samples", type=int, default=bench.N_SAMPLES,
                   help="samples of the chained step")
    p.add_argument("--steps", type=int, default=bench.STEPS_PER_SAMPLE,
                   help="chained steps per sample (one synchronize each)")
    p.add_argument("--depth", type=float, default=None,
                   help="model depth (default 1.0; --train 0.33)")
    p.add_argument("--width", type=float, default=None,
                   help="model width (default 1.0; --train 0.5)")
    p.add_argument("--input", type=int, nargs=2, default=bench.INPUT, metavar=("H", "W"))
    p.add_argument("--train", action="store_true",
                   help="measure the training input pipeline instead")
    p.add_argument("--train-batch", type=int, default=16)
    p.add_argument("--train-batches", type=int, default=8, help="timed batches per row")
    p.add_argument("--train-frames", type=int, default=24,
                   help="fixture frames per sequence (2 sequences)")
    p.add_argument("--train-workers", default="0,1,2",
                   help="comma list of loader worker counts")
    p.add_argument("--train-aug", action="store_true",
                   help="the mosaic branch (the shipped configs train no_aug from epoch 0)")
    p.add_argument("--train-no-cache-row", action="store_true",
                   help="skip the --cache (memmap) rows")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = make_parser().parse_args(argv)
    device = resolve_device(args.device)
    if args.train:
        results = {"device": card(device), "train": bench_train(args, device)}
        print(json.dumps(results), flush=True)
        return 0
    results = {"device": card(device), "host": bench_host(args.samples, args.input, device)}
    if not args.host_only:
        results["transfers"] = bench_transfers(args.samples, args.input, device)
        results["step"] = bench_steps(args, device)
        results["budget"] = budget_table(results["host"], results["transfers"],
                                         results["step"])
        b = results["budget"]
        if b["winner"]:
            print(f"budget: host-resize {b['host_resize']['total_ms']:.3f} ms/frame, "
                  f"device-resize {b['device_resize']['total_ms']:.3f} ms/frame -> "
                  f"{b['winner']}", file=sys.stderr)
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
