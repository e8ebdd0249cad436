#!/usr/bin/env python3
"""Streaming sAP rehearsal of the port: the whole streaming-perception chain
in one command, the counterpart of ``tools/sap_rehearsal.py``.

    python -m streamyolo_torch.tools.sap_rehearsal --out-dir OUT --measure 20

The real detector (``CUDAStreamDetector``) produces real detections while a
``SimClock`` advances by latencies replayed from a runtime zoo, so one
latency measurement on the card predicts the streaming sAP of a deployment
without a live 30 fps feed. Stages (each a function below, which
``chip_smoke.py`` also calls):

  1. dataset: an Argoverse-HD layout (``--data-root`` / ``--annot-path``) or
     the synthetic one (``data/dbcode.py``), written as JPEGs or, with
     ``--in-memory``, rendered on demand (no cv2 needed);
  2. latency: ``--latency-ms`` samples, a ``--zoo`` entry, ``--measure N``
     (wall time of N detector calls, frame in -> rows on the host) or
     ``--measure-chain N`` (CUDA events around 50 chained device steps, N
     samples); written to ``<out>/runtime_zoo.pkl``;
  3. ground truth: the annotations (``--gt annotations``) or pseudo ground
     truth from an every-frame run of the same detector (``--gt oracle``,
     the default), so sAP measures staleness against the detector's own
     zero-latency output;
  4. streaming run: ``run_streaming_detection`` under ``SimClock``;
  5. scoring: ``streaming_eval`` (pairing + native COCOeval), one table row
     on stdout and ``<out>/rehearsal_summary.json``.

The model is StreamYOLO ``--size s|m|l`` (the shipped ONE config of that
size), or the config of ``-f`` with ``key value`` overrides after the other
flags (as the JAX tool's ``-f`` and ``opts``): ``--weights`` (``.pth`` or
``.safetensors`` with torch names) or random weights from ``--seed``.
``--perfect-detector`` replaces the model with an oracle that returns the
input frame's annotations, which isolates the cost of latency and motion
alone (no model, no card).
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import statistics
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser("streamyolo_torch streaming sAP rehearsal")
    p.add_argument("--size", choices=["s", "m", "l"], default="l", help="StreamYOLO size")
    p.add_argument("-f", "--exp_file", "--config", dest="exp_file", type=str, default=None,
                   help="config (a port config name or a path into cfgs/); replaces "
                        "--size; --config is the JAX tool's spelling")
    p.add_argument("--weights", "-c", type=str, default=None,
                   help=".pth or .safetensors state dict; omitted = random "
                        "weights from --seed (fine with --gt oracle)")
    p.add_argument("--out-dir", type=str, required=True)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--device-preproc", action="store_true", default=False,
                   help="0.5x downsample on the card (kernel B2); raw frames "
                        "must be exactly 2x the input size")
    # dataset: either point at real data or synthesize
    p.add_argument("--data-root", type=str, default=None)
    p.add_argument("--annot-path", type=str, default=None)
    p.add_argument("--seqs", type=int, default=4, help="synthetic fixture: sequences")
    p.add_argument("--frames", type=int, default=75,
                   help="synthetic fixture: frames per sequence")
    p.add_argument("--frame-size", type=int, nargs=2, default=(300, 480),
                   metavar=("H", "W"), help="synthetic frame size")
    p.add_argument("--in-memory", action="store_true", default=False,
                   help="keep the synthetic fixture in memory (no JPEGs, no cv2)")
    p.add_argument("--seed", type=int, default=0)
    # latency source
    p.add_argument("--latency-ms", type=str, default=None,
                   help="comma-separated per-frame latency samples in ms")
    p.add_argument("--zoo", type=str, default=None, help="existing zoo pkl")
    p.add_argument("--zoo-name", type=str, default=None)
    p.add_argument("--measure", type=int, default=0, metavar="N",
                   help="measure N per-call wall times of the detector")
    p.add_argument("--measure-chain", type=int, default=0, metavar="N",
                   help="N samples of CUDA events around 50 chained device steps")
    p.add_argument("--perf-factor", type=float, default=1.0)
    # protocol
    p.add_argument("--fps", type=float, default=30.0)
    p.add_argument("--eta", type=int, default=0)
    p.add_argument("--det-stride", type=int, default=1)
    p.add_argument("--dynamic-schedule", action="store_true", default=False)
    p.add_argument("--in_scale", type=float, default=0.5)
    p.add_argument("--conf", type=float, default=0.01)
    p.add_argument("--nms", type=float, default=0.65)
    p.add_argument("--fp32", action="store_true", default=False)
    p.add_argument("--gt", choices=["oracle", "annotations"], default="oracle")
    p.add_argument("--pgt-score-th", type=float, default=0.3,
                   help="score threshold for --gt oracle pseudo annotations")
    p.add_argument("--perfect-detector", action="store_true", default=False,
                   help="an oracle returning the input frame's annotations "
                        "replaces the model; implies --gt annotations")
    p.add_argument("opts", default=None, nargs=argparse.REMAINDER,
                   help="'key value' overrides of the config")
    return p.parse_args(argv)


def build_detector(size: str, *, input_size: Tuple[int, int], weights: Optional[str] = None,
                   seed: int = 0, fp32: bool = False, device: str = "cuda", exp=None,
                   **det_kw):
    """``CUDAStreamDetector`` over the model of ``exp`` (by default the
    shipped ONE config of ``size``: StreamYOLO with the TAL head, 8
    classes), bf16 modules unless ``fp32``, with ``weights`` or random
    weights drawn from ``seed``. ``det_kw`` goes to the detector."""
    from streamyolo_torch.exp import SIZE_CONFIGS, get_exp
    from streamyolo_torch.stream import CUDAStreamDetector
    from streamyolo_torch.utils.weights import load_state_dict_file

    exp = exp or get_exp(exp_name=SIZE_CONFIGS[size])
    exp.compute_dtype = "float32" if fp32 else "bfloat16"
    exp.seed = seed
    model = exp.get_model(device)
    model.load_state_dict(load_state_dict_file(weights) if weights else exp.init_model(),
                          strict=True)
    return CUDAStreamDetector(model, input_size=input_size, num_classes=exp.num_classes,
                              use_bf16=not fp32, device=device, **det_kw)


def measure_per_call(detector, frame: np.ndarray, n: int) -> List[float]:
    """Wall seconds of ``n`` detector calls on ``frame`` (host frame in, host
    rows out: the D2H ends each call), after the detector's star step."""
    detector.reset()
    detector(frame)
    samples = []
    for _ in range(n):
        t0 = time.perf_counter()
        detector(frame)
        samples.append(time.perf_counter() - t0)
    return samples


def measure_chain(detector, frame: np.ndarray, n: int, chain: int = 50) -> List[float]:
    """Device seconds per step: ``n`` samples, each CUDA events around
    ``chain`` steady ``step`` calls that carry the buffer, one synchronise
    per sample (the counterpart of the JAX tool's ``fori_loop`` chain).
    Needs a CUDA detector."""
    import torch

    if detector.device.type != "cuda":
        raise ValueError("--measure-chain times the card with CUDA events; "
                         f"the detector runs on {detector.device}")
    image = torch.from_numpy(np.ascontiguousarray(
        detector.preproc(frame))).to(detector.device)[None]
    detector.reset()
    detector.step(image)  # star
    for _ in range(3):
        detector.step(image)
    samples = []
    for _ in range(max(n, 2)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(chain):
            detector.step(image)
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / 1e3 / chain)
    return samples


def offline_ccf(db, detector, load_frame: Callable[[dict], np.ndarray]) -> List[dict]:
    """Every-frame zero-latency detections in CCF format (the oracle run),
    the detector reset at each sequence's first frame."""
    from streamyolo_torch.stream.bbox import ltrb2ltwh

    results_ccf = []
    for img in db.dataset["images"]:
        if img["fid"] == 0:
            detector.reset()
        bboxes, scores, labels, _ = detector(load_frame(img))
        if len(bboxes):
            ltwh = ltrb2ltwh(bboxes)
            for i in range(len(bboxes)):
                results_ccf.append(dict(
                    image_id=img["id"], bbox=[float(v) for v in ltwh[i]],
                    score=float(scores[i]), category_id=int(labels[i])))
    return results_ccf


def pseudo_ground_truth(db, oracle_ccf: List[dict], score_th: float, out_dir: str):
    """The pseudo ground truth of an oracle run as a COCO index (and
    ``<out_dir>/pseudo_gt.json``). Raises if it holds no annotation."""
    from streamyolo_torch.data import COCO, pseudo_gt_from_detections

    pgt = pseudo_gt_from_detections(db.dataset, oracle_ccf, score_th=score_th)
    if not pgt["annotations"]:
        raise ValueError(
            f"oracle produced no detections above score {score_th}; lower "
            "--pgt-score-th or pass trained --weights")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "pseudo_gt.json")
    with open(path, "w") as f:
        json.dump(pgt, f)
    return COCO(path)


def run_perfect_streaming(db, out_dir: str, runtime_dist, fps: float = 30.0,
                          det_stride: int = 1, dynamic_schedule: bool = False) -> Dict:
    """Whole-dataset simulated run with the ground-truth oracle detector (no
    frames, no model): per-sequence pkls + ``time_info.pkl``, the layout of
    ``run_streaming_detection``."""
    from streamyolo_torch.stream import SimClock, SimulatedDetector, stream_sequence

    os.makedirs(out_dir, exist_ok=True)
    by_sid_fid: Dict[Tuple[int, int], Tuple[list, list]] = {}
    for ann in db.dataset["annotations"]:
        img = db.imgs[ann["image_id"]]
        x, y, w, h = ann["bbox"]
        entry = by_sid_fid.setdefault((img["sid"], img["fid"]), ([], []))
        entry[0].append([x, y, x + w, y + h])
        entry[1].append(ann["category_id"])

    runtime_all, n_processed, n_total = [], 0, 0
    for sid, seq in enumerate(db.dataset["sequences"]):
        n_frames = sum(1 for i in db.imgs.values() if i["sid"] == sid)
        det = SimulatedDetector(
            lambda f, sid=sid: by_sid_fid.get((sid, f), ([], [])), runtime_dist)
        result = stream_sequence(
            list(range(n_frames)), det, fps=fps, clock=SimClock(),
            det_stride=det_stride, dynamic_schedule=dynamic_schedule,
            runtime_dist=runtime_dist, frame_arg_is_index=True)
        with open(os.path.join(out_dir, seq + ".pkl"), "wb") as f:
            pickle.dump(result, f)
        runtime_all += result["runtime"]
        n_processed += len(result["results_parsed"])
        n_total += n_frames
    time_info = {
        "runtime_all": runtime_all,
        "n_processed": n_processed,
        "n_total": n_total,
        "n_small_runtime": int((np.asarray(runtime_all) < 1.0 / fps).sum())
        if runtime_all else 0,
    }
    with open(os.path.join(out_dir, "time_info.pkl"), "wb") as f:
        pickle.dump(time_info, f)
    return time_info


def write_zoo(out_dir: str, name: str, samples: List[float]) -> str:
    """Add ``samples`` (seconds) as zoo entry ``name`` to
    ``<out_dir>/runtime_zoo.pkl``; returns the path."""
    zoo_path = os.path.join(out_dir, "runtime_zoo.pkl")
    zoo = {}
    if os.path.isfile(zoo_path):
        with open(zoo_path, "rb") as f:
            zoo = pickle.load(f)
    zoo[name] = {"type": "empirical", "samples": list(samples)}
    with open(zoo_path, "wb") as f:
        pickle.dump(zoo, f)
    return zoo_path


def summarize(config: str, gt: str, fps: float, runtime_dist, n_samples: int,
              perf_factor: float, time_info: Dict, assoc: Dict, eval_summary) -> Dict:
    """The ``rehearsal_summary.json`` dict (the JAX tool's keys)."""
    stats = [float(v) for v in eval_summary["stats"]] if eval_summary else []
    return {
        "config": config,
        "gt": gt,
        "fps": fps,
        "latency_ms": {
            "mean": round(1e3 * runtime_dist.mean(), 3),
            "min": round(1e3 * runtime_dist.min(), 3),
            "max": round(1e3 * runtime_dist.max(), 3),
            "n_samples": n_samples,
        },
        "perf_factor": perf_factor,
        "frames": {"total": time_info["n_total"],
                   "processed": time_info["n_processed"],
                   "faster_than_frame_interval": time_info["n_small_runtime"]},
        "association": assoc,
        "sAP": round(100 * stats[0], 2) if stats else None,
        "sAP50": round(100 * stats[1], 2) if stats else None,
        "sAP75": round(100 * stats[2], 2) if stats else None,
    }


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    args = parse_args(argv)
    from streamyolo_torch.data import COCO, SyntheticArgoverse, make_synthetic_argoverse
    from streamyolo_torch.exp import get_exp
    from streamyolo_torch.stream import (
        SimClock,
        dist_from_zoo,
        run_streaming_detection,
        streaming_eval,
    )
    from streamyolo_torch.stream.online import imread_loader

    os.makedirs(args.out_dir, exist_ok=True)
    exp = get_exp(args.exp_file) if args.exp_file else None
    if exp is not None:
        exp.merge(args.opts)
    elif args.opts:
        raise SystemExit(f"config overrides {args.opts} need -f")
    config = exp.exp_name if exp is not None else f"streamyolo_{args.size}"

    # ---- 1. dataset
    load_frame = None
    if args.data_root:
        if not args.annot_path:
            raise SystemExit("--data-root needs --annot-path")
        db = COCO(args.annot_path)
    elif args.in_memory:
        synth = SyntheticArgoverse(seq_lens=(args.frames,) * args.seqs,
                                   size=tuple(args.frame_size), seed=args.seed)
        db, load_frame = COCO(synth.data), synth.frame
    else:
        fix = os.path.join(args.out_dir, "fixture")
        annot_path = os.path.join(fix, "Argoverse-HD", "annotations", "val.json")
        if not os.path.isfile(annot_path):
            print(f"[1/5] synthesizing {args.seqs}x{args.frames} frames "
                  f"@ {args.frame_size[0]}x{args.frame_size[1]} under {fix}")
            make_synthetic_argoverse(
                fix, seq_lens=(args.frames,) * args.seqs,
                size=tuple(args.frame_size), seed=args.seed)
        args.data_root = os.path.join(fix, "Argoverse-1.1", "tracking")
        db = COCO(annot_path)
    if load_frame is None and not args.perfect_detector:
        load_frame = imread_loader(db, args.data_root)

    # ---- model + detector
    img0 = next(iter(db.imgs.values()))
    detector = None
    if args.perfect_detector:
        if args.measure or args.measure_chain:
            raise SystemExit("--measure/--measure-chain need the real detector")
        args.gt = "annotations"
    else:
        input_size = (int(img0["height"] * args.in_scale), int(img0["width"] * args.in_scale))
        detector = build_detector(
            args.size, input_size=input_size, weights=args.weights, seed=args.seed,
            fp32=args.fp32, device=args.device, exp=exp, in_scale=args.in_scale,
            conf_thre=args.conf, nms_thre=args.nms, device_preproc=args.device_preproc)
        detector.warmup(5)

    # ---- 2. latency -> zoo
    name = args.zoo_name or config
    if args.latency_ms:
        samples = [float(v) / 1e3 for v in args.latency_ms.split(",")]
    elif args.zoo:
        with open(args.zoo, "rb") as f:
            entries = pickle.load(f)
        if name not in entries:
            raise SystemExit(
                f"zoo entry '{name}' not in {args.zoo} "
                f"(has: {sorted(entries)}); pick one with --zoo-name")
        samples = list(entries[name]["samples"])
    elif args.measure or args.measure_chain:
        frame = np.asarray(
            255 * np.random.RandomState(0).rand(img0["height"], img0["width"], 3), np.uint8)
        if args.measure:
            samples = measure_per_call(detector, frame, args.measure)
            print(f"[2/5] measured {len(samples)} per-call latencies on "
                  f"{detector.device}: mean {1e3 * np.mean(samples):.3f} ms, "
                  f"p99 {1e3 * np.percentile(samples, 99):.3f} ms")
        else:
            samples = measure_chain(detector, frame, args.measure_chain)
            print(f"[2/5] chained device step: min {1e3 * np.min(samples):.3f} ms, "
                  f"median {1e3 * statistics.median(samples):.3f} ms over "
                  f"{len(samples)} samples of 50 chained steps each")
    else:
        raise SystemExit("need a latency source: --latency-ms, --zoo, "
                         "--measure, or --measure-chain")
    zoo_path = write_zoo(args.out_dir, name, samples)
    runtime_dist = dist_from_zoo(zoo_path, name, perf_factor=args.perf_factor,
                                 seed=args.seed)

    # ---- 3. ground truth
    if args.gt == "oracle":
        print("[3/5] offline every-frame oracle run (pseudo-GT: sAP scores "
              "staleness vs the detector's own zero-latency output)")
        oracle = offline_ccf(db, detector, load_frame)
        with open(os.path.join(args.out_dir, "oracle_ccf.pkl"), "wb") as f:
            pickle.dump(oracle, f)
        db = pseudo_ground_truth(db, oracle, args.pgt_score_th, args.out_dir)

    # ---- 4. simulated-clock streaming run
    print(f"[4/5] streaming run: SimClock, latency mean "
          f"{1e3 * runtime_dist.mean():.3f} ms over {len(db.imgs)} frames")
    run_dir = os.path.join(args.out_dir, "stream_run")
    if args.perfect_detector:
        time_info = run_perfect_streaming(
            db, run_dir, runtime_dist, fps=args.fps,
            det_stride=args.det_stride, dynamic_schedule=args.dynamic_schedule)
    else:
        time_info = run_streaming_detection(
            db, args.data_root, run_dir, detector, fps=args.fps,
            det_stride=args.det_stride, dynamic_schedule=args.dynamic_schedule,
            clock=SimClock(), runtime_dist=runtime_dist, overwrite=True,
            load_frame=load_frame)

    # ---- 5. pairing + COCOeval
    print("[5/5] pairing + COCOeval")
    eval_summary, assoc = streaming_eval(
        db, run_dir, fps=args.fps, eta=args.eta, out_dir=run_dir, overwrite=True)
    summary = summarize(config, args.gt, args.fps, runtime_dist, len(samples),
                        args.perf_factor, time_info, assoc, eval_summary)
    with open(os.path.join(args.out_dir, "rehearsal_summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print("| config | latency (ms) | fps | frames | in_time | mismatch | "
          "sAP | sAP50 | sAP75 |")
    print(f"| {summary['config']} | {summary['latency_ms']['mean']:.2f} | "
          f"{args.fps:g} | {time_info['n_processed']}/{time_info['n_total']} | "
          f"{assoc['in_time']} | {assoc['mismatch']} | "
          f"{summary['sAP']} | {summary['sAP50']} | {summary['sAP75']} |")
    return summary


if __name__ == "__main__":
    main()
