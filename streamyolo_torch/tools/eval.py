#!/usr/bin/env python3
"""Offline evaluation CLI of the port (pseudo-streaming sAP / plain AP), the
counterpart of ``tools/eval.py``.

    python -m streamyolo_torch.tools.eval -f cfgs/l_s50_onex_dfp_tal_filp.py \\
        -c weights.pth -b 64 --fp16 [--device cpu] [opts: key value ...]

``-f`` / ``-n`` name one of the port's configs (``streamyolo_torch/cfgs``;
a path into ``cfgs/`` is matched by its basename) or a config file of its
own. ``-c`` reads a ``.pth`` state dict (raw or under ``model``) or a
``.safetensors`` file with torch names; a JAX ``.pkl`` checkpoint pickles
flax and optax objects and cannot be read without jax: convert it with
``tools/export_safetensors.py``. Eval loads strictly (``--tolerant`` keeps
init values for missing or mismatched entries). ``--fuse`` folds BN into
the convs in float32 before the weights are cast; ``--fp16`` builds bf16
modules. ``--int8`` serves the int8 PTQ model (``quant/ptq.py``): BN
folded, activation ranges calibrated on the first ``--calib-batches`` val
batches (in ``--speed`` mode on the timed random batch), every CBS conv
through the int8 kernel; ``--fuse`` is then ignored (the fold is part of
quantizing). ONE/TWO configs evaluate through the sequential-dedup forward
with its first-batch guard against the dual-frame forward (``--no-dedup``
for the dual-frame forward alone); ``--speed`` times the batched forward
and postprocess on random input with the init weights. Runs on ``cuda``
unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import itertools
import os
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np


def make_parser():
    parser = argparse.ArgumentParser("streamyolo_torch eval")
    parser.add_argument("-expn", "--experiment-name", type=str, default=None)
    parser.add_argument("-n", "--name", type=str, default=None)
    parser.add_argument("-f", "--exp_file", default=None, type=str)
    parser.add_argument("-b", "--batch-size", type=int, default=64)
    parser.add_argument("-c", "--ckpt", default=None, type=str)
    parser.add_argument("--conf", default=None, type=float)
    parser.add_argument("--nms", default=None, type=float)
    parser.add_argument("--tsize", default=None, type=int, nargs=2, metavar=("H", "W"))
    parser.add_argument("--fuse", dest="fuse", default=False, action="store_true",
                        help="fold BN into the conv weights before eval")
    parser.add_argument("--fp16", dest="fp16", default=False, action="store_true",
                        help="bf16 modules (the card's mixed precision)")
    parser.add_argument("--dedup", action="store_true", default=False,
                        help="require the sequential-dedup forward (the default "
                             "for ONE/TWO configs); fails for a STILL config")
    parser.add_argument("--no-dedup", dest="no_dedup", action="store_true", default=False,
                        help="the dual-frame (off_pipe) forward: both halves of "
                             "every 6-channel sample through the backbone")
    parser.add_argument("--int8", dest="int8", default=False, action="store_true",
                        help="int8 PTQ serving path (quant/ptq.py): fold BN, calibrate "
                             "activation scales on val batches, run the CBS convs "
                             "through the int8 kernel. int8 is approximate: validate "
                             "accuracy before shipping")
    parser.add_argument("--calib-batches", type=int, default=8,
                        help="val batches observed by the --int8 calibration (absmax)")
    parser.add_argument("--per-channel-act", dest="per_channel_act", default=False,
                        action="store_true",
                        help="--int8 with one activation scale per input channel "
                             "(folded into the kernel, the same conv cost)")
    parser.add_argument("--seed", default=None, type=int,
                        help="seed of the init weights (--speed, --tolerant)")
    parser.add_argument("--test", dest="test", default=False, action="store_true",
                        help="evaluate on the test split (test.json)")
    parser.add_argument("--speed", dest="speed", default=False, action="store_true",
                        help="speed-only test on random input, no dataset")
    parser.add_argument("--tolerant", dest="tolerant", default=False, action="store_true",
                        help="shape-tolerant checkpoint load (missing or mismatched "
                             "entries keep their init values); eval loads strictly "
                             "by default")
    parser.add_argument("--legacy", dest="legacy", default=False, action="store_true",
                        help="accepted for compatibility; changes nothing")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return parser


def load_checkpoint(path: str) -> Dict:
    """The state dict of a ``.pth`` or ``.safetensors`` file. A JAX ``.pkl``
    raises before anything is read."""
    from streamyolo_torch.utils.weights import load_state_dict_file

    if path.endswith(".pkl"):
        raise ValueError(
            f"{path} is a JAX checkpoint (a pickle of flax and optax train state) "
            "that cannot be read without jax; convert it with "
            "tools/export_safetensors.py and pass the .safetensors file")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"checkpoint not found: {path}")
    return load_state_dict_file(path)


def speed_batch(exp, batch_size: int) -> np.ndarray:
    """The random 6-channel uint8 batch that ``--speed`` times."""
    h, w = exp.test_size
    return np.random.RandomState(0).randint(0, 255, (batch_size, h, w, 6)).astype(np.uint8)


def speed_test(exp, model, batch_size: int, iters: int = 10) -> float:
    """Median seconds of the batched forward + postprocess + D2H on
    ``speed_batch`` (3 warm-up batches first)."""
    import torch

    from streamyolo_torch.ops.nms import postprocess_fixed

    imgs = speed_batch(exp, batch_size)
    forward_fn = exp.get_forward_fn(model)

    def run():
        with torch.inference_mode():
            postprocess_fixed(forward_fn(imgs), exp.num_classes, exp.test_conf,
                              exp.nmsthre).cpu()

    for _ in range(3):
        run()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def main(argv: Optional[Sequence[str]] = None,
         load_frame: Optional[Callable[[dict], np.ndarray]] = None):
    """Evaluate as the command line says; returns ``ap``, ``ap50``, the
    ``summary``, the COCO ``rows`` and the evaluator's ``stats`` (or the
    ``--speed`` time). ``load_frame`` (image dict -> BGR uint8 frame)
    supplies the pixels instead of reading them from ``data_dir``."""
    args = make_parser().parse_args(argv)
    if args.dedup and args.no_dedup:
        raise SystemExit("--dedup conflicts with --no-dedup")

    from streamyolo_torch.exp import get_exp
    from streamyolo_torch.utils.fuse import fuse_state_dict
    from streamyolo_torch.utils.logger import setup_logger
    from streamyolo_torch.utils.weights import merge_state_dict

    exp = get_exp(args.exp_file, args.name)
    exp.merge(args.opts)
    if not args.experiment_name:
        args.experiment_name = exp.exp_name
    if args.conf is not None:
        exp.test_conf = args.conf
    if args.nms is not None:
        exp.nmsthre = args.nms
    if args.tsize is not None:
        exp.test_size = tuple(args.tsize)
    if args.fp16:
        exp.compute_dtype = "bfloat16"
    if args.seed is not None:
        exp.seed = args.seed
    if args.test:
        exp.val_ann = "test.json"
    can_dedup = exp.evaluator_name in ("onex", "twox")
    if args.dedup and not can_dedup:
        raise SystemExit("--dedup needs a sequential (ONE/TWO) pairing")

    file_name = os.path.join(exp.output_dir, args.experiment_name)
    os.makedirs(file_name, exist_ok=True)
    logger = setup_logger(file_name, filename="val_log.txt")
    logger.info(f"Args: {args}")

    # the checkpoint is read (or refused) before the model is built
    state_dict = exp.init_model()
    if not args.speed:  # speed-only mode runs on the init weights
        ckpt_file = args.ckpt or os.path.join(file_name, "best_ckpt.pth")
        logger.info(f"loading checkpoint from {ckpt_file}")
        state_dict = merge_state_dict(state_dict, load_checkpoint(ckpt_file),
                                      strict=not args.tolerant)
        logger.info("loaded checkpoint done.")
    if args.fuse and not args.int8:
        logger.info("\tFusing conv+BN...")
        state_dict = fuse_state_dict(state_dict)
    import torch

    torch.backends.cudnn.benchmark = True  # as the reference's tools/eval.py
    if exp.compute_dtype == "float32":  # float32 means float32, not TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    model = exp.get_model(args.device)
    model.load_state_dict(state_dict, strict=True)

    evaluator = None
    if args.int8:
        from streamyolo_torch.quant import quantize_for_serving

        if args.speed:  # no dataset: calibrate on the batch that is timed
            calib = [speed_batch(exp, args.batch_size)]
        else:
            evaluator = exp.get_evaluator(args.batch_size, load_frame=load_frame)
            calib = [batch[0] for batch in itertools.islice(
                iter(evaluator.dataloader), max(1, args.calib_batches))]
        logger.info(f"\tint8 PTQ: folding BN + calibrating on {len(calib)} batches"
                    f"{' (per-channel act scales)' if args.per_channel_act else ''}...")
        model.load_state_dict(quantize_for_serving(
            model, state_dict, calib, per_channel_act=args.per_channel_act), strict=True)

    if args.speed:
        from streamyolo_torch.utils.model_info import get_model_info

        logger.info(get_model_info(model, exp.test_size))
        med = speed_test(exp, model, args.batch_size)
        logger.info(f"speed test: {med * 1e3:.1f} ms / batch of {args.batch_size} "
                    f"({args.batch_size / med:.1f} imgs/s)")
        return {"speed_s_per_batch": med}

    if evaluator is None:
        evaluator = exp.get_evaluator(args.batch_size, load_frame=load_frame)
    if can_dedup and not args.no_dedup:
        logger.info("sequential-dedup eval (default; --no-dedup for the dual-frame forward)")
        forward_fn = exp.get_dedup_forward_fn(model, evaluator.dataset)
    else:
        forward_fn = exp.get_forward_fn(model)
    (ap, ap50, summary), rows = evaluator.evaluate(forward_fn, return_outputs=True)
    logger.info(f"\n{summary}")
    logger.info(f"AP: {ap:.4f}  AP50: {ap50:.4f}")
    return {"ap": float(ap), "ap50": float(ap50), "summary": summary, "rows": rows,
            "stats": evaluator.last_stats}


if __name__ == "__main__":
    main()
