#!/usr/bin/env python3
"""Training CLI of the port, the counterpart of ``tools/train.py``.

    python -m streamyolo_torch.tools.train -f cfgs/l_s50_onex_dfp_tal_filp.py \\
        -b 8 --fp16 [--device cpu] [-c weights.pth | --resume] [opts: key value ...]

``-f`` / ``-n`` name one of the port's configs (a path into ``cfgs/`` is
matched by its basename) or a config file of its own; ``opts`` are ``key
value`` overrides of the ``Exp``. ``-b`` is the batch; ``--fp16`` trains
under bf16 autocast with float32 master weights (and evaluates bf16
modules); ``-c`` fine-tunes from a ``.pth`` / ``.safetensors`` state dict
(shape-tolerant), ``--resume`` continues from ``<output_dir>/<name>/
latest_ckpt.pth`` (or ``-c``). After every epoch the EMA weights are
evaluated (sequential-dedup for ONE / TWO configs; ``--no-dedup`` for the
dual-frame forward) and checkpoints are written under ``output_dir``. Runs
on ``cuda`` unless ``--device cpu``.

Not ported yet, and refused: several machines (``--num_machines`` > 1,
``--dist-url``), the wandb logger, ``--cache``, and the mosaic branch
(configs with ``no_aug_epochs < max_epoch``).
"""

from __future__ import annotations

import argparse
import random
import warnings
from typing import Callable, Optional, Sequence

DIST_MESSAGE = "multi-machine training is not ported yet (ROADMAP queue A item 14)"


def make_parser():
    parser = argparse.ArgumentParser("streamyolo_torch train")
    parser.add_argument("-expn", "--experiment-name", type=str, default=None)
    parser.add_argument("-n", "--name", type=str, default=None, help="model name")
    parser.add_argument("-f", "--exp_file", default=None, type=str, help="experiment config file")
    parser.add_argument("-b", "--batch-size", type=int, default=32, help="total batch size")
    parser.add_argument("-c", "--ckpt", default=None, type=str,
                        help="checkpoint file (.pth or .safetensors)")
    parser.add_argument("--resume", default=False, action="store_true", help="resume training")
    parser.add_argument("-e", "--start_epoch", default=None, type=int, help="resume start epoch")
    parser.add_argument("--fp16", dest="fp16", default=False, action="store_true",
                        help="bf16 autocast with float32 master weights")
    parser.add_argument("--cache", dest="cache", default=False, action="store_true",
                        help="cache resized images in RAM (not ported yet)")
    parser.add_argument("-o", "--occupy", dest="occupy", default=False, action="store_true",
                        help="accepted for compatibility; changes nothing")
    parser.add_argument("--dist-backend", default="nccl", type=str,
                        help="accepted for compatibility; one process trains on one card")
    parser.add_argument("--num_machines", default=1, type=int, help=DIST_MESSAGE)
    parser.add_argument("--machine_rank", default=0, type=int, help=DIST_MESSAGE)
    parser.add_argument("--dist-url", default=None, type=str, help=DIST_MESSAGE)
    parser.add_argument("-l", "--logger", type=str, default="tensorboard",
                        help="logger backend: tensorboard (wandb is not ported yet)")
    parser.add_argument("--seed", default=None, type=int)
    parser.add_argument("--dedup", dest="dedup", default=False, action="store_true",
                        help="accepted for compatibility: the sequential-dedup per-epoch "
                             "eval is the default for ONE / TWO configs")
    parser.add_argument("--no-dedup", dest="no_dedup", default=False, action="store_true",
                        help="per-epoch eval with the dual-frame (off_pipe) forward")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER,
                        help="extra 'key value' Exp overrides")
    return parser


def main(argv: Optional[Sequence[str]] = None,
         load_frame: Optional[Callable[[dict], "object"]] = None):
    """Train as the command line says; returns the ``Trainer``.
    ``load_frame`` (image dict -> BGR uint8 frame) supplies the pixels of
    both splits instead of reading them from ``data_dir``."""
    args = make_parser().parse_args(argv)
    if args.num_machines > 1 or args.dist_url:
        raise NotImplementedError(DIST_MESSAGE)

    from streamyolo_torch.exp import get_exp

    exp = get_exp(args.exp_file, args.name)
    exp.merge(args.opts)
    if args.seed is not None:
        exp.seed = args.seed
    if exp.seed is not None:
        import numpy as np
        import torch

        random.seed(exp.seed)
        np.random.seed(exp.seed)
        torch.manual_seed(exp.seed)
        warnings.warn("Seed set: determinism may slow data loading (the reference's caveat).")
    if not args.experiment_name:
        args.experiment_name = exp.exp_name
    args.load_frame = load_frame

    import torch

    torch.backends.cudnn.benchmark = True  # as the reference trainer
    if not args.fp16:  # float32 means float32, not TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    trainer = exp.get_trainer(args)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
