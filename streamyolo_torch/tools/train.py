#!/usr/bin/env python3
"""Training CLI of the port, the counterpart of ``tools/train.py``.

    python -m streamyolo_torch.tools.train -f cfgs/l_s50_onex_dfp_tal_filp.py \\
        -b 8 --fp16 [-d N] [--device cpu] [-c weights.pth | --resume] [opts: key value ...]

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

Data parallel, as the JAX package trains over every local chip: ``-d N``
starts N local worker processes (``spawn``), one per card, by default one
per visible card; ``--num_machines M --machine_rank m --dist-url
tcp://host:port`` spans M hosts, rank ``m * N + local rank`` of ``M * N``,
over ``--dist-backend`` (``nccl``; ``gloo`` also on the CPU, where ``-d``
counts CPU workers). ``-b`` stays the global batch; each rank loads ``-b /
world`` and the step computes what one process computes on the whole batch
(``parallel/``). A world of 1 trains in this process with no group; with
``-d 1`` and several machines this process is the rank. A rank that fails
makes the others fail (the spawned workers are terminated; a collective
with a dead peer raises), and a group that does not form raises.

Configs with ``no_aug_epochs < max_epoch`` train their first epochs on the
mosaic branch (``data/mosaic.py``, no cv2); ``--cache`` keeps the resized
frames in a memmap under ``data_dir``; ``-l wandb`` logs to Weights &
Biases, a no-op without the ``wandb`` package.
"""

from __future__ import annotations

import argparse
import random
import warnings
from typing import Callable, Optional, Sequence


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
                        help="cache resized images in a memmap under data_dir")
    parser.add_argument("-o", "--occupy", dest="occupy", default=False, action="store_true",
                        help="accepted for compatibility; changes nothing")
    parser.add_argument("-d", "--devices", default=None, type=int,
                        help="local worker processes, one per card (default: every "
                             "visible card; 1 on the CPU or a named card)")
    parser.add_argument("--dist-backend", default="nccl", type=str,
                        help="process group backend: nccl, or gloo (also on the CPU)")
    parser.add_argument("--num_machines", default=1, type=int, help="number of hosts")
    parser.add_argument("--machine_rank", default=0, type=int, help="this host's rank")
    parser.add_argument("--dist-url", default=None, type=str,
                        help="the group's rendezvous, tcp://host:port (a free local port "
                             "by default on one host)")
    parser.add_argument("-l", "--logger", type=str, default="tensorboard",
                        help="logger backend: tensorboard or wandb")
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
    """Train as the command line says; returns the ``Trainer`` of this
    process (``None`` when it spawned the ``-d`` workers). ``load_frame``
    (image dict -> BGR uint8 frame) supplies the pixels of both splits
    instead of reading them from ``data_dir``; the spawned workers get it
    pickled, so it must be picklable (a module-level class or function)."""
    import torch

    from streamyolo_torch.parallel import free_local_port
    from streamyolo_torch.utils.device import resolve_device

    args = make_parser().parse_args(argv)
    if args.devices is None:  # every visible card, unless one is named
        dev = resolve_device(args.device)
        args.devices = torch.cuda.device_count() if dev.type == "cuda" and dev.index is None else 1
    world = args.num_machines * args.devices
    if args.devices < 1 or not 0 <= args.machine_rank < args.num_machines:
        raise ValueError(f"bad topology: -d {args.devices}, --num_machines "
                         f"{args.num_machines}, --machine_rank {args.machine_rank}")
    if args.batch_size % world:
        raise ValueError(f"the batch {args.batch_size} does not split over {world} ranks")
    if world == 1:
        return _train(args, load_frame)
    if args.dist_url is None:
        if args.num_machines > 1:
            raise ValueError("--num_machines > 1 needs --dist-url tcp://host:port")
        args.dist_url = f"tcp://127.0.0.1:{free_local_port()}"
    if args.devices == 1:
        return _worker(0, args, load_frame)
    torch.multiprocessing.start_processes(_worker, args=(args, load_frame),
                                          nprocs=args.devices, start_method="spawn")
    return None


def _worker(local_rank: int, args, load_frame):
    """One rank: join the group on card ``local_rank`` (or the CPU), train,
    wait for the others, leave the group."""
    from streamyolo_torch.parallel import destroy, init_distributed, synchronize

    world = args.num_machines * args.devices
    rank = args.machine_rank * args.devices + local_rank
    device = init_distributed(args.dist_backend, args.dist_url, world, rank,
                              device=args.device, local_rank=local_rank)
    args.device = str(device)
    try:
        trainer = _train(args, load_frame)
        synchronize()
        return trainer
    finally:
        destroy()


def _train(args, load_frame):
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
