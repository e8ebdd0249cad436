#!/usr/bin/env python3
"""Export a checkpoint's model weights as ``.safetensors``, the counterpart
of ``tools/export_safetensors.py``.

    python -m streamyolo_torch.tools.export_safetensors -c CKPT.pth -o OUT.safetensors \\
        [--torch-names | --flax-names]

``-c`` takes a port checkpoint (the state dict under ``model``), a released
``.pth`` or a ``.safetensors`` file. ``--torch-names`` (the default) writes
the yolox state-dict names with OIHW convs, which the port (and
``torch.nn.Module.load_state_dict``) loads; ``--flax-names`` writes the
flax tree with '/'-joined names and HWIO convs. Both write what the JAX
tool writes for the same weights, tensor for tensor, without the
``safetensors`` package.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def make_parser():
    p = argparse.ArgumentParser("streamyolo_torch safetensors export")
    p.add_argument("-c", "--ckpt", type=str, required=True,
                   help="checkpoint: *.pth (port or released) or *.safetensors")
    p.add_argument("-o", "--out", type=str, required=True, help="output .safetensors path")
    names = p.add_mutually_exclusive_group()
    names.add_argument("--torch-names", dest="torch_layout", action="store_true", default=True)
    names.add_argument("--flax-names", dest="torch_layout", action="store_false")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Run as the command line says; returns the number of tensors written."""
    args = make_parser().parse_args(argv)

    from streamyolo_torch.utils.checkpoint import load_checkpoint
    from streamyolo_torch.utils.weights import save_safetensors

    n = save_safetensors(load_checkpoint(args.ckpt)["model"], args.out,
                         torch_layout=args.torch_layout)
    print(f"wrote {n} tensors ({'torch' if args.torch_layout else 'flax'} layout) "
          f"to {args.out}")
    return n


if __name__ == "__main__":
    main()
