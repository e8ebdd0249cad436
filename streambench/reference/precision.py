"""The reference computes in float32 proper: TF32 off for cuBLAS and cuDNN
while it runs, the flags restored afterwards for the program."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def float32_exact():
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before
