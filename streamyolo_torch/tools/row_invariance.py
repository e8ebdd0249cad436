"""Does the bf16 trunk on the card round an image alike at every row of the
batch? Under cuDNN settings chosen by name, each run in a fresh process (a
choice is cached for the life of a process).

    python streamyolo_torch/tools/row_invariance.py [--modes default benchmark]
        [--repeats 1] [--kernels]

Modes: ``default`` (cuDNN's heuristic choice), ``benchmark``
(``torch.backends.cudnn.benchmark``: timed choice), ``deterministic``
(``torch.backends.cudnn.deterministic``: engines with a nondeterministic
note left out), ``benchmark_deterministic`` (both) and ``no_cudnn``
(cuDNN off: PyTorch's own convolution, one GEMM per image, as the dedup
eval's first-batch guard runs).

StreamYOLO-l at 600x960, bf16 modules, seed-0 weights with the obj/cls
prediction biases set to 0, a batch of 8 random uint8 frames. Per process:

  * ``rerun``: the max abs difference of the three pafpn outputs between two
    passes over the same batch;
  * ``rows_moved``: the same when every image of the batch moves one row
    down;
  * ``dedup_vs_dual_frame``: the first-batch guard's two numbers (max box
    difference in pixels, max score difference) between the ``seq`` forward
    (support shift 1, row 0 self-fused) and the dual-frame forward of the
    same samples, whose support half of row i is row i-1's frame; the eval's
    bf16 guard allows (1.0, 5e-3);
  * ``pafpn_ms_b8``: host clock around 5 synchronised pafpn passes, mean;
  * with ``--kernels``, ``gemm_kernels``: the names of the GEMM-like kernels
    (cuDNN, CUTLASS) one pafpn pass launches, from ``torch.profiler``.

Prints one JSON line per process, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import subprocess
import sys
import time
from pathlib import Path

# (enabled, benchmark, deterministic)
MODES = {"default": (True, False, False), "benchmark": (True, True, False),
         "deterministic": (True, False, True), "benchmark_deterministic": (True, True, True),
         "no_cudnn": (False, False, False)}
GEMM_WORDS = ("xmma", "cutlass", "gemm", "conv", "sm90", "implicit", "wgrad", "fprop")


def measure(mode: str, kernels: bool) -> dict:
    import numpy as np
    import torch

    from streamyolo_torch.exp import get_exp

    cudnn = torch.backends.cudnn
    cudnn.enabled, cudnn.benchmark, cudnn.deterministic = MODES[mode]
    exp = get_exp(exp_name="l_s50_onex_dfp_tal_filp")
    exp.compute_dtype = "bfloat16"
    model = exp.get_model("cuda")
    model.load_state_dict(exp.init_model())
    with torch.no_grad():
        for m in list(model.head.obj_preds) + list(model.head.cls_preds):
            m.bias.zero_()
    cur = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (8, 600, 960, 3), np.uint8))
    prev = torch.cat([cur[:1], cur[:-1]])  # row i's support: row i-1's frame
    cur, prev = cur.cuda(), prev.cuda()
    down = torch.tensor([7, 0, 1, 2, 3, 4, 5, 6], device="cuda")  # every image one row down
    shifts = torch.tensor([0] + [1] * 7, device="cuda")
    with torch.inference_mode():
        x = cur.to(torch.bfloat16).permute(0, 3, 1, 2)
        a = model.backbone.pafpn(x)
        again = model.backbone.pafpn(x)
        b = model.backbone.pafpn(x[down].contiguous(memory_format=torch.channels_last))
        seq, _ = model(cur, mode="seq", support_shift=shifts)
        dual = model(torch.cat([cur, prev], dim=-1), mode="off_pipe")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            model.backbone.pafpn(x)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 5 * 1e3
        out = {
            "mode": mode,
            "rerun": [float((p - q).abs().max()) for p, q in zip(a, again)],
            "rows_moved": [float((p[down] - q).abs().max()) for p, q in zip(a, b)],
            "dedup_vs_dual_frame": [float((seq[..., :4] - dual[..., :4]).abs().max()),
                                    float((seq[..., 4:] - dual[..., 4:]).abs().max())],
            "pafpn_ms_b8": ms,
        }
        if kernels:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                model.backbone.pafpn(x)
                torch.cuda.synchronize()
            names = {e.key for e in prof.key_averages()}
            out["gemm_kernels"] = sorted(n for n in names
                                         if any(w in n.lower() for w in GEMM_WORDS))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--modes", nargs="+", choices=sorted(MODES),
                    default=["default", "benchmark", "no_cudnn"])
    ap.add_argument("--repeats", type=int, default=1, help="fresh processes per mode")
    ap.add_argument("--kernels", action="store_true", help="list the GEMM-like kernels")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("row_invariance: no CUDA device available", file=sys.stderr)
        return 1
    ctx = multiprocessing.get_context("spawn")
    for mode in args.modes:
        for _ in range(args.repeats):
            with ctx.Pool(1) as pool:
                print(json.dumps(pool.apply(measure, (mode, args.kernels))), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    sys.exit(main())
