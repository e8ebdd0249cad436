"""The one generator of the benchmark's inputs: frames and schedules drawn
from ``--seed`` and the parameters of a traffic file.

Frames are smooth seeded images, not white noise: a coarse random grid
(one value per ``detail`` x ``detail`` pixels and channel) upsampled
bilinearly, plus per-pixel noise of ``noise`` levels, in uint8 BGR. They
are drawn on the card in one call and copied once to the host, where a
camera's frames live before they are served.

Every seed gives the same sizes, counts and arrival times; only the
pixels and which pool frame a camera shows when differ.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from streambench.seeds import generator, rng


def frames(seed: int, name: str, count: int, size, device, detail: int = 16,
           noise: float = 24.0) -> np.ndarray:
    """``count`` seeded [H, W, 3] uint8 frames on the host (stream
    ``name``): a [count, H, W, 3] array."""
    h, w = size
    gen = generator(seed, name, device)
    coarse = torch.rand((count, 3, -(-h // detail) + 1, -(-w // detail) + 1), generator=gen,
                        device=device) * 255.0
    out = torch.empty((count, h, w, 3), dtype=torch.uint8, device=device)
    for i in range(0, count, 8):  # a few frames at a time keeps the float copy small
        part = F.interpolate(coarse[i:i + 8], size=(h, w), mode="bilinear", align_corners=False)
        part = part + torch.randn(part.shape, generator=gen, device=device) * noise
        out[i:i + 8] = part.clamp(0, 255).round().to(torch.uint8).permute(0, 2, 3, 1)
    return out.cpu().numpy()


@dataclasses.dataclass
class CameraPlan:
    """An open-loop camera schedule: tick ``t`` is due at ``t / fps``
    seconds after the window opens and serves pool frame ``index[t, c]`` of
    camera ``c``; ``check`` lists the ticks whose rows are judged."""

    fps: float
    ticks: int
    index: np.ndarray  # [ticks, cameras]
    check: List[int]


def camera_plan(traffic: dict, seed: int, seconds: float) -> CameraPlan:
    """Each camera steps through its pool from a seeded phase, so that
    consecutive frames of a camera differ and cameras differ from each
    other. The judged ticks are the first (every camera's star frame), the
    last, and ``check_ticks - 2`` more drawn from the seed."""
    fps, cams, pool = traffic["fps"], traffic["cameras"], traffic["pool_per_camera"]
    ticks = max(int(round(seconds * fps)), 2)
    r = rng(seed, "cameras")
    phase = r.integers(0, pool, cams)
    index = (np.arange(ticks)[:, None] + phase[None, :]) % pool
    middle = r.choice(np.arange(1, ticks - 1), size=min(traffic["check_ticks"] - 2, ticks - 2),
                      replace=False)
    return CameraPlan(fps, ticks, index, sorted({0, ticks - 1, *middle.tolist()}))

