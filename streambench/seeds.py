"""Every random draw of a run comes from ``--seed`` through these helpers:
one named stream per use, so that adding a use leaves the others alike.
A seed is any whole number >= 0 (also above 32 bits)."""

from __future__ import annotations

import hashlib

import numpy as np
import torch


def derive(seed: int, name: str) -> int:
    """A 63-bit seed for the stream ``name`` of the run ``seed``."""
    if seed < 0:
        raise ValueError(f"seeds are >= 0, got {seed}")
    digest = hashlib.sha256(f"{seed}/{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, name: str, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` for the stream ``name``."""
    return torch.Generator(device=device).manual_seed(derive(seed, name))


def rng(seed: int, name: str) -> np.random.Generator:
    """A NumPy generator for the stream ``name``."""
    return np.random.default_rng(derive(seed, name))
