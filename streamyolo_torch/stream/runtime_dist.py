"""Runtime distributions and the runtime zoo: the port's own copy of
``streamyolo_tpu/stream/runtime_dist.py``.

``Empirical`` draws simulated runtimes from measured samples (seconds) with
``np.random.RandomState(seed).choice``, exactly as the JAX package does, so
both packages draw the same latencies from the same seed. The zoo is a
pickle of ``{name: {"type": "empirical", "samples": [...]}}``: measure once
on the card, simulate any number of runs.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Optional, Sequence

import numpy as np


class Empirical:
    """Empirical runtime distribution over measured samples (seconds)."""

    def __init__(self, samples: Sequence[float], perf_factor: float = 1.0,
                 seed: Optional[int] = None):
        self.samples = np.asarray(samples, dtype=np.float64)
        if perf_factor <= 0:
            raise ValueError(f"perf_factor must be > 0, got {perf_factor}")
        if perf_factor != 1:
            self.samples = self.samples / perf_factor
        self.sidx = 0
        self._rng = np.random.RandomState(seed)

    def draw(self) -> float:
        return float(self._rng.choice(self.samples))

    def draw_sequential(self) -> float:
        sample = float(self.samples[self.sidx])
        self.sidx = (self.sidx + 1) % len(self.samples)
        return sample

    def mean(self) -> float:
        return float(self.samples.mean())

    def std(self) -> float:
        return float(self.samples.std(ddof=1))

    def min(self) -> float:
        return float(self.samples.min())

    def max(self) -> float:
        return float(self.samples.max())


def dist_from_dict(dist_dict: Dict, perf_factor: float = 1.0,
                   seed: Optional[int] = None) -> Empirical:
    if dist_dict["type"] == "empirical":
        return Empirical(dist_dict["samples"], perf_factor, seed=seed)
    raise ValueError(f'Unknown distribution type "{dist_dict["type"]}"')


def add_to_runtime_zoo(time_info_path: str, zoo_path: str, name: str) -> None:
    """Put the measured runtimes of a run's ``time_info.pkl`` into the zoo
    under ``name``."""
    with open(time_info_path, "rb") as f:
        time_info = pickle.load(f)
    samples = list(time_info["runtime_all"])
    zoo: Dict[str, Dict] = {}
    if os.path.isfile(zoo_path):
        with open(zoo_path, "rb") as f:
            zoo = pickle.load(f)
    zoo[name] = {"type": "empirical", "samples": samples}
    os.makedirs(os.path.dirname(os.path.abspath(zoo_path)), exist_ok=True)
    with open(zoo_path, "wb") as f:
        pickle.dump(zoo, f)


def dist_from_zoo(zoo_path: str, name: str, perf_factor: float = 1.0,
                  seed: Optional[int] = None) -> Empirical:
    with open(zoo_path, "rb") as f:
        zoo = pickle.load(f)
    return dist_from_dict(zoo[name], perf_factor, seed=seed)
