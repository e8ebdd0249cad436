"""Clock abstraction for the streaming harness: the port's own copy of
``streamyolo_tpu/stream/clock.py``.

``WallClock`` is real time (the production loop on the card); ``SimClock``
moves only when told, by simulated runtimes drawn from an ``Empirical``
distribution, so one streaming loop serves both the run on the card and a
deterministic simulation on any host.
"""

from __future__ import annotations

import time


class WallClock:
    """Real wall-clock time; ``advance`` is a no-op (time passes by itself)."""

    def __init__(self):
        self._t0 = time.perf_counter()

    def reset(self):
        self._t0 = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self._t0

    def advance(self, dt: float) -> None:  # real work already took dt
        pass


class SimClock:
    """Virtual time: only ``advance`` moves the clock. Deterministic."""

    def __init__(self):
        self._t = 0.0

    def reset(self):
        self._t = 0.0

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"SimClock cannot go back in time (dt={dt})")
        self._t += dt
