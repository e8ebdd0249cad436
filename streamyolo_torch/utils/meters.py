"""Windowed metric meters and device memory telemetry, the counterpart of
``streamyolo_tpu/utils/meters.py`` (yolox ``MeterBuffer`` /
``gpu_mem_usage``)."""

from __future__ import annotations

from collections import defaultdict, deque
from typing import Dict, Optional


class AverageMeter:
    """A series of values: median and mean over a window, a global mean."""

    def __init__(self, window_size: int = 50):
        self._deque = deque(maxlen=window_size)
        self._total = 0.0
        self._count = 0

    def update(self, value):
        value = float(value)
        self._deque.append(value)
        self._count += 1
        self._total += value

    @property
    def median(self) -> float:
        if not self._deque:
            return 0.0
        d = sorted(self._deque)
        return d[len(d) // 2]

    @property
    def avg(self) -> float:
        return sum(self._deque) / max(len(self._deque), 1)

    @property
    def global_avg(self) -> float:
        return self._total / max(self._count, 1)

    @property
    def latest(self) -> Optional[float]:
        return self._deque[-1] if self._deque else None

    @property
    def total(self) -> float:
        return self._total

    def reset(self):
        self._deque.clear()
        self._total = 0.0
        self._count = 0

    def clear(self):
        self._deque.clear()


class MeterBuffer(defaultdict):
    """A dict of ``AverageMeter``s, filterable by a substring of the name."""

    def __init__(self, window_size: int = 20):
        super().__init__(lambda: AverageMeter(window_size=window_size))

    def reset(self):
        for v in self.values():
            v.reset()

    def get_filtered_meter(self, filter_key: str = "time") -> Dict[str, AverageMeter]:
        return {k: v for k, v in self.items() if filter_key in k}

    def update(self, values=None, **kwargs):
        values = dict(values or {})
        values.update(kwargs)
        for k, v in values.items():
            self[k].update(v)

    def clear_meters(self):
        for v in self.values():
            v.clear()


def device_mem_usage_mb() -> float:
    """The peak of the CUDA caching allocator's allocated memory on the
    current card, in MB (``torch.cuda.max_memory_allocated``); 0 without a
    card."""
    import torch

    if not torch.cuda.is_available():
        return 0.0
    return torch.cuda.max_memory_allocated() / (1024 * 1024)
