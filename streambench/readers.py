"""Arithmetic the metric readers (``metrics/<name>.py``) share. Each
returns None where the run recorded nothing to read."""

from __future__ import annotations

from typing import Optional

from streambench.count import PEAK_OPS_PER_S, nms_work, time_at_peak
from streambench.trace import kernel_seconds

NMS_KERNEL = "nms_bitmask_kernel"  # kernel B1's name in the program's csrc/nms.cu


def idle_pct(rec: dict) -> Optional[float]:
    """The share of the traced window with no operation on the device."""
    t = rec.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def nms_roofline(rec: dict) -> Optional[float]:
    """Kernel B1's least time for its launches (``count.nms_work``) over
    its measured device time."""
    t, nms = rec.get("trace"), rec.get("nms")
    if not t or not nms:
        return None
    seconds, launches = kernel_seconds(t, NMS_KERNEL)
    if not launches or seconds <= 0:
        return None
    return 100.0 * launches * time_at_peak(nms_work(nms["images_per_launch"], nms["k"])) / seconds


def mfu(work: Optional[dict], items: int, seconds: Optional[float]) -> Optional[float]:
    """``items`` times ``work``'s operations over ``seconds`` at the peak of
    its number format."""
    if not work or not seconds or seconds <= 0:
        return None
    return 100.0 * work["flops"] * items / seconds / PEAK_OPS_PER_S[work["format"]]


def launches_per(rec: dict, items: int) -> Optional[float]:
    t = rec.get("trace")
    if not t or not items:
        return None
    return t["launches"] / items
