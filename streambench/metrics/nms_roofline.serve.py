"""Kernel B1 at K = 200, one launch over the N cameras: its least time over
its device time (%)."""

from streambench.readers import nms_roofline


def read(rec):
    return nms_roofline(rec) if rec.get("kind") == "cameras" else None
