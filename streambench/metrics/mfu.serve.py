"""The steady serving step's operations (the frozen count, per frame) times
the frames served, over the device time of the step (``trace.summary``'s
``compute_s``: every device operation of the window but the copies to and
from the host), at the bf16 peak (%)."""

from streambench.readers import mfu


def read(rec):
    t = rec.get("trace")
    return mfu(rec.get("frame_work"), rec.get("frames_done", 0), t["compute_s"] if t else None)
