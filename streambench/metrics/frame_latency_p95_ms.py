"""95th percentile of every frame's latency in the window, from its due
time at the generator to its rows back on the host (ms)."""

import numpy as np


def read(rec):
    lat = rec.get("frame_latency_s")
    return None if lat is None or not len(lat) else float(np.percentile(lat, 95) * 1e3)
