"""Host calls that launch a kernel or a graph (the profiler's CUDA
launch calls) per served frame."""

from streambench.readers import launches_per


def read(rec):
    return launches_per(rec, rec.get("frames_done"))
