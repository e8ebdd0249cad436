"""Set-up seconds: from the process's start (before torch is imported) to
the window's opening: imports, the kernels' build or load, weights on the
card, the model, the frames, the warm-up of the cell's shapes."""


def read(rec):
    return rec.get("setup_s")
