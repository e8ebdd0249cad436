"""Frames whose rows were delivered, over the window's seconds (longer than
``--seconds`` when the last one ended after it)."""


def read(rec):
    done = rec.get("frames_done")
    return None if done is None else done / rec["rate_window_s"]
