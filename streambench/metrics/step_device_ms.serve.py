"""The serving step's device time per tick: the traced window's device
operations (``trace.summary``'s ``compute_s``: kernels, device copies and
sets, not the copies to and from the host) over the ticks served (ms)."""


def read(rec):
    t = rec.get("trace")
    return None if not t or not rec.get("ticks") or t["compute_s"] <= 0 else (
        t["compute_s"] / rec["ticks"] * 1e3)
