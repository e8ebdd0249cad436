"""The share of the traced serving window with no operation on the device
(%)."""

from streambench.readers import idle_pct


def read(rec):
    return idle_pct(rec) if rec.get("kind") == "cameras" else None
