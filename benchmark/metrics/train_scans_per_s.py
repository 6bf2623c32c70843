"""Scans consumed by the training steps completed in the window, over the
window (every step ends in a synchronize)."""
from ..stats import rate


def read(ctx, record):
    w = record.get("window")
    if not w or "scans" not in w:
        return None
    return rate(w["scans"], w["seconds"])
