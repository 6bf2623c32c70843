"""Pairs registered in the window, over the window: closed loop, one
client; a pair ends when its 4 x 4 transform is read on the host."""
from ..stats import rate


def read(ctx, record):
    w = record.get("window")
    if not w or "pairs" not in w:
        return None
    return rate(w["pairs"], w["seconds"])
