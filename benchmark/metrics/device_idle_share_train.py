"""The device's idle share over a profiled window of steady training steps:
1 - the union of the device's kernel and copy intervals over the
window's wall, both from the trace."""
from ._trace import idle_share


def read(ctx, record):
    return idle_share(record)
