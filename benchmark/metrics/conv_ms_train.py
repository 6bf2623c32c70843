"""Device ms a step launched inside the port's sparse conv spans:
``conv/fwd`` around each conv Function's forward and ``conv/bwd`` around
its backward, on the thread autograd runs it on (core/sparse_ops.py ->
kernels/, csrc/). The conv layer by where its work is launched, not by
kernel names."""
from ._spans import span_ms

SPANS = ("conv/fwd", "conv/bwd")


def read(ctx, record):
    return span_ms(record, SPANS)
