"""Named ranges of the program's stages in a torch.profiler trace.

``with span("graph/levels"): ...`` opens the range only while a profiler
runs; otherwise it enters one shared no-op context, so a span costs one
check of the profiler's state. Autograd hands the profiler's state on to
the threads it runs a backward on, so a span in an autograd Function's
backward opens there too.

The names carry a ``/`` (``<stage>/<part>``): the benchmark's trace
reducer keeps every range whose name holds one, with the device time of
the kernels launched inside it.

A range is two nested records of one name. The outer, a
``record_function``, is the user annotation that the trace shows. The
profiler ties a kernel to the innermost operator record open at its
launch, never to a user annotation, and the port's own kernels are
launched straight from Python (kernels/build.py), inside no operator of
the range: the inner record (``RecordFunctionFast``, an operator record)
takes them, and the profiler folds it into the outer one, kernels and
all, since it has one child of the same name.
"""
from __future__ import annotations

import contextlib

import torch

_profiler_enabled = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def _ranges(name: str):
    with torch.profiler.record_function(name), \
            torch._C._profiler._RecordFunctionFast(name):
        yield


def span(name: str):
    """A context manager: the profiler range ``name`` while a profiler
    runs, a no-op otherwise."""
    if _profiler_enabled():
        return _ranges(name)
    return _OFF
