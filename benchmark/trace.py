"""One torch.profiler window over steady units of work (train steps or
pairs), reduced to what the per-layer metrics read: the device's busy
time (the union of its kernels' and copies' intervals), the device time
of the kernels launched inside each host range (the port's record_function
ranges and the benchmark's own spans), device time by kernel name, and
the idle gaps named by the range that was open on the host."""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, Dict, List, Sequence

import torch

from .stats import gaps, union_length

TOP = 10


def _is_annotation(e, ranges: set) -> bool:
    flag = getattr(e, "is_user_annotation", None)
    return bool(flag) if flag is not None else e.name in ranges


def window(units: Sequence[Callable[[], None]]) -> Dict:
    """Run ``units`` back to back under the profiler, then reduce.

    Returns {"window_s", "busy_s", "units", "range_device_s" {range name:
    device s of the kernels launched inside it, over the window},
    "range_host_s" {name: host s}, "kernel_s" {kernel name: device s},
    "breakdown" {"device_ops", "idle_gaps"}} (seconds)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for unit in units:
            unit()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    host_ranges = [e for e in events if e.device_type == DeviceType.CPU
                   and "/" in e.name and getattr(e, "is_user_annotation",
                                                 True)]
    names = {e.name for e in host_ranges}
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not _is_annotation(e, names)]
    spans = [(e.time_range.start, e.time_range.end) for e in device]
    busy_us = union_length(spans)
    kernel_us = defaultdict(float)
    for e in device:
        kernel_us[e.name] += e.time_range.end - e.time_range.start
    range_dev, range_host = defaultdict(float), defaultdict(float)
    for e in host_ranges:
        range_dev[e.name] += e.device_time_total
        range_host[e.name] += e.time_range.end - e.time_range.start
    # the idle gaps between the first and the last device interval, each
    # named by the innermost host range open at its start
    idle = []
    if spans:
        lo, hi = min(a for a, _ in spans), max(b for _, b in spans)
        for a, b in gaps(spans, lo, hi):
            open_ = [e for e in host_ranges
                     if e.time_range.start <= a < e.time_range.end]
            name = (min(open_, key=lambda e: e.time_range.end
                        - e.time_range.start).name if open_ else "host")
            idle.append((name, (b - a) / 1e6))
    idle.sort(key=lambda x: -x[1])
    ops = sorted(kernel_us.items(), key=lambda x: -x[1])
    return {
        "window_s": wall, "busy_s": busy_us / 1e6, "units": len(units),
        "range_device_s": {k: v / 1e6 for k, v in range_dev.items()},
        "range_host_s": {k: v / 1e6 for k, v in range_host.items()},
        "kernel_s": {k: v / 1e6 for k, v in kernel_us.items()},
        "breakdown": {
            "device_ops": [[k[:120], v / 1e6] for k, v in ops[:TOP]],
            "idle_gaps": _merged_gaps(idle)}}


def _merged_gaps(idle: List) -> List:
    """The longest gaps, one entry per host range: [name, total s] of its
    gaps, the largest TOP."""
    by = defaultdict(float)
    for name, s in idle:
        by[name] += s
    return [[k, v] for k, v in sorted(by.items(), key=lambda x: -x[1])[:TOP]]
