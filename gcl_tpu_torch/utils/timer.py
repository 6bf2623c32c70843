"""Timers and meters (a copy of gcl_tpu/utils/timer.py), and the host
clock read after the card has finished its queued work."""
from __future__ import annotations

import time

import torch


def synced_time(dev: torch.device) -> float:
    """time.perf_counter() once ``dev``'s queued work is done (a
    synchronize first on a CUDA device)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.sq_sum = 0.0
        self.var = 0.0
        self.count = 0

    def update(self, val, n=1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
        self.sq_sum += val ** 2 * n
        self.var = self.sq_sum / self.count - self.avg ** 2


class Timer:
    def __init__(self):
        self.reset()

    def reset(self):
        self.total_time = 0.0
        self.calls = 0
        self.start_time = 0.0
        self.diff = 0.0
        self.avg = 0.0

    @property
    def average_time(self):
        return self.total_time / self.calls if self.calls > 0 else 0.0

    def tic(self):
        self.start_time = time.time()

    def toc(self, average=True):
        self.diff = time.time() - self.start_time
        self.total_time += self.diff
        self.calls += 1
        self.avg = self.average_time
        return self.average_time if average else self.diff


class MinTimer(Timer):
    """A Timer that also keeps the shortest of its intervals."""

    def __init__(self):
        super().__init__()
        self.min = float("inf")

    def toc(self, average=True):
        out = super().toc(average)
        self.min = min(self.min, self.diff)
        return out
