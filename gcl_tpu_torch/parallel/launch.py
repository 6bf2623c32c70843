"""Starting the data-parallel ranks: one process a card.

* ``spawn(fn, n)``: n local ranks started with torch.multiprocessing's
  ``spawn`` (never ``fork``: a process that has started torch's threads or
  the CUDA runtime cannot fork safely), each joined to a process group
  over a ``file://`` rendezvous in a temporary directory of its own (so
  concurrent runs on one machine never contend for a port), then
  ``fn(rank, n, *args)``. A rank that raises or exits fails the whole
  call, and the other ranks are stopped; so does a run that outlives a
  join timeout, where the caller sets one (tests and the smoke run do;
  training sets none).
* ``init_from_env()``: under ``torchrun`` (several machines, or any
  launcher that sets RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT), the
  ``env://`` rendezvous; rank r takes ``cuda:LOCAL_RANK``.
* ``init_local_group()``: a group of one rank in this process, for a
  data-parallel run on one device; ``run_ranks`` takes it for n = 1 and
  spawns for more.
* ``data_parallel_ranks(config, ...)``: how many ranks a run of a config
  takes (gcl_tpu's rule over the visible devices).

The kernel library is built once before local ranks start
(``run_ranks``), or by each machine's local rank 0 behind a barrier
(``build_kernels_once``, under torchrun).

NCCL on CUDA, gloo on the CPU (and wherever asked for, e.g. two ranks on
one card, which NCCL refuses). Rank r of a local run takes ``cuda:r``.
"""
from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import check_divisible

# a collective that waits longer than this fails its rank. The ranks do
# the same work between collectives (every rank validates; rank 0's
# writes take seconds), so only a hung rank keeps the others waiting; the
# longest legitimate wait is local rank 0 compiling the kernel library
# (build_kernels_once), a few minutes
COLLECTIVE_TIMEOUT_S = 1800.0


def backend_for(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def rank_device(device_type: str, local_rank: int) -> torch.device:
    """The device of local rank ``local_rank``: cuda:local_rank, or the
    CPU."""
    if device_type == "cuda":
        return torch.device("cuda", local_rank)
    return torch.device(device_type)


def _timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S)


def init_local_group(backend: str) -> None:
    """A process group of one rank (this process, over an in-memory
    store), for the data-parallel step on one device."""
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1, timeout=_timeout())


def init_from_env(device_type: str,
                  backend: Optional[str] = None) -> torch.device:
    """Join the group a launcher such as torchrun describes in the
    environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT)
    and return this rank's device: cuda:LOCAL_RANK, or the CPU."""
    local = int(os.environ.get("LOCAL_RANK", "0"))
    dev = rank_device(device_type, local)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or backend_for(device_type),
                            init_method="env://", timeout=_timeout())
    return dev


def _rank_entry(rank: int, fn: Callable, world_size: int, init: str,
                backend: str, args: Sequence) -> None:
    # the ranks share the machine's cores: a pool of all of them in each
    # rank oversubscribes them world_size times over
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // world_size))
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world_size, timeout=_timeout())
    try:
        fn(rank, world_size, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, args: Sequence = (),
          backend: str = "gloo",
          join_timeout: Optional[float] = None) -> None:
    """Run ``fn(rank, world_size, *args)`` on ``world_size`` spawned
    ranks joined in one process group of ``backend`` and wait for all of
    them. ``fn`` must be importable by name (a module-level function) and
    ``args`` picklable. Raises if a rank raises or exits with an error,
    or, with a ``join_timeout``, if the ranks have not all finished that
    many seconds after the start; the other ranks are stopped then.
    Without one (the default, as training runs) it waits as long as the
    ranks run."""
    tmp = tempfile.mkdtemp(prefix="gcl_rdv_")
    try:
        ctx = mp.start_processes(
            _rank_entry,
            args=(fn, world_size, f"file://{tmp}/rendezvous", backend,
                  tuple(args)),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = (float("inf") if join_timeout is None
                    else time.monotonic() + join_timeout)
        try:
            while not ctx.join(timeout=max(0.0, min(
                    5.0, deadline - time.monotonic()))):
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"{world_size} ranks of {fn.__name__} did not "
                        f"finish within {join_timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(timeout=30)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_ranks(fn: Callable, world_size: int, args: Sequence = (),
              backend: str = "gloo", device_type: str = "cpu",
              join_timeout: Optional[float] = None):
    """``fn(rank, world_size, *args)`` on ``world_size`` data-parallel
    ranks: one rank in this process, in a group of its own, for
    world_size 1, else ``spawn`` (``join_timeout`` as there: none by
    default). A single rank runs here rather than in a spawned process so
    that its caller gets what ``fn`` returns (the trainer, the benchmark's
    record: nothing crosses back from a spawned rank) and pays no second
    interpreter's start and card initialization. On CUDA the kernel
    library is built first, so the ranks only load it."""
    if device_type == "cuda":
        from ..kernels.build import load_library
        load_library()
    if world_size > 1:
        spawn(fn, world_size, args, backend, join_timeout)
        return None
    init_local_group(backend)
    try:
        return fn(0, 1, *args)
    finally:
        dist.destroy_process_group()


def data_parallel_ranks(config, device_type: str, batch_size: int) -> int:
    """The number of ranks a data-parallel run of ``config`` takes on this
    machine, 0 for a run without data parallelism: gcl_tpu's rule over
    the visible devices (all the cards; on the CPU, --num_devices of
    them). --data_parallel true always, auto with more than one device
    and a batch that divides among them. A data-parallel batch that does
    not divide raises ValueError."""
    dp = str(getattr(config, "data_parallel", "false")).lower()
    n_req = getattr(config, "num_devices", 0) or 0
    n_avail = (torch.cuda.device_count() if device_type == "cuda"
               else max(1, n_req))
    n_dev = max(1, min(n_req or n_avail, n_avail))
    if not (dp == "true" or (dp == "auto" and n_dev > 1
                             and batch_size % n_dev == 0)):
        return 0
    check_divisible(batch_size, n_dev)
    return n_dev


def build_kernels_once() -> None:
    """Build the kernel library on each machine's local rank 0 while the
    other ranks wait, then load it everywhere (ranks started by a
    launcher such as torchrun, which compiles nothing before them)."""
    from ..kernels.build import load_library

    if int(os.environ.get("LOCAL_RANK", "0")) == 0:
        load_library()
    dist.barrier()
    load_library()
