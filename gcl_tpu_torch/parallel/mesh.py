"""Data-parallel steps over torch.distributed (port of
gcl_tpu/parallel/mesh.py: make_global_grad_fn, make_parallel_train_step).

gcl_tpu shards the batch over a 1-D device mesh inside one program
(shard_map) and pmean's the gradients, the BN running statistics and the
metrics over it. The port runs one process a card, each with its shard of
the batch (data.loader's rank slices): every rank runs the whole
per-shard pipeline (voxelize -> maps -> U-Net -> loss) on its own card,
and only the gradients, the running statistics and the metrics cross
between ranks, as one flattened buffer averaged by an all-reduce (SUM,
then a division by the world size: gloo has no AVG). The parameters stay
replicated: they start equal (broadcast_module from rank 0) and every rank
applies the same averaged gradients.

DistributedDataParallel is not used: by default it copies rank 0's BN
buffers to the other ranks rather than averaging them, and its bucketed
reduction overlapping the backward buys nothing where the backward ends
in one reduction anyway.

Semantics as in gcl_tpu: hardest negatives and group subsamples are mined
within each rank's shard, and batch norm normalizes with each rank's own
statistics, whose running averages are then averaged.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..train.steps import make_optimizer, make_train_step_from_grad

_MASK64 = (1 << 64) - 1


def world(group=None) -> Tuple[int, int]:
    """(rank, world size) in ``group`` (the default group); (0, 1) where
    no process group is initialized."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def check_divisible(batch_size: int, n_ranks: int) -> None:
    """Raise ValueError unless ``n_ranks`` divide a global batch of
    ``batch_size`` samples (gcl_tpu's rule: every shard is equal)."""
    if batch_size % n_ranks:
        raise ValueError(f"data_parallel: batch_size {batch_size} not "
                         f"divisible by {n_ranks} ranks")


def shard_of(batch_size: int, group=None) -> Tuple[int, int, int]:
    """(rank, world size, samples a rank) of a global batch of
    ``batch_size`` samples over the ranks of ``group``: (0, 1,
    batch_size) outside a process group. The one place a data-parallel
    run's shard is decided; the trainer and the benchmark read it."""
    rank, n = world(group)
    check_divisible(batch_size, n)
    return rank, n, batch_size // n


def _mix(seed: int, rank: int) -> int:
    """splitmix64 of the seed with the rank folded in, as a torch seed."""
    z = (seed + (rank + 1) * 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def fold_in(generator: torch.Generator, rank: int) -> torch.Generator:
    """A generator of ``rank``'s own for one step (the counterpart of
    jax.random.fold_in(key, axis_index)): one seed drawn from
    ``generator``, which every rank holds in the same state, with the rank
    mixed in. ``generator`` moves by one draw on every rank alike."""
    seed = int(torch.randint(0, 1 << 62, (1,), generator=generator,
                             device=generator.device))
    out = torch.Generator(device=generator.device)
    out.manual_seed(_mix(seed, rank))
    return out


def all_reduce_mean(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Average float tensors over the ranks in place: one flattened float32
    buffer (float64 if any tensor is float64), all-reduced by SUM and
    divided by the world size."""
    if not tensors:
        return
    _, n = world(group)
    dtype = (torch.float64 if any(t.dtype == torch.float64 for t in tensors)
             else torch.float32)
    flat = torch.cat([t.detach().reshape(-1).to(dtype) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat /= n
    offset = 0
    with torch.no_grad():
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view(t.shape))
            offset += t.numel()


def broadcast_module(model: torch.nn.Module, src: int = 0,
                     group=None) -> None:
    """Every parameter and buffer of ``model`` set to rank ``src``'s, in
    one flattened broadcast a type."""
    tensors = list(model.parameters()) + list(model.buffers())
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        same = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.detach().reshape(-1) for t in same])
        dist.broadcast(flat, src, group=group)
        offset = 0
        with torch.no_grad():
            for t in same:
                t.copy_(flat[offset:offset + t.numel()].view(t.shape))
                offset += t.numel()


def _state_to_average(model: torch.nn.Module) -> List[torch.Tensor]:
    """The gradients of every trainable parameter (zeros for one the step
    did not reach, so every rank sends the same layout) and every float
    buffer (the BN running statistics)."""
    out = []
    for p in model.parameters():
        if p.requires_grad:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            out.append(p.grad)
    return out + [b for b in model.buffers() if b.is_floating_point()]


def make_global_grad_fn(grad_fn: Callable, model: torch.nn.Module,
                        group=None) -> Callable:
    """Lift a per-shard grad_fn onto the ranks of ``group``.

    grad_fn(*shard, generator=None, draws=None) -> metrics leaves d loss /
    d p of this rank's shard in ``.grad`` and moves the BN running
    statistics (train/steps.py). The lifted function has the same
    contract for the whole batch: its random numbers come from
    fold_in(generator, rank) (or from ``draws``, this rank's own), and
    after it every gradient, every float buffer of ``model`` and every
    metric holds the average over the ranks. It composes with
    make_train_step_from_grad and AccumStepper as gcl_tpu's does: one
    average a micro-batch."""

    def global_grad_fn(*shard, generator: Optional[torch.Generator] = None,
                       draws=None) -> Dict[str, torch.Tensor]:
        rank, _ = world(group)
        gen = fold_in(generator, rank) if generator is not None else None
        metrics = grad_fn(*shard, generator=gen, draws=draws)
        dev = next(model.parameters()).device
        names = sorted(metrics)
        vals = [torch.as_tensor(metrics[k], dtype=torch.float32,
                                device=dev).clone() for k in names]
        all_reduce_mean(_state_to_average(model) + vals, group)
        return dict(zip(names, vals))

    return global_grad_fn


def make_parallel_train_step(model: torch.nn.Module, grad_fn: Callable,
                             step_cfg, stage: str = "gcl", group=None
                             ) -> Tuple[torch.optim.SGD, Callable]:
    """(optimizer, step_fn): the SGD step over the averaged gradients of
    a per-shard grad_fn (gcl_tpu's make_parallel_train_step). The model
    must start replicated (broadcast_module)."""
    opt = make_optimizer(model.parameters(), step_cfg)
    return opt, make_train_step_from_grad(
        opt, make_global_grad_fn(grad_fn, model, group), stage)
