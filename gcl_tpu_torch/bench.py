"""Benchmark: GCL train-step throughput on one CUDA card.

``python -m gcl_tpu_torch.bench`` runs the flagship configuration
(ResUNetFatBN at full width, conv1 k=5, voxel 0.3 m, batch 4 x 7 clouds of
65,536 synthetic LiDAR points, exact input jitter, the ``finest`` loss
with the spatial negative filter, SGD momentum 0.8 / weight decay 1e-4,
the colocation-group search on a hash grid of 1.08 m cells) and times the
full step: voxelization, colocation-group search, levels and conv maps,
U-Net forward and backward, loss and the SGD update. It is the port of the
root ``bench.py``, bf16 compute included (``"compute_dtype": "bfloat16"``:
features bf16 between layers, products in bf16, sums and BN statistics in
float32, parameters and loss float32); ``--compute_dtype float32`` runs
the step in float32. ``--search brute_force`` swaps the grid search (one launch of the
windowed cell top-k kernel, printed as ``"search": "grid_1.08"``) for the
brute-force O(QT) one (``"search": "brute_force"``), the step this
benchmark timed before the grid search was ported.

``--data_parallel`` runs the step as root ``bench.py --data_parallel``
does: over every visible card, one rank a card (gcl_tpu_torch.parallel;
a single card is a process group of one, on NCCL), each rank with its
slice of the batch, capacities and the loss's sample counts per shard,
and the averaged ``num_valid_voxels`` scaled back to the whole batch. On
one card it times what the data-parallel step costs over the plain one
(``"data_parallel": world size`` in the output).

``--batch_size 8`` is 56 clouds a step, above the 31 that the implicit
conv maps address: the step then builds explicit index tables with the
join kernel and runs the index-table conv kernels, as the root bench.py
does at that batch (``"graph": "explicit"`` in the output; ``"implicit"``
up to batch 4). ``--graph explicit`` asks for the tables at any batch.

It prints ONE JSON line with bench.py's keys (``metric:
gcl_train_voxels_per_sec``, ``value``, ``unit``, ``vs_baseline``,
``step_time_s`` with min and max, ``voxels_per_step``, ``device``) plus
``compute_dtype``, ``search``, ``graph`` and ``gpu`` (the card's name and
power limit). ``vs_baseline`` divides by the upstream project's own figure for
this batch shape on an RTX 3090 (~0.81 s/step = 6.4e5 voxel/s). Where
a step's time goes is the benchmark's to say (``python3 benchmark/run.py
--workload gcl.train.b4x7 --seed <n> --seconds <s> --trace 1``); an
operator's trace of a training run is ``python -m gcl_tpu_torch.train
--profile_dir DIR``.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .core.kernel_maps import default_level_caps, graph_route
from .data.synthetic import synth_lidar
from .losses.gcl import GCLLossConfig
from .models.resunet import ResUNetFatBN
from .models.weights import random_state_dict
from .parallel import (backend_for, broadcast_module, check_divisible,
                       make_parallel_train_step, run_ranks, shard_of)
from .train.steps import (StepConfig, make_gcl_grad_fn, make_optimizer,
                          make_train_step_from_grad)

BASELINE_VOXELS_PER_SEC = 6.4e5
N_CLOUDS = 7  # the centre scan + 6 neighbours
SEARCH_CELL = 1.08  # the root bench.py's: >= 2 x the 0.45 m search radius


def bench_model(seed: int, device) -> ResUNetFatBN:
    """ResUNetFatBN at full width with seeded random weights."""
    model = ResUNetFatBN(1, 32, bn_momentum=0.05, normalize_feature=True,
                         conv1_kernel_size=5, D=3)
    model.load_state_dict(random_state_dict(model, seed))
    return model.to(device)


COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def bench_config(batch_size: int, nv_cap: int = 18432,
                 search: str = "grid", graph: str = "auto",
                 compute_dtype: torch.dtype = torch.bfloat16):
    """(conv specs, StepConfig) at the root bench.py's settings; ``search``
    is 'grid' (its search_cell) or 'brute_force', ``graph`` the conv maps'
    route (build_graph's method), ``compute_dtype`` the features' type
    (bf16, as root bench.py has it, or float32)."""
    if search not in ("grid", "brute_force"):
        raise ValueError(f"search {search!r}: 'grid' or 'brute_force'")
    specs = ResUNetFatBN.conv_specs(5)
    strides = sorted({s for sp in specs
                      for s in (sp.in_stride, sp.out_stride)})
    n_flat = batch_size * N_CLOUDS * nv_cap
    return specs, StepConfig(
        voxel_size=0.3, nv_cap=nv_cap,
        level_caps=default_level_caps(n_flat, strides, 0.55),
        knn_chunk=1024,
        search_cell=SEARCH_CELL if search == "grid" else None,
        graph_method=graph, compute_dtype=compute_dtype)


def bench_step(model, batch_size: int, nv_cap: int = 18432,
               search: str = "grid", graph: str = "auto",
               compute_dtype: torch.dtype = torch.bfloat16,
               data_parallel: bool = False):
    """(optimizer, step_fn) at the root bench.py's settings for a (shard's)
    batch of ``batch_size`` samples; ``data_parallel``: the grad_fn lifted
    onto the ranks of the process group (parallel.make_parallel_train_step)."""
    specs, cfg = bench_config(batch_size, nv_cap, search, graph,
                              compute_dtype)
    grad_fn = make_gcl_grad_fn(
        model, specs, cfg, GCLLossConfig(block_finest_gradient=False),
        "finest", max_pos_cluster=256 * batch_size,
        max_hn_samples=256 * batch_size, pos_weight=1.0, finest_weight=1.0,
        neg_weight=1.0)
    if data_parallel:
        return make_parallel_train_step(model, grad_fn, cfg)
    opt = make_optimizer(model.parameters(), cfg)
    return opt, make_train_step_from_grad(opt, grad_fn)


def bench_batch(seed: int, batch_size: int, n_points: int, device):
    """bench.py's synthetic batch: (points [B, 7, P, 3], pmask, transforms
    [B, 7, 4, 4], radius [B]); the neighbours are displaced along a
    synthetic trajectory."""
    rng = np.random.RandomState(seed)
    points = np.zeros((batch_size, N_CLOUDS, n_points, 3), np.float32)
    for i in range(batch_size):
        for c in range(N_CLOUDS):
            points[i, c] = synth_lidar(rng, n_points)
    transforms = np.broadcast_to(np.eye(4, dtype=np.float32),
                                 (batch_size, N_CLOUDS, 4, 4)).copy()
    for c in range(1, N_CLOUDS):
        transforms[:, c, 0, 3] = ((c + 1) // 2) * 8.0 * (1 if c % 2 else -1)
    pmask = np.ones((batch_size, N_CLOUDS, n_points), bool)
    radius = np.full((batch_size,), 0.45, np.float32)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (points, pmask, transforms, radius))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--points", type=int, default=65536)
    ap.add_argument("--nv", type=int, default=18432)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--search", default="grid",
                    choices=["grid", "brute_force"])
    ap.add_argument("--graph", default="auto",
                    choices=["auto", "implicit", "explicit"])
    ap.add_argument("--compute_dtype", default="bfloat16",
                    choices=sorted(COMPUTE_DTYPES))
    ap.add_argument("--data_parallel", action="store_true")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this benchmark times the card "
                         "(pass --device cpu for a functional run)")
    if not args.data_parallel:
        return run(0, 1, args)
    n = torch.cuda.device_count() if args.device == "cuda" else 1
    check_divisible(args.batch_size, n)
    return run_ranks(run, n, (args,), backend_for(args.device), args.device)


def run(rank: int, world_size: int, args):
    """The benchmark of ``args`` on this rank (cuda:rank, or the CPU) of
    ``world_size`` (1 without data parallelism); rank 0 prints."""
    on_card = args.device == "cuda"
    dev = torch.device("cuda", rank) if on_card else torch.device("cpu")
    if on_card:
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def sync():
        if on_card:
            torch.cuda.synchronize()

    per = shard_of(args.batch_size)[2]  # static capacities are PER SHARD
    model = bench_model(args.seed, dev)
    if args.data_parallel:
        broadcast_module(model)
    _, step = bench_step(model, per, args.nv, args.search, args.graph,
                         COMPUTE_DTYPES[args.compute_dtype],
                         args.data_parallel)
    batch = tuple(a[rank * per:(rank + 1) * per] for a in bench_batch(
        args.seed, args.batch_size, args.points, dev))
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    metrics = step(0.1, *batch, generator=gen)  # warm-up (builds kernels)
    sync()
    # averaged over the ranks when data-parallel: scaled to the batch
    n_vox = float(metrics["num_valid_voxels"]) * world_size
    times = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        for _ in range(args.iters):
            metrics = step(0.1, *batch, generator=gen)
        sync()
        times.append((time.perf_counter() - t0) / args.iters)
    dt = sorted(times)[len(times) // 2]
    if not bool(torch.isfinite(metrics["loss"])):
        raise RuntimeError(f"non-finite loss {metrics['loss']}")

    if rank != 0:
        return None

    voxels_per_sec = n_vox / dt
    out = {
        "metric": "gcl_train_voxels_per_sec",
        "value": voxels_per_sec,
        "unit": "voxel/s",
        "vs_baseline": voxels_per_sec / BASELINE_VOXELS_PER_SEC,
        "step_time_s": dt,
        "step_time_min_s": min(times),
        "step_time_max_s": max(times),
        "voxels_per_step": int(n_vox),
        "device": torch.cuda.get_device_name(0) if on_card else "cpu",
        "compute_dtype": args.compute_dtype,
        "search": (f"grid_{SEARCH_CELL}" if args.search == "grid"
                   else "brute_force"),
        "graph": graph_route(args.graph, per * N_CLOUDS),
        "data_parallel": world_size if args.data_parallel else 0,
    }
    if on_card:
        from .infer import gpu_identity
        out["gpu"] = gpu_identity()
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
