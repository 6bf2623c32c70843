"""Benchmark: GCL train-step throughput on one CUDA card.

``python -m gcl_tpu_torch.bench`` runs the flagship configuration
(ResUNetFatBN at full width, conv1 k=5, voxel 0.3 m, batch 4 x 7 clouds of
65,536 synthetic LiDAR points, exact input jitter, the ``finest`` loss
with the spatial negative filter, SGD momentum 0.8 / weight decay 1e-4,
the colocation-group search on a hash grid of 1.08 m cells) and times the
full step: voxelization, colocation-group search, levels and conv maps,
U-Net forward and backward, loss and the SGD update. It is the port of the
root ``bench.py`` with one difference, named in the output: compute is
float32. ``--search brute_force`` swaps the grid search (one launch of the
windowed cell top-k kernel, printed as ``"search": "grid_1.08"``) for the
brute-force O(QT) one (``"search": "brute_force"``), the step this
benchmark timed before the grid search was ported.

``--batch_size 8`` is 56 clouds a step, above the 31 that the implicit
conv maps address: the step then builds explicit index tables with the
join kernel and runs the index-table conv kernels, as the root bench.py
does at that batch (``"graph": "explicit"`` in the output; ``"implicit"``
up to batch 4). ``--graph explicit`` asks for the tables at any batch.

With ``--profile`` it first prints a JSON line of where one step's time
goes (host-clock stage times with a synchronize after each stage's range,
device time by stage and by op from torch.profiler, the device's idle
share). It then prints, last, ONE JSON line with bench.py's keys (``metric:
gcl_train_voxels_per_sec``, ``value``, ``unit``, ``vs_baseline``,
``step_time_s`` with min and max, ``voxels_per_step``, ``device``) plus
``compute_dtype``, ``search``, ``graph`` and ``gpu`` (the card's name and
power limit). ``vs_baseline`` divides by the upstream project's own figure for
this batch shape on an RTX 3090 (~0.81 s/step = 6.4e5 voxel/s).
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
from .train.steps import StepConfig, make_gcl_train_step

BASELINE_VOXELS_PER_SEC = 6.4e5
N_CLOUDS = 7  # the centre scan + 6 neighbours
SEARCH_CELL = 1.08  # the root bench.py's: >= 2 x the 0.45 m search radius


def bench_model(seed: int, device) -> ResUNetFatBN:
    """ResUNetFatBN at full width with seeded random weights."""
    model = ResUNetFatBN(1, 32, bn_momentum=0.05, normalize_feature=True,
                         conv1_kernel_size=5, D=3)
    model.load_state_dict(random_state_dict(model, seed))
    return model.to(device)


def bench_config(batch_size: int, nv_cap: int = 18432,
                 search: str = "grid", graph: str = "auto"):
    """(conv specs, StepConfig) at the root bench.py's settings; ``search``
    is 'grid' (its search_cell) or 'brute_force', ``graph`` the conv maps'
    route (build_graph's method)."""
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
        graph_method=graph)


def bench_step(model, batch_size: int, nv_cap: int = 18432,
               search: str = "grid", graph: str = "auto"):
    """(optimizer, step_fn) at the root bench.py's settings."""
    specs, cfg = bench_config(batch_size, nv_cap, search, graph)
    return make_gcl_train_step(
        model, specs, cfg, GCLLossConfig(block_finest_gradient=False),
        "finest", max_pos_cluster=256 * batch_size,
        max_hn_samples=256 * batch_size, pos_weight=1.0, finest_weight=1.0,
        neg_weight=1.0)


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


def profile_step(step, batch, gen, iters: int = 2) -> dict:
    """Where a step's time goes on the card: one torch.profiler window
    over ``iters`` steps. Stage times are the host-side spans of the
    step's record_function ranges (voxelize, groups, graph, unet, loss,
    backward, sgd) and the device time of the kernels launched inside
    them; the device's busy time is the sum over device-side events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            step(0.1, *batch, generator=gen)
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # device-side events only (kernels and copies), without the ranges'
    # own device-side annotations, which span the same time again
    kernels = sorted(((e.self_device_time_total, e.key, e.count)
                      for e in events if e.device_type == DeviceType.CUDA
                      and not e.key.startswith("gcl/")), reverse=True)
    busy_ms = sum(us for us, _, _ in kernels) / 1e3
    # each range shows twice: on the host (its span there) and as an
    # annotation on the device's timeline (the span of its kernels)
    stages = {}
    for e in events:
        if e.key.startswith("gcl/"):
            stage = stages.setdefault(e.key[4:], {})
            if e.device_type == DeviceType.CUDA:
                stage["device_ms"] = e.device_time_total / 1e3 / iters
            else:
                stage["host_ms"] = e.cpu_time_total / 1e3 / iters
    # autograd launches the backward's kernels from its own thread, outside
    # the range: its device time is what the other stages leave
    stages["backward"]["device_ms"] = busy_ms / iters - sum(
        v.get("device_ms", 0.0) for k, v in stages.items()
        if k != "backward")
    return {"stage_ms": stages, "window_ms_per_step": wall_ms / iters,
            "device_busy_ms_per_step": busy_ms / iters,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "top_device_ops": [
                {"op": k[:80], "ms_per_step": us / 1e3 / iters,
                 "calls_per_step": n / iters} for us, k, n in kernels[:20]]}


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
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this benchmark times the card "
                         "(pass --device cpu for a functional run)")
    on_card = args.device == "cuda"
    dev = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def sync():
        if on_card:
            torch.cuda.synchronize()

    model = bench_model(args.seed, dev)
    _, step = bench_step(model, args.batch_size, args.nv, args.search,
                         args.graph)
    batch = bench_batch(args.seed, args.batch_size, args.points, dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    metrics = step(0.1, *batch, generator=gen)  # warm-up (builds kernels)
    sync()
    n_vox = float(metrics["num_valid_voxels"])
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

    if args.profile and on_card:
        print(json.dumps(profile_step(step, batch, gen)))

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
        "compute_dtype": "float32",
        "search": (f"grid_{SEARCH_CELL}" if args.search == "grid"
                   else "brute_force"),
        "graph": graph_route(args.graph, args.batch_size * N_CLOUDS),
    }
    if on_card:
        from .infer import gpu_identity
        out["gpu"] = gpu_identity()
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
