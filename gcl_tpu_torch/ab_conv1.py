"""K2, K3, K9, K1 and K11 of this checkout against those of another, and
the range of K4 / K5.

``python -m gcl_tpu_torch.ab_conv1 --other DIR`` builds the kernel library
of this checkout and that of the checkout at DIR (the parent commit
unpacked with ``git archive``, say: its own ``gcl_tpu_torch.kernels.build``
compiles it there), then launches the C entry points of the two libraries
(the same in both) on the same inputs, alternating which goes first from
round to round:

* the occupancy conv K2 (``occupancy_conv_fwd``) at the serving pair's
  level (float32) and at the 4 x 7 train step's (bf16 and float32), the
  level ``chip_smoke.py`` times; the two K2s must agree bit for bit;
* its weight gradient K3 (``occupancy_conv_dw``) at the 4 x 7 step, bf16
  and float32, on K2's bitmasks and a seeded g; the two dWs must agree
  within 1e-4 of the max (float32 sums by atomics, in an order that
  changes from launch to launch); each launch zeroes dW first, as the
  wrapper does;
* conv1's dX K9 (``scalar_conv_dx``) at the 4 x 7 step, bf16 and float32,
  on a seeded g and no row flag, as ``chip_smoke.py`` times it; the two
  dXs must agree within 1e-4 (float32) or 1e-2 (bf16) of the max (float32
  sums in another order);
* the grid group search's top-k K1 (``windowed_cell_topk``, the packed
  order) on the arrays the 4 x 7 step's search hands it (S = 28, T = Q =
  18,432, kn = 5); rows and d2 must agree bit for bit;
* its exact order K11 (the same entry, T > 2^19) on the arrays of
  ``chip_smoke.py``'s large-T search (S = 1, Q = 4096, T = 589,824, kn =
  5), which hold no equal distances across window chunks, so that the
  two orders agree: rows and d2 bit for bit.

Every round also times this checkout's wrappers of K4 and K5 on the train
step's gated launch (x zero off the centre clouds, those rows flagged), in
bf16 and float32, and of K9 and K11 on the cases above (the wrapper's
checks and allocations on the host are part of what a caller pays). Each
reading is one warm-up launch, then CUDA events over 3 launches, as
``chip_smoke.py`` times a kernel. Such a reading holds whatever time the
host takes to issue the launches where that is longer than the card's.
Each launch of a C entry holds the tensors it was given, so no later
allocation takes their memory, and after the rounds the outputs of the
deterministic C entries (K2, K9, K1, K11) must still equal, bit for bit,
those of their first launch: the timed launches saw the checked inputs.

Two more readings of each (kernel, checkout) follow the rounds, both of
the card's time alone: CUDA events over 10 launches
queued while the card spins (``torch.cuda._sleep``), so the host has
issued them all before the first starts; and the sum of the durations of
the kernels (and copies) the profiler's CUPTI trace saw during 10 more
launches, a launch.

It prints one line a round, then the card's name and power limit, then
one JSON object: every reading per (kernel, level, type, checkout), with
its least, median and greatest value, and under "witness" the two
readings of each.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

from . import bench, infer
from .core.kernel_maps import build_graph
from .data import device_pipeline as dp
from .data.device_pipeline import voxelize_per_cloud
from .data.synthetic import synth_lidar
from .kernels import (build, radius_topk, scalar_conv_dw, scalar_conv_dx,
                      scalar_conv_fwd)
from .kernels.occupancy_conv import CHUNK

N_POINTS = 65536
NV_CAP = 18432
SEED = 0
REPS = 3


def other_library(root: str) -> ctypes.CDLL:
    """The kernel library of the checkout at root, built by its own
    build module in a process of its own."""
    code = ("from gcl_tpu_torch.kernels import build; "
            "print(build.load_library()._name)")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(root))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, check=True)
    return ctypes.CDLL(out.stdout.strip().splitlines()[-1])


def c_entry(lib: ctypes.CDLL, name: str, dtype=torch.float32):
    """The C entry point ``name`` of lib, in the form for ``dtype``."""
    name += "_bf16" if dtype == torch.bfloat16 else ""
    fn = getattr(lib, name)
    fn.argtypes = build.SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn


def c_launch(fn, *args):
    """A launch of the C entry fn on args, each tensor passed as its
    pointer. The launch holds the tensors, so that their memory outlives
    the case that made them."""
    ptrs = tuple(a.data_ptr() if isinstance(a, torch.Tensor) else a
                 for a in args)

    def launch():
        return fn(*ptrs)

    launch.args = args
    return launch


def step_topk_arrays(dev):
    """The arrays (tkey_s, trow_s, txyz_s, pbase, qxyz, r2) that the 4 x 7
    step's group search hands K1."""
    b, c = 4, bench.N_CLOUDS
    points, pmask, transforms, radius = bench.bench_batch(SEED, b, N_POINTS,
                                                          dev)
    vox = voxelize_per_cloud(points.reshape(b * c, N_POINTS, 3),
                             pmask.reshape(b * c, N_POINTS), 0.3, NV_CAP)
    vox_b = dp.VoxelizedClouds(vox.coords.reshape(b, c, NV_CAP, 4),
                               vox.mask.reshape(b, c, NV_CAP),
                               vox.xyz.reshape(b, c, NV_CAP, 3))
    seen = []
    real = radius_topk.windowed_cell_topk_packed
    radius_topk.windowed_cell_topk_packed = (
        lambda *a: seen.append(a[:6]) or real(*a))
    try:
        dp._grid_searches(vox_b, transforms, radius, 5, bench.SEARCH_CELL)
    finally:
        radius_topk.windowed_cell_topk_packed = real
    return seen[0]


def large_t_arrays(dev, q_n: int = 4096):
    """The arrays (tkey_s, trow_s, txyz_s, pbase, qxyz, r2) that
    chip_smoke.py's large-T search hands K11: the first q_n voxels of the
    4 x 7 batch's first cloud against 32 of its clouds stacked, each
    shifted by 0.11 m from the one before (T = 589,824), r = 0.45."""
    b, c = 4, bench.N_CLOUDS
    points, pmask, _, _ = bench.bench_batch(SEED, b, N_POINTS, dev)
    vox = voxelize_per_cloud(points.reshape(b * c, N_POINTS, 3),
                             pmask.reshape(b * c, N_POINTS), 0.3, NV_CAP)
    n_copy = (1 << 19) // NV_CAP + 4
    pick = torch.arange(n_copy, device=dev) % (b * c)
    shift = torch.arange(n_copy, device=dev, dtype=torch.float32) * 0.11
    targets = (vox.xyz[pick] + shift[:, None, None]).reshape(1, -1, 3)
    seen = []
    real = radius_topk.windowed_cell_topk_exact
    radius_topk.windowed_cell_topk_exact = (
        lambda *a: seen.append(a[:6]) or real(*a))
    try:
        dp.batched_grid_radius_knn(vox.xyz[:1, :q_n], vox.mask[:1, :q_n],
                                   targets, vox.mask[pick].reshape(1, -1),
                                   torch.full((1,), 0.45, device=dev), 5,
                                   bench.SEARCH_CELL)
    finally:
        radius_topk.windowed_cell_topk_exact = real
    return seen[0]


def conv1_level(dev, serving: bool):
    """(aux, skeys, srow, coords, mask) of conv1's level: the serving
    pair's (two scans, as chip_smoke.py builds them) or the 4 x 7 train
    step's (bench.py's batch)."""
    if serving:
        rng = np.random.RandomState(SEED)
        pts = torch.from_numpy(np.stack([synth_lidar(rng, N_POINTS)
                                         for _ in range(2)])).to(dev)
        pmask = torch.ones(pts.shape[:2], dtype=torch.bool, device=dev)
        extract = infer.serving_extractor(infer.serving_model(SEED, dev),
                                          NV_CAP)
        specs, voxel, caps, n_clouds = (extract.conv_specs,
                                        extract.voxel_size,
                                        extract.level_caps, 2)
    else:
        n_clouds = 4 * bench.N_CLOUDS
        points, pmask, _, _ = bench.bench_batch(SEED, 4, N_POINTS, dev)
        pts = points.reshape(n_clouds, N_POINTS, 3)
        pmask = pmask.reshape(n_clouds, N_POINTS)
        specs, cfg = bench.bench_config(4, NV_CAP)
        voxel, caps = cfg.voxel_size, cfg.level_caps
    flat = voxelize_per_cloud(pts, pmask, voxel, NV_CAP).flatten()
    graph = build_graph(flat.coords, flat.mask, specs, caps, n_clouds)
    lv = graph.levels[1]
    return (graph.maps["s1->s1/k5d1"].c1z, lv.skeys, lv.srow, lv.coords,
            lv.mask)


def k3_case(libs, sbits, dtype, form, gen, mask, stream):
    """K3 of each library at the 4 x 7 step on K2's bitmasks and a seeded
    g; the two dWs agree within 1e-4 of the max."""
    n = sbits.shape[0]
    g = (torch.randn(n, 32, generator=gen).to(sbits.device)
         * mask[:, None]).to(dtype)
    launch, outs = {}, {}
    for tree, lib in libs.items():
        dw = torch.zeros(125, 1, 32, device=sbits.device)
        fn = c_entry(lib, "occupancy_conv_dw", dtype)
        launch[tree] = lambda fn=fn, dw=dw: (dw.zero_(), fn(
            sbits.data_ptr(), g.data_ptr(), dw.data_ptr(), n, 5, 32,
            stream))[1]
        outs[tree] = dw
    for tree in libs:
        if launch[tree]() != 0:
            raise RuntimeError(f"K3 of {tree} failed to launch")
    torch.cuda.synchronize()
    err = float((outs["this"] - outs["other"]).abs().max()) / float(
        outs["other"].abs().max())
    if not err <= 1e-4:
        raise RuntimeError(f"K3 train_4x7 {form}: the two checkouts differ "
                           f"by {err} of the max")
    return f"K3 train_4x7 {form}", launch, {}


def k9_case(libs, geo, g, w, form, stream):
    """K9 of each library at the 4 x 7 step; the two dXs within 1e-4
    (float32) or 1e-2 (bf16) of the max."""
    aux, skeys, srow = geo
    n = aux.shape[0]
    launch, outs = {}, {}
    for tree, lib in libs.items():
        dx = torch.empty(n, 1, dtype=g.dtype, device=g.device)
        launch[tree] = c_launch(c_entry(lib, "scalar_conv_dx", g.dtype), g,
                                w, aux, skeys, srow, None, dx, n, 5, 32,
                                skeys.shape[0], stream)
        outs[tree] = (dx,)
    for tree in libs:
        if launch[tree]() != 0:
            raise RuntimeError(f"K9 of {tree} failed to launch")
    torch.cuda.synchronize()
    tol = 1e-4 if form == "float32" else 1e-2
    ref = outs["other"][0].float()
    err = float((outs["this"][0].float() - ref).abs().max()) / float(
        ref.abs().max())
    if not err <= tol:
        raise RuntimeError(f"K9 train_4x7 {form}: the two checkouts differ "
                           f"by {err} of the max")
    return f"K9 train_4x7 {form}", launch, outs


def topk_case(libs, arrays, what):
    """K1 or K11 (by T) of each library on ``arrays``; rows and d2 bit for
    bit."""
    tkey, trow, txyz, pbase, qxyz, r2 = arrays
    dev = tkey.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    s_n, t_n = tkey.shape
    q_n, kn = pbase.shape[1], 5
    rowb = radius_topk.row_bits(t_n)
    scale = inv_scale = None
    qcap = 0.0
    if rowb:
        scale, inv_scale, qcap = radius_topk._quantizer(r2, rowb)
    launch, outs = {}, {}
    for tree, lib in libs.items():
        rows = torch.empty((s_n, q_n, kn), dtype=torch.int32, device=dev)
        d2 = torch.empty((s_n, q_n, kn), dtype=torch.float32, device=dev)
        launch[tree] = c_launch(c_entry(lib, "windowed_cell_topk"), tkey,
                                trow, txyz, pbase, qxyz, r2, scale,
                                inv_scale, rows, d2, s_n, t_n, q_n, kn, rowb,
                                qcap, stream)
        outs[tree] = (rows, d2)
    for tree in libs:
        if launch[tree]() != 0:
            raise RuntimeError(f"{what} of {tree} failed to launch")
    torch.cuda.synchronize()
    if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(outs["this"], outs["other"])):
        raise RuntimeError(f"{what}: the two checkouts disagree")
    return what, launch, outs


def ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def queued_ms(fn, n: int = 10) -> float:
    """ms a launch by CUDA events, with n launches queued behind a spin of
    the card so that no host time lies between them."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)  # ~10 ms of the card: the host runs ahead
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def profiled_ms(fn, n: int = 10):
    """(ms a launch, kernels a launch): the durations of the kernels and
    copies the profiler's CUPTI trace saw during n launches, summed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    us = sum(e.time_range.elapsed_us() for e in dev)
    return us / 1e3 / n, len(dev) / n


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the checkout to compare K2, K3, K9, K1 "
                         "and K11 with")
    ap.add_argument("--rounds", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    dev = torch.device("cuda")
    libs = {"this": build.load_library(), "other": other_library(args.other)}
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    w1 = torch.randn(125, 1, 32, generator=gen).to(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    # (name, {checkout: launch}, {checkout: outputs that must not change})
    cases = []
    for level, serving, dtypes in (("serving", True, (torch.float32,)),
                                   ("train_4x7", False,
                                    (torch.bfloat16, torch.float32))):
        aux, skeys, srow, coords, mask = conv1_level(dev, serving)
        n = aux.shape[0]
        for dtype in dtypes:
            form = "bf16" if dtype == torch.bfloat16 else "float32"
            w = w1.to(dtype)
            launch, outs = {}, {}
            for tree, lib in libs.items():
                out = torch.empty(n, 32, dtype=dtype, device=dev)
                sbits = torch.empty(n, 8, dtype=torch.int32, device=dev)
                launch[tree] = c_launch(
                    c_entry(lib, "occupancy_conv_fwd", dtype), aux, skeys, w,
                    out, sbits, skeys.shape[0], n, 5, 32, CHUNK, stream)
                outs[tree] = (out, sbits)
            for tree in libs:
                if launch[tree]() != 0:
                    raise RuntimeError(f"K2 of {tree} failed to launch")
            torch.cuda.synchronize()
            if not all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                       for a, b in zip(outs["this"], outs["other"])):
                raise RuntimeError(f"K2 {level} {form}: the two checkouts "
                                   f"disagree")
            cases.append((f"K2 {level} {form}", launch, outs))
            if serving:
                continue
            cases.append(k3_case(libs, outs["this"][1], dtype, form, gen,
                                 mask, stream))
            sel = ((torch.remainder(coords[:, 0], bench.N_CLOUDS) == 0)
                   & mask).to(torch.float32)
            x = (torch.randn(n, 1, generator=gen).to(dev)
                 * sel[:, None]).to(dtype)
            g = (torch.randn(n, 32, generator=gen).to(dev)
                 * mask[:, None]).to(dtype)
            geo = (aux, skeys, srow)
            cases.append((f"K4 {level} {form} gated", {"this": (
                lambda x=x, geo=geo, sel=sel: scalar_conv_fwd(
                    x, w1, *geo, sel))}, {}))
            cases.append((f"K5 {level} {form} gated", {"this": (
                lambda x=x, g=g, geo=geo, sel=sel: scalar_conv_dw(
                    x, g, *geo, 125, sel))}, {}))
            w9 = w1.to(dtype).float()
            cases.append(k9_case(libs, geo, g, w9, form, stream))
            cases.append((f"K9 {level} {form} wrapper", {"this": (
                lambda g=g, geo=geo, w9=w9: scalar_conv_dx(g, w9, *geo))},
                          {}))

    cases.append(topk_case(libs, step_topk_arrays(dev), "K1 train_4x7"))
    arrays = large_t_arrays(dev)
    cases.append(topk_case(libs, arrays, "K11 Q=4096"))
    cases.append(("K11 Q=4096 wrapper", {"this": (
        lambda: radius_topk.windowed_cell_topk_exact(*arrays, 5))}, {}))

    first = {name: {tree: [t.clone() for t in ts] for tree, ts in outs.items()}
             for name, _, outs in cases}
    times = {name: {tree: [] for tree in launch} for name, launch, _ in cases}
    for r in range(args.rounds):
        order = ("other", "this") if r % 2 == 0 else ("this", "other")
        line = []
        for name, launch, _ in cases:
            for tree in order:
                if tree in launch:
                    t = ms(launch[tree])
                    times[name][tree].append(t)
                    line.append(f"{name} {tree} {t:.4f}")
        print(f"round {r}: " + "; ".join(line), flush=True)
    summary = {name: {tree: dict(ms=v, min=min(v), median=statistics.median(v),
                                 max=max(v)) for tree, v in per.items()}
               for name, per in times.items()}
    summary["witness"] = {}
    for name, launch, _ in cases:
        per = summary["witness"][name] = {}
        for tree in launch:
            prof_ms, kernels = profiled_ms(launch[tree])
            per[tree] = dict(queued_ms=queued_ms(launch[tree]),
                             profiled_ms=prof_ms, kernels=kernels)
            print(f"witness {name} {tree}: queued "
                  f"{per[tree]['queued_ms']:.4f} ms, profiled "
                  f"{prof_ms:.4f} ms over {kernels:g} kernels a launch",
                  flush=True)
    torch.cuda.synchronize()
    for name, _, outs in cases:
        for tree, ts in outs.items():
            if not all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                       for a, b in zip(ts, first[name][tree])):
                raise RuntimeError(f"{name} {tree}: the timed launches' "
                                   f"outputs differ from the first's")
    print(f"card: {infer.gpu_identity()}")
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
