"""K2 of this checkout against K2 of another, and the range of K4 / K5.

``python -m gcl_tpu_torch.ab_conv1 --other DIR`` builds the kernel library
of this checkout and that of the checkout at DIR (the parent commit
unpacked with ``git archive``, say: its own ``gcl_tpu_torch.kernels.build``
compiles it there), then launches the occupancy conv (K2,
``occupancy_conv_fwd``; the C entry point, the same in both) of the two
libraries on the same inputs, alternating which goes first from round to
round: at the serving pair's level (float32) and at the 4 x 7 train step's
(bf16 and float32), the level ``chip_smoke.py`` times. Every round also
times this checkout's K4 and K5 wrappers on the train step's gated launch
(x zero off the centre clouds, those rows flagged), in bf16 and float32.
Each reading is one warm-up launch, then CUDA events over 3 launches, as
``chip_smoke.py`` times a kernel. The two K2s must agree bit for bit.

It prints one line a round, then the card's name and power limit, then
one JSON object: every reading per (kernel, level, type, checkout), with
its least, median and greatest value.
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
from .data.device_pipeline import voxelize_per_cloud
from .data.synthetic import synth_lidar
from .kernels import build, scalar_conv_dw, scalar_conv_fwd
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


def k2_entry(lib: ctypes.CDLL, dtype):
    name = "occupancy_conv_fwd" + ("_bf16" if dtype == torch.bfloat16
                                   else "")
    fn = getattr(lib, name)
    fn.argtypes = build.SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn


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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the checkout to compare K2 with")
    ap.add_argument("--rounds", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    dev = torch.device("cuda")
    libs = {"this": build.load_library(), "other": other_library(args.other)}
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    w1 = torch.randn(125, 1, 32, generator=gen).to(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    cases = []  # (name, {checkout: launch})
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
                fn, ptrs = k2_entry(lib, dtype), (
                    aux.data_ptr(), skeys.data_ptr(), w.data_ptr(),
                    out.data_ptr(), sbits.data_ptr(), skeys.shape[0], n, 5,
                    32, CHUNK, stream)
                launch[tree] = lambda fn=fn, ptrs=ptrs: fn(*ptrs)
                outs[tree] = (out, sbits)
            for tree in libs:
                if launch[tree]() != 0:
                    raise RuntimeError(f"K2 of {tree} failed to launch")
            torch.cuda.synchronize()
            if not all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                       for a, b in zip(outs["this"], outs["other"])):
                raise RuntimeError(f"K2 {level} {form}: the two checkouts "
                                   f"disagree")
            cases.append((f"K2 {level} {form}", launch))
            if serving:
                continue
            sel = ((torch.remainder(coords[:, 0], bench.N_CLOUDS) == 0)
                   & mask).to(torch.float32)
            x = (torch.randn(n, 1, generator=gen).to(dev)
                 * sel[:, None]).to(dtype)
            g = (torch.randn(n, 32, generator=gen).to(dev)
                 * mask[:, None]).to(dtype)
            geo = (aux, skeys, srow)
            cases.append((f"K4 {level} {form} gated", {"this": (
                lambda x=x, geo=geo, sel=sel: scalar_conv_fwd(
                    x, w1, *geo, sel))}))
            cases.append((f"K5 {level} {form} gated", {"this": (
                lambda x=x, g=g, geo=geo, sel=sel: scalar_conv_dw(
                    x, g, *geo, 125, sel))}))

    times = {name: {tree: [] for tree in launch} for name, launch in cases}
    for r in range(args.rounds):
        order = ("other", "this") if r % 2 == 0 else ("this", "other")
        line = []
        for name, launch in cases:
            for tree in order:
                if tree in launch:
                    t = ms(launch[tree])
                    times[name][tree].append(t)
                    line.append(f"{name} {tree} {t:.4f}")
        print(f"round {r}: " + "; ".join(line), flush=True)
    summary = {name: {tree: dict(ms=v, min=min(v), median=statistics.median(v),
                                 max=max(v)) for tree, v in per.items()}
               for name, per in times.items()}
    print(f"card: {infer.gpu_identity()}")
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
