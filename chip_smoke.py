"""Smoke run of gcl_tpu_torch's serving path and train step on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:

1. device: requires CUDA (there is no CPU run), turns TF32 off for
   float32 matmuls and convolutions, prints the card's name and power
   limit;
2. build: compiles the CUDA kernels from gcl_tpu_torch/csrc with nvcc;
3. serving kernels: runs K6 and K2 against their plain PyTorch versions on
   the card at the serving path's shapes (two synthetic 65,536-point LiDAR
   clouds, voxel 0.3 m): K6 for every k=3 conv of ResUNetFatBN at its real
   Cin / Cout (rtol = atol = 1e-4), K2 on conv1 (out within 1e-5, sbits
   exact), and times both versions with CUDA events;
4. serving slice: registers pairs with ResUNetFatBN (seeded random
   weights) + SC2-PCR at bench_infer.py's settings: exactly 1 K2 and 20 K6
   launches per pair, kernel-path features within 1e-3 of the plain
   path's on the same card, a cloud registered against itself within
   RTE < 2 m and RRE < 5 deg, and pairs/s of both paths;
5. train kernels: builds the graph of the train step's batch (4 x 7
   clouds, 516,096 stride-1 rows) and runs every kernel of the step
   against its plain version there, each within 1e-4 of the plain
   tensor's max (float32 sums in another order; dW sums over blocks by
   atomics): K7's dX and dW for every k=3 geometry at its real Cin / Cout,
   K7's dX also against K6 through the reverse map with flipped transposed
   weights, K3, K4 (a dense random x, and the gated eps case bit for bit
   against the ungated kernel), K5, and K6 / K2 again at these shapes. It
   times each with CUDA events and works out each kernel's bound from the
   bytes it must move and the FMAs of its matched (offset, row) pairs;
6. train step: make_gcl_train_step at gcl_tpu_torch.bench's settings,
   float32: one step on the kernel path and one on the plain path from
   the same weights and the same draws (loss within 1e-4, every gradient
   within 0.1 of its max: ReLUs at the edge of rounding open in one path
   and not the other, as the printed yardstick shows), a step in which
   each of the 44 launches is held to its plain version on the same
   inputs within 1e-4 of the max, exactly K2 1, K3 1, K4 1, K5 1, K6 20,
   K7 20 launches per step, then 3 timed steps (finite losses, groups found,
   a parameter of every module changed), one timed plain-path step and
   the peak device memory;
7. prints {"kernels": [...]} (six kernels), the card line and, last, the
   {"ok": true, "device": {...}} line.
"""
import contextlib
import json
import sys
import time

import numpy as np

N_POINTS = 65536
NV_CAP = 18432
N_KEY = 5000
SEED = 0
REPS = 10
BATCH = 4          # the train step's batch: 4 samples x 7 clouds
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published
FP32_FLOP_PER_S = 67e12     # float32 outside the tensor cores, published
REL_TOL = 1e-4     # kernel vs plain, relative to the plain tensor's max


def _require(ok: bool, what: str) -> None:
    """Raise unless ok (a check that, unlike assert, survives python -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def _ms(fn, reps: int) -> float:
    """Mean device time of fn() in ms over reps launches (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def _routed(route):
    """Put route(K, wrapper, plain) in each kernel wrapper's place in
    core.sparse_ops, which the model's convs call through."""
    from gcl_tpu_torch.core import sparse_ops
    from gcl_tpu_torch.kernels import KERNELS

    saved = {fn.__name__: fn for fn, _ in KERNELS.values()}
    for k, (fn, plain) in KERNELS.items():
        setattr(sparse_ops, fn.__name__, route(k, fn, plain))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(sparse_ops, name, fn)


def plain_path():
    """Route the model's convs, forward and backward, through the kernels'
    plain versions (for the comparison runs only)."""
    return _routed(lambda k, fn, plain: plain)


def checked_path(errs: dict):
    """Keep the model on the kernels, and hold every launch against the
    plain version on the very same inputs: errs[K] collects the worst
    error relative to the plain tensor's max (integer outputs must be
    equal). A failure raises inside the step."""
    import torch

    def checked(k, fn, plain):
        def both(*args, **kw):
            got, ref = fn(*args, **kw), plain(*args, **kw)
            one = not isinstance(got, tuple)
            for a, b in zip((got,) if one else got, (ref,) if one else ref):
                if a is None:
                    _require(b is None, f"{k}: both leave dX out")
                elif a.dtype == torch.int32:
                    _require(torch.equal(a, b), f"{k}: equal integers")
                else:
                    errs[k] = max(errs.get(k, 0.0),
                                  _rel_err(a, b, f"{k} inside the step"))
            return got
        return both

    return _routed(checked)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound(n_bytes: float, flops: float):
    """(bound_ms, bound_by): the larger of bytes over the card's memory
    rate and float32 operations over its CUDA-core peak (the inputs are
    float32 and the kernels use no tensor cores; in TF32 the operations'
    share would be 7.4 times smaller)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / FP32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _rel_err(a, b, what: str) -> float:
    """max|a - b| / max|b|, required within REL_TOL."""
    scale = float(b.abs().max())
    _require(scale > 0, f"{what}: the plain version is not all zero")
    err = float((a - b).abs().max()) / scale
    _require(err <= REL_TOL, f"{what} within {REL_TOL} of max, got {err}")
    return err


def _rte_rre(t_est, t_gt):
    r = t_est[:3, :3].T @ t_gt[:3, :3]
    cos = np.clip((np.trace(r) - 1.0) / 2.0, -1.0, 1.0)
    return (float(np.linalg.norm(t_est[:3, 3] - t_gt[:3, 3])),
            float(np.degrees(np.arccos(cos))))


def train_kernel_checks(dev) -> dict:
    """Phase 5: every kernel of the train step against its plain version
    at the step's shapes. Returns {K: {max_abs_err, ms, plain_ms, bytes,
    flops}} summed over the step's launches of that kernel."""
    import torch

    from gcl_tpu_torch import bench
    from gcl_tpu_torch.core.coords import lookup
    from gcl_tpu_torch.core.kernel_maps import build_graph
    from gcl_tpu_torch.data.device_pipeline import voxelize_per_cloud
    from gcl_tpu_torch.kernels import KERNELS, c1z_unpack_bits
    from gcl_tpu_torch.models.common import SparseConv

    points, pmask, _, _ = bench.bench_batch(SEED, BATCH, N_POINTS, dev)
    n_clouds = BATCH * bench.N_CLOUDS
    specs, cfg = bench.bench_config(BATCH, NV_CAP)
    vox = voxelize_per_cloud(points.reshape(n_clouds, N_POINTS, 3),
                             pmask.reshape(n_clouds, N_POINTS),
                             cfg.voxel_size, NV_CAP)
    flat = vox.flatten()
    graph = build_graph(flat.coords, flat.mask, specs, cfg.level_caps,
                        n_clouds)
    torch.cuda.synchronize()
    print("train levels: " + ", ".join(
        f"s{s} {lv.coords.shape[0]} rows / {lv.skeys.shape[0]} valid"
        for s, lv in sorted(graph.levels.items())))

    rec = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bytes=0, flops=0)
           for k in KERNELS}

    def run(name, args, mult=1, n_bytes=0, flops=0, outs=lambda o: o,
            kw=None):
        """Kernel and plain version on the same inputs: errors, times."""
        fn, plain = KERNELS[name]
        kw = kw or {}
        got = fn(*args, **kw)
        torch.cuda.synchronize()
        ref = plain(*args, **kw)
        torch.cuda.synchronize()
        errs = [(_rel_err(a, b, f"{name} output {i}"),
                 float((a - b).abs().max()))
                for i, (a, b) in enumerate(zip(outs(got), outs(ref)))]
        ms = _ms(lambda: fn(*args, **kw), 3)
        pms = _ms(lambda: plain(*args, **kw), 3)
        r = rec[name]
        r["max_abs_err"] = max([r["max_abs_err"]] + [e[1] for e in errs])
        r["ms"] += mult * ms
        r["plain_ms"] += mult * pms
        r["bytes"] += mult * n_bytes
        r["flops"] += mult * flops
        return got, max(e[0] for e in errs), ms, pms

    convs = {}
    for m in bench.bench_model(SEED, "cpu").modules():
        if isinstance(m, SparseConv) and m.spec.kernel_size == 3:
            sig = (m.spec.key, m.spec.in_stride, m.spec.out_stride, m.in_ch,
                   m.out_ch)
            convs[sig] = convs.get(sig, 0) + 1
    _require(sum(convs.values()) == 20, f"20 k=3 convs, got {convs}")
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    for (key, s_in, s_out, cin, cout), mult in sorted(convs.items()):
        lv_in, lv_out = graph.levels[s_in], graph.levels[s_out]
        cmap = graph.maps[key]
        x = (torch.randn(lv_in.coords.shape[0], cin, generator=gen)
             .to(dev) * lv_in.mask[:, None])
        g = (torch.randn(lv_out.coords.shape[0], cout, generator=gen)
             .to(dev) * lv_out.mask[:, None])
        w = torch.randn(27, cin, cout, generator=gen).to(dev) / (27 * cin) ** .5
        matched = int((lookup(lv_in.skeys, lv_in.srow, cmap.qkey) >= 0).sum())
        rmatched = int((lookup(lv_out.skeys, lv_out.srow, cmap.rqkey)
                        >= 0).sum())
        _require(matched == rmatched > 0,
                 f"{key}: forward and reverse maps hold the same pairs "
                 f"({matched} vs {rmatched})")
        fwd_args = (x, w, cmap.qkey, lv_in.skeys, lv_in.srow)
        out, e6, ms6, p6 = run(
            "K6", fwd_args, mult, flops=2 * matched * cin * cout,
            n_bytes=_nbytes(*fwd_args) + 4 * g.numel(), outs=lambda o: (o,))
        bwd_args = (x, g, w, cmap.rqkey, lv_out.skeys, lv_out.srow)
        (dx, dw), e7, ms7, p7 = run(
            "K7", bwd_args, mult, flops=4 * matched * cin * cout,
            n_bytes=_nbytes(*bwd_args) + _nbytes(x, w))
        two_pass = KERNELS["K6"][0](
            g, w.flip(0).transpose(1, 2).contiguous(), cmap.rqkey,
            lv_out.skeys, lv_out.srow)
        e2 = _rel_err(dx, two_pass, f"K7 {key} dX against K6 through the "
                                    f"reverse map")
        print(f"{key} {cin}->{cout} x{mult} ({matched} pairs): "
              f"K6 rel_err {e6:.3g} {ms6:.3f} ms (plain {p6:.3f}); "
              f"K7 rel_err {e7:.3g} {ms7:.3f} ms (plain {p7:.3f}), "
              f"dX vs two-pass {e2:.3g}")
        del x, g, w, out, dx, dw, two_pass

    # the Cin == 1 kernels on conv1 (k = 5, 1 -> 32)
    lv = graph.levels[1]
    c1 = graph.maps["s1->s1/k5d1"]
    n = lv.coords.shape[0]
    w1 = torch.randn(125, 1, 32, generator=gen).to(dev)
    g1 = torch.randn(n, 32, generator=gen).to(dev) * lv.mask[:, None]
    x1 = torch.randn(n, 1, generator=gen).to(dev)
    k2_args = (c1.c1z, lv.skeys, w1)
    fn2, plain2 = KERNELS["K2"]
    out, sbits = fn2(*k2_args)
    torch.cuda.synchronize()
    ref, ref_bits = plain2(*k2_args)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
    _require(torch.equal(sbits, ref_bits), "K2 sbits equal the plain's")
    bits = c1z_unpack_bits(sbits, 125)
    present = int(bits.sum())
    rec["K2"].update(
        max_abs_err=float((out - ref).abs().max()),
        ms=_ms(lambda: fn2(*k2_args), 3),
        plain_ms=_ms(lambda: plain2(*k2_args), 3),
        bytes=_nbytes(*k2_args, out, sbits), flops=present * 32)
    _, e3, _, _ = run("K3", (sbits, g1, 125), flops=present * 32,
                      n_bytes=_nbytes(sbits, g1, w1), outs=lambda o: (o,))
    # K4 / K5: a dense random x for the function itself; then the train
    # step's case, x zero off the jittered centre clouds and those rows
    # flagged, which is what the step launches and what is timed
    geo = (c1.c1z, lv.skeys, lv.srow)
    run("K4", (x1, w1, *geo), mult=0, outs=lambda o: (o,))
    run("K5", (x1, g1, *geo, 125), mult=0, outs=lambda o: (o,))
    sel = ((torch.remainder(lv.coords[:, 0], bench.N_CLOUDS) == 0)
           & lv.mask).to(torch.float32)
    xs = x1 * sel[:, None]
    sel_pairs = int((bits * sel[:, None].to(torch.int32)).sum())
    gated, e4, _, _ = run(
        "K4", (xs, w1, *geo, sel), flops=2 * sel_pairs * 32,
        n_bytes=_nbytes(xs, w1, *geo, sel, out), outs=lambda o: (o,))
    _require(torch.equal(gated, KERNELS["K4"][0](xs, w1, *geo, None)),
             "K4 with the row flag equals K4 without it, bit for bit")
    _, e5, _, _ = run(
        "K5", (xs, g1, *geo, 125, sel), flops=2 * sel_pairs * 32,
        n_bytes=_nbytes(xs, g1, *geo, sel, w1), outs=lambda o: (o,))
    _rel_err(KERNELS["K5"][0](xs, g1, *geo, 125, sel),
             KERNELS["K5"][0](xs, g1, *geo, 125, None),
             "K5 with the row flag against K5 without it")
    print(f"conv1 k5 1->32 ({present} present pairs, {sel_pairs} on the "
          f"centre clouds): K3 rel_err {e3:.3g}, K4 gated {e4:.3g}, "
          f"K5 gated {e5:.3g}")
    for name, r in rec.items():
        r["bound_ms"], r["bound_by"] = _bound(r["bytes"], r["flops"])
        print(f"{name} per train step: kernel {r['ms']:.3f} ms, plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms by "
              f"{r['bound_by']} ({r['bytes'] / 1e6:.1f} MB, "
              f"{r['flops'] / 1e9:.2f} GFLOP), max_abs_err "
              f"{r['max_abs_err']:.3g}")
    return rec


def train_step_checks(dev, gpu: str) -> dict:
    """Phase 6: the train step at full width and full batch. Returns the
    launch counts of one step."""
    import torch

    from gcl_tpu_torch import bench
    from gcl_tpu_torch.kernels import launch_counts, reset_launch_counts
    from gcl_tpu_torch.losses.gcl import LossDraws
    from gcl_tpu_torch.models.weights import gradients_by_name
    from gcl_tpu_torch.train.steps import StepDraws

    batch = bench.bench_batch(SEED, BATCH, N_POINTS, dev)
    n_rows = BATCH * bench.N_CLOUDS * NV_CAP
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    draws = StepDraws(
        sample_gate_u=rand(BATCH),
        jitter=(rand(), torch.randn((n_rows, 1), generator=gen, device=dev)),
        loss=LossDraws(rand(256 * BATCH), rand(256 * BATCH),
                       rand(256 * BATCH)))
    lr = 0.1
    runs = {}
    in_step_errs = {}
    for name in ("kernel", "plain", "checked", "plain_nudged"):
        model = bench.bench_model(SEED, dev)
        if name == "plain_nudged":  # weights moved by 1e-7 of themselves
            with torch.no_grad():
                for p in model.parameters():
                    p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=gen,
                                                  device=dev))
        before = {k: v.clone() for k, v in model.state_dict().items()}
        _, step = bench.bench_step(model, BATCH, NV_CAP)
        reset_launch_counts()
        ctx = {"kernel": contextlib.nullcontext(),
               "checked": checked_path(in_step_errs)}.get(name) or plain_path()
        with ctx:
            metrics = step(lr, *batch, draws=draws)
            torch.cuda.synchronize()
        runs[name] = dict(model=model, step=step, before=before,
                          metrics={k: float(v) for k, v in metrics.items()},
                          grads={k: g.clone() for k, g in
                                 gradients_by_name(model).items()},
                          launches=launch_counts())
    launches = runs["kernel"]["launches"]
    print(f"launches per train step: {launches}")
    want = {"K2": 1, "K3": 1, "K4": 1, "K5": 1, "K6": 20, "K7": 20}
    _require(launches == want, f"launches per step {want}, got {launches}")
    _require(not any(runs["plain"]["launches"].values()),
             "the plain path launches no kernel")
    mk, mp = runs["kernel"]["metrics"], runs["plain"]["metrics"]
    print(f"first step, kernel path: {mk}")
    print(f"first step, plain path:  {mp}")
    _require(abs(mk["loss"] - mp["loss"]) <= 1e-4,
             f"loss of kernel and plain path within 1e-4: {mk['loss']} vs "
             f"{mp['loss']}")

    def worst_gradient(a, b):
        worst = ("", 0.0)
        for pname, ga in runs[a]["grads"].items():
            gb = runs[b]["grads"][pname]
            err = float((ga - gb).abs().max()) / float(gb.abs().max())
            worst = max(worst, (pname, err), key=lambda t: t[1])
        return worst

    # Gradients. Inside one step every launch of every kernel is held to
    # its plain version on the same inputs (checked_path, REL_TOL). Between
    # a whole kernel-path step and a whole plain-path step the gradients
    # cannot be held that tightly: their features differ by float32
    # rounding, and a ReLU whose input lies within that rounding of zero
    # opens in one path and stays shut in the other, which moves a
    # channel's gradient by percents of the tensor's max. The plain path
    # shows the same against itself with its weights moved by 1e-7 of
    # themselves, printed beside it as the yardstick; the two paths are
    # held to 0.1 of each tensor's max.
    print(f"kernel vs plain inside the step, worst rel_err per kernel: "
          f"{ {k: float(f'{v:.3g}') for k, v in sorted(in_step_errs.items())} }")
    _require(sorted(in_step_errs) == sorted(want),
             f"all six kernels were checked inside the step: {in_step_errs}")
    free = worst_gradient("kernel", "plain")
    nudged = worst_gradient("plain_nudged", "plain")
    print(f"gradients of whole steps over {len(runs['kernel']['grads'])} "
          f"tensors, worst error relative to the tensor's max: kernel path "
          f"vs plain path {free[1]:.3g} ({free[0]}); plain path with "
          f"weights moved by 1e-7 vs plain path {nudged[1]:.3g} "
          f"({nudged[0]})")
    _require(free[1] <= 0.1, f"gradient of {free[0]} on the kernel path "
                             f"within 0.1 of its max, got {free[1]}")

    model, step = runs["kernel"]["model"], runs["kernel"]["step"]
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):  # the first step above was the warm-up
        t0 = time.perf_counter()
        metrics = step(lr, *batch, generator=gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        _require(all(bool(torch.isfinite(v)) for v in metrics.values()),
                 f"finite metrics, got {metrics}")
        _require(float(metrics["num_groups"]) > 0, "groups were found")
    peak = torch.cuda.max_memory_allocated()
    with plain_path():
        t0 = time.perf_counter()
        runs["plain"]["step"](lr, *batch, generator=gen)
        torch.cuda.synchronize()
        plain_dt = time.perf_counter() - t0
    after = model.state_dict()
    for mname, module in model.named_modules():
        own = [f"{mname}.{p}" for p, _ in module.named_parameters(
            recurse=False)]
        _require(not own or any(
            not torch.equal(after[k], runs["kernel"]["before"][k])
            for k in own), f"a parameter of {mname} changed")
    dt = sorted(times)[1]
    n_vox = float(metrics["num_valid_voxels"])
    print(f"train step, kernel path: step_time_s {dt:.4f} (min "
          f"{min(times):.4f}, max {max(times):.4f}; 3 steps after a "
          f"warm-up), {n_vox / dt:.1f} voxel/s, loss "
          f"{float(metrics['loss']):.6f}, num_groups "
          f"{int(metrics['num_groups'])}, voxels_per_step {int(n_vox)} "
          f"on {gpu}")
    print(f"train step, plain path: step_time_s {plain_dt:.4f} (1 step "
          f"after a warm-up), {n_vox / plain_dt:.1f} voxel/s")
    print(f"peak device memory over the timed steps: {peak / 2**30:.2f} GiB")
    return launches


def main() -> None:
    import torch

    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke run needs a CUDA card")
    from gcl_tpu_torch import infer
    from gcl_tpu_torch.core.kernel_maps import build_graph
    from gcl_tpu_torch.data.device_pipeline import voxelize_per_cloud
    from gcl_tpu_torch.data.synthetic import synth_lidar
    from gcl_tpu_torch.core.coords import lookup
    from gcl_tpu_torch.kernels import (build, c1z_unpack_bits, launch_counts,
                                       occupancy_conv_fwd,
                                       occupancy_conv_fwd_plain,
                                       reset_launch_counts,
                                       sparse_conv_implicit_fwd,
                                       sparse_conv_implicit_fwd_plain)
    from gcl_tpu_torch.models.common import SparseConv

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    gpu = infer.gpu_identity()
    print(f"card: {gpu}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    dev = torch.device("cuda")

    # 2. build
    t0 = time.perf_counter()
    build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {build.build_info.get('seconds', 0.0):.2f} s)")
    for line in build.build_info.get("ptxas", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # 3. K6 and K2 against their plain versions at the serving shapes
    rng = np.random.RandomState(SEED)
    pts = torch.from_numpy(np.stack([synth_lidar(rng, N_POINTS)
                                     for _ in range(2)])).to(dev)
    pmask = torch.ones(pts.shape[:2], dtype=torch.bool, device=dev)
    model = infer.serving_model(SEED, dev)
    extract = infer.serving_extractor(model, NV_CAP)
    specs = extract.conv_specs
    vox = voxelize_per_cloud(pts, pmask, extract.voxel_size, NV_CAP)
    flat = vox.flatten()
    graph = build_graph(flat.coords, flat.mask, specs, extract.level_caps, 2)
    torch.cuda.synchronize()
    print("levels: " + ", ".join(
        f"s{s} {lv.coords.shape[0]} rows / {lv.skeys.shape[0]} valid"
        for s, lv in sorted(graph.levels.items())))

    convs = {}
    for m in model.modules():
        if isinstance(m, SparseConv) and m.spec.kernel_size == 3:
            sig = (m.spec.key, m.spec.in_stride, m.in_ch, m.out_ch)
            convs[sig] = convs.get(sig, 0) + 1
    _require(sum(convs.values()) == 20, f"20 k=3 convs, got {convs}")
    g = torch.Generator(device="cpu").manual_seed(SEED)
    k6_err, k6_ms, k6_plain_ms = 0.0, 0.0, 0.0
    k6_bytes, k6_flops = 0, 0
    for (key, s_in, cin, cout), mult in sorted(convs.items()):
        lv = graph.levels[s_in]
        x = (torch.randn(lv.coords.shape[0], cin, generator=g)
             .to(dev) * lv.mask[:, None])
        w = torch.randn(27, cin, cout, generator=g).to(dev) / (27 * cin) ** .5
        args = (x, w, graph.maps[key].qkey, lv.skeys, lv.srow)
        out = sparse_conv_implicit_fwd(*args)
        torch.cuda.synchronize()
        ref = sparse_conv_implicit_fwd_plain(*args)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
        ms = _ms(lambda: sparse_conv_implicit_fwd(*args), 5)
        pms = _ms(lambda: sparse_conv_implicit_fwd_plain(*args), 5)
        print(f"K6 {key} {cin}->{cout} x{mult}: max_abs_err {err:.3g} "
              f"kernel {ms:.3f} ms plain {pms:.3f} ms")
        k6_err = max(k6_err, err)
        k6_ms += mult * ms
        k6_plain_ms += mult * pms
        matched = int((lookup(lv.skeys, lv.srow, args[2]) >= 0).sum())
        k6_bytes += mult * _nbytes(*args, out)
        k6_flops += mult * 2 * matched * cin * cout

    c1 = graph.maps["s1->s1/k5d1"]
    w1 = torch.randn(125, 1, 32, generator=g).to(dev)
    k2_args = (c1.c1z, graph.levels[1].skeys, w1)
    out, sbits = occupancy_conv_fwd(*k2_args)
    torch.cuda.synchronize()
    ref, ref_bits = occupancy_conv_fwd_plain(*k2_args)
    torch.cuda.synchronize()
    k2_err = float((out - ref).abs().max())
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
    _require(torch.equal(sbits, ref_bits),
             "K2 sbits equal the plain version's")
    _require(int(sbits.count_nonzero()) > 0, "K2 sets presence bits")
    k2_ms = _ms(lambda: occupancy_conv_fwd(*k2_args), 5)
    k2_plain_ms = _ms(lambda: occupancy_conv_fwd_plain(*k2_args), 5)
    print(f"K2 conv1 k5 1->32: max_abs_err {k2_err:.3g} kernel "
          f"{k2_ms:.3f} ms plain {k2_plain_ms:.3f} ms")
    k6_bound = _bound(k6_bytes, k6_flops)
    k2_bound = _bound(_nbytes(*k2_args, out, sbits),
                      32 * int(c1z_unpack_bits(sbits, 125).sum()))
    print(f"bounds per serving pair: K6 {k6_bound[0]:.3f} ms by "
          f"{k6_bound[1]} ({k6_bytes / 1e6:.1f} MB, {k6_flops / 1e9:.2f} "
          f"GFLOP), K2 {k2_bound[0]:.4f} ms by {k2_bound[1]}")

    # 4. the serving slice
    matcher = infer.kitti_matcher(N_KEY)
    gen = torch.Generator().manual_seed(SEED)
    reset_launch_counts()
    t_est, _, feats = infer.register_pair(extract, matcher, pts, pmask,
                                          N_KEY, gen)
    torch.cuda.synchronize()
    launches = launch_counts()
    print(f"launches per pair: {launches}")
    _require(launches == {"K2": 1, "K3": 0, "K4": 0, "K5": 0, "K6": 20,
                          "K7": 0},
             f"1 K2 and 20 K6 launches per pair, got {launches}")
    _require(bool(torch.isfinite(t_est).all())
             and bool(torch.isfinite(feats).all()),
             "finite transform and features")
    _require(feats.shape == (2, NV_CAP, 32),
             f"features [2, {NV_CAP}, 32], got {tuple(feats.shape)}")
    with plain_path():
        _, feats_plain = extract(pts, pmask)
        torch.cuda.synchronize()
    _require(occupancy_conv_fwd.launches == 1
             and sparse_conv_implicit_fwd.launches == 20,
             "the plain path launches no kernel")
    feat_err = float((feats - feats_plain).abs().max())
    print(f"features kernel vs plain path: max_abs_err {feat_err:.3g}")
    _require(feat_err < 1e-3, f"features within 1e-3, got {feat_err}")

    self_pts = torch.stack([pts[0], pts[0]])
    t_self, _, _ = infer.register_pair(extract, matcher, self_pts, pmask,
                                       N_KEY, gen)
    rte, rre = _rte_rre(t_self.cpu().numpy(), np.eye(4))
    print(f"self pair: RTE {rte:.4g} m RRE {rre:.4g} deg")
    _require(rte < 2.0 and rre < 5.0,
             f"self pair within RTE < 2 m, RRE < 5 deg, got {rte}, {rre}")
    shift = torch.tensor([3.0, 0.0, 0.0], device=dev)  # 10 voxels in x
    t_gt = np.eye(4)
    t_gt[0, 3] = 3.0
    t_sh, _, _ = infer.register_pair(
        extract, matcher, torch.stack([pts[0], pts[0] + shift]), pmask,
        N_KEY, gen)
    rte_s, rre_s = _rte_rre(t_sh.cpu().numpy(), t_gt)
    print(f"pair shifted 10 voxels in x: RTE {rte_s:.4g} m "
          f"RRE {rre_s:.4g} deg")

    def pair():
        infer.register_pair(extract, matcher, pts, pmask, N_KEY, gen)
        torch.cuda.synchronize()

    with plain_path():
        pair()  # warm-up of the plain path
    times = {"kernel": 0.0, "plain": 0.0}
    for _ in range(REPS):  # alternate the two paths pair by pair
        for name in ("kernel", "plain"):
            ctx = plain_path() if name == "plain" else contextlib.nullcontext()
            with ctx:
                t0 = time.perf_counter()
                pair()
                times[name] += time.perf_counter() - t0
    for name, tot in times.items():
        dt = tot / REPS
        print(f"{name} path: {1.0 / dt:.3f} pairs/s, {dt * 1e3:.2f} ms "
              f"per pair ({REPS} pairs after a warm-up) on {gpu}")

    # 5. and 6. the train step
    rec = train_kernel_checks(dev)
    step_launches = train_step_checks(dev, gpu)

    table = [
        ("K6", "sparse_conv_implicit_fwd", "sparse_conv_fwd.cu", 781),
        ("K7", "sparse_conv_implicit_bwd", "sparse_conv_bwd.cu", 820),
        ("K2", "occupancy_conv_fwd", "occupancy_conv_fwd.cu", 1024),
        ("K3", "occupancy_conv_dw", "occupancy_conv_dw.cu", 1118),
        ("K4", "scalar_conv_fwd", "scalar_conv.cu", 917),
        ("K5", "scalar_conv_dw", "scalar_conv.cu", 973)]
    kernels = []
    for k, name, src, line in table:
        r = rec[k]
        kernels.append({
            "name": f"{name} ({k})", "route": "cuda",
            "source": f"gcl_tpu_torch/csrc/{src}",
            "replaces": f"gcl_tpu/core/pallas_conv.py:{line}",
            "launches": step_launches[k], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            # no single PyTorch call computes any of these functions
            "library_ms": None, "shapes": "train step"})
    kernels[0].update(serving_launches=launches["K6"],
                      serving_max_abs_err=k6_err, serving_ms=k6_ms,
                      serving_plain_ms=k6_plain_ms,
                      serving_bound_ms=k6_bound[0])
    kernels[2].update(serving_launches=launches["K2"],
                      serving_max_abs_err=k2_err, serving_ms=k2_ms,
                      serving_plain_ms=k2_plain_ms,
                      serving_bound_ms=k2_bound[0])
    print(json.dumps({"kernels": kernels}))
    print(f"{gpu}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
