"""Smoke run of gcl_tpu_torch's serving path on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:

1. device: requires CUDA (there is no CPU run), turns TF32 off for
   float32 matmuls and convolutions, prints the card's name and power
   limit;
2. build: compiles the CUDA kernels from gcl_tpu_torch/csrc with nvcc;
3. kernels: runs each kernel against its plain PyTorch version on the card
   at the serving path's shapes (two synthetic 65,536-point LiDAR clouds,
   voxel 0.3 m): K6 for every k=3 conv of ResUNetFatBN at its real
   Cin / Cout (rtol = atol = 1e-4), K2 on conv1 (out within 1e-5, sbits
   exact), and times both versions with CUDA events;
4. slice: registers pairs with ResUNetFatBN (seeded random weights) +
   SC2-PCR at bench_infer.py's settings: exactly 1 K2 and 20 K6 launches
   per pair, kernel-path features within 1e-3 of the plain path's on the
   same card, a cloud registered against itself within RTE < 2 m and
   RRE < 5 deg, and pairs/s of both paths;
5. prints {"kernels": [...]}, the card line and, last, the
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
def plain_path():
    """Route the model's convs through the kernels' plain versions (for the
    comparison run only)."""
    from gcl_tpu_torch.core import sparse_ops
    from gcl_tpu_torch.kernels import (occupancy_conv_fwd_plain,
                                       sparse_conv_implicit_fwd_plain)

    saved = (sparse_ops.sparse_conv_implicit_fwd,
             sparse_ops.occupancy_conv_fwd)
    sparse_ops.sparse_conv_implicit_fwd = sparse_conv_implicit_fwd_plain
    sparse_ops.occupancy_conv_fwd = occupancy_conv_fwd_plain
    try:
        yield
    finally:
        (sparse_ops.sparse_conv_implicit_fwd,
         sparse_ops.occupancy_conv_fwd) = saved


def _rte_rre(t_est, t_gt):
    r = t_est[:3, :3].T @ t_gt[:3, :3]
    cos = np.clip((np.trace(r) - 1.0) / 2.0, -1.0, 1.0)
    return (float(np.linalg.norm(t_est[:3, 3] - t_gt[:3, 3])),
            float(np.degrees(np.arccos(cos))))


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
    from gcl_tpu_torch.kernels import (build, occupancy_conv_fwd,
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

    # 3. kernels against their plain versions at the slice's shapes
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

    # 4. the slice
    matcher = infer.kitti_matcher(N_KEY)
    gen = torch.Generator().manual_seed(SEED)
    reset_launch_counts()
    t_est, _, feats = infer.register_pair(extract, matcher, pts, pmask,
                                          N_KEY, gen)
    torch.cuda.synchronize()
    launches = {"K2": occupancy_conv_fwd.launches,
                "K6": sparse_conv_implicit_fwd.launches}
    print(f"launches per pair: {launches}")
    _require(launches == {"K2": 1, "K6": 20},
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

    print(json.dumps({"kernels": [
        {"name": "sparse_conv_implicit_fwd (K6)", "route": "cuda",
         "source": "gcl_tpu_torch/csrc/sparse_conv_fwd.cu",
         "replaces": "gcl_tpu/core/pallas_conv.py:781",
         "launches": launches["K6"], "max_abs_err": k6_err,
         "ms": k6_ms, "plain_ms": k6_plain_ms},
        {"name": "occupancy_conv_fwd (K2)", "route": "cuda",
         "source": "gcl_tpu_torch/csrc/occupancy_conv_fwd.cu",
         "replaces": "gcl_tpu/core/pallas_conv.py:1024",
         "launches": launches["K2"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]}))
    print(f"{gpu}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
