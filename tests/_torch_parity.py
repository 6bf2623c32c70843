"""Shared inputs for the gcl_tpu_torch parity tests (tests/test_torch_*.py).

Every input is made once with numpy from a seed and handed to both
packages; results come back to numpy for comparison. JAX stays on the CPU
(tests/conftest.py) and runs its XLA path: build_graph(method='auto')
resolves to sort-join explicit maps plus the scan sparse_conv there.
"""
import numpy as np
import pytest
import torch

VOXEL = 0.3


@pytest.fixture(scope="module")
def one_torch_thread():
    """torch's CPU ops on one thread for a module's tests: their tensors are
    small, and the test workers already run one per core, where a pool of
    threads a worker waits on descheduled threads at every parallel op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def clouds(seed: int, n_clouds: int = 2, n_points: int = 700):
    """Small LiDAR-like clouds, float32[C, P, 3] (a ground patch + posts,
    a few metres across, so a few hundred voxels each) and pmask with a
    few dropped points."""
    rng = np.random.RandomState(seed)
    pts = np.empty((n_clouds, n_points, 3), np.float32)
    for c in range(n_clouds):
        n_g = n_points // 2
        ground = np.concatenate([rng.uniform(-4, 4, (n_g, 2)),
                                 rng.randn(n_g, 1) * 0.05], 1)
        posts = (rng.uniform(-4, 4, (8, 3)) * [1, 1, 0])[
            rng.randint(0, 8, n_points - n_g)]
        posts = posts + rng.randn(n_points - n_g, 3) * [0.3, 0.3, 1.0]
        pts[c] = np.concatenate([ground, posts]) + rng.randn(3) * 2
    pmask = rng.rand(n_clouds, n_points) > 0.05
    return pts, pmask


def fatbn_specs():
    from gcl_tpu_torch.models.resunet import ResUNetFatBN
    return ResUNetFatBN.conv_specs(5)


# ResUNetFatBNEXP's strides and kernel sizes at test widths
NARROW_EXP = dict(CHANNELS=[None, 8, 8, 16, 16],
                  TR_CHANNELS=[None, 16, 16, 16, 16])


def narrow_exp_classes():
    """The narrow EXP variant in both packages (defined here, for tests
    only): (gcl_tpu class, gcl_tpu_torch class)."""
    from gcl_tpu.models.resunet import ResUNetFatBNEXP as JEXP
    from gcl_tpu_torch.models.resunet import ResUNetFatBNEXP

    return (type("NarrowEXP", (JEXP,), dict(NARROW_EXP)),
            type("NarrowEXP", (ResUNetFatBNEXP,), dict(NARROW_EXP)))


def strides_of(specs):
    return sorted({s for sp in specs for s in (sp.in_stride, sp.out_stride)})


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def jax_specs(specs):
    from gcl_tpu.core.kernel_maps import ConvSpec as JSpec
    return [JSpec(s.name, s.in_stride, s.out_stride, s.kernel_size,
                  s.dilation) for s in specs]


def jax_graph(coords, mask, specs, caps, n_clouds):
    """gcl_tpu's graph of level-0 rows in the voxelize_per_cloud layout
    (jitted: one compile instead of hundreds of eager op compiles)."""
    import jax
    import jax.numpy as jnp
    from gcl_tpu.core.kernel_maps import build_graph

    jspecs = jax_specs(specs)
    build = jax.jit(lambda c, m: build_graph(
        c, m, jspecs, caps, sorted_blocks=True, n_clouds=n_clouds))
    return build(jnp.asarray(coords), jnp.asarray(mask))


def jax_map_refs(graph, specs):
    """For every forward geometry with a kernel: (query keys as
    _build_fused_maps packs them, _build_kmap's rows), in one jit."""
    import jax
    import jax.numpy as jnp
    from gcl_tpu.core import kernel_maps as jkm
    from gcl_tpu.core.coords import pack_query_keys

    specs = [sp for sp in jax_specs(specs) if not sp.is_identity_map]

    @jax.jit
    def refs(levels):
        out = {}
        for sp in specs:
            offs = jkm.kernel_offsets(sp.kernel_size) * sp.offset_scale
            folded = jkm._fold_clouds(levels[sp.out_stride].coords)
            qk = jax.vmap(lambda o, sp=sp: pack_query_keys(
                folded, o, sp.in_stride))(jnp.asarray(offs))
            km = jkm._build_kmap(levels[sp.out_stride],
                                 levels[sp.in_stride], sp.in_stride, offs)
            out[sp.key] = (qk, km)
        return out

    return jax.tree_util.tree_map(np.asarray, refs(graph.levels))


def voxelized(seed, n_clouds, nv, n_points=700, scale=1.0):
    """Level-0 (coords, mask) of clouds(seed, ...) spread ``scale`` times
    wider, voxelized as the train step does."""
    from gcl_tpu_torch.data.device_pipeline import voxelize_per_cloud

    pts, pmask = clouds(seed, n_clouds, n_points)
    pts = (pts * scale).astype(np.float32)
    vox = voxelize_per_cloud(torch.from_numpy(pts), torch.from_numpy(pmask),
                             VOXEL, nv)
    flat = vox.flatten()
    return to_np(flat.coords), to_np(flat.mask)


def check_graph(coords, mask, specs, caps, n_clouds):
    """Levels and every forward map of the port equal gcl_tpu's: level
    coords / masks row for row, query keys as _build_fused_maps packs
    them, and the resolved rows against _build_kmap and the sort-join
    maps."""
    from gcl_tpu_torch.core.coords import lookup
    from gcl_tpu_torch.core.kernel_maps import build_graph

    g = build_graph(torch.from_numpy(coords), torch.from_numpy(mask), specs,
                    caps, n_clouds)
    gj = jax_graph(coords, mask, specs, caps, n_clouds)
    assert sorted(g.levels) == sorted(gj.levels)
    for s, lv in g.levels.items():
        np.testing.assert_array_equal(to_np(lv.coords),
                                      np.asarray(gj.levels[s].coords))
        np.testing.assert_array_equal(to_np(lv.mask),
                                      np.asarray(gj.levels[s].mask))
        assert (np.diff(to_np(lv.skeys).astype(np.int64)) > 0).all()
    refs = jax_map_refs(gj, specs)
    for sp in specs:
        if sp.is_identity_map:
            continue
        qk, ref = refs[sp.key]
        cmap = g.maps[sp.key]
        np.testing.assert_array_equal(to_np(cmap.qkey), qk)
        lv = g.levels[sp.in_stride]
        rows = to_np(lookup(lv.skeys, lv.srow, cmap.qkey))
        np.testing.assert_array_equal(rows, ref)
        np.testing.assert_array_equal(rows, np.asarray(gj.kmaps[sp.key]))
    return g, gj


def assert_close_to_max(got, ref, rel: float, what: str = ""):
    """max|got - ref| <= rel * max|ref|, on arrays of one shape."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = float(np.abs(ref).max())
    assert scale > 0, f"{what}: the reference is all zero"
    err = float(np.abs(got - ref).max())
    assert err <= rel * scale, f"{what}: {err} > {rel} * {scale}"


def bf16_ordered(t: torch.Tensor) -> torch.Tensor:
    """bf16 values as int32 in the order of the values: neighbours in bf16
    differ by one (+0 and -0 are both 0)."""
    bits = t.detach().cpu().contiguous().view(torch.int16).to(torch.int32)
    return torch.where(bits < 0, -(bits & 0x7FFF), bits)


def assert_bf16_close(got, ref, what: str = "", bound=None):
    """got and ref bf16 of one shape (any array of bf16 values): equal bit
    for bit on >= 99.9% of the elements, within one bf16 ulp on the rest:
    the gate for two sums of the same exact products in float32, in
    another order, each rounded to bf16 once. Where a sum cancels, its
    float32 rounding can exceed a bf16 ulp of the result in any order;
    there, with ``bound`` given (a tensor of ref's shape, the two float32
    sums' error bound), the elements may differ by one ulp plus it."""
    got, ref = (
        (t if torch.is_tensor(t) else torch.from_numpy(np.array(t)))
        .detach().cpu().to(torch.bfloat16) for t in (got, ref))
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert bool(ref.float().abs().max() > 0), f"{what}: all zero"
    ulps = (bf16_ordered(got) - bf16_ordered(ref)).abs()
    share = float((ulps == 0).float().mean())
    assert share >= 0.999, f"{what}: bit-equal on {share} of the elements"
    far = ulps > 1
    if bound is None or not bool(far.any()):
        assert int(ulps.max()) <= 1, f"{what}: {int(ulps.max())} ulps apart"
        return
    _, e = torch.frexp(ref.float())
    ulp = torch.where(ref == 0, 0.0, torch.ldexp(torch.ones_like(e, dtype=
                                                              torch.float32),
                                                 e - 8))
    room = ulp + torch.as_tensor(bound).detach().cpu().float()
    diff = (got.float() - ref.float()).abs()
    worst = float((diff[far] / room[far]).max())
    assert worst <= 1, (f"{what}: {int(far.sum())} elements more than one "
                        f"ulp apart, up to {worst} x one ulp + the bound")


def replay_loss_draws(key, n_groups: int, n_voxels: int,
                      max_pos_cluster: int, max_hn_samples: int):
    """The uniforms gcl_tpu's finest_contrastive_loss draws from ``key``
    (its key splits, losses/gcl.py, and sample_without_replacement's one
    uniform call per pick), as the port's LossDraws."""
    import jax
    from gcl_tpu_torch.losses.gcl import LossDraws

    k_sel, _, k_neg = jax.random.split(key, 3)
    k1, k2, _ = jax.random.split(k_neg, 3)

    def u(k, m, n):
        return torch.from_numpy(np.array(
            jax.random.uniform(k, (min(m, n),))))

    return LossDraws(u(k_sel, max_pos_cluster, n_groups),
                     u(k1, max_hn_samples, n_voxels),
                     u(k2, max_hn_samples, n_voxels))



def replay_pair_loss_draws(kind: str, key, n_pairs: int, n0: int, n1: int,
                           num_pos: int = 0, num_hn: int = 0,
                           num_rand: int = 0, num_neg: int = 0):
    """The numbers gcl_tpu's pair loss ``kind`` ('hardest_contrastive',
    'contrastive', 'triplet', 'hardest_triplet') draws from ``key`` (its
    key splits, losses/pairs.py: one uniform call per
    sample_without_replacement, one randint per sample_uniform_index), as
    the port's PairLossDraws."""
    import jax
    from gcl_tpu_torch.losses.pairs import PairLossDraws

    def u(k, m, n):
        return torch.from_numpy(np.array(
            jax.random.uniform(k, (min(m, n),))))

    if kind == "contrastive":
        k0, k1 = jax.random.split(key)
        return PairLossDraws(**{
            f"r{i}": torch.from_numpy(np.array(
                jax.random.randint(k, (num_neg,), 0, n))).long()
            for i, (k, n) in enumerate(((k0, n0), (k1, n1)))})
    if kind == "hardest_contrastive":
        k_pos, k0, k1 = jax.random.split(key, 3)
        return PairLossDraws(pos=u(k_pos, num_pos, n_pairs),
                             hn0=u(k0, num_hn, n0), hn1=u(k1, num_hn, n1))
    if kind == "triplet":
        k_pos, k_rt, k_neg = jax.random.split(key, 3)
        return PairLossDraws(pos=u(k_pos, num_pos, n_pairs),
                             rand=u(k_rt, num_rand, n_pairs),
                             neg=u(k_neg, num_rand, n1))
    k_pos, k0, k1, k_rt, k_neg = jax.random.split(key, 5)
    return PairLossDraws(pos=u(k_pos, num_pos, n_pairs),
                         hn0=u(k0, num_hn, n0), hn1=u(k1, num_hn, n1),
                         rand=u(k_rt, num_rand, n_pairs),
                         neg=u(k_neg, num_rand, n1))


def replay_pair_step_draws(k, n_samples: int, n_rows: int, n_pairs: int,
                           kind: str = "hardest_contrastive", **counts):
    """The PairDraws of gcl_tpu's pair grad_fn of trainer ``kind`` called
    with key k (train/steps.py): side s takes fold_in(k, s), split into
    (key, k_gate); its gates uniform(k_gate, [B]), its noise the normals
    of the second half of split(key) (the first half's uniform is the
    always-open p = 1 gate); the loss draws from k itself (``counts`` as
    replay_pair_loss_draws takes them)."""
    import jax
    from gcl_tpu_torch.train.steps import PairDraws, StepDraws

    sides = []
    for s in (0, 1):
        key, k_gate = jax.random.split(jax.random.fold_in(k, s))
        k1, k2 = jax.random.split(key)
        sides.append(StepDraws(
            torch.from_numpy(np.array(jax.random.uniform(k_gate,
                                                         (n_samples,)))),
            (torch.from_numpy(np.array(jax.random.uniform(k1))),
             torch.from_numpy(np.array(jax.random.normal(k2,
                                                         (n_rows, 1)))))))
    return PairDraws(*sides, replay_pair_loss_draws(kind, k, n_pairs, n_rows,
                                                    n_rows, **counts))

# --- key-window cases (K10's and K2's window tables) ---------------------

def _face_coords():
    """One cloud of voxels on the faces of the key window: x, y at -512 /
    511 (the two-word keys' window) and z at -64 / 63 (the packed keys'
    z field), with neighbours inside, in key order; pads at the tail."""
    from gcl_tpu_torch.core.types import INVALID_BATCH
    xyz = np.array([(x, y, z) for x in (-512, -511, 0, 510, 511)
                    for y in (-512, -511, 0, 511) for z in (-64, -63, 0, 62, 63)],
                   np.int32)
    xyz = xyz[np.lexsort((xyz[:, 2], xyz[:, 1], xyz[:, 0]))]
    return _one_cloud(xyz, INVALID_BATCH)


def _one_cloud(xyz, invalid):
    n = len(xyz)
    cap = -(-n // 256) * 256 + 256
    coords = np.full((cap, 4), -1, np.int32)
    coords[:, 0] = invalid
    coords[:n, 0] = 0
    coords[:n, 1:] = xyz
    return coords, np.arange(cap) < n


def _upmap_coords(seed=0):
    """tests/test_core.py::test_upmap_window_soundness's level: ~4000
    unique voxels of one cloud in key order, pads at the tail."""
    from gcl_tpu_torch.core.types import INVALID_BATCH
    rng = np.random.RandomState(seed)
    pts = rng.randint(-30, 30, size=(4000, 2))
    z = rng.randint(-16, 16, size=(4000, 1))
    xyz = np.unique(np.concatenate([pts, z], axis=1), axis=0)
    xyz = xyz[np.lexsort((xyz[:, 2], xyz[:, 1], xyz[:, 0]))]
    return _one_cloud(xyz.astype(np.int32), INVALID_BATCH)


def _clouds_level(seed, n_clouds, nv, n_points):
    from gcl_tpu_torch.data.device_pipeline import voxelize_per_cloud
    pts, pmask = clouds(seed, n_clouds, n_points)
    flat = voxelize_per_cloud(torch.from_numpy(pts), torch.from_numpy(pmask),
                              VOXEL, nv).flatten()
    return to_np(flat.coords), to_np(flat.mask)


# name -> (level-0 coords, mask, clouds, conv specs)
def window_case(name: str):
    from gcl_tpu_torch.core.kernel_maps import ConvSpec
    s13 = [ConvSpec("block", 1, 1, 3), ConvSpec("down", 1, 2, 3),
           ConvSpec("block2", 2, 2, 3)]
    if name == "blocked_28":     # 4 x 7 clouds: cloud-blocked levels
        return (*_clouds_level(11, 28, 160, 300), 28, fatbn_specs())
    if name == "compacted_56":   # 8 x 7 clouds: one compacted run
        return (*_clouds_level(12, 56, 64, 120), 56, fatbn_specs())
    if name == "faces":
        return (*_face_coords(), 1, [ConvSpec("conv1", 1, 1, 5)] + s13)
    if name == "upmap_scale":
        return (*_upmap_coords(), 1, [ConvSpec("conv1", 1, 1, 5)] + s13)
    if name == "clouds_20_nv90":  # clouds >= 16, tiles that mix clouds
        return (*_clouds_level(13, 20, 90, 260), 20,
                [ConvSpec("conv1", 1, 1, 5), ConvSpec("block", 1, 1, 3)])
    if name == "clouds_31_nv70":  # the most clouds packed keys address
        return (*_clouds_level(14, 31, 70, 200), 31,
                [ConvSpec("conv1", 1, 1, 5), ConvSpec("block", 1, 1, 3)])
    raise KeyError(name)


JOIN_WINDOW_CASES = ("blocked_28", "compacted_56", "faces", "upmap_scale")
OCC_WINDOW_CASES = ("blocked_28", "clouds_20_nv90", "clouds_31_nv70",
                    "faces", "upmap_scale")


def join_window_geometries(name: str, device="cpu"):
    """The explicit route's geometries of case ``name``: (map key, level
    keys (key_hi, key_lo, perm), queries (qhi, qlo), out coords, in
    stride, offsets) for every table build_graph makes."""
    from gcl_tpu_torch.core import kernel_maps as tkm
    coords, mask, n_clouds, specs = window_case(name)
    caps = tkm.default_level_caps(len(coords), strides_of(specs), 0.7)
    g = tkm.build_graph(torch.from_numpy(coords).to(device),
                        torch.from_numpy(mask).to(device), specs, caps,
                        n_clouds, method="explicit")
    out = []
    for key in sorted(g.kmaps):
        a, b = key.split("/")[0].split("->")
        s_in, s_out = int(a[1:]), int(b[1:])
        k = int(key.split("/k")[1].split("d")[0])
        offs = tkm.kernel_offsets(k) * min(s_in, s_out)
        lv, lv_out = g.levels[s_in], g.levels[s_out]
        qhi, qlo = tkm.two_word_query_keys(lv_out, s_in, offs)
        out.append((key, (lv.key_hi, lv.key_lo, lv.perm), (qhi, qlo),
                    lv_out.coords, s_in, offs))
    return out


def _occupancy_level(name: str, side: int, device):
    """(aux, level) of case ``name``'s stride-1 level for a cube conv of
    the given side."""
    from gcl_tpu_torch.core.kernel_maps import ConvSpec, build_graph
    coords, mask, n_clouds, _ = window_case(name)
    spec = ConvSpec("occ", 1, 1, side)
    g = build_graph(torch.from_numpy(coords).to(device),
                    torch.from_numpy(mask).to(device), [spec], {}, n_clouds)
    return g.maps[spec.key].c1z, g.levels[1]


def occupancy_window_inputs(name: str, side: int, device="cpu"):
    """(aux, skeys) of case ``name``'s stride-1 level for an occupancy conv
    of the given side, and the level's coords."""
    aux, lv = _occupancy_level(name, side, device)
    return aux, lv.skeys, lv.coords


def scalar_window_inputs(name: str, side: int, device="cpu"):
    """(aux, skeys, srow, row_sel) of case ``name``'s stride-1 level for the
    scalar conv (K4, K5) of the given side. row_sel f32[N] flags about 70%
    of the valid rows (seeded) of two tiles in three and no row of the
    third, so that some tiles have no flagged row and the others a flag
    that varies inside them."""
    from gcl_tpu_torch.kernels.occupancy_conv import TILE
    aux, lv = _occupancy_level(name, side, device)
    n = aux.shape[0]
    rng = np.random.RandomState(side)
    flag = (rng.rand(n) < 0.7) & (np.arange(n) // TILE % 3 != 1)
    sel = torch.from_numpy(flag.astype(np.float32)).to(device)
    return aux, lv.skeys, lv.srow, sel * lv.mask.to(torch.float32)


TOPK_WINDOW_CASES = ("home_sorted", "sorted", "sentinels", "grid_edge")


def _captured_topk(search):
    """The six arrays (tkey_s, trow_s, txyz_s, pbase, qxyz, r2) that
    search() hands kernels.radius_topk.windowed_cell_topk_packed (K1), in
    place of which an empty result comes back: the cases need the arrays,
    not a dense search of them on the CPU."""
    from gcl_tpu_torch.kernels import radius_topk
    seen = []

    def record(*a):
        seen.append(a[:6])
        s_n, q_n, kn = a[3].shape[0], a[3].shape[1], a[6]
        return (torch.full((s_n, q_n, kn), -1, dtype=torch.int32,
                           device=a[0].device),
                torch.full((s_n, q_n, kn), 1e30, device=a[0].device))

    real = radius_topk.windowed_cell_topk_packed
    radius_topk.windowed_cell_topk_packed = record
    try:
        search()
    finally:
        radius_topk.windowed_cell_topk_packed = real
    assert len(seen) == 1
    return seen[0]


def _random_search(seed, s_n, q_n, t_n, spread, drop=0.1, device="cpu",
                   shift=0.0):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(s_n, q_n, 3, generator=gen) * spread + shift
    t = torch.randn(s_n, t_n, 3, generator=gen) * spread + shift
    qm = torch.rand(s_n, q_n, generator=gen) > drop
    tm = torch.rand(s_n, t_n, generator=gen) > drop
    return q.to(device), qm.to(device), t.to(device), tm.to(device)


def topk_window_inputs(name: str, device="cpu"):
    """The arrays that K1 (kernels.windowed_cell_topk_packed) receives in
    case ``name``, as the port's group search prepares them:

    * home_sorted: the train step's search (data.device_pipeline.
      _grid_searches): 2 samples x 3 clouds, queries sorted by HOME cell,
      so the bases are only about monotone;
    * sorted: batched_grid_radius_knn's, queries sorted by base;
    * sentinels: as sorted, with 40% of the queries invalid (their
      sentinel bases sort last: whole tiles of them, and a tile of both);
    * grid_edge: queries and targets in the cells next to the +-2^9 grid
      edge of each axis: bases at its first and last cells, and sentinel
      bases for the queries whose probe block leaves it;
    * step: the 4 x 7 train step's search (root bench.py's batch, seed 0:
      S = 28, T = Q = 18,432).

    Tiles that straddle x cells occur in every case."""
    from gcl_tpu_torch.data import device_pipeline as dp
    if name == "home_sorted":
        pts, pmask = clouds(21, 6, 900)
        vox = dp.voxelize_per_cloud(torch.from_numpy(pts).to(device),
                                    torch.from_numpy(pmask).to(device),
                                    VOXEL, 600)
        vox_b = dp.VoxelizedClouds(vox.coords.reshape(2, 3, 600, 4),
                                   vox.mask.reshape(2, 3, 600),
                                   vox.xyz.reshape(2, 3, 600, 3))
        trans = torch.eye(4).repeat(2, 3, 1, 1)
        trans[:, 1, 0, 3], trans[:, 2, 1, 3] = 0.4, -0.3
        return _captured_topk(lambda: dp._grid_searches(
            vox_b, trans.to(device), torch.tensor([0.45, 0.7], device=device),
            5, 1.2))
    if name == "step":
        from gcl_tpu_torch import bench
        b, c, p, nv = 4, bench.N_CLOUDS, 65536, 18432
        points, pmask, trans, radius = bench.bench_batch(0, b, p, device)
        vox = dp.voxelize_per_cloud(points.reshape(b * c, p, 3),
                                    pmask.reshape(b * c, p), 0.3, nv)
        vox_b = dp.VoxelizedClouds(vox.coords.reshape(b, c, nv, 4),
                                   vox.mask.reshape(b, c, nv),
                                   vox.xyz.reshape(b, c, nv, 3))
        return _captured_topk(lambda: dp._grid_searches(
            vox_b, trans, radius, 5, bench.SEARCH_CELL))
    if name == "sorted":
        q, qm, t, tm = _random_search(31, 3, 1500, 1800, 3.0, device=device)
    elif name == "sentinels":
        q, qm, t, tm = _random_search(32, 2, 1500, 1200, 2.5, drop=0.4,
                                      device=device)
    elif name == "grid_edge":
        # cell 1: the cells of the grid are -512 .. 511 on each axis; the
        # points sit in -512 .. -509 and 508 .. 511, on every axis at once
        q, qm, t, tm = _random_search(33, 2, 900, 1400, 1.0, drop=0.0,
                                      device=device)
        gen = torch.Generator().manual_seed(34)

        def at_edges(x):
            corner = torch.where(torch.rand(x.shape[:2] + (1,),
                                            generator=gen) < 0.5,
                                 -510.0, 510.0)
            return x.clamp(-1.99, 1.99) + corner.to(device)

        q, t = at_edges(q), at_edges(t)
    else:
        raise KeyError(name)
    r = torch.linspace(0.3, 0.5, q.shape[0], device=device)
    return _captured_topk(lambda: dp._batched_grid_core(
        q, qm, t, tm, r, 5, 1.0, presorted=False))
