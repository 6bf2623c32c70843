"""Colocation groups of the port against gcl_tpu, on the same clouds,
transforms and per-sample radii: the brute-force radius_knn, the hash-grid
searches (grid_radius_knn in plain tensor code; the batched search through
windowed_cell_topk, gcl_tpu's side in Pallas interpret mode) and the group
tables built from each. Everything compared is an integer or a mask, or a
float copied from the inputs: exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcl_tpu.data import device_pipeline as jdp
from gcl_tpu_torch.data import device_pipeline as tdp

from _torch_parity import VOXEL, clouds, to_np

B, C, NV, K = 2, 3, 320, 5


def _transforms(seed):
    """[B, C, 4, 4]: identity for the centre cloud, a small yaw and a
    shift of a metre or two for the neighbours."""
    rng = np.random.RandomState(seed)
    t = np.broadcast_to(np.eye(4, dtype=np.float32), (B, C, 4, 4)).copy()
    for b in range(B):
        for c in range(1, C):
            a = rng.uniform(-0.2, 0.2)
            t[b, c, :2, :2] = [[np.cos(a), -np.sin(a)],
                               [np.sin(a), np.cos(a)]]
            t[b, c, :3, 3] = rng.uniform(-1.5, 1.5, 3) * [1, 1, 0.1]
    return t


@pytest.fixture(scope="module")
def batch():
    # neighbour clouds: the sample's centre scene seen from the
    # neighbour's pose (inverse transform), resampled with some noise
    centre, pmask = clouds(21, B, 600)
    transforms = _transforms(4)
    rng = np.random.RandomState(5)
    pts = np.empty((B, C, 600, 3), np.float32)
    for b in range(B):
        for c in range(C):
            world = centre[b] + rng.randn(600, 3).astype(np.float32) * 0.05
            r, t = transforms[b, c, :3, :3], transforms[b, c, :3, 3]
            pts[b, c] = (world - t) @ r  # inverse of x @ r.T + t
    pts = pts.reshape(B * C, 600, 3)
    pmask = np.repeat(pmask, C, axis=0) & (rng.rand(B * C, 600) > 0.1)
    tv = tdp.voxelize_per_cloud(torch.from_numpy(pts),
                                torch.from_numpy(pmask), VOXEL, NV)
    jv = jdp.voxelize_per_cloud(jnp.asarray(pts), jnp.asarray(pmask), VOXEL,
                                NV)
    np.testing.assert_array_equal(to_np(tv.xyz), np.asarray(jv.xyz))
    tv_b = tdp.VoxelizedClouds(tv.coords.reshape(B, C, NV, 4),
                               tv.mask.reshape(B, C, NV),
                               tv.xyz.reshape(B, C, NV, 3))
    jv_b = jax.tree_util.tree_map(
        lambda x: x.reshape((B, C) + x.shape[1:]), jv)
    return tv_b, jv_b, transforms, np.array([0.45, 0.6], np.float32)


def test_radius_knn_exact(batch):
    """Hits and, where hit, neighbour rows; gcl_tpu's top_k keeps the lower
    index among equal distances and so does the port."""
    tv_b, jv_b, _, _ = batch
    q, qm = tv_b.xyz[0, 0], tv_b.mask[0, 0]
    t, tm = tv_b.xyz[0, 0] + 0.1, tv_b.mask[0, 0]
    for chunk in (64, 512):
        idx, hit = tdp.radius_knn(q, qm, t, tm, 0.5, K, chunk)
        jidx, jhit = jdp.radius_knn(jnp.asarray(to_np(q)),
                                    jnp.asarray(to_np(qm)),
                                    jnp.asarray(to_np(t)),
                                    jnp.asarray(to_np(tm)), 0.5, K, chunk)
        np.testing.assert_array_equal(to_np(hit), np.asarray(jhit))
        np.testing.assert_array_equal(to_np(idx)[to_np(hit)],
                                      np.asarray(jidx)[np.asarray(jhit)])
        assert idx.dtype == torch.int32 and to_np(hit).sum() > 200


def test_radius_knn_ties_keep_lower_index():
    """Duplicate targets at one distance: the lower row comes first."""
    q = torch.tensor([[0.0, 0.0, 0.0]])
    t = torch.tensor([[1.0, 0, 0], [0, 1.0, 0], [0.5, 0, 0], [0, 0, -1.0],
                      [0, 0.5, 0], [9.0, 9, 9]])
    idx, hit = tdp.radius_knn(q, torch.ones(1, dtype=torch.bool), t,
                              torch.tensor([1, 1, 1, 1, 1, 0], dtype=bool),
                              1.0, 5)
    assert idx.tolist() == [[2, 4, 0, 1, 3]] and hit.all()
    jidx, _ = jdp.radius_knn(jnp.asarray(to_np(q)), jnp.ones(1, bool),
                             jnp.asarray(to_np(t)),
                             jnp.asarray([1, 1, 1, 1, 1, 0], bool), 1.0, 5)
    assert np.asarray(jidx).tolist() == idx.tolist()


def test_batch_colocation_groups_exact(batch):
    tv_b, jv_b, transforms, radius = batch
    g = tdp.batch_colocation_groups(tv_b, torch.from_numpy(transforms),
                                    torch.from_numpy(radius), k=K, chunk=128)
    ref = jax.jit(lambda v, t, r: jdp.batch_colocation_groups(
        v, t, r, k=K, chunk=128, cell=None))(
            jv_b, jnp.asarray(transforms), jnp.asarray(radius))
    _assert_groups_equal(g, ref)
    n_valid = int(to_np(g.valid).sum())
    assert n_valid > 100
    fin = to_np(g.finest_pos)[to_np(g.valid)]
    assert (fin == 0).any() and (fin > 0).any()  # both finest outcomes
    assert (to_np(g.member_idx)[B * NV // 2:].max() >= C * NV)  # sample 1


def _assert_groups_equal(g, ref):
    for name in ("member_idx", "member_mask", "finest_pos", "valid",
                 "anchor_xyz", "anchor_item"):
        got, want = to_np(getattr(g, name)), np.asarray(getattr(ref, name))
        assert got.shape == want.shape, name
        if name == "member_idx":  # rows are meaningful where they hit
            got = np.where(to_np(g.member_mask), got, -1)
            want = np.where(np.asarray(ref.member_mask), want, -1)
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_cell_keys_and_octant_bases_exact():
    """Cell keys of targets (binned by a divide) and probe-block bases of
    queries (binned by a multiply with float32(1 / cell)), masked rows and
    rows outside the +-512 cell grid included."""
    rng = np.random.RandomState(2)
    x = (rng.randn(3, 400, 3) * 6).astype(np.float32)
    x[0, :4] = [[700.0, 0, 0], [-700.0, 0, 0], [0, 459.6, 0], [0, 0, -460.7]]
    m = rng.rand(3, 400) > 0.2
    m[0, :4] = True
    for cell in (0.9, 1.08, 1.2):
        cells = np.floor(np.where(m[..., None], x, 1e30) / np.float32(cell))
        key, ok = tdp._cell_key(tdp._to_cell(torch.from_numpy(
            np.where(m[..., None], x, np.float32(1e30))) / cell),
            torch.from_numpy(m))
        jkey, jok = jdp._cell_key(jnp.floor(jnp.where(
            jnp.asarray(m)[..., None], jnp.asarray(x), 1e30) / cell).astype(
                jnp.int32), jnp.asarray(m))
        np.testing.assert_array_equal(to_np(key), np.asarray(jkey))
        np.testing.assert_array_equal(to_np(ok), np.asarray(jok))
        assert not to_np(ok)[0, :2].any() and (np.abs(cells) < 512).mean() > .5
        qx, base = tdp._octant_base(torch.from_numpy(x), torch.from_numpy(m),
                                    cell)
        jqx, jbase = jdp._octant_base(jnp.asarray(x), jnp.asarray(m), cell)
        np.testing.assert_array_equal(to_np(base), np.asarray(jbase))
        np.testing.assert_array_equal(to_np(qx), np.asarray(jqx))
        _, probes, pok = tdp._octant_probes(torch.from_numpy(x),
                                            torch.from_numpy(m), cell)
        _, jprobes, jpok = jdp._octant_probes(jnp.asarray(x), jnp.asarray(m),
                                              cell)
        np.testing.assert_array_equal(to_np(probes), np.asarray(jprobes))
        np.testing.assert_array_equal(to_np(pok), np.asarray(jpok))


@pytest.mark.parametrize("cell_cap", [2, 64])
def test_grid_radius_knn_exact(batch, cell_cap):
    """The sorted-hash-grid search with its per-cell truncation: hits and,
    where hit, rows (cell_cap 2 truncates, 64 does not); the radius above
    cell / 2 is clamped."""
    tv_b, _, _, _ = batch
    q, qm = tv_b.xyz[0, 0], tv_b.mask[0, 0]
    t, tm = tv_b.xyz[0, 1] + 0.1, tv_b.mask[0, 1]
    for radius, cell in ((0.45, 1.2), (0.8, 1.0)):
        idx, hit = tdp.grid_radius_knn(q, qm, t, tm, radius, K, cell,
                                       cell_cap)
        jidx, jhit = jdp.grid_radius_knn(
            jnp.asarray(to_np(q)), jnp.asarray(to_np(qm)),
            jnp.asarray(to_np(t)), jnp.asarray(to_np(tm)), radius, K,
            cell=cell, cell_cap=cell_cap)
        np.testing.assert_array_equal(to_np(hit), np.asarray(jhit))
        np.testing.assert_array_equal(to_np(idx)[to_np(hit)],
                                      np.asarray(jidx)[np.asarray(jhit)])
        assert idx.dtype == torch.int32 and to_np(hit).sum() > 100
    bidx, bhit = tdp.radius_knn(q, qm, t, tm, 0.5, K)   # clamped 0.8 = 0.5
    if cell_cap == 64:
        np.testing.assert_array_equal(to_np(hit), to_np(bhit))
    else:
        assert to_np(hit).sum() < to_np(bhit).sum()


def test_batched_grid_radius_knn_exact(batch):
    """S searches through windowed_cell_topk, results unscattered to the
    given query order: against gcl_tpu's kernel in interpret mode (its
    batched_grid_radius_knn has no interpret switch, so the same core is
    driven as it drives it) and against the brute-force search."""
    tv_b, _, transforms, _ = batch
    q = tv_b.xyz[:, 0]
    t = tv_b.xyz[:, 1] @ torch.from_numpy(
        transforms[:, 1, :3, :3]).transpose(1, 2) + torch.from_numpy(
            transforms[:, 1, None, :3, 3])
    qm, tm = tv_b.mask[:, 0], tv_b.mask[:, 1]
    radius, cell = torch.tensor([0.45, 0.7]), 1.2
    idx, hit = tdp.batched_grid_radius_knn(q, qm, t, tm, radius, K, cell)

    @jax.jit
    def ref(q, qm, t, tm, radius):
        r = jnp.minimum(radius, cell * 0.5)
        rows_s, d2_s, qperm = jdp._batched_grid_core(
            q, qm, t, tm, r, K, cell, presorted=False, interpret=True)
        sidx = jnp.broadcast_to(jnp.arange(B, dtype=jnp.int32)[:, None],
                                (B, NV))
        rows = jnp.zeros((B, NV, K), jnp.int32).at[sidx, qperm].set(rows_s)
        d2 = jnp.full((B, NV, K), 1e30, jnp.float32).at[sidx, qperm].set(
            d2_s)
        return jnp.maximum(rows, 0), ((d2 <= (r * r)[:, None, None])
                                      & (rows >= 0) & qm[..., None])

    jidx, jhit = ref(*(jnp.asarray(to_np(a)) for a in (q, qm, t, tm,
                                                         radius)))
    np.testing.assert_array_equal(to_np(hit), np.asarray(jhit))
    np.testing.assert_array_equal(to_np(idx)[to_np(hit)],
                                  np.asarray(jidx)[np.asarray(jhit)])
    for s in range(B):  # radius 0.7 is clamped to cell / 2 = 0.6
        _, bhit = tdp.radius_knn(q[s], qm[s], t[s], tm[s],
                                 min(float(radius[s]), 0.6), K)
        np.testing.assert_array_equal(to_np(hit[s]).sum(-1),
                                      to_np(bhit).sum(-1))


def test_batch_colocation_groups_on_the_grid_exact(batch):
    """cell set: every ColocationGroups field against gcl_tpu's Pallas
    route in interpret mode, slot order (the home-cell sort of the centre
    voxels) included. Per-sample radii, 0.7 above cell / 2 = 0.6 (the
    clamp). No tolerance: the fields are integers, masks and copied floats;
    d2 itself (one quantum apart where XLA's CPU build contracts an FMA,
    see test_torch_radius_topk.py) only enters as d2 <= r^2, which every
    dequantized distance passes."""
    tv_b, jv_b, transforms, _ = batch
    radius = np.array([0.45, 0.7], np.float32)
    g = tdp.batch_colocation_groups(tv_b, torch.from_numpy(transforms),
                                    torch.from_numpy(radius), k=K, cell=1.2)
    ref = jax.jit(lambda v, t, r: jdp.batch_colocation_groups(
        v, t, r, k=K, cell=1.2, _interpret=True))(
            jv_b, jnp.asarray(transforms), jnp.asarray(radius))
    _assert_groups_equal(g, ref)
    assert int(to_np(g.valid).sum()) > 100
    # the slots are permuted: anchors are not in row order, and the set of
    # groups is the brute-force one at the clamped radii
    brute = tdp.batch_colocation_groups(
        tv_b, torch.from_numpy(transforms),
        torch.from_numpy(np.minimum(radius, 0.6)), k=K)
    assert not np.array_equal(to_np(g.anchor_xyz), to_np(brute.anchor_xyz))

    def group_set(gr):
        mi, mm = to_np(gr.member_idx), to_np(gr.member_mask)
        return {(tuple(a), int(i)): frozenset(mi[s][mm[s]].tolist())
                for s, (a, i) in enumerate(zip(to_np(gr.anchor_xyz),
                                               to_np(gr.anchor_item)))
                if to_np(gr.valid)[s]}

    assert group_set(g) == group_set(brute)


def test_build_colocation_groups_with_cell_cap_exact(batch):
    """One sample through grid_radius_knn (the route with cell_cap)."""
    tv_b, jv_b, transforms, _ = batch
    vox = tdp.VoxelizedClouds(tv_b.coords[1], tv_b.mask[1], tv_b.xyz[1])
    jvox = jax.tree_util.tree_map(lambda x: x[1], jv_b)
    for cell_cap in (2, 8):
        g = tdp.build_colocation_groups(vox, torch.from_numpy(transforms[1]),
                                        0.5, k=K, cell=1.2, cell_cap=cell_cap)
        ref = jdp.build_colocation_groups(jvox, jnp.asarray(transforms[1]),
                                          0.5, k=K, cell=1.2,
                                          cell_cap=cell_cap)
        _assert_groups_equal(g, ref)
        assert int(to_np(g.valid).sum()) > 50
