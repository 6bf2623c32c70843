"""Colocation groups of the port (brute-force radius_knn ->
batch_colocation_groups with cell=None) against gcl_tpu, on the same
clouds, transforms and per-sample radii. Everything compared is an integer
or a mask, or a float copied from the inputs: exact.
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
    for name in ("member_idx", "member_mask", "finest_pos", "valid",
                 "anchor_xyz", "anchor_item"):
        got, want = to_np(getattr(g, name)), np.asarray(getattr(ref, name))
        assert got.shape == want.shape, name
        if name == "member_idx":  # rows are meaningful where they hit
            got = np.where(to_np(g.member_mask), got, -1)
            want = np.where(np.asarray(ref.member_mask), want, -1)
        np.testing.assert_array_equal(got, want, err_msg=name)
    n_valid = int(to_np(g.valid).sum())
    assert n_valid > 100
    fin = to_np(g.finest_pos)[to_np(g.valid)]
    assert (fin == 0).any() and (fin > 0).any()  # both finest outcomes
    assert (to_np(g.member_idx)[B * NV // 2:].max() >= C * NV)  # sample 1


def test_grid_search_is_not_ported(batch):
    tv_b, _, transforms, radius = batch
    with pytest.raises(NotImplementedError, match="K1"):
        tdp.batch_colocation_groups(tv_b, torch.from_numpy(transforms),
                                    torch.from_numpy(radius), k=K,
                                    cell=1.6)
