"""Parity of gcl_tpu_torch.core (keys, voxelizer, levels, conv maps) with
gcl_tpu. Everything here is integer or a gathered copy, so every
comparison is EXACT."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcl_tpu.core import coords as jc
from gcl_tpu.core import kernel_maps as jkm
from gcl_tpu.core.types import INVALID_BATCH as J_INVALID
from gcl_tpu.core.voxelize import representative_xyz as j_rep_xyz
from gcl_tpu.core.voxelize import voxelize_points as j_voxelize_points
from gcl_tpu.data.device_pipeline import voxelize_per_cloud as j_vpc
from gcl_tpu_torch.core import coords as tc
from gcl_tpu_torch.core import kernel_maps as tkm
from gcl_tpu_torch.core.kernel_maps import ConvSpec, build_graph
from gcl_tpu_torch.core.types import INVALID_BATCH
from gcl_tpu_torch.core.voxelize import representative_xyz, voxelize_points
from gcl_tpu_torch.data.device_pipeline import voxelize_per_cloud

from _torch_parity import (VOXEL, clouds, fatbn_specs, jax_graph,
                           jax_map_refs, strides_of, to_np)


def _rand_coords(rng, n, n_clouds, stride=1, lim=600):
    c = np.empty((n, 4), np.int32)
    c[:, 0] = rng.randint(0, n_clouds, n)
    c[:, 1:3] = rng.randint(-lim, lim, (n, 2)) // stride * stride
    c[:, 3] = rng.randint(-80, 80, n) // stride * stride
    c[rng.rand(n) < 0.1, 0] = INVALID_BATCH
    return c


def test_invalid_batch_matches():
    assert INVALID_BATCH == int(J_INVALID)
    for k in (1, 3, 5):
        np.testing.assert_array_equal(tc.kernel_offsets(k),
                                      jc.kernel_offsets(k))


@pytest.mark.parametrize("stride", [1, 2, 4, 8])
def test_keys_exact(stride):
    """coord_keys / pack_keys / pack_query_keys, 20 clouds: packed keys of
    clouds >= 16 are negative int32, and coords outside the key window or
    off the lattice take the pad spaces."""
    rng = np.random.RandomState(stride)
    c = _rand_coords(rng, 3000, 20, stride)
    ct, cj = torch.from_numpy(c), jnp.asarray(c)
    for a, b in zip(tc.coord_keys(ct, stride), jc.coord_keys(cj, stride)):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))
    pk = to_np(tc.pack_keys(ct, stride))
    np.testing.assert_array_equal(pk, np.asarray(jc.pack_keys(cj, stride)))
    assert (pk < 0).any()
    offs = tc.kernel_offsets(3) * max(1, stride // 2)
    q = to_np(tc.pack_query_keys(ct, torch.from_numpy(offs), stride))
    for k, o in enumerate(offs):
        np.testing.assert_array_equal(
            q[k], np.asarray(jc.pack_query_keys(cj, jnp.asarray(o), stride)))


def test_voxelize_per_cloud_exact():
    pts, pmask = clouds(0, n_clouds=3)
    pts[1, :5] = [[0.3 * 7, -0.3 * 2, 0.9]] * 5  # points on voxel faces
    for nv in (256, 1024):  # truncating and padded capacities
        t = voxelize_per_cloud(torch.from_numpy(pts),
                               torch.from_numpy(pmask), VOXEL, nv)
        j = j_vpc(jnp.asarray(pts), jnp.asarray(pmask), VOXEL, nv)
        np.testing.assert_array_equal(to_np(t.coords), np.asarray(j.coords))
        np.testing.assert_array_equal(to_np(t.mask), np.asarray(j.mask))
        np.testing.assert_array_equal(to_np(t.xyz), np.asarray(j.xyz))


def test_voxelize_points_multi_cloud_exact():
    pts, pmask = clouds(1, n_clouds=3, n_points=400)
    pts[2] += [200.0, 0.0, 0.0]  # recentred per cloud, not dropped
    bt, rt = voxelize_points(torch.from_numpy(pts), torch.from_numpy(pmask),
                             VOXEL, 900)
    bj, rj = j_voxelize_points(jnp.asarray(pts), jnp.asarray(pmask), VOXEL,
                               900)
    np.testing.assert_array_equal(to_np(bt.coords), np.asarray(bj.coords))
    np.testing.assert_array_equal(to_np(bt.mask), np.asarray(bj.mask))
    np.testing.assert_array_equal(to_np(rt), np.asarray(rj))
    np.testing.assert_array_equal(
        to_np(representative_xyz(torch.from_numpy(pts), rt, bt.mask)),
        np.asarray(j_rep_xyz(jnp.asarray(pts), rj, bj.mask)))


def _voxelized(seed, n_clouds, nv, n_points=700):
    pts, pmask = clouds(seed, n_clouds, n_points)
    vox = voxelize_per_cloud(torch.from_numpy(pts), torch.from_numpy(pmask),
                             VOXEL, nv)
    flat = vox.flatten()
    return to_np(flat.coords), to_np(flat.mask)


def _check_graph(coords, mask, specs, caps, n_clouds):
    """Levels and every forward map of the port equal gcl_tpu's: level
    coords / masks row for row, query keys as _build_fused_maps packs
    them, and the resolved rows against _build_kmap and the sort-join
    maps."""
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
        rows = to_np(tc.lookup(lv.skeys, lv.srow, cmap.qkey))
        np.testing.assert_array_equal(rows, ref)
        np.testing.assert_array_equal(rows, np.asarray(gj.kmaps[sp.key]))
    return g, gj


def test_graph_fatbn_exact():
    specs = fatbn_specs()
    nv = 512
    coords, mask = _voxelized(2, 2, nv)
    caps = jkm.default_level_caps(nv, strides_of(specs), 0.7)
    g, gj = _check_graph(coords, mask, specs, caps, 2)
    aux = to_np(g.maps["s1->s1/k5d1"].c1z)
    np.testing.assert_array_equal(aux, np.asarray(jkm._c1z_aux(
        gj.levels[1])))
    assert g.maps["s1->s1/k3d1"].c1z is not None
    assert g.maps["s2->s1/k3d1"].c1z is None


def test_graph_17_plus_clouds_exact():
    """18 clouds: cloud ids >= 16 give negative packed keys, so the
    signed sort and search must agree with gcl_tpu's maps (same-level,
    strided and transposed geometries)."""
    specs = [ConvSpec("block1", 1, 1, 3), ConvSpec("conv2", 1, 2, 3),
             ConvSpec("block2", 2, 2, 3), ConvSpec("conv2_tr", 2, 1, 3)]
    nv = 96
    coords, mask = _voxelized(3, 18, nv, n_points=150)
    caps = {2: nv * 4}
    g, _ = _check_graph(coords, mask, specs, caps, 18)
    assert (to_np(g.levels[1].skeys) < 0).any()


def test_graph_upmap_scale_exact():
    """A few thousand voxels in one cloud, the scale at which gcl_tpu's
    unsound up-map window bounds showed (test_core.py::
    test_upmap_window_soundness): down and up maps, exact rows."""
    rng = np.random.RandomState(0)
    pts = rng.randint(-30, 30, size=(4000, 2))
    z = rng.randint(-16, 16, size=(4000, 1))
    xyz = np.unique(np.concatenate([pts, z], axis=1), axis=0)
    xyz = xyz[np.lexsort((xyz[:, 2], xyz[:, 1], xyz[:, 0]))]
    n = len(xyz)
    cap = -(-n // 256) * 256 + 256
    coords = np.full((cap, 4), -1, np.int32)
    coords[:, 0] = INVALID_BATCH
    coords[:n, 0] = 0
    coords[:n, 1:] = xyz
    mask = np.zeros(cap, bool)
    mask[:n] = True
    specs = [ConvSpec("d", 1, 2, 3), ConvSpec("u", 2, 1, 3),
             ConvSpec("s", 2, 2, 3)]
    _check_graph(coords, mask, specs, {1: cap, 2: cap}, 1)


def test_more_than_31_clouds_raises():
    """(Kept under its first name.) Above 31 clouds the implicit route
    raises, since its packed keys fold cloud ids mod 31; 'auto' builds
    index tables over unblocked levels instead."""
    coords, mask = _voxelized(4, 2, 64)
    args = (torch.from_numpy(coords), torch.from_numpy(mask), fatbn_specs(),
            {2: 64, 4: 64, 8: 64})
    with pytest.raises(ValueError, match="31"):
        build_graph(*args, n_clouds=32, method="implicit")
    with pytest.raises(ValueError, match="method"):
        build_graph(*args, n_clouds=2, method="sortjoin")
    g = build_graph(*args, n_clouds=32)
    assert not g.maps and len(g.kmaps) == 11
    assert g.levels[2].coords.shape[0] == 64 and g.levels[1].skeys is None


def test_fold_clouds_exact():
    rng = np.random.RandomState(5)
    c = _rand_coords(rng, 500, 40)
    np.testing.assert_array_equal(
        to_np(tkm._fold_clouds(torch.from_numpy(c))),
        np.asarray(jkm._fold_clouds(jnp.asarray(c))))
