"""The port's reverse-direction maps (ConvMap.rqkey), which the backward
kernel K7 walks: exact against gcl_tpu's reverse twins, and the voxel
duality kmap[k, i] == j  <=>  rev[K-1-k, j] == i on the port's own maps.
All integers, all exact.
"""
import numpy as np
import torch

from gcl_tpu_torch.core.coords import lookup
from gcl_tpu_torch.core.kernel_maps import (ConvSpec, build_graph,
                                            default_level_caps)
from gcl_tpu_torch.core.types import INVALID_BATCH, map_key
from gcl_tpu_torch.data.device_pipeline import voxelize_per_cloud

from _torch_parity import (VOXEL, clouds, fatbn_specs, jax_graph,
                           strides_of, to_np)


def _flat(seed, n_clouds, nv, n_points=700):
    pts, pmask = clouds(seed, n_clouds, n_points)
    vox = voxelize_per_cloud(torch.from_numpy(pts), torch.from_numpy(pmask),
                             VOXEL, nv)
    return vox.flatten()


def _resolved(g, sp):
    """(forward rows [K, N_out] into the input level, reverse rows
    [K, N_in] into the output level) of one geometry, -1 for none."""
    cmap = g.maps[sp.key]
    lv_in, lv_out = g.levels[sp.in_stride], g.levels[sp.out_stride]
    return (to_np(lookup(lv_in.skeys, lv_in.srow, cmap.qkey)),
            to_np(lookup(lv_out.skeys, lv_out.srow, cmap.rqkey)))


def _check_duality(g, specs):
    n_pairs = 0
    for sp in specs:
        if sp.is_identity_map:
            continue
        fwd, rev = _resolved(g, sp)
        kvol = fwd.shape[0]
        k, i = np.nonzero(fwd >= 0)
        j = fwd[k, i]
        np.testing.assert_array_equal(rev[kvol - 1 - k, j], i)
        kp, jr = np.nonzero(rev >= 0)
        np.testing.assert_array_equal(fwd[kvol - 1 - kp, rev[kp, jr]], jr)
        assert len(k) == len(kp) > 0
        n_pairs += len(k)
    return n_pairs


def test_reverse_maps_fatbn_exact():
    """Every ResUNetFatBN geometry: the port's reverse rows equal gcl_tpu's
    sort-join map of the twin geometry; twins share one tensor."""
    specs = fatbn_specs()
    nv = 512
    flat = _flat(2, 2, nv)
    caps = default_level_caps(nv, strides_of(specs), 0.7)
    g = build_graph(flat.coords, flat.mask, specs, caps, 2)
    gj = jax_graph(to_np(flat.coords), to_np(flat.mask), specs, caps, 2)
    seen = set()
    for sp in specs:
        if sp.is_identity_map or sp.key in seen:
            continue
        seen.add(sp.key)
        rk = map_key(sp.out_stride, sp.in_stride, sp.kernel_size,
                     sp.dilation)
        _, rev = _resolved(g, sp)
        ref = np.asarray(gj.kmaps[rk])
        assert rev.shape == ref.shape
        np.testing.assert_array_equal(rev, ref)
        assert (rev >= 0).any()
        assert g.maps[sp.key].rqkey is g.maps[rk].qkey  # built once
    assert len(seen) == 11  # conv1 + 4 same-level + 3 down + 3 up
    _check_duality(g, specs)


def test_duality_with_negative_keys():
    """18 clouds: cloud ids >= 16 give negative packed keys."""
    specs = [ConvSpec("block1", 1, 1, 3), ConvSpec("conv2", 1, 2, 3),
             ConvSpec("block2", 2, 2, 3), ConvSpec("conv2_tr", 2, 1, 3)]
    nv = 96
    flat = _flat(3, 18, nv, n_points=150)
    g = build_graph(flat.coords, flat.mask, specs, {2: nv * 4}, 18)
    assert (to_np(g.levels[1].skeys) < 0).any()
    _check_duality(g, specs)


def test_duality_at_upmap_scale():
    """A few thousand voxels in one cloud, the scale of
    tests/test_core.py::test_upmap_window_soundness. Most reverse queries
    of a strided conv are off the coarse lattice and must match nothing."""
    rng = np.random.RandomState(0)
    xyz = np.unique(np.concatenate(
        [rng.randint(-30, 30, size=(4000, 2)),
         rng.randint(-16, 16, size=(4000, 1))], axis=1), axis=0)
    xyz = xyz[np.lexsort((xyz[:, 2], xyz[:, 1], xyz[:, 0]))]
    n = len(xyz)
    cap = -(-n // 256) * 256 + 256
    coords = np.full((cap, 4), -1, np.int32)
    coords[:, 0] = INVALID_BATCH
    coords[:n, 0] = 0
    coords[:n, 1:] = xyz
    mask = np.arange(cap) < n
    specs = [ConvSpec("d", 1, 2, 3), ConvSpec("u", 2, 1, 3),
             ConvSpec("s", 2, 2, 3), ConvSpec("c1", 1, 1, 5)]
    g = build_graph(torch.from_numpy(coords), torch.from_numpy(mask), specs,
                    {2: cap}, 1)
    assert _check_duality(g, specs) > 10000
    _, rev = _resolved(g, specs[0])  # s1 rows querying the s2 lattice
    odd = (xyz % 2 != 0).any(axis=1)
    # an s1 voxel with an odd coordinate has no s2 voxel at offset 0
    assert (rev[13, :n][odd] == -1).all() and (rev[13, :n][~odd] >= 0).all()


def test_even_kernel_has_no_reverse_twin():
    """An even kernel has no twin, so inside an implicit graph it gets an
    index table and no implicit map (gcl_tpu's per-spec fallback); the odd
    geometry beside it stays implicit."""
    flat = _flat(4, 1, 128)
    g = build_graph(flat.coords, flat.mask,
                    [ConvSpec("e", 1, 2, 2), ConvSpec("b", 1, 1, 3)],
                    {2: 128}, 1)
    assert list(g.kmaps) == ["s1->s2/k2d1"]
    assert list(g.maps) == ["s1->s1/k3d1"]
    assert g.kmaps["s1->s2/k2d1"].shape == (8, g.levels[2].coords.shape[0])
    assert (g.kmaps["s1->s2/k2d1"] >= 0).any()
