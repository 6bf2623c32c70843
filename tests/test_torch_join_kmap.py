"""The port's explicit kernel maps (two-word query keys joined by K10's
plain version on the CPU) against gcl_tpu's own: _build_kmap (binary
search, the reference) and _build_kmap_pallas in interpret mode (the
Pallas merge-join K10 replaces). All integers, all exact.

gcl_tpu's build_graph(method="auto") is no reference above 31 clouds off a
TPU: it picks the sort-join there, whose packed keys give every cloud with
id >= 31 a never-matching key (test_auto_off_tpu_drops_clouds_from_31
pins that fault). So above 31 clouds the port is held to
method="bsearch".

One stated departure, on the faces of the +-512 key window: gcl_tpu's
two-word keys clamp, so its query one step outside the window finds the
face voxel itself; the port's carries the sentinel, as its implicit maps
and gcl_tpu's sort-join maps do (test_window_faces).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcl_tpu.core import kernel_maps as jkm
from gcl_tpu_torch.core import kernel_maps as tkm
from gcl_tpu_torch.core.coords import kernel_offsets, lookup
from gcl_tpu_torch.core.kernel_maps import ConvSpec, build_graph
from gcl_tpu_torch.core.types import INVALID_BATCH, LevelCoords
from gcl_tpu_torch.data.device_pipeline import voxelize_per_cloud
from gcl_tpu_torch.kernels import join_kmap, join_kmap_plain

from _torch_parity import (VOXEL, clouds, fatbn_specs, jax_graph, jax_specs,
                           strides_of, to_np)


def _random_batch(seed, n=300, cap=512, span=12, n_clouds=3):
    """tests/test_core.py's random batch: unique (cloud, x, y, z) rows in
    lexicographic order (which is cloud-blocked and key-sorted), pads at
    the tail."""
    rng = np.random.RandomState(seed)
    coords = np.unique(np.concatenate(
        [rng.randint(0, n_clouds, size=(n, 1)),
         rng.randint(-span, span, size=(n, 3))], 1), axis=0)
    n = len(coords)
    pad = np.full((cap - n, 4), -1, np.int32)
    pad[:, 0] = INVALID_BATCH
    return np.concatenate([coords.astype(np.int32), pad]), np.arange(cap) < n


def _port_levels(coords, mask, cap):
    """Levels 1 and 2 in the unblocked layout with their two-word index."""
    l1 = LevelCoords(torch.from_numpy(coords), torch.from_numpy(mask))
    l2 = tkm._downsample_level(l1.coords, 2, cap, None)
    tkm._two_word_index(l1, 1)
    tkm._two_word_index(l2, 2)
    return {1: l1, 2: l2}


def _assert_levels_equal(lv, ref, keys=True):
    np.testing.assert_array_equal(to_np(lv.coords), np.asarray(ref.coords))
    np.testing.assert_array_equal(to_np(lv.mask), np.asarray(ref.mask))
    if keys:
        np.testing.assert_array_equal(to_np(lv.key_hi),
                                      np.asarray(ref.key_hi))
        np.testing.assert_array_equal(to_np(lv.key_lo),
                                      np.asarray(ref.key_lo))
        nv = int(np.asarray(ref.mask).sum())
        np.testing.assert_array_equal(to_np(lv.perm)[:nv],
                                      np.asarray(ref.perm)[:nv])


# tests/test_core.py::test_pallas_join_matches_bsearch's five cases:
# (out stride, in stride, kernel, offset scale)
CASES = {"self": (1, 1, 3, 1), "down": (2, 1, 3, 1),
         "transpose": (1, 2, 3, 1), "self_s2": (2, 2, 3, 2),
         "k5": (1, 1, 5, 1)}


@pytest.mark.parametrize("case", list(CASES))
def test_join_matches_bsearch_and_pallas_join(case):
    out_s, in_s, k, scale = CASES[case]
    coords, mask = _random_batch(0)
    cap = coords.shape[0]
    lv = _port_levels(coords, mask, cap)
    j1 = jkm._index_level(jnp.asarray(coords), jnp.asarray(mask), 1)
    j2 = jkm._downsample_level(jnp.asarray(coords), jnp.asarray(mask), 2,
                               cap)
    jl = {1: j1, 2: j2}
    # level 1's rows are already in key order, so gcl_tpu's sorted index
    # is the compacted one the port builds
    for s in (1, 2):
        _assert_levels_equal(lv[s], jl[s])
    offs = kernel_offsets(k) * scale
    qhi, qlo = tkm.two_word_query_keys(lv[out_s], in_s, offs)
    got = to_np(join_kmap(lv[in_s].key_hi, lv[in_s].key_lo, lv[in_s].perm,
                          qhi, qlo))
    ref = np.asarray(jkm._build_kmap(jl[out_s], jl[in_s], in_s, offs))
    np.testing.assert_array_equal(got, ref)
    assert (got >= 0).sum() > 100 and got.shape == (k ** 3, cap)
    pal = np.asarray(jkm._build_kmap_pallas(jl[out_s], jl[in_s], in_s, offs,
                                            interpret=True))
    np.testing.assert_array_equal(got, pal)
    # the query keys themselves: gcl_tpu's, bit for bit (off the faces)
    jqh, jql = jkm._query_keys(jl[out_s], in_s, offs)
    np.testing.assert_array_equal(to_np(qhi), np.asarray(jqh))
    np.testing.assert_array_equal(to_np(qlo), np.asarray(jql))


def _voxelized(seed, n_clouds, nv, n_points=150):
    pts, pmask = clouds(seed, n_clouds, n_points)
    vox = voxelize_per_cloud(torch.from_numpy(pts), torch.from_numpy(pmask),
                             VOXEL, nv)
    return vox.flatten()


def _jax_bsearch(coords, mask, specs, caps, n_clouds):
    jspecs = jax_specs(specs)
    return jax.jit(lambda c, m: jkm.build_graph(
        c, m, jspecs, caps, method="bsearch", sorted_blocks=True,
        n_clouds=n_clouds))(jnp.asarray(coords), jnp.asarray(mask))


MIXED = [ConvSpec("conv1", 1, 1, 5), ConvSpec("block1", 1, 1, 3),
         ConvSpec("conv2", 1, 2, 3), ConvSpec("block2", 2, 2, 3),
         ConvSpec("conv2_tr", 2, 1, 3), ConvSpec("even", 1, 2, 2)]


@pytest.fixture(scope="module")
def graphs_36():
    """36 clouds of a few dozen voxels: the unblocked layout on both
    sides."""
    nv, n_clouds = 48, 36
    flat = _voxelized(3, n_clouds, nv)
    caps = {2: nv * n_clouds}
    g = build_graph(flat.coords, flat.mask, MIXED, caps, n_clouds)
    gj = _jax_bsearch(to_np(flat.coords), to_np(flat.mask), MIXED,
                      {1: nv * n_clouds, **caps}, n_clouds)
    return g, gj


def test_36_clouds_levels_unblocked_exact(graphs_36):
    g, gj = graphs_36
    assert not g.maps and g.levels[1].skeys is None
    for s in (1, 2):
        _assert_levels_equal(g.levels[s], gj.levels[s])
    assert int(g.levels[2].mask.sum()) > 300
    assert int(to_np(g.levels[1].coords)[:, 0][to_np(g.levels[1].mask)].max()
               ) == 35


@pytest.mark.parametrize("key", [
    "s1->s1/k5d1", "s1->s1/k3d1", "s1->s2/k3d1", "s2->s2/k3d1",
    "s2->s1/k3d1", "s1->s2/k2d1"])
def test_36_clouds_maps_match_bsearch(graphs_36, key):
    """Every geometry, the even kernel included (which has no twin: five
    odd maps + their twins among themselves + one even = six tables)."""
    g, gj = graphs_36
    assert sorted(g.kmaps) == sorted(gj.kmaps) and len(g.kmaps) == 6
    got, ref = to_np(g.kmaps[key]), np.asarray(gj.kmaps[key])
    np.testing.assert_array_equal(got, ref)
    # clouds 31+ do match (what the sort-join on packed keys loses)
    sp = next(s for s in MIXED if s.key == key)
    cloud = to_np(g.levels[sp.out_stride].coords)[:, 0]
    late = (cloud >= 31) & (cloud < INVALID_BATCH)
    assert late.sum() > 20 and (got[:, late] >= 0).any()


def test_36_clouds_match_pallas_join(graphs_36):
    g, gj = graphs_36
    for sp in (MIXED[2], MIXED[4]):                    # down and transposed
        offs = kernel_offsets(3) * sp.offset_scale
        pal = jkm._build_kmap_pallas(gj.levels[sp.out_stride],
                                     gj.levels[sp.in_stride], sp.in_stride,
                                     offs, interpret=True)
        np.testing.assert_array_equal(to_np(g.kmaps[sp.key]),
                                      np.asarray(pal))


def test_auto_off_tpu_drops_clouds_from_31(graphs_36):
    """A fault of gcl_tpu, pinned and not repaired: off a TPU its
    build_graph(method='auto') takes the sort-join for any cloud count, and
    pack_keys / pack_query_keys give clouds with id >= 31 never-matching
    keys, so their map entries are all -1, without a message. bsearch (and
    the port) match them."""
    g, gj = graphs_36
    jspecs = jax_specs(MIXED[1:2])
    lv = g.levels[1]
    auto = jax.jit(lambda c, m: jkm.build_graph(
        c, m, jspecs, {1: c.shape[0]}, method="auto", sorted_blocks=True,
        n_clouds=36))(jnp.asarray(to_np(lv.coords)),
                      jnp.asarray(to_np(lv.mask)))
    km = np.asarray(auto.kmaps["s1->s1/k3d1"])
    cloud, valid = to_np(lv.coords)[:, 0], to_np(lv.mask)
    early, late = valid & (cloud < 31), valid & (cloud >= 31)
    centre = 13
    assert (km[centre, early] == np.nonzero(early)[0]).all()
    assert (km[:, late] == -1).all()                   # the fault
    ours = to_np(g.kmaps["s1->s1/k3d1"])
    assert (ours[centre, late] == np.nonzero(late)[0]).all()
    np.testing.assert_array_equal(ours[:, early], km[:, early])


def test_explicit_equals_implicit_and_sortjoin_up_to_31_clouds():
    """6 clouds, every ResUNetFatBN geometry, on the blocked levels both
    routes share: the explicit table equals the rows the implicit route's
    keys resolve to, and gcl_tpu's sort-join map (its 'auto' off a TPU)."""
    specs = fatbn_specs()
    nv, n_clouds = 160, 6
    flat = _voxelized(5, n_clouds, nv, n_points=400)
    caps = tkm.default_level_caps(nv * n_clouds, strides_of(specs), 0.7)
    gi = build_graph(flat.coords, flat.mask, specs, caps, n_clouds)
    ge = build_graph(flat.coords, flat.mask, specs, caps, n_clouds,
                     method="explicit")
    gj = jax_graph(to_np(flat.coords), to_np(flat.mask), specs, caps,
                   n_clouds)
    assert not ge.maps and not gi.kmaps and len(ge.kmaps) == 11
    for s, lv in ge.levels.items():
        _assert_levels_equal(lv, gj.levels[s], keys=False)
        assert lv.skeys is None and gi.levels[s].key_hi is None
    for key, kmap in ge.kmaps.items():
        in_s = int(key.split("->")[0][1:])
        lv = gi.levels[in_s]
        rows = lookup(lv.skeys, lv.srow, gi.maps[key].qkey)
        assert torch.equal(kmap, rows) and (kmap >= 0).any()
        np.testing.assert_array_equal(to_np(kmap), np.asarray(gj.kmaps[key]))


def test_window_faces():
    """Voxels on the faces of the key window (x, y = -512 or 511). The
    port's explicit map equals gcl_tpu's sort-join map and the port's own
    implicit map. It departs from gcl_tpu's two-word maps there, and
    only there: those clamp the query, so a step out of the window lands
    on the face voxel itself (kmap[k, i] == i at an offset that is not the
    centre)."""
    xyz = np.array([(x, y, z) for x in (-512, -511, 0, 510, 511)
                    for y in (-512, 0, 511) for z in (-2, 0, 1)], np.int32)
    xyz = xyz[np.lexsort((xyz[:, 2], xyz[:, 1], xyz[:, 0]))]
    n, cap = len(xyz), 64
    coords = np.full((cap, 4), -1, np.int32)
    coords[:, 0] = INVALID_BATCH
    coords[:n, 0] = 0
    coords[:n, 1:] = xyz
    mask = np.arange(cap) < n
    spec = ConvSpec("b", 1, 1, 3)
    args = (torch.from_numpy(coords), torch.from_numpy(mask), [spec], {}, 1)
    ge = build_graph(*args, method="explicit")
    gi = build_graph(*args)
    got = to_np(ge.kmaps[spec.key])
    lv = gi.levels[1]
    np.testing.assert_array_equal(
        got, to_np(lookup(lv.skeys, lv.srow, gi.maps[spec.key].qkey)))
    j1 = jkm._index_level(jnp.asarray(coords), jnp.asarray(mask), 1)
    offs = kernel_offsets(3)
    np.testing.assert_array_equal(
        got, np.asarray(jkm._build_kmap_sortjoin(j1, j1, 1, offs)))
    clamped = np.asarray(jkm._build_kmap(j1, j1, 1, offs))
    k, i = np.nonzero(got != clamped)
    assert len(k) > 0
    assert (got[k, i] == -1).all()
    q = xyz[i] + offs[k]
    assert ((q[:, :2] < -512) | (q[:, :2] > 511)).any(axis=1).all()
    # what gcl_tpu finds there is a voxel on the face: the query clamped
    hit = xyz[clamped[k, i]]
    np.testing.assert_array_equal(hit, np.clip(q, -512, 511))


def test_join_wrapper_checks_and_plain_chunks(monkeypatch):
    """The wrapper refuses what the kernel does not take; the plain
    version gives one answer however its passes are cut; a sentinel query
    never finds the padded tail."""
    import importlib
    # the package re-exports the function under the module's name
    mod = importlib.import_module("gcl_tpu_torch.kernels.join_kmap")
    coords, mask = _random_batch(1)
    lv = _port_levels(coords, mask, coords.shape[0])[1]
    qhi, qlo = tkm.two_word_query_keys(lv, 1, kernel_offsets(3))
    whole = join_kmap_plain(lv.key_hi, lv.key_lo, lv.perm, qhi, qlo)
    monkeypatch.setattr(mod, "_PLAIN_CHUNK", 1000)
    assert torch.equal(whole, join_kmap(lv.key_hi, lv.key_lo, lv.perm, qhi,
                                        qlo))
    assert int(lv.key_hi[-1]) == 0x7FFFFFFF
    assert (whole[:, ~torch.from_numpy(mask)] == -1).all()
    with pytest.raises(TypeError, match="int32"):
        join_kmap(lv.key_hi.long(), lv.key_lo, lv.perm, qhi, qlo)
    with pytest.raises(ValueError, match="one shape"):
        join_kmap(lv.key_hi, lv.key_lo, lv.perm, qhi, qlo[:3])
    with pytest.raises(ValueError, match="one length"):
        join_kmap(lv.key_hi, lv.key_lo[:5], lv.perm, qhi, qlo)
