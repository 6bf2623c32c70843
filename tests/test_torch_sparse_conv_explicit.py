"""The explicit route's conv (sparse_ops.sparse_conv over an index table:
plain K12 forward, K12 through the reverse table + K8 for the gradients,
or the scatter-add without a reverse table) and the two-pass backward of
the implicit route (plain K6 through the reverse map + K8), against
gcl_tpu's sparse_conv with its two VJPs and against its Pallas kernels in
interpret mode.

Tolerance: values, dX and dW within 1e-5 of each tensor's max. Both sides
sum the same float32 products in another order (per-offset matmuls here,
XLA's HIGHEST-precision scan there); 1e-4 against the Pallas kernels, whose
gathers are one-hot products.

The last block closes the TPU kernels that are variants of K6 / K7 / K8
rather than functions of their own: the full-tile window kernels and the
index-table API over them (pallas_conv.py fused_conv_fwd / _dw / _bwd,
pallas_conv_fwd / _dw) and the folded kernels for C in {16, 32, 64}
(_conv_fold_fwd / _bwd). The port has one kernel per function, so it is
run on the geometries those variants exist for -- tests/test_core.py's
stacked-offset, multi-chunk, split-window and folded-width cases and its
explicit tables -- on both routes and both backwards.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcl_tpu.core.sparse_ops import sparse_conv as j_sparse_conv
from gcl_tpu_torch import kernels
from gcl_tpu_torch.core import sparse_ops
from gcl_tpu_torch.core.kernel_maps import ConvSpec, build_graph
from gcl_tpu_torch.core.types import INVALID_BATCH, map_key
from gcl_tpu_torch.data.device_pipeline import voxelize_per_cloud

from _torch_parity import VOXEL, assert_close_to_max, clouds, to_np

SPECS = [ConvSpec("conv1", 1, 1, 5), ConvSpec("block1", 1, 1, 3),
         ConvSpec("conv2", 1, 2, 3), ConvSpec("block2", 2, 2, 3),
         ConvSpec("conv2_tr", 2, 1, 3), ConvSpec("even", 1, 2, 2)]
REL = 1e-5


@jax.jit
def _j_conv_vjp(x, w, kmap, rev, g):
    out, vjp = jax.vjp(lambda x, w: j_sparse_conv(x, w, kmap, rev), x, w)
    return (out,) + vjp(g)


@jax.jit
def _j_conv_vjp_scatter(x, w, kmap, g):
    out, vjp = jax.vjp(lambda x, w: j_sparse_conv(x, w, kmap), x, w)
    return (out,) + vjp(g)


def _rev_key(sp):
    return map_key(sp.out_stride, sp.in_stride, sp.kernel_size, sp.dilation)


def _graph_pair(coords, mask, specs, caps, n_clouds):
    """The same geometry on both routes (blocked levels, shared rows)."""
    args = (torch.from_numpy(coords), torch.from_numpy(mask), specs, caps,
            n_clouds)
    return build_graph(*args), build_graph(*args, method="explicit")


@pytest.fixture(scope="module")
def graphs():
    pts, pmask = clouds(7, 2, 700)
    vox = voxelize_per_cloud(torch.from_numpy(pts), torch.from_numpy(pmask),
                             VOXEL, 512)
    flat = vox.flatten()
    return _graph_pair(to_np(flat.coords), to_np(flat.mask), SPECS, {2: 384},
                       2)


def _inputs(g, sp, cin, cout, seed):
    rng = np.random.RandomState(seed)
    lv_in, lv_out = g.levels[sp.in_stride], g.levels[sp.out_stride]
    x = rng.randn(lv_in.coords.shape[0], cin).astype(np.float32)
    x *= to_np(lv_in.mask)[:, None]
    w = (rng.randn(sp.kernel_size ** 3, cin, cout) * 0.05).astype(np.float32)
    up = rng.randn(lv_out.coords.shape[0], cout).astype(np.float32)
    return x, w, up


def _run(fn, x, w, up, needs_dx=True):
    """(out, dX, dW) of fn(x, w) under a non-contiguous upstream gradient,
    as autograd often hands one over."""
    xt = torch.from_numpy(x).requires_grad_(needs_dx)
    wt = torch.from_numpy(w).requires_grad_()
    out = fn(xt, wt)
    out.backward(torch.from_numpy(np.ascontiguousarray(up.T)).T)
    return out.detach(), xt.grad, wt.grad


def _assert_triples_close(got, ref, rel, what):
    for name, a, b in zip(("out", "dX", "dW"), got, ref):
        assert_close_to_max(to_np(a) if isinstance(a, torch.Tensor)
                            else np.asarray(a), np.asarray(
                                to_np(b) if isinstance(b, torch.Tensor)
                                else b), rel, f"{what} {name}")


@pytest.mark.parametrize("key,cin,cout", [
    ("s1->s1/k3d1", 32, 32),    # same level
    ("s1->s2/k3d1", 32, 64),    # strided
    ("s2->s1/k3d1", 192, 128),  # transposed, Cin after a skip concat
    ("s1->s1/k5d1", 1, 32),     # conv1 reading its features, Cin == 1
])
@pytest.mark.parametrize("with_rev", [True, False])
def test_sparse_conv_matches_jax(graphs, key, cin, cout, with_rev):
    """sparse_conv(x, w, kmap, rev_kmap) and sparse_conv(x, w, kmap):
    values and both gradients against gcl_tpu's, which takes the
    reverse-map VJP with rev_kmap and the scatter-add VJP without."""
    _, ge = graphs
    sp = next(s for s in SPECS if s.key == key)
    x, w, up = _inputs(ge, sp, cin, cout, cin + cout)
    kmap = ge.kmaps[key]
    rev = ge.kmaps[_rev_key(sp)] if with_rev else None
    got = _run(lambda x, w: sparse_ops.sparse_conv(x, w, kmap, rev), x, w, up)
    jk, jup = jnp.asarray(to_np(kmap)), jnp.asarray(up)
    if with_rev:
        ref = _j_conv_vjp(jnp.asarray(x), jnp.asarray(w), jk,
                          jnp.asarray(to_np(rev)), jup)
    else:
        ref = _j_conv_vjp_scatter(jnp.asarray(x), jnp.asarray(w), jk, jup)
    _assert_triples_close(got, ref, REL, key)
    assert float(got[1].abs().max()) > 0


def test_even_kernel_conv_takes_the_scatter_backward(graphs, monkeypatch):
    """An even kernel inside an implicit graph: the model's dispatch finds
    it in graph.kmaps with no twin, and its backward launches neither K8
    nor a second K12."""
    from gcl_tpu_torch.models.common import SparseConv
    gi, _ = graphs
    sp = SPECS[-1]
    assert sp.key in gi.kmaps and sp.key not in gi.maps
    x, w, up = _inputs(gi, sp, 8, 12, 3)
    conv = SparseConv(8, 12, sp)
    with torch.no_grad():
        conv.kernel.copy_(torch.from_numpy(w))
    calls = []
    for name in ("sparse_conv_dw", "sparse_conv_table_fwd"):
        real = getattr(sparse_ops, name)
        monkeypatch.setattr(sparse_ops, name, lambda *a, _r=real, _n=name:
                            calls.append(_n) or _r(*a))
    xt = torch.from_numpy(x).requires_grad_()
    out = conv(xt, gi)
    out.backward(torch.from_numpy(up))
    assert calls == ["sparse_conv_table_fwd"]
    ref = _j_conv_vjp_scatter(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(to_np(gi.kmaps[sp.key])),
                              jnp.asarray(up))
    _assert_triples_close((out.detach(), xt.grad, conv.kernel.grad), ref, REL,
                          "even")


def test_sparse_conv_skips_dx_nobody_asked_for(graphs, monkeypatch):
    _, ge = graphs
    key = "s1->s1/k3d1"
    calls = []
    real = sparse_ops.sparse_conv_table_fwd
    monkeypatch.setattr(sparse_ops, "sparse_conv_table_fwd",
                        lambda *a: calls.append(1) or real(*a))
    n = ge.levels[1].coords.shape[0]
    w = torch.randn(27, 4, 4, requires_grad=True)
    for needs in (False, True):
        x = torch.randn(n, 4, requires_grad=needs)
        sparse_ops.sparse_conv(x, w, ge.kmaps[key],
                               ge.kmaps[key]).sum().backward()
        assert (x.grad is not None) == needs
    assert len(calls) == 3  # forward, forward, one dX


@pytest.mark.parametrize("key,cin,cout", [
    ("s1->s1/k3d1", 32, 32), ("s1->s2/k3d1", 32, 64),
    ("s2->s1/k3d1", 192, 128)])
def test_two_pass_backward_matches_one_pass_and_jax(graphs, key, cin, cout):
    """SparseConvImplicit with two_pass_backward: dX by K6 through the
    reverse map, dW by K8 over the forward map, against the one-pass
    backward (K7) and gcl_tpu's reverse-map VJP."""
    gi, ge = graphs
    sp = next(s for s in SPECS if s.key == key)
    x, w, up = _inputs(gi, sp, cin, cout, cin * cout)
    lv_in, lv_out = gi.levels[sp.in_stride], gi.levels[sp.out_stride]

    def conv(two_pass):
        return lambda x, w: sparse_ops.sparse_conv_implicit(
            x, w, gi.maps[key], lv_in, lv_out, two_pass_backward=two_pass)

    one, two = _run(conv(False), x, w, up), _run(conv(True), x, w, up)
    assert torch.equal(one[0], two[0])
    _assert_triples_close(two, one, REL, f"{key} two-pass vs one-pass")
    ref = _j_conv_vjp(jnp.asarray(x), jnp.asarray(w),
                      jnp.asarray(to_np(ge.kmaps[key])),
                      jnp.asarray(to_np(ge.kmaps[_rev_key(sp)])),
                      jnp.asarray(up))
    _assert_triples_close(two, ref, REL, f"{key} two-pass vs gcl_tpu")
    # dW alone, when the input asks for no gradient
    _, dx, dw = _run(conv(True), x, w, up, needs_dx=False)
    assert dx is None and torch.equal(dw, two[2])


def test_two_pass_backward_matches_pallas_kernels():
    """The port's plain K6-through-the-reverse-map and K8 against gcl_tpu's
    Pallas kernels themselves in interpret mode: fused_conv_fwd through the
    reverse map with flipped transposed weights (dX), fused_conv_dw (the
    kernel K8 replaces) and pallas_conv_dw (its index-table API) for dW."""
    from gcl_tpu.core.pallas_conv import (fused_conv_dw, fused_conv_fwd,
                                          pallas_conv_dw)
    from gcl_tpu.testing import kernel_interpret
    from _torch_parity import jax_graph

    pts, pmask = clouds(8, 1, 300)
    vox = voxelize_per_cloud(torch.from_numpy(pts), torch.from_numpy(pmask),
                             VOXEL, 256)
    flat = vox.flatten()
    specs = [ConvSpec("b", 1, 1, 3)]
    key = "s1->s1/k3d1"
    gi, ge = _graph_pair(to_np(flat.coords), to_np(flat.mask), specs, {}, 1)
    lv, cmap = gi.levels[1], gi.maps[key]
    rng = np.random.RandomState(2)
    x = rng.randn(256, 8).astype(np.float32) * to_np(lv.mask)[:, None]
    w = (rng.randn(27, 8, 16) * 0.1).astype(np.float32)
    up = rng.randn(256, 16).astype(np.float32)
    with kernel_interpret():
        gj = jax_graph(to_np(flat.coords), to_np(flat.mask), specs, {}, 1)
        fm = gj.fused[key]
        geo = dict(win=fm.win, rows=fm.rows, hstarts=fm.hstarts,
                   hnch=fm.hnch, hwin=fm.hwin, interpret=True)
        rdx = fused_conv_fwd(jnp.asarray(up),
                             jnp.swapaxes(jnp.asarray(w)[::-1], 1, 2),
                             fm.qkey, fm.starts, fm.nch, fm.tkeys, **geo)
        rdw = fused_conv_dw(jnp.asarray(x), jnp.asarray(up), fm.qkey,
                            fm.starts, fm.nch, fm.tkeys, **geo)
        kmap = to_np(ge.kmaps[key])
        tdw = pallas_conv_dw(jnp.asarray(x), jnp.asarray(up),
                             jnp.asarray(np.where(kmap < 0, 256, kmap)),
                             interpret=True)
    _, dx, dw = _run(lambda x, w: sparse_ops.sparse_conv_implicit(
        x, w, cmap, lv, lv, two_pass_backward=True), x, w, up)
    assert_close_to_max(to_np(dx), np.asarray(rdx), 1e-4, "dX")
    assert_close_to_max(to_np(dw), np.asarray(rdw), 1e-4, "dW")
    tab = kernels.sparse_conv_dw(torch.from_numpy(x), torch.from_numpy(up),
                                 ge.kmaps[key])
    assert_close_to_max(to_np(tab), np.asarray(tdw), 1e-4, "table dW")
    assert_close_to_max(to_np(tab), to_np(dw), REL, "table dW vs implicit")


# --- closing K12 and K13: the variants' geometries of tests/test_core.py ---

def _padded(rows, cap):
    coords = np.full((cap, 4), -1, np.int32)
    coords[:, 0] = INVALID_BATCH
    coords[:len(rows)] = rows
    return coords, np.arange(cap) < len(rows)


def _sparse_two_clouds(rng):
    """TestFusedGraph._coords: 60 random voxels of two clouds."""
    raw = np.concatenate([rng.randint(0, 2, (60, 1)),
                          rng.randint(-6, 7, (60, 3))], axis=1)
    return _padded(np.unique(raw, axis=0), 96) + (2,)


def _full_z_columns(rng):
    """test_fused_multichunk_windows: full z-columns of the packed-key z
    range, spans wider than one of the TPU's window chunks."""
    rows = np.array([(0, x, y, z - 32) for x in range(2) for y in range(14)
                     for z in range(64)], np.int32)
    return _padded(rows, len(rows) + 128) + (1,)


def _dense_block(rng):
    """test_fused_split_windows: a dense block at 35% occupancy."""
    raw = np.stack(np.meshgrid(np.arange(-4, 5), np.arange(-12, 13),
                               np.arange(-16, 17),
                               indexing="ij")).reshape(3, -1).T
    sel = raw[rng.rand(len(raw)) < 0.35]
    rows = np.unique(np.concatenate(
        [np.zeros((len(sel), 1), np.int64), sel], axis=1), axis=0)
    return _padded(rows.astype(np.int32), len(rows) + 128) + (1,)


VARIANT_CASES = {
    # name: (geometry, in stride, out stride, Cin, Cout)
    "stacked_same_level": (_sparse_two_clouds, 1, 1, 32, 32),
    "stacked_strided": (_sparse_two_clouds, 1, 2, 32, 32),
    "multichunk": (_full_z_columns, 1, 1, 4, 6),
    "multichunk_folded": (_full_z_columns, 1, 1, 32, 32),
    "split_windows": (_dense_block, 1, 1, 32, 32),
    "fold_32": (_sparse_two_clouds, 1, 1, 32, 32),
    "fold_64": (_sparse_two_clouds, 1, 1, 64, 64),
    "fold_32_64_strided": (_sparse_two_clouds, 1, 2, 32, 64),
    "fold_64_32_transposed": (_sparse_two_clouds, 2, 1, 64, 32),
    "fold_16": (_sparse_two_clouds, 1, 1, 16, 16),
}


@pytest.mark.parametrize("case", list(VARIANT_CASES))
def test_variant_geometries_match_jax(case):
    """One geometry of a K12 / K13 variant: the implicit route (one pass
    and two passes) and the explicit route against gcl_tpu's explicit-map
    reference (method='bsearch', sparse_conv with its reverse map), as
    tests/test_core.py::TestFusedGraph._check holds the TPU variants."""
    from gcl_tpu.core.kernel_maps import ConvSpec as JSpec
    from gcl_tpu.core.kernel_maps import build_graph as j_build_graph

    geometry, in_s, out_s, cin, cout = VARIANT_CASES[case]
    rng = np.random.RandomState(len(case))
    coords, mask, n_clouds = geometry(rng)
    cap = coords.shape[0]
    sp = ConvSpec("c", in_s, out_s, 3)
    gi, ge = _graph_pair(coords, mask, [sp], {2: cap}, n_clouds)
    # gcl_tpu's reference sits on unblocked levels: its level 2 holds the
    # same voxels in the same order, without the port's block slack, so
    # rows are compared through each side's own valid rows
    gj = jax.jit(lambda c, m: j_build_graph(
        c, m, [JSpec("c", in_s, out_s, 3)], {1: cap, 2: cap},
        method="bsearch"))(jnp.asarray(coords), jnp.asarray(mask))
    sel = {s: (to_np(ge.levels[s].mask), np.asarray(gj.levels[s].mask))
           for s in {in_s, out_s}}
    for s, (mine, theirs) in sel.items():
        np.testing.assert_array_equal(
            to_np(ge.levels[s].coords)[mine],
            np.asarray(gj.levels[s].coords)[theirs])

    def spread(vals, s, n):
        """Values on the port's valid rows moved to gcl_tpu's rows."""
        out = np.zeros((n,) + vals.shape[1:], vals.dtype)
        out[sel[s][1]] = vals[sel[s][0]]
        return out

    x, w, up = _inputs(ge, sp, cin, cout, 1)
    up *= to_np(ge.levels[out_s].mask)[:, None]
    ref = _j_conv_vjp(
        jnp.asarray(spread(x, in_s, cap)), jnp.asarray(w),
        gj.kmaps[sp.key], gj.kmaps[_rev_key(sp)],
        jnp.asarray(spread(up, out_s, cap)))
    ref = (np.asarray(ref[0])[sel[out_s][1]],
           np.asarray(ref[1])[sel[in_s][1]], np.asarray(ref[2]))
    lv_in, lv_out = gi.levels[in_s], gi.levels[out_s]
    routes = {
        "one-pass": lambda x, w: sparse_ops.sparse_conv_implicit(
            x, w, gi.maps[sp.key], lv_in, lv_out),
        "two-pass": lambda x, w: sparse_ops.sparse_conv_implicit(
            x, w, gi.maps[sp.key], lv_in, lv_out, two_pass_backward=True),
        "table": lambda x, w: sparse_ops.sparse_conv(
            x, w, ge.kmaps[sp.key], ge.kmaps[_rev_key(sp)]),
    }
    for name, fn in routes.items():
        out, dx, dw = _run(fn, x, w, up)
        got = (to_np(out)[sel[out_s][0]], to_np(dx)[sel[in_s][0]], to_np(dw))
        _assert_triples_close(got, ref, REL, f"{case} {name}")


@pytest.mark.parametrize("c,cout", [(16, 24), (1, 24), (16, 1)])
def test_explicit_tables_match_scan(c, cout):
    """tests/test_core.py::TestPallasConv's tables (random rows, 30%
    missing, a hard jump): the index-table forward and dW against
    gcl_tpu's scan path and against pallas_conv_fwd / pallas_conv_dw in
    interpret mode, general, Cin == 1 and Cout == 1."""
    from gcl_tpu.core.pallas_conv import pallas_conv_dw, pallas_conv_fwd

    rng = np.random.RandomState(c + cout)
    n, k = 700, 27
    x = rng.randn(n, c).astype(np.float32)
    w = (rng.randn(k, c, cout) * 0.1).astype(np.float32)
    base = np.arange(n, dtype=np.int32)
    idx = np.zeros((k, n), np.int32)
    for kk in range(k):
        v = np.clip(base + (kk - k // 2) * 11
                    + np.sort(rng.randint(-3, 4, n)), 0, n - 1)
        v[rng.rand(n) < 0.3] = n  # missing, in gcl_tpu's routed form
        idx[kk] = v
    idx[:, n // 2:n // 2 + 40] = 0
    g = rng.randn(n, cout).astype(np.float32)
    xp = np.concatenate([x, np.zeros((1, c), np.float32)])
    ref = sum(xp[idx[kk]] @ w[kk] for kk in range(k))
    ref_dw = np.stack([xp[idx[kk]].T @ g for kk in range(k)])
    # the port's tables say -1 for a missing input; n means the same
    for table in (idx, np.where(idx == n, -1, idx)):
        t = torch.from_numpy(table)
        out = kernels.sparse_conv_table_fwd(torch.from_numpy(x),
                                            torch.from_numpy(w), t)
        dw = kernels.sparse_conv_dw(torch.from_numpy(x), torch.from_numpy(g),
                                    t)
        assert_close_to_max(to_np(out), ref, REL, "forward")
        assert_close_to_max(to_np(dw), ref_dw, REL, "dW")
    pal = pallas_conv_fwd(jnp.asarray(x), jnp.asarray(w), jnp.asarray(idx),
                          interpret=True)
    assert_close_to_max(to_np(out), np.asarray(pal), 1e-4, "pallas forward")
    pal_dw = pallas_conv_dw(jnp.asarray(x), jnp.asarray(g), jnp.asarray(idx),
                            interpret=True)
    assert_close_to_max(to_np(dw), np.asarray(pal_dw), 1e-4, "pallas dW")


def test_table_wrappers_check_their_arguments():
    x, w = torch.zeros(5, 2), torch.zeros(27, 2, 3)
    idx = torch.zeros(27, 4, dtype=torch.int32)
    assert kernels.sparse_conv_table_fwd(x, w, idx).shape == (4, 3)
    assert kernels.sparse_conv_dw(x, torch.zeros(4, 3), idx).shape == (27, 2,
                                                                       3)
    with pytest.raises(TypeError, match="int32"):
        kernels.sparse_conv_table_fwd(x, w, idx.long())
    with pytest.raises(ValueError, match="shape mismatch"):
        kernels.sparse_conv_table_fwd(x, w[:5], idx)
    with pytest.raises(ValueError, match="does not cover"):
        kernels.sparse_conv_dw(x, torch.zeros(3, 3), idx)
    with pytest.raises(ValueError, match="come together"):
        kernels.sparse_conv_dw(x, torch.zeros(4, 3), idx, skeys=idx[0])
    with pytest.raises(TypeError, match="float32"):
        sparse_ops.sparse_conv(x.double(), w, idx)
