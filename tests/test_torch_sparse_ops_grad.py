"""Gradients of the port's three conv Functions (SparseConvImplicit,
OccupancyConv, ScalarConv: plain K6 + K7, K2 + K3, K4 + K5 + K9 on the CPU)
against gcl_tpu's sparse_conv and its reverse-map VJP, and ScalarConv's dX
also against gcl_tpu's Cout == 1 Pallas kernel in interpret mode.

Tolerance: values, dX and dW within 1e-5 of each tensor's max. Both sides
sum the same float32 products, in another order (per-offset matmuls here,
XLA's HIGHEST-precision scan there).

torch.autograd.gradcheck runs in float64 on the Functions with their
wrappers routed to the plain versions: the wrappers themselves refuse
anything but float32, as the kernels do.
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
from gcl_tpu_torch.core.types import map_key
from gcl_tpu_torch.data.device_pipeline import voxelize_per_cloud

from _torch_parity import VOXEL, assert_close_to_max, clouds, jax_graph, to_np

SPECS = [ConvSpec("conv1", 1, 1, 5), ConvSpec("block1", 1, 1, 3),
         ConvSpec("conv2", 1, 2, 3), ConvSpec("block2", 2, 2, 3),
         ConvSpec("conv2_tr", 2, 1, 3)]
CAPS = {2: 384}
REL = 1e-5


def _graphs(seed, n_clouds, n_points, nv, specs=SPECS, caps=CAPS):
    pts, pmask = clouds(seed, n_clouds, n_points)
    vox = voxelize_per_cloud(torch.from_numpy(pts), torch.from_numpy(pmask),
                             VOXEL, nv)
    flat = vox.flatten()
    return (build_graph(flat.coords, flat.mask, specs, caps, n_clouds),
            jax_graph(to_np(flat.coords), to_np(flat.mask), specs, caps,
                      n_clouds))


@pytest.fixture(scope="module")
def graphs():
    return _graphs(7, 2, 700, 512)


@jax.jit
def _j_conv_vjp(x, w, kmap, rev, g):
    out, vjp = jax.vjp(lambda x, w: j_sparse_conv(x, w, kmap, rev), x, w)
    return (out,) + vjp(g)


def _rev_key(sp):
    return map_key(sp.out_stride, sp.in_stride, sp.kernel_size, sp.dilation)


@pytest.mark.parametrize("key,cin,cout", [
    ("s1->s1/k3d1", 32, 32),    # same level
    ("s1->s2/k3d1", 32, 64),    # strided
    ("s2->s1/k3d1", 192, 128),  # transposed, Cin after a skip concat
])
def test_implicit_conv_grads_match_jax(graphs, key, cin, cout):
    g, gj = graphs
    sp = next(s for s in SPECS if s.key == key)
    rng = np.random.RandomState(cin + cout)
    lv_in, lv_out = g.levels[sp.in_stride], g.levels[sp.out_stride]
    x = rng.randn(lv_in.coords.shape[0], cin).astype(np.float32)
    x *= to_np(lv_in.mask)[:, None]
    w = (rng.randn(27, cin, cout) * 0.05).astype(np.float32)  # not symmetric
    up = rng.randn(lv_out.coords.shape[0], cout).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = sparse_ops.sparse_conv_implicit(xt, wt, g.maps[key], lv_in, lv_out)
    # a non-contiguous upstream gradient, as autograd often hands over
    out.backward(torch.from_numpy(np.ascontiguousarray(up.T)).T)
    ref, rdx, rdw = _j_conv_vjp(jnp.asarray(x), jnp.asarray(w),
                                gj.kmaps[key], gj.kmaps[_rev_key(sp)],
                                jnp.asarray(up))
    assert_close_to_max(to_np(out), ref, REL)
    assert_close_to_max(to_np(xt.grad), rdx, REL)
    assert_close_to_max(to_np(wt.grad), rdw, REL)


def test_implicit_conv_skips_dx_nobody_asked_for(graphs, monkeypatch):
    g, _ = graphs
    lv = g.levels[1]
    seen = []
    real = sparse_ops.sparse_conv_implicit_bwd

    def spy(*args, want_dx=True):
        seen.append(want_dx)
        return real(*args, want_dx=want_dx)

    monkeypatch.setattr(sparse_ops, "sparse_conv_implicit_bwd", spy)
    w = torch.randn(27, 4, 4, requires_grad=True)
    for needs in (False, True):
        x = torch.randn(lv.coords.shape[0], 4, requires_grad=needs)
        sparse_ops.sparse_conv_implicit(x, w, g.maps["s1->s1/k3d1"], lv,
                                        lv).sum().backward()
        assert (x.grad is not None) == needs
    assert seen == [False, True]


@pytest.mark.parametrize("key,k", [("s1->s1/k5d1", 125), ("s1->s1/k3d1", 27)])
def test_occupancy_and_scalar_conv_grads_match_jax(graphs, key, k):
    """OccupancyConv (plain K2 + K3) against sparse_conv of all-ones
    features; ScalarConv (plain K4 + K5) on a dense random x [N, 1]."""
    g, gj = graphs
    lv = g.levels[1]
    n = lv.coords.shape[0]
    rng = np.random.RandomState(k)
    w = (rng.randn(k, 1, 32) * 0.1).astype(np.float32)
    up = rng.randn(n, 32).astype(np.float32)
    ones = to_np(lv.mask).astype(np.float32)[:, None]
    x = rng.randn(n, 1).astype(np.float32) * ones
    cmap = g.maps[key]

    wt = torch.from_numpy(w).requires_grad_()
    out = sparse_ops.sparse_conv_c1z(wt, cmap.c1z, lv)
    out.backward(torch.from_numpy(up))
    ref, _, rdw = _j_conv_vjp(jnp.asarray(ones), jnp.asarray(w),
                              gj.kmaps[key], gj.kmaps[key], jnp.asarray(up))
    assert_close_to_max(to_np(out), ref, REL)
    assert_close_to_max(to_np(wt.grad), rdw, REL)

    wt = torch.from_numpy(w).requires_grad_()
    out = sparse_ops.ScalarConv.apply(torch.from_numpy(x), wt, cmap.c1z,
                                      lv.skeys, lv.srow, None)
    out.backward(torch.from_numpy(up))
    ref, _, rdw = _j_conv_vjp(jnp.asarray(x), jnp.asarray(w), gj.kmaps[key],
                              gj.kmaps[key], jnp.asarray(up))
    assert_close_to_max(to_np(out), ref, REL)
    assert_close_to_max(to_np(wt.grad), rdw, REL)


def test_scalar_conv_refuses_dx(graphs, monkeypatch):
    """(Kept under its first name.) ScalarConv no longer refuses dX: an x
    that requires a gradient gets it from K9 (plain version here), against
    gcl_tpu's reverse-map VJP; an x that does not never reaches K9."""
    g, gj = graphs
    key = "s1->s1/k3d1"
    lv, cmap = g.levels[1], g.maps[key]
    n = lv.coords.shape[0]
    rng = np.random.RandomState(4)
    x = rng.randn(n, 1).astype(np.float32) * to_np(lv.mask)[:, None]
    w = (rng.randn(27, 1, 6) * 0.3).astype(np.float32)       # not symmetric
    up = rng.randn(n, 6).astype(np.float32)
    calls = []
    real = sparse_ops.scalar_conv_dx
    monkeypatch.setattr(sparse_ops, "scalar_conv_dx",
                        lambda *a: calls.append(1) or real(*a))
    for needs in (False, True):
        xt = torch.from_numpy(x).requires_grad_(needs)
        wt = torch.from_numpy(w).requires_grad_()
        sparse_ops.ScalarConv.apply(xt, wt, cmap.c1z, lv.skeys, lv.srow,
                                    None).backward(torch.from_numpy(up))
        assert len(calls) == int(needs)
    _, rdx, rdw = _j_conv_vjp(jnp.asarray(x), jnp.asarray(w), gj.kmaps[key],
                              gj.kmaps[key], jnp.asarray(up))
    assert_close_to_max(to_np(xt.grad), rdx, REL)
    assert_close_to_max(to_np(wt.grad), rdw, REL)


@pytest.mark.parametrize("gated", [False, True])
def test_scalar_conv_dx_is_the_adjoint_of_the_forward(graphs, gated):
    """<K4(x), g> == <x, K9(g)> for random x, g and weights, with and
    without a row flag that is NOT constant over a cloud (K9 leaves out the
    rows of g that K4 skipped); 1e-5 of the inner product's scale."""
    g, _ = graphs
    lv, cmap = g.levels[1], g.maps["s1->s1/k5d1"]
    n = lv.coords.shape[0]
    gen = torch.Generator().manual_seed(11)
    x = torch.randn(n, 1, generator=gen) * lv.mask[:, None]
    up = torch.randn(n, 32, generator=gen)
    w = torch.randn(125, 1, 32, generator=gen)
    sel = (torch.rand(n, generator=gen) > 0.4).float() if gated else None
    geo = (cmap.c1z, lv.skeys, lv.srow, sel)
    out = kernels.scalar_conv_fwd(x, w, *geo)
    dx = kernels.scalar_conv_dx(up, w, *geo)
    assert dx.shape == (n, 1)
    lhs, rhs = float((out * up).sum()), float((x * dx).sum())
    scale = float((out.abs() * up.abs()).sum())
    assert abs(lhs - rhs) <= 1e-5 * scale and abs(lhs) > 1e-3 * scale
    if gated:
        assert not torch.equal(dx, kernels.scalar_conv_dx(up, w, *geo[:3]))


def test_scalar_conv_dx_matches_pallas_co1_kernel():
    """The port's plain K9 against gcl_tpu's own route to it: jax.grad of
    sparse_conv_fused with Cin == 1 w.r.t. the features, whose backward
    runs the Cout == 1 Pallas kernel (_conv_co1_fwd) through the reverse
    queries, in interpret mode; 1e-5 of the max."""
    from gcl_tpu.core.sparse_ops import sparse_conv_fused
    from gcl_tpu.testing import kernel_interpret

    pts, pmask = clouds(8, 2, 300)
    vox = voxelize_per_cloud(torch.from_numpy(pts), torch.from_numpy(pmask),
                             VOXEL, 256)
    flat = vox.flatten()
    specs = [ConvSpec("c", 1, 1, 5)]
    key = "s1->s1/k5d1"
    g = build_graph(flat.coords, flat.mask, specs, {}, 2)
    lv, cmap = g.levels[1], g.maps[key]
    rng = np.random.RandomState(6)
    x = rng.randn(512, 1).astype(np.float32) * to_np(lv.mask)[:, None]
    w = (rng.randn(125, 1, 32) * 0.1).astype(np.float32)
    up = rng.randn(512, 32).astype(np.float32)
    with kernel_interpret():
        gj = jax_graph(to_np(flat.coords), to_np(flat.mask), specs, {}, 2)
        fm = gj.fused[key]
        rdx = jax.grad(lambda x: jnp.sum(
            sparse_conv_fused(x, jnp.asarray(w), fm, fm) * jnp.asarray(up)))(
                jnp.asarray(x))
    dx = kernels.scalar_conv_dx(torch.from_numpy(up), torch.from_numpy(w),
                                cmap.c1z, lv.skeys, lv.srow)
    assert_close_to_max(to_np(dx), rdx, REL)


def test_exact_jitter_matches_jax_and_row_flag_is_exact(graphs):
    """conv(1) + conv(eps) with a given eps on the centre cloud's rows
    against gcl_tpu's sparse_conv(1 + eps): value and dW. The row flag
    changes neither, bit for bit."""
    g, gj = graphs
    key = "s1->s1/k5d1"
    lv, cmap = g.levels[1], g.maps[key]
    n = lv.coords.shape[0]
    rng = np.random.RandomState(9)
    w = (rng.randn(125, 1, 32) * 0.1).astype(np.float32)
    up = rng.randn(n, 32).astype(np.float32)
    row_sel = (lv.coords[:, 0] == 0).to(torch.float32)
    normal = torch.from_numpy(rng.randn(n, 1).astype(np.float32))
    eps = sparse_ops.draw_input_eps(None, 0.01, 0.95, lv.mask, row_sel,
                                    gate_u=torch.tensor(0.5), normal=normal)
    assert (eps[row_sel == 0] == 0).all() and (eps != 0).sum() > 100
    off = sparse_ops.draw_input_eps(None, 0.01, 0.95, lv.mask, row_sel,
                                    gate_u=torch.tensor(0.97), normal=normal)
    assert not off.any()  # the gate closes above p

    got = []
    for sel in (row_sel, None):
        wt = torch.from_numpy(w).requires_grad_()
        out = sparse_ops.sparse_conv_c1z_exact_jitter(wt, cmap, lv, eps, sel)
        out.backward(torch.from_numpy(up))
        got.append((out.detach(), wt.grad))
    assert torch.equal(got[0][0], got[1][0])
    assert torch.equal(got[0][1], got[1][1])

    feats = to_np(lv.mask).astype(np.float32)[:, None] + to_np(eps)
    ref, _, rdw = _j_conv_vjp(jnp.asarray(feats), jnp.asarray(w),
                              gj.kmaps[key], gj.kmaps[key], jnp.asarray(up))
    assert_close_to_max(to_np(got[0][0]), ref, REL)
    assert_close_to_max(to_np(got[0][1]), rdw, REL)
    # the eps term alone is visible at this tolerance
    plain = sparse_ops.sparse_conv_c1z(torch.from_numpy(w), cmap.c1z, lv)
    assert float((got[0][0] - plain).abs().max()) > 1e-3


def test_float32_only():
    """Weights are float32 parameters; features float32 or bf16. float64
    and float16 features and float64 weights are refused; bf16 features
    build, and their conv comes out in bf16 with a float32 dW."""
    with pytest.raises(TypeError, match="float32"):
        sparse_ops.sparse_conv_c1z(torch.zeros(27, 1, 4, dtype=torch.float64),
                                   None, None)
    for dt in (torch.float64, torch.float16):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            sparse_ops.sparse_conv_implicit(
                torch.zeros(4, 2, dtype=dt), torch.zeros(27, 2, 3),
                None, None, None)
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            sparse_ops.sparse_conv(torch.zeros(4, 2, dtype=dt),
                                   torch.zeros(27, 2, 3),
                                   torch.zeros(27, 4, dtype=torch.int32))
    pts, pmask = clouds(5, 1, 60)
    flat = voxelize_per_cloud(torch.from_numpy(pts), torch.from_numpy(pmask),
                              VOXEL, 40).flatten()
    g = build_graph(flat.coords, flat.mask, [ConvSpec("b", 1, 1, 3)], {}, 1)
    lv, cmap = g.levels[1], g.maps["s1->s1/k3d1"]
    x = torch.randn(lv.coords.shape[0], 2).to(torch.bfloat16)
    w = torch.randn(27, 2, 3, requires_grad=True)
    out = sparse_ops.sparse_conv_implicit(x, w, cmap, lv, lv)
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    assert w.grad.dtype == torch.float32 and bool(w.grad.abs().sum() > 0)


@pytest.fixture
def plain_wrappers(monkeypatch):
    """Route the Functions to the plain versions (which take float64)."""
    for fn, plain in kernels.KERNELS.values():
        if hasattr(sparse_ops, fn.__name__):   # the conv kernels
            monkeypatch.setattr(sparse_ops, fn.__name__, plain)


def test_gradcheck_float64(plain_wrappers):
    g, _ = _graphs(5, 2, 60, 40, [ConvSpec("b", 1, 1, 3),
                                  ConvSpec("d", 1, 2, 3)], {2: 40})
    gen = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64)

    for key, s_in, s_out in (("s1->s1/k3d1", 1, 1), ("s1->s2/k3d1", 1, 2)):
        lv_in, lv_out = g.levels[s_in], g.levels[s_out]
        cmap = g.maps[key]
        x = rand(lv_in.coords.shape[0], 3).requires_grad_()
        w = rand(27, 3, 2).requires_grad_()
        assert torch.autograd.gradcheck(
            lambda x, w: sparse_ops.SparseConvImplicit.apply(
                x, w, cmap.qkey, cmap.rqkey, lv_in.skeys, lv_in.srow,
                lv_out.skeys, lv_out.srow), (x, w))
    lv, cmap = g.levels[1], g.maps["s1->s1/k3d1"]
    w = rand(27, 1, 3).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda w: sparse_ops.OccupancyConv.apply(w, cmap.c1z, lv.skeys)[0],
        (w,))
    x = rand(lv.coords.shape[0], 1).requires_grad_()
    sel = (lv.coords[:, 0] == 1).to(torch.float64)
    for row_sel in (None, sel):
        assert torch.autograd.gradcheck(
            lambda x, w: sparse_ops.ScalarConv.apply(
                x, w, cmap.c1z, lv.skeys, lv.srow, row_sel), (x, w))


def test_plain_backward_matches_pallas_kernels():
    """The port's plain K7 and K3 against gcl_tpu's Pallas kernels
    themselves (fused_conv_bwd, fused_conv_c1z_dw) in interpret mode, at a
    tiny shape; 1e-4 of the max (the TPU kernels' one-hot products)."""
    from gcl_tpu.core.sparse_ops import sparse_conv_c1z as j_c1z
    from gcl_tpu.core.sparse_ops import sparse_conv_fused
    from gcl_tpu.testing import kernel_interpret

    pts, pmask = clouds(8, 1, 300)
    vox = voxelize_per_cloud(torch.from_numpy(pts), torch.from_numpy(pmask),
                             VOXEL, 256)
    flat = vox.flatten()
    specs = [ConvSpec("b", 1, 1, 3)]
    key = "s1->s1/k3d1"
    g = build_graph(flat.coords, flat.mask, specs, {}, 1)
    lv, cmap = g.levels[1], g.maps[key]
    rng = np.random.RandomState(2)
    x = rng.randn(256, 8).astype(np.float32) * to_np(lv.mask)[:, None]
    w = (rng.randn(27, 8, 16) * 0.1).astype(np.float32)
    w1 = (rng.randn(27, 1, 16) * 0.1).astype(np.float32)
    up = rng.randn(256, 16).astype(np.float32)
    with kernel_interpret():
        gj = jax_graph(to_np(flat.coords), to_np(flat.mask), specs, {}, 1)
        fm = gj.fused[key]
        _, vjp = jax.vjp(lambda x, w: sparse_conv_fused(x, w, fm, fm),
                         jnp.asarray(x), jnp.asarray(w))
        rdx, rdw = vjp(jnp.asarray(up))
        _, vjp1 = jax.vjp(lambda w: j_c1z(w, fm, jnp.float32),
                          jnp.asarray(w1))
        (rdw1,) = vjp1(jnp.asarray(up))
    dx, dw = kernels.sparse_conv_implicit_bwd(
        torch.from_numpy(x), torch.from_numpy(up), torch.from_numpy(w),
        cmap.rqkey, lv.skeys, lv.srow)
    assert_close_to_max(to_np(dx), rdx, 1e-4)
    assert_close_to_max(to_np(dw), rdw, 1e-4)
    _, sbits = kernels.occupancy_conv_fwd(cmap.c1z, lv.skeys,
                                          torch.from_numpy(w1))
    dw1 = kernels.occupancy_conv_dw(sbits, torch.from_numpy(up), 27)
    assert_close_to_max(to_np(dw1), rdw1, 1e-4)
