"""Parity of the two kernels' plain versions (K6 implicit-map conv, K2
occupancy conv) and the masked statistics with gcl_tpu.

Tolerances: the convs sum the same float32 products in another order
(per-offset matmuls here, XLA's HIGHEST-precision scan there), so outputs
agree to rounding: rtol/atol 1e-5. Presence bits are integers: exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcl_tpu.core.sparse_ops import l2_normalize as j_l2n
from gcl_tpu.core.sparse_ops import masked_mean_var as j_mmv
from gcl_tpu.core.sparse_ops import sparse_conv as j_sparse_conv
from gcl_tpu_torch.core import sparse_ops
from gcl_tpu_torch.core.kernel_maps import ConvSpec, build_graph
from gcl_tpu_torch.core.types import INVALID_BATCH
from gcl_tpu_torch.data.device_pipeline import voxelize_per_cloud
from gcl_tpu_torch.kernels import (occupancy_conv_fwd,
                                   sparse_conv_implicit_fwd)

from _torch_parity import VOXEL, clouds, jax_graph, to_np

TOL = dict(rtol=1e-5, atol=1e-5)
SPECS = [ConvSpec("conv1", 1, 1, 5), ConvSpec("block1", 1, 1, 3),
         ConvSpec("conv2", 1, 2, 3), ConvSpec("block2", 2, 2, 3),
         ConvSpec("conv2_tr", 2, 1, 3)]
CAPS = {2: 384}


@pytest.fixture(scope="module")
def graphs():
    pts, pmask = clouds(7, 2, 700)
    vox = voxelize_per_cloud(torch.from_numpy(pts), torch.from_numpy(pmask),
                             VOXEL, 512)
    flat = vox.flatten()
    c, m = to_np(flat.coords), to_np(flat.mask)
    return (build_graph(flat.coords, flat.mask, SPECS, CAPS, 2),
            jax_graph(c, m, SPECS, CAPS, 2))


_j_conv = jax.jit(j_sparse_conv)


@pytest.mark.parametrize("key,cin,cout", [
    ("s1->s1/k3d1", 32, 32),    # same level
    ("s1->s2/k3d1", 32, 64),    # strided
    ("s2->s1/k3d1", 192, 128),  # transposed, Cin after a skip concat
])
def test_implicit_conv_plain_matches_jax(graphs, key, cin, cout):
    g, gj = graphs
    sp = next(s for s in SPECS if s.key == key)
    rng = np.random.RandomState(cin + cout)
    lv = g.levels[sp.in_stride]
    x = rng.randn(lv.coords.shape[0], cin).astype(np.float32)
    x *= to_np(lv.mask)[:, None]
    w = (rng.randn(27, cin, cout) * 0.05).astype(np.float32)
    out = sparse_ops.sparse_conv_implicit(torch.from_numpy(x),
                                          torch.from_numpy(w), g.maps[key],
                                          lv, g.levels[sp.out_stride])
    ref = _j_conv(jnp.asarray(x), jnp.asarray(w), gj.kmaps[key])
    assert out.shape == ref.shape
    np.testing.assert_allclose(to_np(out), np.asarray(ref), **TOL)
    assert np.abs(np.asarray(ref)).max() > 0.1


def _check_occupancy(g, gj, key, w):
    """out against gcl_tpu's sparse_conv of all-ones occupancy features;
    sbits' bit k against kmap[k, i] >= 0 exactly."""
    lv = g.levels[1]
    out, sbits = occupancy_conv_fwd(g.maps[key].c1z, lv.skeys,
                                    torch.from_numpy(w))
    ones = np.asarray(gj.levels[1].mask, np.float32)[:, None]
    ref = _j_conv(jnp.asarray(ones), jnp.asarray(w), gj.kmaps[key])
    np.testing.assert_allclose(to_np(out), np.asarray(ref), **TOL)
    kmap = np.asarray(gj.kmaps[key])
    side = round(w.shape[0] ** (1 / 3))
    k = np.arange(w.shape[0])
    bits = (to_np(sbits)[:, k // side ** 2] >> (k % side ** 2)) & 1
    np.testing.assert_array_equal(bits.T, (kmap >= 0).astype(np.int32))
    assert (to_np(sbits)[:, side:] == 0).all()
    return to_np(sbits)


@pytest.mark.parametrize("key,k", [("s1->s1/k5d1", 125), ("s1->s1/k3d1", 27)])
def test_occupancy_conv_plain_matches_jax(graphs, key, k):
    g, gj = graphs
    w = (np.random.RandomState(k).randn(k, 1, 32) * 0.1).astype(np.float32)
    sbits = _check_occupancy(g, gj, key, w)
    assert sbits.any()


def test_occupancy_conv_at_key_window_edges():
    """Voxels on the packed-key window's faces (x, y in {-512, 511}, z in
    {-64, 63}): neighbours beyond the window must be absent, not aliased
    into the adjacent bit field."""
    xs = [-512, -511, -510, 509, 510, 511]
    zs = [-64, -63, 0, 62, 63]
    xyz = np.array([(x, y, z) for x in xs for y in xs for z in zs],
                   np.int32)
    key = ((xyz[:, 0] + 512) << 18) | ((xyz[:, 1] + 512) << 8) | (
        xyz[:, 2] + 128)
    xyz = xyz[np.argsort(key)]
    n, cap = len(xyz), 256 * (len(xyz) // 256 + 1)
    coords = np.full((cap, 4), -1, np.int32)
    coords[:, 0] = INVALID_BATCH
    coords[:n, 0] = 0
    coords[:n, 1:] = xyz
    mask = np.arange(cap) < n
    specs = [ConvSpec("conv1", 1, 1, 5)]
    g = build_graph(torch.from_numpy(coords), torch.from_numpy(mask), specs,
                    {}, 1)
    gj = jax_graph(coords, mask, specs, {1: cap}, 1)
    w = (np.random.RandomState(0).randn(125, 1, 32)).astype(np.float32)
    _check_occupancy(g, gj, "s1->s1/k5d1", w)


def test_occupancy_sbits_match_pallas_kernel():
    """sbits equal those of gcl_tpu's Pallas kernel K2 (interpret mode)."""
    from gcl_tpu.core.pallas_conv import fused_conv_c1z_fwd
    from gcl_tpu.testing import kernel_interpret

    pts, pmask = clouds(8, 1, 300)
    vox = voxelize_per_cloud(torch.from_numpy(pts), torch.from_numpy(pmask),
                             VOXEL, 256)
    flat = vox.flatten()
    specs = [ConvSpec("conv1", 1, 1, 3)]
    c, m = to_np(flat.coords), to_np(flat.mask)
    with kernel_interpret():
        gj = jax_graph(c, m, specs, {}, 1)
        fm = gj.fused["s1->s1/k3d1"]
        w = np.random.RandomState(1).randn(27, 1, 8).astype(np.float32)
        out_p, sb_p = fused_conv_c1z_fwd(fm.c1z, jnp.asarray(w), fm.starts,
                                         fm.nch, fm.tkeys, fm.win,
                                         jnp.float32, interpret=True)
    g = build_graph(flat.coords, flat.mask, specs, {}, 1)
    out, sbits = occupancy_conv_fwd(g.maps["s1->s1/k3d1"].c1z,
                                    g.levels[1].skeys, torch.from_numpy(w))
    np.testing.assert_array_equal(to_np(sbits), np.asarray(sb_p))
    np.testing.assert_allclose(to_np(out), np.asarray(out_p), **TOL)


@pytest.mark.parametrize("gate_open", [True, False])
def test_c1z_jittered_matches_jax(gate_open):
    """sparse_conv_c1z_jittered (jitter_mode 'c1z') against gcl_tpu's, which
    rides its Pallas occupancy kernels (interpret mode): the gate uniform
    and the normals gcl_tpu draws from its key are handed to the port.
    Values and dW (which flows through the noise term too) within 1e-5 of
    the max; centre-cloud rows only."""
    from gcl_tpu.core.sparse_ops import sparse_conv_c1z_jittered as j_jit
    from gcl_tpu.testing import kernel_interpret

    pts, pmask = clouds(9, 2, 300)
    vox = voxelize_per_cloud(torch.from_numpy(pts), torch.from_numpy(pmask),
                             VOXEL, 256)
    flat = vox.flatten()
    specs = [ConvSpec("conv1", 1, 1, 5)]
    key_name = "s1->s1/k5d1"
    g = build_graph(flat.coords, flat.mask, specs, {}, 2)
    lv, cmap = g.levels[1], g.maps[key_name]
    rng = np.random.RandomState(3)
    w = (rng.randn(125, 1, 32) * 0.1).astype(np.float32)
    up = rng.randn(512, 32).astype(np.float32)
    row_sel = to_np((lv.coords[:, 0] == 0).to(torch.float32))
    sigma, p = 0.05, 0.95
    # a key whose gate uniform falls on the wanted side of p
    key = next(k for k in map(jax.random.PRNGKey, range(200))
               if (float(jax.random.uniform(jax.random.split(k)[0])) < p)
               == gate_open)
    k_gate, k_eps = jax.random.split(key)
    with kernel_interpret():
        gj = jax_graph(to_np(flat.coords), to_np(flat.mask), specs, {}, 2)
        fm = gj.fused[key_name]
        ref, vjp = jax.vjp(lambda w: j_jit(w, fm, jnp.float32, key, sigma, p,
                                           jnp.asarray(row_sel)),
                           jnp.asarray(w))
        (rdw,) = vjp(jnp.asarray(up))
    wt = torch.from_numpy(w).requires_grad_()
    out = sparse_ops.sparse_conv_c1z_jittered(
        wt, cmap, lv, None, sigma, p, torch.from_numpy(row_sel),
        gate_u=torch.tensor(float(jax.random.uniform(k_gate))),
        normal=torch.from_numpy(np.array(
            jax.random.normal(k_eps, (512, 125), jnp.float32))))
    out.backward(torch.from_numpy(up))
    scale = float(np.abs(np.asarray(ref)).max())
    np.testing.assert_allclose(to_np(out), np.asarray(ref), rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(to_np(wt.grad), np.asarray(rdw), rtol=0,
                               atol=1e-5 * float(np.abs(rdw).max()))
    clean = sparse_ops.sparse_conv_c1z(torch.from_numpy(w), cmap.c1z, lv)
    noise = (out.detach() - clean).abs().max(dim=1)[0]
    assert float(noise[torch.from_numpy(row_sel) == 0].max()) == 0
    assert (float(noise.max()) > 1e-3) == gate_open
    # from a generator: same mean, other numbers
    gen = torch.Generator().manual_seed(0)
    drawn = sparse_ops.sparse_conv_c1z_jittered(
        torch.from_numpy(w), cmap, lv, gen, sigma, 1.0,
        torch.from_numpy(row_sel))
    assert float((drawn - clean).abs().max()) > 1e-3


def test_wrappers_refuse_other_devices():
    """A non-CPU tensor never takes the plain version: meta tensors (no
    CUDA here) are refused outright."""
    x = torch.empty((4, 2), device="meta")
    w = torch.empty((27, 2, 3), device="meta")
    i = torch.empty((27, 4), dtype=torch.int32, device="meta")
    k = torch.empty((4,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        sparse_conv_implicit_fwd(x, w, i, k, k)
    with pytest.raises(ValueError, match="device"):
        occupancy_conv_fwd(torch.empty((4, 8), dtype=torch.int32,
                                       device="meta"), k,
                           torch.empty((27, 1, 3), device="meta"))
    with pytest.raises(TypeError):
        sparse_conv_implicit_fwd(torch.zeros(4, 2, dtype=torch.float64),
                                 torch.zeros(27, 2, 3),
                                 torch.zeros(27, 4, dtype=torch.int32),
                                 torch.zeros(4, dtype=torch.int32),
                                 torch.zeros(4, dtype=torch.int32))


def test_masked_stats_and_normalize():
    """masked_mean_var / l2_normalize against gcl_tpu (1e-5: reductions
    in another order)."""
    rng = np.random.RandomState(3)
    x = rng.randn(300, 16).astype(np.float32) * 3 + 1
    m = rng.rand(300) > 0.3
    mt, vt, ct = sparse_ops.masked_mean_var(torch.from_numpy(x),
                                            torch.from_numpy(m))
    mj, vj, cj = j_mmv(jnp.asarray(x), jnp.asarray(m))
    np.testing.assert_allclose(to_np(mt), np.asarray(mj), **TOL)
    np.testing.assert_allclose(to_np(vt), np.asarray(vj), **TOL)
    assert float(ct) == float(cj)
    np.testing.assert_allclose(
        to_np(sparse_ops.l2_normalize(torch.from_numpy(x))),
        np.asarray(j_l2n(jnp.asarray(x))), **TOL)
    np.testing.assert_array_equal(
        to_np(sparse_ops.apply_mask(torch.from_numpy(x),
                                    torch.from_numpy(m))),
        x * m[:, None])


@pytest.mark.parametrize("key,tile,frag", [("s1->s1/k3d1", 64, 16),
                                           ("s1->s2/k3d1", 64, 16),
                                           ("s2->s1/k3d1", 128, 8)])
def test_compacted_rows_against_a_loop(graphs, key, tile, frag):
    """kernels.compacted_rows (the work the gather-GEMM of K6, K7's dX and
    K12 executes) against a plain loop over (tile, offset) on a real map:
    the hits of each tile's offset rounded up to ``frag``."""
    from gcl_tpu_torch.core.coords import lookup
    from gcl_tpu_torch.kernels import compacted_rows

    g = graphs[0]
    lv = g.levels[int(key.split("->")[0][1:])]
    hit = lookup(lv.skeys, lv.srow, g.maps[key].qkey) >= 0
    matched, executed = 0, 0
    for k in range(hit.shape[0]):
        for t0 in range(0, hit.shape[1], tile):
            n = int(hit[k, t0:t0 + tile].sum())
            matched += n
            executed += -(-n // frag) * frag
    assert compacted_rows(hit, tile, frag) == (matched, executed)
    assert matched <= executed < matched + hit.shape[0] * frag * (
        -(-hit.shape[1] // tile))
