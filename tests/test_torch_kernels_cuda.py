"""CUDA legs of the port's kernels (K1-K12): each kernel against its
plain PyTorch version on the card, at small shapes with ragged tile edges
(K10, K2, K4, K5 and K1 also on the key-window cases of
tests/_torch_parity.py; K3 also on synthetic bitmasks at the widths and
row counts its tensor-core tiles cut).

A CUDA kernel has no CPU mode, so these skip where
torch.cuda.is_available() is false. On a machine with a card (no JAX
needed, hence no conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q
"""
import numpy as np
import pytest
import torch

from gcl_tpu_torch.core.kernel_maps import ConvSpec, build_graph
from gcl_tpu_torch.data.device_pipeline import voxelize_per_cloud
from gcl_tpu_torch.infer import make_feature_extractor
from gcl_tpu_torch.data.device_pipeline import (_batched_grid_core,
                                                batch_colocation_groups,
                                                batched_grid_radius_knn,
                                                radius_knn)
from gcl_tpu_torch.core import kernel_maps, sparse_ops
from gcl_tpu_torch.kernels import (compacted_rows, counted_dw_rows,
                                   counted_gather_rows, counted_join_keys,
                                   counted_occupancy_keys,
                                   counted_scalar_keys, counted_topk_keys,
                                   join_kmap,
                                   join_kmap_plain, join_windows,
                                   occupancy_windows,
                                   sparse_conv_dw, sparse_conv_dw_plain,
                                   sparse_conv_table_fwd,
                                   sparse_conv_table_fwd_plain,
                                   occupancy_conv_dw,
                                   occupancy_conv_dw_plain,
                                   occupancy_conv_fwd,
                                   occupancy_conv_fwd_plain, scalar_conv_dw,
                                   scalar_conv_dw_plain, scalar_conv_dx,
                                   scalar_conv_dx_plain, scalar_conv_fwd,
                                   scalar_conv_fwd_plain,
                                   sparse_conv_implicit_bwd,
                                   sparse_conv_implicit_bwd_plain,
                                   sparse_conv_implicit_fwd,
                                   sparse_conv_implicit_fwd_plain,
                                   topk_windows, windowed_cell_topk,
                                   windowed_cell_topk_exact,
                                   windowed_cell_topk_packed,
                                   windowed_cell_topk_plain)
from gcl_tpu_torch.kernels.join_kmap import CHUNK as JOIN_CHUNK
from gcl_tpu_torch.kernels.occupancy_conv import CHUNK as OCC_CHUNK
from gcl_tpu_torch.kernels.scalar_conv import CHUNK as SCALAR_CHUNK
from gcl_tpu_torch.models.resunet import ResUNetFatBN
from gcl_tpu_torch.models.weights import random_state_dict

from _torch_parity import (JOIN_WINDOW_CASES, OCC_WINDOW_CASES,
                           TOPK_WINDOW_CASES, VOXEL, assert_bf16_close,
                           assert_close_to_max, clouds, fatbn_specs,
                           join_window_geometries, occupancy_window_inputs,
                           scalar_window_inputs, to_np, topk_window_inputs)

pytestmark = pytest.mark.cuda

SPECS = [ConvSpec("conv1", 1, 1, 5), ConvSpec("block1", 1, 1, 3),
         ConvSpec("conv2", 1, 2, 3), ConvSpec("conv2_tr", 2, 1, 3)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _graph(dev, seed=0, n_clouds=3):
    pts, pmask = clouds(seed, n_clouds, 900)
    vox = voxelize_per_cloud(torch.from_numpy(pts).to(dev),
                             torch.from_numpy(pmask).to(dev), VOXEL, 600)
    flat = vox.flatten()
    return build_graph(flat.coords, flat.mask, SPECS, {2: 500}, n_clouds)


@pytest.mark.parametrize("key,cin,cout", [
    ("s1->s1/k3d1", 32, 32), ("s1->s2/k3d1", 40, 72),
    ("s2->s1/k3d1", 100, 24), ("s1->s1/k3d1", 1, 1)])
def test_implicit_conv_kernel_matches_plain(dev, key, cin, cout):
    """rtol/atol 1e-4: float32 FMAs in another order than the plain
    version's per-offset matmuls (TF32 off)."""
    g = _graph(dev)
    in_s = int(key.split("->")[0][1:])
    lv = g.levels[in_s]
    gen = torch.Generator().manual_seed(cin)
    x = torch.randn(lv.coords.shape[0], cin, generator=gen).to(dev)
    w = torch.randn(27, cin, cout, generator=gen).to(dev)
    args = (x, w, g.maps[key].qkey, lv.skeys, lv.srow)
    before = sparse_conv_implicit_fwd.launches
    out = sparse_conv_implicit_fwd(*args)
    torch.cuda.synchronize()
    assert sparse_conv_implicit_fwd.launches == before + 1
    torch.testing.assert_close(out, sparse_conv_implicit_fwd_plain(*args),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("key,k", [("s1->s1/k5d1", 125), ("s1->s1/k3d1", 27)])
def test_occupancy_kernel_matches_plain(dev, key, k):
    g = _graph(dev, seed=1)
    w = torch.randn(k, 1, 32, generator=torch.Generator().manual_seed(k))
    args = (g.maps[key].c1z, g.levels[1].skeys, w.to(dev))
    before = occupancy_conv_fwd.launches
    out, sbits = occupancy_conv_fwd(*args)
    torch.cuda.synchronize()
    assert occupancy_conv_fwd.launches == before + 1
    ref, ref_bits = occupancy_conv_fwd_plain(*args)
    assert torch.equal(sbits, ref_bits) and sbits.any()
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)


def _close_to_max(a, b, rel):
    assert_close_to_max(to_np(a), to_np(b), rel)


@pytest.mark.parametrize("key,cin,cout", [
    ("s1->s1/k3d1", 32, 32), ("s1->s2/k3d1", 40, 72),
    ("s2->s1/k3d1", 100, 24), ("s1->s1/k3d1", 130, 200),
    ("s1->s2/k3d1", 70, 300), ("s1->s1/k3d1", 1, 1)])
@pytest.mark.parametrize("want_dx", [True, False])
def test_implicit_conv_bwd_kernel_matches_plain(dev, key, cin, cout, want_dx):
    """dX and dW within 1e-4 of each tensor's max: float32 FMAs, dW summed
    over blocks by atomics in an order that changes from run to run. dX is
    also held against K6 run through the reverse map with flipped,
    transposed weights (the two-pass route)."""
    gr = _graph(dev)
    s_in, s_out = (int(t[1:]) for t in key.split("/")[0].split("->"))
    lv_in, lv_out = gr.levels[s_in], gr.levels[s_out]
    gen = torch.Generator().manual_seed(cin + cout)
    x = torch.randn(lv_in.coords.shape[0], cin, generator=gen).to(dev)
    g = torch.randn(cout, lv_out.coords.shape[0], generator=gen).to(dev).T
    w = torch.randn(27, cin, cout, generator=gen).to(dev)
    assert cout == 1 or not g.is_contiguous()
    args = (x, g, w, gr.maps[key].rqkey, lv_out.skeys, lv_out.srow)
    before = sparse_conv_implicit_bwd.launches
    dx, dw = sparse_conv_implicit_bwd(*args, want_dx=want_dx)
    torch.cuda.synchronize()
    assert sparse_conv_implicit_bwd.launches == before + 1
    rdx, rdw = sparse_conv_implicit_bwd_plain(*args, want_dx=want_dx)
    _close_to_max(dw, rdw, 1e-4)
    if not want_dx:
        assert dx is None
        return
    _close_to_max(dx, rdx, 1e-4)
    two_pass = sparse_conv_implicit_fwd(
        g.contiguous(), w.flip(0).transpose(1, 2).contiguous(),
        gr.maps[key].rqkey, lv_out.skeys, lv_out.srow)
    _close_to_max(dx, two_pass, 1e-4)


@pytest.mark.parametrize("key,k", [("s1->s1/k5d1", 125), ("s1->s1/k3d1", 27)])
@pytest.mark.parametrize("cout", [32, 20])
def test_occupancy_dw_kernel_matches_plain(dev, key, k, cout):
    gr = _graph(dev, seed=1)
    gen = torch.Generator().manual_seed(k + cout)
    w = torch.randn(k, 1, cout, generator=gen).to(dev)
    _, sbits = occupancy_conv_fwd(gr.maps[key].c1z, gr.levels[1].skeys, w)
    g = torch.randn(cout, sbits.shape[0], generator=gen).to(dev).T
    before = occupancy_conv_dw.launches
    dw = occupancy_conv_dw(sbits, g, k)
    torch.cuda.synchronize()
    assert occupancy_conv_dw.launches == before + 1
    assert dw.shape == (k, 1, cout)
    _close_to_max(dw, occupancy_conv_dw_plain(sbits, g, k), 1e-4)


@pytest.mark.parametrize("key,k", [("s1->s1/k5d1", 125), ("s1->s1/k3d1", 27)])
@pytest.mark.parametrize("gated", [False, True])
def test_scalar_conv_kernels_match_plain(dev, key, k, gated):
    """K4 and K5 on a dense random x; with the row flag and x zero off the
    flagged cloud, K4 gives the same bits as without the flag."""
    gr = _graph(dev, seed=2)
    lv = gr.levels[1]
    n = lv.coords.shape[0]
    gen = torch.Generator().manual_seed(k)
    x = torch.randn(n, 1, generator=gen).to(dev)
    w = torch.randn(k, 1, 32, generator=gen).to(dev)
    g = torch.randn(32, n, generator=gen).to(dev).T
    sel = None
    if gated:
        sel = (lv.coords[:, 0] == 1).to(torch.float32)
        x = x * sel[:, None]
    geo = (gr.maps[key].c1z, lv.skeys, lv.srow)
    b4, b5 = scalar_conv_fwd.launches, scalar_conv_dw.launches
    out = scalar_conv_fwd(x, w, *geo, sel)
    dw = scalar_conv_dw(x, g, *geo, k, sel)
    torch.cuda.synchronize()
    assert (scalar_conv_fwd.launches, scalar_conv_dw.launches) == (b4 + 1,
                                                                   b5 + 1)
    _close_to_max(out, scalar_conv_fwd_plain(x, w, *geo, sel), 1e-4)
    _close_to_max(dw, scalar_conv_dw_plain(x, g, *geo, k, sel), 1e-4)
    if gated:
        assert torch.equal(out, scalar_conv_fwd(x, w, *geo, None))
        _close_to_max(dw, scalar_conv_dw(x, g, *geo, k, None), 1e-5)


@pytest.mark.parametrize("key,k", [("s1->s1/k5d1", 125), ("s1->s1/k3d1", 27)])
@pytest.mark.parametrize("cout", [32, 20, 70])
@pytest.mark.parametrize("gated", [False, True])
def test_scalar_conv_dx_kernel_matches_plain(dev, key, k, cout, gated):
    """K9 within 1e-4 of the max (float32 FMAs in another order than the
    plain version's matmul), with a row flag that varies inside a cloud,
    and by the adjoint identity with K4: <K4(x), g> == <x, K9(g)>."""
    gr = _graph(dev, seed=2)
    lv = gr.levels[1]
    n = lv.coords.shape[0]
    gen = torch.Generator().manual_seed(k + cout)
    x = torch.randn(n, 1, generator=gen).to(dev)
    w = torch.randn(k, 1, cout, generator=gen).to(dev)       # not symmetric
    g = torch.randn(cout, n, generator=gen).to(dev).T        # not contiguous
    sel = (torch.rand(n, generator=gen) > 0.4).float().to(dev) if gated \
        else None
    geo = (gr.maps[key].c1z, lv.skeys, lv.srow, sel)
    before = scalar_conv_dx.launches
    dx = scalar_conv_dx(g, w, *geo)
    torch.cuda.synchronize()
    assert scalar_conv_dx.launches == before + 1 and dx.shape == (n, 1)
    _close_to_max(dx, scalar_conv_dx_plain(g, w, *geo), 1e-4)
    out = scalar_conv_fwd(x, w, *geo)
    lhs, rhs = float((out * g).sum()), float((x * dx).sum())
    assert abs(lhs - rhs) <= 1e-4 * float((out.abs() * g.abs()).sum())


def _search_inputs(dev, seed, s_n, q_n, t_n, spread=1.2):
    gen = torch.Generator().manual_seed(seed)
    q = (torch.randn(s_n, q_n, 3, generator=gen) * spread).to(dev)
    t = (torch.randn(s_n, t_n, 3, generator=gen) * spread).to(dev)
    qm = (torch.rand(s_n, q_n, generator=gen) > 0.1).to(dev)
    tm = (torch.rand(s_n, t_n, generator=gen) > 0.1).to(dev)
    return q, qm, t, tm


def _topk_arrays(q, qm, t, tm, r, cell):
    """The prepared arrays windowed_cell_topk is given, captured from
    _batched_grid_core."""
    from gcl_tpu_torch.kernels import radius_topk
    seen = []
    real = radius_topk.windowed_cell_topk
    radius_topk.windowed_cell_topk = lambda *a: seen.append(a) or real(*a)
    try:
        _batched_grid_core(q, qm, t, tm, r, 5, cell, presorted=False)
    finally:
        radius_topk.windowed_cell_topk = real
    return seen[0][:6]


@pytest.mark.parametrize("s_n,q_n,t_n,kn", [
    (3, 300, 600, 5), (2, 1000, 777, 8), (1, 129, 4099, 1), (4, 64, 33, 4)])
def test_windowed_topk_kernel_matches_plain(dev, s_n, q_n, t_n, kn):
    """K1: rows equal and d2 equal bit for bit (the kernel forbids the FMA
    contraction that would move a candidate into the next bin)."""
    q, qm, t, tm = _search_inputs(dev, q_n, s_n, q_n, t_n)
    r = torch.linspace(0.3, 0.5, s_n, device=dev)
    arrays = _topk_arrays(q, qm, t, tm, r, 1.0)
    before = (windowed_cell_topk_packed.launches,
              windowed_cell_topk_exact.launches)
    rows, d2 = windowed_cell_topk(*arrays, kn)
    torch.cuda.synchronize()
    assert (windowed_cell_topk_packed.launches,
            windowed_cell_topk_exact.launches) == (before[0] + 1, before[1])
    prow, pd2 = windowed_cell_topk_plain(*arrays, kn)
    assert torch.equal(rows, prow)
    assert torch.equal(d2.view(torch.int32), pd2.view(torch.int32))
    assert int((rows >= 0).sum()) > 20


def test_windowed_topk_crowded_cells(dev):
    """Hundreds of targets in a cell, far more than kn, and every query in
    the same few cells: each run is read to its end."""
    q, qm, t, tm = _search_inputs(dev, 5, 2, 500, 3000, spread=0.4)
    r = torch.tensor([0.5, 0.2], device=dev)
    arrays = _topk_arrays(q, qm, t, tm, r, 1.0)
    rows, d2 = windowed_cell_topk(*arrays, 8)
    prow, pd2 = windowed_cell_topk_plain(*arrays, 8)
    assert torch.equal(rows, prow)
    assert torch.equal(d2.view(torch.int32), pd2.view(torch.int32))
    # and the hit counts are the brute-force search's
    idx, hit = batched_grid_radius_knn(q, qm, t, tm, r, 8, 1.0)
    for s in range(2):
        _, bhit = radius_knn(q[s], qm[s], t[s], tm[s], r[s], 8)
        agree = (hit[s].sum(-1) == bhit.sum(-1)).float().mean()
        assert float(agree) > 0.99


def test_windowed_topk_exact_kernel_matches_plain(dev):
    """K11 (T > 2^19): rows and exact d2 equal; duplicated targets make
    exact ties, which go to the lower sorted position in both."""
    t_n = (1 << 19) + 7
    q, qm, t, tm = _search_inputs(dev, 9, 2, 700, t_n, spread=3.0)
    t[:, 1::2] = t[:, 0::2][:, :t[:, 1::2].shape[1]]         # duplicates
    r = torch.tensor([0.5, 0.4], device=dev)
    arrays = _topk_arrays(q, qm, t, tm, r, 1.0)
    before = windowed_cell_topk_exact.launches
    rows, d2 = windowed_cell_topk(*arrays, 5)
    torch.cuda.synchronize()
    assert windowed_cell_topk_exact.launches == before + 1
    prow, pd2 = windowed_cell_topk_plain(*arrays, 5)
    assert torch.equal(rows, prow)
    assert torch.equal(d2.view(torch.int32), pd2.view(torch.int32))
    ties = (d2[..., 1:] == d2[..., :-1]) & (rows[..., 1:] >= 0)
    assert int(ties.sum()) > 100 and int((rows >= 0).sum()) > 1000


def test_windowed_topk_exact_cross_chunk_ties(dev):
    """K11 (T just over 2^19) on ties that enter a window chunk after
    another chunk has filled the slots: rows and d2 equal to the plain
    version's bit for bit, in gcl_tpu's order (the last tie entered
    first), as tests/test_torch_radius_topk.py holds the plain version to
    gcl_tpu's kernel in interpret mode."""
    from gcl_tpu_torch.kernels.radius_topk import (cross_chunk_ties,
                                                   exact_window_starts)
    q, qm, t, tm = _search_inputs(dev, 11, 1, 300, (1 << 19) + 7)
    arrays = _topk_arrays(q, qm, t, tm, torch.tensor([0.5], device=dev),
                          1.0)
    first = int(torch.nonzero(arrays[3][0] != 0x7FFFFFFF)[0, 0])
    arrays, pos = cross_chunk_ties(arrays, first)
    start = int(exact_window_starts(arrays[0], arrays[3])[0, first])
    assert (pos + 4 - start) // 2048 < (pos + 2100 - start) // 2048
    before = windowed_cell_topk_exact.launches
    rows, d2 = windowed_cell_topk(*arrays, 5)
    torch.cuda.synchronize()
    assert windowed_cell_topk_exact.launches == before + 1
    prow, pd2 = windowed_cell_topk_plain(*arrays, 5)
    assert torch.equal(rows, prow)
    assert torch.equal(d2.view(torch.int32), pd2.view(torch.int32))
    assert torch.equal(rows[0, first],
                       arrays[1][0, pos + 2100:pos + 2105].flip(0))


def test_groups_on_the_grid_on_card_match_cpu(dev):
    """batch_colocation_groups(cell=...) with K1 on the card against the
    plain version on the CPU: every field equal."""
    pts, pmask = clouds(21, 6, 900)
    trans = torch.eye(4).repeat(2, 3, 1, 1)
    trans[:, 1, 0, 3], trans[:, 2, 1, 3] = 0.4, -0.3
    out = []
    for d in (dev, torch.device("cpu")):
        vox = voxelize_per_cloud(torch.from_numpy(pts).to(d),
                                 torch.from_numpy(pmask).to(d), VOXEL, 600)
        vox_b = type(vox)(vox.coords.reshape(2, 3, 600, 4),
                          vox.mask.reshape(2, 3, 600),
                          vox.xyz.reshape(2, 3, 600, 3))
        out.append(batch_colocation_groups(
            vox_b, trans.to(d), torch.tensor([0.45, 0.7], device=d), k=5,
            cell=1.2))
    for name in ("member_idx", "member_mask", "finest_pos", "valid",
                 "anchor_xyz", "anchor_item"):
        assert torch.equal(getattr(out[0], name).cpu(), getattr(out[1], name))
    assert int(out[1].valid.sum()) > 100


def test_train_mode_gradients_on_card_match_cpu(dev):
    """ResUNetFatBN in train mode with exact jitter: every parameter
    gradient from the kernels on the card against the plain versions on the
    CPU, within 1e-3 of the tensor's max (23 convs and 21 batch norms of
    float32 sums in another order)."""
    pts, pmask = clouds(3, 2, 900)
    specs = fatbn_specs()
    caps = {2: 512, 4: 384, 8: 256}
    rng = torch.Generator().manual_seed(0)
    normal = torch.randn(1200, 1, generator=rng)
    target = torch.randn(1200, 32, generator=rng)
    grads = []
    for d in (dev, torch.device("cpu")):
        model = ResUNetFatBN(1, 32, bn_momentum=0.05,
                             normalize_feature=True, conv1_kernel_size=5)
        model.load_state_dict(random_state_dict(model, seed=5))
        model.to(d).train()
        vox = voxelize_per_cloud(torch.from_numpy(pts).to(d),
                                 torch.from_numpy(pmask).to(d), VOXEL, 600)
        flat = vox.flatten()
        gr = build_graph(flat.coords, flat.mask, specs, caps, 2)
        sel = (flat.coords[:, 0] == 0).to(torch.float32)
        f = model(gr, flat.feats, conv1_jitter=(0.01, 1.0, sel, True),
                  jitter_draws=(torch.zeros((), device=d), normal.to(d)))
        ((f * target.to(d)) * flat.mask[:, None]).sum().backward()
        grads.append({k: p.grad.cpu() for k, p in model.named_parameters()})
    assert grads[0].keys() == grads[1].keys()
    for name in grads[0]:
        _close_to_max(grads[0][name], grads[1][name], 1e-3)


def test_wrappers_raise_instead_of_falling_back(dev):
    g = _graph(dev)
    lv = g.levels[1]
    x = torch.randn(8, lv.coords.shape[0], device=dev).T  # not contiguous
    w = torch.randn(27, 8, 16, device=dev)
    before = sparse_conv_implicit_fwd.launches
    with pytest.raises(ValueError, match="contiguous"):
        sparse_conv_implicit_fwd(x, w, g.maps["s1->s1/k3d1"].qkey, lv.skeys,
                                 lv.srow)
    with pytest.raises(ValueError, match="on cpu"):
        sparse_conv_implicit_fwd(x.contiguous(), w.cpu(),
                                 g.maps["s1->s1/k3d1"].qkey, lv.skeys,
                                 lv.srow)
    assert sparse_conv_implicit_fwd.launches == before


def test_features_on_card_match_cpu(dev):
    """ResUNetFatBN features: kernels on the card against the plain
    versions on the CPU, one set of weights; 1e-4 abs on unit-norm
    features."""
    pts, pmask = clouds(3, 2, 900)
    specs = fatbn_specs()
    caps = {2: 512, 4: 384, 8: 256}
    feats = []
    for d in (dev, torch.device("cpu")):
        model = ResUNetFatBN(1, 32, bn_momentum=0.05,
                             normalize_feature=True, conv1_kernel_size=5)
        model.load_state_dict(random_state_dict(model, seed=5))
        extract = make_feature_extractor(model.to(d), specs, VOXEL, 600,
                                         caps)
        _, f = extract(torch.from_numpy(pts).to(d),
                       torch.from_numpy(pmask).to(d))
        feats.append(f.cpu())
    torch.testing.assert_close(feats[0], feats[1], rtol=0, atol=1e-4)


# --- the explicit route: K10, the index-table forward (K12) and K8 ---

TABLE_SPECS = SPECS + [ConvSpec("block2", 2, 2, 3), ConvSpec("even", 1, 2, 2)]


def _table_graph(dev, n_clouds, seed=0, n_points=900, nv=600, cap2=500):
    """The clouds and capacities of _graph by default, on the explicit
    route."""
    pts, pmask = clouds(seed, n_clouds, n_points)
    vox = voxelize_per_cloud(torch.from_numpy(pts).to(dev),
                             torch.from_numpy(pmask).to(dev), VOXEL, nv)
    flat = vox.flatten()
    return build_graph(flat.coords, flat.mask, TABLE_SPECS,
                       {2: cap2}, n_clouds, method="explicit")


@pytest.mark.parametrize("n_clouds,n_points,nv", [(3, 900, 600),
                                                  (40, 200, 90)])
def test_join_kernel_matches_plain(dev, n_clouds, n_points, nv):
    """K10: every table of a graph equals the plain version's, on blocked
    levels (3 clouds) and unblocked ones (40 clouds); sentinel queries and
    the padded tail of the keys give -1."""
    before = join_kmap.launches
    g = _table_graph(dev, n_clouds, 4, n_points, nv, nv * n_clouds)
    torch.cuda.synchronize()
    assert join_kmap.launches == before + 6 and len(g.kmaps) == 6
    for sp in TABLE_SPECS:
        lv = g.levels[sp.in_stride]
        offs = kernel_maps.kernel_offsets(sp.kernel_size) * sp.offset_scale
        qhi, qlo = kernel_maps.two_word_query_keys(g.levels[sp.out_stride],
                                                   sp.in_stride, offs)
        ref = join_kmap_plain(lv.key_hi, lv.key_lo, lv.perm, qhi, qlo)
        assert torch.equal(g.kmaps[sp.key], ref), sp.key
        assert int((ref >= 0).sum()) > 100
        assert (ref[qhi == 0x7FFFFFFF] == -1).all()
    if n_clouds > 31:
        cloud = g.levels[1].coords[:, 0]
        late = (cloud >= 31) & g.levels[1].mask
        assert (g.kmaps["s1->s1/k3d1"][13][late]
                == torch.nonzero(late).flatten()).all()


TABLE_CASES = [("s1->s1/k3d1", 32, 32), ("s1->s2/k3d1", 40, 72),
               ("s2->s1/k3d1", 100, 24), ("s1->s1/k3d1", 130, 200),
               ("s1->s2/k3d1", 70, 300), ("s1->s1/k3d1", 1, 1),
               ("s1->s1/k5d1", 1, 32), ("s1->s2/k2d1", 8, 12)]


def _table_inputs(g, key, cin, cout, dev):
    s_in, s_out = (int(t[1:]) for t in key.split("/")[0].split("->"))
    kvol = g.kmaps[key].shape[0]
    gen = torch.Generator().manual_seed(cin + cout)
    x = torch.randn(g.levels[s_in].coords.shape[0], cin, generator=gen)
    up = torch.randn(cout, g.levels[s_out].coords.shape[0], generator=gen)
    w = torch.randn(kvol, cin, cout, generator=gen)
    return x.to(dev), up.to(dev).T, w.to(dev), (s_in, s_out)


@pytest.mark.parametrize("key,cin,cout", TABLE_CASES)
def test_table_conv_kernel_matches_plain(dev, key, cin, cout):
    """The index-table forward within 1e-4 of the plain version's max
    (float32 FMAs in another order than its per-offset matmuls)."""
    g = _table_graph(dev, 3)
    x, _, w, _ = _table_inputs(g, key, cin, cout, dev)
    before = sparse_conv_table_fwd.launches
    out = sparse_conv_table_fwd(x, w, g.kmaps[key])
    torch.cuda.synchronize()
    assert sparse_conv_table_fwd.launches == before + 1
    _close_to_max(out, sparse_conv_table_fwd_plain(x, w, g.kmaps[key]), 1e-4)


@pytest.mark.parametrize("key,cin,cout", TABLE_CASES)
def test_dw_kernel_matches_plain(dev, key, cin, cout):
    """K8 over an index table and, for the odd kernels, over the implicit
    map of the same geometry: within 1e-4 of the plain version's max (dW
    summed over blocks by atomics), and of each other."""
    g = _table_graph(dev, 3)
    x, up, _, (s_in, _) = _table_inputs(g, key, cin, cout, dev)
    assert cout == 1 or not up.is_contiguous()
    before = sparse_conv_dw.launches
    dw = sparse_conv_dw(x, up, g.kmaps[key])
    torch.cuda.synchronize()
    assert sparse_conv_dw.launches == before + 1
    assert dw.shape == (g.kmaps[key].shape[0], cin, cout)
    _close_to_max(dw, sparse_conv_dw_plain(x, up, g.kmaps[key]), 1e-4)
    if "k2" in key:
        return
    gi = _graph(dev)  # the same clouds on the implicit route
    lv = gi.levels[s_in]
    dwi = sparse_conv_dw(x, up, gi.maps[key].qkey, lv.skeys, lv.srow)
    _close_to_max(dwi, sparse_conv_dw_plain(x, up, gi.maps[key].qkey,
                                            lv.skeys, lv.srow), 1e-4)
    _close_to_max(dwi, dw, 1e-4)


@pytest.mark.parametrize("key,cin,cout", TABLE_CASES[:3] + TABLE_CASES[-2:])
def test_table_conv_gradients_on_card(dev, key, cin, cout):
    """sparse_conv through autograd on the card (K12 + K12 through the
    reverse table + K8, or the scatter-add for the even kernel) against the
    same Function on the plain versions; and the implicit route's two-pass
    backward (K6 + K8) against its one-pass backward (K7)."""
    g = _table_graph(dev, 3)
    x, up, w, (s_in, s_out) = _table_inputs(g, key, cin, cout, dev)
    rev = g.kmaps.get(f"s{s_out}->s{s_in}/{key.split('/')[1]}") \
        if "k2" not in key else None

    def grads(fn):
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        out = fn(xr, wr)
        out.backward(up)
        return out.detach(), xr.grad, wr.grad

    got = grads(lambda x, w: sparse_ops.sparse_conv(x, w, g.kmaps[key], rev))
    saved = {n: getattr(sparse_ops, n) for n in ("sparse_conv_table_fwd",
                                                 "sparse_conv_dw")}
    try:
        sparse_ops.sparse_conv_table_fwd = sparse_conv_table_fwd_plain
        sparse_ops.sparse_conv_dw = sparse_conv_dw_plain
        ref = grads(lambda x, w: sparse_ops.sparse_conv(x, w, g.kmaps[key],
                                                        rev))
    finally:
        for n, fn in saved.items():
            setattr(sparse_ops, n, fn)
    for a, b in zip(got, ref):
        _close_to_max(a, b, 1e-4)
    if rev is None or "k5" in key:
        return
    gi = _graph(dev)
    lv_in, lv_out = gi.levels[s_in], gi.levels[s_out]
    one, two = (grads(lambda x, w: sparse_ops.sparse_conv_implicit(
        x, w, gi.maps[key], lv_in, lv_out, two_pass_backward=tp))
        for tp in (False, True))
    for a, b, c in zip(one, two, got):
        _close_to_max(b, a, 1e-4)
        _close_to_max(c, a, 1e-4)


def test_explicit_route_gradients_on_card_match_cpu(dev, monkeypatch):
    """ResUNetFatBN in train mode on the explicit route, 40 clouds, with
    the input jitter, forward and backward on the card.

    Every launch of K10, K12 and K8 inside it is held to its plain version
    on the very same inputs (integers equal, floats within 1e-4 of the
    max); the features agree with the plain versions on the CPU within
    1e-4 (unit-norm rows). The parameter gradients of the two whole runs
    are held to 0.1 of each tensor's max only: a ReLU input within float32
    rounding of zero opens on one machine and not on the other and moves a
    channel's gradient by percents (2e-2 was seen here between the plain
    versions on the card and on the CPU; the card against itself repeats
    to 5e-7)."""
    calls = {}

    def checked(name, fn, plain):
        def both(*args):
            got, ref = fn(*args), plain(*args)
            if got.dtype == torch.int32:
                assert torch.equal(got, ref), name
            else:
                _close_to_max(got, ref, 1e-4)
            calls[name] = calls.get(name, 0) + 1
            return got
        return both

    n_clouds, nv = 40, 90
    pts, pmask = clouds(3, n_clouds, 200)
    specs = fatbn_specs()
    n = n_clouds * nv
    caps = {2: n, 4: n, 8: n}
    rng = torch.Generator().manual_seed(0)
    normal = torch.randn(n, 1, generator=rng)
    target = torch.randn(n, 32, generator=rng)
    feats, grads = [], []
    for d in (dev, torch.device("cpu")):
        if d.type == "cuda":
            monkeypatch.setattr(kernel_maps, "join_kmap", checked(
                "K10", join_kmap, join_kmap_plain))
            monkeypatch.setattr(sparse_ops, "sparse_conv_table_fwd", checked(
                "K12", sparse_conv_table_fwd, sparse_conv_table_fwd_plain))
            monkeypatch.setattr(sparse_ops, "sparse_conv_dw", checked(
                "K8", sparse_conv_dw, sparse_conv_dw_plain))
        model = ResUNetFatBN(1, 32, bn_momentum=0.05,
                             normalize_feature=True, conv1_kernel_size=5)
        model.load_state_dict(random_state_dict(model, seed=5))
        model.to(d).train()
        vox = voxelize_per_cloud(torch.from_numpy(pts).to(d),
                                 torch.from_numpy(pmask).to(d), VOXEL, nv)
        flat = vox.flatten()
        gr = build_graph(flat.coords, flat.mask, specs, caps, n_clouds)
        assert not gr.maps and len(gr.kmaps) == 11
        sel = (flat.coords[:, 0] % 7 == 0).to(torch.float32)
        f = model(gr, flat.feats, conv1_jitter=(0.01, 1.0, sel, True),
                  jitter_draws=(torch.zeros((), device=d), normal.to(d)))
        ((f * target.to(d)) * flat.mask[:, None]).sum().backward()
        feats.append(f.detach().cpu())
        grads.append({k: p.grad.cpu() for k, p in model.named_parameters()})
        monkeypatch.undo()
    assert calls == {"K10": 11, "K12": 41, "K8": 21}
    torch.testing.assert_close(feats[0], feats[1], rtol=0, atol=1e-4)
    for name in grads[0]:
        _close_to_max(grads[0][name], grads[1][name], 0.1)


# --- the tensor-core gather-GEMM (K6, K12 and K7's dX) and K7's split-K dW
# on synthetic maps: matched rows per (64-row tile, offset) at the 16-row
# fragment edges, a fully dense map, pads only ---

def _synthetic_rows(kvol, n_rows, n_src, pattern, seed):
    """int64 [K, n_rows]: the input row of each (offset, output row), -1
    for none. 'edges': offset 0 matches 0, 16 and 17 rows of the first
    three 64-row tiles (and some of the ragged last one), offset 1 one row
    of tile 0, the rest a quarter of the pairs; 'dense': every pair;
    'pads': none."""
    gen = torch.Generator().manual_seed(seed)
    rows = torch.randint(0, n_src, (kvol, n_rows), generator=gen)
    if pattern == "dense":
        return rows
    if pattern == "pads":
        return torch.full_like(rows, -1)
    keep = torch.rand((kvol, n_rows), generator=gen) < 0.25
    keep[0] = False
    for tile, count in ((1, 16), (2, 17), (3, 5)):
        pick = torch.randperm(64, generator=gen)[:count] + 64 * tile
        keep[0, pick[pick < n_rows]] = True
    keep[1, :64] = False
    keep[1, 37] = True
    return torch.where(keep, rows, -1)


def _as_keys(rows, n_src, seed):
    """The rows as an implicit map: sorted keys of the n_src input rows
    (srow a permutation of them) and the query key of every pair, a key
    that is not there for none."""
    gen = torch.Generator().manual_seed(seed + 1)
    skeys = (torch.arange(n_src) * 3 + 7).to(torch.int32)
    srow = torch.randperm(n_src, generator=gen).to(torch.int32)
    key_of_row = torch.empty(n_src, dtype=torch.int32)
    key_of_row[srow.long()] = skeys
    qkey = torch.where(rows >= 0, key_of_row[rows.clamp_min(0)],
                       torch.tensor(-5, dtype=torch.int32))
    return qkey.to(torch.int32), skeys, srow


SYNTH_WIDTHS = [(32, 32), (32, 384), (192, 128), (384, 128), (128, 256),
                (384, 384)]


@pytest.mark.parametrize("pattern", ["edges", "dense", "pads"])
@pytest.mark.parametrize("cin,cout", SYNTH_WIDTHS)
def test_gather_gemm_forward_on_synthetic_maps(dev, pattern, cin, cout):
    """K6 and K12 within 1e-4 of the plain version's max (exact zeros for
    pads only), N = 3 tiles of 64 + 13 rows; K6 repeats bit for bit."""
    kvol, n_out, n_in = 27, 3 * 64 + 13, 150
    rows = _synthetic_rows(kvol, n_out, n_in, pattern, cin + cout)
    qkey, skeys, srow = _as_keys(rows, n_in, cin)
    gen = torch.Generator().manual_seed(cout)
    x = torch.randn(n_in, cin, generator=gen).to(dev)
    w = (torch.randn(kvol, cin, cout, generator=gen) / cin ** .5).to(dev)
    args = (x, w, qkey.to(dev), skeys.to(dev), srow.to(dev))
    # a miss outside [0, n_in) on the table as well as -1
    idx = torch.where((rows < 0) & (torch.arange(n_out) % 2 == 0), n_in + 3,
                      rows).to(torch.int32).to(dev)
    before = (sparse_conv_implicit_fwd.launches,
              sparse_conv_table_fwd.launches)
    out = sparse_conv_implicit_fwd(*args)
    again = sparse_conv_implicit_fwd(*args)
    tab = sparse_conv_table_fwd(x, w, idx)
    torch.cuda.synchronize()
    assert (sparse_conv_implicit_fwd.launches,
            sparse_conv_table_fwd.launches) == (before[0] + 2, before[1] + 1)
    assert torch.equal(out.view(torch.int32), again.view(torch.int32))
    ref = sparse_conv_implicit_fwd_plain(*args)
    if pattern == "pads":
        assert not out.any() and not tab.any()
        return
    _close_to_max(out, ref, 1e-4)
    _close_to_max(tab, sparse_conv_table_fwd_plain(x, w, idx), 1e-4)
    _close_to_max(tab, ref, 1e-4)


@pytest.mark.parametrize("pattern", ["edges", "dense"])
@pytest.mark.parametrize("cin,cout", [(1, 32), (1, 1), (4, 24)])
@pytest.mark.parametrize("kvol", [27, 125])
def test_gather_gemm_table_narrow_input(dev, pattern, cin, cout, kvol):
    """K12 with Cin < 8 (conv1 of the explicit route: Cin 1, K 125)."""
    n_out, n_in = 2 * 64 + 50, 170
    rows = _synthetic_rows(kvol, n_out, n_in, pattern, kvol + cin)
    gen = torch.Generator().manual_seed(cout)
    x = torch.randn(n_in, cin, generator=gen).to(dev)
    w = torch.randn(kvol, cin, cout, generator=gen).to(dev)
    idx = rows.to(torch.int32).to(dev)
    out = sparse_conv_table_fwd(x, w, idx)
    _close_to_max(out, sparse_conv_table_fwd_plain(x, w, idx), 1e-4)


@pytest.mark.parametrize("pattern", ["edges", "dense", "pads"])
@pytest.mark.parametrize("cin,cout", SYNTH_WIDTHS)
@pytest.mark.parametrize("want_dx", [True, False])
def test_backward_on_synthetic_maps(dev, pattern, cin, cout, want_dx):
    """K7's dX (the gather-GEMM through W[K-1-k']^T) and dW (split-K over
    the compacted rows, atomics between chunks) within 1e-4 of the plain
    version's max; zeros for pads only. N_in = 4 tiles of 64 + 9 rows."""
    kvol, n_in, n_out = 27, 4 * 64 + 9, 140
    rows = _synthetic_rows(kvol, n_in, n_out, pattern, cin * cout)
    rqkey, skeys, srow = _as_keys(rows, n_out, cout)
    gen = torch.Generator().manual_seed(cin)
    x = torch.randn(n_in, cin, generator=gen).to(dev)
    g = torch.randn(n_out, cout, generator=gen).to(dev)
    w = (torch.randn(kvol, cin, cout, generator=gen) / cout ** .5).to(dev)
    args = (x, g, w, rqkey.to(dev), skeys.to(dev), srow.to(dev))
    before = sparse_conv_implicit_bwd.launches
    dx, dw = sparse_conv_implicit_bwd(*args, want_dx=want_dx)
    torch.cuda.synchronize()
    assert sparse_conv_implicit_bwd.launches == before + 1
    assert (dx is None) == (not want_dx)
    if pattern == "pads":
        assert not dw.any() and (dx is None or not dx.any())
        return
    rdx, rdw = sparse_conv_implicit_bwd_plain(*args, want_dx=want_dx)
    _close_to_max(dw, rdw, 1e-4)
    if want_dx:
        _close_to_max(dx, rdx, 1e-4)


@pytest.mark.parametrize("pattern", ["edges", "dense", "pads"])
@pytest.mark.parametrize("cin,cout", [(32, 32), (192, 128), (128, 384)])
def test_gather_gemm_counts_the_rows_it_multiplies(dev, pattern, cin, cout):
    """The rows that K6, K12 and K7's dX count inside counted_gather_rows
    are compacted_rows' executed rows of their map (per 64-row tile and
    offset the matches rounded up to 16: 0, 16 and 32 for the 0, 16 and 17
    of the edges; an output wider than 256 columns counted once), dW and
    launches outside the block count nothing."""
    kvol, n, n_src = 27, 3 * 64 + 13, 150
    rows = _synthetic_rows(kvol, n, n_src, pattern, cin + cout)
    qkey, skeys, srow = _as_keys(rows, n_src, cin)
    _, executed = compacted_rows(rows >= 0)
    gen = torch.Generator().manual_seed(cout)
    x = torch.randn(n_src, cin, generator=gen).to(dev)
    w = torch.randn(kvol, cin, cout, generator=gen).to(dev)
    xb = torch.randn(n, cin, generator=gen).to(dev)
    g = torch.randn(n_src, cout, generator=gen).to(dev)
    fwd = (x, w, qkey.to(dev), skeys.to(dev), srow.to(dev))
    bwd = (xb, g, w, qkey.to(dev), skeys.to(dev), srow.to(dev))
    counts = []
    for launch in (lambda: sparse_conv_implicit_fwd(*fwd),
                   lambda: sparse_conv_table_fwd(x, w, rows.to(torch.int32)
                                                 .to(dev)),
                   lambda: sparse_conv_implicit_bwd(*bwd),
                   lambda: sparse_conv_implicit_bwd(*bwd, want_dx=False)):
        launch()
        with counted_gather_rows(dev) as counter:
            launch()
        launch()
        torch.cuda.synchronize()
        counts.append(int(counter.item()))
    assert counts == [executed, executed, executed, 0]



# --- ResUNetFatBNEXP's geometry: levels at strides 1, 3, 9, 27 and k = 5
# strided and transposed convs (125 offsets, sparse matches a tile) ---

def _exp_graph(dev, seed=3, n_clouds=2):
    from gcl_tpu_torch.models.resunet import ResUNetFatBNEXP
    pts, pmask = clouds(seed, n_clouds, 2500)
    pts = pts * np.float32(3.0)  # spread out: many stride-27 voxels
    vox = voxelize_per_cloud(torch.from_numpy(pts).to(dev),
                             torch.from_numpy(pmask).to(dev), VOXEL, 1600)
    flat = vox.flatten()
    return build_graph(flat.coords, flat.mask, ResUNetFatBNEXP.conv_specs(5),
                       {3: 900, 9: 400, 27: 160}, n_clouds)


@pytest.mark.parametrize("key,cin,cout", [
    ("s1->s3/k5d1", 32, 64), ("s27->s9/k5d1", 256, 256),
    ("s9->s3/k5d1", 384, 128), ("s3->s1/k5d1", 192, 128),
    ("s3->s9/k5d1", 64, 128), ("s9->s27/k5d1", 128, 256)])
def test_exp_k5_convs_match_plain(dev, key, cin, cout):
    """K6 on EXP's six k = 5 geometries at their real widths, within 1e-4
    of the max of its plain version, and the rows it multiplies equal to
    compacted_rows' count of the map (the matched rows of a 64-row tile
    and offset, rounded up to 16)."""
    from gcl_tpu_torch.core.coords import lookup
    g = _exp_graph(dev)
    in_s = int(key.split("->")[0][1:])
    lv = g.levels[in_s]
    gen = torch.Generator().manual_seed(cin + cout)
    x = (torch.randn(lv.coords.shape[0], cin, generator=gen).to(dev)
         * lv.mask[:, None])
    w = torch.randn(125, cin, cout, generator=gen).to(dev) / (125 * cin) ** .5
    args = (x, w, g.maps[key].qkey, lv.skeys, lv.srow)
    before = sparse_conv_implicit_fwd.launches
    out = sparse_conv_implicit_fwd(*args)
    torch.cuda.synchronize()
    assert sparse_conv_implicit_fwd.launches == before + 1
    _close_to_max(out, sparse_conv_implicit_fwd_plain(*args), 1e-4)
    hit = lookup(lv.skeys, lv.srow, args[2]) >= 0
    matched, executed = compacted_rows(hit)
    assert matched > 0
    with counted_gather_rows(dev) as counter:
        sparse_conv_implicit_fwd(*args)
    torch.cuda.synchronize()
    assert int(counter.item()) == executed


def test_exp_conv1_occupancy_kernel_matches_plain(dev):
    """K2 at EXP's conv1 (k = 5, 1 -> 32) on EXP's stride-1 level."""
    g = _exp_graph(dev, seed=4)
    w = torch.randn(125, 1, 32, generator=torch.Generator().manual_seed(5))
    args = (g.maps["s1->s1/k5d1"].c1z, g.levels[1].skeys, w.to(dev))
    out, sbits = occupancy_conv_fwd(*args)
    ref, ref_bits = occupancy_conv_fwd_plain(*args)
    assert torch.equal(sbits, ref_bits) and sbits.any()
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)


def test_exp_features_on_card_match_cpu(dev):
    """A full-width ResUNetFatBNEXP in eval mode on the card (K2 and K6)
    against the same model on the CPU (plain versions): features within
    1e-3, exactly 1 K2 and 20 K6 launches."""
    from gcl_tpu_torch.infer import serving_extractor, serving_model
    from gcl_tpu_torch.kernels import launch_counts, reset_launch_counts
    from gcl_tpu_torch.models.resunet import ResUNetFatBNEXP
    pts, pmask = clouds(6, 2, 2500)
    pts = torch.from_numpy(pts * np.float32(3.0))
    pmask = torch.from_numpy(pmask)
    out = {}
    for d in ("cpu", dev):
        extract = serving_extractor(serving_model(0, d, ResUNetFatBNEXP),
                                    1600)
        reset_launch_counts()
        _, out[str(d)] = extract(pts.to(d), pmask.to(d))
        if d != "cpu":
            torch.cuda.synchronize()
            counts = launch_counts()
            assert counts["K2"] == 1 and counts["K6"] == 20, counts
    err = (out["cuda"].cpu() - out["cpu"]).abs().max()
    assert float(err) < 1e-3

EXP_K5 = [("s1->s3/k5d1", 32, 64), ("s27->s9/k5d1", 256, 256),
          ("s9->s3/k5d1", 384, 128), ("s3->s1/k5d1", 192, 128),
          ("s3->s9/k5d1", 64, 128), ("s9->s27/k5d1", 128, 256)]


@pytest.mark.parametrize("key,cin,cout", EXP_K5)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_exp_k5_backward_matches_plain(dev, key, cin, cout, dtype):
    """K7 (dX and dW in one pass over the reverse map) on EXP's six k = 5
    strided and transposed geometries at their real widths (Cin up to
    384), as the FCGF train step runs them: float32 dX and dW within 1e-4
    of the plain version's max; bf16 dX at the bf16 gate and its float32
    dW within 1e-4. dX also against K6 through the reverse map; the rows
    the dX gather-GEMM multiplies equal compacted_rows' count of the
    reverse map, and the split-K dW stages between the matched pairs and
    1.05 x them + 8 rows a block."""
    from gcl_tpu_torch.core.coords import lookup
    g = _exp_graph(dev)
    s_in, s_out = (int(t[1:]) for t in key.split("/")[0].split("->"))
    lv_in, lv_out = g.levels[s_in], g.levels[s_out]
    gen = torch.Generator().manual_seed(cin * cout)
    x = (torch.randn(lv_in.coords.shape[0], cin, generator=gen).to(dev)
         * lv_in.mask[:, None]).to(dtype)
    gr = (torch.randn(lv_out.coords.shape[0], cout, generator=gen).to(dev)
          * lv_out.mask[:, None]).to(dtype)
    w = torch.randn(125, cin, cout, generator=gen).to(dev) / (125 * cin) ** .5
    rqkey = g.maps[key].rqkey
    args = (x, gr, w, rqkey, lv_out.skeys, lv_out.srow)
    before = sparse_conv_implicit_bwd.launches
    dx, dw = sparse_conv_implicit_bwd(*args)
    torch.cuda.synchronize()
    assert sparse_conv_implicit_bwd.launches == before + 1
    assert dx.dtype == dtype and dw.dtype == torch.float32
    rdx, rdw = sparse_conv_implicit_bwd_plain(*args)
    _close_to_max(dw, rdw, 1e-4)
    two_pass = sparse_conv_implicit_fwd(
        gr, w.flip(0).transpose(1, 2).contiguous(), rqkey, lv_out.skeys,
        lv_out.srow)
    if dtype == torch.float32:
        _close_to_max(dx, rdx, 1e-4)
        _close_to_max(dx, two_pass, 1e-4)
    else:
        bound = _sum_bound(sparse_conv_implicit_bwd_plain, args)
        assert_bf16_close(dx, rdx, "K7 dX", bound)
        assert_bf16_close(dx, two_pass, "K7 dX against K6", bound)
    hit = lookup(lv_out.skeys, lv_out.srow, rqkey) >= 0
    matched, executed = compacted_rows(hit)
    assert matched > 0
    with counted_gather_rows(dev) as counter:
        sparse_conv_implicit_bwd(*args)
    torch.cuda.synchronize()
    assert int(counter.item()) == executed
    with counted_dw_rows(dev) as counter:
        sparse_conv_implicit_bwd(*args)
    torch.cuda.synchronize()
    staged, blocks = (int(v) for v in counter.tolist())
    assert matched <= staged <= 1.05 * matched + 8 * blocks


# --- ResUNetFatBNEXP_V2's extra pair: conv1_extra (1 -> 5, k = 5,
# dilation 5) and conv1_tr_extra (5 -> 1, dilation 4), a geometry no other
# model has: levels at strides 5, 10, 20, 40 and offsets 5 or 4 apart ---

V2_EXTRA = [("s1->s5/k5d5", 32, 32), ("s5->s1/k5d4", 160, 128)]


def _v2_graph(dev, seed=3, n_clouds=2):
    from gcl_tpu_torch.models.resunet import ResUNetFatBNEXP_V2
    pts, pmask = clouds(seed, n_clouds, 2500)
    pts = pts * np.float32(3.0)
    vox = voxelize_per_cloud(torch.from_numpy(pts).to(dev),
                             torch.from_numpy(pmask).to(dev), VOXEL, 1600)
    flat = vox.flatten()
    return build_graph(flat.coords, flat.mask,
                       ResUNetFatBNEXP_V2.conv_specs(5),
                       {5: 600, 10: 300, 20: 160, 40: 80}, n_clouds)


@pytest.mark.parametrize("key,cin,cout", V2_EXTRA)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_v2_extra_convs_match_plain(dev, key, cin, cout, dtype):
    """K6 and K7 on V2's conv1_extra and conv1_tr_extra at their real
    widths: forward, dX and dW against the plain versions (float32 within
    1e-4 of the max; bf16 at the bf16 gate, float32 dW within 1e-4), dX
    also against K6 through the reverse map, and the rows each
    gather-GEMM multiplies equal to compacted_rows' count, the dW's staged
    rows within 1.05 x the matched pairs + 8 a block."""
    from gcl_tpu_torch.core.coords import lookup
    g = _v2_graph(dev)
    s_in, s_out = (int(t[1:]) for t in key.split("/")[0].split("->"))
    lv_in, lv_out = g.levels[s_in], g.levels[s_out]
    gen = torch.Generator().manual_seed(cin + 7 * cout)
    x = (torch.randn(lv_in.coords.shape[0], cin, generator=gen).to(dev)
         * lv_in.mask[:, None]).to(dtype)
    gr = (torch.randn(lv_out.coords.shape[0], cout, generator=gen).to(dev)
          * lv_out.mask[:, None]).to(dtype)
    w = torch.randn(125, cin, cout, generator=gen).to(dev) / (125 * cin) ** .5
    fwd = (x, w, g.maps[key].qkey, lv_in.skeys, lv_in.srow)
    rqkey = g.maps[key].rqkey
    bwd = (x, gr, w, rqkey, lv_out.skeys, lv_out.srow)
    out, ref = sparse_conv_implicit_fwd(*fwd), sparse_conv_implicit_fwd_plain(
        *fwd)
    dx, dw = sparse_conv_implicit_bwd(*bwd)
    rdx, rdw = sparse_conv_implicit_bwd_plain(*bwd)
    two_pass = sparse_conv_implicit_fwd(
        gr, w.flip(0).transpose(1, 2).contiguous(), rqkey, lv_out.skeys,
        lv_out.srow)
    torch.cuda.synchronize()
    _close_to_max(dw, rdw, 1e-4)
    if dtype == torch.float32:
        _close_to_max(out, ref, 1e-4)
        _close_to_max(dx, rdx, 1e-4)
        _close_to_max(dx, two_pass, 1e-4)
    else:
        assert_bf16_close(out, ref, "K6", _sum_bound(
            sparse_conv_implicit_fwd_plain, fwd))
        bound = _sum_bound(sparse_conv_implicit_bwd_plain, bwd)
        assert_bf16_close(dx, rdx, "K7 dX", bound)
        assert_bf16_close(dx, two_pass, "K7 dX against K6", bound)
    for launch, skeys, srow, keys in (
            (lambda: sparse_conv_implicit_fwd(*fwd), lv_in.skeys,
             lv_in.srow, fwd[2]),
            (lambda: sparse_conv_implicit_bwd(*bwd), lv_out.skeys,
             lv_out.srow, rqkey)):
        matched, executed = compacted_rows(lookup(skeys, srow, keys) >= 0)
        assert matched > 0
        with counted_gather_rows(dev) as counter:
            launch()
        torch.cuda.synchronize()
        assert int(counter.item()) == executed
    matched, _ = compacted_rows(lookup(lv_out.skeys, lv_out.srow, rqkey)
                                >= 0)
    with counted_dw_rows(dev) as counter:
        sparse_conv_implicit_bwd(*bwd)
    torch.cuda.synchronize()
    staged, blocks = (int(v) for v in counter.tolist())
    assert matched <= staged <= 1.05 * matched + 8 * blocks


@pytest.mark.parametrize("name,n_conv", [("ResUNetFatBNEXP", 20),
                                         ("ResUNetFatBNEXP_V2", 22),
                                         ("ResUNetIN2E", 20)])
def test_exp_pair_step_on_card_matches_cpu(dev, name, n_conv):
    """One FCGF pair step (hardest contrastive, exact input jitter) of a
    full-width ResUNetFatBNEXP (and of V2 and of the instance-norm
    ResUNetIN2E) on the card against the same step on the CPU from the
    same weights and draws: exactly K2 2, K4 2, K3 2, K5 2 and K6 = K7 =
    2 x its convs on K6 (20; V2 22) launches (both sides; conv1's input
    takes no gradient, so no K9), loss terms within 1e-4."""
    from gcl_tpu_torch.core.kernel_maps import default_level_caps
    from gcl_tpu_torch.kernels import launch_counts, reset_launch_counts
    from gcl_tpu_torch.losses.pairs import PairLossDraws
    from gcl_tpu_torch.models import load_model
    from gcl_tpu_torch.train.steps import (PairDraws, StepConfig, StepDraws,
                                           make_pair_grad_fn)
    cls = load_model(name)
    pts, pmask = clouds(8, 2, 2500)
    pts = pts * np.float32(3.0)
    moved = pts + np.float32([0.6, -0.9, 0.0])
    trans = np.stack([np.eye(4, dtype=np.float32)] * 2)
    trans[:, :3, 3] = [0.6, -0.9, 0.0]
    nv = 1600
    cfg = dict(batch_size=2, num_pos_per_batch=256,
               num_hn_samples_per_batch=128, triplet_num_pos=8,
               triplet_num_hn=8, triplet_num_rand=8, pos_thresh=0.1,
               neg_thresh=1.4, neg_weight=1.0, jitter_feats=True)
    gen = torch.Generator().manual_seed(0)
    sides = [StepDraws(torch.zeros(2), (torch.zeros(()), torch.randn(
        2 * nv, 1, generator=gen))) for _ in range(2)]
    draws = PairDraws(*sides, PairLossDraws(
        pos=torch.rand(512, generator=gen), hn0=torch.rand(256, generator=gen),
        hn1=torch.rand(256, generator=gen)))
    out = {}
    for d in (dev, torch.device("cpu")):
        model = cls(1, 32, bn_momentum=0.05, normalize_feature=True,
                    conv1_kernel_size=5)
        model.load_state_dict(random_state_dict(model, seed=5))
        model.to(d)
        specs = cls.conv_specs(5)
        strides = sorted({s for sp in specs
                          for s in (sp.in_stride, sp.out_stride)})
        caps = ({3: 1800, 9: 800, 27: 320} if name == "ResUNetFatBNEXP"
                else default_level_caps(2 * nv, strides, 0.6))
        step_cfg = StepConfig(voxel_size=VOXEL, nv_cap=nv, level_caps=caps,
                              search_cell=1.08)
        grad_fn = make_pair_grad_fn(model, specs, step_cfg,
                                    "hardest_contrastive", cfg)
        reset_launch_counts()
        m = grad_fn(*(torch.from_numpy(a).to(d) for a in (
            pts, pmask, moved.astype(np.float32), pmask, trans)),
            torch.full((2,), 0.45, device=d),
            draws=PairDraws(*(StepDraws(sd.sample_gate_u.to(d),
                                        tuple(t.to(d) for t in sd.jitter))
                              for sd in draws[:2]),
                            PairLossDraws(*(t.to(d) for t in draws.loss[:3]))))
        if d != torch.device("cpu"):
            torch.cuda.synchronize()
            counts = launch_counts()
            assert {k: v for k, v in counts.items() if v} == {
                "K2": 2, "K4": 2, "K6": 2 * n_conv, "K3": 2, "K5": 2,
                "K7": 2 * n_conv}, counts
        out[d.type] = {k: float(v) for k, v in m.items()}
    assert out["cuda"]["num_pos_pairs"] == out["cpu"]["num_pos_pairs"] > 0
    for k in ("loss", "pos_loss", "neg_loss"):
        assert abs(out["cuda"][k] - out["cpu"][k]) <= 1e-4, (k, out)


# --- the split-K dW core (K8 over forward maps and index tables, K7's dW
# over reverse maps) on synthetic maps: 0, 7, 8, 9 and 33 matched rows per
# offset (around the 8-row rounding and the 32-pair stage), a dense map,
# pads only, and a map of several 2048-row resolve rounds and chunks ---

DW_WIDTHS = [(1, 1), (1, 32), (3, 64), (32, 96), (48, 128), (128, 256),
             (384, 128), (384, 256), (32, 32), (128, 64), (32, 1), (384, 1)]
RESOLVE_ROWS = 2048  # rows a block resolves per round (splitk_dw.cuh)


def _dw_rows(kvol, n_drive, n_src, pattern, seed):
    """int64 [K, n_drive]: the source row of each (offset, driving row),
    -1 for none. 'stages': offset k matches (0, 7, 8, 9, 33)[k % 5] rows;
    'quarter': a quarter of the pairs; 'dense': every pair; 'pads': none."""
    gen = torch.Generator().manual_seed(seed)
    rows = torch.randint(0, n_src, (kvol, n_drive), generator=gen)
    if pattern == "dense":
        return rows
    if pattern == "pads":
        return torch.full_like(rows, -1)
    if pattern == "quarter":
        keep = torch.rand((kvol, n_drive), generator=gen) < 0.25
    else:
        keep = torch.zeros((kvol, n_drive), dtype=torch.bool)
        for k in range(kvol):
            count = (0, 7, 8, 9, 33)[k % 5]
            keep[k, torch.randperm(n_drive, generator=gen)[:count]] = True
    return torch.where(keep, rows, -1)


def _staged_rows(matched):
    """The rows one chunk stages for `matched` pairs of an offset: stages
    of 32 pairs, the last rounded up to 8."""
    return 32 * (matched // 32) + (matched % 32 + 7) // 8 * 8


@pytest.mark.parametrize("pattern", ["stages", "quarter", "dense", "pads"])
@pytest.mark.parametrize("cin,cout", DW_WIDTHS)
@pytest.mark.parametrize("form", ["forward", "table", "reverse"])
def test_splitk_dw_on_synthetic_maps(dev, form, pattern, cin, cout):
    """K8 over a forward implicit map and over an index table (misses as -1,
    N_in and N_in + 3), and K7's dW over the same rows as a reverse map,
    all on the one split-K core: within 1e-4 of the plain version's max
    (atomics between chunks), exact zeros for pads only, a non-contiguous
    g. The staged rows the kernel counts: exactly the stages of 32 pairs
    with the last rounded to 8 where an offset is one chunk (N of 205, not
    a multiple of a resolve round), else between the matched pairs and 7
    more per block; one block per (offset, chunk) with a match. Cin = 1
    takes the core's CUDA-core form, which counts the matched pairs."""
    kvol = 125 if (cin, cout) == (1, 32) else 27   # conv1 of the explicit
    n_drive = 2 * RESOLVE_ROWS + 77 if pattern == "quarter" else 205
    n_src = 150
    rows = _dw_rows(kvol, n_drive, n_src, pattern, cin * 7 + cout)
    gen = torch.Generator().manual_seed(cin + cout)
    n_x, n_g = (n_drive, n_src) if form == "reverse" else (n_src, n_drive)
    x = torch.randn(n_x, cin, generator=gen).to(dev)
    g = torch.randn(cout, n_g, generator=gen).to(dev).T
    assert cout == 1 or not g.is_contiguous()
    if form == "table":
        miss = torch.where(torch.arange(n_drive) % 3 == 0, -1,
                           n_src + torch.arange(n_drive) % 2 * 3)
        args = (x, g, torch.where(rows < 0, miss, rows).to(torch.int32)
                .to(dev))
    else:
        keys = tuple(t.to(dev) for t in _as_keys(rows, n_src, cin))
    if form == "forward":
        args = (x, g) + keys
    if form == "reverse":
        w = torch.randn(kvol, cin, cout, generator=gen).to(dev)
        args = (x, g, w) + keys
        fn, before = sparse_conv_implicit_bwd, sparse_conv_implicit_bwd.launches

        def launch():
            return sparse_conv_implicit_bwd(*args, want_dx=False)[1]
        ref = sparse_conv_implicit_bwd_plain(*args, want_dx=False)[1]
    else:
        fn, before = sparse_conv_dw, sparse_conv_dw.launches

        def launch():
            return sparse_conv_dw(*args)
        ref = sparse_conv_dw_plain(*args)
    dw = launch()
    with counted_dw_rows(dev) as counter:
        again = launch()
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    assert dw.shape == (kvol, cin, cout)
    staged, blocks = counter.tolist()
    matched = (rows >= 0).sum(1)
    if pattern == "pads":
        assert not dw.any() and not again.any() and staged == blocks == 0
        return
    _close_to_max(dw, ref, 1e-4)
    _close_to_max(again, ref, 1e-4)
    if cin == 1:
        assert staged == int(matched.sum())
    elif n_drive <= RESOLVE_ROWS:
        assert staged == int(_staged_rows(matched).sum())
    else:
        total = int(matched.sum())
        assert total <= staged <= total + 7 * blocks
    if n_drive <= RESOLVE_ROWS:
        assert blocks == int((matched > 0).sum())
    else:
        n_chunks = -(-n_drive // RESOLVE_ROWS)
        assert (matched > 0).sum() <= blocks <= kvol * n_chunks


# --- the bf16 forms (bf16 features, float32 weights rounded to bf16 in the
# wrapper, float32 sums): every bf16 output bit-equal to the plain bf16
# version on >= 99.9% of its elements and within one ulp on the rest (two
# float32 sums of the same exact products in another order, each rounded
# once); every float32 dW within 1e-4 of the plain version's max ---

BF16_WIDTHS = [(32, 32), (32, 384), (192, 128), (384, 128), (128, 256),
               (36, 20)]   # 36 x 20: rows not 16-byte aligned in bf16
SUM_BOUND = 2.0 ** -22


def _sum_bound(plain, args, i=0, **kw):
    """The float32 error bound of two sums of an output's n products,
    n * 2^-22 * sum |products| (Higham's gamma_n for each sum, with the
    tensor cores' truncating adder's 2^-23), for output i of plain(*args):
    the room assert_bf16_close gives elements whose sum cancels (there a
    float32 sum in any order can be more than a bf16 ulp off, as
    chip_smoke.py's bf16 cancellation phase measures against float64)."""
    out = plain(*[t.abs() if torch.is_tensor(t) and t.is_floating_point()
                  else t for t in args], **kw)
    s = (out[i] if isinstance(out, tuple) else out).float()
    w = next(t for t in args if torch.is_tensor(t) and t.dim() == 3
             and t.dtype == torch.float32)
    return (w.numel() // s.shape[1]) * SUM_BOUND * s


@pytest.mark.parametrize("pattern", ["edges", "dense", "pads"])
@pytest.mark.parametrize("cin,cout", BF16_WIDTHS)
def test_bf16_gather_gemm_forward_on_synthetic_maps(dev, pattern, cin, cout):
    """K6 and K12 in bf16 on the synthetic maps; K6 repeats bit for bit and
    its row counter equals compacted_rows' count."""
    kvol, n_out, n_in = 27, 3 * 64 + 13, 150
    rows = _synthetic_rows(kvol, n_out, n_in, pattern, cin + cout)
    qkey, skeys, srow = _as_keys(rows, n_in, cin)
    gen = torch.Generator().manual_seed(cout)
    x = torch.randn(n_in, cin, generator=gen).to(dev).to(torch.bfloat16)
    w = (torch.randn(kvol, cin, cout, generator=gen) / cin ** .5).to(dev)
    args = (x, w, qkey.to(dev), skeys.to(dev), srow.to(dev))
    idx = torch.where((rows < 0) & (torch.arange(n_out) % 2 == 0), n_in + 3,
                      rows).to(torch.int32).to(dev)
    before = (sparse_conv_implicit_fwd.launches,
              sparse_conv_table_fwd.launches)
    out = sparse_conv_implicit_fwd(*args)
    with counted_gather_rows(dev) as counter:
        again = sparse_conv_implicit_fwd(*args)
    tab = sparse_conv_table_fwd(x, w, idx)
    torch.cuda.synchronize()
    assert (sparse_conv_implicit_fwd.launches,
            sparse_conv_table_fwd.launches) == (before[0] + 2, before[1] + 1)
    assert out.dtype == tab.dtype == torch.bfloat16
    assert torch.equal(out.view(torch.int16), again.view(torch.int16))
    assert int(counter.item()) == compacted_rows(rows >= 0)[1]
    if pattern == "pads":
        assert not out.any() and not tab.any()
        return
    assert_bf16_close(out, sparse_conv_implicit_fwd_plain(*args), "K6",
                      _sum_bound(sparse_conv_implicit_fwd_plain, args))
    assert_bf16_close(tab, sparse_conv_table_fwd_plain(x, w, idx), "K12",
                      _sum_bound(sparse_conv_table_fwd_plain, (x, w, idx)))


@pytest.mark.parametrize("pattern", ["edges", "dense"])
@pytest.mark.parametrize("cin,cout", [(1, 32), (1, 1), (4, 24)])
@pytest.mark.parametrize("kvol", [27, 125])
def test_bf16_gather_gemm_table_narrow_input(dev, pattern, cin, cout, kvol):
    """K12 in bf16 with Cin < 8 (conv1 of the explicit route: Cin 1, K
    125): one k16 step of which Cin channels are real."""
    n_out, n_in = 2 * 64 + 50, 170
    rows = _synthetic_rows(kvol, n_out, n_in, pattern, kvol + cin)
    gen = torch.Generator().manual_seed(cout)
    x = torch.randn(n_in, cin, generator=gen).to(dev).to(torch.bfloat16)
    w = torch.randn(kvol, cin, cout, generator=gen).to(dev)
    idx = rows.to(torch.int32).to(dev)
    assert_bf16_close(sparse_conv_table_fwd(x, w, idx),
                      sparse_conv_table_fwd_plain(x, w, idx), "K12",
                      _sum_bound(sparse_conv_table_fwd_plain, (x, w, idx)))


@pytest.mark.parametrize("pattern", ["edges", "dense", "pads"])
@pytest.mark.parametrize("cin,cout", BF16_WIDTHS)
@pytest.mark.parametrize("want_dx", [True, False])
def test_bf16_backward_on_synthetic_maps(dev, pattern, cin, cout, want_dx):
    """K7 in bf16: dX (the gather-GEMM through W[K-1-k']^T, the kBT B
    operand read as packed pairs) at the bf16 gate, dW float32 within 1e-4;
    dX also against K6 through the reverse map (the two-pass route)."""
    kvol, n_in, n_out = 27, 4 * 64 + 9, 140
    rows = _synthetic_rows(kvol, n_in, n_out, pattern, cin * cout)
    rqkey, skeys, srow = _as_keys(rows, n_out, cout)
    gen = torch.Generator().manual_seed(cin)
    x = torch.randn(n_in, cin, generator=gen).to(dev).to(torch.bfloat16)
    g = torch.randn(n_out, cout, generator=gen).to(dev).to(torch.bfloat16)
    w = (torch.randn(kvol, cin, cout, generator=gen) / cout ** .5).to(dev)
    args = (x, g, w, rqkey.to(dev), skeys.to(dev), srow.to(dev))
    before = sparse_conv_implicit_bwd.launches
    dx, dw = sparse_conv_implicit_bwd(*args, want_dx=want_dx)
    torch.cuda.synchronize()
    assert sparse_conv_implicit_bwd.launches == before + 1
    assert dw.dtype == torch.float32 and (dx is None) == (not want_dx)
    if pattern == "pads":
        assert not dw.any() and (dx is None or not dx.any())
        return
    rdx, rdw = sparse_conv_implicit_bwd_plain(*args, want_dx=want_dx)
    _close_to_max(dw, rdw, 1e-4)
    if want_dx:
        assert dx.dtype == torch.bfloat16
        bound = _sum_bound(sparse_conv_implicit_bwd_plain, args)
        assert_bf16_close(dx, rdx, "K7 dX", bound)
        two_pass = sparse_conv_implicit_fwd(
            g, w.flip(0).transpose(1, 2).contiguous(), *args[3:])
        assert_bf16_close(dx, two_pass, "K7 dX against K6", bound)


@pytest.mark.parametrize("pattern", ["stages", "quarter", "dense", "pads"])
@pytest.mark.parametrize("cin,cout", DW_WIDTHS + [(36, 20)])
@pytest.mark.parametrize("form", ["forward", "table", "reverse"])
def test_bf16_splitk_dw_on_synthetic_maps(dev, form, pattern, cin, cout):
    """The split-K dW core in bf16 (K8 over a forward map and a table, K7's
    dW over a reverse map): within 1e-4 of the plain version's max, and
    staging exactly the rows its float32 form stages (the k16 steps' rows
    past a stage's pairs rounded to 8 go in as zero registers)."""
    kvol = 125 if (cin, cout) == (1, 32) else 27
    n_drive = 2 * RESOLVE_ROWS + 77 if pattern == "quarter" else 205
    n_src = 150
    rows = _dw_rows(kvol, n_drive, n_src, pattern, cin * 7 + cout)
    gen = torch.Generator().manual_seed(cin + cout)
    n_x, n_g = (n_drive, n_src) if form == "reverse" else (n_src, n_drive)
    x = torch.randn(n_x, cin, generator=gen).to(dev).to(torch.bfloat16)
    g = torch.randn(cout, n_g, generator=gen).to(dev).to(torch.bfloat16).T
    if form == "table":
        miss = torch.where(torch.arange(n_drive) % 3 == 0, -1,
                           n_src + torch.arange(n_drive) % 2 * 3)
        args = (x, g, torch.where(rows < 0, miss, rows).to(torch.int32)
                .to(dev))
    else:
        keys = tuple(t.to(dev) for t in _as_keys(rows, n_src, cin))
    if form == "forward":
        args = (x, g) + keys
    if form == "reverse":
        w = torch.randn(kvol, cin, cout, generator=gen).to(dev)
        args = (x, g, w) + keys

        def launch():
            return sparse_conv_implicit_bwd(*args, want_dx=False)[1]
        ref = sparse_conv_implicit_bwd_plain(*args, want_dx=False)[1]
    else:
        def launch():
            return sparse_conv_dw(*args)
        ref = sparse_conv_dw_plain(*args)
    with counted_dw_rows(dev) as counter:
        dw = launch()
    staged, blocks = counter.tolist()
    with counted_dw_rows(dev) as counter:
        launch_f32 = (sparse_conv_implicit_bwd(
            x.float(), g.float(), w, *keys, want_dx=False)
            if form == "reverse" else
            sparse_conv_dw(x.float(), g.float(), *args[2:]))
    assert counter.tolist() == [staged, blocks]
    assert dw.dtype == torch.float32 and dw.shape == (kvol, cin, cout)
    if pattern == "pads":
        assert not dw.any() and staged == blocks == 0
        return
    del launch_f32
    _close_to_max(dw, ref, 1e-4)
    matched = (rows >= 0).sum(1)
    if cin == 1:
        assert staged == int(matched.sum())
    elif n_drive <= RESOLVE_ROWS:
        assert staged == int(_staged_rows(matched).sum())


@pytest.mark.parametrize("key,k", [("s1->s1/k5d1", 125), ("s1->s1/k3d1", 27)])
@pytest.mark.parametrize("cout", [32, 20])
def test_bf16_occupancy_kernels_match_plain(dev, key, k, cout):
    """K2 in bf16 (W rounded in the wrapper, out rounded once; sbits as in
    float32) and K3 from a bf16 gradient (float32 dW)."""
    gr = _graph(dev, seed=1)
    gen = torch.Generator().manual_seed(k + cout)
    w = torch.randn(k, 1, cout, generator=gen).to(dev)
    args = (gr.maps[key].c1z, gr.levels[1].skeys, w)
    b2, b3 = occupancy_conv_fwd.launches, occupancy_conv_dw.launches
    out, sbits = occupancy_conv_fwd(*args, torch.bfloat16)
    ref, ref_bits = occupancy_conv_fwd_plain(*args, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    assert torch.equal(sbits, ref_bits) and sbits.any()
    assert torch.equal(sbits, occupancy_conv_fwd(*args)[1])
    assert_bf16_close(out, ref, "K2", _sum_bound(
        occupancy_conv_fwd_plain, args + (torch.bfloat16,)))
    g = (torch.randn(cout, sbits.shape[0], generator=gen).to(dev)
         .to(torch.bfloat16).T)
    dw = occupancy_conv_dw(sbits, g, k)
    torch.cuda.synchronize()
    assert (occupancy_conv_fwd.launches, occupancy_conv_dw.launches) == (
        b2 + 2, b3 + 1)
    assert dw.dtype == torch.float32
    _close_to_max(dw, occupancy_conv_dw_plain(sbits, g, k), 1e-4)


@pytest.mark.parametrize("key,k", [("s1->s1/k5d1", 125), ("s1->s1/k3d1", 27)])
@pytest.mark.parametrize("cout", [32, 20])
@pytest.mark.parametrize("gated", [False, True])
def test_bf16_scalar_conv_kernels_match_plain(dev, key, k, cout, gated):
    """K4 (bf16 x, float32 W, out rounded once), K5 (float32 dW) and K9
    (bf16 g, dX rounded once) in bf16; with the row flag and x zero off
    the flagged cloud, K4 gives the same bits as without it."""
    gr = _graph(dev, seed=2)
    lv = gr.levels[1]
    n = lv.coords.shape[0]
    gen = torch.Generator().manual_seed(k + cout)
    x = torch.randn(n, 1, generator=gen).to(dev)
    w = torch.randn(k, 1, cout, generator=gen).to(dev)
    g = torch.randn(cout, n, generator=gen).to(dev).to(torch.bfloat16).T
    sel = None
    if gated:
        sel = (lv.coords[:, 0] == 1).to(torch.float32)
        x = x * sel[:, None]
    x = x.to(torch.bfloat16)
    geo = (gr.maps[key].c1z, lv.skeys, lv.srow)
    before = (scalar_conv_fwd.launches, scalar_conv_dw.launches,
              scalar_conv_dx.launches)
    out = scalar_conv_fwd(x, w, *geo, sel)
    dw = scalar_conv_dw(x, g, *geo, k, sel)
    dx = scalar_conv_dx(g, w, *geo, sel)
    torch.cuda.synchronize()
    assert (scalar_conv_fwd.launches, scalar_conv_dw.launches,
            scalar_conv_dx.launches) == tuple(b + 1 for b in before)
    assert out.dtype == dx.dtype == torch.bfloat16
    assert dw.dtype == torch.float32
    assert_bf16_close(out, scalar_conv_fwd_plain(x, w, *geo, sel), "K4",
                      _sum_bound(scalar_conv_fwd_plain, (x, w, *geo, sel)))
    _close_to_max(dw, scalar_conv_dw_plain(x, g, *geo, k, sel), 1e-4)
    assert_bf16_close(dx, scalar_conv_dx_plain(g, w, *geo, sel), "K9",
                      _sum_bound(scalar_conv_dx_plain, (g, w, *geo, sel)))
    if gated:
        assert torch.equal(out, scalar_conv_fwd(x, w, *geo, None))


def test_bf16_wrappers_refuse_other_types(dev):
    """float16 features, a g of another type than x and float64 weights
    raise before any launch."""
    g = _graph(dev)
    lv, cmap = g.levels[1], g.maps["s1->s1/k3d1"]
    n = lv.coords.shape[0]
    x = torch.randn(n, 8, device=dev)
    w = torch.randn(27, 8, 16, device=dev)
    before = dict(K6=sparse_conv_implicit_fwd.launches,
                  K7=sparse_conv_implicit_bwd.launches,
                  K8=sparse_conv_dw.launches)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        sparse_conv_implicit_fwd(x.half(), w, cmap.qkey, lv.skeys, lv.srow)
    with pytest.raises(TypeError, match="float32"):
        sparse_conv_implicit_fwd(x.bfloat16(), w.double(), cmap.qkey,
                                 lv.skeys, lv.srow)
    with pytest.raises(TypeError, match="as x is"):
        sparse_conv_implicit_bwd(x.bfloat16(), torch.zeros(n, 16, device=dev),
                                 w, cmap.rqkey, lv.skeys, lv.srow)
    with pytest.raises(TypeError, match="as x is"):
        sparse_conv_dw(x.bfloat16(), torch.zeros(n, 16, device=dev),
                       cmap.qkey, lv.skeys, lv.srow)
    assert before == dict(K6=sparse_conv_implicit_fwd.launches,
                          K7=sparse_conv_implicit_bwd.launches,
                          K8=sparse_conv_dw.launches)


def test_bf16_model_on_card_matches_cpu(dev):
    """ResUNetFatBN in bf16, train mode, forward and backward: kernels on
    the card against the plain versions on the CPU. Both round every conv
    to bf16 once but sum in another order, so features and gradients
    differ by bf16's own noise. Per tensor, as tests/test_torch_bf16.py
    holds the port to gcl_tpu: |card - cpu|max <= 2 |cpu bf16 - cpu
    float32|max + 1e-6 (a wrong fragment layout or a second rounding moves
    them by the whole max)."""
    pts, pmask = clouds(4, 2, 900)
    state = random_state_dict(ResUNetFatBN(1, 32, conv1_kernel_size=5), 0)
    runs = {}
    for name, d, dt in (("cpu", "cpu", torch.bfloat16),
                        ("cpu32", "cpu", torch.float32),
                        ("card", dev, torch.bfloat16)):
        vox = voxelize_per_cloud(torch.from_numpy(pts).to(d),
                                 torch.from_numpy(pmask).to(d), VOXEL, 600)
        flat = vox.flatten()
        gr = build_graph(flat.coords, flat.mask, fatbn_specs(),
                         {2: 500, 4: 400, 8: 300}, 2)
        model = ResUNetFatBN(1, 32, bn_momentum=0.05, normalize_feature=True,
                             conv1_kernel_size=5).to(d)
        model.load_state_dict(state)
        f = model(gr, flat.feats.to(dt))
        assert f.dtype == dt
        (f.float() * flat.mask[:, None]).square().sum().backward()
        runs[name] = {"features": f.detach().float().cpu(),
                      **{k: p.grad.cpu() for k, p in
                         model.named_parameters()}}
    for name, ref in runs["cpu"].items():
        drift = float((ref - runs["cpu32"][name]).abs().max())
        err = float((runs["card"][name] - ref).abs().max())
        assert err <= 2 * drift + 1e-6, (name, err, drift)


# --- K10, K2, K4 and K5 inside their key windows
# (tests/test_torch_key_windows.py checks the same tables' soundness on the
# CPU) ---

@pytest.mark.parametrize("chunk", [JOIN_CHUNK, 6])
@pytest.mark.parametrize("case", JOIN_WINDOW_CASES)
def test_join_kernel_in_windows(dev, case, chunk):
    """K10 on every geometry of the window cases (blocked and compacted
    levels, every strided and transposed geometry of ResUNetFatBN, the key
    window's faces, a level at test_upmap_window_soundness's scale) equal
    to its plain version, at the default chunk and at 6 keys a chunk
    (windows of many chunks); the keys its blocks stage, as the kernel
    counts its copies, equal the plain torch table's sum (the table on the
    card equal to the one on the CPU)."""
    for key, (kh, kl, perm), (qhi, qlo), *_ in join_window_geometries(
            case, dev):
        win = join_windows(kh, kl, qhi, qlo)
        assert torch.equal(win.cpu(), join_windows(
            kh.cpu(), kl.cpu(), qhi.cpu(), qlo.cpu())), key
        ref = join_kmap_plain(kh, kl, perm, qhi, qlo)
        with counted_join_keys(dev) as counter:
            got = join_kmap(kh, kl, perm, qhi, qlo, chunk=chunk)
        assert torch.equal(got, ref), key
        assert int(counter.item()) == int(win[1].sum()), key


@pytest.mark.parametrize("chunk", [OCC_CHUNK, 3])
@pytest.mark.parametrize("side", [3, 5])
@pytest.mark.parametrize("case", OCC_WINDOW_CASES)
def test_occupancy_kernel_in_windows(dev, case, side, chunk):
    """K2 in float32 and bf16 on the window cases (clouds >= 16 and tiles
    that mix clouds 15 and 16, the grid's faces), at the default chunk and
    at 3 keys a chunk (a dz run split between chunks): sbits equal the
    plain version's, out within 1e-5 (float32) or at the bf16 gate, and
    the keys its blocks stage, as the kernel counts its copies, equal the
    plain torch table's sum."""
    aux, skeys, _ = occupancy_window_inputs(case, side, dev)
    gen = torch.Generator().manual_seed(side)
    w = torch.randn(side ** 3, 1, 32, generator=gen).to(dev)
    win = occupancy_windows(aux, skeys, side)
    assert torch.equal(win.cpu(), occupancy_windows(aux.cpu(), skeys.cpu(),
                                                    side))
    for dtype in (torch.float32, torch.bfloat16):
        with counted_occupancy_keys(dev) as counter:
            out, sbits = occupancy_conv_fwd(aux, skeys, w, dtype,
                                            chunk=chunk)
        ref, ref_bits = occupancy_conv_fwd_plain(aux, skeys, w, dtype)
        assert torch.equal(sbits, ref_bits) and sbits.any()
        assert int(counter.item()) == int(win[1].sum())
        if dtype == torch.float32:
            torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
        else:
            assert_bf16_close(out, ref, f"K2 {case}", _sum_bound(
                occupancy_conv_fwd_plain, (aux, skeys, w, dtype)))


def _scalar_inputs(dev, n, side, cout, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(n, 1, generator=gen).to(dev).to(dtype)
    w = torch.randn(side ** 3, 1, cout, generator=gen).to(dev)
    g = torch.randn(n, cout, generator=gen).to(dev).to(dtype)
    return x, w, g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk", [SCALAR_CHUNK, 3])
@pytest.mark.parametrize("side", [3, 5])
@pytest.mark.parametrize("case", OCC_WINDOW_CASES)
def test_scalar_conv_kernels_in_windows(dev, case, side, chunk, dtype):
    """K4 and K5 on the window cases (clouds >= 16 and tiles that mix
    clouds 15 and 16, the grid's faces), with no row flag and with a flag
    that varies inside tiles and leaves whole tiles out, at the default
    chunk and at 3 keys a chunk: K4 within 1e-4 of the max (float32) or at
    the bf16 gate, K5 within 1e-4; the keys each launch stages, as the
    kernels count their copies, equal to the sum of the plain torch table
    of the windows its flagged rows bound."""
    aux, skeys, srow, sel = scalar_window_inputs(case, side, dev)
    x, w, g = _scalar_inputs(dev, aux.shape[0], side, 24, dtype, side)
    for flag in (None, sel):
        geo = (aux, skeys, srow)
        win = occupancy_windows(aux, skeys, side, flag)
        in_table = int(win[1].sum())
        b4, b5 = scalar_conv_fwd.launches, scalar_conv_dw.launches
        with counted_scalar_keys(dev) as counter:
            out = scalar_conv_fwd(x, w, *geo, flag, chunk=chunk)
        assert int(counter.item()) == in_table > 0
        with counted_scalar_keys(dev) as counter:
            dw = scalar_conv_dw(x, g, *geo, side ** 3, flag, chunk=chunk)
        assert int(counter.item()) == in_table
        assert (scalar_conv_fwd.launches, scalar_conv_dw.launches) == (
            b4 + 1, b5 + 1)
        ref = scalar_conv_fwd_plain(x, w, *geo, flag)
        assert out.dtype == dtype and bool(ref.any())
        if dtype == torch.float32:
            _close_to_max(out, ref, 1e-4)
        else:
            assert_bf16_close(out, ref, f"K4 {case}", _sum_bound(
                scalar_conv_fwd_plain, (x, w, *geo, flag)))
        _close_to_max(dw, scalar_conv_dw_plain(x, g, *geo, side ** 3, flag),
                      1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scalar_conv_kernels_with_no_row_flagged(dev, dtype):
    """A flag that selects no row: K4 launches and writes zeros, K5 leaves
    dW zero, and neither stages a key."""
    gr = _graph(dev, seed=2)
    lv = gr.levels[1]
    n = lv.coords.shape[0]
    x, w, g = _scalar_inputs(dev, n, 5, 32, dtype, 3)
    geo = (gr.maps["s1->s1/k5d1"].c1z, lv.skeys, lv.srow)
    none = torch.zeros(n, device=dev)
    b4, b5 = scalar_conv_fwd.launches, scalar_conv_dw.launches
    with counted_scalar_keys(dev) as counter:
        out = scalar_conv_fwd(x, w, *geo, none)
        dw = scalar_conv_dw(x, g, *geo, 125, none)
    assert int(counter.item()) == 0
    assert (scalar_conv_fwd.launches, scalar_conv_dw.launches) == (b4 + 1,
                                                                   b5 + 1)
    assert out.dtype == dtype and out.shape == (n, 32)
    assert torch.equal(out, torch.zeros_like(out))
    assert torch.equal(dw, torch.zeros_like(dw))
    assert bool(scalar_conv_fwd(x, w, *geo, None).any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("side", [3, 5])
@pytest.mark.parametrize("case", OCC_WINDOW_CASES)
def test_scalar_conv_dx_kernel_in_windows(dev, case, side, dtype):
    """K9 on the window cases (clouds >= 16 and tiles that mix clouds 15
    and 16, the grid's faces), with no row flag and with a flag that
    varies inside tiles and leaves whole tiles out: within 1e-4 of the max
    (float32) or at the bf16 gate, the adjoint of K4 (float32), and the
    keys it stages, as the kernel counts its copies, equal to the sum of
    the unflagged plain torch table (the windows of every row)."""
    aux, skeys, srow, sel = scalar_window_inputs(case, side, dev)
    x, w, g = _scalar_inputs(dev, aux.shape[0], side, 24, dtype, side + 7)
    geo = (aux, skeys, srow)
    in_table = int(occupancy_windows(aux, skeys, side)[1].sum())
    for flag in (None, sel):
        before = scalar_conv_dx.launches
        with counted_scalar_keys(dev) as counter:
            dx = scalar_conv_dx(g, w, *geo, flag)
        assert int(counter.item()) == in_table > 0
        assert scalar_conv_dx.launches == before + 1
        ref = scalar_conv_dx_plain(g, w, *geo, flag)
        assert dx.dtype == dtype and bool(ref.any())
        if dtype == torch.float32:
            _close_to_max(dx, ref, 1e-4)
            out = scalar_conv_fwd(x, w, *geo, flag)
            lhs, rhs = float((out * g).sum()), float((x * dx).sum())
            assert abs(lhs - rhs) <= 1e-4 * float((out.abs() * g.abs())
                                                  .sum())
        else:
            assert_bf16_close(dx, ref, f"K9 {case}", _sum_bound(
                scalar_conv_dx_plain, (g, w, *geo, flag)))


def _synthetic_sbits(n, side, seed, density=0.3):
    """int32[n, 8] presence bitmasks as K2 writes them: bit dy * side + dz
    of column dx, each set with the given density; columns past side 0."""
    rng = np.random.RandomState(seed)
    s2 = side * side
    bits = rng.rand(n, side, s2) < density
    words = (bits.astype(np.int64) << np.arange(s2)).sum(-1)
    out = np.zeros((n, 8), np.int32)
    out[:, :side] = words.astype(np.int32)
    return torch.from_numpy(out)


# rows below one 64-row chunk, a ragged last chunk, and enough chunks
# that every block walks its ring of stages more than once
K3_ROWS = [37, 64 * 41 + 13, 100003]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", K3_ROWS)
@pytest.mark.parametrize("cout", [1, 20, 32, 64, 96])
@pytest.mark.parametrize("side", [3, 5])
def test_occupancy_dw_tensor_core_tiles(dev, side, cout, n, dtype):
    """K3 in both forms on synthetic bitmasks: the 16-offset m-tiles (two
    at side 3, eight at side 5, the last padded), column slices of 32 or
    64 padded with zero columns (Cout 1, 20) or cut in two (96), row
    counts below and across the 64-row chunks: dW within 1e-4 of the
    plain version's max (float32 sums in another order, by atomics)."""
    kcube = side ** 3
    sbits = _synthetic_sbits(n, side, side * 1000 + cout).to(dev)
    gen = torch.Generator().manual_seed(n + cout)
    g = torch.randn(n, cout, generator=gen).to(dev).to(dtype)
    before = occupancy_conv_dw.launches
    dw = occupancy_conv_dw(sbits, g, kcube)
    torch.cuda.synchronize()
    assert occupancy_conv_dw.launches == before + 1
    assert dw.dtype == torch.float32 and dw.shape == (kcube, 1, cout)
    _close_to_max(dw, occupancy_conv_dw_plain(sbits, g, kcube), 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_occupancy_dw_unaligned_and_empty(dev, dtype):
    """K3 on g whose rows are not 16-byte aligned (the element copies),
    and on all-zero bitmasks: dW exactly zero."""
    n, cout = 5000, 32
    sbits = _synthetic_sbits(n, 5, 7).to(dev)
    gen = torch.Generator().manual_seed(8)
    flat = torch.randn(n * cout + 1, generator=gen).to(dev).to(dtype)
    g = flat[1:].view(n, cout)
    assert g.data_ptr() % 16 != 0
    dw = occupancy_conv_dw(sbits, g, 125)
    _close_to_max(dw, occupancy_conv_dw_plain(sbits, g, 125), 1e-4)
    zero = torch.zeros_like(sbits)
    dw0 = occupancy_conv_dw(zero, g, 125)
    torch.cuda.synchronize()
    assert torch.equal(dw0, torch.zeros_like(dw0))


@pytest.mark.parametrize("kn", [1, 5, 8])
@pytest.mark.parametrize("case", TOPK_WINDOW_CASES + ("step",))
def test_windowed_topk_kernel_in_windows(dev, case, kn):
    """K1 on the window cases (bases only about monotone, tiles over x
    cells, sentinel tiles, the grid edge, the 4 x 7 step's shapes): rows
    equal and d2 bit for bit, and the targets its blocks stage, as the
    kernel counts its copies, equal to the plain torch table's sum."""
    arrays = topk_window_inputs(case, dev)
    win = topk_windows(arrays[0], arrays[3])
    assert torch.equal(win.cpu(), topk_windows(arrays[0].cpu(),
                                               arrays[3].cpu()))
    before = windowed_cell_topk_packed.launches
    with counted_topk_keys(dev) as counter:
        rows, d2 = windowed_cell_topk_packed(*arrays, kn)
    assert windowed_cell_topk_packed.launches == before + 1
    prow, pd2 = windowed_cell_topk_plain(*arrays, kn)
    assert torch.equal(rows, prow)
    assert torch.equal(d2.view(torch.int32), pd2.view(torch.int32))
    assert int(counter.item()) == int(win[1].sum()) > 0
    assert int((rows >= 0).sum()) > 100

