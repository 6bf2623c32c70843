"""CUDA legs of the port's kernels (K2-K7): each kernel against its plain
PyTorch version on the card, at small shapes with ragged tile edges.

A CUDA kernel has no CPU mode, so these skip where
torch.cuda.is_available() is false. On a machine with a card (no JAX
needed, hence no conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q
"""
import pytest
import torch

from gcl_tpu_torch.core.kernel_maps import ConvSpec, build_graph
from gcl_tpu_torch.data.device_pipeline import voxelize_per_cloud
from gcl_tpu_torch.infer import make_feature_extractor
from gcl_tpu_torch.kernels import (occupancy_conv_dw,
                                   occupancy_conv_dw_plain,
                                   occupancy_conv_fwd,
                                   occupancy_conv_fwd_plain, scalar_conv_dw,
                                   scalar_conv_dw_plain, scalar_conv_fwd,
                                   scalar_conv_fwd_plain,
                                   sparse_conv_implicit_bwd,
                                   sparse_conv_implicit_bwd_plain,
                                   sparse_conv_implicit_fwd,
                                   sparse_conv_implicit_fwd_plain)
from gcl_tpu_torch.models.resunet import ResUNetFatBN
from gcl_tpu_torch.models.weights import random_state_dict

from _torch_parity import (VOXEL, assert_close_to_max, clouds, fatbn_specs,
                           to_np)

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
