"""CUDA legs of the port's kernels (K6, K2): each kernel against its plain
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
from gcl_tpu_torch.kernels import (occupancy_conv_fwd,
                                   occupancy_conv_fwd_plain,
                                   sparse_conv_implicit_fwd,
                                   sparse_conv_implicit_fwd_plain)
from gcl_tpu_torch.models.resunet import ResUNetFatBN
from gcl_tpu_torch.models.weights import random_state_dict

from _torch_parity import VOXEL, clouds, fatbn_specs

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
