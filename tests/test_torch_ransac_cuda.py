"""CUDA legs of RANSAC's scoring kernel (R1, kernels/ransac_score.py):
its counts against the plain version's bit for bit, the fit pass against
the plain version's 1024-hypothesis batches, and ransac_pose
against the benchmark's frozen reference at the FCGF evaluation's 131,072
hypotheses.

A CUDA kernel has no CPU mode, so these skip where
torch.cuda.is_available() is false. On a machine with a card (no JAX
needed, hence no conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_ransac_cuda.py -q
"""
import numpy as np
import pytest
import torch

from gcl_tpu_torch.kernels import (launch_counts, ransac_score,
                                   ransac_score_plain, reset_launch_counts)
from gcl_tpu_torch.kernels.ransac_score import HYPOTHESIS_BATCH
from gcl_tpu_torch.reg.procrustes import rigid_transform_3d
from gcl_tpu_torch.reg.ransac import ransac_pose, score_hypotheses

pytestmark = pytest.mark.cuda

THR = 0.3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rotation(rng, max_deg):
    axis = rng.randn(3)
    axis /= np.linalg.norm(axis)
    th = np.radians(rng.uniform(-max_deg, max_deg))
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k


def _pair(seed, n, inlier_share=0.3):
    """Correspondences of a LiDAR-sized scene: src in a 100 m box, the
    inliers' targets a rigid motion of it within THR, the rest anywhere in
    the box; 5 % of the rows invalid."""
    rng = np.random.RandomState(seed)
    src = rng.uniform(-50, 50, (n, 3)).astype(np.float32)
    tgt = src @ _rotation(rng, 10).T + rng.uniform(-10, 10, 3)
    tgt += rng.randn(n, 3) * THR / 3
    out = rng.rand(n) > inlier_share
    tgt[out] = rng.uniform(-50, 50, (out.sum(), 3))
    mask = rng.rand(n) > 0.05
    return src, tgt.astype(np.float32), mask


def _to(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


def _bits(t):
    """The float32 tensor's bits (NaNs compare equal by their bits)."""
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("n", [5000, 4099, 20000])
@pytest.mark.parametrize("s_n", [3, 4])
def test_counts_equal_the_plain_version(dev, n, s_n):
    """Invalid rows, samples whose edge check fails, degenerate samples
    (repeated rows) and fits with NaN and inf entries; H not a multiple of
    a block's hypotheses, N (also) not a multiple of a staged chunk and
    over one chunk."""
    src, tgt, mask = _pair(n, n)
    rng = np.random.RandomState(s_n)
    h = 4099
    samples = rng.randint(0, n, (h, s_n))
    samples[:64, 1] = samples[:64, 0]      # a repeated row
    samples[64:96] = samples[64:96, :1]    # every row the same
    src_t, tgt_t, valid, idx = _to(dev, src, tgt, mask, samples)
    trans, fit = score_hypotheses(src_t, tgt_t, idx, THR, 0.9, valid)
    ok = fit > 0
    assert 0 < int((~ok).sum()) < h and int(fit.max()) > 20
    bent = trans.clone()
    bent[100:110] = float("nan")
    bent[110:120, 0, 3] = float("inf")
    bent[120:130, 1, 1] = float("-inf")
    for tr in (trans, bent):
        okh = torch.ones(h, dtype=torch.bool, device=dev)
        okh[::7] = False
        got = ransac_score(src_t, tgt_t, valid, tr, okh, THR)
        want = ransac_score_plain(src_t, tgt_t, valid, tr, okh, THR)
        assert torch.equal(got, want)
        assert not got[::7].any()
    assert not ransac_score(src_t, tgt_t, valid, bent,
                            torch.ones(h, dtype=torch.bool, device=dev),
                            THR)[100:130].any()


@pytest.mark.parametrize("seed", [0, 1])
def test_counts_at_the_threshold_equal_the_plain_version(dev, seed):
    """Targets planted so that their distances round to within a few ulps
    of THR on both sides (coordinates under 1 m, so that the rounding of
    the moved points is of the order of THR's ulp), under fits a few ulps
    apart in their translations."""
    rng = np.random.RandomState(seed)
    n, h = 6000, 512
    src = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    r = _rotation(rng, 30).astype(np.float32)
    t = rng.uniform(-0.2, 0.2, 3).astype(np.float32)
    trans = np.tile(np.eye(4, dtype=np.float32), (h, 1, 1))
    trans[:, :3, :3] = r
    trans[:, :3, 3] = t + rng.randint(-4, 5, (h, 3)) * np.spacing(t)
    direction = rng.randn(n, 3)
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    ulp = float(np.spacing(np.float32(THR)))
    dist = THR + rng.randint(-6, 7, n) * ulp
    tgt = (src @ r.T + t - direction * dist[:, None]).astype(np.float32)
    mask = rng.rand(n) > 0.02
    src_t, tgt_t, valid, tr = _to(dev, src, tgt, mask, trans)
    ok = torch.ones(h, dtype=torch.bool, device=dev)
    got = ransac_score(src_t, tgt_t, valid, tr, ok, THR)
    want = ransac_score_plain(src_t, tgt_t, valid, tr, ok, THR)
    assert torch.equal(got, want)
    # most distances within 8 ulps of THR, and counts that differ between
    # the hypotheses
    d = torch.sqrt(((src_t @ tr[0, :3, :3].T + tr[0, :3, 3] - tgt_t) ** 2)
                   .sum(-1))
    assert float(((d - THR).abs() <= 8 * ulp).float().mean()) > 0.5
    assert len(torch.unique(got)) > 3


@pytest.mark.parametrize("h", [16384, 131072, 150000])
def test_the_fit_pass_equals_1024_hypothesis_batches(dev, h):
    """score_hypotheses' fits (fit_hypotheses' calls) bit for bit those of
    the plain version's 1024-hypothesis batches, at ETH's and the FCGF
    evaluation's hypothesis counts and at one that takes calls of both
    sizes."""
    src, tgt, mask = _pair(7, 5000)
    rng = np.random.RandomState(h)
    samples = rng.randint(0, 5000, (h, 4))
    src_t, tgt_t, valid, idx = _to(dev, src, tgt, mask, samples)
    trans, _ = score_hypotheses(src_t, tgt_t, idx, THR, 0.9, valid)
    s, t = src_t[idx], tgt_t[idx]
    batched = torch.cat([rigid_transform_3d(a, b) for a, b in
                         zip(torch.split(s, HYPOTHESIS_BATCH),
                             torch.split(t, HYPOTHESIS_BATCH))])
    assert torch.equal(_bits(trans), _bits(batched))


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11])
def test_ransac_pose_equals_the_reference(dev, seed):
    """ransac_pose at the FCGF evaluation's settings (131,072 hypotheses of
    4 rows, 0.3 m, edge 0.9) against benchmark/reference/reg/ransac.py's on
    the same draws: transform, inliers and fitness bit for bit; one launch
    of the kernel a call, which scores every hypothesis."""
    from benchmark.reference.reg.ransac import ransac_pose as ref_pose

    src, tgt, mask = _pair(seed % 1000, 5000)
    src_t, tgt_t, valid = _to(dev, src, tgt, mask)
    kw = dict(num_hypotheses=131072, sample_size=4, edge_length_ratio=0.9,
              mask=valid)
    reset_launch_counts()
    got = ransac_pose(src_t, tgt_t, THR,
                      generator=torch.Generator().manual_seed(seed), **kw)
    torch.cuda.synchronize()
    assert launch_counts()["R1"] == 1 and ransac_score.hypotheses == 131072
    want = ref_pose(src_t, tgt_t, THR,
                    generator=torch.Generator().manual_seed(seed), **kw)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[2], want[2])
    assert int(got[1].sum()) > 1000
