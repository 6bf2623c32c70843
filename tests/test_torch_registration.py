"""Parity of the rest of gcl_tpu_torch.reg with gcl_tpu.reg: feature
matching, RANSAC, the robust linearised pose, the metrics and ICP.

Tolerances:
- find_nn: indices equal wherever the best and second-best d2 (float64)
  are more than 1e-5 apart, d2 within 1e-5 (|a|^2 + |b|^2 - 2ab in
  float32, the product rounded otherwise than XLA's);
- ransac_pose with gcl_tpu's minimal samples handed in: per-hypothesis
  fitness equal wherever every residual clears the threshold by 1e-4
  (and each edge-length comparison of its sample by as much), the same hypothesis chosen, the transform within 1e-4, inliers equal;
- est_quad_linear_robust: within 1e-4 (20 float32 6x6 solves);
- metrics within 1e-6; ICP, a numpy copy, bit for bit;
- decompose_trans exactly, concatenate within 1e-6 (float32 3x3
  products and sums, XLA's and torch's orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcl_tpu.reg import icp as jicp
from gcl_tpu.reg import metrics as jmetrics
from gcl_tpu.reg.matching import find_corr as j_find_corr
from gcl_tpu.reg.matching import find_nn as j_find_nn
from gcl_tpu.reg.procrustes import rigid_transform_3d as j_rigid
from gcl_tpu.reg.ransac import ransac_pose as j_ransac_pose
from gcl_tpu.reg.robust import est_quad_linear_robust as j_robust
from gcl_tpu.reg import se3 as jse3
from gcl_tpu.reg.se3 import transform as j_transform
from gcl_tpu_torch.reg import icp, metrics, se3
from gcl_tpu_torch.reg.matching import (find_corr, find_nn, find_nn_cpu,
                                        mutual_feature_match)
from gcl_tpu_torch.reg.ransac import ransac_pose, score_hypotheses
from gcl_tpu_torch.reg.robust import est_quad_linear_robust

from _torch_parity import one_torch_thread, to_np  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _transform(rng, max_deg, max_t):
    axis = rng.randn(3)
    axis /= np.linalg.norm(axis)
    th = np.radians(rng.uniform(-max_deg, max_deg))
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    t = np.eye(4, dtype=np.float32)
    t[:3, :3] = np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k
    t[:3, 3] = rng.uniform(-max_t, max_t, 3)
    return t


def _apply(t, x):
    return (x @ t[:3, :3].T + t[:3, 3]).astype(np.float32)


# ----------------------------------------------------------------------
# matching
# ----------------------------------------------------------------------

def _features(seed, n0=300, n1=260, c=16, ties=True):
    rng = np.random.RandomState(seed)
    f0 = rng.randn(n0, c).astype(np.float32)
    f1 = rng.randn(n1, c).astype(np.float32)
    if ties:  # exact duplicates: ties go to the lower index in both
        f1[7] = f1[200]
        f0[:20] = f1[rng.randint(0, n1, 20)]
    f0 /= np.linalg.norm(f0, axis=1, keepdims=True)
    f1 /= np.linalg.norm(f1, axis=1, keepdims=True)
    return f0, f1, rng.rand(n1) > 0.3


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("squared", [True, False])
def test_find_nn_matches_jax(masked, squared):
    f0, f1, mask1 = _features(0)
    m = mask1 if masked else None
    inds, d = find_nn(torch.from_numpy(f0), torch.from_numpy(f1),
                      None if m is None else torch.from_numpy(m), chunk=64,
                      squared=squared)
    j_inds, j_d = j_find_nn(jnp.asarray(f0), jnp.asarray(f1),
                            None if m is None else jnp.asarray(m), chunk=64,
                            squared=squared)
    d64 = ((f0[:, None].astype(np.float64) - f1[None]) ** 2).sum(-1)
    if m is not None:
        d64[:, ~m] = np.inf
        assert m[to_np(inds)].all()
    best = np.sort(d64, axis=1)
    clear = best[:, 1] - best[:, 0] > 1e-5
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(to_np(inds)[clear],
                                  np.asarray(j_inds)[clear])
    np.testing.assert_allclose(to_np(d), np.asarray(j_d), rtol=0,
                               atol=1e-5 if squared else 1e-3)
    # chunked equals unchunked; mutual_feature_match is the argmin
    whole, _ = find_nn(torch.from_numpy(f0), torch.from_numpy(f1),
                       None if m is None else torch.from_numpy(m),
                       chunk=4096, squared=squared)
    assert torch.equal(whole, inds)
    assert torch.equal(mutual_feature_match(
        torch.from_numpy(f0), torch.from_numpy(f1),
        None if m is None else torch.from_numpy(m), chunk=64), inds)


def test_find_nn_cpu_and_find_corr_match_jax():
    f0, f1, _ = _features(1, ties=False)
    np.testing.assert_array_equal(find_nn_cpu(f0, f1), jicp.cKDTree(f1)
                                  .query(f0, k=1)[1])
    rng = np.random.RandomState(2)
    xyz0 = rng.randn(300, 3).astype(np.float32)
    xyz1 = rng.randn(260, 3).astype(np.float32)
    key = jax.random.PRNGKey(4)
    k0, k1 = jax.random.split(key)
    inds = [torch.from_numpy(np.array(jax.random.choice(k, n, (100,),
                                                        replace=False)))
            for k, n in ((k0, 300), (k1, 260))]
    got = find_corr(torch.from_numpy(xyz0), torch.from_numpy(xyz1),
                    torch.from_numpy(f0), torch.from_numpy(f1),
                    subsample_size=100, chunk=64, inds=inds)
    ref = j_find_corr(jnp.asarray(xyz0), jnp.asarray(xyz1), jnp.asarray(f0),
                      jnp.asarray(f1), key, subsample_size=100, chunk=64)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))


# ----------------------------------------------------------------------
# RANSAC
# ----------------------------------------------------------------------

THR = 0.3


def _correspondences(seed, n=240, inlier_share=0.6):
    """src -> tgt under a known transform for the inliers (residuals at
    most THR / 2), far-off targets for the outliers, a few padded rows."""
    rng = np.random.RandomState(seed)
    t = _transform(rng, 40.0, 4.0)
    src = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    tgt = _apply(t, src)
    noise = rng.randn(n, 3)
    noise *= (rng.uniform(0, THR / 2, n) / np.linalg.norm(noise, axis=1))[
        :, None]
    tgt = (tgt + noise).astype(np.float32)
    out = rng.rand(n) > inlier_share
    tgt[out] = rng.uniform(-10, 10, (out.sum(), 3))
    mask = rng.rand(n) > 0.05
    return t, src, tgt, mask


def _j_samples(key, mask, h, s):
    """gcl_tpu's minimal samples, drawn as ransac_pose draws them."""
    valid = jnp.asarray(mask)
    nvalid = jnp.maximum(jnp.sum(valid.astype(jnp.int32)), 1)
    order = jnp.argsort(~valid)
    draws = jax.random.randint(key, (h, s), 0, jnp.int32(2 ** 30)) % nvalid
    return np.asarray(order[draws])


def _j_scores(src, tgt, samples, valid, ratio):
    """gcl_tpu's per-hypothesis (trans, fitness, residuals), its
    ransac.py:53-67 vmapped."""
    s_n = samples.shape[1]

    def hypothesis(idx):
        s, t = src[idx], tgt[idx]
        ds = jnp.linalg.norm(s[:, None] - s[None], axis=-1)
        dt = jnp.linalg.norm(t[:, None] - t[None], axis=-1)
        off = ~jnp.eye(s_n, dtype=bool)
        ok = jnp.all((ds * ratio <= dt + 1e-9) & (dt * ratio <= ds + 1e-9)
                     | ~off)
        trans = j_rigid(s[None], t[None])[0]
        d = jnp.linalg.norm(j_transform(src, trans) - tgt, axis=-1)
        return trans, jnp.sum((d < THR) & valid) * ok.astype(jnp.int32), d

    out = jax.jit(jax.vmap(hypothesis))(jnp.asarray(samples))
    return [np.asarray(a) for a in out]


@pytest.mark.parametrize("seed,sample_size,ratio", [(0, 3, 0.8),
                                                     (1, 4, 0.9)])
def test_ransac_matches_jax_with_pinned_samples(seed, sample_size, ratio):
    _, src, tgt, mask = _correspondences(seed)
    key = jax.random.PRNGKey(seed)
    h = 2048
    samples = _j_samples(key, mask, h, sample_size)
    j_trans_h, j_fit, j_d = _j_scores(jnp.asarray(src), jnp.asarray(tgt),
                                      samples, jnp.asarray(mask), ratio)
    t_src, t_tgt = torch.from_numpy(src), torch.from_numpy(tgt)
    _, fit = score_hypotheses(t_src, t_tgt, torch.from_numpy(samples), THR,
                              ratio, torch.from_numpy(mask))
    fit = to_np(fit)
    s64, t64 = (x.astype(np.float64)[samples] for x in (src, tgt))
    ds = np.linalg.norm(s64[:, :, None] - s64[:, None], axis=-1)
    dt = np.linalg.norm(t64[:, :, None] - t64[:, None], axis=-1)
    off = ~np.eye(sample_size, dtype=bool)
    clear = ((np.abs(j_d - THR) > 1e-4).all(axis=1)
             & (np.abs(ds * ratio - dt) > 1e-4)[:, off].all(axis=1)
             & (np.abs(dt * ratio - ds) > 1e-4)[:, off].all(axis=1))
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(fit[clear], j_fit[clear])
    assert fit.argmax() == j_fit.argmax() and clear[j_fit.argmax()]

    trans, inl, fitness = ransac_pose(
        t_src, t_tgt, THR, samples=torch.from_numpy(samples),
        sample_size=sample_size, edge_length_ratio=ratio,
        mask=torch.from_numpy(mask))
    j_t, j_inl, j_fitness = j_ransac_pose(
        jnp.asarray(src), jnp.asarray(tgt), key, THR, num_hypotheses=h,
        sample_size=sample_size, edge_length_ratio=ratio,
        mask=jnp.asarray(mask))
    np.testing.assert_allclose(to_np(trans), np.asarray(j_t), rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(to_np(inl), np.asarray(j_inl))
    assert float(fitness) == pytest.approx(float(j_fitness), abs=1e-6)


def test_ransac_draws_and_recovers_the_transform():
    t, src, tgt, mask = _correspondences(3)
    gen = torch.Generator().manual_seed(0)
    trans, inl, fitness = ransac_pose(
        torch.from_numpy(src), torch.from_numpy(tgt), THR, generator=gen,
        num_hypotheses=4096, sample_size=4, edge_length_ratio=0.9,
        mask=torch.from_numpy(mask))
    rte, rre = metrics.rte_rre(trans, t)
    assert rte < 0.1 and rre < 1.0
    assert 0.5 < float(fitness) < 0.75 and not (to_np(inl) & ~mask).any()


# ----------------------------------------------------------------------
# the robust linearised pose
# ----------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_est_quad_linear_robust_matches_jax(masked):
    rng = np.random.RandomState(5)
    t = _transform(rng, 8.0, 1.0)
    pts0 = rng.uniform(-5, 5, (400, 3)).astype(np.float32)
    pts1 = (_apply(t, pts0) + 0.02 * rng.randn(400, 3)).astype(np.float32)
    pts1[rng.rand(400) < 0.3] += rng.uniform(-3, 3, (1, 3)).astype(
        np.float32)
    mask = rng.rand(400) > 0.2 if masked else None
    got = est_quad_linear_robust(
        torch.from_numpy(pts0), torch.from_numpy(pts1),
        mask=None if mask is None else torch.from_numpy(mask))
    ref = j_robust(jnp.asarray(pts0), jnp.asarray(pts1),
                   mask=None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(to_np(got), np.asarray(ref), rtol=0,
                               atol=1e-4)
    assert metrics.rte_rre(got, t)[0] < 0.1


# ----------------------------------------------------------------------
# metrics
# ----------------------------------------------------------------------

def test_metrics_match_jax():
    rng = np.random.RandomState(6)
    t_gt, t_est = _transform(rng, 20.0, 3.0), _transform(rng, 20.0, 3.0)
    t_near = t_gt.copy()
    t_near[:3, 3] += 0.5
    for a, b in ((t_est, t_gt), (t_near, t_gt), (t_gt, t_gt)):
        np.testing.assert_allclose(metrics.rte_rre(a, b),
                                   jmetrics.rte_rre(a, b), rtol=0, atol=1e-6)
        assert (metrics.registration_success(torch.from_numpy(a), b)
                == jmetrics.registration_success(a, b))
    xyz0 = rng.randn(50, 3).astype(np.float32)
    xyz1 = _apply(t_gt, xyz0) + 0.05 * rng.randn(50, 3).astype(np.float32)
    w = rng.rand(50).astype(np.float32)
    for weight in (None, w):
        got = metrics.corr_dist(
            torch.from_numpy(t_est), torch.from_numpy(t_gt),
            torch.from_numpy(xyz0), torch.from_numpy(xyz1),
            None if weight is None else torch.from_numpy(weight))
        ref = jmetrics.corr_dist(jnp.asarray(t_est), jnp.asarray(t_gt),
                                 jnp.asarray(xyz0), jnp.asarray(xyz1),
                                 None if weight is None
                                 else jnp.asarray(weight))
        assert float(got) == pytest.approx(float(ref), abs=1e-6)
    assert metrics.hit_ratio(torch.from_numpy(xyz0), xyz1, t_gt, 0.08) \
        == jmetrics.hit_ratio(xyz0, xyz1, t_gt, 0.08)
    trans = np.stack([t_est, t_near, t_gt])
    gts = np.stack([t_gt] * 3)
    np.testing.assert_allclose(
        metrics.TransformationLoss(5, 60)(trans, gts, None, None, None),
        jmetrics.TransformationLoss(5, 60)(trans, gts, None, None, None),
        rtol=0, atol=1e-6)
    pred, gt = rng.rand(200), rng.rand(200)
    assert (metrics.ClassificationLoss()(torch.from_numpy(pred), gt)
            == jmetrics.ClassificationLoss()(pred, gt))


# ----------------------------------------------------------------------
# ICP
# ----------------------------------------------------------------------

def test_icp_is_gcl_tpus_bit_for_bit():
    rng = np.random.RandomState(7)
    src = rng.uniform(-3, 3, (800, 3))
    t = _transform(rng, 3.0, 0.1).astype(np.float64)
    dst = src @ t[:3, :3].T + t[:3, 3] + 0.003 * rng.randn(800, 3)
    np.testing.assert_array_equal(icp.kabsch(src, dst), jicp.kabsch(src, dst))
    np.testing.assert_array_equal(icp.registration_icp(src, dst, 0.2),
                                  jicp.registration_icp(src, dst, 0.2))
    np.testing.assert_array_equal(icp.voxel_downsample(src, 0.25),
                                  jicp.voxel_downsample(src, 0.25))


@pytest.mark.parametrize("batch", [(), (3,), (2, 4)])
def test_decompose_and_concatenate_match_jax(batch):
    """decompose_trans's (R, t) equal gcl_tpu's; concatenate (first
    trans2, then trans1) within 1e-6 of gcl_tpu's, and acting on points
    as trans2 then trans1 do."""
    rng = np.random.RandomState(len(batch))
    n = int(np.prod(batch))
    t1, t2 = (np.stack([_transform(rng, 90, 5) for _ in range(n)]).reshape(
        *batch, 4, 4) for _ in range(2))
    for ours, ref in zip(se3.decompose_trans(torch.from_numpy(t1)),
                         jse3.decompose_trans(jnp.asarray(t1))):
        np.testing.assert_array_equal(to_np(ours), np.asarray(ref))
    got = to_np(se3.concatenate(torch.from_numpy(t1), torch.from_numpy(t2)))
    ref = np.asarray(jse3.concatenate(jnp.asarray(t1), jnp.asarray(t2)))
    assert got.shape == (*batch, 4, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    x = rng.randn(50, 3).astype(np.float32)
    flat = got.reshape(-1, 4, 4)
    for i in range(n):
        a, b = t1.reshape(-1, 4, 4)[i], t2.reshape(-1, 4, 4)[i]
        np.testing.assert_allclose(_apply(flat[i], x), _apply(a, _apply(b, x)),
                                   rtol=0, atol=1e-4)

