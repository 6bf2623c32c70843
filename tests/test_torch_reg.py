"""Parity of gcl_tpu_torch.reg (weighted Kabsch, SC2-PCR) with gcl_tpu.reg.

Tolerances: rigid_transform_3d 1e-5 (the same float32 3x3 SVD problem
through two LAPACK calls); SC2-PCR transforms 1e-3 (twenty reweighted
Kabsch rounds and 20-step power iterations carry float32 rounding
differences, far below the 0.6 m inlier threshold that decides seeds).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcl_tpu.reg.procrustes import rigid_transform_3d as j_rigid
from gcl_tpu.reg.sc2pcr import Matcher as JMatcher
from gcl_tpu_torch.data.device_pipeline import transform_points
from gcl_tpu_torch.infer import kitti_matcher
from gcl_tpu_torch.reg.procrustes import rigid_transform_3d
from gcl_tpu_torch.reg.se3 import transform

from _torch_parity import to_np


def _rot(rng, max_deg):
    axis = rng.randn(3)
    axis /= np.linalg.norm(axis)
    th = np.radians(rng.uniform(-max_deg, max_deg))
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k


def _transform(rng, max_deg=30.0, max_t=3.0):
    t = np.eye(4, dtype=np.float32)
    t[:3, :3] = _rot(rng, max_deg)
    t[:3, 3] = rng.uniform(-max_t, max_t, 3)
    return t


def _j_matcher(n):
    return JMatcher(inlier_threshold=0.6, num_node="all", use_mutual=False,
                    d_thre=0.1, num_iterations=20, ratio=0.2,
                    nms_radius=0.6, max_points=n, k1=30, k2=20)


def test_rigid_transform_matches_jax():
    rng = np.random.RandomState(0)
    bs, n = 6, 50
    a = rng.randn(bs, n, 3).astype(np.float32) * 5
    ts = np.stack([_transform(rng) for _ in range(bs)])
    b = (np.einsum("bij,bnj->bni", ts[:, :3, :3], a) + ts[:, None, :3, 3]
         + rng.randn(bs, n, 3) * 0.01).astype(np.float32)
    w = rng.rand(bs, n).astype(np.float32)
    w[:, :5] = 0.0
    out = to_np(rigid_transform_3d(torch.from_numpy(a), torch.from_numpy(b),
                                   torch.from_numpy(w)))
    ref = np.asarray(j_rigid(jnp.asarray(a), jnp.asarray(b),
                             jnp.asarray(w)))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out, ts, atol=0.02)


def _corr_set(seed, n=400, outlier=0.3):
    """Pinned correspondences: src in a 40 m scene, tgt = T src + 1 cm
    noise, ``outlier`` of them replaced by random points."""
    rng = np.random.RandomState(seed)
    t = _transform(rng)
    src = (rng.rand(n, 3) * [40, 40, 4] - [20, 20, 2]).astype(np.float32)
    tgt = src @ t[:3, :3].T + t[:3, 3] + rng.randn(n, 3) * 0.01
    bad = rng.rand(n) < outlier
    tgt[bad] = rng.rand(bad.sum(), 3) * [40, 40, 4] - [20, 20, 2]
    return src, tgt.astype(np.float32), t


@pytest.mark.parametrize("seed", [0, 1])
def test_sc2pcr_core_matches_jax_and_recovers(seed):
    src, tgt, t_gt = _corr_set(seed)
    out = to_np(kitti_matcher(len(src)).SC2_PCR(
        torch.from_numpy(src)[None], torch.from_numpy(tgt)[None]))[0]
    ref = np.asarray(_j_matcher(len(src)).SC2_PCR(
        jnp.asarray(src)[None], jnp.asarray(tgt)[None]))[0]
    np.testing.assert_allclose(out, ref, atol=1e-3)
    np.testing.assert_allclose(out, t_gt, atol=0.02)
    np.testing.assert_allclose(ref, t_gt, atol=0.02)


def test_estimator_matches_jax_on_same_features():
    """match_pair + SC2-PCR + labels, both fed the same keypoints and unit
    features (tgt features = a noisy shuffle of src's, a few swapped)."""
    rng = np.random.RandomState(4)
    n = 300
    src, tgt_pts, t_gt = _corr_set(4, n=n, outlier=0.0)
    perm = rng.permutation(n)
    tgt = tgt_pts[perm]
    fs = rng.randn(n, 16).astype(np.float32)
    ft = fs[perm] + rng.randn(n, 16).astype(np.float32) * 0.05
    ft[:60] = rng.randn(60, 16)
    fs /= np.linalg.norm(fs, axis=1, keepdims=True)
    ft /= np.linalg.norm(ft, axis=1, keepdims=True)
    args = [x[None] for x in (src, tgt, fs, ft)]
    t_p, lab_p, sc_p, tc_p = kitti_matcher(n).estimator(
        *[torch.from_numpy(a) for a in args])
    t_j, lab_j, sc_j, tc_j = _j_matcher(n).estimator(
        *[jnp.asarray(a) for a in args], jax.random.PRNGKey(0))
    np.testing.assert_array_equal(to_np(tc_p), np.asarray(tc_j))
    np.testing.assert_allclose(to_np(t_p), np.asarray(t_j), atol=1e-3)
    np.testing.assert_array_equal(to_np(lab_p), np.asarray(lab_j))
    np.testing.assert_allclose(to_np(t_p)[0], t_gt, atol=0.02)


def test_transform_matches_numpy():
    rng = np.random.RandomState(2)
    t = _transform(rng)
    p = rng.randn(2, 10, 3).astype(np.float32)
    ref = p @ t[:3, :3].T + t[:3, 3]
    out = transform(torch.from_numpy(p),
                    torch.from_numpy(np.stack([t, t])))
    np.testing.assert_allclose(to_np(out), ref, rtol=1e-5, atol=1e-5)
    for out in (transform(torch.from_numpy(p[0]), torch.from_numpy(t)),
                transform_points(torch.from_numpy(p[0]),
                                 torch.from_numpy(t))):
        np.testing.assert_allclose(to_np(out), ref[0], rtol=1e-5, atol=1e-5)
