"""Multiway pose-graph GT refinement (a copy of gcl_tpu/data/posegraph.py
without its offline CLI that fills the ICP cache): for each side of a
training frame, all-pairs ICP between [current, complement...] clouds builds a
pose graph (consecutive = certain odometry edges, the rest = uncertain
loop closures), a robust Gauss-Newton optimisation with a line process
on the loop edges refines the node poses, and the per-complement
transforms go to the same `icp/<drive>_<t_next>_<t_curr>.npy` cache the
per-pair path uses. Host-side numpy.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


# ----------------------------------------------------------------------
# SE(3) algebra
# ----------------------------------------------------------------------

def _hat(w: np.ndarray) -> np.ndarray:
    return np.array([[0, -w[2], w[1]],
                     [w[2], 0, -w[0]],
                     [-w[1], w[0], 0]], np.float64)


def se3_exp(xi: np.ndarray) -> np.ndarray:
    """xi = (omega[3], v[3]) -> 4x4 transform."""
    w, v = xi[:3], xi[3:]
    th = np.linalg.norm(w)
    k = _hat(w)
    if th < 1e-12:
        r = np.eye(3) + k
        j = np.eye(3) + 0.5 * k
    else:
        a, b = np.sin(th) / th, (1 - np.cos(th)) / th ** 2
        c = (th - np.sin(th)) / th ** 3
        r = np.eye(3) + a * k + b * (k @ k)
        j = np.eye(3) + b * k + c * (k @ k)
    out = np.eye(4)
    out[:3, :3] = r
    out[:3, 3] = j @ v
    return out


def se3_log(t: np.ndarray) -> np.ndarray:
    """4x4 transform -> xi = (omega, v)."""
    r = t[:3, :3]
    cos = np.clip((np.trace(r) - 1) / 2, -1.0, 1.0)
    th = np.arccos(cos)
    if th < 1e-12:
        w = np.array([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0],
                      r[1, 0] - r[0, 1]]) * 0.5
        jinv = np.eye(3) - 0.5 * _hat(w)
    else:
        w = th / (2 * np.sin(th)) * np.array(
            [r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]])
        k = _hat(w)
        jinv = (np.eye(3) - 0.5 * k
                + (1 / th ** 2 - (1 + np.cos(th)) / (2 * th * np.sin(th)))
                * (k @ k))
    return np.concatenate([w, jinv @ t[:3, 3]])


# ----------------------------------------------------------------------
# Pose-graph optimization
# ----------------------------------------------------------------------

class Edge:
    """Relative measurement: points of node `s` map into node `t`'s frame
    by `m_st`; `weight` ~ correspondence count; `uncertain` marks loop
    closures eligible for the line-process downweight."""

    def __init__(self, s: int, t: int, m_st: np.ndarray, weight: float,
                 uncertain: bool):
        self.s, self.t, self.m_st = s, t, np.asarray(m_st, np.float64)
        self.weight = float(weight)
        self.uncertain = uncertain


def _edge_residual(p: List[np.ndarray], e: Edge) -> np.ndarray:
    # consistency: P_s == P_t @ m_st  (P_i maps node i frame -> node 0)
    return se3_log(np.linalg.inv(p[e.s]) @ p[e.t] @ e.m_st)


def optimize_pose_graph(n_nodes: int, edges: Sequence[Edge],
                        init: Sequence[np.ndarray] = None,
                        iters: int = 30, mu: float = 0.25,
                        damping: float = 1e-6) -> List[np.ndarray]:
    """Robust Gauss-Newton over node poses, node 0 fixed to identity.

    Line process on uncertain edges (the role of Open3D's
    GlobalOptimizationLevenbergMarquardt + edge_prune_threshold 0.25,
    reference :454-461): each loop edge gets l = (mu / (mu + w r^2))^2,
    re-evaluated per iteration, so bad loop closures fade out instead of
    corrupting the odometry chain. Jacobians are numerical — graphs here
    are tiny (1 + num_complement_one_side nodes).
    """
    if init is None:
        p = [np.eye(4) for _ in range(n_nodes)]
    else:
        p = [np.asarray(m, np.float64).copy() for m in init]
    base = np.linalg.inv(p[0])
    p = [base @ m for m in p]  # gauge: node 0 = identity

    n_var = n_nodes - 1
    eps = 1e-6
    for _ in range(iters):
        # line-process weights
        wts = []
        for e in edges:
            r = _edge_residual(p, e)
            w = e.weight
            if e.uncertain:
                q = w * float(r @ r)
                w = w * (mu / (mu + q)) ** 2
            wts.append(w)

        def stack(pp):
            return np.concatenate([_edge_residual(pp, e) for e in edges])

        r0 = stack(p)
        jac = np.zeros((len(r0), 6 * n_var))
        for i in range(n_var):
            for d in range(6):
                xi = np.zeros(6)
                xi[d] = eps
                pp = list(p)
                pp[i + 1] = p[i + 1] @ se3_exp(xi)
                jac[:, 6 * i + d] = (stack(pp) - r0) / eps
        wvec = np.repeat(np.sqrt(np.maximum(wts, 1e-12)), 6)
        a = jac * wvec[:, None]
        b = r0 * wvec
        h = a.T @ a + damping * np.eye(6 * n_var)
        try:
            dx = np.linalg.solve(h, -(a.T @ b))
        except np.linalg.LinAlgError:
            break
        for i in range(n_var):
            p[i + 1] = p[i + 1] @ se3_exp(dx[6 * i:6 * (i + 1)])
        if np.linalg.norm(dx) < 1e-10:
            break
    return p


# ----------------------------------------------------------------------
# Multiway registration (reference full_registration/multiway_registration)
# ----------------------------------------------------------------------

def _count_inliers(src: np.ndarray, dst: np.ndarray, m: np.ndarray,
                   max_dist: float) -> int:
    from scipy.spatial import cKDTree

    moved = src @ m[:3, :3].T + m[:3, 3]
    d, _ = cKDTree(dst).query(moved, k=1, distance_upper_bound=max_dist)
    return int(np.isfinite(d).sum())


def full_registration(clouds: List[np.ndarray],
                      odo: List[np.ndarray],
                      max_corr_coarse: float,
                      max_corr_fine: float) -> List[np.ndarray]:
    """All-pairs ICP + pose-graph optimization for one side.

    clouds: downsampled point clouds, node 0 = the current frame.
    odo[i]: odometry prior mapping node i's points into node 0's frame
    (velo2cam-conjugated; odo[0] = I). Returns refined P_i (node i ->
    node 0), the quantity the reference caches (:508-510).
    """
    n = len(clouds)
    from ..reg.icp import registration_icp

    edges = []
    for s in range(n):
        for t in range(s + 1, n):
            # init mapping s -> t from the odometry priors
            init = np.linalg.inv(odo[t]) @ odo[s]
            m_st = registration_icp(clouds[s], clouds[t], max_corr_coarse,
                                    init=init, max_iteration=200)
            w = max(1, _count_inliers(clouds[s], clouds[t], m_st,
                                      max_corr_fine))
            edges.append(Edge(s, t, m_st, w, uncertain=t != s + 1))
    return optimize_pose_graph(n, edges, init=odo)


def multiway_transforms(xyz_curr: np.ndarray,
                        xyz_cmpls: List[np.ndarray],
                        odo_cmpls: List[np.ndarray],
                        num_one_side: int,
                        icp_voxel_size: float = 0.05
                        ) -> List[np.ndarray]:
    """Refined (complement -> current) transforms, split left/right like
    the reference (:496-510): each side optimizes [curr] + its
    complements independently.

    odo_cmpls[i]: odometry prior mapping complement i into the current
    frame (what `kitti_io.odometry_pair_transform(pos_curr, pos_i)`
    yields).
    """
    from ..reg.icp import voxel_downsample

    sub_curr = voxel_downsample(xyz_curr, icp_voxel_size)
    subs = [voxel_downsample(x, icp_voxel_size) for x in xyz_cmpls]
    out: List[np.ndarray] = []
    for side in range(2):
        lo = side * num_one_side
        hi = lo + num_one_side
        clouds = [sub_curr] + subs[lo:hi]
        odo = [np.eye(4)] + [np.asarray(m, np.float64)
                             for m in odo_cmpls[lo:hi]]
        poses = full_registration(clouds, odo,
                                  max_corr_coarse=0.2,
                                  max_corr_fine=icp_voxel_size * 1.5)
        out.extend(poses[1:])
    return out
