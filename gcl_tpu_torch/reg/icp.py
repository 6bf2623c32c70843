"""Point-to-point ICP on the host (numpy + scipy; a copy of
gcl_tpu/reg/icp.py): the ground-truth refinement of the pair datasets
(threshold 0.2 m, identity init, at most 200 iterations), nearest
neighbours by scipy's cKDTree, a closed-form Kabsch update per
iteration, stopped when the RMSE changes by less than 1e-6 of itself.
"""
from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def kabsch(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Rigid transform mapping src -> dst (least squares)."""
    cs, cd = src.mean(0), dst.mean(0)
    h = (src - cs).T @ (dst - cd)
    u, _, vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    s = np.diag([1.0, 1.0, d])
    r = vt.T @ s @ u.T
    t = cd - r @ cs
    out = np.eye(4)
    out[:3, :3] = r
    out[:3, 3] = t
    return out


def registration_icp(source: np.ndarray, target: np.ndarray,
                     max_correspondence_distance: float,
                     init: np.ndarray | None = None,
                     max_iteration: int = 200,
                     relative_rmse: float = 1e-6) -> np.ndarray:
    """Align `source` onto `target`; returns the 4x4 transformation."""
    t = np.eye(4) if init is None else init.copy()
    tree = cKDTree(target)
    prev_rmse = np.inf
    src = source @ t[:3, :3].T + t[:3, 3]
    for _ in range(max_iteration):
        dist, idx = tree.query(src, k=1,
                               distance_upper_bound=max_correspondence_distance)
        ok = np.isfinite(dist)
        if ok.sum() < 3:
            break
        upd = kabsch(src[ok], target[idx[ok]])
        t = upd @ t
        src = src @ upd[:3, :3].T + upd[:3, 3]
        rmse = float(np.sqrt((dist[ok] ** 2).mean()))
        if abs(prev_rmse - rmse) < relative_rmse * max(prev_rmse, 1e-12):
            break
        prev_rmse = rmse
    return t


def voxel_downsample(xyz: np.ndarray, voxel_size: float) -> np.ndarray:
    """First-point-per-voxel downsample (ME.utils.sparse_quantize
    return_index semantics on the host)."""
    coords = np.floor(xyz / voxel_size).astype(np.int64)
    _, sel = np.unique(coords, axis=0, return_index=True)
    return xyz[np.sort(sel)]
