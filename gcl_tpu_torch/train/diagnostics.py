"""Training diagnostics (port of gcl_tpu/train/diagnostics.py:
group_distance_errors, DistErrCollector): the distance-against-feature-error
study behind GCL's density-invariance figures. --calc_distance_err collects
per-member pairs for 20 iterations and writes them to
``dist_err_normal.npz`` in the run directory.
"""
from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from ..core.types import ColocationGroups


def group_distance_errors(f_out: torch.Tensor, groups: ColocationGroups,
                          central_distance: torch.Tensor):
    """Per member its (distance to the finest member's range, feature
    error to the finest member).

    central_distance f32[G, Kc]: each member's distance to its own LiDAR
    origin. Returns flat (dist_err [G * Kc], feat_err [G * Kc], mask
    [G * Kc]); entries outside the mask are meaningless.
    """
    feats = f_out[groups.member_idx.long().clamp_min(0)]     # [G, Kc, C]
    fin = groups.finest_pos.long()
    f_fin = torch.gather(
        feats, 1, fin[:, None, None].expand(-1, 1, feats.shape[2]))[:, 0]
    d_fin = torch.gather(central_distance, 1, fin[:, None])[:, 0]
    dist_err = central_distance - d_fin[:, None]
    feat_err = torch.sqrt(((feats - f_fin[:, None, :]) ** 2).sum(dim=-1))
    mask = groups.member_mask & groups.valid[:, None]
    return dist_err.reshape(-1), feat_err.reshape(-1), mask.reshape(-1)


class DistErrCollector:
    """Accumulates the per-iteration diagnostics and writes the reference's
    npz layout (``dist_err_<tail>.npz`` with arrays distance and err)."""

    def __init__(self, out_dir: str, max_iters: int = 20):
        self.out_dir = out_dir
        self.max_iters = max_iters
        self.all_dist: List[np.ndarray] = []
        self.all_err: List[np.ndarray] = []
        self.iters = 0

    def update(self, dist_err, feat_err, mask) -> bool:
        """Keep one iteration's masked entries; True once max_iters are
        in."""
        m = np.asarray(torch.as_tensor(mask).cpu())
        self.all_dist.append(np.asarray(torch.as_tensor(dist_err).cpu())[m])
        self.all_err.append(np.asarray(torch.as_tensor(feat_err).cpu())[m])
        self.iters += 1
        return self.iters >= self.max_iters

    def save(self, tail: str = "normal") -> str:
        path = os.path.join(self.out_dir, f"dist_err_{tail}")
        np.savez(path, distance=np.concatenate(self.all_dist),
                 err=np.concatenate(self.all_err))
        print("Saved distance-err points!", flush=True)
        return path + ".npz"
