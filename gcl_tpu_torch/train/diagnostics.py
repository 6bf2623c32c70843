"""Training diagnostics (port of gcl_tpu/train/diagnostics.py:
group_distance_errors): the distance-against-feature-error study behind
GCL's density-invariance figures.
"""
from __future__ import annotations

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
