"""SE(3) helpers (port of gcl_tpu/reg/se3.py)."""
from __future__ import annotations

import torch


def transform(pts: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """R @ pts + t for pts [N, 3] with trans [4, 4], or [bs, N, 3] with
    [bs, 4, 4]."""
    if pts.dim() == 3:
        out = trans[:, :3, :3] @ pts.transpose(1, 2) + trans[:, :3, 3:4]
        return out.transpose(1, 2)
    return pts @ trans[:3, :3].T + trans[:3, 3]


def integrate_trans(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """R [..., 3, 3], t [..., 3, 1] -> [..., 4, 4]."""
    batch = r.shape[:-2]
    out = torch.eye(4, dtype=r.dtype, device=r.device).expand(
        *batch, 4, 4).clone()
    out[..., :3, :3] = r
    out[..., :3, 3:4] = t.reshape(*batch, 3, 1)
    return out


def decompose_trans(trans: torch.Tensor):
    """[..., 4, 4] -> (R [..., 3, 3], t [..., 3, 1])."""
    return trans[..., :3, :3], trans[..., :3, 3:4]


def concatenate(trans1: torch.Tensor, trans2: torch.Tensor) -> torch.Tensor:
    """Composite transform: first trans2, then trans1."""
    r1, t1 = decompose_trans(trans1)
    r2, t2 = decompose_trans(trans2)
    return integrate_trans(r1 @ r2, r1 @ t2 + t1)
