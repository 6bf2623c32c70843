"""Weighted rigid alignment (weighted Kabsch via batched 3x3 SVD), port of
gcl_tpu/reg/procrustes.py."""
from __future__ import annotations

from typing import Optional

import torch

from .se3 import integrate_trans


def rigid_transform_3d(a: torch.Tensor, b: torch.Tensor,
                       weights: Optional[torch.Tensor] = None,
                       weight_threshold: float = 0.0) -> torch.Tensor:
    """Weighted least-squares rigid transform mapping a -> b.

    a, b: [bs, n, 3]; weights: [bs, n] (None = uniform). Returns
    [bs, 4, 4]. R = V diag(1, 1, det(V U^T)) U^T, as gcl_tpu writes it; R
    is unique where the singular values are distinct, whatever signs the
    SVD picks.
    """
    if weights is None:
        weights = torch.ones(a.shape[:2], dtype=a.dtype, device=a.device)
    weights = torch.where(weights < weight_threshold, 0.0, weights)
    wsum = weights.sum(dim=1, keepdim=True)[:, :, None] + 1e-6
    centroid_a = (a * weights[:, :, None]).sum(dim=1, keepdim=True) / wsum
    centroid_b = (b * weights[:, :, None]).sum(dim=1, keepdim=True) / wsum
    am = a - centroid_a
    bm = b - centroid_b
    h = torch.einsum("bnc,bn,bnd->bcd", am, weights, bm)
    u, _, vh = torch.linalg.svd(h, full_matrices=False)
    v = vh.transpose(1, 2)
    ut = u.transpose(1, 2)
    det = torch.linalg.det(v @ ut)
    eye = torch.eye(3, dtype=a.dtype, device=a.device).expand(
        a.shape[0], 3, 3).clone()
    eye[:, 2, 2] = det
    r = v @ eye @ ut
    t = centroid_b.transpose(1, 2) - r @ centroid_a.transpose(1, 2)
    return integrate_trans(r, t)
