"""Correspondence RANSAC with every hypothesis scored in one batched pass
(port of gcl_tpu/reg/ransac.py).

A fixed number of minimal samples is drawn, each passes Open3D's
edge-length check or scores nothing, each is scored by its inlier count
(``distance_threshold``), the first best is refined by iterative
reweighted Kabsch over its inliers. Hypotheses are scored ``batch`` at a
time (1024, as gcl_tpu's lax.map), their 3x3 SVDs batched in
reg/procrustes.py. The spans (utils.spans) ``ransac/draw``,
``ransac/score`` (every batch) and ``ransac/refine`` name ransac_pose's
stages in a profiler trace.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..utils.spans import span
from .procrustes import rigid_transform_3d
from .se3 import transform

HYPOTHESIS_BATCH = 1024


def _norm(d: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, written as jnp.linalg.norm."""
    return torch.sqrt((d * d).sum(dim=-1))


def score_hypotheses(src: torch.Tensor, tgt: torch.Tensor,
                     samples: torch.Tensor, distance_threshold: float,
                     edge_length_ratio: float, valid: torch.Tensor,
                     batch: int = HYPOTHESIS_BATCH):
    """(trans f[H, 4, 4], fitness int64[H]) of the minimal samples
    ``samples`` int[H, S] (rows of src / tgt): the Kabsch fit of each
    sample, and its count of valid inliers, zero where an edge of the
    sample fails the length check."""
    s_n = samples.shape[1]
    off = ~torch.eye(s_n, dtype=torch.bool, device=src.device)
    trans_h, fit_h = [], []
    for idx in torch.split(samples.to(src.device).long(), batch):
        s, t = src[idx], tgt[idx]                          # [B, S, 3]
        ds = _norm(s[:, :, None] - s[:, None])
        dt = _norm(t[:, :, None] - t[:, None])
        ok_edge = (((ds * edge_length_ratio <= dt + 1e-9)
                    & (dt * edge_length_ratio <= ds + 1e-9)) | ~off
                   ).flatten(1).all(dim=1)
        trans = rigid_transform_3d(s, t)                   # [B, 4, 4]
        moved = src[None] @ trans[:, :3, :3].transpose(1, 2) \
            + trans[:, None, :3, 3]
        d = _norm(moved - tgt[None])                       # [B, N]
        inl = (d < distance_threshold) & valid[None]
        trans_h.append(trans)
        fit_h.append(inl.sum(dim=1) * ok_edge.long())
    return torch.cat(trans_h), torch.cat(fit_h)


def ransac_pose(src: torch.Tensor, tgt: torch.Tensor,
                distance_threshold: float, *,
                generator: Optional[torch.Generator] = None,
                samples: Optional[torch.Tensor] = None,
                num_hypotheses: int = 16384, sample_size: int = 3,
                edge_length_ratio: float = 0.8,
                mask: Optional[torch.Tensor] = None,
                refine_iters: int = 10):
    """The transform aligning corresponding src[i] -> tgt[i] ([N, 3] each).

    The minimal samples are drawn as gcl_tpu draws them (integers in [0,
    2^30) mod the valid count, mapped onto the valid rows in row order)
    from ``generator`` (a CPU generator), unless ``samples`` int[H, S]
    hands in the rows. ``mask`` bool[N] marks valid rows (None: all).
    Returns (trans [4, 4], inlier_mask bool[N], fitness: inliers / valid
    rows).
    """
    n = src.shape[0]
    dev = src.device
    valid = (torch.ones(n, dtype=torch.bool, device=dev) if mask is None
             else mask.to(dev))
    nvalid = valid.sum().clamp_min(1)
    with span("ransac/draw"):
        if samples is None:
            order = torch.argsort((~valid).to(torch.uint8), stable=True)
            draws = torch.randint(0, 2 ** 30, (num_hypotheses, sample_size),
                                  generator=generator).to(dev)
            samples = order[draws % nvalid]
    with span("ransac/score"):
        trans_h, fit_h = score_hypotheses(src, tgt, samples,
                                          distance_threshold,
                                          edge_length_ratio, valid)
        trans = trans_h[torch.argmax(fit_h)]

    with span("ransac/refine"):
        for _ in range(refine_iters):
            d = _norm(transform(src, trans) - tgt)
            w = ((d < distance_threshold) & valid).to(src.dtype)
            trans = rigid_transform_3d(src[None], tgt[None], w[None])[0]
        d = _norm(transform(src, trans) - tgt)
        inlier = (d < distance_threshold) & valid
        return trans, inlier, inlier.sum() / nvalid
