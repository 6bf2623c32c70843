"""Feature nearest-neighbour matching (port of gcl_tpu/reg/matching.py):
chunked brute-force argmin on the device, scipy's cKDTree on the host.

d2 is |a|^2 + |b|^2 - 2 a.b, as gcl_tpu writes it; the product rounds
otherwise than XLA's, so near ties (rows whose best and second-best d2
lie within rounding) may pick another row. float32 products must not run
in TF32 on the card (torch.backends.cuda.matmul.allow_tf32 = False).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..utils.spans import span

_BIG = 1e30


def find_nn(f0: torch.Tensor, f1: torch.Tensor,
            mask1: Optional[torch.Tensor] = None, chunk: int = 2048,
            squared: bool = True):
    """Nearest row of f1 for every row of f0, ``chunk`` rows of f0 at a
    time. Rows of f1 where ``mask1`` is False are never chosen (unless all
    are). Returns (inds int64[N0], dists[N0]): d2, or sqrt(d2 + 1e-7)
    when not ``squared``; ties go to the lower index. Runs inside the span
    ``match/nn`` (utils.spans)."""
    with span("match/nn"):
        n1sq = (f1 * f1).sum(dim=1)
        if mask1 is not None:
            n1sq = torch.where(mask1, n1sq, _BIG)
        inds, d2 = [], []
        for fc in torch.split(f0, chunk):
            d = ((fc * fc).sum(dim=1)[:, None] + n1sq[None, :]
                 - 2.0 * fc @ f1.T)
            if mask1 is not None:
                d = torch.where(mask1[None, :], d, _BIG)
            dmin, imin = torch.min(d, dim=1)
            inds.append(imin)
            d2.append(dmin)
        inds = (torch.cat(inds) if inds
                else f0.new_zeros(0, dtype=torch.long))
        d2 = torch.cat(d2).clamp_min(0.0) if d2 else f0.new_zeros(0)
        return inds, (d2 if squared else torch.sqrt(d2 + 1e-7))


def find_nn_cpu(feat0, feat1, return_distance: bool = False):
    """scipy cKDTree nearest neighbour of every row of feat0 in feat1."""
    from scipy.spatial import cKDTree

    dists, nn_inds = cKDTree(feat1).query(feat0, k=1)
    if return_distance:
        return nn_inds, dists
    return nn_inds


def find_corr(xyz0: torch.Tensor, xyz1: torch.Tensor, f0: torch.Tensor,
              f1: torch.Tensor, generator: Optional[torch.Generator] = None,
              subsample_size: int = -1, chunk: int = 2048,
              inds: Optional[Sequence[torch.Tensor]] = None):
    """Feature-NN correspondence sets, each side first subsampled without
    replacement to ``subsample_size`` rows where it has more. The draws
    come from ``generator`` (a CPU generator), or ``inds`` = (inds0,
    inds1) hands them in (inds1 is used only where f1 has more rows).
    Returns (xyz0_corr, xyz1_corr)."""
    n0, n1 = f0.shape[0], f1.shape[0]
    if 0 < subsample_size < n0:
        if inds is None:
            inds = (torch.randperm(n0, generator=generator)[:subsample_size],
                    torch.randperm(n1, generator=generator)[:subsample_size])
        i0 = inds[0].to(f0.device)
        f0, xyz0 = f0[i0], xyz0[i0]
        if subsample_size < n1:
            i1 = inds[1].to(f1.device)
            f1, xyz1 = f1[i1], xyz1[i1]
    nn, _ = find_nn(f0, f1, chunk=chunk)
    return xyz0, xyz1[nn]


def mutual_feature_match(src_feats: torch.Tensor, tgt_feats: torch.Tensor,
                         tgt_mask: Optional[torch.Tensor] = None,
                         chunk: int = 2048) -> torch.Tensor:
    """SC2-PCR's coarse matching: the nearest target feature of every
    source feature (argmin of the normalised features' distance)."""
    return find_nn(src_feats, tgt_feats, tgt_mask, chunk=chunk)[0]
