"""Group-wise contrastive loss (port of gcl_tpu/losses/gcl.py: the
``finest`` loss with the spatial negative filter).

Every group reduction is a masked tensor op; there is no per-group loop.
The ``location`` and ``circle`` losses and the membership / pair-list forms
of the negative filter are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..core.types import ColocationGroups
from .common import (masked_mean, pdist_l2, sample_uniform_index,
                     sample_without_replacement)

_BIG = 1e9


@dataclasses.dataclass(frozen=True)
class GCLLossConfig:
    pos_thresh: float = 0.1
    finest_thresh: float = 0.2
    neg_thresh: float = 1.4
    square_loss: bool = True
    block_finest_gradient: bool = True
    use_hard_negative: bool = True
    use_pair_group_positive_loss: bool = False


class GCLLossOut(NamedTuple):
    pos_loss: torch.Tensor
    finest_loss: torch.Tensor
    neg_loss: torch.Tensor


class SpatialNegFilter(NamedTuple):
    """Geometric intra-group filter of the negative loss: a pair is no
    negative when the two voxels lie within 2 * radius in their sample's
    aligned (centre) frame.

    xyz: f32[N, 3] aligned positions (junk on padded rows is fine: they
    are never sampled); sample_id: int[N]; radius: f32[B] per-sample group
    search radius.
    """

    xyz: torch.Tensor
    sample_id: torch.Tensor
    radius: torch.Tensor


class LossDraws(NamedTuple):
    """The uniforms of one finest_contrastive_loss call, already drawn:
    u_sel f32[min(max_pos_cluster, G)] picks the groups, u1 and u2
    f32[min(max_hn_samples, N)] the two negative subsets."""

    u_sel: torch.Tensor
    u1: torch.Tensor
    u2: torch.Tensor


def _group_features(f_out, groups: ColocationGroups, sel_idx, sel_valid):
    """Member features of the selected groups: (feats [M, Kc, C], mmask
    [M, Kc], centroid [M, C], finest_feat [M, C])."""
    mi = groups.member_idx[sel_idx].long()
    mm = groups.member_mask[sel_idx] & sel_valid[:, None]
    feats = f_out[mi.clamp_min(0)] * mm[..., None]
    cnt = mm.sum(dim=1, keepdim=True).clamp_min(1)
    centroid = feats.sum(dim=1) / cnt
    fin = groups.finest_pos[sel_idx].long()
    finest_feat = torch.gather(
        feats, 1, fin[:, None, None].expand(-1, 1, feats.shape[2]))[:, 0]
    return feats, mm, centroid, finest_feat


def _sq_or_sqrt(d2, square: bool):
    return d2 if square else torch.sqrt(d2 + 1e-7)


def _pair_positive_d(feats, mm, generator, square: bool, score_u=None):
    """Distance between two random distinct members of each group
    (use_pair_group_positive_loss). ``score_u`` f32[M, Kc] hands in the
    uniforms."""
    if score_u is None:
        score_u = torch.rand(mm.shape, generator=generator,
                             device=mm.device)
    score = score_u + (~mm) * 2.0
    two = torch.sort(score, dim=1, stable=True)[1][:, :2]  # two valid cols
    c = feats.shape[2]
    fa = torch.gather(feats, 1, two[:, 0:1, None].expand(-1, 1, c))[:, 0]
    fb = torch.gather(feats, 1, two[:, 1:2, None].expand(-1, 1, c))[:, 0]
    return _sq_or_sqrt(((fa - fb) ** 2).sum(dim=1), square)


def negative_loss_from_sel(f_out, sel1, v1, sel2, v2,
                           pos_pairs: SpatialNegFilter, generator,
                           cfg: GCLLossConfig, r=None):
    """The hardest-negative hinge given the two candidate subsets."""
    if not isinstance(pos_pairs, SpatialNegFilter):
        raise NotImplementedError(
            "only the SpatialNegFilter form of the negative filter is "
            "ported (not the membership index or the explicit pair list)")
    d = pdist_l2(f_out[sel1], f_out[sel2]) + _BIG * (~v2)[None, :]
    if cfg.use_hard_negative:
        dmin, j = d.min(dim=1)[0], torch.argmin(d, dim=1)
    else:
        j = sample_uniform_index(generator, v2, (sel1.shape[0],), r)
        dmin = torch.gather(d, 1, j[:, None])[:, 0]
    closest = sel2[j]
    mask_self = sel1 != closest
    sid = pos_pairs.sample_id.long()
    same = sid[sel1] == sid[closest]
    d2 = ((pos_pairs.xyz[sel1] - pos_pairs.xyz[closest]) ** 2).sum(dim=1)
    lim = 2.0 * pos_pairs.radius[sid[sel1].clamp_min(0)]
    not_pos = ~(same & (d2 <= lim * lim))
    m = not_pos & mask_self & v1 & v2[j]
    return masked_mean(torch.relu(cfg.neg_thresh - dmin) ** 2, m)


def _negative_loss(f_out, voxel_mask, pos_pairs, generator, max_hn_samples,
                   cfg: GCLLossConfig, u1=None, u2=None):
    """Hardest-negative hinge over two random voxel subsets."""
    sel1, v1 = sample_without_replacement(generator, voxel_mask,
                                          max_hn_samples, u1)
    sel2, v2 = sample_without_replacement(generator, voxel_mask,
                                          max_hn_samples, u2)
    return negative_loss_from_sel(f_out, sel1, v1, sel2, v2, pos_pairs,
                                  generator, cfg)


def finest_contrastive_loss(f_out: torch.Tensor, voxel_mask: torch.Tensor,
                            groups: ColocationGroups,
                            pos_pairs: SpatialNegFilter,
                            generator: Optional[torch.Generator],
                            max_pos_cluster: int, max_hn_samples: int,
                            cfg: GCLLossConfig,
                            draws: Optional[LossDraws] = None) -> GCLLossOut:
    """The GCL loss.

    positive: relu(mean_m ||centroid - f_m||^2 - pos_thresh) per group;
    finest:   relu(||centroid - f_finest||^2 - finest_thresh) per group
              (the gradient-blocked variant leaves the finest member out
              of the centroid, detaches it and always uses the sqrt form);
    negative: hardest-negative hinge over two independent voxel subsets.

    The random picks come from ``generator`` unless ``draws`` hands in
    their uniforms.
    """
    u_sel, u1, u2 = draws if draws is not None else (None, None, None)
    sel_idx, sel_valid = sample_without_replacement(
        generator, groups.valid, max_pos_cluster, u_sel)
    feats, mm, centroid, f_fin = _group_features(f_out, groups, sel_idx,
                                                 sel_valid)

    if cfg.use_pair_group_positive_loss:
        pos_d = _pair_positive_d(feats, mm, generator, cfg.square_loss)
        pos_g = torch.relu(pos_d - cfg.pos_thresh)
    else:
        d2 = ((centroid[:, None, :] - feats) ** 2).sum(dim=-1)
        var = masked_mean(_sq_or_sqrt(d2, cfg.square_loss), mm, dim=1)
        pos_g = torch.relu(var - cfg.pos_thresh)
    pos_loss = masked_mean(pos_g, sel_valid)

    if cfg.block_finest_gradient:
        cols = torch.arange(mm.shape[1], device=mm.device)
        not_fin = mm & (cols[None, :]
                        != groups.finest_pos[sel_idx].long()[:, None])
        cnt = not_fin.sum(dim=1, keepdim=True).clamp_min(1)
        blocked_centroid = (feats * not_fin[..., None]).sum(dim=1) / cnt
        d2 = ((blocked_centroid - f_fin.detach()) ** 2).sum(dim=-1)
        fin_g = torch.relu(torch.sqrt(d2 + 1e-7) - cfg.finest_thresh)
    else:
        d2 = ((centroid - f_fin) ** 2).sum(dim=-1)
        fin_g = torch.relu(_sq_or_sqrt(d2, cfg.square_loss)
                           - cfg.finest_thresh)
    finest_loss = masked_mean(fin_g, sel_valid)

    neg_loss = _negative_loss(f_out, voxel_mask, pos_pairs, generator,
                              max_hn_samples, cfg, u1, u2)
    return GCLLossOut(pos_loss, finest_loss, neg_loss)
