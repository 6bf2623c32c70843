"""Group-wise contrastive losses (port of gcl_tpu/losses/gcl.py): the
``finest`` loss, its ``location`` ablation without the finest term and the
``circle`` variant, with the three forms of the negative loss's
intra-group filter (spatial, reverse membership index, explicit pair list).

Every group reduction is a masked tensor op; there is no per-group loop.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..core.types import ColocationGroups
from .common import (masked_logsumexp, masked_mean, pair_isin, pdist_l2,
                     sample_uniform_index, sample_without_replacement,
                     sort_pairs, square_distance)

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
    safe_radius: float = 0.75
    log_scale: float = 16.0


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


class PairListNegFilter(NamedTuple):
    """Explicit intra-group filter of the negative loss: the (min, max)
    member pairs of every group (intra_group_pairs) and their mask. gcl_tpu
    hands the two as separate arguments; here they travel together."""

    pairs: torch.Tensor
    mask: torch.Tensor


# The filter of the negative loss: SpatialNegFilter, the reverse membership
# index int32[N, R] of member_group_index, or PairListNegFilter.
NegFilter = Union[SpatialNegFilter, torch.Tensor, PairListNegFilter]


class LossDraws(NamedTuple):
    """The uniforms of one loss call, already drawn: u_sel
    f32[min(max_pos_cluster, G)] picks the groups, u1 and u2
    f32[min(max_hn_samples, N)] the two negative subsets (the circle loss
    draws no subsets: None)."""

    u_sel: torch.Tensor
    u1: Optional[torch.Tensor] = None
    u2: Optional[torch.Tensor] = None


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


def negative_loss_from_sel(f_out, sel1, v1, sel2, v2, pos_pairs: NegFilter,
                           generator, cfg: GCLLossConfig, r=None):
    """The hardest-negative hinge given the two candidate subsets.

    A pair is no negative when it is intra-group, in one of three forms:
    a SpatialNegFilter (the two voxels lie within 2 * search radius in
    their sample's aligned frame: covers every co-membership, with no index
    to build; the training default), the reverse membership index
    int32[N, R] (the two voxels share a group id), or a PairListNegFilter
    (the pair is in the explicit list).
    """
    d = pdist_l2(f_out[sel1], f_out[sel2]) + _BIG * (~v2)[None, :]
    if cfg.use_hard_negative:
        dmin, j = d.min(dim=1)[0], torch.argmin(d, dim=1)
    else:
        j = sample_uniform_index(generator, v2, (sel1.shape[0],), r)
        dmin = torch.gather(d, 1, j[:, None])[:, 0]
    closest = sel2[j]
    mask_self = sel1 != closest
    if isinstance(pos_pairs, SpatialNegFilter):
        sid = pos_pairs.sample_id.long()
        same = sid[sel1] == sid[closest]
        d2 = ((pos_pairs.xyz[sel1] - pos_pairs.xyz[closest]) ** 2).sum(dim=1)
        lim = 2.0 * pos_pairs.radius[sid[sel1].clamp_min(0)]
        not_pos = ~(same & (d2 <= lim * lim))
    elif isinstance(pos_pairs, PairListNegFilter):
        a_s, b_s = sort_pairs(pos_pairs.pairs, pos_pairs.mask)
        not_pos = ~pair_isin(a_s, b_s, torch.minimum(sel1, closest),
                             torch.maximum(sel1, closest))
    else:
        ga = pos_pairs[sel1]        # [S, R] ids of the groups of each anchor
        gb = pos_pairs[closest]
        shared = (ga[:, :, None] == gb[:, None, :]) & (ga >= 0)[:, :, None]
        not_pos = ~shared.any(dim=2).any(dim=1)
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
                            pos_pairs: NegFilter,
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


def location_contrastive_loss(f_out: torch.Tensor, voxel_mask: torch.Tensor,
                              groups: ColocationGroups, pos_pairs: NegFilter,
                              generator: Optional[torch.Generator],
                              max_pos_cluster: int, max_hn_samples: int,
                              cfg: GCLLossConfig,
                              draws: Optional[LossDraws] = None
                              ) -> GCLLossOut:
    """The ablation without the finest term (its finest_loss is zero); the
    positive always uses the sqrt form."""
    u_sel, u1, u2 = draws if draws is not None else (None, None, None)
    sel_idx, sel_valid = sample_without_replacement(
        generator, groups.valid, max_pos_cluster, u_sel)
    feats, mm, centroid, _ = _group_features(f_out, groups, sel_idx,
                                             sel_valid)
    if cfg.use_pair_group_positive_loss:
        pos_d = _pair_positive_d(feats, mm, generator, square=False)
        pos_g = torch.relu(pos_d - cfg.pos_thresh)
    else:
        d2 = ((centroid[:, None, :] - feats) ** 2).sum(dim=-1)
        var = masked_mean(torch.sqrt(d2 + 1e-7), mm, dim=1)
        pos_g = torch.relu(var - cfg.pos_thresh)
    pos_loss = masked_mean(pos_g, sel_valid)
    neg_loss = _negative_loss(f_out, voxel_mask, pos_pairs, generator,
                              max_hn_samples, cfg, u1, u2)
    return GCLLossOut(pos_loss, f_out.new_zeros(()), neg_loss)


def location_circle_loss(f_out: torch.Tensor, voxel_mask: torch.Tensor,
                         groups: ColocationGroups, pos_pairs: NegFilter,
                         generator: Optional[torch.Generator],
                         max_pos_cluster: int, max_hn_samples: int,
                         cfg: GCLLossConfig,
                         draws: Optional[LossDraws] = None) -> GCLLossOut:
    """The circle-loss variant.

    positive / finest: softplus(logsumexp(s * d * detach(max(0, d)))) / s
    per group; negative: a logsumexp circle loss over the group centroids,
    masked by the spatial safe_radius between anchors and by the
    same-sample mask. ``voxel_mask``, ``pos_pairs`` and ``max_hn_samples``
    are unused: this loss mines its negatives among the selected groups.
    """
    ls = cfg.log_scale
    u_sel = draws.u_sel if draws is not None else None
    sel_idx, sel_valid = sample_without_replacement(
        generator, groups.valid, max_pos_cluster, u_sel)
    feats, mm, centroid, f_fin = _group_features(f_out, groups, sel_idx,
                                                 sel_valid)

    def circle_agg(d, m):
        w = d.clamp_min(0.0).detach()
        return F.softplus(masked_logsumexp(ls * d * w, m)) / ls

    if cfg.use_pair_group_positive_loss:
        pos_d = _pair_positive_d(feats, mm, generator, cfg.square_loss)
        pos_g = F.softplus(pos_d - cfg.pos_thresh)
    else:
        d2 = ((centroid[:, None, :] - feats) ** 2).sum(dim=-1)
        var_d = _sq_or_sqrt(d2, cfg.square_loss) - cfg.pos_thresh / 2.0
        pos_g = circle_agg(var_d, mm)
    pos_loss = masked_mean(pos_g, sel_valid)

    if cfg.block_finest_gradient:
        cols = torch.arange(mm.shape[1], device=mm.device)
        m_fin = mm & (cols[None, :]
                      != groups.finest_pos[sel_idx].long()[:, None])
        tgt = f_fin.detach()
    else:
        m_fin, tgt = mm, f_fin
    d2 = ((feats - tgt[:, None, :]) ** 2).sum(dim=-1)
    fin_d = _sq_or_sqrt(d2, cfg.square_loss) - cfg.finest_thresh
    finest_loss = masked_mean(circle_agg(fin_d, m_fin), sel_valid)

    coords = groups.anchor_xyz[sel_idx]
    item = groups.anchor_item[sel_idx]
    coords_dist = torch.sqrt(square_distance(coords, coords))
    feats_dist = torch.sqrt(square_distance(centroid, centroid,
                                            normalised=True))
    vv = sel_valid[:, None] & sel_valid[None, :]
    neg_mask = ((coords_dist > cfg.safe_radius)
                & (item[:, None] == item[None, :]) & vv)
    has_neg = neg_mask.any(dim=-1)
    neg_w = (cfg.neg_thresh
             - (feats_dist + 1e5 * (~neg_mask))).clamp_min(0.0).detach()
    # the logsumexp runs over every valid column: a masked-out one carries
    # weight 0 and contributes exp(0) = 1
    z = ls * (cfg.neg_thresh - feats_dist) * neg_w
    loss_row = F.softplus(masked_logsumexp(z, vv)) / ls
    neg_loss = masked_mean(loss_row, has_neg & sel_valid)
    return GCLLossOut(pos_loss, finest_loss, neg_loss)


def member_group_index(groups: ColocationGroups, n_total: int,
                       r_cap: int = 32) -> torch.Tensor:
    """Reverse membership index int32[n_total, r_cap]: the ids of the (at
    most r_cap, lowest first) groups that hold voxel row v, -1 padded. One
    sort of the member table; the negative loss tests co-membership of its
    sampled pairs by set intersection on it."""
    g_cap, kc = groups.member_idx.shape
    dev = groups.member_idx.device
    v = torch.where(groups.member_mask, groups.member_idx,
                    n_total).reshape(-1)
    gid = torch.arange(g_cap, dtype=torch.int32,
                       device=dev).repeat_interleave(kc)
    v_s, order = torch.sort(v, stable=True)
    g_s = gid[order]
    n = v_s.shape[0]
    iota = torch.arange(n, device=dev)
    new = torch.ones(n, dtype=torch.bool, device=dev)
    new[1:] = v_s[1:] != v_s[:-1]
    rank = iota - torch.cummax(torch.where(new, iota, 0), dim=0)[0]
    ok = (v_s < n_total) & (rank < r_cap)
    slot = torch.where(ok, v_s.long() * r_cap + rank, n_total * r_cap)
    out = torch.full((n_total * r_cap + 1,), -1, dtype=torch.int32,
                     device=dev)
    out[slot] = g_s
    return out[:n_total * r_cap].reshape(n_total, r_cap)


def intra_group_pairs(groups: ColocationGroups,
                      pair_cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """All unordered member pairs (min, max) of every valid group as a list
    of fixed capacity: (pairs int32[pair_cap, 2], mask bool[pair_cap]),
    padded, or compacted and cut when there are more."""
    kc = groups.member_idx.shape[1]
    dev = groups.member_idx.device
    iu, ju = torch.triu_indices(kc, kc, offset=1, device=dev)
    a = groups.member_idx[:, iu].reshape(-1)
    b = groups.member_idx[:, ju].reshape(-1)
    m = (groups.member_mask[:, iu] & groups.member_mask[:, ju]
         & groups.valid[:, None]).reshape(-1)
    pa, pb = torch.minimum(a, b), torch.maximum(a, b)
    total = pa.shape[0]
    if total <= pair_cap:
        pad = (0, pair_cap - total)
        return torch.stack([F.pad(pa, pad), F.pad(pb, pad)], 1), F.pad(m, pad)
    slot = torch.cumsum(m, 0) - 1
    slot = torch.where(m & (slot < pair_cap), slot, pair_cap)
    out = torch.zeros((pair_cap + 1, 2), dtype=torch.int32, device=dev)
    out[slot, 0] = pa
    out[slot, 1] = pb
    nvalid = m.sum().clamp_max(pair_cap)
    return out[:pair_cap], torch.arange(pair_cap, device=dev) < nvalid
