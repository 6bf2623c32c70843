"""FCGF pairwise metric-learning losses (port of gcl_tpu/losses/pairs.py):
the hardest-negative and random-negative contrastive losses and the two
triplet losses, over padded features with row masks and a fixed-capacity
list of positive (i0, i1) pairs with its mask. Whether a mined negative is
in fact a positive is decided by exact pair-set membership over the sorted
positive list (losses.common.sort_pairs / pair_isin).

Every loss draws its selections from a torch.Generator unless
``draws`` (PairLossDraws) hands in the numbers already drawn, so a test can
give both packages the same selections.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .common import (masked_mean, pair_isin, pdist_l2, sample_uniform_index,
                     sample_without_replacement, sort_pairs)

_BIG = 1e9


class PairLossOut(NamedTuple):
    pos_loss: torch.Tensor
    neg_loss: torch.Tensor


class TripletLossOut(NamedTuple):
    loss: torch.Tensor
    pos_dist: torch.Tensor
    neg_dist: torch.Tensor


class PairLossDraws(NamedTuple):
    """The random numbers of one pair-loss call, already drawn: pos
    f32[min(num_pos, M)] picks the positive pairs (M the pair list's
    length); hn0 / hn1 f32[min(num_hn_samples, N)] the hardest-negative
    candidates of side 0 / 1; rand f32[min(num_rand_triplet, M)] the random
    triplets' pairs and neg f32[min(num_rand_triplet, N1)] their negatives;
    r0 / r1 int[num_neg] in [0, N) the contrastive loss's random rows. A
    loss reads only its own fields; None draws from the generator."""

    pos: Optional[torch.Tensor] = None
    hn0: Optional[torch.Tensor] = None
    hn1: Optional[torch.Tensor] = None
    rand: Optional[torch.Tensor] = None
    neg: Optional[torch.Tensor] = None
    r0: Optional[torch.Tensor] = None
    r1: Optional[torch.Tensor] = None


def _select_pos(generator, pairs, pair_mask, num_pos, u=None):
    idx, valid = sample_without_replacement(generator, pair_mask, num_pos, u)
    p = pairs[idx]
    return p[:, 0], p[:, 1], valid


def _hardest(pos_f, f, sel, v):
    """Per row of pos_f its nearest candidate among f[sel] (invalid
    candidates pushed _BIG away): (distance, candidate row)."""
    d = pdist_l2(pos_f, f[sel]) + _BIG * (~v).to(pos_f.dtype)[None, :]
    dmin, j = torch.min(d, dim=1)
    return dmin, sel[j]


def _dist(a, b):
    return torch.sqrt(((a - b) ** 2).sum(dim=1) + 1e-7)


def hardest_contrastive_loss(f0, f1, mask0, mask1, pairs, pair_mask,
                             generator, num_pos: int, num_hn_samples: int,
                             pos_thresh: float, neg_thresh: float,
                             draws: Optional[PairLossDraws] = None
                             ) -> PairLossOut:
    """Hardest-negative contrastive loss (FCGF's).

    pos = relu(||f0_i - f1_j||^2 - pos_thresh) over sampled positive
    pairs; neg = relu(neg_thresh - d_hardest)^2 in both directions, the
    hardest negatives mined over random candidate subsets of each side and
    filtered against the full positive set.
    """
    d = draws or PairLossDraws()
    i0, i1, pv = _select_pos(generator, pairs, pair_mask, num_pos, d.pos)
    pos_f0, pos_f1 = f0[i0], f1[i1]
    sel0, v0 = sample_without_replacement(generator, mask0, num_hn_samples,
                                          d.hn0)
    sel1, v1 = sample_without_replacement(generator, mask1, num_hn_samples,
                                          d.hn1)
    d01min, n01 = _hardest(pos_f0, f1, sel1, v1)
    d10min, n10 = _hardest(pos_f1, f0, sel0, v0)

    a_s, b_s = sort_pairs(pairs, pair_mask)
    m0 = ~pair_isin(a_s, b_s, i0, n01) & pv
    m1 = ~pair_isin(a_s, b_s, n10, i1) & pv

    pos_loss = masked_mean(
        torch.relu(((pos_f0 - pos_f1) ** 2).sum(dim=1) - pos_thresh), pv)
    neg0 = masked_mean(torch.relu(neg_thresh - d01min) ** 2, m0)
    neg1 = masked_mean(torch.relu(neg_thresh - d10min) ** 2, m1)
    return PairLossOut(pos_loss, 0.5 * (neg0 + neg1))


def contrastive_loss(f0, f1, mask0, mask1, pairs, pair_mask, generator,
                     neg_thresh: float, num_neg: int,
                     draws: Optional[PairLossDraws] = None) -> PairLossOut:
    """Random-negative contrastive loss: pos = mean ||f0_i - f1_j||^2 over
    the positive pairs; neg = hinge on random (i, j) pairs that are not
    positives."""
    d = draws or PairLossDraws()
    i0 = sample_uniform_index(generator, mask0, (num_neg,), d.r0)
    i1 = sample_uniform_index(generator, mask1, (num_neg,), d.r1)
    a_s, b_s = sort_pairs(pairs, pair_mask)
    nm = ~pair_isin(a_s, b_s, i0, i1)

    pos_loss = masked_mean(
        ((f0[pairs[:, 0]] - f1[pairs[:, 1]]) ** 2).sum(dim=1), pair_mask)
    dist = torch.sqrt(((f0[i0] - f1[i1]) ** 2).sum(dim=1) + 1e-4)
    neg_loss = masked_mean(torch.relu(neg_thresh - dist) ** 2, nm)
    return PairLossOut(pos_loss, neg_loss)


def _random_triplets(generator, f0, f1, mask1, pairs, pair_mask, a_s, b_s,
                     num_rand_triplet, neg_thresh, d: PairLossDraws):
    """(hinge terms, mask, rand_neg) of the random triplets: random
    positive pairs, each with a random side-1 negative that is no
    positive of its anchor."""
    ridx, rv = sample_without_replacement(generator, pair_mask,
                                          num_rand_triplet, d.rand)
    rp = pairs[ridx]
    negatives, nv = sample_without_replacement(generator, mask1,
                                               num_rand_triplet, d.neg)
    rm = ~pair_isin(a_s, b_s, rp[:, 0], negatives) & rv & nv
    rand_pos = _dist(f0[rp[:, 0]], f1[rp[:, 1]])
    rand_neg = _dist(f0[rp[:, 0]], f1[negatives])
    return torch.relu(rand_pos + neg_thresh - rand_neg), rm, rand_neg


def triplet_loss(f0, f1, mask0, mask1, pairs, pair_mask, generator,
                 num_pos: int, num_rand_triplet: int, neg_thresh: float,
                 draws: Optional[PairLossDraws] = None) -> TripletLossOut:
    """Random triplet margin loss."""
    d = draws or PairLossDraws()
    i0, i1, pv = _select_pos(generator, pairs, pair_mask, num_pos, d.pos)
    pos_dist = _dist(f0[i0], f1[i1])
    a_s, b_s = sort_pairs(pairs, pair_mask)
    terms, rm, rand_neg = _random_triplets(generator, f0, f1, mask1, pairs,
                                           pair_mask, a_s, b_s,
                                           num_rand_triplet, neg_thresh, d)
    return TripletLossOut(masked_mean(terms, rm), masked_mean(pos_dist, pv),
                          masked_mean(rand_neg, rm))


def hardest_triplet_loss(f0, f1, mask0, mask1, pairs, pair_mask, generator,
                         num_pos: int, num_hn_samples: int,
                         num_rand_triplet: int, neg_thresh: float,
                         draws: Optional[PairLossDraws] = None
                         ) -> TripletLossOut:
    """Hardest triplets in both directions plus random triplets, one mean
    over the three sets of hinge terms."""
    d = draws or PairLossDraws()
    i0, i1, pv = _select_pos(generator, pairs, pair_mask, num_pos, d.pos)
    pos_f0, pos_f1 = f0[i0], f1[i1]
    pos_dist = _dist(pos_f0, pos_f1)
    sel0, v0 = sample_without_replacement(generator, mask0, num_hn_samples,
                                          d.hn0)
    sel1, v1 = sample_without_replacement(generator, mask1, num_hn_samples,
                                          d.hn1)
    d01min, n01 = _hardest(pos_f0, f1, sel1, v1)
    d10min, n10 = _hardest(pos_f1, f0, sel0, v0)

    a_s, b_s = sort_pairs(pairs, pair_mask)
    m0 = ~pair_isin(a_s, b_s, i0, n01) & pv
    m1 = ~pair_isin(a_s, b_s, n10, i1) & pv
    rand_terms, rm, _ = _random_triplets(generator, f0, f1, mask1, pairs,
                                         pair_mask, a_s, b_s,
                                         num_rand_triplet, neg_thresh, d)
    terms = torch.cat([rand_terms,
                       torch.relu(pos_dist + neg_thresh - d01min),
                       torch.relu(pos_dist + neg_thresh - d10min)])
    loss = masked_mean(terms, torch.cat([rm, m0, m1]))
    neg_d = 0.5 * (masked_mean(d01min, pv) + masked_mean(d10min, pv))
    return TripletLossOut(loss, masked_mean(pos_dist, pv), neg_d)
