"""Shared loss machinery: distances, masked sampling, pair-set membership
(port of gcl_tpu/losses/common.py).

Every function that draws takes a torch.Generator and, optionally, the
uniforms already drawn, so a test can hand the same numbers to both
packages.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def pdist_l2(a: torch.Tensor, b: torch.Tensor,
             eps: float = 1e-7) -> torch.Tensor:
    """Pairwise L2 distances: sqrt of the clamped squared distance + eps."""
    d2 = ((a * a).sum(dim=1)[:, None] + (b * b).sum(dim=1)[None, :]
          - 2.0 * a @ b.T)
    return torch.sqrt(d2.clamp_min(0.0) + eps)


def square_distance(a: torch.Tensor, b: torch.Tensor,
                    normalised: bool = False) -> torch.Tensor:
    """Pairwise squared distances clamped at 1e-12; ``normalised`` takes
    unit rows (2 - 2 a.b)."""
    d = -2.0 * a @ b.T
    if normalised:
        d = d + 2.0
    else:
        d = d + (a * a).sum(dim=1)[:, None] + (b * b).sum(dim=1)[None, :]
    return d.clamp_min(1e-12)


def _valid_order(valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Valid rows first, in row order, by one cumsum and a scatter (no
    host sync): (order int64[n], count)."""
    n = valid.shape[0]
    cnt = valid.sum()
    slot = torch.where(valid, torch.cumsum(valid, 0) - 1, n)
    order = torch.zeros(n + 1, dtype=torch.int64, device=valid.device)
    order[slot] = torch.arange(n, device=valid.device)
    return order[:n], cnt


def sample_without_replacement(generator: Optional[torch.Generator],
                               valid: torch.Tensor, m: int,
                               u: Optional[torch.Tensor] = None):
    """m distinct random indices, preferring valid rows: one uniform draw
    per stratum of the compacted valid range (jittered-grid sampling).

    Returns (idx int64[m], sel_valid bool[m]). With fewer than m valid
    rows the surplus draws repeat pool rows and are masked invalid, so
    callers weight by sel_valid. ``u`` f32[min(m, n)] hands in the
    uniforms; otherwise they come from ``generator`` on valid's device.
    The arithmetic is float32 in gcl_tpu's order, so the same uniforms
    give the same indices.
    """
    n = valid.shape[0]
    dev = valid.device
    m_eff = min(m, n)
    order, cnt = _valid_order(valid)
    i = torch.arange(m_eff + 1, dtype=torch.float32, device=dev)
    r = cnt.to(torch.float32) / m_eff
    edge = torch.floor(i * r).to(torch.int32)  # stratum boundaries
    lo, hi = edge[:-1], edge[1:]
    if u is None:
        u = torch.rand(m_eff, generator=generator, device=dev)
    pos = lo + (u * (hi - lo).to(torch.float32)).to(torch.int32)
    pos = torch.minimum(pos.clamp_min(0), (cnt - 1).clamp_min(0)).long()
    # empty strata (pool smaller than m) repeat their boundary row; pos is
    # non-decreasing, so adjacent dedup masks the repeats
    dup = torch.zeros(m_eff, dtype=torch.bool, device=dev)
    dup[1:] = pos[1:] == pos[:-1]
    idx = order[pos]
    sel = ~dup & valid[idx]
    if m_eff < m:
        idx = torch.nn.functional.pad(idx, (0, m - m_eff))
        sel = torch.nn.functional.pad(sel, (0, m - m_eff))
    return idx, sel


def sample_uniform_index(generator: Optional[torch.Generator],
                         valid: torch.Tensor, shape,
                         r: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A uniform random valid index per output element (with replacement).
    ``r`` hands in the integers in [0, n) already drawn."""
    order, cnt = _valid_order(valid)
    if r is None:
        r = torch.randint(0, valid.shape[0], tuple(shape),
                          generator=generator, device=valid.device)
    return order[r % cnt.clamp_min(1)]


def masked_mean(x: torch.Tensor, mask: torch.Tensor,
                dim=None) -> torch.Tensor:
    m = mask.to(x.dtype)
    if dim is None:
        return (x * m).sum() / m.sum().clamp_min(1.0)
    return (x * m).sum(dim=dim) / m.sum(dim=dim).clamp_min(1.0)


INT_MAX = 0x7FFFFFFF


def _pair_key(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a, b) non-negative int pairs as one int64 in lexicographic order."""
    return (a.long() << 32) | b.long()


def sort_pairs(pairs: torch.Tensor, valid: torch.Tensor):
    """Sort an (i, j) pair list lexicographically, invalid pairs last (as
    INT_MAX). Returns (a_sorted, b_sorted) int32 for pair_isin."""
    a = torch.where(valid, pairs[:, 0], INT_MAX)
    b = torch.where(valid, pairs[:, 1], INT_MAX)
    key = torch.sort(_pair_key(a, b))[0]
    return (key >> 32).to(torch.int32), (key & 0xFFFFFFFF).to(torch.int32)


def pair_isin(a_sorted: torch.Tensor, b_sorted: torch.Tensor,
              qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """True where (qa, qb) appears in the sorted pair list."""
    keys, q = _pair_key(a_sorted, b_sorted), _pair_key(qa, qb)
    n = keys.shape[0]
    pos = torch.searchsorted(keys, q)
    return (pos < n) & (keys[pos.clamp_max(n - 1)] == q)


def masked_logsumexp(x: torch.Tensor, mask: torch.Tensor,
                     dim: int = -1) -> torch.Tensor:
    """logsumexp over the masked-in entries (-inf where there is none)."""
    return torch.logsumexp(torch.where(mask, x, -torch.inf), dim=dim)
