"""The plain windowed cell top-k of the group search: the nearest targets in
the probed cells of each query (K1 / K11's plain version).

A frozen copy of the port's plain version; nothing here launches a kernel.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .build import tiled

SENTINEL = 0x7FFFFFFF
# the three per-axis "+1 cell" bits of the packed cell key (x<<20 | y<<10 | z)
BLOCK3 = (1 << 20) | (1 << 10) | 1
# the key offsets of the four runs of a probe block: its cells at +0 / +1
# in x and y, each run the two z cells
RUNS = (0, 1 << 10, 1 << 20, (1 << 20) + (1 << 10))
MAX_KN = 8
# gcl_tpu's tile of queries and chunk of window rows (pallas_radius.TILE and
# WIN), on which K11's order among equal distances depends
EXACT_TILE = 128
EXACT_WIN = 2048
_BIG = 1e30
_I64_MAX = torch.iinfo(torch.int64).max
_I64_MIN = torch.iinfo(torch.int64).min


def row_bits(t_cap: int) -> int:
    """Bits the packed order spends on the target row; 0 when fewer than 12
    bits would be left for the quantized distance (then the order is the
    exact one)."""
    rowb = max(1, (t_cap - 1).bit_length())
    return rowb if 31 - rowb >= 12 else 0


def _quantizer(r2: torch.Tensor, rowb: int):
    """(scale f32[S], inv_scale f32[S], qcap): quantized d2 =
    trunc(min(d2 * scale, qcap)). qcap is qmax - 1, not qmax:
    (qmax << ROWB) | max_row would equal the no-candidate value."""
    qmax = float((1 << (31 - rowb)) - 1)
    floor = r2.clamp_min(1e-12)
    # float32 divisions of two tensors (a Python scalar divisor would be a
    # multiply by its reciprocal); qmax filled on the device, as a copy
    # from the host would wait for the work queued before it
    q = torch.full_like(floor, qmax)
    return q / floor, floor / q, float(np.float32(qmax - 1.0))


def exact_window_starts(tkey_s: torch.Tensor,
                        pbase: torch.Tensor) -> torch.Tensor:
    """int64[S, Q]: per query, where gcl_tpu's window for its tile of
    EXACT_TILE queries starts (pallas_radius.windowed_cell_topk): the first
    sorted position whose key is at least the tile's least non-sentinel
    base, rounded down to 128 and clipped to [0, t_pad - EXACT_WIN], t_pad =
    ceil(T / EXACT_WIN) * EXACT_WIN + EXACT_WIN. A candidate at sorted
    position p lies in the window's chunk (p - start) // EXACT_WIN. A tile
    without a valid base has no candidate; its start is that of key 0."""
    s_n, t_n = tkey_s.shape
    q_n = pbase.shape[1]
    valid = pbase != SENTINEL
    kmin = tiled(torch.where(valid, pbase.long(), _I64_MAX), EXACT_TILE,
                 _I64_MAX).amin(-1)                          # [S, n_tiles]
    kmin = torch.where(kmin == _I64_MAX, 0, kmin)
    first = torch.searchsorted(tkey_s.long().contiguous(), kmin.contiguous())
    t_pad = -(-t_n // EXACT_WIN) * EXACT_WIN + EXACT_WIN
    start = (first & ~127).clamp(0, t_pad - EXACT_WIN)
    return start.repeat_interleave(EXACT_TILE, dim=1)[:, :q_n]


def replace_max_order(d2: torch.Tensor, pos: torch.Tensor,
                      chunk: torch.Tensor, kn: int):
    """gcl_tpu's _topk_kernel order (pallas_radius.py:136-180) of each row's
    candidates: d2 f32[R, L] (1e30 where there is none), their sorted
    positions pos and window chunks chunk int64[R, L]. Chunk by chunk in
    ascending order, the chunk's kn best by (d2, position) go, best first,
    each into the first of kn slots that holds the largest distance, where
    strictly less; the slots come out by distance, ties by slot. So equal
    distances that enter after an earlier chunk has filled the slots land
    from the last slot backwards. Returns (idx int64[R, kn]: the column of
    each output, -1 where none; d2 f32[R, kn], 1e30 where none)."""
    r_n, l_n = d2.shape
    live = d2 < _BIG
    # (chunk, d2, position) order by stable sorts, least significant first;
    # the columns with no candidate last
    order = torch.argsort(pos, dim=1, stable=True)
    for key in (d2, torch.where(live, chunk, _I64_MAX)):
        order = torch.gather(order, 1, torch.argsort(
            torch.gather(key, 1, order), dim=1, stable=True))
    c = torch.gather(torch.where(live, chunk, _I64_MAX), 1, order)
    col = torch.arange(l_n, device=d2.device).expand(r_n, l_n)
    new = torch.ones_like(live)
    new[:, 1:] = c[:, 1:] != c[:, :-1]
    rank = col - torch.cummax(torch.where(new, col, 0), 1)[0]
    keep = torch.gather(live, 1, order) & (rank < kn)
    # the kept candidates, in order, to the front
    order = torch.gather(order, 1, torch.argsort(
        (~keep).to(torch.int8), dim=1, stable=True))
    n_kept = keep.sum(1)
    n_keep = int(n_kept.max()) if r_n else 0
    slot_d = torch.full((r_n, kn), _BIG, dtype=d2.dtype, device=d2.device)
    slot_i = torch.full((r_n, kn), -1, dtype=torch.int64, device=d2.device)
    rows = torch.arange(r_n, device=d2.device)
    for t in range(n_keep):
        e = order[:, t]
        m = torch.where(n_kept > t, d2[rows, e], _BIG)
        j = torch.argmax(slot_d, 1)             # the first slot at the max
        better = m < slot_d[rows, j]
        slot_d[rows, j] = torch.where(better, m, slot_d[rows, j])
        slot_i[rows, j] = torch.where(better, e, slot_i[rows, j])
    out = torch.argsort(slot_d, dim=1, stable=True)
    out_d = torch.gather(slot_d, 1, out)
    return torch.where(out_d < _BIG, torch.gather(slot_i, 1, out), -1), out_d


def windowed_cell_topk_plain(tkey_s, trow_s, txyz_s, pbase, qxyz, r2, kn: int,
                             tile_elems: int = 1 << 24):
    """Plain version: dense [chunk of Q, T] tiles per search -- the
    candidate test on key differences, the same d2 and the same packing,
    then a smallest-kn on the distinct int32 values (K1) or gcl_tpu's
    order of the candidates (K11, ``replace_max_order`` over the chunks of
    ``exact_window_starts``' windows). ``tile_elems`` bounds a tile's
    size."""
    s_n, t_n = tkey_s.shape
    q_n = pbase.shape[1]
    dev = tkey_s.device
    rowb = row_bits(t_n)
    if rowb:
        scale, inv_scale, qcap = _quantizer(r2, rowb)
    else:
        wstart = exact_window_starts(tkey_s, pbase)
    kk = min(kn, t_n)
    chunk = max(1, min(q_n, tile_elems // max(t_n, 1)))
    rows = torch.full((s_n, q_n, kn), -1, dtype=torch.int32, device=dev)
    d2o = torch.full((s_n, q_n, kn), _BIG, dtype=torch.float32, device=dev)
    for s in range(s_n):
        for lo in range(0, q_n, chunk):
            hi = min(lo + chunk, q_n)
            d = tkey_s[s][None, :] - pbase[s, lo:hi, None]   # wraps as int32
            ok = (d >= 0) & ((d & ~BLOCK3) == 0)
            d2 = None
            for a in range(3):
                diff = qxyz[s, lo:hi, a, None] - txyz_s[s, None, :, a]
                d2 = diff * diff if d2 is None else d2 + diff * diff
            ok &= d2 <= r2[s]
            if rowb:
                qd = (d2 * scale[s]).clamp_max(qcap).to(torch.int32)
                packed = torch.where(ok, (qd << rowb) | trow_s[s][None, :],
                                     SENTINEL)
                m = torch.topk(packed, kk, dim=1, largest=False,
                               sorted=True)[0]
                hit = m != SENTINEL
                rows[s, lo:hi, :kk] = torch.where(
                    hit, m & ((1 << rowb) - 1), -1)
                d2o[s, lo:hi, :kk] = torch.where(
                    hit, (m >> rowb).to(torch.float32) * inv_scale[s], _BIG)
            else:
                qi, p = torch.nonzero(ok, as_tuple=True)
                n_q = torch.bincount(qi, minlength=hi - lo)
                width = max(1, int(n_q.max()))
                col = torch.arange(len(qi), device=dev) - (
                    torch.repeat_interleave(torch.cumsum(n_q, 0) - n_q, n_q))
                cd2 = torch.full((hi - lo, width), _BIG, device=dev)
                cpos = torch.zeros((hi - lo, width), dtype=torch.int64,
                                   device=dev)
                cd2[qi, col] = d2[qi, p]
                cpos[qi, col] = p
                idx, m = replace_max_order(
                    cd2, cpos, (cpos - wstart[s, lo:hi, None]) // EXACT_WIN,
                    kn)
                got = torch.gather(cpos, 1, idx.clamp_min(0))
                rows[s, lo:hi] = torch.where(idx >= 0, trow_s[s][got], -1)
                d2o[s, lo:hi] = m
    return rows, d2o


