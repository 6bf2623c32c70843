"""K1 and K11: nearest targets within a radius among the 2x2x2 cell block
of each query -- the candidate selection of the hash-grid group search.

``windowed_cell_topk`` launches the CUDA kernels of ``csrc/radius_topk.cu``
on CUDA tensors and takes the plain PyTorch version below on CPU tensors. It
replaces gcl_tpu/core/pallas_radius.py:windowed_cell_topk, whose two kernel
bodies are the two orders of one selection:

* K1 (_topk_kernel_packed), when the target rows leave at least 12 bits of
  an int32 for the distance (T <= 2^19): candidates ordered by the int32
  ``(quantized d2 << ROWB) | row``; the distance that comes out is the
  dequantized one;
* K11 (_topk_kernel), for larger T: candidates ordered by the exact float
  d2, ties in gcl_tpu's order (``replace_max_order``): each window chunk's
  best by (d2, sorted position), merged into kn slots by replace-first-max
  and emitted by slot among equal distances.

Each keeps its own launch counter (``windowed_cell_topk_packed.launches``
and ``windowed_cell_topk_exact.launches``).

K1's kernel searches a tile of TILE queries of one search inside windows
of the search's sorted keys, one a run of the 2x2x2 probe block, which
each of its blocks works out for its tile (gcl_tpu works them out in XLA
before its pallas_call); ``topk_windows`` is the same table in plain
torch, the reference that the tests hold sound and that the keys the
kernel stages are counted against.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .build import check, counted, load_library, tiled

SENTINEL = 0x7FFFFFFF
# the three per-axis "+1 cell" bits of the packed cell key (x<<20 | y<<10 | z)
BLOCK3 = (1 << 20) | (1 << 10) | 1
# the key offsets of the four runs of a probe block: its cells at +0 / +1
# in x and y, each run the two z cells
RUNS = (0, 1 << 10, 1 << 20, (1 << 20) + (1 << 10))
MAX_KN = 8
TILE = 256    # queries of a tile of K1's kernel: kTile of its source
CHUNK = 2048  # targets K1's kernel stages at a time: kChunk of its source
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


def topk_windows(tkey_s: torch.Tensor, pbase: torch.Tensor,
                 tile: int = TILE) -> torch.Tensor:
    """int32[2, S, ceil(Q / tile), 4]: [0] the first position and [1] the
    length of the keys of search s that K1's block for (s, tile) stages
    for run r. Run r of every query in the tile lies in the keys [lo +
    RUNS[r], hi + RUNS[r] + 1], lo and hi the least and the greatest of
    the tile's non-sentinel bases (queries sorted by home cell give bases
    that are only about monotone); the run's window is the positions of
    those keys. The windows of a tile overlap (runs 0 and 1 differ by one
    y line, as do runs 2 and 3) and their ends ascend with r, so each run
    holds its window less the positions of the windows before it: the
    four are disjoint, ascending, and hold the union of the windows. A
    tile without a valid base has length 0 everywhere."""
    s_n, q_n = pbase.shape
    valid = pbase != SENTINEL
    pb = pbase.long()
    lo = tiled(torch.where(valid, pb, _I64_MAX), tile, _I64_MAX).amin(-1)
    hi = tiled(torch.where(valid, pb, _I64_MIN), tile, _I64_MIN).amax(-1)
    live = (lo <= hi)[..., None]                                # [S, n, 1]
    runs = torch.tensor(RUNS, dtype=torch.int64, device=pbase.device)
    n_tiles = lo.shape[1]
    keys = tkey_s.long().contiguous()
    first = torch.searchsorted(keys, (torch.where(
        live, lo[..., None], 0) + runs).reshape(s_n, -1)).reshape(
            s_n, n_tiles, 4)
    end = torch.searchsorted(keys, (torch.where(
        live, hi[..., None], 0) + runs + 1).reshape(s_n, -1),
        right=True).reshape(s_n, n_tiles, 4)
    # the end of the windows of the runs before r: their positions are held
    held = torch.cat([torch.zeros_like(end[..., :1]),
                      torch.cummax(end, -1)[0][..., :-1]], -1)
    start = torch.maximum(first, held)
    length = torch.where(live, (end - start).clamp(min=0), 0)
    return torch.stack([torch.where(length > 0, start, 0),
                        length]).to(torch.int32)


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


def cross_chunk_ties(arrays, q: int):
    """The case on which K11's order among equal distances is checked: a
    copy of K11's arrays (tkey_s, trow_s, txyz_s, pbase, qxyz, r2; S = 1,
    T > 2^19, query q of valid base) where query q's probe cell holds, from
    the first sorted position pos of its base key on, 2110 targets at (dx,
    0, 0) from it: five distinct distances (dx 0.40 .. 0.48), 2095 targets
    at dx 0.52, then ten at dx 0.1, all within r2 = 0.3, so that the ten
    ties lie a window chunk (EXACT_WIN rows) after the five. Keys stay
    sorted: the positions it takes held keys >= the base. Returns (arrays,
    pos)."""
    tkey, trow, txyz, pbase, qxyz, r2 = (a.clone() for a in arrays)
    base = int(pbase[0, q])
    pos = int((tkey[0] < base).sum())
    if pos + 2110 > tkey.shape[1]:
        raise ValueError("no room for the tie case's 2110 targets")
    dx = torch.full((2110,), 0.52, device=tkey.device)
    dx[:5] = torch.tensor([0.40, 0.42, 0.44, 0.46, 0.48])
    dx[2100:] = 0.1
    tkey[0, pos:pos + 2110] = base
    txyz[0, pos:pos + 2110] = qxyz[0, q]
    txyz[0, pos:pos + 2110, 0] += dx
    r2.fill_(0.3)
    return (tkey, trow, txyz, pbase, qxyz, r2), pos


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


def _check_args(tkey_s, trow_s, txyz_s, pbase, qxyz, r2, kn):
    if tkey_s.dim() != 2 or pbase.dim() != 2:
        raise ValueError(f"expected tkey_s [S, T] and pbase [S, Q], got "
                         f"{tuple(tkey_s.shape)} and {tuple(pbase.shape)}")
    s_n, t_n = tkey_s.shape
    q_n = pbase.shape[1]
    want = (("trow_s", trow_s, (s_n, t_n), torch.int32),
            ("tkey_s", tkey_s, (s_n, t_n), torch.int32),
            ("txyz_s", txyz_s, (s_n, t_n, 3), torch.float32),
            ("pbase", pbase, (s_n, q_n), torch.int32),
            ("qxyz", qxyz, (s_n, q_n, 3), torch.float32),
            ("r2", r2, (s_n,), torch.float32))
    for name, t, shape, dt in want:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != tkey_s.device:
            raise ValueError(f"{name} on {t.device}, tkey_s on "
                             f"{tkey_s.device}")
    if not 1 <= kn <= MAX_KN:
        raise ValueError(f"kn must be in [1, {MAX_KN}], got {kn}")
    if tkey_s.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {tkey_s.device}")
    if tkey_s.device.type == "cuda":
        for name, t, _, _ in want:
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if not 0 < s_n <= 65535 or q_n == 0:
            raise ValueError(f"a launch takes 1..65535 searches of at least "
                             f"one query, got S={s_n}, Q={q_n}")


def _launch(tkey_s, trow_s, txyz_s, pbase, qxyz, r2, kn, rowb):
    s_n, t_n = tkey_s.shape
    q_n = pbase.shape[1]
    dev = tkey_s.device
    rows = torch.empty((s_n, q_n, kn), dtype=torch.int32, device=dev)
    d2 = torch.empty((s_n, q_n, kn), dtype=torch.float32, device=dev)
    scale = inv_scale = None
    qcap = 0.0
    if rowb:
        scale, inv_scale, qcap = _quantizer(r2, rowb)
    lib = load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.windowed_cell_topk(
        tkey_s.data_ptr(), trow_s.data_ptr(), txyz_s.data_ptr(),
        pbase.data_ptr(), qxyz.data_ptr(), r2.data_ptr(),
        None if scale is None else scale.data_ptr(),
        None if inv_scale is None else inv_scale.data_ptr(),
        rows.data_ptr(), d2.data_ptr(), s_n, t_n, q_n, kn, rowb, qcap,
        stream)
    check(err, "windowed_cell_topk")
    return rows, d2


def windowed_cell_topk_packed(tkey_s, trow_s, txyz_s, pbase, qxyz, r2,
                              kn: int):
    """K1: ``windowed_cell_topk`` where T <= 2^19 selects the packed
    order."""
    _check_args(tkey_s, trow_s, txyz_s, pbase, qxyz, r2, kn)
    rowb = row_bits(tkey_s.shape[1])
    if not rowb:
        raise ValueError("T > 2^19 selects the exact order (K11)")
    if tkey_s.device.type == "cpu":
        return windowed_cell_topk_plain(tkey_s, trow_s, txyz_s, pbase, qxyz,
                                        r2, kn)
    out = _launch(tkey_s, trow_s, txyz_s, pbase, qxyz, r2, kn, rowb)
    _PACKED.launches += 1
    return out


def counted_topk_keys(device):
    """While the block runs, K1's launches on ``device`` count the targets
    they stage into shared memory (each block its windows; the kernel adds
    up the copies its threads issue). Yields an int64 tensor [1] on the
    card that holds the sum once the block has ended: ``topk_windows``'s
    sum of lengths when the kernel stages what the table says."""
    return counted(device, ("windowed_cell_topk_count_keys",), 1,
                   "K1's staged-key counter")


def windowed_cell_topk_exact(tkey_s, trow_s, txyz_s, pbase, qxyz, r2,
                             kn: int):
    """K11: ``windowed_cell_topk`` where T > 2^19 selects the exact
    order."""
    _check_args(tkey_s, trow_s, txyz_s, pbase, qxyz, r2, kn)
    if row_bits(tkey_s.shape[1]):
        raise ValueError("T <= 2^19 selects the packed order (K1)")
    if tkey_s.device.type == "cpu":
        return windowed_cell_topk_plain(tkey_s, trow_s, txyz_s, pbase, qxyz,
                                        r2, kn)
    out = _launch(tkey_s, trow_s, txyz_s, pbase, qxyz, r2, kn, 0)
    _EXACT.launches += 1
    return out


windowed_cell_topk_packed.launches = 0
windowed_cell_topk_exact.launches = 0
# The counters stay with the wrappers when a caller puts something else
# under their names here (windowed_cell_topk looks the two up at call time,
# so that a check can route it).
_PACKED, _EXACT = windowed_cell_topk_packed, windowed_cell_topk_exact


def windowed_cell_topk(tkey_s: torch.Tensor, trow_s: torch.Tensor,
                       txyz_s: torch.Tensor, pbase: torch.Tensor,
                       qxyz: torch.Tensor, r2: torch.Tensor, kn: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched nearest-targets-in-probed-cells.

    tkey_s int32[S, T]: packed cell keys per search, SORTED ascending
    (0x7FFFFFFF on invalid rows); trow_s int32[S, T]: the original target
    row of each sorted position; txyz_s f32[S, T, 3]: the coordinates in
    sorted order (1e30 on invalid rows); pbase int32[S, Q]: the key of the
    min-corner cell of each query's 2x2x2 probe block (0x7FFFFFFF for
    invalid or grid-edge queries); qxyz f32[S, Q, 3]; r2 f32[S] squared
    radii; 1 <= kn <= 8.

    Returns (rows int32[S, Q, kn], -1 where none; d2 f32[S, Q, kn], 1e30
    where none), ascending: by ``(quantized d2 << ROWB) | row`` with the
    dequantized d2 while T <= 2^19 (K1), by the exact d2 beyond (K11), equal
    distances in gcl_tpu's order (``replace_max_order``).
    """
    fn = (windowed_cell_topk_packed if row_bits(tkey_s.shape[-1])
          else windowed_cell_topk_exact)
    return fn(tkey_s, trow_s, txyz_s, pbase, qxyz, r2, kn)
