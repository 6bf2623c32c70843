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
  d2, ties by sorted position.

Each keeps its own launch counter (``windowed_cell_topk_packed.launches``
and ``windowed_cell_topk_exact.launches``).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .build import check, load_library

SENTINEL = 0x7FFFFFFF
# the three per-axis "+1 cell" bits of the packed cell key (x<<20 | y<<10 | z)
BLOCK3 = (1 << 20) | (1 << 10) | 1
MAX_KN = 8
_BIG = 1e30


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
    scale = torch.tensor(qmax, dtype=torch.float32, device=r2.device) / floor
    inv_scale = floor / torch.tensor(qmax, dtype=torch.float32,
                                     device=r2.device)
    return scale, inv_scale, float(np.float32(qmax - 1.0))


def windowed_cell_topk_plain(tkey_s, trow_s, txyz_s, pbase, qxyz, r2, kn: int,
                             tile_elems: int = 1 << 24):
    """Plain version: dense [chunk of Q, T] tiles per search -- the
    candidate test on key differences, the same d2 and the same packing,
    then a smallest-kn on the distinct int32 values (K1) or a stable
    smallest-kn on d2 (K11). ``tile_elems`` bounds a tile's size."""
    s_n, t_n = tkey_s.shape
    q_n = pbase.shape[1]
    dev = tkey_s.device
    rowb = row_bits(t_n)
    if rowb:
        scale, inv_scale, qcap = _quantizer(r2, rowb)
    kk = min(kn, t_n)
    chunk = max(1, min(q_n, tile_elems // max(t_n, 1)))
    rows = torch.full((s_n, q_n, kn), -1, dtype=torch.int32, device=dev)
    d2o = torch.full((s_n, q_n, kn), _BIG, dtype=torch.float32, device=dev)
    pos = torch.arange(t_n, device=dev)
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
                # distinct int64 keys: d2's bits (non-negative floats order
                # as their bits) << 32 | sorted position
                dm = torch.where(ok, d2, _BIG).contiguous()
                key = (dm.view(torch.int32).long() << 32) | pos
                best = torch.topk(key, kk, dim=1, largest=False,
                                  sorted=True)[0] & 0xFFFFFFFF
                m = torch.gather(dm, 1, best)
                rows[s, lo:hi, :kk] = torch.where(m < _BIG,
                                                  trow_s[s][best], -1)
                d2o[s, lo:hi, :kk] = m
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
    dequantized d2 while T <= 2^19 (K1), by (exact d2, sorted position)
    beyond (K11).
    """
    fn = (windowed_cell_topk_packed if row_bits(tkey_s.shape[-1])
          else windowed_cell_topk_exact)
    return fn(tkey_s, trow_s, txyz_s, pbase, qxyz, r2, kn)
