"""Integer coordinate keys (port of gcl_tpu/core/coords.py).

Two key schemes, as in the JAX package:

* composite (hi, lo) keys (``coord_keys``) order voxels for the
  multi-cloud voxelizer and address them in the explicit kernel maps
  (``searchsorted2`` / ``lookup2``), for any number of clouds;
* packed single-int32 keys (``pack_keys`` / ``pack_query_keys``) address
  voxels in the conv kernels: ``cloud << 27 | ux << 17 | uy << 7 | uz``
  with per-axis offsets ``u = xyz // stride + 2^(bits-1)``.

Packed keys wrap in int32 for clouds >= 16 (they go negative). Every
consumer sorts and searches them as signed int32, so the order is total and
consistent. Shifts are evaluated in int64 and wrapped back to int32
explicitly, which reproduces the JAX int32 arithmetic bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from .types import INVALID_BATCH

GRID_BITS = 10
GRID_HALF = 1 << (GRID_BITS - 1)  # 512
GRID_SIZE = 1 << GRID_BITS

DEFAULT_KEY_BITS = (10, 10, 7)
PAD_CLOUD = 31
_INT32_MAX = 0x7FFFFFFF


def wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """Two's-complement wrap of an int64 tensor into int32."""
    return ((v + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)


def floordiv(a: torch.Tensor, b: int) -> torch.Tensor:
    """jnp ``//`` on ints: rounds toward minus infinity."""
    return torch.div(a, b, rounding_mode="floor")


def coord_keys(coords: torch.Tensor, stride: int = 1):
    """Composite (hi, lo) int32 keys for int coords[N, 4] = (b, x, y, z).

    Padded rows (b >= INVALID_BATCH) take the largest key on both halves so
    they sort last.
    """
    c = coords.long()
    b = c[:, 0]
    xyz = floordiv(c[:, 1:4], stride).clamp(-GRID_HALF, GRID_HALF - 1)
    hi = b * GRID_SIZE + (xyz[:, 0] + GRID_HALF)
    lo = (xyz[:, 1] + GRID_HALF) * GRID_SIZE + (xyz[:, 2] + GRID_HALF)
    pad = b >= INVALID_BATCH
    hi = torch.where(pad, _INT32_MAX, hi)
    lo = torch.where(pad, _INT32_MAX, lo)
    return wrap_int32(hi), wrap_int32(lo)


def sort_by_keys(hi: torch.Tensor, lo: torch.Tensor, *payloads):
    """Stable lexicographic sort by (hi, lo); returns sorted keys + payloads.

    Two stable passes (minor key first) give the lexicographic order with
    ties kept in row order, as lax.sort(num_keys=2, is_stable=True) does.
    """
    _, p1 = torch.sort(lo, stable=True)
    _, p2 = torch.sort(hi[p1], stable=True)
    perm = p1[p2]
    return (hi[perm], lo[perm]) + tuple(p[perm] for p in payloads)


def _halves(bits):
    bx, by, bz = bits
    return (1 << (bx - 1), 1 << (by - 1), 1 << (bz - 1))


def _pack(c: torch.Tensor, u: torch.Tensor, bits) -> torch.Tensor:
    bx, by, bz = bits
    return ((c << (bx + by + bz)) | (u[..., 0] << (by + bz))
            | (u[..., 1] << bz) | u[..., 2])


def pack_keys(coords: torch.Tensor, stride: int,
              bits=DEFAULT_KEY_BITS) -> torch.Tensor:
    """Injective int32 key for coords[N, 4] = (cloud, x, y, z).

    xyz must be exact multiples of ``stride``. Padded rows (cloud >=
    PAD_CLOUD) and rows outside the per-axis ranges map into the reserved
    PAD_CLOUD space keyed by row index, where no query key lands.
    """
    n = coords.shape[0]
    c = coords[:, 0].long()
    half = torch.tensor(_halves(bits), dtype=torch.long, device=coords.device)
    u = floordiv(coords[:, 1:4].long(), stride) + half
    in_range = ((u >= 0) & (u < 2 * half)).all(dim=1)
    valid = in_range & (c < PAD_CLOUD)
    key = _pack(c, u, bits)
    rows = torch.arange(n, dtype=torch.long, device=coords.device)
    pad_key = (PAD_CLOUD << sum(bits)) + rows
    return wrap_int32(torch.where(valid, key, pad_key))


def pack_query_keys(coords: torch.Tensor, offset: torch.Tensor,
                    in_stride: int, bits=DEFAULT_KEY_BITS) -> torch.Tensor:
    """Key of (coords.xyz + offset) at ``in_stride``, or a never-matching
    key (PAD_CLOUD | 1 << 26 space) when off-lattice, out of range or
    padding. ``offset`` is int[3] (result [N]) or int[K, 3] (result
    [K, N], one row per offset)."""
    n = coords.shape[0]
    dev = coords.device
    off = offset.long().to(dev)
    c = coords[:, 0].long()
    qxyz = coords[:, 1:4].long() + off[..., None, :]
    on_lattice = (torch.remainder(qxyz, in_stride) == 0).all(dim=-1)
    half = torch.tensor(_halves(bits), dtype=torch.long, device=dev)
    u = floordiv(qxyz, in_stride) + half
    in_range = ((u >= 0) & (u < 2 * half)).all(dim=-1)
    valid = in_range & (c < PAD_CLOUD) & on_lattice
    key = _pack(c, u, bits)
    rows = torch.arange(n, dtype=torch.long, device=dev)
    pad_key = ((PAD_CLOUD << sum(bits)) | (1 << 26)) + rows
    return wrap_int32(torch.where(valid, key, pad_key))


def lookup(skeys: torch.Tensor, srow: torch.Tensor,
           q: torch.Tensor) -> torch.Tensor:
    """Row of each query key among sorted keys, or -1: srow[p] where
    skeys[p] == q (torch.searchsorted over signed int32 keys)."""
    n = skeys.shape[0]
    if n == 0:
        return torch.full_like(q, -1, dtype=torch.int32)
    pos = torch.searchsorted(skeys, q.contiguous())
    pos_c = pos.clamp(max=n - 1)
    found = (pos < n) & (skeys[pos_c] == q)
    return torch.where(found, srow[pos_c], -1).to(torch.int32)


def _key64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """One int64 whose signed order is the lexicographic signed order of
    the int32 pair (hi, lo)."""
    return (hi.long() << 32) + (lo.long() + (1 << 31))


def searchsorted2(key_hi: torch.Tensor, key_lo: torch.Tensor,
                  q_hi: torch.Tensor, q_lo: torch.Tensor) -> torch.Tensor:
    """Lower bound of each (q_hi, q_lo) among the lexicographically sorted
    (key_hi, key_lo): the first position p with keys[p] >= query, int64 of
    the queries' shape. All four are int32, compared as signed."""
    return torch.searchsorted(_key64(key_hi, key_lo),
                              _key64(q_hi, q_lo).contiguous())


def lookup2(key_hi: torch.Tensor, key_lo: torch.Tensor, perm: torch.Tensor,
            q_hi: torch.Tensor, q_lo: torch.Tensor) -> torch.Tensor:
    """Two-word lookup: perm[p] where (key_hi[p], key_lo[p]) equals the
    query, else -1 (int32). Padded keys and sentinel queries are both
    0x7FFFFFFF on hi; a sentinel query never finds a padded row."""
    n = key_hi.shape[0]
    if n == 0:
        return torch.full_like(q_hi, -1, dtype=torch.int32)
    pos = searchsorted2(key_hi, key_lo, q_hi, q_lo)
    pos_c = pos.clamp(max=n - 1)
    found = ((pos < n) & (key_hi[pos_c] == q_hi) & (key_lo[pos_c] == q_lo)
             & (q_hi != _INT32_MAX))
    return torch.where(found, perm[pos_c], -1).to(torch.int32)


def kernel_offsets(kernel_size: int) -> np.ndarray:
    """Integer offsets of a cubic kernel (MinkowskiEngine HYPER_CUBE).

    Odd kernels are centred; enumeration is x-outermost / z-innermost, the
    order of the conv weights' first axis.
    """
    if kernel_size % 2 == 1:
        r = kernel_size // 2
        rng = range(-r, r + 1)
    else:
        rng = range(0, kernel_size)
    offs = [(dx, dy, dz) for dx in rng for dy in rng for dz in rng]
    return np.asarray(offs, dtype=np.int32)
