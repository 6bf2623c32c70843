"""The plain occupancy conv of conv1's presence input: forward and weight
gradient (K2 / K3's plain versions).

A frozen copy of the port's plain version; nothing here launches a kernel.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.coords import DEFAULT_KEY_BITS, kernel_offsets, lookup, wrap_int32
from .build import rounded, summing

MAX_SIDE = 5  # side^2 presence bits must fit one int32 column
_I64_MAX = torch.iinfo(torch.int64).max
_I64_MIN = torch.iinfo(torch.int64).min
_I32 = torch.iinfo(torch.int32)


def cube_side(kcube: int) -> int:
    side = round(kcube ** (1 / 3))
    if side ** 3 != kcube or side % 2 != 1 or side > MAX_SIDE:
        raise ValueError(f"occupancy conv needs an odd cubic kernel with "
                         f"side <= {MAX_SIDE}, got K={kcube}")
    return side


def neighbor_rows(aux: torch.Tensor, skeys: torch.Tensor,
                  srow: torch.Tensor, side: int) -> torch.Tensor:
    """int32[N, side^3]: the row of the voxel at each kernel offset of each
    stride-1 row (srow of the matching key), -1 where it is absent or
    beyond the key window. Resolved from the occupancy aux as the kernels
    do: grid-edge masks first, then a searchsorted of the neighbour key."""
    bx, by, bz = DEFAULT_KEY_BITS
    offs = torch.from_numpy(kernel_offsets(side).astype(np.int64)).to(
        aux.device)                                          # [K, 3]
    u = aux[:, None, 1:4].long() + offs[None]                # [N, K, 3]
    lim = torch.tensor([1 << bx, 1 << by, 1 << bz], device=aux.device)
    in_range = ((u >= 0) & (u < lim)).all(dim=-1)
    delta = (offs[:, 0] << (by + bz)) + (offs[:, 1] << bz) + offs[:, 2]
    nkey = wrap_int32(aux[:, 0:1].long() + delta[None])      # [N, K]
    return torch.where(in_range, lookup(skeys, srow, nkey), -1)


def c1z_unpack_bits(sbits: torch.Tensor, kcube: int) -> torch.Tensor:
    """Presence bit per (row, kernel offset) from the occupancy forward's
    packed bitmasks: offset k = (dx, dy, dz) in kernel_offsets order lives
    at bit dy*side + dz of sbits[:, dx]. Returns int32[N, kcube] in
    {0, 1}."""
    side = round(kcube ** (1 / 3))
    s2 = side * side
    karr = torch.arange(kcube, dtype=torch.int64, device=sbits.device)
    cols = sbits[:, karr // s2]                              # [N, kcube]
    return (cols >> (karr % s2).to(torch.int32)[None, :]) & 1


def occupancy_conv_fwd_plain(aux: torch.Tensor, skeys: torch.Tensor,
                             w: torch.Tensor, out_dtype=None):
    """Plain version: presence by searchsorted of every neighbour key over
    the whole level, then ``bits @ W[:, 0, :]``
    with W rounded to ``out_dtype`` (w's type when None), summed in float32
    and rounded once; sbits packs the same bits."""
    side = cube_side(w.shape[0])
    dtype = out_dtype or w.dtype
    rows = neighbor_rows(aux, skeys, torch.zeros_like(skeys), side)
    bits = (rows >= 0).to(torch.int32)                       # [N, K]
    wk = summing(w[:, 0, :].to(dtype))
    out = rounded(bits.to(wk.dtype) @ rounded(wk)).to(dtype)
    s2 = side * side
    shift = torch.arange(s2, device=aux.device, dtype=torch.int32)
    cols = (bits.reshape(-1, side, s2) << shift).sum(-1, dtype=torch.int32)
    sbits = torch.zeros((aux.shape[0], 8), dtype=torch.int32,
                        device=aux.device)
    sbits[:, :side] = cols
    return out, sbits


def occupancy_conv_dw_plain(sbits: torch.Tensor, g: torch.Tensor,
                            kcube: int) -> torch.Tensor:
    """Plain version: unpacked bits transposed times g, in float32."""
    gf = summing(g)
    bits = c1z_unpack_bits(sbits, kcube).to(gf.dtype)
    return (bits.T @ gf)[:, None, :]


