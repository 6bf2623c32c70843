"""The plain scalar conv of conv1's jitter term: forward, weight gradient
and input gradient (K4 / K5 / K9's plain versions).

A frozen copy of the port's plain version; nothing here launches a kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from .build import summing
from .occupancy_conv import cube_side, neighbor_rows


def _matched_scalars(x, aux, skeys, srow, row_sel, side):
    """xv[i, k] = x[match(k, i)], zero where offset k of row i is absent or
    row i is not selected."""
    rows = neighbor_rows(aux, skeys, srow, side).long()      # [N, K]
    xv = torch.where(rows >= 0, x[:, 0][rows.clamp_min(0)], 0.0)
    if row_sel is not None:
        xv = xv * (row_sel > 0).to(xv.dtype)[:, None]
    return xv


def scalar_conv_fwd_plain(x, w, aux, skeys, srow, row_sel=None):
    """Plain version: the 125 neighbour rows by searchsorted, a gather of
    their scalars, one float32 matmul with W[:, 0, :], rounded to x's type
    once."""
    xv = _matched_scalars(x, aux, skeys, srow, row_sel, cube_side(w.shape[0]))
    return (summing(xv) @ summing(w[:, 0, :])).to(x.dtype)


def scalar_conv_dw_plain(x, g, aux, skeys, srow, kcube, row_sel=None):
    """Plain version: the same gather, transposed times g, in float32."""
    xv = _matched_scalars(x, aux, skeys, srow, row_sel, cube_side(kcube))
    return (summing(xv).T @ summing(g))[:, None, :]


def scalar_conv_dx_plain(g, w, aux, skeys, srow, row_sel=None):
    """Plain version: p[i, k] = g[i] . W[k, 0, :] by one matmul (zero on
    rows K4 skipped), then dX[j] = sum_k p[match(K-1-k, j), k] by a gather
    through the mirrored neighbour rows; float32 sums, rounded to g's type
    once."""
    kcube = w.shape[0]
    p = summing(g) @ summing(w[:, 0, :]).T                   # [N, K]
    if row_sel is not None:
        p = p * (row_sel > 0).to(p.dtype)[:, None]
    rows = neighbor_rows(aux, skeys, srow, cube_side(kcube)).flip(1).long()
    picked = torch.gather(p, 0, rows.clamp_min(0))
    return torch.where(rows >= 0, picked, 0.0).sum(
        dim=1, keepdim=True).to(g.dtype)


