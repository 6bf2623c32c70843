"""The plain sparse convolution over an implicit map or an index table:
forward, backward and weight gradient (K6 / K7 / K8 / K12's plain
versions). Every product's operands and every output go through
``build.rounded``, the identity unless the control's lower precision is
on.

A frozen copy of the port's plain version; nothing here launches a kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.coords import lookup
from .build import rounded, summing


def _operand(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The weights rounded to the features' type, in the summing type."""
    return summing(w.to(dtype))


def sparse_conv_implicit_fwd_plain(x: torch.Tensor, w: torch.Tensor,
                                   qkey: torch.Tensor, skeys: torch.Tensor,
                                   srow: torch.Tensor) -> torch.Tensor:
    """Plain version: searchsorted resolution, then a gather and one
    matmul per offset, summed in float32 in offset order and rounded to
    x's type once."""
    n_in, cin = x.shape
    rows = lookup(skeys, srow, qkey).long()
    xp = torch.cat([x, x.new_zeros((1, cin))])
    idx = torch.where(rows < 0, n_in, rows)
    wk = _operand(w, x.dtype)
    out = wk.new_zeros((qkey.shape[1], w.shape[2]))
    for k in range(w.shape[0]):
        out = out + rounded(summing(xp[idx[k]])) @ rounded(wk[k])
    return rounded(out).to(x.dtype)


def sparse_conv_implicit_bwd_plain(x: torch.Tensor, g: torch.Tensor,
                                   w: torch.Tensor, rqkey: torch.Tensor,
                                   skeys: torch.Tensor, srow: torch.Tensor,
                                   want_dx: bool = True):
    """Plain version: the reverse rows by searchsorted, then per reverse
    offset k' a gather of g, one matmul for dX (with W[K-1-k']^T) and one
    for dW[K-1-k'], in float32; dX rounded to x's type once."""
    n_out, cout = g.shape
    kvol = w.shape[0]
    rows = lookup(skeys, srow, rqkey).long()                 # [K, N_in]
    gp = torch.cat([g, g.new_zeros((1, cout))])
    idx = torch.where(rows < 0, n_out, rows)
    wk = _operand(w, x.dtype)
    xf = summing(x)
    dx = torch.zeros_like(xf) if want_dx else None
    dw = []
    for kp in range(kvol):
        gg = summing(gp[idx[kp]])                            # [N_in, Cout]
        if want_dx:
            dx = dx + rounded(gg, True) @ rounded(wk[kvol - 1 - kp]).T
        dw.append(rounded(xf).T @ rounded(gg, True))
    dx = rounded(dx, True).to(x.dtype) if want_dx else None
    return dx, torch.stack(dw[::-1])


def compacted_rows(hit: torch.Tensor, tile: int = 64, frag: int = 16):
    """(matched, executed) rows of a map whose hit mask is ``hit`` bool[K,
    N] (offset k of output row i has an input): matched counts the hits;
    executed what the gather-GEMM multiplies, the hits of each (``tile``-row
    tile, offset) rounded up to a multiple of ``frag``. Times Cin x Cout x 2
    they are the matched and the executed operations."""
    kvol, n = hit.shape
    pad = -n % tile
    per = torch.nn.functional.pad(hit.to(torch.int64), (0, pad))
    per = per.reshape(kvol, -1, tile).sum(-1)
    return int(per.sum()), int(((per + frag - 1) // frag * frag).sum())


def sparse_conv_table_fwd_plain(x: torch.Tensor, w: torch.Tensor,
                                idx: torch.Tensor) -> torch.Tensor:
    """Plain version: a gather and one matmul per offset, summed in float32
    in offset order and rounded to x's type once (gcl_tpu's scan
    _conv_forward)."""
    n_in, cin = x.shape
    xp = torch.cat([x, x.new_zeros((1, cin))])
    rows = idx.long()
    rows = torch.where((rows < 0) | (rows >= n_in), n_in, rows)
    wk = _operand(w, x.dtype)
    out = wk.new_zeros((idx.shape[1], w.shape[2]))
    for k in range(w.shape[0]):
        out = out + rounded(summing(xp[rows[k]])) @ rounded(wk[k])
    return rounded(out).to(x.dtype)


def sparse_conv_dw_plain(x: torch.Tensor, g: torch.Tensor,
                         qkey: torch.Tensor,
                         skeys: Optional[torch.Tensor] = None,
                         srow: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Plain version: the forward rows (by searchsorted, or read from the
    table when skeys is None), then per offset a gather of x and one
    matmul, in float32."""
    n_in, cin = x.shape
    rows = (qkey if skeys is None else lookup(skeys, srow, qkey)).long()
    rows = torch.where((rows < 0) | (rows >= n_in), n_in, rows)
    xp = torch.cat([x, x.new_zeros((1, cin))])
    gf = summing(g)
    return torch.stack([rounded(summing(xp[rows[k]])).T @ rounded(gf, True)
                        for k in range(qkey.shape[0])])


