"""Sparse tensor compute primitives with their gradients (port of the
implicit-map part of gcl_tpu/core/sparse_ops.py).

A sparse convolution over an implicit map is

    out[i] = sum_k  X[row whose key == qkey[k, i]] @ W[k]   (missing -> 0)

Three torch.autograd.Functions wire the kernels of gcl_tpu_torch.kernels to
the graph records:

* ``SparseConvImplicit``: forward K6; backward K7, one pass over the
  reverse map for dX and dW (dX only when the input asks for it);
* ``OccupancyConv`` (conv1 of an in_ch == 1 model on all-ones features):
  forward K2, which also leaves the presence bitmasks; backward K3 from
  those bitmasks; there is no dX;
* ``ScalarConv`` (a Cin == 1 conv that reads its features: the eps term of
  the exact input jitter): forward K4, backward K5. Its dX would be a
  Cout == 1 conv through the reverse map, which is not ported; asking for
  it raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels import (c1z_unpack_bits, occupancy_conv_dw, occupancy_conv_fwd,
                       scalar_conv_dw, scalar_conv_fwd,
                       sparse_conv_implicit_bwd, sparse_conv_implicit_fwd)
from .types import ConvMap, LevelCoords

__all__ = ["SparseConvImplicit", "OccupancyConv", "ScalarConv",
           "sparse_conv_implicit", "sparse_conv_c1z", "c1z_unpack_bits",
           "draw_input_eps", "sparse_conv_c1z_exact_jitter",
           "masked_mean_var", "l2_normalize", "apply_mask"]


def _require_f32(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32 (the port computes in "
                        f"float32 only), got {t.dtype}")


class SparseConvImplicit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, qkey, rqkey, in_skeys, in_srow, out_skeys,
                out_srow):
        x, w = x.contiguous(), w.contiguous()
        ctx.save_for_backward(x, w)
        ctx.rev = (rqkey, out_skeys, out_srow)
        return sparse_conv_implicit_fwd(x, w, qkey, in_skeys, in_srow)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        rqkey, out_skeys, out_srow = ctx.rev
        if rqkey is None:
            raise NotImplementedError(
                "this conv map has no reverse twin (even kernel): its "
                "backward is not ported")
        dx, dw = sparse_conv_implicit_bwd(
            x, g, w, rqkey, out_skeys, out_srow,
            want_dx=ctx.needs_input_grad[0])
        return (dx, dw if ctx.needs_input_grad[1] else None) + (None,) * 6


class OccupancyConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, aux, skeys):
        out, sbits = occupancy_conv_fwd(aux, skeys, w.contiguous())
        ctx.save_for_backward(sbits)
        ctx.kcube = w.shape[0]
        return out

    @staticmethod
    def backward(ctx, g):
        (sbits,) = ctx.saved_tensors
        return occupancy_conv_dw(sbits, g, ctx.kcube), None, None


class ScalarConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, aux, skeys, srow, row_sel):
        x, w = x.contiguous(), w.contiguous()
        ctx.save_for_backward(x)
        ctx.rest = (aux, skeys, srow, row_sel, w.shape[0])
        return scalar_conv_fwd(x, w, aux, skeys, srow, row_sel)

    @staticmethod
    def backward(ctx, g):
        if ctx.needs_input_grad[0]:
            raise NotImplementedError(
                "dX of a Cin == 1 conv is a Cout == 1 conv through the "
                "reverse map (gcl_tpu's _conv_co1_fwd), which is not "
                "ported; the jitter noise it is used for needs no gradient")
        (x,) = ctx.saved_tensors
        aux, skeys, srow, row_sel, kcube = ctx.rest
        dw = scalar_conv_dw(x, g, aux, skeys, srow, kcube, row_sel)
        return (None, dw) + (None,) * 4


def sparse_conv_implicit(x: torch.Tensor, w: torch.Tensor, cmap: ConvMap,
                         in_level: LevelCoords,
                         out_level: LevelCoords) -> torch.Tensor:
    """Sparse (transpose) convolution of x [N_in, Cin] (the input level's
    rows) with w [K, Cin, Cout] over the map's query keys; differentiable
    in x and w."""
    _require_f32("x", x)
    _require_f32("w", w)
    return SparseConvImplicit.apply(
        x, w, cmap.qkey, cmap.rqkey, in_level.skeys, in_level.srow,
        out_level.skeys, out_level.srow)


def sparse_conv_c1z(w: torch.Tensor, c1z: torch.Tensor,
                    level: LevelCoords) -> torch.Tensor:
    """Occupancy convolution: out[i] = sum_k present_k(i) * W[k, 0, :];
    differentiable in w.

    EXACT only under the in_ch == 1 contract: the conv's input features
    are ones on every valid row (how GCL always drives in_ch == 1 models).
    c1z is the level's occupancy aux (ConvMap.c1z).
    """
    _require_f32("w", w)
    return OccupancyConv.apply(w, c1z, level.skeys)


def draw_input_eps(generator: Optional[torch.Generator], sigma: float,
                   p: float, lv_mask: torch.Tensor,
                   row_sel: Optional[torch.Tensor] = None,
                   gate_u: Optional[torch.Tensor] = None,
                   normal: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The input-feature jitter noise as a standalone draw: eps f32[N, 1] =
    gate(p) * N(0, sigma) on valid rows, restricted further by row_sel
    (GCL jitters centre-cloud rows only; the callers fold the per-sample
    gates into it).

    The gate uniform (scalar) and the standard normals f32[N, 1] come from
    ``generator`` on lv_mask's device unless ``gate_u`` / ``normal`` hand
    them in already drawn.
    """
    dev = lv_mask.device
    n = lv_mask.shape[0]
    if gate_u is None:
        gate_u = torch.rand((), generator=generator, device=dev)
    if normal is None:
        normal = torch.randn((n, 1), generator=generator, device=dev)
    gate = (gate_u < p).to(torch.float32)
    eps = normal * sigma * gate * lv_mask.to(torch.float32)[:, None]
    if row_sel is not None:
        eps = eps * row_sel.to(torch.float32)[:, None]
    return eps


def sparse_conv_c1z_exact_jitter(w: torch.Tensor, cmap: ConvMap,
                                 level: LevelCoords, eps: torch.Tensor,
                                 row_sel: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """Occupancy conv + exact input jitter at presence cost.

    conv(1 + eps) = conv(1) + conv(eps) by linearity: the all-ones term
    rides the presence kernels (K2, K3) and the eps term is a
    scalar-feature conv (K4, K5) that skips output rows outside
    ``row_sel`` -- exact because eps (draw_input_eps with the same
    row_sel) is zero on every row of an unselected row's cloud and a
    same-level conv never leaves the cloud. eps carries no parameter
    dependence, so only dW flows back, from both terms.
    """
    _require_f32("w", w)
    sel = None
    if row_sel is not None:
        sel = (level.mask.to(torch.float32)
               * row_sel.to(torch.float32)).contiguous()
    return (OccupancyConv.apply(w, cmap.c1z, level.skeys)
            + ScalarConv.apply(eps.detach(), w, cmap.c1z, level.skeys,
                               level.srow, sel))


def masked_mean_var(feats: torch.Tensor, mask: torch.Tensor):
    """Mean / biased variance per channel over valid rows only."""
    m = mask.to(feats.dtype)[:, None]
    cnt = m.sum().clamp_min(1.0)
    mean = (feats * m).sum(dim=0) / cnt
    var = ((feats - mean) ** 2 * m).sum(dim=0) / cnt
    return mean, var, cnt


def l2_normalize(feats: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Row-wise L2 normalization."""
    n = torch.sqrt((feats * feats).sum(dim=1, keepdim=True))
    return feats / n.clamp_min(eps)


def apply_mask(feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Zero out padded rows."""
    return feats * mask.to(feats.dtype)[:, None]
