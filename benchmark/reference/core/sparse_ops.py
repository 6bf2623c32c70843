"""Sparse tensor compute primitives with their gradients (port of
gcl_tpu/core/sparse_ops.py).

A sparse convolution is

    out[i] = sum_k  X[row(k, i)] @ W[k]                     (missing -> 0)

with row(k, i) the row whose key equals qkey[k, i] (an implicit map) or
kmap[k, i] (an index table). Four torch.autograd.Functions wire the
kernels of gcl_tpu_torch.kernels to the graph records:

* ``SparseConvImplicit``: forward K6; backward K7, one pass over the
  reverse map for dX and dW (dX only when the input asks for it), or on
  request two passes: K6 through the reverse map with flipped, transposed
  weights for dX and K8 over the forward map for dW;
* ``SparseConvTable`` (``sparse_conv``, the explicit route): forward K12;
  backward with a reverse table K12 through it for dX and K8 for dW, and
  without one (even kernels) a scatter-add in plain torch, as it is plain
  XLA in gcl_tpu;
* ``OccupancyConv`` (conv1 of an in_ch == 1 model on all-ones features):
  forward K2, which also leaves the presence bitmasks; backward K3 from
  those bitmasks; there is no dX;
* ``ScalarConv`` (a Cin == 1 conv that reads its features: the eps term of
  the exact input jitter): forward K4, backward K5 for dW and, only when
  the input asks for a gradient, K9 for dX (the jitter noise does not).

Features are float32 or bf16 (gcl_tpu's compute_dtype), weights float32
(the parameters). As in gcl_tpu/core/sparse_ops.py, a conv's output and
its dX come in the features' type, the upstream gradient is cast to it
before the backward, and dW comes back float32; the kernels take the
weights to the features' type themselves (the Cin == 1 conv of K4 keeps
them float32, as gcl_tpu's does).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels import (c1z_unpack_bits, occupancy_conv_dw, occupancy_conv_fwd,
                       scalar_conv_dw, scalar_conv_dx, scalar_conv_fwd,
                       sparse_conv_dw, sparse_conv_implicit_bwd,
                       sparse_conv_implicit_fwd, sparse_conv_table_fwd)
from ..kernels.build import summing
from .types import ConvMap, LevelCoords

__all__ = ["SparseConvImplicit", "SparseConvTable", "OccupancyConv",
           "ScalarConv", "sparse_conv_implicit", "sparse_conv",
           "sparse_conv_c1z", "c1z_unpack_bits",
           "draw_input_eps", "sparse_conv_c1z_exact_jitter",
           "sparse_conv_c1z_jittered",
           "masked_mean_var", "masked_instance_mean_var", "l2_normalize",
           "apply_mask"]


def _require_f32(name: str, t: torch.Tensor, features: bool = False) -> None:
    """t must be float32, or float32 or bf16 for ``features`` (weights
    are float32 parameters in either compute type)."""
    if t.dtype == torch.float32 or (features and t.dtype == torch.bfloat16):
        return
    allowed = "float32 or bfloat16" if features else "float32"
    raise TypeError(f"{name} must be {allowed}, got {t.dtype}")


def _flipped_transposed(w: torch.Tensor) -> torch.Tensor:
    """W[K-1-k']^T, the weights of the dX conv through a reverse map."""
    return w.flip(0).transpose(1, 2).contiguous()


class SparseConvImplicit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, qkey, rqkey, in_skeys, in_srow, out_skeys,
                out_srow, two_pass=False):
        x, w = x.contiguous(), w.contiguous()
        ctx.save_for_backward(x, w)
        ctx.fwd = (qkey, in_skeys, in_srow)
        ctx.rev = (rqkey, out_skeys, out_srow)
        ctx.two_pass = two_pass
        return sparse_conv_implicit_fwd(x, w, qkey, in_skeys, in_srow)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        rqkey, out_skeys, out_srow = ctx.rev
        if rqkey is None:
            raise ValueError(
                "this implicit map has no reverse twin (build_graph gives "
                "an even kernel an index table instead)")
        want_dx, want_dw = ctx.needs_input_grad[:2]
        if ctx.two_pass:
            g = g.contiguous()
            dx = dw = None
            if want_dx:
                dx = sparse_conv_implicit_fwd(g, _flipped_transposed(w),
                                              rqkey, out_skeys, out_srow)
            if want_dw:
                dw = sparse_conv_dw(x, g, *ctx.fwd)
        else:
            dx, dw = sparse_conv_implicit_bwd(
                x, g, w, rqkey, out_skeys, out_srow, want_dx=want_dx)
        return ((dx, dw if want_dw else None)
                + (None,) * (len(ctx.needs_input_grad) - 2))


class SparseConvTable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, kmap, rev_kmap):
        x, w = x.contiguous(), w.contiguous()
        ctx.save_for_backward(x, w)
        ctx.maps = (kmap, rev_kmap)
        return sparse_conv_table_fwd(x, w, kmap)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        kmap, rev_kmap = ctx.maps
        want_dx, want_dw = ctx.needs_input_grad[:2]
        g = g.to(x.dtype).contiguous()
        dx = dw = None
        if rev_kmap is not None:
            if want_dx:
                dx = sparse_conv_table_fwd(g, _flipped_transposed(w),
                                           rev_kmap)
            if want_dw:
                dw = sparse_conv_dw(x, g, kmap)
            return dx, dw, None, None
        # no reverse table: dX by scatter-add, dW from the gathered rows,
        # offset by offset (gcl_tpu's _sparse_conv_bwd, plain XLA there),
        # summed in float32 (bf16 features: w rounded to bf16, dX rounded
        # once)
        n_in, cin = x.shape
        xs, gs = summing(x), summing(g)
        idx = torch.where(kmap < 0, n_in, kmap).long()
        xp = torch.cat([xs, xs.new_zeros((1, cin))])
        dxp = xs.new_zeros((n_in + 1, cin)) if want_dx else None
        dws = []
        for k in range(w.shape[0]):
            if want_dw:
                dws.append(xp[idx[k]].T @ gs)
            if want_dx:  # row n_in: the pads
                dxp.index_add_(0, idx[k], gs @ summing(w[k].to(x.dtype)).T)
        return (dxp[:n_in].to(x.dtype) if want_dx else None,
                torch.stack(dws) if want_dw else None, None, None)


class OccupancyConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, aux, skeys, out_dtype=None):
        """(out, sbits): the presence bitmasks come out too, so that a
        caller can mask by presence without a second kernel pass. out is
        in ``out_dtype`` (the features' type; w's when None)."""
        out, sbits = occupancy_conv_fwd(aux, skeys, w.contiguous(),
                                        out_dtype)
        ctx.save_for_backward(sbits)
        ctx.mark_non_differentiable(sbits)
        ctx.kcube, ctx.out_dtype = w.shape[0], out.dtype
        return out, sbits

    @staticmethod
    def backward(ctx, g, _g_sbits):
        (sbits,) = ctx.saved_tensors
        dw = occupancy_conv_dw(sbits, g.to(ctx.out_dtype), ctx.kcube)
        return dw, None, None, None


class ScalarConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, aux, skeys, srow, row_sel):
        x, w = x.contiguous(), w.contiguous()
        ctx.save_for_backward(x, w)
        ctx.rest = (aux, skeys, srow, row_sel)
        return scalar_conv_fwd(x, w, aux, skeys, srow, row_sel)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        aux, skeys, srow, row_sel = ctx.rest
        g = g.to(x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # gcl_tpu's dX conv takes the weights flipped and cast to the
            # features' type (K4 itself reads them in float32)
            dx = scalar_conv_dx(g, summing(w.to(x.dtype)), aux, skeys, srow,
                                row_sel)
        if ctx.needs_input_grad[1]:
            dw = scalar_conv_dw(x, g, aux, skeys, srow, w.shape[0], row_sel)
        return (dx, dw) + (None,) * 4


def sparse_conv_implicit(x: torch.Tensor, w: torch.Tensor, cmap: ConvMap,
                         in_level: LevelCoords, out_level: LevelCoords,
                         two_pass_backward: bool = False) -> torch.Tensor:
    """Sparse (transpose) convolution of x [N_in, Cin] (the input level's
    rows, float32 or bf16) with w f32[K, Cin, Cout] over the map's query
    keys, in x's type; differentiable in x and w. ``two_pass_backward``
    takes dX and dW in two kernels (K6 through the reverse map, K8 over
    the forward map) instead of K7's one pass; the gradients are the same
    to rounding."""
    _require_f32("x", x, True)
    _require_f32("w", w)
    return SparseConvImplicit.apply(
        x, w, cmap.qkey, cmap.rqkey, in_level.skeys, in_level.srow,
        out_level.skeys, out_level.srow, two_pass_backward)


def sparse_conv(x: torch.Tensor, w: torch.Tensor, kmap: torch.Tensor,
                rev_kmap: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sparse (transpose) convolution over an index table; differentiable
    in x and w.

    x f32 or bf16 [N_in, Cin] (padded rows MUST be zero), w f32[K, Cin,
    Cout], kmap int32[K, N_out] the input row of each (offset, output row),
    -1 where there is none. rev_kmap: optional int32[K, N_in] table of the
    reverse direction (the output level looked up at in_coords + offset; a
    full odd stencil only): with it dX is a conv of the gradient through
    it with flipped weights, without it a scatter-add. Returns [N_out,
    Cout] in x's type; padded output rows are zero.
    """
    _require_f32("x", x, True)
    _require_f32("w", w)
    return SparseConvTable.apply(x, w, kmap, rev_kmap)


def sparse_conv_c1z(w: torch.Tensor, c1z: torch.Tensor,
                    level: LevelCoords,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Occupancy convolution: out[i] = sum_k present_k(i) * W[k, 0, :] in
    ``out_dtype`` (the type of the all-ones features); differentiable in
    w.

    EXACT only under the in_ch == 1 contract: the conv's input features
    are ones on every valid row (how GCL always drives in_ch == 1 models).
    c1z is the level's occupancy aux (ConvMap.c1z).
    """
    _require_f32("w", w)
    return OccupancyConv.apply(w, c1z, level.skeys, out_dtype)[0]


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
                                 row_sel: Optional[torch.Tensor] = None,
                                 out_dtype: torch.dtype = torch.float32
                                 ) -> torch.Tensor:
    """Occupancy conv + exact input jitter at presence cost.

    conv(1 + eps) = conv(1) + conv(eps) by linearity: the all-ones term
    rides the presence kernels (K2, K3) and the eps term is a
    scalar-feature conv (K4, K5) that skips output rows outside
    ``row_sel`` -- exact because eps (draw_input_eps with the same
    row_sel) is zero on every row of an unselected row's cloud and a
    same-level conv never leaves the cloud. eps carries no parameter
    dependence, so only dW flows back, from both terms. Both terms and
    their sum are in ``out_dtype``: eps (float32) is rounded to it first,
    as gcl_tpu does.
    """
    _require_f32("w", w)
    sel = None
    if row_sel is not None:
        sel = (level.mask.to(torch.float32)
               * row_sel.to(torch.float32)).contiguous()
    return (OccupancyConv.apply(w, cmap.c1z, level.skeys, out_dtype)[0]
            + ScalarConv.apply(eps.detach().to(out_dtype), w, cmap.c1z,
                               level.skeys, level.srow, sel))


def sparse_conv_c1z_jittered(w: torch.Tensor, cmap: ConvMap,
                             level: LevelCoords,
                             generator: Optional[torch.Generator],
                             sigma: float, p: float,
                             row_sel: Optional[torch.Tensor] = None,
                             gate_u: Optional[torch.Tensor] = None,
                             normal: Optional[torch.Tensor] = None,
                             out_dtype: torch.dtype = torch.float32
                             ) -> torch.Tensor:
    """Occupancy conv + distribution-matched output noise (jitter_mode
    'c1z'), plain tensor code on the presence bits K2 leaves.

    Input jitter adds sum_{k present(i)} eps_{j_k} W[k] to output i. This
    draws a fresh iid eps_{ik} per (output, offset) instead, masked by the
    forward's presence bitmasks: per output the mean (zero) and covariance
    (sigma^2 sum_present W[k] W[k]^T) are those of the input jitter; the
    correlation between outputs that share an input voxel is dropped. The
    noise term is differentiable in w, as in gcl_tpu. ``row_sel`` f32[N]
    restricts the noise to selected output rows. The gate uniform (scalar)
    and the normals f32[N, K] come from ``generator`` on w's device unless
    ``gate_u`` / ``normal`` hand them in. The output and the noise's
    product are in ``out_dtype``, as in gcl_tpu.
    """
    _require_f32("w", w)
    out, sbits = OccupancyConv.apply(w, cmap.c1z, level.skeys, out_dtype)
    bits = c1z_unpack_bits(sbits, w.shape[0]).to(torch.float32)
    if gate_u is None:
        gate_u = torch.rand((), generator=generator, device=w.device)
    if normal is None:
        normal = torch.randn(bits.shape, generator=generator,
                             device=w.device)
    a = normal * sigma * bits * (gate_u < p).to(torch.float32)
    if row_sel is not None:
        a = a * row_sel.to(torch.float32)[:, None]
    return out + a.to(out_dtype) @ w[:, 0, :].to(out_dtype)


def masked_mean_var(feats: torch.Tensor, mask: torch.Tensor):
    """Mean / biased variance per channel over valid rows only, in
    float32 (float64 stays float64)."""
    feats = summing(feats)
    m = mask.to(feats.dtype)[:, None]
    cnt = m.sum().clamp_min(1.0)
    mean = (feats * m).sum(dim=0) / cnt
    var = ((feats - mean) ** 2 * m).sum(dim=0) / cnt
    return mean, var, cnt


def masked_instance_mean_var(feats: torch.Tensor, mask: torch.Tensor,
                             batch_idx: torch.Tensor, num_items: int):
    """Per-cloud mean / biased variance over valid rows (instance norm),
    broadcast back to rows: (mean, var), each [N, C].

    Segments as gcl_tpu's segment sums have them: a valid row of cloud c
    sums into segment c, padding rows into the extra segment num_items
    (with weight 0), and a valid row of a cloud id above num_items into
    none (it reads the extra segment's statistics). Counts are clamped to
    1, so an empty cloud has mean 0 and variance 0.

    The sums and the broadcast back are products with one-hot [N, S]
    matrices (S = num_items + 1 segments), so both directions of autograd
    are products too: a gather of a few segment rows by N rows
    (``mean[row]``) has a backward that sorts N indices onto S rows, which
    took ~1 s a step on the card at ResUNetIN2E's 98,304 rows a side."""
    feats = summing(feats)
    n_seg = num_items + 1
    seg = torch.where(mask, batch_idx.long(),
                      torch.full_like(batch_idx, num_items, dtype=torch.long))
    # ids above num_items go to a column past the last and are dropped
    seg = seg.clamp(max=n_seg)
    weights = (torch.nn.functional.one_hot(seg, n_seg + 1)[:, :n_seg]
               * mask[:, None]).to(feats.dtype)                  # [N, S]
    rows = torch.nn.functional.one_hot(seg.clamp(max=num_items),
                                       n_seg).to(feats.dtype)    # [N, S]
    cnt = weights.sum(dim=0).clamp_min(1.0)[:, None]
    mean = rows @ (weights.T @ feats / cnt)
    d = feats - mean
    return mean, rows @ (weights.T @ (d * d) / cnt)


def l2_normalize(feats: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Row-wise L2 normalization."""
    n = torch.sqrt((feats * feats).sum(dim=1, keepdim=True))
    return feats / n.clamp_min(eps)


def apply_mask(feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Zero out padded rows."""
    return feats * mask.to(feats.dtype)[:, None]
