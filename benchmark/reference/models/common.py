"""Shared model building blocks: the sparse conv module and masked norms
(port of gcl_tpu/models/common.py). Gradients come from the
torch.autograd.Functions of core.sparse_ops.

Parameter and buffer names follow the flax modules (``kernel``, ``bias``,
``scale``, ``mean``, ``var``) so models.weights maps a flax tree onto the
state_dict by name alone.

Parameters and BN statistics are float32 whatever the features' type. For
bf16 features (gcl_tpu's compute_dtype), as in gcl_tpu/models/common.py:
a conv computes in the features' type (its kernel cast to it; the bias
added in the output's type), the batch norm takes its statistics and its
affine map in float32 and returns the features' type, and the input
jitter's noise is cast to the features' type.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..core.kernel_maps import ConvSpec
from ..core.sparse_ops import (draw_input_eps, masked_instance_mean_var,
                               masked_mean_var, sparse_conv, sparse_conv_c1z,
                               sparse_conv_c1z_exact_jitter,
                               sparse_conv_c1z_jittered, sparse_conv_implicit)
from ..core.types import SparseGraph, map_key
from ..kernels.build import rounded


class SparseConv(nn.Module):
    """Sparse (transpose) convolution over a graph's map.

    Dispatch, as in gcl_tpu: a 1x1x1 same-level conv is a plain matmul (no
    map); an ``occupancy`` conv with in_ch == 1 whose implicit map carries
    the occupancy aux runs the K2 presence kernel (its input must be the
    all-ones occupancy features); a conv whose geometry is in
    ``graph.maps`` runs the K6 implicit-map kernel; every other conv runs
    the index-table kernel over ``graph.kmaps``, with its reverse twin's
    table for an odd kernel. The kernel weight is [K, Cin, Cout] with
    offsets in kernel_offsets order ([Cin, Cout] for 1x1).
    """

    def __init__(self, in_ch: int, out_ch: int, spec: ConvSpec,
                 use_bias: bool = False, occupancy: bool = False):
        super().__init__()
        self.in_ch, self.out_ch, self.spec = in_ch, out_ch, spec
        self.occupancy = occupancy
        shape = ((in_ch, out_ch) if spec.is_identity_map
                 else (spec.kernel_size ** 3, in_ch, out_ch))
        # flax variance_scaling(1/3, fan_in, uniform): bound 1/sqrt(fan_in)
        bound = 1.0 / math.sqrt(math.prod(shape[:-1]))
        self.kernel = nn.Parameter(torch.empty(shape).uniform_(-bound,
                                                               bound))
        self.bias = (nn.Parameter(torch.zeros(out_ch)) if use_bias
                     else None)

    def forward(self, x: torch.Tensor, graph: SparseGraph, c1z_jitter=None,
                generator=None, jitter_draws=None) -> torch.Tensor:
        """``c1z_jitter``: optional (sigma, p, row_sel, exact) -- the conv
        owns the train-time feature jitter of its all-ones input. On the
        occupancy path, exact=True: conv(1 + eps) = presence conv(1) +
        scalar conv(eps) (sparse_ops.sparse_conv_c1z_exact_jitter);
        exact=False: distribution-matched noise on the output
        (sparse_ops.sparse_conv_c1z_jittered). On any route that reads its
        features the conv adds the literal input jitter to ``x`` first.
        The noise comes from ``generator`` unless ``jitter_draws`` =
        (gate_u, normal) hands in the numbers already drawn (normal of
        x's shape, f32[N, 1], for the exact and the input jitter, f32[N,
        K] for the other)."""
        gate_u, normal = jitter_draws or (None, None)

        def input_jitter(x):
            sigma, p, row_sel, _ = c1z_jitter
            lv_mask = graph.levels[self.spec.in_stride].mask
            u = gate_u if gate_u is not None else torch.rand(
                (), generator=generator, device=x.device)
            z = normal if normal is not None else torch.randn(
                x.shape, generator=generator, device=x.device)
            noise = z * sigma * lv_mask.to(z.dtype)[:, None]
            if row_sel is not None:
                noise = noise * row_sel.to(z.dtype)[:, None]
            return x + (u < p).to(x.dtype) * noise.to(x.dtype)

        if self.spec.is_identity_map:
            if c1z_jitter is not None:
                x = input_jitter(x)
            y = rounded(torch.matmul(rounded(x), rounded(
                self.kernel.to(x.dtype))))
        else:
            cmap = graph.maps.get(self.spec.key)
            in_level = graph.levels[self.spec.in_stride]
            on_c1z = (self.occupancy and self.in_ch == 1
                      and cmap is not None and cmap.c1z is not None)
            if c1z_jitter is not None and not on_c1z:
                x = input_jitter(x)
            if on_c1z and c1z_jitter is not None:
                sigma, p, row_sel, exact = c1z_jitter
                if exact:
                    eps = draw_input_eps(generator, sigma, p, in_level.mask,
                                         row_sel, gate_u, normal)
                    y = sparse_conv_c1z_exact_jitter(self.kernel, cmap,
                                                     in_level, eps, row_sel,
                                                     x.dtype)
                else:
                    y = sparse_conv_c1z_jittered(self.kernel, cmap, in_level,
                                                 generator, sigma, p,
                                                 row_sel, gate_u, normal,
                                                 x.dtype)
            elif on_c1z:
                y = sparse_conv_c1z(self.kernel, cmap.c1z, in_level, x.dtype)
            elif cmap is not None:
                y = sparse_conv_implicit(x, self.kernel, cmap, in_level,
                                         graph.levels[self.spec.out_stride])
            else:
                # only odd kernels have a reverse twin
                rev = (graph.kmaps.get(map_key(
                    self.spec.out_stride, self.spec.in_stride,
                    self.spec.kernel_size, self.spec.dilation))
                    if self.spec.kernel_size % 2 == 1 else None)
                y = sparse_conv(x, self.kernel, graph.kmaps[self.spec.key],
                                rev)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the valid rows of a padded sparse tensor.

    Train mode normalizes with the masked batch statistics (biased
    variance) and updates the running stats with the unbiased variance:
    running = (1 - m) * running + m * batch. Eval mode uses the running
    stats. Padded rows are normalized too (they never feed a valid row).
    Statistics and the affine map are float32 (float64 stays float64);
    the output is in x's type.
    """

    def __init__(self, features: int, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                batch_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``batch_idx`` (the rows' cloud ids) is the norms' common
        signature; batch norm does not read it."""
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training:
            mean, var, cnt = masked_mean_var(xf, mask)
            with torch.no_grad():
                unbiased = var * cnt / (cnt - 1.0).clamp_min(1.0)
                m = self.momentum
                self.mean.copy_((1 - m) * self.mean + m * mean)
                self.var.copy_((1 - m) * self.var + m * unbiased)
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + self.eps) * self.scale
        return ((xf - mean) * inv + self.bias).to(x.dtype)


class MaskedInstanceNorm(nn.Module):
    """Per-cloud normalization (ME.MinkowskiInstanceNorm) over the valid
    rows of each cloud, in train and eval mode alike: no parameters, no
    running statistics. Clouds are told apart by ``batch_idx`` (a level's
    ``coords[:, 0]``); ids from ``num_items`` on share the extra segment
    (core.sparse_ops.masked_instance_mean_var). Statistics in float32; the
    output in x's type."""

    def __init__(self, features: int, num_items: int = 64,
                 eps: float = 1e-5):
        super().__init__()
        self.features, self.num_items, self.eps = features, num_items, eps

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                batch_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        if batch_idx is None:
            raise ValueError("instance norm needs the rows' cloud ids")
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean, var = masked_instance_mean_var(xf, mask, batch_idx,
                                             self.num_items)
        return ((xf - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)


def get_norm(norm_type: str, features: int, bn_momentum: float = 0.1,
             num_items: int = 64) -> nn.Module:
    """'BN' -> MaskedBatchNorm, 'IN' -> MaskedInstanceNorm."""
    if norm_type == "BN":
        return MaskedBatchNorm(features, momentum=bn_momentum)
    if norm_type == "IN":
        return MaskedInstanceNorm(features, num_items=num_items)
    raise ValueError(f"Type {norm_type}, not defined")
