"""Shared model building blocks: the sparse conv module and masked norms
(port of gcl_tpu/models/common.py). Gradients come from the
torch.autograd.Functions of core.sparse_ops.

Parameter and buffer names follow the flax modules (``kernel``, ``bias``,
``scale``, ``mean``, ``var``) so models.weights maps a flax tree onto the
state_dict by name alone.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..core.kernel_maps import ConvSpec
from ..core.sparse_ops import (draw_input_eps, masked_mean_var,
                               sparse_conv_c1z, sparse_conv_c1z_exact_jitter,
                               sparse_conv_implicit)
from ..core.types import SparseGraph


class SparseConv(nn.Module):
    """Sparse (transpose) convolution over a graph's implicit map.

    Dispatch: a 1x1x1 same-level conv is a plain matmul (no map); an
    ``occupancy`` conv with in_ch == 1 runs the K2 presence kernel (its
    input must be the all-ones occupancy features); every other conv runs
    the K6 implicit-map kernel. The kernel weight is [K, Cin, Cout] with
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
        owns the train-time feature jitter of its all-ones input. Only an
        occupancy conv takes it, and only exact=True is ported: conv(1 +
        eps) = presence conv(1) + scalar conv(eps)
        (sparse_ops.sparse_conv_c1z_exact_jitter). The noise comes from
        ``generator`` unless ``jitter_draws`` = (gate_u, normal) hands in
        draw_input_eps's numbers already drawn."""
        if self.spec.is_identity_map:
            y = torch.matmul(x, self.kernel)
        else:
            cmap = graph.maps[self.spec.key]
            in_level = graph.levels[self.spec.in_stride]
            on_c1z = (self.occupancy and self.in_ch == 1
                      and cmap.c1z is not None)
            if c1z_jitter is not None:
                sigma, p, row_sel, exact = c1z_jitter
                if not on_c1z:
                    raise NotImplementedError(
                        "input jitter is ported for the occupancy conv1 "
                        "only")
                if not exact:
                    raise NotImplementedError(
                        "jitter_mode 'c1z' (distribution-matched output "
                        "noise) is not ported; use the exact input jitter")
                gate_u, normal = jitter_draws or (None, None)
                eps = draw_input_eps(generator, sigma, p, in_level.mask,
                                     row_sel, gate_u, normal)
                y = sparse_conv_c1z_exact_jitter(self.kernel, cmap, in_level,
                                                 eps, row_sel)
            elif on_c1z:
                y = sparse_conv_c1z(self.kernel, cmap.c1z, in_level)
            else:
                y = sparse_conv_implicit(x, self.kernel, cmap, in_level,
                                         graph.levels[self.spec.out_stride])
        if self.bias is not None:
            y = y + self.bias
        return y


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the valid rows of a padded sparse tensor.

    Train mode normalizes with the masked batch statistics (biased
    variance) and updates the running stats with the unbiased variance:
    running = (1 - m) * running + m * batch. Eval mode uses the running
    stats. Padded rows are normalized too (they never feed a valid row).
    """

    def __init__(self, features: int, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean, var, cnt = masked_mean_var(x, mask)
            with torch.no_grad():
                unbiased = var * cnt / (cnt - 1.0).clamp_min(1.0)
                m = self.momentum
                self.mean.copy_((1 - m) * self.mean + m * mean)
                self.var.copy_((1 - m) * self.var + m * unbiased)
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + self.eps) * self.scale
        return (x - mean) * inv + self.bias


def get_norm(norm_type: str, features: int,
             bn_momentum: float = 0.1) -> nn.Module:
    """'BN' -> MaskedBatchNorm (instance norm variants are not ported)."""
    if norm_type == "BN":
        return MaskedBatchNorm(features, momentum=bn_momentum)
    raise ValueError(f"Type {norm_type}, not defined")
