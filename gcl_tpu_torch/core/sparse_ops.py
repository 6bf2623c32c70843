"""Sparse tensor compute primitives, forward (port of the serving-path part
of gcl_tpu/core/sparse_ops.py).

A sparse convolution over an implicit map is

    out[i] = sum_k  X[row whose key == qkey[k, i]] @ W[k]   (missing -> 0)

and runs in the K6 kernel, which resolves the map itself. The occupancy
conv1 runs in the K2 presence kernel. Both kernels live in
gcl_tpu_torch.kernels; this module wires them to the graph records.
"""
from __future__ import annotations

import torch

from ..kernels import occupancy_conv_fwd, sparse_conv_implicit_fwd
from .types import LevelCoords


def sparse_conv_implicit(x: torch.Tensor, w: torch.Tensor,
                         qkey: torch.Tensor,
                         in_level: LevelCoords) -> torch.Tensor:
    """Sparse (transpose) convolution of x [N_in, Cin] (the input level's
    rows) with w [K, Cin, Cout] over query keys qkey int32[K, N_out]."""
    return sparse_conv_implicit_fwd(x.contiguous(), w.contiguous(), qkey,
                                    in_level.skeys, in_level.srow)


def sparse_conv_c1z(w: torch.Tensor, c1z: torch.Tensor,
                    level: LevelCoords) -> torch.Tensor:
    """Occupancy convolution: out[i] = sum_k present_k(i) * W[k, 0, :].

    EXACT only under the in_ch == 1 contract: the conv's input features
    are ones on every valid row (how GCL always drives in_ch == 1 models).
    c1z is the level's occupancy aux (ConvMap.c1z).
    """
    out, _ = occupancy_conv_fwd(c1z, level.skeys, w.contiguous())
    return out


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
