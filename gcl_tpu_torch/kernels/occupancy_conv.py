"""K2: the occupancy convolution forward (conv1 of an in_ch == 1 model).

``occupancy_conv_fwd`` launches the CUDA kernel of
``csrc/occupancy_conv_fwd.cu`` on a CUDA tensor and takes the plain PyTorch
version below on a CPU tensor. It replaces
gcl_tpu/core/pallas_conv.py:fused_conv_c1z_fwd (kernel body
_fwd_c1z_kernel).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.coords import DEFAULT_KEY_BITS, kernel_offsets, lookup, wrap_int32
from .build import check, load_library

MAX_SIDE = 5  # side^2 presence bits must fit one int32 column


def _side(w: torch.Tensor) -> int:
    side = round(w.shape[0] ** (1 / 3))
    if side ** 3 != w.shape[0] or side % 2 != 1 or side > MAX_SIDE:
        raise ValueError(f"occupancy conv needs an odd cubic kernel with "
                         f"side <= {MAX_SIDE}, got K={w.shape[0]}")
    return side


def occupancy_conv_fwd_plain(aux: torch.Tensor, skeys: torch.Tensor,
                             w: torch.Tensor):
    """Plain version: presence by searchsorted of every neighbour key,
    then ``bits.float() @ W[:, 0, :]``; sbits packs the same bits."""
    side = _side(w)
    bx, by, bz = DEFAULT_KEY_BITS
    offs = torch.from_numpy(kernel_offsets(side).astype(np.int64)).to(
        aux.device)                                          # [K, 3]
    u = aux[:, None, 1:4].long() + offs[None]                # [N, K, 3]
    lim = torch.tensor([1 << bx, 1 << by, 1 << bz], device=aux.device)
    in_range = ((u >= 0) & (u < lim)).all(dim=-1)
    delta = (offs[:, 0] << (by + bz)) + (offs[:, 1] << bz) + offs[:, 2]
    nkey = wrap_int32(aux[:, 0:1].long() + delta[None])      # [N, K]
    found = lookup(skeys, torch.zeros_like(skeys), nkey) >= 0
    bits = (in_range & found).to(torch.int32)                # [N, K]
    out = bits.to(w.dtype) @ w[:, 0, :]
    s2 = side * side
    shift = torch.arange(s2, device=aux.device, dtype=torch.int32)
    cols = (bits.reshape(-1, side, s2) << shift).sum(-1, dtype=torch.int32)
    sbits = torch.zeros((aux.shape[0], 8), dtype=torch.int32,
                        device=aux.device)
    sbits[:, :side] = cols
    return out, sbits


def occupancy_conv_fwd(aux: torch.Tensor, skeys: torch.Tensor,
                       w: torch.Tensor):
    """(out, sbits) of the occupancy conv over a stride-1 level.

    aux int32[N, 8] (kernel_maps._c1z_aux layout), skeys int32[n] (the
    level's sorted valid keys), w f32[side^3, 1, Cout] with odd side <= 5.
    out f32[N, Cout] = sum_k present_k(i) * w[k, 0]; sbits int32[N, 8] has
    bit dy*side + dz of column dx set iff offset (dx, dy, dz) is present.
    """
    side = _side(w)
    if aux.dim() != 2 or aux.shape[1] != 8 or w.shape[1] != 1:
        raise ValueError(f"expected aux [N, 8] and w [K, 1, Cout], got "
                         f"{tuple(aux.shape)} and {tuple(w.shape)}")
    for name, t, dt in (("aux", aux, torch.int32),
                        ("skeys", skeys, torch.int32),
                        ("w", w, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != aux.device:
            raise ValueError(f"{name} on {t.device}, aux on {aux.device}")
    if aux.device.type == "cpu":
        return occupancy_conv_fwd_plain(aux, skeys, w)
    if aux.device.type != "cuda":
        raise ValueError(f"unsupported device {aux.device}")
    for name, t in (("aux", aux), ("skeys", skeys), ("w", w)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n, cout = aux.shape[0], w.shape[2]
    out = torch.empty((n, cout), dtype=torch.float32, device=aux.device)
    sbits = torch.empty((n, 8), dtype=torch.int32, device=aux.device)
    if n == 0:
        return out, sbits
    lib = load_library()
    stream = torch.cuda.current_stream(aux.device).cuda_stream
    err = lib.occupancy_conv_fwd(aux.data_ptr(), skeys.data_ptr(),
                                 w.data_ptr(), out.data_ptr(),
                                 sbits.data_ptr(), n, side, cout,
                                 skeys.shape[0], stream)
    check(err, "occupancy_conv_fwd")
    occupancy_conv_fwd.launches += 1
    return out, sbits


occupancy_conv_fwd.launches = 0
