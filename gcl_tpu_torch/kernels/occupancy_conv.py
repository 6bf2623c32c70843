"""K2 and K3: the occupancy convolution (conv1 of an in_ch == 1 model),
forward and weight gradient.

``occupancy_conv_fwd`` launches the CUDA kernel of
``csrc/occupancy_conv_fwd.cu`` on a CUDA tensor and takes the plain PyTorch
version below on a CPU tensor. It replaces
gcl_tpu/core/pallas_conv.py:fused_conv_c1z_fwd (kernel body
_fwd_c1z_kernel). ``occupancy_conv_dw`` does the same with
``csrc/occupancy_conv_dw.cu`` and replaces fused_conv_c1z_dw (kernel body
_dw_c1z_kernel).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.coords import DEFAULT_KEY_BITS, kernel_offsets, lookup, wrap_int32
from .build import check, load_library

MAX_SIDE = 5  # side^2 presence bits must fit one int32 column


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
                             w: torch.Tensor):
    """Plain version: presence by searchsorted of every neighbour key,
    then ``bits.float() @ W[:, 0, :]``; sbits packs the same bits."""
    side = cube_side(w.shape[0])
    rows = neighbor_rows(aux, skeys, torch.zeros_like(skeys), side)
    bits = (rows >= 0).to(torch.int32)                       # [N, K]
    out = bits.to(w.dtype) @ w[:, 0, :]
    s2 = side * side
    shift = torch.arange(s2, device=aux.device, dtype=torch.int32)
    cols = (bits.reshape(-1, side, s2) << shift).sum(-1, dtype=torch.int32)
    sbits = torch.zeros((aux.shape[0], 8), dtype=torch.int32,
                        device=aux.device)
    sbits[:, :side] = cols
    return out, sbits


def occupancy_conv_dw_plain(sbits: torch.Tensor, g: torch.Tensor,
                            kcube: int) -> torch.Tensor:
    """Plain version: unpacked bits transposed times g."""
    bits = c1z_unpack_bits(sbits, kcube).to(g.dtype)
    return (bits.T @ g)[:, None, :]


def occupancy_conv_fwd(aux: torch.Tensor, skeys: torch.Tensor,
                       w: torch.Tensor):
    """(out, sbits) of the occupancy conv over a stride-1 level.

    aux int32[N, 8] (kernel_maps._c1z_aux layout), skeys int32[n] (the
    level's sorted valid keys), w f32[side^3, 1, Cout] with odd side <= 5.
    out f32[N, Cout] = sum_k present_k(i) * w[k, 0]; sbits int32[N, 8] has
    bit dy*side + dz of column dx set iff offset (dx, dy, dz) is present.
    """
    side = cube_side(w.shape[0])
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


def occupancy_conv_dw(sbits: torch.Tensor, g: torch.Tensor,
                      kcube: int) -> torch.Tensor:
    """dW f32[kcube, 1, Cout] of the occupancy conv: dW[k, 0, :] = sum_i
    present_k(i) * g[i, :], the bits read from the forward's sbits
    int32[N, 8]. g f32[N, Cout] may be any strides (an upstream gradient
    often is not contiguous); it is made contiguous here."""
    side = cube_side(kcube)
    if (sbits.dim() != 2 or sbits.shape[1] != 8 or g.dim() != 2
            or g.shape[0] != sbits.shape[0]):
        raise ValueError(f"expected sbits [N, 8] and g [N, Cout], got "
                         f"{tuple(sbits.shape)} and {tuple(g.shape)}")
    if sbits.dtype != torch.int32 or g.dtype != torch.float32:
        raise TypeError(f"sbits must be int32 and g float32, got "
                        f"{sbits.dtype} and {g.dtype}")
    if g.device != sbits.device:
        raise ValueError(f"g on {g.device}, sbits on {sbits.device}")
    if sbits.device.type == "cpu":
        return occupancy_conv_dw_plain(sbits, g, kcube)
    if sbits.device.type != "cuda":
        raise ValueError(f"unsupported device {sbits.device}")
    if not sbits.is_contiguous():
        raise ValueError("sbits must be contiguous")
    g = g.contiguous()
    n, cout = g.shape
    dw = torch.zeros((kcube, 1, cout), dtype=torch.float32, device=g.device)
    if n == 0:
        return dw
    lib = load_library()
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = lib.occupancy_conv_dw(sbits.data_ptr(), g.data_ptr(),
                                dw.data_ptr(), n, side, cout, stream)
    check(err, "occupancy_conv_dw")
    occupancy_conv_dw.launches += 1
    return dw


occupancy_conv_dw.launches = 0
