"""K2 and K3: the occupancy convolution (conv1 of an in_ch == 1 model),
forward and weight gradient.

``occupancy_conv_fwd`` launches the CUDA kernel of
``csrc/occupancy_conv_fwd.cu`` on a CUDA tensor and takes the plain PyTorch
version below on a CPU tensor. It replaces
gcl_tpu/core/pallas_conv.py:fused_conv_c1z_fwd (kernel body
_fwd_c1z_kernel). ``occupancy_conv_dw`` does the same with
``csrc/occupancy_conv_dw.cu`` and replaces fused_conv_c1z_dw (kernel body
_dw_c1z_kernel).

Both take float32 or bf16: the forward's out in a given type (W rounded to
it once per launch, as gcl_tpu's _c1z_w3 does, sums in float32, out
rounded once), the weight gradient's g in either type (sums and dW in
float32). The bf16 forms are the kernels' ``*_bf16`` entry points.

The forward kernel resolves the neighbours of a tile of rows inside a
window of the level's sorted keys per dx, which each of its blocks works
out for its tile (gcl_tpu's compute_windows_h does the same in XLA before
its pallas_call); ``occupancy_windows`` is the same table in plain torch,
the reference that the tests hold sound and that the keys the kernel
stages are counted against.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.coords import DEFAULT_KEY_BITS, kernel_offsets, lookup, wrap_int32
from .build import (FEATURE_DTYPES, check, check_features, counted, entry,
                    summing, tiled)

MAX_SIDE = 5  # side^2 presence bits must fit one int32 column
TILE = 128    # rows of a tile of the forward kernel: kTile of its source
CHUNK = 1024  # keys the forward kernel stages at a time
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


def occupancy_windows(aux: torch.Tensor, skeys: torch.Tensor, side: int,
                      row_sel: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """int32[2, side, ceil(N / TILE), 2]: [0] the first position and [1]
    the length of the runs of skeys that hold every neighbour, at dx group
    g, of the rows of each tile: [..., 0] the run of negative keys, [..., 1]
    the run of non-negative ones (clouds >= 16 have negative packed keys, so
    a tile that mixes clouds 15 and 16 would otherwise window over every
    cloud between). A row's neighbours at dx lie among the keys q + (dx <<
    (BY + BZ)) + (dy << BZ) + dz, |dy|, |dz| <= R, q = aux[:, 0], where the
    neighbour's coords are in range (then no field carries); rows that
    have no neighbour at dx (pads included) stay out of the bounds, and
    so do the rows with ``row_sel`` <= 0 where a row flag f32[N] is given.
    The windows that the blocks of K2 (no flag) and of K4 / K5 (their
    ``row_sel``) stage."""
    bx, by, bz = DEFAULT_KEY_BITS
    r = side // 2
    dev = aux.device
    u = aux[:, 1:4].long()
    lim = torch.tensor([1 << by, 1 << bz], device=dev)
    yz = ((u[:, 1:] >= -r) & (u[:, 1:] < lim + r)).all(1)
    dx = torch.arange(-r, r + 1, device=dev)[:, None]
    ux = u[None, :, 0] + dx                                   # [side, N]
    live = yz & (ux >= 0) & (ux < (1 << bx))
    if row_sel is not None:
        live = live & (row_sel > 0)
    reach = (r << bz) + r
    lo = aux[None, :, 0].long() + (dx << (by + bz)) - reach
    hi = lo + 2 * reach
    neg, pos = live & (lo < 0), live & (hi >= 0)
    # [side, n_tiles, 2]: the negative run, then the non-negative one
    tmin = tiled(torch.stack([torch.where(neg, lo, _I64_MAX),
                              torch.where(pos, lo.clamp(min=0), _I64_MAX)]),
                 TILE, _I64_MAX).amin(-1).permute(1, 2, 0)
    tmax = tiled(torch.stack([torch.where(neg, hi.clamp(max=-1), _I64_MIN),
                              torch.where(pos, hi, _I64_MIN)]),
                 TILE, _I64_MIN).amax(-1).permute(1, 2, 0)
    start = torch.searchsorted(
        skeys, tmin.clamp(_I32.min, _I32.max).to(torch.int32).contiguous())
    end = torch.searchsorted(
        skeys, tmax.clamp(_I32.min, _I32.max).to(torch.int32).contiguous(),
        right=True)
    ok = tmin <= tmax
    length = torch.where(ok, end - start, 0).clamp(min=0)
    return torch.stack([torch.where(ok, start, 0), length]).to(torch.int32)


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
    out = (bits.to(wk.dtype) @ wk).to(dtype)
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


def occupancy_conv_fwd(aux: torch.Tensor, skeys: torch.Tensor,
                       w: torch.Tensor, out_dtype=None, *,
                       chunk: int = CHUNK):
    """(out, sbits) of the occupancy conv over a stride-1 level.

    aux int32[N, 8] (kernel_maps._c1z_aux layout), skeys int32[n] (the
    level's sorted valid keys), w f32[side^3, 1, Cout] with odd side <= 5.
    out [N, Cout] in ``out_dtype`` (float32 or bfloat16, the features'
    type of the model; w's type when None) = sum_k present_k(i) * w[k, 0],
    w rounded to out_dtype; sbits int32[N, 8] has bit dy*side + dz of
    column dx set iff offset (dx, dy, dz) is present. The kernel finds a
    neighbour only inside its tile's window (``occupancy_windows``). chunk:
    the keys the kernel stages at a time (a small one forces windows of
    many chunks, for tests).
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
    out_dtype = out_dtype or w.dtype
    if out_dtype not in FEATURE_DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    if aux.device.type == "cpu":
        return occupancy_conv_fwd_plain(aux, skeys, w, out_dtype)
    if aux.device.type != "cuda":
        raise ValueError(f"unsupported device {aux.device}")
    for name, t in (("aux", aux), ("skeys", skeys), ("w", w)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n, cout = aux.shape[0], w.shape[2]
    out = torch.empty((n, cout), dtype=out_dtype, device=aux.device)
    sbits = torch.empty((n, 8), dtype=torch.int32, device=aux.device)
    if n == 0:
        return out, sbits
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    w = w.to(out_dtype)
    stream = torch.cuda.current_stream(aux.device).cuda_stream
    err = entry("occupancy_conv_fwd", out_dtype)(
        aux.data_ptr(), skeys.data_ptr(), w.data_ptr(), out.data_ptr(),
        sbits.data_ptr(), skeys.shape[0], n, side, cout, chunk, stream)
    check(err, "occupancy_conv_fwd")
    occupancy_conv_fwd.launches += 1
    return out, sbits


occupancy_conv_fwd.launches = 0


def counted_occupancy_keys(device):
    """While the block runs, K2's launches on ``device`` count the keys they
    stage into shared memory (each block its windows; the kernel adds up
    the copies its threads issue). Yields an int64 tensor [1] on the card
    that holds the sum once the block has ended: ``occupancy_windows``'s
    sum of lengths when the kernel stages what the table says."""
    return counted(device, ("occupancy_conv_fwd_count_keys",), 1,
                   "K2's staged-key counter")


def occupancy_conv_dw(sbits: torch.Tensor, g: torch.Tensor,
                      kcube: int) -> torch.Tensor:
    """dW f32[kcube, 1, Cout] of the occupancy conv: dW[k, 0, :] = sum_i
    present_k(i) * g[i, :], the bits read from the forward's sbits
    int32[N, 8]. g f32 or bf16 [N, Cout] may be any strides (an upstream
    gradient often is not contiguous); it is made contiguous here."""
    side = cube_side(kcube)
    if (sbits.dim() != 2 or sbits.shape[1] != 8 or g.dim() != 2
            or g.shape[0] != sbits.shape[0]):
        raise ValueError(f"expected sbits [N, 8] and g [N, Cout], got "
                         f"{tuple(sbits.shape)} and {tuple(g.shape)}")
    if sbits.dtype != torch.int32:
        raise TypeError(f"sbits must be int32, got {sbits.dtype}")
    check_features("g", g)
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
    if n == 0 or cout == 0:
        return dw
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = entry("occupancy_conv_dw", g.dtype)(
        sbits.data_ptr(), g.data_ptr(), dw.data_ptr(), n, side, cout, stream)
    check(err, "occupancy_conv_dw")
    occupancy_conv_dw.launches += 1
    return dw


occupancy_conv_dw.launches = 0
