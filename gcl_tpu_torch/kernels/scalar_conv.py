"""K4, K5 and K9: the scalar-feature (Cin == 1) conv that reads its
features, forward, weight gradient and input gradient, on a stride-1
same-level odd stencil.

``scalar_conv_fwd``, ``scalar_conv_dw`` and ``scalar_conv_dx`` launch the
CUDA kernels of ``csrc/scalar_conv.cu`` on CUDA tensors and take the plain
PyTorch versions below on CPU tensors. They replace
gcl_tpu/core/pallas_conv.py:_conv_c1_fwd (kernel body _fwd_c1_kernel),
_conv_c1_dw (_dw_c1_kernel) and _conv_co1_fwd (_fwd_co1_kernel: the
Cout == 1 forward that gcl_tpu runs through the reverse queries as the dX
of a Cin == 1 conv). On the train path x is the eps term of the exact input
jitter, which needs no dX; a caller whose x requires a gradient gets it
from K9.

x and g are float32 or bf16 (g in x's type); W stays float32 in both, as
gcl_tpu's c1 / co1 kernels keep it: products and sums are float32, out and
dX rounded to the features' type once, dW float32. The bf16 forms are the
kernels' ``*_bf16`` entry points.

K4 and K5 resolve the neighbours of a tile of flagged rows inside the
windows of the level's sorted keys that K2 stages
(``occupancy_conv.occupancy_windows`` with their ``row_sel`` is the same
table in plain torch); K9 resolves those of every row of its tile (its
flag gates the rows of g it gathers, not its windows: the table without
a flag); ``counted_scalar_keys`` counts the keys the three stage.
"""
from __future__ import annotations

from typing import Optional

import torch

from .build import check, check_features, counted, entry, summing
from .occupancy_conv import cube_side, neighbor_rows

CHUNK = 1024  # keys K4 and K5 stage at a time


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


def _check_args(x, other, other_name, aux, skeys, srow, row_sel):
    """The checks the three wrappers share; x is None where the wrapper
    takes none (the dX)."""
    n = aux.shape[0]
    if aux.dim() != 2 or aux.shape[1] != 8:
        raise ValueError(f"expected aux [N, 8], got {tuple(aux.shape)}")
    if x is not None and tuple(x.shape) != (n, 1):
        raise ValueError(f"expected x [N, 1] = {(n, 1)}, got "
                         f"{tuple(x.shape)}")
    if skeys.dim() != 1 or srow.shape != skeys.shape:
        raise ValueError("skeys and srow must be 1-D of one length")
    if row_sel is not None and tuple(row_sel.shape) != (n,):
        raise ValueError(f"row_sel must be [N], got {tuple(row_sel.shape)}")
    # features: float32 or bf16, g in x's type; w float32
    if x is not None:
        check_features("x", x)
    if other_name == "w":
        feat = None
    else:
        check_features(other_name, other)
        feat = other.dtype if x is None else x.dtype
    named = [(other_name, other, feat or torch.float32),
             ("aux", aux, torch.int32), ("skeys", skeys, torch.int32),
             ("srow", srow, torch.int32)]
    if x is not None:
        named.append(("x", x, x.dtype))
    if row_sel is not None:
        named.append(("row_sel", row_sel, torch.float32))
    dev = aux.device
    for name, t, dt in named:
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, aux on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda":
        for name, t, _ in named:
            if name != "g" and not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_chunk(chunk: int) -> None:
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")


def scalar_conv_fwd(x: torch.Tensor, w: torch.Tensor, aux: torch.Tensor,
                    skeys: torch.Tensor, srow: torch.Tensor,
                    row_sel: Optional[torch.Tensor] = None, *,
                    chunk: int = CHUNK) -> torch.Tensor:
    """out [N, Cout] in x's type = sum_k x[match(k, i)] * w[k, 0, :].

    x f32 or bf16 [N, 1] (any values), w f32[side^3, 1, Cout] with odd
    side <= 5,
    aux int32[N, 8] (kernel_maps._c1z_aux), skeys / srow the level's sorted
    valid keys and their rows. ``row_sel`` f32[N], optional: output rows
    with row_sel <= 0 are skipped and come out zero -- exact where x is
    zero on every row of an unselected row's cloud. chunk: the keys the
    kernel stages at a time (a small one forces windows of many chunks,
    for tests). On the card Cout is at most 196 at side 5 and the default
    chunk (the block's shared memory); a wider one raises at launch.
    """
    side = cube_side(w.shape[0])
    if w.dim() != 3 or w.shape[1] != 1:
        raise ValueError(f"expected w [K, 1, Cout], got {tuple(w.shape)}")
    _check_args(x, w, "w", aux, skeys, srow, row_sel)
    _check_chunk(chunk)
    if x.device.type == "cpu":
        return scalar_conv_fwd_plain(x, w, aux, skeys, srow, row_sel)
    n, cout = aux.shape[0], w.shape[2]
    out = torch.empty((n, cout), dtype=x.dtype, device=x.device)
    if n == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = entry("scalar_conv_fwd", x.dtype)(x.data_ptr(), w.data_ptr(), aux.data_ptr(),
                              skeys.data_ptr(), srow.data_ptr(),
                              _ptr(row_sel), out.data_ptr(), n, side, cout,
                              skeys.shape[0], chunk, stream)
    check(err, "scalar_conv_fwd")
    scalar_conv_fwd.launches += 1
    return out


def scalar_conv_dw(x: torch.Tensor, g: torch.Tensor, aux: torch.Tensor,
                   skeys: torch.Tensor, srow: torch.Tensor, kcube: int,
                   row_sel: Optional[torch.Tensor] = None, *,
                   chunk: int = CHUNK) -> torch.Tensor:
    """dW f32[kcube, 1, Cout] of scalar_conv_fwd: dW[k, 0, :] = sum_i
    x[match(k, i)] * g[i, :], rows with row_sel <= 0 skipped. g [N, Cout]
    in x's type may have any strides; it is made contiguous here. chunk
    and the widest Cout as scalar_conv_fwd's."""
    side = cube_side(kcube)
    if g.dim() != 2 or g.shape[0] != aux.shape[0]:
        raise ValueError(f"expected g [N, Cout], got {tuple(g.shape)}")
    _check_args(x, g, "g", aux, skeys, srow, row_sel)
    _check_chunk(chunk)
    if x.device.type == "cpu":
        return scalar_conv_dw_plain(x, g, aux, skeys, srow, kcube, row_sel)
    g = g.contiguous()
    n, cout = g.shape
    dw = torch.zeros((kcube, 1, cout), dtype=torch.float32, device=x.device)
    if n == 0:
        return dw
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = entry("scalar_conv_dw", x.dtype)(x.data_ptr(), g.data_ptr(), aux.data_ptr(),
                             skeys.data_ptr(), srow.data_ptr(),
                             _ptr(row_sel), dw.data_ptr(), n, side, cout,
                             skeys.shape[0], chunk, stream)
    check(err, "scalar_conv_dw")
    scalar_conv_dw.launches += 1
    return dw


def scalar_conv_dx(g: torch.Tensor, w: torch.Tensor, aux: torch.Tensor,
                   skeys: torch.Tensor, srow: torch.Tensor,
                   row_sel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dX [N, 1] in g's type of scalar_conv_fwd: dX[j] = sum over the
    (k, i) with match(k, i) == j of g[i, :] . w[k, 0, :], rows i with
    row_sel[i] <= 0 left out (their outputs were skipped): the exact
    adjoint of scalar_conv_fwd in x for any row flag. g f32 or bf16 [N,
    Cout] may have any strides; it is made contiguous here."""
    side = cube_side(w.shape[0])
    if w.dim() != 3 or w.shape[1] != 1:
        raise ValueError(f"expected w [K, 1, Cout], got {tuple(w.shape)}")
    n = aux.shape[0]
    if g.dim() != 2 or tuple(g.shape) != (n, w.shape[2]):
        raise ValueError(f"expected g [N, Cout] = {(n, w.shape[2])}, got "
                         f"{tuple(g.shape)}")
    _check_args(None, g, "g", aux, skeys, srow, row_sel)
    if w.dtype != torch.float32 or w.device != g.device:
        raise TypeError(f"w must be float32 on {g.device}, got {w.dtype} on "
                        f"{w.device}")
    if g.device.type == "cpu":
        return scalar_conv_dx_plain(g, w, aux, skeys, srow, row_sel)
    g, w = g.contiguous(), w.contiguous()
    dx = torch.empty((n, 1), dtype=g.dtype, device=g.device)
    if n == 0:
        return dx
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = entry("scalar_conv_dx", g.dtype)(g.data_ptr(), w.data_ptr(), aux.data_ptr(),
                             skeys.data_ptr(), srow.data_ptr(),
                             _ptr(row_sel), dx.data_ptr(), n, side,
                             w.shape[2], skeys.shape[0], stream)
    check(err, "scalar_conv_dx")
    scalar_conv_dx.launches += 1
    return dx


scalar_conv_fwd.launches = 0
scalar_conv_dw.launches = 0
scalar_conv_dx.launches = 0


def counted_scalar_keys(device):
    """While the block runs, K4, K5 and K9's launches on ``device`` count
    the keys they stage into shared memory (each block its windows; the
    kernels add up the copies their threads issue). Yields an int64 tensor
    [1] on the card that holds the sum once the block has ended:
    ``occupancy_windows(aux, skeys, side, row_sel)``'s sum of lengths a K4
    or K5 launch, ``occupancy_windows(aux, skeys, side)``'s a K9 launch,
    when the kernels stage what the tables say."""
    return counted(device, ("scalar_conv_count_keys",), 1,
                   "K4, K5 and K9's staged-key counter")
