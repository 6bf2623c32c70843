"""K4 and K5: the scalar-feature (Cin == 1) conv that reads its features,
forward and weight gradient, on a stride-1 same-level odd stencil.

``scalar_conv_fwd`` and ``scalar_conv_dw`` launch the CUDA kernels of
``csrc/scalar_conv.cu`` on CUDA tensors and take the plain PyTorch versions
below on CPU tensors. They replace gcl_tpu/core/pallas_conv.py:_conv_c1_fwd
(kernel body _fwd_c1_kernel) and _conv_c1_dw (kernel body _dw_c1_kernel).
On the train path x is the eps term of the exact input jitter.
"""
from __future__ import annotations

from typing import Optional

import torch

from .build import check, load_library
from .occupancy_conv import cube_side, neighbor_rows


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
    their scalars, one matmul with W[:, 0, :]."""
    xv = _matched_scalars(x, aux, skeys, srow, row_sel, cube_side(w.shape[0]))
    return xv @ w[:, 0, :]


def scalar_conv_dw_plain(x, g, aux, skeys, srow, kcube, row_sel=None):
    """Plain version: the same gather, transposed times g."""
    xv = _matched_scalars(x, aux, skeys, srow, row_sel, cube_side(kcube))
    return (xv.T @ g)[:, None, :]


def _check_args(x, other, other_name, aux, skeys, srow, row_sel):
    n = aux.shape[0]
    if aux.dim() != 2 or aux.shape[1] != 8 or tuple(x.shape) != (n, 1):
        raise ValueError(f"expected aux [N, 8] and x [N, 1], got "
                         f"{tuple(aux.shape)} and {tuple(x.shape)}")
    if skeys.dim() != 1 or srow.shape != skeys.shape:
        raise ValueError("skeys and srow must be 1-D of one length")
    if row_sel is not None and tuple(row_sel.shape) != (n,):
        raise ValueError(f"row_sel must be [N], got {tuple(row_sel.shape)}")
    named = [("x", x, torch.float32), (other_name, other, torch.float32),
             ("aux", aux, torch.int32), ("skeys", skeys, torch.int32),
             ("srow", srow, torch.int32)]
    if row_sel is not None:
        named.append(("row_sel", row_sel, torch.float32))
    for name, t, dt in named:
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if x.device.type == "cuda":
        for name, t, _ in named:
            if name != "g" and not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def scalar_conv_fwd(x: torch.Tensor, w: torch.Tensor, aux: torch.Tensor,
                    skeys: torch.Tensor, srow: torch.Tensor,
                    row_sel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out f32[N, Cout] = sum_k x[match(k, i)] * w[k, 0, :].

    x f32[N, 1] (any values), w f32[side^3, 1, Cout] with odd side <= 5,
    aux int32[N, 8] (kernel_maps._c1z_aux), skeys / srow the level's sorted
    valid keys and their rows. ``row_sel`` f32[N], optional: output rows
    with row_sel <= 0 are skipped and come out zero -- exact where x is
    zero on every row of an unselected row's cloud.
    """
    side = cube_side(w.shape[0])
    if w.dim() != 3 or w.shape[1] != 1:
        raise ValueError(f"expected w [K, 1, Cout], got {tuple(w.shape)}")
    _check_args(x, w, "w", aux, skeys, srow, row_sel)
    if x.device.type == "cpu":
        return scalar_conv_fwd_plain(x, w, aux, skeys, srow, row_sel)
    n, cout = aux.shape[0], w.shape[2]
    out = torch.empty((n, cout), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    lib = load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.scalar_conv_fwd(x.data_ptr(), w.data_ptr(), aux.data_ptr(),
                              skeys.data_ptr(), srow.data_ptr(),
                              _ptr(row_sel), out.data_ptr(), n, side, cout,
                              skeys.shape[0], stream)
    check(err, "scalar_conv_fwd")
    scalar_conv_fwd.launches += 1
    return out


def scalar_conv_dw(x: torch.Tensor, g: torch.Tensor, aux: torch.Tensor,
                   skeys: torch.Tensor, srow: torch.Tensor, kcube: int,
                   row_sel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dW f32[kcube, 1, Cout] of scalar_conv_fwd: dW[k, 0, :] = sum_i
    x[match(k, i)] * g[i, :], rows with row_sel <= 0 skipped. g f32[N, Cout]
    may have any strides; it is made contiguous here."""
    side = cube_side(kcube)
    if g.dim() != 2 or g.shape[0] != aux.shape[0]:
        raise ValueError(f"expected g [N, Cout], got {tuple(g.shape)}")
    _check_args(x, g, "g", aux, skeys, srow, row_sel)
    if x.device.type == "cpu":
        return scalar_conv_dw_plain(x, g, aux, skeys, srow, kcube, row_sel)
    g = g.contiguous()
    n, cout = g.shape
    dw = torch.zeros((kcube, 1, cout), dtype=torch.float32, device=x.device)
    if n == 0:
        return dw
    lib = load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.scalar_conv_dw(x.data_ptr(), g.data_ptr(), aux.data_ptr(),
                             skeys.data_ptr(), srow.data_ptr(),
                             _ptr(row_sel), dw.data_ptr(), n, side, cout,
                             skeys.shape[0], stream)
    check(err, "scalar_conv_dw")
    scalar_conv_dw.launches += 1
    return dw


scalar_conv_fwd.launches = 0
scalar_conv_dw.launches = 0
