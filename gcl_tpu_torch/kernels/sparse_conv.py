"""K6: the implicit-map sparse convolution forward.

``sparse_conv_implicit_fwd`` launches the CUDA kernel of
``csrc/sparse_conv_fwd.cu`` on a CUDA tensor and takes the plain PyTorch
version below on a CPU tensor. It replaces
gcl_tpu/core/pallas_conv.py:_conv_half_fwd (kernel body _fwd_kernel_h).
"""
from __future__ import annotations

import torch

from ..core.coords import lookup
from .build import check, load_library


def sparse_conv_implicit_fwd_plain(x: torch.Tensor, w: torch.Tensor,
                                   qkey: torch.Tensor, skeys: torch.Tensor,
                                   srow: torch.Tensor) -> torch.Tensor:
    """Plain version: searchsorted resolution, then a gather and one
    matmul per offset, summed in offset order."""
    n_in, cin = x.shape
    rows = lookup(skeys, srow, qkey).long()
    xp = torch.cat([x, x.new_zeros((1, cin))])
    idx = torch.where(rows < 0, n_in, rows)
    out = x.new_zeros((qkey.shape[1], w.shape[2]))
    for k in range(w.shape[0]):
        out = out + xp[idx[k]] @ w[k]
    return out


def _check_args(x, w, qkey, skeys, srow):
    if x.dim() != 2 or w.dim() != 3 or qkey.dim() != 2:
        raise ValueError("expected x [N_in, Cin], w [K, Cin, Cout], "
                         "qkey [K, N_out]")
    if w.shape[1] != x.shape[1] or w.shape[0] != qkey.shape[0]:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, qkey {tuple(qkey.shape)}")
    if skeys.dim() != 1 or srow.shape != skeys.shape:
        raise ValueError("skeys and srow must be 1-D of one length")
    for name, t, dt in (("x", x, torch.float32), ("w", w, torch.float32),
                        ("qkey", qkey, torch.int32),
                        ("skeys", skeys, torch.int32),
                        ("srow", srow, torch.int32)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")


def sparse_conv_implicit_fwd(x: torch.Tensor, w: torch.Tensor,
                             qkey: torch.Tensor, skeys: torch.Tensor,
                             srow: torch.Tensor) -> torch.Tensor:
    """out[i] = sum_k x[srow[p]] @ w[k] where skeys[p] == qkey[k, i], zero
    where no key matches.

    x f32[N_in, Cin], w f32[K, Cin, Cout], qkey int32[K, N_out],
    skeys / srow int32[n] (sorted valid keys of the input level and their
    rows). Returns f32[N_out, Cout].
    """
    _check_args(x, w, qkey, skeys, srow)
    if x.device.type == "cpu":
        return sparse_conv_implicit_fwd_plain(x, w, qkey, skeys, srow)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    for name, t in (("x", x), ("w", w), ("qkey", qkey), ("skeys", skeys),
                    ("srow", srow)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    kvol, cin, cout = w.shape
    n_out = qkey.shape[1]
    out = torch.empty((n_out, cout), dtype=torch.float32, device=x.device)
    if n_out == 0:
        return out
    lib = load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.sparse_conv_implicit_fwd(
        x.data_ptr(), w.data_ptr(), qkey.data_ptr(), skeys.data_ptr(),
        srow.data_ptr(), out.data_ptr(), cin, cout, kvol, n_out,
        skeys.shape[0], stream)
    check(err, "sparse_conv_implicit_fwd")
    sparse_conv_implicit_fwd.launches += 1
    return out


sparse_conv_implicit_fwd.launches = 0
