"""K6, K7, K8 and K12: the sparse convolution over an implicit map or an
index table, forward, backward and standalone weight gradient.

``sparse_conv_implicit_fwd`` launches the CUDA kernel of
``csrc/sparse_conv_fwd.cu`` on a CUDA tensor and takes the plain PyTorch
version below on a CPU tensor. It replaces
gcl_tpu/core/pallas_conv.py:_conv_half_fwd (kernel body _fwd_kernel_h).
``sparse_conv_implicit_bwd`` does the same with ``csrc/sparse_conv_bwd.cu``
(dX and dW over the reverse map, two launches behind one call) and
replaces _conv_half_bwd (kernel body _bwd_kernel_h). K6, K12 and K7's dX
are one tensor-core gather-GEMM (``csrc/gather_gemm.cuh``) that multiplies
only the matched rows, compacted per (64-row tile, offset) and padded to
16; ``compacted_rows`` counts that work from a map's hit mask, and
``counted_gather_rows`` has the kernels count what they multiplied.
Every dW is one split-K tensor-core core (``csrc/splitk_dw.cuh``) that
stages only the matched (input row, output row) pairs, 32 at a time: K7's
dW resolves them through the reverse map, ``sparse_conv_dw``
(``csrc/sparse_conv_dw.cu``, K8) through the forward map or an index
table; ``counted_dw_rows`` has it count the rows it staged. Over the
implicit forward map K8 replaces _conv_half_dw (kernel body _dw_kernel_h),
over an index table pallas_conv_dw. ``sparse_conv_table_fwd`` (K12, the
forward kernel with its rows read from a table) replaces pallas_conv_fwd,
the index-table API that gcl_tpu reaches through _fused_from_idx.
"""
from __future__ import annotations

import contextlib
from typing import Optional

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


def sparse_conv_implicit_bwd_plain(x: torch.Tensor, g: torch.Tensor,
                                   w: torch.Tensor, rqkey: torch.Tensor,
                                   skeys: torch.Tensor, srow: torch.Tensor,
                                   want_dx: bool = True):
    """Plain version: the reverse rows by searchsorted, then per reverse
    offset k' a gather of g, one matmul for dX (with W[K-1-k']^T) and one
    for dW[K-1-k']."""
    n_out, cout = g.shape
    kvol = w.shape[0]
    rows = lookup(skeys, srow, rqkey).long()                 # [K, N_in]
    gp = torch.cat([g, g.new_zeros((1, cout))])
    idx = torch.where(rows < 0, n_out, rows)
    dx = torch.zeros_like(x) if want_dx else None
    dw = []
    for kp in range(kvol):
        gg = gp[idx[kp]]                                     # [N_in, Cout]
        if want_dx:
            dx = dx + gg @ w[kvol - 1 - kp].T
        dw.append(x.T @ gg)
    return dx, torch.stack(dw[::-1])


# a row of the gathered operand is packed beside its 6-bit tile row in one
# 32-bit list entry (csrc/gather_gemm.cuh)
MAX_GATHER_ROWS = 1 << 26


def compacted_rows(hit: torch.Tensor, tile: int = 64, frag: int = 16):
    """(matched, executed) rows of a map whose hit mask is ``hit`` bool[K,
    N] (offset k of output row i has an input): matched counts the hits;
    executed what the gather-GEMM multiplies, the hits of each (``tile``-row
    tile, offset) rounded up to a multiple of ``frag``. Times Cin x Cout x 2
    they are the matched and the executed operations."""
    kvol, n = hit.shape
    pad = -n % tile
    per = torch.nn.functional.pad(hit.to(torch.int64), (0, pad))
    per = per.reshape(kvol, -1, tile).sum(-1)
    return int(per.sum()), int(((per + frag - 1) // frag * frag).sum())


@contextlib.contextmanager
def counted_gather_rows(device):
    """While the block runs, the gather-GEMM launches (K6, K12, K7's dX)
    on ``device`` count the rows they multiply: per (64-row tile, offset)
    the compacted list rounded up to 16, the rows of the mma fragments the
    block ran. Yields an int64 tensor [1] on the card that holds the sum
    once the block has ended. For checks: the count is one atomic add per
    block, and launches outside the block count nothing."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the kernels count on a CUDA device, not {device}")
    lib = load_library()
    setters = (lib.sparse_conv_fwd_count_rows, lib.sparse_conv_bwd_count_rows)
    counter = torch.zeros(1, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        torch.cuda.synchronize()
        for fn in setters:
            check(fn(counter.data_ptr()), "the gather-GEMM's row counter")
        try:
            yield counter
        finally:
            torch.cuda.synchronize()
            for fn in setters:
                check(fn(None), "the gather-GEMM's row counter")


@contextlib.contextmanager
def counted_dw_rows(device):
    """While the block runs, the split-K dW launches (K7's dW, K8 in both
    forms) on ``device`` count what they stage: yields an int64 tensor [2]
    on the card that holds, once the block has ended, the rows staged (per
    32-pair stage the pairs rounded up to 8) and the blocks that staged
    them, both over the first Cin x Cout tile of each launch. For checks:
    one atomic add per block, and launches outside the block count
    nothing."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the kernels count on a CUDA device, not {device}")
    lib = load_library()
    setters = (lib.sparse_conv_dw_count_rows,
               lib.sparse_conv_bwd_count_dw_rows)
    counter = torch.zeros(2, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        torch.cuda.synchronize()
        for fn in setters:
            check(fn(counter.data_ptr()), "the dW's staged-row counter")
        try:
            yield counter
        finally:
            torch.cuda.synchronize()
            for fn in setters:
                check(fn(None), "the dW's staged-row counter")


def _check_gather_rows(name, t):
    if t.shape[0] >= MAX_GATHER_ROWS:
        raise ValueError(f"{name} has {t.shape[0]} rows; the kernel gathers "
                         f"from fewer than {MAX_GATHER_ROWS}")


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
    _check_gather_rows("x", x)
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


def sparse_conv_implicit_bwd(x: torch.Tensor, g: torch.Tensor,
                             w: torch.Tensor, rqkey: torch.Tensor,
                             skeys: torch.Tensor, srow: torch.Tensor,
                             want_dx: bool = True):
    """(dX, dW) of sparse_conv_implicit_fwd over the reverse map, in one
    call (two launches: dX, then dW): dX[j] = sum_k' g[rev(k', j)] @
    w[K-1-k']^T (None unless want_dx) and dW[K-1-k'] = sum_j x[j]^T
    g[rev(k', j)], dW in forward offset order.

    x f32[N_in, Cin], g f32[N_out, Cout] (any strides: made contiguous
    here), w f32[K, Cin, Cout], rqkey int32[K, N_in] the reverse-direction
    query keys (ConvMap.rqkey), skeys / srow the OUTPUT level's sorted
    valid keys and their rows.
    """
    _check_args(x, w, rqkey, skeys, srow)
    if rqkey.shape[1] != x.shape[0]:
        raise ValueError(f"rqkey {tuple(rqkey.shape)} does not cover x "
                         f"{tuple(x.shape)}")
    if g.dim() != 2 or g.shape[1] != w.shape[2]:
        raise ValueError(f"g {tuple(g.shape)} does not match w "
                         f"{tuple(w.shape)}")
    if g.dtype != torch.float32:
        raise TypeError(f"g must be torch.float32, got {g.dtype}")
    if g.device != x.device:
        raise ValueError(f"g on {g.device}, x on {x.device}")
    if x.device.type == "cpu":
        return sparse_conv_implicit_bwd_plain(x, g, w, rqkey, skeys, srow,
                                              want_dx)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    for name, t in (("x", x), ("w", w), ("rqkey", rqkey), ("skeys", skeys),
                    ("srow", srow)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    kvol, cin, cout = w.shape
    g = g.contiguous()
    _check_gather_rows("g", g)
    n_in = x.shape[0]
    dx = torch.empty_like(x) if want_dx else None   # every row is written
    dw = torch.zeros_like(w)
    if n_in == 0 or g.shape[0] == 0:
        return (dx.zero_() if want_dx else None), dw
    lib = load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.sparse_conv_implicit_bwd(
        x.data_ptr(), g.data_ptr(), w.data_ptr(), rqkey.data_ptr(),
        skeys.data_ptr(), srow.data_ptr(),
        dx.data_ptr() if want_dx else None, dw.data_ptr(), cin, cout, kvol,
        n_in, skeys.shape[0], int(want_dx), stream)
    check(err, "sparse_conv_implicit_bwd")
    sparse_conv_implicit_bwd.launches += 1
    return dx, dw


sparse_conv_implicit_bwd.launches = 0


def sparse_conv_table_fwd_plain(x: torch.Tensor, w: torch.Tensor,
                                idx: torch.Tensor) -> torch.Tensor:
    """Plain version: a gather and one matmul per offset, summed in offset
    order (gcl_tpu's scan _conv_forward)."""
    n_in, cin = x.shape
    xp = torch.cat([x, x.new_zeros((1, cin))])
    rows = idx.long()
    rows = torch.where((rows < 0) | (rows >= n_in), n_in, rows)
    out = x.new_zeros((idx.shape[1], w.shape[2]))
    for k in range(w.shape[0]):
        out = out + xp[rows[k]] @ w[k]
    return out


def sparse_conv_dw_plain(x: torch.Tensor, g: torch.Tensor,
                         qkey: torch.Tensor,
                         skeys: Optional[torch.Tensor] = None,
                         srow: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Plain version: the forward rows (by searchsorted, or read from the
    table when skeys is None), then per offset a gather of x and one
    matmul."""
    n_in, cin = x.shape
    rows = (qkey if skeys is None else lookup(skeys, srow, qkey)).long()
    rows = torch.where((rows < 0) | (rows >= n_in), n_in, rows)
    xp = torch.cat([x, x.new_zeros((1, cin))])
    return torch.stack([xp[rows[k]].T @ g for k in range(qkey.shape[0])])


def _check_map(x, idx):
    if x.dim() != 2 or idx.dim() != 2:
        raise ValueError(f"expected x [N_in, Cin] and a map [K, N_out], got "
                         f"{tuple(x.shape)} and {tuple(idx.shape)}")
    if x.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"x must be float32 and the map int32, got {x.dtype} "
                        f"and {idx.dtype}")
    if idx.device != x.device:
        raise ValueError(f"the map on {idx.device}, x on {x.device}")


def sparse_conv_table_fwd(x: torch.Tensor, w: torch.Tensor,
                          idx: torch.Tensor) -> torch.Tensor:
    """out[i] = sum_k x[idx[k, i]] @ w[k], an entry outside [0, N_in)
    (a missing input is -1) contributing zero.

    x f32[N_in, Cin], w f32[K, Cin, Cout], idx int32[K, N_out] (a kernel
    map of SparseGraph.kmaps). Returns f32[N_out, Cout]. Through the
    reverse table with flipped, transposed weights it is also the dX of
    the conv.
    """
    _check_map(x, idx)
    if w.dim() != 3 or w.shape[:2] != (idx.shape[0], x.shape[1]):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, idx {tuple(idx.shape)}")
    if w.dtype != torch.float32 or w.device != x.device:
        raise TypeError(f"w must be float32 on {x.device}, got {w.dtype} "
                        f"on {w.device}")
    if x.device.type == "cpu":
        return sparse_conv_table_fwd_plain(x, w, idx)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    for name, t in (("x", x), ("w", w), ("idx", idx)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    _check_gather_rows("x", x)
    kvol, cin, cout = w.shape
    n_out = idx.shape[1]
    out = torch.empty((n_out, cout), dtype=torch.float32, device=x.device)
    if n_out == 0:
        return out
    lib = load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.sparse_conv_table_fwd(
        x.data_ptr(), w.data_ptr(), idx.data_ptr(), out.data_ptr(), cin,
        cout, kvol, n_out, x.shape[0], stream)
    check(err, "sparse_conv_table_fwd")
    sparse_conv_table_fwd.launches += 1
    return out


sparse_conv_table_fwd.launches = 0


def sparse_conv_dw(x: torch.Tensor, g: torch.Tensor, qkey: torch.Tensor,
                   skeys: Optional[torch.Tensor] = None,
                   srow: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dW[k] = sum_i x[row(k, i)]^T g[i] over the forward map, f32[K, Cin,
    Cout]: the standalone weight gradient.

    x f32[N_in, Cin], g f32[N_out, Cout] (any strides: made contiguous
    here). The map comes in one of two forms. Implicit: qkey int32[K,
    N_out] the forward query keys (ConvMap.qkey) with skeys / srow the
    INPUT level's sorted valid keys and their rows. Index table: qkey
    int32[K, N_out] holds the rows themselves (a kernel map of
    SparseGraph.kmaps; outside [0, N_in) means no input) and skeys / srow
    stay None.
    """
    _check_map(x, qkey)
    kvol = qkey.shape[0]
    if g.dim() != 2 or g.shape[0] != qkey.shape[1]:
        raise ValueError(f"g {tuple(g.shape)} does not cover the map "
                         f"{tuple(qkey.shape)}")
    if g.dtype != torch.float32 or g.device != x.device:
        raise TypeError(f"g must be float32 on {x.device}, got {g.dtype} "
                        f"on {g.device}")
    if (skeys is None) != (srow is None):
        raise ValueError("skeys and srow come together or not at all")
    if skeys is not None:
        if skeys.dim() != 1 or srow.shape != skeys.shape:
            raise ValueError("skeys and srow must be 1-D of one length")
        for name, t in (("skeys", skeys), ("srow", srow)):
            if t.dtype != torch.int32 or t.device != x.device:
                raise TypeError(f"{name} must be int32 on {x.device}, got "
                                f"{t.dtype} on {t.device}")
    if x.device.type == "cpu":
        return sparse_conv_dw_plain(x, g, qkey, skeys, srow)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    for name, t in (("x", x), ("qkey", qkey), ("skeys", skeys),
                    ("srow", srow)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    g = g.contiguous()
    cin, cout = x.shape[1], g.shape[1]
    n_out = qkey.shape[1]
    dw = torch.zeros((kvol, cin, cout), dtype=torch.float32, device=x.device)
    if n_out == 0 or x.shape[0] == 0 or dw.numel() == 0:
        return dw
    lib = load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if skeys is None:
        err = lib.sparse_conv_table_dw(
            x.data_ptr(), g.data_ptr(), qkey.data_ptr(), dw.data_ptr(), cin,
            cout, kvol, n_out, x.shape[0], stream)
    else:
        err = lib.sparse_conv_implicit_dw(
            x.data_ptr(), g.data_ptr(), qkey.data_ptr(), skeys.data_ptr(),
            srow.data_ptr(), dw.data_ptr(), cin, cout, kvol, n_out,
            skeys.shape[0], stream)
    check(err, "sparse_conv_dw")
    sparse_conv_dw.launches += 1
    return dw


sparse_conv_dw.launches = 0
