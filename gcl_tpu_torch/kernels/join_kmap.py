"""K10: the join that builds an explicit kernel map, of two-word query keys
against a level's sorted two-word keys.

``join_kmap`` launches the CUDA kernel of ``csrc/join_kmap.cu`` on CUDA
tensors and takes the plain PyTorch version below on CPU tensors. It
replaces gcl_tpu/core/pallas_join.py:join_kmap (kernel body _join_kernel);
the plain version is the port of gcl_tpu/core/kernel_maps.py:_build_kmap's
lookup.
"""
from __future__ import annotations

import torch

from ..core.coords import lookup2
from .build import check, load_library

# queries per pass of the plain version: bounds its int64 temporaries
_PLAIN_CHUNK = 1 << 24


def join_kmap_plain(key_hi: torch.Tensor, key_lo: torch.Tensor,
                    perm: torch.Tensor, qhi: torch.Tensor,
                    qlo: torch.Tensor) -> torch.Tensor:
    """Plain version: torch.searchsorted over the pair fused into one
    int64, a few offsets at a time."""
    k, n_out = qhi.shape
    step = max(1, _PLAIN_CHUNK // max(n_out, 1))
    rows = [lookup2(key_hi, key_lo, perm, qhi[i:i + step], qlo[i:i + step])
            for i in range(0, k, step)]
    return torch.cat(rows) if rows else qhi.new_empty((0, n_out))


def join_kmap(key_hi: torch.Tensor, key_lo: torch.Tensor, perm: torch.Tensor,
              qhi: torch.Tensor, qlo: torch.Tensor) -> torch.Tensor:
    """kmap[k, i] = perm[p] where (key_hi[p], key_lo[p]) == (qhi[k, i],
    qlo[k, i]), else -1; a sentinel query (qhi == 0x7FFFFFFF) gives -1.

    key_hi / key_lo / perm int32[T]: a level's keys in lexicographic
    signed order (unique among its valid rows; the padded tail carries the
    sentinel on both words) and the row of each. qhi / qlo int32[K, N_out].
    Returns int32[K, N_out].
    """
    if qhi.dim() != 2 or qlo.shape != qhi.shape:
        raise ValueError(f"expected qhi and qlo [K, N_out] of one shape, "
                         f"got {tuple(qhi.shape)} and {tuple(qlo.shape)}")
    if key_hi.dim() != 1 or key_lo.shape != key_hi.shape \
            or perm.shape != key_hi.shape:
        raise ValueError("key_hi, key_lo and perm must be 1-D of one length")
    for name, t in (("key_hi", key_hi), ("key_lo", key_lo), ("perm", perm),
                    ("qhi", qhi), ("qlo", qlo)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be torch.int32, got {t.dtype}")
        if t.device != qhi.device:
            raise ValueError(f"{name} on {t.device}, qhi on {qhi.device}")
    if qhi.device.type == "cpu":
        return join_kmap_plain(key_hi, key_lo, perm, qhi, qlo)
    if qhi.device.type != "cuda":
        raise ValueError(f"unsupported device {qhi.device}")
    for name, t in (("key_hi", key_hi), ("key_lo", key_lo), ("perm", perm),
                    ("qhi", qhi), ("qlo", qlo)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty_like(qhi)
    if qhi.numel() == 0:
        return out
    if key_hi.shape[0] == 0:
        return out.fill_(-1)
    lib = load_library()
    stream = torch.cuda.current_stream(qhi.device).cuda_stream
    err = lib.join_kmap(key_hi.data_ptr(), key_lo.data_ptr(),
                        perm.data_ptr(), qhi.data_ptr(), qlo.data_ptr(),
                        out.data_ptr(), key_hi.shape[0], qhi.numel(), stream)
    check(err, "join_kmap")
    join_kmap.launches += 1
    return out


join_kmap.launches = 0
