"""The plain index-table join of the explicit route (K10's plain version).

A frozen copy of the port's plain version; nothing here launches a kernel.
"""
from __future__ import annotations

import torch

from ..core.coords import key64, lookup2

# queries per pass of the plain version: bounds its int64 temporaries
_PLAIN_CHUNK = 1 << 24
_SEN = 0x7FFFFFFF
_I64_MAX = torch.iinfo(torch.int64).max
_I64_MIN = torch.iinfo(torch.int64).min


def join_kmap_plain(key_hi: torch.Tensor, key_lo: torch.Tensor,
                    perm: torch.Tensor, qhi: torch.Tensor,
                    qlo: torch.Tensor) -> torch.Tensor:
    """Plain version: torch.searchsorted over the pair fused into one
    int64, a few offsets at a time, over the whole level."""
    k, n_out = qhi.shape
    step = max(1, _PLAIN_CHUNK // max(n_out, 1))
    rows = [lookup2(key_hi, key_lo, perm, qhi[i:i + step], qlo[i:i + step])
            for i in range(0, k, step)]
    return torch.cat(rows) if rows else qhi.new_empty((0, n_out))


