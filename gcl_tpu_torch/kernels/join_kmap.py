"""K10: the join that builds an explicit kernel map, of two-word query keys
against a level's sorted two-word keys.

``join_kmap`` launches the CUDA kernel of ``csrc/join_kmap.cu`` on CUDA
tensors and takes the plain PyTorch version below on CPU tensors. It
replaces gcl_tpu/core/pallas_join.py:join_kmap (kernel body _join_kernel);
the plain version is the port of gcl_tpu/core/kernel_maps.py:_build_kmap's
lookup.

The kernel resolves the queries of a tile of TILE consecutive outputs and
one offset group (the offsets of one dx, ``num_offset_groups``) inside a
window of the level's keys: the run between the lexicographic min and max
of the group's valid queries over the tile (gcl_tpu computes the same
bounds in XLA before its pallas_call, pallas_join.py:101-190). Each block
of the kernel works out its own window; ``join_windows`` is the same table
in plain torch, the reference that the tests hold sound and that the keys
the kernel stages are counted against.
"""
from __future__ import annotations

import torch

from ..core.coords import key64, lookup2
from .build import check, counted, load_library, tiled

TILE = 256    # outputs per tile: kTile of csrc/join_kmap.cu
CHUNK = 1024  # keys the kernel stages at a time (even)
# queries per pass of the plain version: bounds its int64 temporaries
_PLAIN_CHUNK = 1 << 24
_SEN = 0x7FFFFFFF
_I64_MAX = torch.iinfo(torch.int64).max
_I64_MIN = torch.iinfo(torch.int64).min


def num_offset_groups(k: int) -> int:
    """The offset groups of a K-offset table (gcl_tpu's num_offset_groups,
    pallas_conv.py:123): side groups of side^2 offsets, one per dx, for a
    cubic table of side >= 2 (kernel_offsets order, z innermost); else
    one."""
    g = round(k ** (1 / 3))
    return g if g >= 2 and g ** 3 == k else 1


def join_windows(key_hi: torch.Tensor, key_lo: torch.Tensor,
                 qhi: torch.Tensor, qlo: torch.Tensor) -> torch.Tensor:
    """int32[2, G, ceil(N_out / TILE)]: for each (offset group, tile) the
    first position and the length of the run of keys between the
    lexicographic min and max of its valid queries (sentinel queries never
    enter the bounds; a tile without one has length 0): the window that
    K10's block for that (tile, group) stages."""
    k, n_out = qhi.shape
    grp = num_offset_groups(k)
    q = key64(qhi, qlo).reshape(grp, k // grp, n_out)
    valid = (qhi != _SEN).reshape(q.shape)
    tmin = tiled(torch.where(valid, q, _I64_MAX).amin(1), TILE,
                 _I64_MAX).amin(-1)
    tmax = tiled(torch.where(valid, q, _I64_MIN).amax(1), TILE,
                 _I64_MIN).amax(-1)
    keys = key64(key_hi, key_lo)
    start = torch.searchsorted(keys, tmin.contiguous())
    end = torch.searchsorted(keys, tmax.contiguous(), right=True)
    live = tmin != _I64_MAX
    length = torch.where(live, end - start, 0).clamp(min=0)
    return torch.stack([torch.where(live, start, 0), length]).to(torch.int32)


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


def join_kmap(key_hi: torch.Tensor, key_lo: torch.Tensor, perm: torch.Tensor,
              qhi: torch.Tensor, qlo: torch.Tensor, *,
              chunk: int = CHUNK) -> torch.Tensor:
    """kmap[k, i] = perm[p] where (key_hi[p], key_lo[p]) == (qhi[k, i],
    qlo[k, i]), else -1; a sentinel query (qhi == 0x7FFFFFFF) gives -1.

    key_hi / key_lo / perm int32[T]: a level's keys in lexicographic
    signed order (unique among its valid rows; the padded tail carries the
    sentinel on both words) and the row of each. qhi / qlo int32[K, N_out].
    The kernel finds a query's key only inside its tile's window
    (``join_windows``). chunk: the keys the kernel stages at a time, even
    (a small one forces windows of many chunks, for tests). Returns
    int32[K, N_out].
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
    k, n_out = qhi.shape
    out = torch.empty_like(qhi)
    if qhi.numel() == 0:
        return out
    if key_hi.shape[0] == 0:
        return out.fill_(-1)
    if chunk < 2 or chunk % 2:
        raise ValueError(f"chunk must be even and positive, got {chunk}")
    grp = num_offset_groups(k)
    n_tiles = -(-n_out // TILE)
    lib = load_library()
    stream = torch.cuda.current_stream(qhi.device).cuda_stream
    err = lib.join_kmap(key_hi.data_ptr(), key_lo.data_ptr(),
                        perm.data_ptr(), qhi.data_ptr(), qlo.data_ptr(),
                        out.data_ptr(), key_hi.shape[0], n_out, k // grp,
                        grp, n_tiles, chunk, stream)
    check(err, "join_kmap")
    join_kmap.launches += 1
    return out


join_kmap.launches = 0


def counted_join_keys(device):
    """While the block runs, K10's launches on ``device`` count the keys
    they stage into shared memory (each block its window; the kernel adds
    up the copies its threads issue). Yields an int64 tensor [1] on the
    card that holds the sum once the block has ended: ``join_windows``'s
    sum of lengths when the kernel stages what the table says."""
    return counted(device, ("join_kmap_count_keys",), 1,
                   "K10's staged-key counter")
