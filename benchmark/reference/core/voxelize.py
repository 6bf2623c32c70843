"""Voxel quantization (sort / unique), fixed capacity — port of
gcl_tpu/core/voxelize.py.

floor-divide, stable key sort, first-occurrence dedup, compaction to a
static capacity. The arithmetic follows the JAX package exactly: true
division by the voxel size (never a multiply by its reciprocal, which
moves points that sit on voxel boundaries), round-half-to-even in the
recentring, stable sorts everywhere.
"""
from __future__ import annotations

import torch

from .coords import coord_keys, sort_by_keys
from .types import INVALID_BATCH, SparseBatch

# The conv packed-key window per cloud (coords.DEFAULT_KEY_BITS): rows
# outside it are dropped, never clipped.
KEY_RANGE_LO = (-512, -512, -64)
KEY_RANGE_HI = (511, 511, 63)

# Recentring shifts are a multiple of every level stride.
RECENTER_ALIGN = 40

_SEN = 0x7FFFFFFF


def true_div(a: torch.Tensor, value: float) -> torch.Tensor:
    """``a / value`` as an IEEE division on every device.

    A Python scalar divisor becomes a multiply by its reciprocal in
    PyTorch's CUDA kernel; a divisor tensor on ``a``'s device does not.
    """
    return a / torch.tensor(value, dtype=a.dtype, device=a.device)


def _recenter_offsets(vcoords: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """Per-cloud int voxel offset [B, 3]: the masked mean voxel, rounded
    half to even to a multiple of RECENTER_ALIGN (0 for empty clouds)."""
    cnt = mask.sum(dim=1).to(torch.float32).clamp_min(1.0)
    s = torch.where(mask[..., None], vcoords.long(), 0).sum(dim=1)
    mid = s.to(torch.float32) / cnt[:, None]
    off = torch.round(true_div(mid, float(RECENTER_ALIGN))).to(torch.int32)
    off = off * RECENTER_ALIGN
    return torch.where(mask.any(dim=1)[:, None], off, 0)


def _quantize(points: torch.Tensor, mask: torch.Tensor, voxel_size):
    """Recentred int voxel coords [B, P, 3] + mask of rows in key range."""
    vcoords = torch.floor(true_div(points, voxel_size)).to(torch.int32)
    vcoords = vcoords - _recenter_offsets(vcoords, mask)[:, None, :]
    lo = torch.tensor(KEY_RANGE_LO, dtype=torch.int32, device=points.device)
    hi = torch.tensor(KEY_RANGE_HI, dtype=torch.int32, device=points.device)
    in_range = ((vcoords >= lo) & (vcoords <= hi)).all(dim=-1)
    return vcoords, mask & in_range


def voxelize_clouds(points: torch.Tensor, mask: torch.Tensor, voxel_size,
                    n_cap: int):
    """Each cloud of points [C, P, 3] quantized on its own (the B == 1
    packed-key path of gcl_tpu's voxelize_points, batched over clouds).

    One invertible 28-bit (x, y, z) key per point; a stable sort dedups it
    and a second stable sort of the dedup-marked keys compacts the kept
    voxels to the front, carrying each one's first point row.

    Returns coords int32[C, n_cap, 4] (cloud column 0 on valid rows,
    (INVALID_BATCH, -1, -1, -1) on pads), mask bool[C, n_cap] and
    rep int32[C, n_cap] (representative point row, 0 on pads).
    """
    c, p = points.shape[:2]
    vcoords, ok = _quantize(points, mask, voxel_size)
    v = vcoords.long()
    key = (((v[..., 0] + 512) << 18) | ((v[..., 1] + 512) << 8)
           | (v[..., 2] + 128))
    key = torch.where(ok, key, _SEN).to(torch.int32)
    key_s, perm = torch.sort(key, dim=1, stable=True)
    first = torch.ones_like(key_s, dtype=torch.bool)
    first[:, 1:] = key_s[:, 1:] != key_s[:, :-1]
    valid = first & (key_s != _SEN)
    key2 = torch.where(valid, key_s, _SEN)
    key2_s, order = torch.sort(key2, dim=1, stable=True)
    take = torch.gather(perm, 1, order)
    m = min(n_cap, p)
    key_m = key2_s[:, :m]
    take = take[:, :m]
    if n_cap > p:  # fewer points than capacity: pad the tail
        key_m = torch.nn.functional.pad(key_m, (0, n_cap - p), value=_SEN)
        take = torch.nn.functional.pad(take, (0, n_cap - p))
    out_mask = key_m != _SEN
    coords = torch.stack([torch.zeros_like(key_m),
                          ((key_m >> 18) & 0x3FF) - 512,
                          ((key_m >> 8) & 0x3FF) - 512,
                          (key_m & 0xFF) - 128], dim=-1)
    pad_row = torch.tensor([INVALID_BATCH, -1, -1, -1], dtype=torch.int32,
                           device=points.device)
    coords = torch.where(out_mask[..., None], coords, pad_row)
    rep = torch.where(out_mask, take, 0).to(torch.int32)
    return coords.to(torch.int32), out_mask, rep


def voxelize_points(points: torch.Tensor, mask: torch.Tensor, voxel_size,
                    n_cap: int):
    """Quantize a batch of point clouds [B, P, 3] into one SparseBatch.

    Returns (batch, rep_idx): batch.coords int32[n_cap, 4] = (cloud, x, y,
    z), occupancy features float32[n_cap, 1], mask bool[n_cap]; rep_idx
    int32[n_cap, 2] the (cloud, point) of each voxel's representative
    point (its first point in key order). Voxels beyond n_cap are dropped
    (largest keys first).
    """
    b, p = points.shape[:2]
    dev = points.device
    if b == 1:
        coords, out_mask, rep = voxelize_clouds(points, mask, voxel_size,
                                                n_cap)
        coords, out_mask, rep = coords[0], out_mask[0], rep[0]
        rep_idx = torch.stack([torch.zeros_like(rep), rep], dim=1)
        return (SparseBatch(coords, out_mask[:, None].to(torch.float32),
                            out_mask), rep_idx)

    vcoords, mask = _quantize(points, mask, voxel_size)
    cloud_id = torch.arange(b, dtype=torch.int32, device=dev)[:, None]
    cloud_id = torch.where(mask, cloud_id.expand(b, p), INVALID_BATCH)
    coords = torch.cat([cloud_id[..., None], vcoords],
                       dim=-1).reshape(b * p, 4).to(torch.int32)
    point_id = torch.arange(p, dtype=torch.int32,
                            device=dev)[None, :].expand(b, p).reshape(-1)
    flat_cloud = cloud_id.reshape(-1).to(torch.int32)

    hi, lo = coord_keys(coords)
    hi_s, lo_s, coords_s, cid_s, pid_s = sort_by_keys(
        hi, lo, coords, flat_cloud, point_id)
    first = torch.ones_like(hi_s, dtype=torch.bool)
    first[1:] = (hi_s[1:] != hi_s[:-1]) | (lo_s[1:] != lo_s[:-1])
    valid = first & (cid_s != INVALID_BATCH)

    slot = torch.cumsum(valid.long(), 0) - 1
    slot = torch.where(valid & (slot < n_cap), slot, n_cap)
    out_coords = torch.full((n_cap + 1, 4), -1, dtype=torch.int32,
                            device=dev)
    out_coords[:, 0] = INVALID_BATCH
    out_rep = torch.zeros((n_cap + 1, 2), dtype=torch.int32, device=dev)
    keep = slot < n_cap
    out_coords[slot[keep]] = coords_s[keep]
    out_rep[slot[keep], 0] = cid_s[keep]
    out_rep[slot[keep], 1] = pid_s[keep]
    out_coords = out_coords[:n_cap]
    out_rep = out_rep[:n_cap]
    out_mask = out_coords[:, 0] != INVALID_BATCH
    return (SparseBatch(out_coords, out_mask[:, None].to(torch.float32),
                        out_mask), out_rep)


def representative_xyz(points: torch.Tensor, rep_idx: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """The representative original point of each voxel, float[N, 3]
    (zeros on padded rows)."""
    xyz = points[rep_idx[:, 0].long(), rep_idx[:, 1].long()]
    return torch.where(mask[:, None], xyz, 0.0)
