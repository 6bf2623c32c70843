"""Per-cloud voxelization and colocation groups on the device (port of
gcl_tpu/data/device_pipeline.py: voxelize_per_cloud, the brute-force
radius_knn and the group tables built from it).

The grid search (``cell`` set) rides gcl_tpu's windowed top-k kernel
(pallas_radius.windowed_cell_topk), which is not ported yet: asking for it
raises.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..core.types import INVALID_BATCH, ColocationGroups, SparseBatch
from ..core.voxelize import voxelize_clouds

_FAR = 1e30  # distance / norm sentinel of masked rows, as in gcl_tpu


@dataclasses.dataclass
class VoxelizedClouds:
    """Per-cloud voxelization output, fixed per-cloud capacity.

    coords: int32[C, Nv, 4] (cloud, x, y, z); mask: bool[C, Nv];
    xyz: float32[C, Nv, 3] representative original points (zeros on pads).
    """

    coords: torch.Tensor
    mask: torch.Tensor
    xyz: torch.Tensor

    def flatten(self) -> SparseBatch:
        """Concatenate clouds into one SparseBatch (global row = c*Nv+i)."""
        c, nv, _ = self.coords.shape
        coords = self.coords.reshape(c * nv, 4)
        mask = self.mask.reshape(c * nv)
        return SparseBatch(coords, mask[:, None].to(torch.float32), mask)


def voxelize_per_cloud(points: torch.Tensor, pmask: torch.Tensor,
                       voxel_size, nv_cap: int) -> VoxelizedClouds:
    """Quantize each cloud of points [C, P, 3] independently (own frame,
    own capacity); pmask bool[C, P]."""
    coords, mask, rep = voxelize_clouds(points, pmask, voxel_size, nv_cap)
    xyz = torch.gather(points, 1, rep.long()[..., None].expand(-1, -1, 3))
    xyz = torch.where(mask[..., None], xyz, 0.0)
    c = points.shape[0]
    cloud_id = torch.arange(c, dtype=torch.int32,
                            device=points.device)[:, None]
    coords = coords.clone()
    coords[:, :, 0] = torch.where(mask, cloud_id, INVALID_BATCH)
    return VoxelizedClouds(coords, mask, xyz)


def transform_points(xyz: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 transform to [..., 3] points."""
    return xyz @ t[:3, :3].T + t[:3, 3]


def _smallest_k(d2: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """The k smallest entries along the last axis in ascending order, ties
    by lower index first (jax.lax.top_k(-d2, k)'s order): one top-k over
    int64 keys (order-preserving bits of the float << 32 | index), which
    are distinct, so torch.topk's unspecified tie order never shows.
    Returns (idx int64[..., k], values[..., k])."""
    bits = d2.contiguous().view(torch.int32)
    # flip the magnitude bits of negative floats: integer order = float order
    ordered = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    iota = torch.arange(d2.shape[-1], device=d2.device)
    idx = torch.topk((ordered.long() << 32) | iota, k, dim=-1, largest=False,
                     sorted=True)[0] & 0xFFFFFFFF
    return idx, torch.gather(d2, -1, idx)


def radius_knn(queries: torch.Tensor, q_mask: torch.Tensor,
               targets: torch.Tensor, t_mask: torch.Tensor, radius, k: int,
               chunk: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """K nearest targets within ``radius`` of each query, hits sorted by
    distance (brute force, ``chunk`` queries at a time).

    queries f32[Q, 3], targets f32[..., T, 3] with optional leading batch
    dims (every batch shares the queries), t_mask bool[..., T]. Returns
    (idx int32[..., Q, k], hit bool[..., Q, k]); idx is meaningful only
    where hit.
    """
    q = queries.shape[0]
    # a masked target sits _FAR away: adding 0 leaves a valid one's bits
    t2 = ((targets * targets).sum(dim=-1)
          + torch.where(t_mask, 0.0, _FAR))[..., None, :]    # [..., 1, T]
    tt = targets.transpose(-1, -2)                           # [..., 3, T]
    idx, d2 = [], []
    for lo in range(0, q, chunk):
        qc = queries[lo:lo + chunk]
        # (2 qc) @ t is 2 (qc @ t) exactly
        dist = ((qc * qc).sum(dim=1)[:, None] + t2) - (2.0 * qc) @ tt
        i, d = _smallest_k(dist, k)
        idx.append(i.to(torch.int32))
        d2.append(d)
    idx, d2 = torch.cat(idx, dim=-2), torch.cat(d2, dim=-2)
    hit = (d2 <= radius * radius) & q_mask[:, None]
    return idx, hit


def _assemble_groups(vox: VoxelizedClouds, idx: torch.Tensor,
                     hit: torch.Tensor) -> ColocationGroups:
    """Group tables of one sample from its per-cloud searches (idx / hit
    [C, Q, k]; cloud 0 is the centre). Member rows are c * Nv + i."""
    c, nv, _ = vox.xyz.shape
    k = idx.shape[-1]
    dev = idx.device
    center_mask = vox.mask[0]
    own_norms = torch.sqrt((vox.xyz * vox.xyz).sum(dim=-1))  # to own LiDAR
    own_norms = torch.where(vox.mask, own_norms, _FAR)

    row_off = (torch.arange(c, dtype=torch.int32, device=dev) * nv)[:, None,
                                                                    None]
    gidx = (idx + row_off).permute(1, 0, 2).reshape(-1, c * k)
    ghit = hit.permute(1, 0, 2).reshape(-1, c * k)
    member_idx = torch.where(ghit, gidx, -1)

    # finest: per neighbour cloud only the norm of its FIRST hit competes
    # with the centre voxel's own norm; the earliest cloud wins ties
    # (argmin returns the first minimum)
    first = torch.gather(own_norms, 1, idx[:, :, 0].long())  # [C, Q]
    cand = torch.where(hit[:, :, 0], first, _FAR).T.clone()  # [Q, C]
    cand[:, 0] = torch.where(center_mask, own_norms[0], _FAR)
    finest_pos = torch.argmin(cand, dim=1).to(torch.int32) * k

    valid = center_mask & hit[1:].any(dim=2).any(dim=0)
    return ColocationGroups(
        member_idx=member_idx, member_mask=ghit & valid[:, None],
        finest_pos=finest_pos, valid=valid,
        anchor_xyz=vox.coords[0, :, 1:4].to(torch.float32),
        anchor_item=torch.zeros(nv, dtype=torch.int32, device=dev))


def build_colocation_groups(vox: VoxelizedClouds, transforms: torch.Tensor,
                            search_radius, k: int = 5, chunk: int = 512,
                            cell: Optional[float] = None) -> ColocationGroups:
    """Colocation groups of one sample of C clouds (cloud 0 the centre).

    transforms f32[C, 4, 4] map each cloud into the centre frame. For each
    centre voxel, the k nearest voxels within ``search_radius`` in the
    centre cloud itself and in every aligned neighbour cloud form one
    group; groups with no cross-cloud hit are invalid.
    """
    if cell is not None:
        raise NotImplementedError(
            "the grid group search (cell set) runs gcl_tpu's windowed "
            "top-k kernel (K1, pallas_radius.windowed_cell_topk), which is "
            "not ported; pass cell=None for the brute-force search")
    aligned = (vox.xyz @ transforms[:, :3, :3].transpose(1, 2)
               + transforms[:, None, :3, 3])
    idx, hit = radius_knn(vox.xyz[0], vox.mask[0], aligned, vox.mask,
                          search_radius, k, chunk)
    return _assemble_groups(vox, idx, hit)


def batch_colocation_groups(vox_b: VoxelizedClouds,
                            transforms_b: torch.Tensor, search_radius,
                            k: int = 5, chunk: int = 512,
                            cell: Optional[float] = None) -> ColocationGroups:
    """Groups of a batch: vox_b fields carry a leading sample dim
    [B, C, Nv, ...]; member rows index the flattened [B * C * Nv] voxel
    array and anchor_item is the sample. ``search_radius`` is a scalar or
    a per-sample f32[B]."""
    b, c, nv, _ = vox_b.xyz.shape
    dev = vox_b.xyz.device
    radius_b = torch.broadcast_to(torch.as_tensor(
        search_radius, dtype=torch.float32, device=dev), (b,))
    per = [build_colocation_groups(
        VoxelizedClouds(vox_b.coords[i], vox_b.mask[i], vox_b.xyz[i]),
        transforms_b[i], radius_b[i], k, chunk, cell) for i in range(b)]
    sample = torch.arange(b, dtype=torch.int32, device=dev)
    member_idx = torch.stack([g.member_idx for g in per])    # [B, Nv, Kc]
    member_idx = torch.where(member_idx >= 0,
                             member_idx + (sample * (c * nv))[:, None, None],
                             -1)
    return ColocationGroups(
        member_idx=member_idx.reshape(b * nv, c * k),
        member_mask=torch.stack([g.member_mask for g in per]).reshape(
            b * nv, c * k),
        finest_pos=torch.cat([g.finest_pos for g in per]),
        valid=torch.cat([g.valid for g in per]),
        anchor_xyz=torch.cat([g.anchor_xyz for g in per]),
        anchor_item=sample.repeat_interleave(nv))
