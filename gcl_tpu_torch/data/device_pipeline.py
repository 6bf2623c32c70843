"""Per-cloud voxelization on the device (port of the serving-path part of
gcl_tpu/data/device_pipeline.py)."""
from __future__ import annotations

import dataclasses

import torch

from ..core.types import INVALID_BATCH, SparseBatch
from ..core.voxelize import voxelize_clouds


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
