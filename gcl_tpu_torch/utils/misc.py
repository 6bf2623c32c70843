"""Host-facing helpers (port of gcl_tpu/utils/misc.py): the
extract_features inference API and square_distance."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.kernel_maps import default_level_caps
from ..infer import make_feature_extractor


def square_distance(src: torch.Tensor, dst: torch.Tensor,
                    normalised: bool = False) -> torch.Tensor:
    """[B, N, C] x [B, M, C] -> [B, N, M] squared distances, clipped at
    1e-12 (gcl_tpu's; reference util/misc.py:7-26)."""
    dist = -2.0 * torch.matmul(src, dst.transpose(1, 2))
    if normalised:
        dist = dist + 2.0
    else:
        dist = dist + (src ** 2).sum(-1)[:, :, None]
        dist = dist + (dst ** 2).sum(-1)[:, None, :]
    return dist.clamp_min(1e-12)


def _round_up(n, m):
    return ((n + m - 1) // m) * m


def extract_features(model: torch.nn.Module, xyz: np.ndarray,
                     rgb: Optional[np.ndarray] = None,
                     normal: Optional[np.ndarray] = None,
                     voxel_size: float = 0.05, device="cuda",
                     skip_check: bool = False):
    """Voxelize one cloud xyz [N, 3] and run the model in eval mode on
    ``device`` (gcl_tpu's extract_features, reference util/misc.py:58-130):
    capacity n_cap = N rounded up to 4096, level caps
    default_level_caps(n_cap, strides, 0.7), the model's conv plan.

    The input features are [rgb - 0.5] and / or [normal / 2] where given,
    else the occupancy. Returns (xyz of each valid voxel's representative
    point float32[M, 3], features [M, out_channels]), tensors on
    ``device``.
    """
    if not skip_check:
        assert xyz.shape[1] == 3
        if rgb is not None:
            assert len(rgb) == len(xyz) and rgb.shape[1] == 3
            if np.any(rgb > 1):
                raise ValueError(
                    "Invalid color. Color must range from [0, 1]")
        if normal is not None:
            assert len(normal) == len(xyz) and normal.shape[1] == 3
            if np.any(normal > 1):
                raise ValueError(
                    "Invalid normal. Normal must range from [-1, 1]")
    parts = []
    if rgb is not None:
        parts.append(rgb - 0.5)
    if normal is not None:
        parts.append(normal / 2)

    dev = torch.device(device)
    n = len(xyz)
    n_cap = _round_up(n, 4096)
    pts = torch.zeros((1, n_cap, 3), dtype=torch.float32)
    pts[0, :n] = torch.from_numpy(np.asarray(xyz, np.float32))
    pmask = torch.zeros((1, n_cap), dtype=torch.bool)
    pmask[0, :n] = True
    point_feats = None
    if parts:
        f = np.hstack(parts).astype(np.float32)
        point_feats = torch.zeros((1, n_cap, f.shape[1]))
        point_feats[0, :n] = torch.from_numpy(f)
        point_feats = point_feats.to(dev)

    specs = type(model).conv_specs(model.conv1.spec.kernel_size)
    strides = sorted({s for sp in specs
                      for s in (sp.in_stride, sp.out_stride)})
    extract = make_feature_extractor(
        model.to(dev), specs, voxel_size, n_cap,
        default_level_caps(n_cap, strides, 0.7))
    vox, feats = extract(pts.to(dev), pmask.to(dev), point_feats)
    valid = vox.mask[0]
    return vox.xyz[0][valid], feats[0][valid]
