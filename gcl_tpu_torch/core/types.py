"""Core records of the sparse-voxel engine (port of gcl_tpu/core/types.py).

Fixed-capacity padded tensors plus validity masks, as in the JAX package,
so levels and features compare row for row with it. The TPU's window
tables (``FusedMap``) are not ported: a level carries its sorted packed
keys, and each conv geometry carries its query keys (``ConvMap``); the
CUDA kernels resolve the map by binary search over the sorted keys.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

# Sentinel cloud index of padded (invalid) voxel rows; sorts after every
# real cloud index.
INVALID_BATCH = 0x000FFFFF  # 2**20 - 1


@dataclasses.dataclass
class SparseBatch:
    """A batch of sparse voxel tensors, fixed capacity.

    coords: int32[N_cap, 4] (cloud, x, y, z); padded rows have cloud ==
    INVALID_BATCH. feats: float[N_cap, C], zero on padded rows.
    mask: bool[N_cap], True for valid rows.
    """

    coords: torch.Tensor
    feats: torch.Tensor
    mask: torch.Tensor


@dataclasses.dataclass
class LevelCoords:
    """Voxel coordinates at one stride level.

    coords: int32[N_l, 4] in level-0 voxel units, exact multiples of the
    stride (cloud-blocked rows, pads inline). mask: bool[N_l].
    skeys: int32[n_valid] packed keys (cloud ids folded mod 31) of the
    VALID rows only, sorted ascending as signed int32.
    srow: int32[n_valid] the row in ``coords`` of each sorted key.
    """

    coords: torch.Tensor
    mask: torch.Tensor
    skeys: torch.Tensor
    srow: torch.Tensor


@dataclasses.dataclass
class ConvMap:
    """Implicit kernel map of one forward conv geometry.

    qkey: int32[K, N_out] packed query keys of out_coords + offset_k at the
    input stride (pack_query_keys); padded / off-lattice queries carry keys
    that no sorted level key equals.
    c1z: None, or int32[N_out, 8] occupancy-conv aux (stride-1 same-level
    odd maps): col 0 the row's own packed query key, cols 1-3 its
    grid-shifted (ux, uy, uz) coords, -(1 << 20) on padded rows.
    """

    qkey: torch.Tensor
    c1z: Optional[torch.Tensor] = None


@dataclasses.dataclass
class SparseGraph:
    """The static geometry of one U-Net forward pass.

    levels: stride -> LevelCoords. maps: map_key -> ConvMap for every
    forward conv geometry with a kernel (1x1 same-level convs need none).
    """

    levels: Dict[int, LevelCoords]
    maps: Dict[str, ConvMap]


def map_key(in_stride: int, out_stride: int, kernel_size: int,
            dilation: int) -> str:
    """Canonical name for a kernel map between two stride levels."""
    return f"s{in_stride}->s{out_stride}/k{kernel_size}d{dilation}"
