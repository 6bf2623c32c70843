"""Core records of the sparse-voxel engine (port of gcl_tpu/core/types.py).

Fixed-capacity padded tensors plus validity masks, as in the JAX package,
so levels and features compare row for row with it. The TPU's window
tables (``FusedMap``) are not ported. On the implicit route a level
carries its sorted packed keys and each conv geometry its query keys
(``ConvMap``); the CUDA kernels resolve the map by binary search. On the
explicit route (more than 31 clouds, or an even kernel) a level carries
its sorted two-word keys and each geometry an index table
(``SparseGraph.kmaps``).
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
    stride (rows in key order; cloud-blocked with pads inline up to 31
    clouds, one compacted run above). mask: bool[N_l].
    The implicit route's index (None on a graph that has none):
    skeys: int32[n_valid] packed keys (cloud ids folded mod 31) of the
    VALID rows only, sorted ascending as signed int32.
    srow: int32[n_valid] the row in ``coords`` of each sorted key.
    The explicit route's index (None where no map is joined):
    key_hi, key_lo: int32[N_l] the (hi, lo) keys of coords.coord_keys of
    the valid rows in lexicographic order, 0x7FFFFFFF on the padded tail.
    perm: int32[N_l] the row in ``coords`` of each sorted key.
    """

    coords: torch.Tensor
    mask: torch.Tensor
    skeys: Optional[torch.Tensor] = None
    srow: Optional[torch.Tensor] = None
    key_hi: Optional[torch.Tensor] = None
    key_lo: Optional[torch.Tensor] = None
    perm: Optional[torch.Tensor] = None


@dataclasses.dataclass
class ConvMap:
    """Implicit kernel map of one forward conv geometry.

    qkey: int32[K, N_out] packed query keys of out_coords + offset_k at the
    input stride (pack_query_keys); padded / off-lattice queries carry keys
    that no sorted level key equals.
    c1z: None, or int32[N_out, 8] occupancy-conv aux (stride-1 same-level
    odd maps): col 0 the row's own packed query key, cols 1-3 its
    grid-shifted (ux, uy, uz) coords, -(1 << 20) on padded rows.
    rqkey: None (even kernels), or int32[K, N_in] the query keys of the
    reverse-direction twin (in and out strides swapped) over the INPUT
    level's rows, which the backward resolves against the output level:
    kmap[k, i] == j  <=>  rev[K-1-k, j] == i. It is the same tensor as the
    twin geometry's ``qkey`` (a same-level map is its own twin).
    """

    qkey: torch.Tensor
    c1z: Optional[torch.Tensor] = None
    rqkey: Optional[torch.Tensor] = None


@dataclasses.dataclass
class SparseGraph:
    """The static geometry of one U-Net forward pass.

    levels: stride -> LevelCoords. maps: map_key -> ConvMap for every
    conv geometry on the implicit route and its reverse twin. kmaps:
    map_key -> int32[K, N_out] index table (the input level's row at
    out_coords + offset_k, -1 where there is none) for every geometry on
    the explicit route and, for odd kernels, its reverse twin. 1x1
    same-level convs need neither.
    """

    levels: Dict[int, LevelCoords]
    maps: Dict[str, ConvMap]
    kmaps: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ColocationGroups:
    """Fixed-capacity colocation groups (GCL positive clusters), one slot
    per centre voxel; invalid slots are masked, not dropped.

    member_idx: int32[G, Kc] global voxel rows of the members (centre-cloud
    hits first, then each neighbour cloud's), -1 pad. member_mask:
    bool[G, Kc]. finest_pos: int32[G] column of the finest member (the one
    closest to its own LiDAR origin; 0 is the centre voxel itself). valid:
    bool[G] (centre voxel valid and at least one cross-cloud hit).
    anchor_xyz: float32[G, 3] integer voxel coords of the centre voxel.
    anchor_item: int32[G] sample index of the group.
    """

    member_idx: torch.Tensor
    member_mask: torch.Tensor
    finest_pos: torch.Tensor
    valid: torch.Tensor
    anchor_xyz: torch.Tensor
    anchor_item: torch.Tensor


def map_key(in_stride: int, out_stride: int, kernel_size: int,
            dilation: int) -> str:
    """Canonical name for a kernel map between two stride levels."""
    return f"s{in_stride}->s{out_stride}/k{kernel_size}d{dilation}"
