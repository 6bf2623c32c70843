"""Stride levels + implicit kernel maps (port of gcl_tpu/core/kernel_maps.py,
forward maps of the cloud-blocked layout only).

For each stride level the port keeps the level's coords and mask exactly
as gcl_tpu lays them out (cloud-blocked, 256-row-aligned cloud bases, pads
inline), plus the sorted packed keys of its valid rows (``skeys``) and
their rows (``srow``). For each forward conv geometry it keeps the query
keys ``qkey[k, i] = pack_query_keys(fold(out_coords[i]), offset_k *
offset_scale, in_stride)``, exactly what gcl_tpu's _build_fused_maps
computes. The conv kernels resolve ``qkey`` against ``skeys`` by binary
search; the TPU's window tables have no counterpart here.

Transpose-conv parity note (as in gcl_tpu): the map gathers
in[f + d'·s·dil] @ W'[d'], so a MinkowskiEngine weight W maps to
W'[d'] = W[-d'].
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence

import torch

from .coords import (DEFAULT_KEY_BITS, floordiv, kernel_offsets, pack_keys,
                     pack_query_keys)
from .types import (INVALID_BATCH, ConvMap, LevelCoords, SparseGraph,
                    map_key)

# Packed keys fold cloud ids mod 31 (PAD_CLOUD = 31 is reserved), which is
# injective only up to 31 clouds per graph.
MAX_CLOUDS = 31
_BLOCK_ALIGN = 256
_SEN = 0x7FFFFFFF


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """Static description of one sparse convolution's geometry."""

    name: str
    in_stride: int
    out_stride: int
    kernel_size: int
    dilation: int = 1

    @property
    def offset_scale(self) -> int:
        # offsets in units of the finer of the two tensor strides
        return min(self.in_stride, self.out_stride) * self.dilation

    @property
    def key(self) -> str:
        return map_key(self.in_stride, self.out_stride, self.kernel_size,
                       self.dilation)

    @property
    def is_identity_map(self) -> bool:
        return self.kernel_size == 1 and self.in_stride == self.out_stride


def _fold_clouds(coords: torch.Tensor) -> torch.Tensor:
    """Cloud ids folded into [0, 31) for packed keys (pads keep theirs)."""
    c = coords[:, 0]
    fc = torch.where(c >= INVALID_BATCH, c, torch.remainder(c, 31))
    return torch.cat([fc[:, None], coords[:, 1:]], dim=1)


def _index_level(coords: torch.Tensor, mask: torch.Tensor,
                 stride: int) -> LevelCoords:
    """Sorted packed keys of the valid rows of an existing level."""
    rows = torch.nonzero(mask).flatten()
    keys = pack_keys(_fold_clouds(coords[rows]), stride)
    skeys, order = torch.sort(keys, stable=True)
    return LevelCoords(coords, mask, skeys, rows[order].to(torch.int32))


def _downsample_level(coords0: torch.Tensor, stride: int, cap: int,
                      n_clouds: int) -> LevelCoords:
    """Unique coords at ``stride`` in the cloud-blocked layout of gcl_tpu's
    _downsample_level(n_clouds=...): coarse coords are the distinct values
    of floor(c / stride) * stride; cloud c's rows start at a
    _BLOCK_ALIGN-aligned base, in coarse-key order, with pads inline
    between blocks. The caller budgets cap >= total + n_clouds *
    _BLOCK_ALIGN.
    """
    dev = coords0.device
    b = coords0[:, 0:1].long()
    xyz = floordiv(coords0[:, 1:4].long(), stride) * stride
    coords = torch.cat([b, xyz], dim=1)
    # single-int packed dedup key (cloud, x/s, y/s, z/s): per-axis bits
    # cover the stride's share of the key window
    los, bits = [], []
    for half in (512, 512, 64):
        lo_c = math.floor(-half / stride)
        hi_c = math.floor((half - 1) / stride)
        los.append(lo_c)
        bits.append(max(1, (hi_c - lo_c).bit_length()))
    if 5 + sum(bits) > 31:
        raise ValueError(
            f"packed dedup key needs {5 + sum(bits)} bits > 31 "
            f"(stride={stride}, per-axis bits={bits})")
    u = floordiv(xyz, stride) - torch.tensor(los, dtype=torch.long,
                                             device=dev)
    key = coords[:, 0]
    for a in range(3):
        key = (key << bits[a]) | u[:, a]
    lim = torch.tensor([1 << bt for bt in bits], dtype=torch.long,
                       device=dev)
    ok = ((u >= 0) & (u < lim)).all(dim=1) & (coords[:, 0] < MAX_CLOUDS)
    key = torch.where(ok, key, _SEN).to(torch.int32)
    key_s, perm = torch.sort(key, stable=True)
    coords_s = coords[perm]
    first = torch.ones_like(key_s, dtype=torch.bool)
    first[1:] = key_s[1:] != key_s[:-1]
    valid = first & (key_s != _SEN)

    vcum = torch.cumsum(valid.long(), 0)
    vr = vcum - 1
    b_s = coords_s[:, 0].contiguous()  # ascending: keys are cloud-major
    ends = torch.searchsorted(
        b_s, torch.arange(n_clouds, dtype=b_s.dtype, device=dev),
        right=True)
    vcum0 = torch.cat([torch.zeros(1, dtype=torch.long, device=dev), vcum])
    prefix = vcum0[ends]
    vstart = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                        prefix[:-1]])
    counts = prefix - vstart
    sizes = -floordiv(-counts, _BLOCK_ALIGN) * _BLOCK_ALIGN
    base = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                      torch.cumsum(sizes, 0)[:-1]])
    delta = base - vstart
    blocked = vr + delta[b_s.clamp(0, n_clouds - 1)]
    keep = valid & (blocked < cap)

    out = torch.tensor([INVALID_BATCH, -1, -1, -1], dtype=torch.long,
                       device=dev).repeat(cap, 1)
    out[blocked[keep]] = coords_s[keep]
    out = out.to(torch.int32)
    out_mask = out[:, 0] != INVALID_BATCH
    return _index_level(out, out_mask, stride)


def _c1z_aux(level: LevelCoords) -> torch.Tensor:
    """Occupancy-conv aux int32[N, 8] of a stride-1 level: col 0 the row's
    own packed query key (pack_query_keys at offset 0), cols 1-3 the
    grid-shifted coords u = xyz + 2^(bits-1), -(1 << 20) on padded rows so
    every neighbour is out of range; cols 4-7 zero."""
    bx, by, bz = DEFAULT_KEY_BITS
    dev = level.coords.device
    q0 = pack_query_keys(_fold_clouds(level.coords),
                         torch.zeros(3, dtype=torch.int32, device=dev), 1)
    half = torch.tensor([1 << (bx - 1), 1 << (by - 1), 1 << (bz - 1)],
                        dtype=torch.int32, device=dev)
    u = level.coords[:, 1:4] + half
    u = torch.where(level.mask[:, None], u, -(1 << 20))
    aux = torch.zeros((level.coords.shape[0], 8), dtype=torch.int32,
                      device=dev)
    aux[:, 0] = q0
    aux[:, 1:4] = u
    return aux


def query_keys(spec: ConvSpec, out_level: LevelCoords) -> torch.Tensor:
    """int32[K, N_out] packed query keys of one forward conv geometry."""
    offsets = torch.from_numpy(kernel_offsets(spec.kernel_size)
                               * spec.offset_scale)
    return pack_query_keys(_fold_clouds(out_level.coords), offsets,
                           spec.in_stride)


def build_graph(coords: torch.Tensor, mask: torch.Tensor,
                specs: Sequence[ConvSpec], level_caps: Dict[int, int],
                n_clouds: int) -> SparseGraph:
    """All stride levels + forward conv maps of a conv plan.

    coords int32[N0, 4] / mask bool[N0] are level-0 voxels in the
    voxelize_per_cloud layout (ascending cloud blocks, each key-sorted,
    pads inline). ``n_clouds`` bounds the cloud ids; above 31 the packed
    keys' cloud fold would alias, so this raises. ``level_caps`` gives the
    capacity of every stride > 1 before the n_clouds * 256 rows of block
    slack.
    """
    if n_clouds > MAX_CLOUDS:
        raise ValueError(
            f"{n_clouds} clouds per graph: packed conv keys fold cloud ids "
            f"mod {MAX_CLOUDS} and address at most {MAX_CLOUDS} clouds")
    strides = sorted({s for sp in specs
                      for s in (sp.in_stride, sp.out_stride)})
    levels: Dict[int, LevelCoords] = {}
    for s in strides:
        if s == 1:
            levels[1] = _index_level(coords, mask, 1)
            continue
        cap = level_caps[s] + n_clouds * _BLOCK_ALIGN
        # floor(floor(x/a)/b) == floor(x/(ab)): derive each level from the
        # coarsest finer level already built
        src = max((p for p in levels if s % p == 0), default=None)
        src_coords = levels[src].coords if src is not None else coords
        levels[s] = _downsample_level(src_coords, s, cap, n_clouds)

    maps: Dict[str, ConvMap] = {}
    for sp in specs:
        if sp.is_identity_map or sp.key in maps:
            continue
        c1z = None
        if (sp.in_stride == sp.out_stride == 1 and sp.dilation == 1
                and sp.kernel_size % 2 == 1):
            c1z = _c1z_aux(levels[1])
        maps[sp.key] = ConvMap(query_keys(sp, levels[sp.out_stride]), c1z)
    return SparseGraph(levels, maps)


def default_level_caps(n_cap: int, strides: Sequence[int],
                       shrink: float = 0.5) -> Dict[int, int]:
    """Heuristic per-level capacities: LiDAR voxel counts roughly halve per
    2x stride (surfaces are ~2D). Rounded up to multiples of 8."""
    caps = {}
    for i, s in enumerate(sorted(set(strides))):
        c = n_cap if s == 1 else int(n_cap * (shrink ** i))
        caps[s] = max(8, -(-c // 8) * 8)
    return caps
