"""Stride levels + kernel maps, implicit and explicit (port of
gcl_tpu/core/kernel_maps.py; the sort-join maps are not ported).

For each stride level the port keeps the level's coords and mask exactly
as gcl_tpu lays them out, in one of its two layouts: cloud-blocked
(256-row-aligned cloud bases, pads inline) up to 31 clouds, one globally
compacted run in (hi, lo) key order above.

Two routes give a conv its map, as in gcl_tpu:

* implicit (up to 31 clouds, odd kernels): the level carries the sorted
  packed keys of its valid rows (``skeys``) and their rows (``srow``); a
  geometry carries the query keys ``qkey[k, i] =
  pack_query_keys(fold(out_coords[i]), offset_k * offset_scale,
  in_stride)``, exactly what gcl_tpu's _build_fused_maps computes, and the
  conv kernels resolve them by binary search (the TPU's window tables have
  no counterpart here). Every geometry also gets its reverse-direction
  twin (``ConvMap.rqkey``), which the backward walks;
* explicit (more than 31 clouds, where the packed keys' cloud fold would
  alias; an even kernel, which has no twin; or on request): the level
  carries its sorted two-word keys (``key_hi``, ``key_lo``, ``perm``) and
  a geometry an index table ``kmaps[key][k, i]`` = the input level's row
  at out_coords[i] + offset_k, or -1, built by the join kernel K10
  (kernels.join_kmap). Odd kernels get their twin's table too.

One departure from gcl_tpu, on the explicit route only: coord_keys clamps
a coordinate to the +-512 window, so gcl_tpu's two-word query one step
outside the window finds the face voxel itself. Here such a query carries
the sentinel and finds nothing, as on the implicit route (where the packed
keys put it out of range) and in gcl_tpu's sort-join maps.

Transpose-conv parity note (as in gcl_tpu): the map gathers
in[f + d'·s·dil] @ W'[d'], so a MinkowskiEngine weight W maps to
W'[d'] = W[-d'].
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..kernels.join_kmap import join_kmap
from ..utils.spans import span
from .coords import (DEFAULT_KEY_BITS, GRID_HALF, GRID_SIZE, coord_keys,
                     floordiv, kernel_offsets, pack_keys, pack_query_keys,
                     sort_by_keys)
from .types import (INVALID_BATCH, ConvMap, LevelCoords, SparseGraph,
                    map_key)

# Packed keys fold cloud ids mod 31 (PAD_CLOUD = 31 is reserved), which is
# injective only up to 31 clouds per graph: the implicit route's limit.
MAX_CLOUDS = 31
METHODS = ("auto", "implicit", "explicit")
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


def _packed_index(level: LevelCoords, stride: int) -> None:
    """Give a level the implicit route's index: the sorted packed keys of
    its valid rows and their rows."""
    rows = torch.nonzero(level.mask).flatten()
    keys = pack_keys(_fold_clouds(level.coords[rows]), stride)
    level.skeys, order = torch.sort(keys, stable=True)
    level.srow = rows[order].to(torch.int32)


def _two_word_index(level: LevelCoords, stride: int) -> None:
    """Give a level the explicit route's index (gcl_tpu's
    _index_level_sorted, at any stride): both layouts keep the valid rows
    in (hi, lo) key order, so the sorted view is the valid rows compacted
    to the front; the tail carries the sentinel key and the last row."""
    n = level.coords.shape[0]
    rows = torch.nonzero(level.mask).flatten()
    hi, lo = coord_keys(level.coords[rows], stride)
    dev = level.coords.device
    level.key_hi = torch.full((n,), _SEN, dtype=torch.int32, device=dev)
    level.key_lo = torch.full((n,), _SEN, dtype=torch.int32, device=dev)
    level.perm = torch.full((n,), n - 1, dtype=torch.int32, device=dev)
    level.key_hi[:rows.shape[0]] = hi
    level.key_lo[:rows.shape[0]] = lo
    level.perm[:rows.shape[0]] = rows.to(torch.int32)


def _downsample_level(coords0: torch.Tensor, stride: int, cap: int,
                      n_clouds: Optional[int]) -> LevelCoords:
    """Unique coords at ``stride``: the distinct values of floor(c /
    stride) * stride, in gcl_tpu's _downsample_level layouts.

    With ``n_clouds`` (at most 31) the rows are cloud-blocked: cloud c's
    rows start at a _BLOCK_ALIGN-aligned base, in coarse-key order, with
    pads inline between blocks; the caller budgets cap >= total + n_clouds
    * _BLOCK_ALIGN. With None they are one run in (hi, lo) key order,
    compacted to the front (a two-key sort; any number of clouds).
    """
    dev = coords0.device
    b = coords0[:, 0:1].long()
    xyz = floordiv(coords0[:, 1:4].long(), stride) * stride
    coords = torch.cat([b, xyz], dim=1)
    pad_row = torch.tensor([INVALID_BATCH, -1, -1, -1], dtype=torch.long,
                           device=dev)
    if n_clouds is None:
        hi, lo = coord_keys(coords, stride)
        hi_s, lo_s, coords_s = sort_by_keys(hi, lo, coords)
        first = torch.ones_like(hi_s, dtype=torch.bool)
        first[1:] = (hi_s[1:] != hi_s[:-1]) | (lo_s[1:] != lo_s[:-1])
        valid = first & (coords_s[:, 0] != INVALID_BATCH)
        slot = torch.cumsum(valid.long(), 0) - 1
        keep = valid & (slot < cap)
        out = pad_row.repeat(cap, 1)
        out[slot[keep]] = coords_s[keep]
        out = out.to(torch.int32)
        return LevelCoords(out, out[:, 0] != INVALID_BATCH)

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

    out = pad_row.repeat(cap, 1)
    out[blocked[keep]] = coords_s[keep]
    out = out.to(torch.int32)
    return LevelCoords(out, out[:, 0] != INVALID_BATCH)


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


def two_word_query_keys(out_level: LevelCoords, in_stride: int,
                        offsets) -> Tuple[torch.Tensor, torch.Tensor]:
    """(qhi, qlo) int32[K, N_out]: coord_keys of out_coords + offset_k at
    ``in_stride`` (gcl_tpu's _query_keys). Padded rows, queries off the
    input lattice and -- the departure named in the module's note --
    queries outside the +-512 key window carry the sentinel 0x7FFFFFFF on
    both words. int32 arithmetic throughout: [K, N_out] is the largest
    tensor of the graph build."""
    oc = out_level.coords
    off = torch.as_tensor(offsets, dtype=torch.int32, device=oc.device)
    ok = (oc[:, 0] < INVALID_BATCH)[None, :]
    u = []
    for a in range(3):
        q = oc[None, :, 1 + a] + off[:, a:a + 1]               # [K, N_out]
        if in_stride > 1:
            ok = ok & (torch.remainder(q, in_stride) == 0)
            q = floordiv(q, in_stride)
        ok = ok & (q >= -GRID_HALF) & (q < GRID_HALF)
        u.append(q + GRID_HALF)
    qhi = oc[None, :, 0] * GRID_SIZE + u[0]
    qlo = u[1] * GRID_SIZE + u[2]
    return torch.where(ok, qhi, _SEN), torch.where(ok, qlo, _SEN)


def build_kmap(spec: ConvSpec, levels: Dict[int, LevelCoords]
               ) -> torch.Tensor:
    """int32[K, N_out] index table of one conv geometry: the input level's
    row at out_coords[i] + offset_k, -1 where there is none (gcl_tpu's
    _build_kmap_pallas: query keys, then the join K10)."""
    offsets = kernel_offsets(spec.kernel_size) * spec.offset_scale
    lv_in = levels[spec.in_stride]
    qhi, qlo = two_word_query_keys(levels[spec.out_stride], spec.in_stride,
                                   offsets)
    return join_kmap(lv_in.key_hi, lv_in.key_lo, lv_in.perm, qhi, qlo)


def graph_route(method: str, n_clouds: int) -> str:
    """'implicit' or 'explicit': the route ``method`` takes for a graph of
    ``n_clouds`` clouds (odd kernels; an even kernel is always explicit)."""
    if method not in METHODS:
        raise ValueError(f"method {method!r}: one of {METHODS}")
    if method == "implicit" and n_clouds > MAX_CLOUDS:
        raise ValueError(
            f"{n_clouds} clouds per graph: packed conv keys fold cloud ids "
            f"mod {MAX_CLOUDS} and address at most {MAX_CLOUDS} clouds "
            f"(method 'auto' or 'explicit' builds index tables instead)")
    if method == "auto":
        return "implicit" if n_clouds <= MAX_CLOUDS else "explicit"
    return method


def build_graph(coords: torch.Tensor, mask: torch.Tensor,
                specs: Sequence[ConvSpec], level_caps: Dict[int, int],
                n_clouds: int, method: str = "auto") -> SparseGraph:
    """All stride levels + conv maps (with reverse twins) of a conv plan.

    coords int32[N0, 4] / mask bool[N0] are level-0 voxels in the
    voxelize_per_cloud layout (ascending cloud blocks, each key-sorted,
    pads inline). ``n_clouds`` bounds the cloud ids. ``method``: 'auto'
    (implicit maps up to 31 clouds, explicit index tables above, as
    gcl_tpu's 'auto' on a TPU), 'implicit' (gcl_tpu's 'fused'; raises
    above 31 clouds) or 'explicit' (gcl_tpu's 'pallas'). An even kernel
    gets an explicit table on every route. Up to 31 clouds the levels are
    cloud-blocked whatever the route (gcl_tpu's layout under 'auto' and
    'fused'), and ``level_caps`` gives the capacity of every stride > 1
    before the n_clouds * 256 rows of block slack; above 31 they are one
    compacted run of ``level_caps[s]`` rows.

    Three spans (utils.spans) name its phases in a profiler trace:
    ``graph/levels`` (the stride levels), ``graph/index`` (each level's
    sorted keys) and ``graph/maps`` (query keys, occupancy aux, reverse
    twins, index tables).
    """
    route = graph_route(method, n_clouds)
    blocked = n_clouds <= MAX_CLOUDS
    strides = sorted({s for sp in specs
                      for s in (sp.in_stride, sp.out_stride)})
    levels: Dict[int, LevelCoords] = {}
    with span("graph/levels"):
        for s in strides:
            if s == 1:
                levels[1] = LevelCoords(coords, mask)
                continue
            cap = level_caps[s] + (n_clouds * _BLOCK_ALIGN if blocked else 0)
            # floor(floor(x/a)/b) == floor(x/(ab)): derive each level from
            # the coarsest finer level already built
            src = max((p for p in levels if s % p == 0), default=None)
            src_coords = levels[src].coords if src is not None else coords
            levels[s] = _downsample_level(src_coords, s, cap,
                                          n_clouds if blocked else None)

    # every odd-kernel map also gets its reverse twin; for the ResUNet
    # family this adds nothing (a same-level map is its own twin and each
    # strided conv's twin is its transposed conv's map)
    uniq: Dict[str, ConvSpec] = {}
    for sp in specs:
        want = [sp]
        if sp.kernel_size % 2 == 1:
            want.append(dataclasses.replace(
                sp, name=sp.name + "_rev", in_stride=sp.out_stride,
                out_stride=sp.in_stride))
        for w in want:
            if not w.is_identity_map:
                uniq.setdefault(w.key, w)
    # an even kernel's offsets are not symmetric, so it has no twin for
    # the implicit backward: it takes a table on either route
    implicit = [sp for sp in uniq.values()
                if route == "implicit" and sp.kernel_size % 2 == 1]
    explicit = [sp for sp in uniq.values() if sp not in implicit]
    with span("graph/index"):
        for s, lv in levels.items():
            if implicit:
                _packed_index(lv, s)
            if any(s == sp.in_stride for sp in explicit):
                _two_word_index(lv, s)

    maps: Dict[str, ConvMap] = {}
    with span("graph/maps"):
        for sp in implicit:
            c1z = None
            if sp.in_stride == sp.out_stride == 1 and sp.dilation == 1:
                c1z = _c1z_aux(levels[1])
            maps[sp.key] = ConvMap(query_keys(sp, levels[sp.out_stride]),
                                   c1z)
        for sp in implicit:
            maps[sp.key].rqkey = maps[map_key(
                sp.out_stride, sp.in_stride, sp.kernel_size,
                sp.dilation)].qkey
        kmaps = {sp.key: build_kmap(sp, levels) for sp in explicit}
    return SparseGraph(levels, maps, kmaps)


def default_level_caps(n_cap: int, strides: Sequence[int],
                       shrink: float = 0.5) -> Dict[int, int]:
    """Heuristic per-level capacities: LiDAR voxel counts roughly halve per
    2x stride (surfaces are ~2D). Rounded up to multiples of 8."""
    caps = {}
    for i, s in enumerate(sorted(set(strides))):
        c = n_cap if s == 1 else int(n_cap * (shrink ** i))
        caps[s] = max(8, -(-c // 8) * 8)
    return caps
