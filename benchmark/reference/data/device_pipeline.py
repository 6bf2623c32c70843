"""Per-cloud voxelization and colocation groups on the device (port of
gcl_tpu/data/device_pipeline.py: voxelize_per_cloud, the brute-force
radius_knn, the hash-grid searches and the group tables built from them).

With ``cell`` set, batch_colocation_groups runs the S = B * C searches of a
batch as one call of kernels.radius_topk.windowed_cell_topk (K1 / K11: the
CUDA kernel on the card, its plain version on the CPU) and leaves the group
slots in home-cell order; there is no other route (gcl_tpu picks between
its kernel and an XLA fallback by pallas_available()). grid_radius_knn, that
fallback's search with its per-cell truncation ``cell_cap``, is ported as
plain tensor code and serves build_colocation_groups (one sample).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.types import INVALID_BATCH, ColocationGroups, SparseBatch
from ..core.voxelize import voxelize_clouds
from .. import kernels
from ..kernels.radius_topk import SENTINEL

_FAR = 1e30  # distance / norm sentinel of masked rows, as in gcl_tpu


@dataclasses.dataclass
class VoxelizedClouds:
    """Per-cloud voxelization output, fixed per-cloud capacity.

    coords: int32[C, Nv, 4] (cloud, x, y, z); mask: bool[C, Nv];
    xyz: float32[C, Nv, 3] representative original points (zeros on pads);
    rep: int32[C, Nv], the point index of each voxel's representative
    (voxelize_per_cloud sets it; 0 on pads).
    """

    coords: torch.Tensor
    mask: torch.Tensor
    xyz: torch.Tensor
    rep: Optional[torch.Tensor] = None

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
    return VoxelizedClouds(coords, mask, xyz, rep)


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


_CELL_BITS = 10
_CELL_HALF = 1 << (_CELL_BITS - 1)
_KEY_SENTINEL = (1 << 30) - 1      # _cell_key's: stays int30 for 2 * key + 1
_OCTANT = ((0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1),
           (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1))


def _to_cell(x: torch.Tensor) -> torch.Tensor:
    """floor(x) as int32 cell coords. A masked row arrives as +-1e30: XLA's
    cast saturates, a CPU cast in torch gives INT_MIN and a CUDA cast
    saturates, and the ``+ _CELL_HALF`` that follows may wrap. Clamping to
    +-2^30 first gives one answer everywhere: far outside the +-2^9 grid,
    so the row gets the sentinel key either way."""
    lim = float(1 << 30)
    return torch.floor(x).clamp(-lim, lim).to(torch.int32)


def _pack_cell(u: torch.Tensor) -> torch.Tensor:
    return ((u[..., 0] << (2 * _CELL_BITS)) | (u[..., 1] << _CELL_BITS)
            | u[..., 2])


def _cell_key(cxyz: torch.Tensor, valid: torch.Tensor):
    """Pack integer cell coords [..., 3] into one int30 key (< 2^30).
    Returns (key, ok); rows that are invalid or outside the +-2^9 cell
    range get the max key (1 << 30) - 1 and ok = False."""
    u = cxyz + _CELL_HALF
    ok = valid & ((u >= 0) & (u < 2 * _CELL_HALF)).all(dim=-1)
    return torch.where(ok, _pack_cell(u), _KEY_SENTINEL), ok


def _midpoint_step(xyz, mask, cell):
    """Masked query positions (-1e30 fill), their home cells and, per axis,
    the side (+1 / -1) of the cell midpoint they lie on. Queries are
    binned by a float32 multiply with 1 / cell, targets (and the centre
    voxels' home keys) by a divide: gcl_tpu's two roundings, kept apart."""
    qx = torch.where(mask[..., None], xyz, -_FAR)
    qc = qx * float(np.float32(1.0 / cell))
    qcell = _to_cell(qc)
    step = torch.where(qc - qcell >= 0.5, 1, -1).to(torch.int32)
    return qx, qcell, step


def _octant_base(xyz: torch.Tensor, mask: torch.Tensor, cell):
    """Masked query positions and the MIN-CORNER key of each query's 2x2x2
    probe block: the home cell plus, per axis, the neighbour on the side of
    the cell midpoint is the unit block at qcell + min(step, 0). Queries
    whose block cannot pack injectively (invalid, or within one cell of
    the +-2^9 grid edge) get 0x7FFFFFFF: they then key-match only invalid
    targets, whose 1e30 coordinates never pass the radius test."""
    qx, qcell, step = _midpoint_step(xyz, mask, cell)
    ub = qcell + step.clamp_max(0) + _CELL_HALF
    ok = mask & ((ub >= 0) & (ub + 1 < 2 * _CELL_HALF)).all(dim=-1)
    return qx, torch.where(ok, _pack_cell(ub), SENTINEL)


def _octant_probes(xyz: torch.Tensor, mask: torch.Tensor, cell):
    """Masked query positions and their 8 probe keys (qx [..., 3], probes
    int32[..., 8], ok bool[..., 8]): a sphere of radius <= cell / 2 meets at
    most 2 cells per axis, the home cell and the neighbour on the side of
    the cell midpoint."""
    qx, qcell, step = _midpoint_step(xyz, mask, cell)
    octant = torch.tensor(_OCTANT, dtype=torch.int32, device=xyz.device)
    probe_cells = qcell[..., None, :] + step[..., None, :] * octant
    probes, ok = _cell_key(probe_cells, mask[..., None])
    return qx, probes, ok


def _target_keys(targets, t_mask, cell):
    """(key, ok, xyz with 1e30 on rows that are not ok) of search targets."""
    tkey, t_ok = _cell_key(_to_cell(
        torch.where(t_mask[..., None], targets, _FAR) / cell), t_mask)
    return tkey, t_ok, torch.where(t_ok[..., None], targets, _FAR)


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b|^2 over the last axis, summed as (dx^2 + dy^2) + dz^2."""
    dx, dy, dz = (a - b).unbind(dim=-1)
    return (dx * dx + dy * dy) + dz * dz


def grid_radius_knn(queries: torch.Tensor, q_mask: torch.Tensor,
                    targets: torch.Tensor, t_mask: torch.Tensor, radius,
                    k: int, cell: float, cell_cap: int = 8
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """radius_knn over a sorted hash grid, plain tensor code.

    Targets are binned into cells of size ``cell`` (the radius is clamped
    to cell / 2) and sorted by cell key; each query probes its 8-cell
    octant; per probe the candidates are the first ``cell_cap`` targets of
    that cell's run in the sorted order; exact distances to the
    8 * cell_cap candidates, then the k smallest. Exact up to that per-cell
    truncation. queries f32[Q, 3], targets f32[T, 3]. Returns (idx
    int32[Q, k], hit bool[Q, k]); idx is meaningful only where hit.
    """
    qn, tn = queries.shape[0], targets.shape[0]
    r = torch.as_tensor(radius, dtype=torch.float32,
                        device=queries.device).clamp_max(cell * 0.5)
    tkey, _, tx = _target_keys(targets, t_mask, cell)
    qx, qkey, _ = _octant_probes(queries, q_mask, cell)          # [Q, 8]
    # gcl_tpu merges targets and probes in one sort and counts the targets
    # before each probe; a stable sort of the targets and a left
    # searchsorted of the probes give the same order and the same starts
    tkey_s, tsorted = torch.sort(tkey, stable=True)
    qstart = torch.searchsorted(tkey_s, qkey.contiguous())       # run starts
    txyz_s = tx[tsorted]
    cpos = qstart[:, :, None] + torch.arange(cell_cap, device=queries.device)
    in_arr = cpos < tn
    cposc = cpos.clamp_max(tn - 1)
    same_cell = tkey_s[cposc] == qkey[:, :, None]
    d2 = _sq_dist(qx[:, None, None, :], txyz_s[cposc])
    d2 = torch.where(in_arr & same_cell, d2, _FAR)
    ci, d2k = _smallest_k(d2.reshape(qn, 8 * cell_cap), k)
    idx = tsorted[torch.gather(cposc.reshape(qn, 8 * cell_cap), 1, ci)]
    hit = (d2k <= r * r) & q_mask[:, None]
    return idx.to(torch.int32), hit


def _knn_single(queries, q_mask, targets, t_mask, radius, k, chunk, cell,
                cell_cap):
    """One search: queries [Q, 3] against targets [T, 3], on the grid
    (grid_radius_knn, the first ``cell_cap`` targets of a cell) with
    ``cell`` set, else brute force."""
    if cell is not None:
        return grid_radius_knn(queries, q_mask, targets, t_mask, radius, k,
                               cell, cell_cap)
    return radius_knn(queries, q_mask, targets, t_mask, radius, k, chunk)


def _knn(queries, q_mask, targets, t_mask, radius, k, chunk, cell, cell_cap):
    """One sample's searches: queries [Q, 3] against targets [C, T, 3]."""
    if cell is None:
        return radius_knn(queries, q_mask, targets, t_mask, radius, k, chunk)
    per = [grid_radius_knn(queries, q_mask, targets[c], t_mask[c], radius, k,
                           cell, cell_cap) for c in range(targets.shape[0])]
    return (torch.stack([i for i, _ in per]),
            torch.stack([h for _, h in per]))


def _batched_grid_core(queries, q_mask, targets, t_mask, r, k, cell,
                       presorted: bool):
    """The kernel side of the batched grid search: (rows, d2, qperm) of
    windowed_cell_topk over S searches (queries [S, Q, 3], targets
    [S, T, 3], r f32[S]).

    With presorted=False the queries are sorted by the key of their probe
    block here and the results come back in that SORTED order with the
    permutation. With presorted=True the queries must already be about
    monotone in home-cell key; the results keep the given order and qperm
    is None.
    """
    s_n, q_n, _ = queries.shape
    # invalid targets carry the kernel's sentinel 0x7FFFFFFF, not
    # _cell_key's int30 one: no probe block's key can reach them
    tkey, t_ok, tx = _target_keys(targets, t_mask, cell)
    tkey = torch.where(t_ok, tkey, SENTINEL)
    tkey_s, trow_s = torch.sort(tkey, dim=1, stable=True)
    txyz_s = torch.gather(tx, 1, trow_s[..., None].expand(-1, -1, 3))
    qx, pbase = _octant_base(queries, q_mask, cell)              # [S, Q]
    qperm = None
    if not presorted:
        pbase, qperm = torch.sort(pbase, dim=1, stable=True)
        qx = torch.gather(qx, 1, qperm[..., None].expand(-1, -1, 3))
    rows, d2 = kernels.windowed_cell_topk(
        tkey_s.contiguous(), trow_s.to(torch.int32).contiguous(),
        txyz_s.contiguous(), pbase.contiguous(), qx.contiguous(),
        (r * r).contiguous(), k)
    return rows, d2, qperm


def batched_grid_radius_knn(queries: torch.Tensor, q_mask: torch.Tensor,
                            targets: torch.Tensor, t_mask: torch.Tensor,
                            radius: torch.Tensor, k: int, cell: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched grid search on the windowed top-k kernel: queries
    f32[S, Q, 3], targets f32[S, T, 3], radius f32[S] (clamped to
    cell / 2). Returns (idx int32[S, Q, k], hit bool[S, Q, k]) in the given
    query order."""
    r = radius.to(torch.float32).clamp_max(cell * 0.5)
    rows_s, d2_s, qperm = _batched_grid_core(queries, q_mask, targets, t_mask,
                                             r, k, cell, presorted=False)
    where = qperm[..., None].expand(-1, -1, k)
    rows = torch.zeros_like(rows_s).scatter_(1, where, rows_s)
    d2 = torch.full_like(d2_s, _FAR).scatter_(1, where, d2_s)
    hit = (d2 <= (r * r)[:, None, None]) & (rows >= 0) & q_mask[..., None]
    return rows.clamp_min(0), hit


def _assemble_groups(vox: VoxelizedClouds, idx: torch.Tensor,
                     hit: torch.Tensor,
                     qperm: Optional[torch.Tensor] = None
                     ) -> ColocationGroups:
    """Group tables of one sample from its per-cloud searches (idx / hit
    [C, Q, k]; cloud 0 is the centre). Member rows are c * Nv + i.

    With ``qperm``, query q is centre voxel row qperm[q] (the searches ran
    over home-cell-sorted queries) and the group SLOTS come out in that
    order; member rows are target rows and do not move."""
    c, nv, _ = vox.xyz.shape
    k = idx.shape[-1]
    dev = idx.device
    own_norms = torch.sqrt((vox.xyz * vox.xyz).sum(dim=-1))  # to own LiDAR
    own_norms = torch.where(vox.mask, own_norms, _FAR)
    center_mask, center_norm = vox.mask[0], own_norms[0]
    anchor = vox.coords[0, :, 1:4]
    if qperm is not None:
        center_mask, center_norm = center_mask[qperm], center_norm[qperm]
        anchor = anchor[qperm]

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
    cand[:, 0] = torch.where(center_mask, center_norm, _FAR)
    finest_pos = torch.argmin(cand, dim=1).to(torch.int32) * k

    valid = center_mask & hit[1:].any(dim=2).any(dim=0)
    return ColocationGroups(
        member_idx=member_idx, member_mask=ghit & valid[:, None],
        finest_pos=finest_pos, valid=valid,
        anchor_xyz=anchor.to(torch.float32),
        anchor_item=torch.zeros(nv, dtype=torch.int32, device=dev))


def _aligned(xyz: torch.Tensor, transforms: torch.Tensor) -> torch.Tensor:
    """xyz [..., Nv, 3] under transforms [..., 4, 4], one per cloud."""
    return (xyz @ transforms[..., :3, :3].transpose(-1, -2)
            + transforms[..., None, :3, 3])


def build_colocation_groups(vox: VoxelizedClouds, transforms: torch.Tensor,
                            search_radius, k: int = 5, chunk: int = 512,
                            cell: Optional[float] = None,
                            cell_cap: int = 8) -> ColocationGroups:
    """Colocation groups of one sample of C clouds (cloud 0 the centre).

    transforms f32[C, 4, 4] map each cloud into the centre frame. For each
    centre voxel, the k nearest voxels within ``search_radius`` in the
    centre cloud itself and in every aligned neighbour cloud form one
    group; groups with no cross-cloud hit are invalid. ``cell`` selects
    grid_radius_knn (the first ``cell_cap`` targets of a cell compete)
    over the brute-force search.
    """
    idx, hit = _knn(vox.xyz[0], vox.mask[0], _aligned(vox.xyz, transforms),
                    vox.mask, search_radius, k, chunk, cell, cell_cap)
    return _assemble_groups(vox, idx, hit)


def _grid_searches(vox_b: VoxelizedClouds, transforms_b, radius_b, k, cell):
    """The S = B * C searches of a batch in one windowed_cell_topk call:
    (idx [B, C, Nv, k], hit, qperm [B, Nv]). All C searches of a sample
    share its centre voxels as queries, sorted once per sample by home-cell
    key (a stable sort, so qperm is gcl_tpu's)."""
    b, c, nv, _ = vox_b.xyz.shape
    center, cmask = vox_b.xyz[:, 0], vox_b.mask[:, 0]
    home, _ = _cell_key(_to_cell(
        torch.where(cmask[..., None], center, -_FAR) / cell), cmask)
    qperm = torch.sort(home, dim=1, stable=True)[1]              # [B, Nv]
    q_sorted = torch.gather(center, 1, qperm[..., None].expand(-1, -1, 3))
    m_sorted = torch.gather(cmask, 1, qperm)
    queries = q_sorted[:, None].expand(b, c, nv, 3).reshape(b * c, nv, 3)
    q_mask = m_sorted[:, None].expand(b, c, nv).reshape(b * c, nv)
    r_s = radius_b.clamp_max(cell * 0.5).repeat_interleave(c)
    rows, d2, _ = _batched_grid_core(
        queries, q_mask, _aligned(vox_b.xyz, transforms_b).reshape(
            b * c, nv, 3), vox_b.mask.reshape(b * c, nv), r_s, k, cell,
        presorted=True)
    # d2 is the kernel's (dequantized while T <= 2^19): hit as gcl_tpu has it
    hit = (d2 <= (r_s * r_s)[:, None, None]) & (rows >= 0) & q_mask[..., None]
    return (rows.clamp_min(0).reshape(b, c, nv, k),
            hit.reshape(b, c, nv, k), qperm)


def batch_colocation_groups(vox_b: VoxelizedClouds,
                            transforms_b: torch.Tensor, search_radius,
                            k: int = 5, chunk: int = 512,
                            cell: Optional[float] = None) -> ColocationGroups:
    """Groups of a batch: vox_b fields carry a leading sample dim
    [B, C, Nv, ...]; member rows index the flattened [B * C * Nv] voxel
    array and anchor_item is the sample. ``search_radius`` is a scalar or
    a per-sample f32[B].

    ``cell`` (>= twice the largest radius; a larger radius is clamped to
    cell / 2) selects the hash-grid search through windowed_cell_topk, one
    call for the whole batch; the group slots of a sample then come out in
    home-cell order, not row order. The kernel sees every target of a cell:
    there is no ``cell_cap`` here (grid_radius_knn's truncation, which
    build_colocation_groups keeps)."""
    b, c, nv, _ = vox_b.xyz.shape
    dev = vox_b.xyz.device
    radius_b = torch.broadcast_to(torch.as_tensor(
        search_radius, dtype=torch.float32, device=dev), (b,))

    def sample(i):
        return VoxelizedClouds(vox_b.coords[i], vox_b.mask[i], vox_b.xyz[i])

    if cell is not None:
        idx, hit, qperm = _grid_searches(vox_b, transforms_b, radius_b, k,
                                         cell)
        per = [_assemble_groups(sample(i), idx[i], hit[i], qperm[i])
               for i in range(b)]
    else:
        per = [build_colocation_groups(sample(i), transforms_b[i],
                                       radius_b[i], k, chunk)
               for i in range(b)]
    sample_id = torch.arange(b, dtype=torch.int32, device=dev)
    member_idx = torch.stack([g.member_idx for g in per])    # [B, Nv, Kc]
    member_idx = torch.where(member_idx >= 0,
                             member_idx + (sample_id * (c * nv))[:, None,
                                                                 None],
                             -1)
    return ColocationGroups(
        member_idx=member_idx.reshape(b * nv, c * k),
        member_mask=torch.stack([g.member_mask for g in per]).reshape(
            b * nv, c * k),
        finest_pos=torch.cat([g.finest_pos for g in per]),
        valid=torch.cat([g.valid for g in per]),
        anchor_xyz=torch.cat([g.anchor_xyz for g in per]),
        anchor_item=sample_id.repeat_interleave(nv))


def build_correspondences(xyz0: torch.Tensor, mask0: torch.Tensor,
                          xyz1: torch.Tensor, mask1: torch.Tensor,
                          trans: torch.Tensor, search_radius, k: int = 8,
                          chunk: int = 512, cell: Optional[float] = None,
                          cell_cap: int = 8
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ground-truth correspondences of one pair: every voxel of cloud 1
    within ``search_radius`` of each voxel of cloud 0 moved by ``trans``
    (cloud 0 -> cloud 1), the k nearest at most.

    xyz0 f32[N0, 3], xyz1 f32[N1, 3], trans f32[4, 4]. ``cell`` selects
    grid_radius_knn (the first ``cell_cap`` targets of a cell compete) over
    the brute-force search. Returns (pairs int32[N0 * k, 2] of (i0, i1),
    mask bool[N0 * k]); a pair outside the mask is meaningless.
    """
    src = transform_points(xyz0, trans)
    idx, hit = _knn_single(src, mask0, xyz1, mask1, search_radius, k, chunk,
                           cell, cell_cap)
    n0 = xyz0.shape[0]
    i0 = torch.arange(n0, dtype=torch.int32,
                      device=xyz0.device).repeat_interleave(k)
    return torch.stack([i0, idx.reshape(-1)], dim=1), hit.reshape(-1)
