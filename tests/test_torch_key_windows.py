"""Soundness of the key windows that K10 (the join), K2 (the occupancy
conv), K4 / K5 (the scalar conv, bounded by their flagged rows), K9 (its
dX, on the windows of every row) and K1 (the grid group search) search
in: every key that the plain version
resolves lies inside its tile's window from the window table, at scale
and on the adversarial cases (ROADMAP Queue 3: test every window or bound
at scale).

The tables are plain torch, so they are checked here on the CPU. The
kernels work out the same windows block by block and run only on the
card: tests/test_torch_kernels_cuda.py holds them to their plain versions
on the same cases, and the keys they stage to the tables' sums.
"""
import numpy as np
import pytest
import torch

from gcl_tpu_torch.core.coords import searchsorted2
from gcl_tpu_torch.core.types import INVALID_BATCH
from gcl_tpu_torch.kernels import (join_kmap, join_kmap_plain, join_windows,
                                   occupancy_conv_fwd,
                                   occupancy_conv_fwd_plain,
                                   occupancy_windows, scalar_conv_dw,
                                   scalar_conv_dw_plain, scalar_conv_fwd,
                                   scalar_conv_fwd_plain, topk_windows,
                                   windowed_cell_topk,
                                   windowed_cell_topk_plain)
from gcl_tpu_torch.kernels.join_kmap import TILE, num_offset_groups
from gcl_tpu_torch.kernels.occupancy_conv import TILE as OCC_TILE
from gcl_tpu_torch.kernels.occupancy_conv import neighbor_rows
from gcl_tpu_torch.kernels.radius_topk import CHUNK as TOPK_CHUNK
from gcl_tpu_torch.kernels.radius_topk import RUNS
from gcl_tpu_torch.kernels.radius_topk import TILE as TOPK_TILE

from _torch_parity import (JOIN_WINDOW_CASES, OCC_WINDOW_CASES,
                           TOPK_WINDOW_CASES, join_window_geometries,
                           occupancy_window_inputs, scalar_window_inputs,
                           topk_window_inputs)

SEN = 0x7FFFFFFF


def _tile_any(v: torch.Tensor, tile: int) -> torch.Tensor:
    """[..., N] bool -> [..., ceil(N / tile)]: any per tile."""
    pad = -v.shape[-1] % tile
    v = torch.cat([v, v.new_zeros((*v.shape[:-1], pad))], -1)
    return v.reshape(*v.shape[:-1], -1, tile).any(-1)


@pytest.mark.parametrize("case", JOIN_WINDOW_CASES)
def test_join_windows_hold_every_match(case):
    """Every geometry of the case: every query that finds a row finds it
    at a position inside its (offset group, tile) window; a tile whose
    group has no valid query has an empty window. The cases between them
    hold tiles without a valid query and tiles over several x-slabs."""
    empty = straddle = 0
    for key, (kh, kl, perm), (qhi, qlo), oc, s_in, offs in \
            join_window_geometries(case):
        win = join_windows(kh, kl, qhi, qlo)
        k_all, n_out = qhi.shape
        grp = num_offset_groups(k_all)
        kg = k_all // grp
        assert win.shape == (2, grp, -(-n_out // TILE)), key
        kmap = join_kmap_plain(kh, kl, perm, qhi, qlo)
        k, i = torch.nonzero(kmap >= 0, as_tuple=True)
        assert len(k) > 0, key
        pos = searchsorted2(kh, kl, qhi[k, i], qlo[k, i])
        start, length = win[0][k // kg, i // TILE], win[1][k // kg, i // TILE]
        assert bool(((pos >= start) & (pos < start + length)).all()), key
        valid = _tile_any((qhi != SEN).reshape(grp, kg, n_out).any(1), TILE)
        assert bool((win[1][~valid] == 0).all()), key
        assert bool((win[1] <= kh.shape[0]).all()), key
        empty += int((~valid).sum())
        live, x, big = oc[:, 0] < INVALID_BATCH, oc[:, 1].long(), 1 << 20
        pad = x.new_full((-x.shape[0] % TILE,), big)
        lo = torch.cat([torch.where(live, x, big), pad]).reshape(-1, TILE)
        hi = torch.cat([torch.where(live, x, -big), -pad]).reshape(-1, TILE)
        straddle += int((hi.amax(1) > lo.amin(1)).sum())
    assert straddle > 0, "no tile spans several x-slabs"
    if case in ("blocked_28", "faces", "upmap_scale"):
        assert empty > 0, "no tile without a valid query"


def test_join_windows_group_offsets_by_dx():
    """A cubic table's offsets fall into one group per dx (side^2 offsets
    each, kernel_offsets order), so a tile's window per group spans the
    keys of one x-slab; any other table is one group."""
    assert [num_offset_groups(k) for k in (1, 8, 27, 125, 343, 2, 26)] \
        == [1, 2, 3, 5, 7, 1, 1]
    (key, (kh, kl, perm), (qhi, qlo), *_), *_ = join_window_geometries(
        "faces")
    win = join_windows(kh, kl, qhi, qlo)
    one = join_windows(kh, kl, qhi[:26], qlo[:26])
    assert one.shape[1] == 1 and win.shape[1] == num_offset_groups(
        qhi.shape[0]) > 1
    # the group of offsets 0..side^2 - 1 spans no more than all 26 offsets
    assert bool((win[1][0] <= one[1][0]).all()), key


def test_join_windows_change_nothing_on_the_cpu():
    """On the CPU the join takes its plain version, which searches the
    whole level: the keys staged at a time change nothing."""
    for key, (kh, kl, perm), (qhi, qlo), *_ in join_window_geometries(
            "faces"):
        assert torch.equal(join_kmap(kh, kl, perm, qhi, qlo, chunk=6),
                           join_kmap_plain(kh, kl, perm, qhi, qlo)), key


@pytest.mark.parametrize("side", [3, 5])
@pytest.mark.parametrize("case", OCC_WINDOW_CASES)
def test_occupancy_windows_hold_every_neighbour(case, side):
    """Every present neighbour (row i, offset (dx, dy, dz)) that the plain
    version finds lies inside the window of i's tile at dx: in its
    negative-key run if its key is negative, else in the non-negative run.
    The negative run lies before the non-negative one, so the two staged
    one after the other stay sorted; a tile with no row that can have a
    neighbour (pads only) has empty windows."""
    aux, skeys, coords = occupancy_window_inputs(case, side)
    n, nk, tile = aux.shape[0], skeys.shape[0], OCC_TILE
    win = occupancy_windows(aux, skeys, side)
    n_tiles = -(-n // tile)
    assert win.shape == (2, side, n_tiles, 2)
    pos = neighbor_rows(aux, skeys, torch.arange(nk, dtype=torch.int32),
                        side)
    i, k = torch.nonzero(pos >= 0, as_tuple=True)
    assert len(i) > 0
    p = pos[i, k].long()
    half = (skeys[p] >= 0).long()
    g, t = k // (side * side), i // tile
    start, length = win[0][g, t, half], win[1][g, t, half]
    assert bool(((p >= start) & (p < start + length)).all())
    s, ln = win[0].long(), win[1].long()
    assert bool((ln >= 0).all() and (s + ln <= nk).all())
    both = (ln[..., 0] > 0) & (ln[..., 1] > 0)
    assert bool((s[..., 0] + ln[..., 0] <= s[..., 1])[both].all())
    assert bool((skeys[s[..., 0][ln[..., 0] > 0]] < 0).all())
    assert bool((skeys[s[..., 1][ln[..., 1] > 0]] >= 0).all())
    live = _tile_any(aux[:, 1] > -(1 << 19), tile)
    assert bool((win[1][:, ~live] == 0).all())
    if case.startswith("clouds_"):
        # tiles that mix clouds, one with clouds 15 and 16 (keys of both
        # signs), both runs non-empty there
        cloud = torch.where(coords[:, 0] < INVALID_BATCH, coords[:, 0], -1)
        pad = -n % tile
        c = torch.cat([cloud, cloud.new_full((pad,), -1)]).reshape(-1, tile)
        has = lambda v: (c == v).any(1)
        mixed = has(15) & has(16)
        assert bool(mixed.any())
        assert bool((win[1][side // 2, mixed] > 0).all())


@pytest.mark.parametrize("case", OCC_WINDOW_CASES)
def test_occupancy_windows_change_nothing_on_the_cpu(case):
    """On the CPU the forward takes its plain version: the keys staged at a
    time change nothing."""
    aux, skeys, _ = occupancy_window_inputs(case, 5)
    w = torch.from_numpy(np.random.RandomState(0).randn(125, 1, 8)
                         .astype(np.float32))
    out, sbits = occupancy_conv_fwd(aux, skeys, w, None, chunk=3)
    ref, ref_bits = occupancy_conv_fwd_plain(aux, skeys, w)
    assert torch.equal(out, ref) and torch.equal(sbits, ref_bits)
    assert bool(sbits.any())


@pytest.mark.parametrize("side", [3, 5])
@pytest.mark.parametrize("case", OCC_WINDOW_CASES)
def test_flagged_windows_hold_every_flagged_neighbour(case, side):
    """The windows of K4 / K5, bounded by their flagged rows: every present
    neighbour of a flagged row lies inside its tile's window at its dx and
    sign; a tile with no flagged row has empty windows; no window is longer
    than the unflagged one; a flag of all ones gives the unflagged table."""
    aux, skeys, srow, sel = scalar_window_inputs(case, side)
    n, nk, tile = aux.shape[0], skeys.shape[0], OCC_TILE
    win = occupancy_windows(aux, skeys, side, sel)
    full = occupancy_windows(aux, skeys, side)
    assert win.shape == full.shape == (2, side, -(-n // tile), 2)
    pos = neighbor_rows(aux, skeys, torch.arange(nk, dtype=torch.int32),
                        side)
    i, k = torch.nonzero((pos >= 0) & (sel > 0)[:, None], as_tuple=True)
    assert len(i) > 0
    p = pos[i, k].long()
    half = (skeys[p] >= 0).long()
    g, t = k // (side * side), i // tile
    start, length = win[0][g, t, half], win[1][g, t, half]
    assert bool(((p >= start) & (p < start + length)).all())
    flagged = _tile_any(sel > 0, tile)
    assert bool(flagged.any()) and bool((~flagged).any())
    assert bool((win[1][:, ~flagged] == 0).all())
    assert bool((win[1] <= full[1]).all())
    assert torch.equal(occupancy_windows(aux, skeys, side,
                                         torch.ones(n)), full)


@pytest.mark.parametrize("side", [3, 5])
@pytest.mark.parametrize("case", OCC_WINDOW_CASES)
def test_dx_windows_hold_every_flagged_gathered_neighbour(case, side):
    """K9's windows are the unflagged table, those of every row of its
    tile: its row flag gates the rows of g that a row's dX gathers, not
    the rows it writes. Every present neighbour i of a row j whose flag
    row_sel[i] is set lies inside the window of j's tile at its dx and
    sign; the flagged table of K4 / K5 would miss some (a tile with no
    flagged row of its own still gathers from flagged neighbours)."""
    aux, skeys, srow, sel = scalar_window_inputs(case, side)
    nk, tile = skeys.shape[0], OCC_TILE
    win = occupancy_windows(aux, skeys, side)
    flagged = occupancy_windows(aux, skeys, side, sel)
    pos = neighbor_rows(aux, skeys, torch.arange(nk, dtype=torch.int32),
                        side).long()
    rows = torch.where(pos >= 0, srow.long()[pos.clamp_min(0)], -1)
    j, k = torch.nonzero((rows >= 0) & (sel[rows.clamp_min(0)] > 0),
                         as_tuple=True)
    assert len(j) > 0
    p = pos[j, k]
    half = (skeys[p] >= 0).long()
    g, t = k // (side * side), j // tile
    inside = [(p >= w[0][g, t, half]) & (p < w[0][g, t, half]
                                         + w[1][g, t, half])
              for w in (win, flagged)]
    assert bool(inside[0].all())
    if case != "faces":   # (its flagged tiles hold every gathered pair)
        assert not bool(inside[1].all())
    live = _tile_any(aux[:, 1] > -(1 << 19), tile)
    assert bool((win[1][:, ~live] == 0).all())


@pytest.mark.parametrize("case", OCC_WINDOW_CASES)
def test_scalar_conv_windows_change_nothing_on_the_cpu(case):
    """On the CPU K4 and K5 take their plain versions: the keys staged at
    a time change nothing, flagged or not."""
    aux, skeys, srow, sel = scalar_window_inputs(case, 5)
    rng = np.random.RandomState(1)
    n = aux.shape[0]
    x = torch.from_numpy(rng.randn(n, 1).astype(np.float32))
    w = torch.from_numpy(rng.randn(125, 1, 8).astype(np.float32))
    g = torch.from_numpy(rng.randn(n, 8).astype(np.float32))
    for flag in (None, sel):
        out = scalar_conv_fwd(x, w, aux, skeys, srow, flag, chunk=3)
        assert torch.equal(out, scalar_conv_fwd_plain(x, w, aux, skeys, srow,
                                                      flag))
        assert bool(out.any())
        dw = scalar_conv_dw(x, g, aux, skeys, srow, 125, flag, chunk=3)
        assert torch.equal(dw, scalar_conv_dw_plain(x, g, aux, skeys, srow,
                                                    125, flag))
        assert bool(dw.any())


def _run_positions(keys: torch.Tensor, base: torch.Tensor, off: int):
    """(query, position) of every target in run ``off`` of each query's
    probe block: the positions of the keys base + off and base + off + 1
    in the sorted keys (the candidates the plain version's key test
    passes there)."""
    b = base.long() + off
    first = torch.searchsorted(keys, b)
    n = torch.searchsorted(keys, b + 1, right=True) - first
    qi = torch.repeat_interleave(torch.arange(len(b)), n)
    step = torch.arange(int(n.sum())) - torch.repeat_interleave(
        torch.cumsum(n, 0) - n, n)
    return qi, torch.repeat_interleave(first, n) + step


@pytest.mark.parametrize("case", TOPK_WINDOW_CASES + ("step",))
def test_topk_windows_hold_every_candidate(case):
    """K1's windows: every target that the plain version's key test takes
    for run r of a valid query lies in its tile's windows of runs 0..r
    (each run holds its window less what the runs before it hold, so the
    pieces are disjoint and ascend); a tile with no valid base stages
    nothing. The cases between them hold bases only about monotone (the
    train step's queries sorted by home cell), tiles that straddle x
    cells, tiles of sentinel bases only and of both, bases at the +-2^9
    grid edge, and the 4 x 7 step's shapes, where the windows hold at
    most 16 targets a valid query and some tile's more than one chunk."""
    tkey, _, _, pbase, _, _ = topk_window_inputs(case)
    s_n, q_n = pbase.shape
    t_n = tkey.shape[1]
    n_tiles = -(-q_n // TOPK_TILE)
    win = topk_windows(tkey, pbase)
    assert win.shape == (2, s_n, n_tiles, 4)
    start, length = win[0].long(), win[1].long()
    assert bool((length >= 0).all() and (start + length <= t_n).all())
    # the pieces of a tile ascend and are disjoint: the staged sequence is
    # sorted
    end = torch.cummax(torch.where(length > 0, start + length, 0), -1)[0]
    assert bool(((start[..., 1:] >= end[..., :-1]) | (length[..., 1:] == 0))
                .all())
    valid = pbase != 0x7FFFFFFF
    live = _tile_any(valid, TOPK_TILE)
    assert bool((win[1][~live] == 0).all())
    keys = tkey.long()
    total = 0
    for s in range(s_n):
        base = torch.where(valid[s], pbase[s].long(), -(1 << 40))  # none
        for r, off in enumerate(RUNS):
            qi, pos = _run_positions(keys[s], base, off)
            t = qi // TOPK_TILE
            st, ln = start[s, t, :r + 1], length[s, t, :r + 1]
            assert bool(((pos[:, None] >= st) & (pos[:, None] < st + ln))
                        .any(1).all()), (case, s, r)
            total += len(pos)
    assert total > 0
    # the case holds what it is for
    tiles = torch.where(valid, pbase.long(), -1)
    tiles = torch.cat([tiles, tiles.new_full((s_n, n_tiles * TOPK_TILE - q_n),
                                             -1)], 1).reshape(s_n, n_tiles,
                                                              TOPK_TILE)
    lo = torch.where(tiles >= 0, tiles, 1 << 40).amin(-1)
    hi = tiles.amax(-1)
    assert bool(((lo >> 20) != (hi >> 20))[live].any()), "no tile straddles"
    if case in ("home_sorted", "step"):
        assert bool(((pbase[:, 1:] < pbase[:, :-1]) & valid[:, 1:]).any())
    if case == "sentinels":
        # tiles of sentinel bases only, and tiles of both
        assert bool((~live).any())
        assert bool((live & _tile_any(~valid, TOPK_TILE)).any())
    if case == "grid_edge":
        bx = pbase[valid] >> 20
        assert int(bx.min()) == 0 and int(bx.max()) == 1022
        assert bool((~valid).any())
    if case == "step":
        assert (s_n, q_n, t_n) == (28, 18432, 18432)
        assert int(win[1].sum()) <= 16 * int(valid.sum())
        assert int(win[1].sum(-1).max()) > TOPK_CHUNK


@pytest.mark.parametrize("case", TOPK_WINDOW_CASES)
def test_topk_windows_change_nothing_on_the_cpu(case):
    """A search of only the targets each tile stages gives the plain
    version's rows and d2 bit for bit (the windows lose no candidate), and
    on the CPU windowed_cell_topk takes the plain version."""
    arrays = topk_window_inputs(case)
    tkey, trow, txyz, pbase, qxyz, r2 = arrays
    s_n, q_n = pbase.shape
    win = topk_windows(tkey, pbase)
    pos = torch.arange(tkey.shape[1])
    for kn in (1, 5, 8):
        rows, d2 = windowed_cell_topk_plain(*arrays, kn)
        wrows, wd2 = torch.empty_like(rows), torch.empty_like(d2)
        for t in range(win.shape[2]):
            st, ln = win[0, :, t].long(), win[1, :, t].long()   # [S, 4]
            staged = ((pos[None, :, None] >= st[:, None])
                      & (pos[None, :, None] < (st + ln)[:, None])).any(-1)
            sl = slice(t * TOPK_TILE, (t + 1) * TOPK_TILE)
            wrows[:, sl], wd2[:, sl] = windowed_cell_topk_plain(
                torch.where(staged, tkey, 0x7FFFFFFF), trow,
                torch.where(staged[..., None], txyz, 1e30),
                pbase[:, sl].contiguous(), qxyz[:, sl].contiguous(), r2, kn)
        assert torch.equal(wrows, rows)
        assert torch.equal(wd2.view(torch.int32), d2.view(torch.int32))
        got = windowed_cell_topk(*arrays, kn)
        assert torch.equal(got[0], rows) and torch.equal(got[1], d2)
        assert int((rows >= 0).sum()) > 100

