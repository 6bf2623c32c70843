"""K1 / K11 of the port (kernels.radius_topk, plain version: the CPU has no
CUDA) against gcl_tpu's windowed_cell_topk in Pallas interpret mode, on the
same prepared arrays (sorted target keys, probe-block bases), and against a
numpy oracle.

Tolerances. Against the numpy oracle, which sums d2 as (dx^2 + dy^2) + dz^2
in separate float32 multiplies and adds as the port does: rows equal and d2
equal bit for bit. Against interpret mode: rows equal, d2 within ONE QUANTUM
r^2 / qmax (K1) or 2e-7 relative (K11). XLA's CPU build was found to
contract the multiply-adds of d2 into FMAs (about 1 % of the distances
here move by an ulp, and with 21-24 distance bits at these small T an ulp
is a quantum), which a TPU's vector unit, the port's kernel and its plain
version do not. A contraction could also swap two candidates closer than a
quantum; at the seeds below none does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcl_tpu.core import pallas_radius
from gcl_tpu.data import device_pipeline as jdp
from gcl_tpu_torch.data import device_pipeline as tdp
from gcl_tpu_torch.kernels import radius_topk

from _torch_parity import to_np


def _prepare(q, qm, t, tm, cell):
    """gcl_tpu's own preparation (_batched_grid_core, presorted=False) of
    S searches, as numpy arrays: tkey_s, trow_s, txyz_s, pbase_s, qxyz_s."""
    q, qm, t, tm = map(jnp.asarray, (q, qm, t, tm))
    s, tn = tm.shape
    tkey, t_ok = jdp._cell_key(jnp.floor(
        jnp.where(tm[..., None], t, 1e30) / cell).astype(jnp.int32), tm)
    tkey = jnp.where(t_ok, tkey, jnp.int32(0x7FFFFFFF))
    tx = jnp.where(t_ok[..., None], t, 1e30)
    iota_t = jnp.broadcast_to(jnp.arange(tn, dtype=jnp.int32), (s, tn))
    tkey_s, trow_s = jax.lax.sort((tkey, iota_t), num_keys=1)
    txyz_s = jnp.take_along_axis(tx, trow_s[..., None], axis=1)
    qx, pbase = jdp._octant_base(q, qm, cell)
    iota_q = jnp.broadcast_to(jnp.arange(q.shape[1], dtype=jnp.int32),
                              pbase.shape)
    _, qperm = jax.lax.sort((pbase, iota_q), num_keys=1)
    pbase_s = jnp.take_along_axis(pbase, qperm, axis=1)
    qxyz_s = jnp.take_along_axis(qx, qperm[..., None], axis=1)
    return tuple(np.array(a) for a in (tkey_s, trow_s, txyz_s, pbase_s,
                                       qxyz_s))


def _both(arrays, r2, kn):
    """(port rows, port d2, gcl_tpu rows, gcl_tpu d2) on the same arrays."""
    r2 = np.asarray(r2, np.float32)
    rows, d2 = radius_topk.windowed_cell_topk(
        *(torch.from_numpy(a) for a in arrays), torch.from_numpy(r2), kn)
    jrows, jd2 = pallas_radius.windowed_cell_topk(
        *(jnp.asarray(a) for a in arrays), jnp.asarray(r2), kn,
        interpret=True)
    return to_np(rows), to_np(d2), np.asarray(jrows), np.asarray(jd2)


def _assert_bit_equal(got, want, what):
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32),
                                  err_msg=what)


def _check(arrays, r2, kn, exact=False):
    """The port against interpret mode and the oracle; returns the port's
    (rows, d2)."""
    rows, d2, jrows, jd2 = _both(arrays, r2, kn)
    np.testing.assert_array_equal(rows, jrows)
    if exact:
        np.testing.assert_allclose(d2, jd2, rtol=2e-7, atol=0)
    else:
        rowb = radius_topk.row_bits(arrays[0].shape[1])
        # one quantum, and the float32 rounding of the dequantizing product
        tol = r2 / np.float32((1 << (31 - rowb)) - 1) + 2.4e-7 * r2
        assert np.all(np.abs(d2 - jd2) <= tol[:, None, None])
    orows, od2 = _oracle(arrays, r2, kn, exact)
    np.testing.assert_array_equal(rows, orows)
    _assert_bit_equal(d2, od2, "d2 against the oracle")
    return rows, d2


def _exact_start(keys, pbase, q):
    """numpy: where gcl_tpu's window for the tile of 128 queries that holds
    query q starts: the lower bound of the tile's least valid base, rounded
    down to 128 (pallas_radius.windowed_cell_topk)."""
    t0 = q // 128 * 128
    b = pbase[t0:t0 + 128]
    first = int(np.searchsorted(keys, b[b != 0x7FFFFFFF].min()))
    t_pad = -(-len(keys) // 2048) * 2048 + 2048
    return min(first & ~127, t_pad - 2048)


def _oracle(arrays, r2, kn, exact):
    """numpy: per query the candidates by the key test, within r2, the kn
    best by the packed value (K1), or (K11) in gcl_tpu's order: the
    candidates in the 2048-row chunks of their tile's window, in
    radius_topk.replace_max_order's rule."""
    tkey_s, trow_s, txyz_s, pbase, qxyz = arrays
    s_n, t_n = tkey_s.shape
    rowb = radius_topk.row_bits(t_n)
    assert bool(rowb) != exact
    rows = np.full(pbase.shape + (kn,), -1, np.int32)
    d2o = np.full(pbase.shape + (kn,), 1e30, np.float32)
    for s in range(s_n):
        for q in range(pbase.shape[1]):
            d = tkey_s[s].astype(np.int64) - int(pbase[s, q])
            cand = np.nonzero((d >= 0) & ((d & ~radius_topk.BLOCK3) == 0))[0]
            diff = (qxyz[s, q][None] - txyz_s[s, cand]).astype(np.float32)
            with np.errstate(over="ignore"):   # 1e30 fills square to inf
                sq = diff * diff
                d2 = (sq[:, 0] + sq[:, 1]) + sq[:, 2]
            keep = d2 <= r2[s]
            cand, d2 = cand[keep], d2[keep]
            if exact and len(cand):
                chunk = (cand - _exact_start(tkey_s[s], pbase[s], q)) // 2048
                idx, out = radius_topk.replace_max_order(
                    torch.from_numpy(d2[None]), torch.from_numpy(cand[None]),
                    torch.from_numpy(chunk[None]), kn)
                order = to_np(idx[0])
                order, out = order[order >= 0], to_np(out[0])[order >= 0]
            elif exact:
                order = out = cand
            else:
                qmax = np.float32((1 << (31 - rowb)) - 1)
                scale = qmax / np.maximum(np.float32(r2[s]),
                                          np.float32(1e-12))
                qd = np.minimum(d2 * scale, np.float32(
                    float(qmax) - 1.0)).astype(np.int32)
                order = np.argsort((qd.astype(np.int64) << rowb)
                                   | trow_s[s, cand])[:kn]
                out = qd[order].astype(np.float32) * (
                    np.maximum(np.float32(r2[s]), np.float32(1e-12)) / qmax)
            rows[s, q, :len(order)] = trow_s[s, cand[order]]
            d2o[s, q, :len(order)] = out
    return rows, d2o


@pytest.mark.parametrize("q_n,t_n,kn", [(96, 120, 5), (300, 600, 8),
                                        (131, 257, 5)])
def test_packed_matches_interpret_mode(q_n, t_n, kn):
    """Random clouds, masked rows on both sides, a radius per search; T and
    Q multiples of nothing."""
    rng = np.random.RandomState(q_n)
    s_n, cell = 3, 1.0
    q = (rng.randn(s_n, q_n, 3) * 1.2).astype(np.float32)
    t = (rng.randn(s_n, t_n, 3) * 1.2).astype(np.float32)
    qm, tm = rng.rand(s_n, q_n) > 0.1, rng.rand(s_n, t_n) > 0.1
    arrays = _prepare(q, qm, t, tm, cell)
    r2 = np.array([0.25, 0.16, 0.09], np.float32)
    rows, d2 = _check(arrays, r2, kn)
    assert ((rows >= 0).sum(-1) >= 3).any() and (rows[..., 0] < 0).any()
    assert np.all(d2[rows < 0] == np.float32(1e30))
    assert np.all(d2[rows >= 0] <= r2[:, None, None].repeat(q_n, 1).repeat(
        kn, 2)[rows >= 0])


def test_crowded_cells_and_max_corner_run():
    """More than kn targets in one cell, on every corner of the probe
    block: the run sharing the max-corner key is read to its end."""
    rng = np.random.RandomState(3)
    cell, kn = 1.0, 5
    # 20 targets in each of the 8 cells around the corner (1, 1, 1), all
    # within 0.2 of it; queries sit just below the corner, so their probe
    # block is cells 0..1 per axis and the max-corner cell is (1, 1, 1)
    corner = np.array([1.0, 1.0, 1.0], np.float32)
    offs = np.array([[a, b, c] for a in (-1, 1) for b in (-1, 1)
                     for c in (-1, 1)], np.float32)
    # (the max-corner cell's targets are the closest to the corner)
    t = np.concatenate([corner + o * (
        rng.uniform(0.005, 0.06, (20, 3)) if (o > 0).all()
        else rng.uniform(0.1, 0.3, (20, 3)))
        for o in offs]).astype(np.float32)[None]
    q = (corner - rng.uniform(0.01, 0.1, (40, 3))).astype(np.float32)[None]
    arrays = _prepare(q, np.ones((1, 40), bool), t, np.ones((1, 160), bool),
                      cell)
    r2 = np.array([0.25], np.float32)
    rows, d2 = _check(arrays, r2, kn)
    assert (rows >= 0).all()
    # whole answers come from the max-corner cell's run, beyond its first
    # target; others mix cells
    in_max = (t[0, rows[0]] >= corner).all(axis=-1)          # [Q, kn]
    assert (in_max.sum(axis=1) == kn).any() and not in_max.all()


def test_grid_edge_and_all_masked_search():
    """A query within one cell of the +-512 grid edge gets the sentinel
    base and no neighbour, even with a target beside it; so does every
    query of a search whose targets are all masked."""
    rng = np.random.RandomState(7)
    cell, kn = 1.0, 4
    q = (rng.randn(2, 64, 3) * 1.5).astype(np.float32)
    t = (q + rng.randn(2, 64, 3) * 0.1).astype(np.float32)
    q[0, 0] = t[0, 0] = [511.7, 0.2, 0.2]     # max edge: block would reach 512
    q[0, 1] = t[0, 1] = [-511.8, 0.2, 0.2]    # min edge: block starts at -513
    qm, tm = np.ones((2, 64), bool), np.ones((2, 64), bool)
    tm[1] = False
    arrays = _prepare(q, qm, t, tm, cell)
    r2 = np.array([0.25, 0.25], np.float32)
    rows, d2 = _check(arrays, r2, kn)
    pbase_s, qxyz_s = arrays[3], arrays[4]
    assert (pbase_s[0] == 0x7FFFFFFF).sum() == 2
    edge = np.abs(qxyz_s[0, :, 0]) > 500
    assert edge.sum() == 2 and (rows[0, edge] == -1).all()
    assert (rows[0, ~edge, 0] >= 0).all()
    assert (rows[1] == -1).all() and (d2[1] == np.float32(1e30)).all()


def test_masked_rows_get_the_sentinel_on_the_far_fill():
    """The +-1e30 fill of masked rows is clamped before the int cast: the
    keys are the sentinels, as gcl_tpu's saturating cast leaves them."""
    rng = np.random.RandomState(1)
    x = (rng.randn(2, 50, 3) * 2).astype(np.float32)
    m = rng.rand(2, 50) > 0.3
    tkey, ok, tx = tdp._target_keys(torch.from_numpy(x), torch.from_numpy(m),
                                    0.9)
    assert (to_np(tkey)[~m] == (1 << 30) - 1).all() and not to_np(ok)[~m].any()
    assert (to_np(tx)[~m] == np.float32(1e30)).all()
    _, pbase = tdp._octant_base(torch.from_numpy(x), torch.from_numpy(m), 0.9)
    assert (to_np(pbase)[~m] == 0x7FFFFFFF).all()
    jqx, jbase = jdp._octant_base(jnp.asarray(x), jnp.asarray(m), 0.9)
    np.testing.assert_array_equal(to_np(pbase), np.asarray(jbase))


def _exact_case(seed, t_valid=400, q_n=150):
    """T just over 2^19 (the packed order would keep fewer than 12 distance
    bits), all but t_valid targets masked."""
    rng = np.random.RandomState(seed)
    t_n = (1 << 19) + 1
    t = np.zeros((1, t_n, 3), np.float32)
    tm = np.zeros((1, t_n), bool)
    where = rng.choice(t_n, t_valid, replace=False)
    t[0, where] = (rng.randn(t_valid, 3) * 1.2).astype(np.float32)
    tm[0, where] = True
    q = (rng.randn(1, q_n, 3) * 1.2).astype(np.float32)
    return _prepare(q, rng.rand(1, q_n) > 0.1, t, tm, 1.0)


def test_exact_matches_interpret_mode():
    """K11: gcl_tpu falls to _topk_kernel when T > 2^19; the port's plain
    version gives the same rows and the same d2."""
    arrays = _exact_case(0)
    assert radius_topk.row_bits(arrays[0].shape[1]) == 0
    r2 = np.array([0.3], np.float32)
    before = radius_topk.windowed_cell_topk_exact.launches
    rows, d2 = _check(arrays, r2, 5, exact=True)
    assert radius_topk.windowed_cell_topk_exact.launches == before  # CPU
    assert (rows >= 0).sum() > 100


def test_exact_ties_go_to_the_lower_sorted_position():
    """Duplicate targets in one cell at one distance: (d2, sorted position)
    ascending, in the port and in interpret mode alike."""
    arrays = _exact_case(1, t_valid=300, q_n=20)
    tkey_s, trow_s, txyz_s, pbase, qxyz = arrays
    # six copies of one point beside query 0, at consecutive sorted
    # positions of one run (same key)
    first = int(np.nonzero(pbase[0] != 0x7FFFFFFF)[0][0])
    centre = np.floor(qxyz[0, first]) + 0.5
    qxyz[0, first] = centre
    base = int(pbase[0, first])
    pos = int(np.searchsorted(tkey_s[0], base))
    txyz_s[0, pos:pos + 6] = centre + np.float32([0.1, 0, 0])
    tkey_s[0, pos:pos + 6] = base
    assert (np.diff(tkey_s[0]) >= 0).all()
    r2 = np.array([0.3], np.float32)
    rows, d2 = _check(arrays, r2, 5, exact=True)
    np.testing.assert_array_equal(rows[0, first], trow_s[0, pos:pos + 5])


def test_exact_ties_across_window_chunks_take_the_tpu_order():
    """Equal distances that enter after an earlier window chunk has filled
    the kn slots: gcl_tpu puts each into the first slot holding the
    largest distance and emits equal distances by slot, so they come out
    from the last one entered to the first. Five distinct distances fill
    the slots in the tile's first 2048-row chunk; ten ties at a smaller
    distance follow past its end."""
    arrays = _exact_case(1, t_valid=300, q_n=20)
    tkey_s, trow_s, txyz_s, pbase, qxyz = arrays
    first = int(np.nonzero(pbase[0] != 0x7FFFFFFF)[0][0])
    centre = np.floor(qxyz[0, first]) + 0.5
    qxyz[0, first] = centre
    base = int(pbase[0, first])
    pos = int(np.searchsorted(tkey_s[0], base))
    dx = np.full(2110, 0.52, np.float32)
    dx[:5] = [0.40, 0.42, 0.44, 0.46, 0.48]
    dx[2100:] = 0.1
    tkey_s[0, pos:pos + 2110] = base
    txyz_s[0, pos:pos + 2110] = centre
    txyz_s[0, pos:pos + 2110, 0] += dx
    assert (np.diff(tkey_s[0]) >= 0).all()
    start = _exact_start(tkey_s[0], pbase[0], first)
    chunk = (pos + np.array([0, 4, 2100, 2109]) - start) // 2048
    assert chunk[0] == chunk[1] < chunk[2] == chunk[3]
    r2 = np.array([0.3], np.float32)
    rows, d2 = _check(arrays, r2, 5, exact=True)
    np.testing.assert_array_equal(rows[0, first],
                                  trow_s[0, pos + 2104:pos + 2099:-1])
    assert (d2[0, first] == d2[0, first, 0]).all()   # ties, all five


def test_wrapper_checks_its_arguments():
    arrays = [torch.from_numpy(a) for a in _prepare(
        np.zeros((1, 8, 3), np.float32), np.ones((1, 8), bool),
        np.zeros((1, 8, 3), np.float32), np.ones((1, 8), bool), 1.0)]
    r2 = torch.tensor([0.25])
    with pytest.raises(ValueError, match="kn"):
        radius_topk.windowed_cell_topk(*arrays, r2, 9)
    with pytest.raises(TypeError, match="tkey_s"):
        radius_topk.windowed_cell_topk(arrays[0].long(), *arrays[1:], r2, 5)
    with pytest.raises(ValueError, match="packed order"):
        radius_topk.windowed_cell_topk_exact(*arrays, r2, 5)
    rows, _ = radius_topk.windowed_cell_topk(*arrays, r2, 5)
    assert rows.shape == (1, 8, 5) and (to_np(rows)[0, :, 0] >= 0).all()
