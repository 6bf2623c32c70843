"""The port's loss machinery against gcl_tpu: stratified sampling (exact,
given the same uniforms), the negative hinge with pinned subsets in its
three filter forms, the reverse membership index and the pair list
(exact), and the finest, location and circle losses with their gradients
for both block_finest_gradient values. The two packages cannot share a
generator, so the tests draw gcl_tpu's uniforms from its keys and hand
them to the port.

Tolerance: losses 1e-5 absolute, d loss / d f_out within 1e-5 of its max
(float32 sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcl_tpu.core.types import ColocationGroups as JGroups
from gcl_tpu.losses import common as jlc
from gcl_tpu.losses import gcl as jgcl
from gcl_tpu_torch.core.types import ColocationGroups
from gcl_tpu_torch.losses import common as tlc
from gcl_tpu_torch.losses import gcl as tgcl

from _torch_parity import assert_close_to_max, replay_loss_draws, to_np


@pytest.mark.parametrize("n,n_valid,m", [
    (500, 300, 64),    # pool larger than m
    (500, 40, 64),     # pool smaller than m: repeats masked invalid
    (48, 30, 64),      # fewer rows than m: padded
    (500, 0, 16),      # nothing valid
    (1000, 977, 256),  # stratum edges where float32 order matters
])
def test_sample_without_replacement_exact(n, n_valid, m):
    rng = np.random.RandomState(n + n_valid)
    valid = np.zeros(n, bool)
    valid[rng.permutation(n)[:n_valid]] = True
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        u = np.array(jax.random.uniform(key, (min(m, n),)))
        jidx, jsel = jlc.sample_without_replacement(key, jnp.asarray(valid),
                                                    m)
        idx, sel = tlc.sample_without_replacement(
            None, torch.from_numpy(valid), m, torch.from_numpy(u))
        np.testing.assert_array_equal(to_np(sel), np.asarray(jsel))
        np.testing.assert_array_equal(to_np(idx), np.asarray(jidx))
        assert int(to_np(sel).sum()) == min(m, n_valid) or n_valid > m


def test_sampling_from_a_generator():
    valid = torch.rand(400, generator=torch.Generator().manual_seed(0)) > 0.4
    gen = torch.Generator().manual_seed(1)
    idx, sel = tlc.sample_without_replacement(gen, valid, 50)
    assert sel.all() and valid[idx].all() and len(set(idx.tolist())) == 50
    j = tlc.sample_uniform_index(gen, valid, (30,))
    assert valid[j].all()
    order, cnt = tlc._valid_order(valid)
    assert order[:int(cnt)].tolist() == torch.nonzero(valid)[:, 0].tolist()


def _features(seed, n, c=16):
    rng = np.random.RandomState(seed)
    f = rng.randn(n, c).astype(np.float32)
    return f / np.linalg.norm(f, axis=1, keepdims=True)


def _neg_filter(seed, n, b):
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    sid = np.repeat(np.arange(b, dtype=np.int32), n // b)
    radius = np.array([0.45, 0.8][:b], np.float32)
    return xyz, sid, radius


@pytest.mark.parametrize("hard", [True, False])
def test_negative_loss_with_pinned_subsets(hard):
    n, s = 600, 96
    f = _features(0, n)
    xyz, sid, radius = _neg_filter(1, n, 2)
    rng = np.random.RandomState(2)
    sel1, sel2 = rng.permutation(n)[:s], rng.permutation(n)[:s]
    sel2[:10] = sel1[:10]  # self pairs, which the loss must mask
    v1, v2 = rng.rand(s) > 0.1, rng.rand(s) > 0.1
    key = jax.random.PRNGKey(3)
    ref = jgcl.negative_loss_from_sel(
        jnp.asarray(f), jnp.asarray(sel1), jnp.asarray(v1),
        jnp.asarray(sel2), jnp.asarray(v2),
        jgcl.SpatialNegFilter(jnp.asarray(xyz), jnp.asarray(sid),
                              jnp.asarray(radius)),
        None, key, jgcl.GCLLossConfig(use_hard_negative=hard))
    # gcl_tpu's loss is finished before the port's starts (JAX dispatches
    # asynchronously), and the port's uniforms are a copy of JAX's, not a
    # read-only view of a buffer that JAX owns
    ref = float(ref)
    r = torch.from_numpy(np.array(jax.random.randint(key, (s,), 0, s)))
    got = tgcl.negative_loss_from_sel(
        torch.from_numpy(f), torch.from_numpy(sel1), torch.from_numpy(v1),
        torch.from_numpy(sel2), torch.from_numpy(v2),
        tgcl.SpatialNegFilter(torch.from_numpy(xyz), torch.from_numpy(sid),
                              torch.from_numpy(radius)),
        None, tgcl.GCLLossConfig(use_hard_negative=hard), r)
    assert ref > 0.01
    np.testing.assert_allclose(float(got), ref, rtol=0, atol=1e-5)


def test_other_negative_filters_are_not_ported():
    """(Kept under its first name.) The membership-index and pair-list
    forms of the filter are ported: with pinned subsets each gives
    gcl_tpu's loss, and the three forms differ from one another."""
    n, s, g_cap, kc = 600, 96, 150, 6
    f = _features(0, n)
    f[300:] = f[:300] + 0.02 * _features(7, 300)  # near twins: live hinge
    gr = _groups(8, n, g_cap, kc)
    # groups of twins, so that sampled hardest pairs are co-members
    gr["member_idx"][:, 1] = np.where(gr["member_mask"][:, 1],
                                      (gr["member_idx"][:, 0] + 300) % n, -1)
    rng = np.random.RandomState(2)
    sel1 = gr["member_idx"][gr["valid"], 0][:s].astype(np.int64)
    sel2 = (sel1 + 300) % n
    sel2[::3] = rng.permutation(n)[:len(sel2[::3])]
    v1, v2 = rng.rand(len(sel1)) > 0.1, rng.rand(len(sel1)) > 0.1
    jg = JGroups(**{k: jnp.asarray(v) for k, v in gr.items()})
    tg = ColocationGroups(**{k: torch.from_numpy(v) for k, v in gr.items()})
    xyz, sid, radius = _neg_filter(1, n, 2)
    jpairs, jpm = jgcl.intra_group_pairs(jg, 4096)
    forms = {
        "spatial": ((jgcl.SpatialNegFilter(jnp.asarray(xyz), jnp.asarray(sid),
                                           jnp.asarray(radius)), None),
                    tgcl.SpatialNegFilter(torch.from_numpy(xyz),
                                          torch.from_numpy(sid),
                                          torch.from_numpy(radius))),
        "membership": ((jgcl.member_group_index(jg, n, 8), None),
                       tgcl.member_group_index(tg, n, 8)),
        "pairs": ((jpairs, jpm),
                  tgcl.PairListNegFilter(*tgcl.intra_group_pairs(tg, 4096)))}
    got = {}
    for name, ((jpp, jmask), tpp) in forms.items():
        ref = jgcl.negative_loss_from_sel(
            jnp.asarray(f), jnp.asarray(sel1), jnp.asarray(v1),
            jnp.asarray(sel2), jnp.asarray(v2), jpp, jmask,
            jax.random.PRNGKey(0), jgcl.GCLLossConfig())
        got[name] = float(tgcl.negative_loss_from_sel(
            torch.from_numpy(f), torch.from_numpy(sel1),
            torch.from_numpy(v1), torch.from_numpy(sel2),
            torch.from_numpy(v2), tpp, None, tgcl.GCLLossConfig()))
        np.testing.assert_allclose(got[name], float(ref), rtol=0, atol=1e-5,
                                   err_msg=name)
    assert got["membership"] == pytest.approx(got["pairs"], abs=1e-6)
    assert abs(got["spatial"] - got["membership"]) > 1e-3


@pytest.mark.parametrize("r_cap", [2, 32])
def test_member_group_index_exact(r_cap):
    gr = _groups(5, 300, 120, 6)
    ref = jgcl.member_group_index(
        JGroups(**{k: jnp.asarray(v) for k, v in gr.items()}), 300, r_cap)
    got = tgcl.member_group_index(
        ColocationGroups(**{k: torch.from_numpy(v) for k, v in gr.items()}),
        300, r_cap)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(to_np(got), np.asarray(ref))
    assert (to_np(got)[:, -1] >= 0).any() == (r_cap == 2)  # 2 truncates


@pytest.mark.parametrize("pair_cap", [4096, 300])
def test_intra_group_pairs_exact(pair_cap):
    """Padded (cap above the 120 * 15 candidate pairs) and compacted and
    cut (cap below the valid ones); sort_pairs and pair_isin agree too."""
    gr = _groups(6, 300, 120, 6)
    jp, jm = jgcl.intra_group_pairs(
        JGroups(**{k: jnp.asarray(v) for k, v in gr.items()}), pair_cap)
    tp, tm = tgcl.intra_group_pairs(
        ColocationGroups(**{k: torch.from_numpy(v) for k, v in gr.items()}),
        pair_cap)
    np.testing.assert_array_equal(to_np(tm), np.asarray(jm))
    np.testing.assert_array_equal(to_np(tp)[to_np(tm)],
                                  np.asarray(jp)[np.asarray(jm)])
    assert tp.shape == (pair_cap, 2) and int(tm.sum()) > 250
    ja, jb = jlc.sort_pairs(jp, jm)
    ta, tb = tlc.sort_pairs(tp, tm)
    np.testing.assert_array_equal(to_np(ta), np.asarray(ja))
    np.testing.assert_array_equal(to_np(tb), np.asarray(jb))
    rng = np.random.RandomState(0)
    qa = np.concatenate([np.asarray(jp)[:40, 0], rng.randint(0, 300, 60)])
    qb = np.concatenate([np.asarray(jp)[:40, 1], rng.randint(0, 300, 60)])
    want = jlc.pair_isin(ja, jb, jnp.asarray(qa, jnp.int32),
                         jnp.asarray(qb, jnp.int32))
    got = tlc.pair_isin(ta, tb, torch.from_numpy(qa).int(),
                        torch.from_numpy(qb).int())
    np.testing.assert_array_equal(to_np(got), np.asarray(want))
    assert 0 < int(got.sum()) < 100


def test_square_distance_and_masked_logsumexp():
    rng = np.random.RandomState(3)
    a, b = _features(1, 40), _features(2, 50)
    for normalised in (False, True):
        np.testing.assert_allclose(
            to_np(tlc.square_distance(torch.from_numpy(a), torch.from_numpy(b),
                                      normalised)),
            np.asarray(jlc.square_distance(jnp.asarray(a), jnp.asarray(b),
                                           normalised)), rtol=1e-6, atol=1e-6)
    x = rng.randn(30, 12).astype(np.float32) * 5
    m = rng.rand(30, 12) > 0.5
    m[0] = False
    got = to_np(tlc.masked_logsumexp(torch.from_numpy(x),
                                     torch.from_numpy(m)))
    want = np.asarray(jlc.masked_logsumexp(jnp.asarray(x), jnp.asarray(m)))
    assert got[0] == want[0] == -np.inf
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-6, atol=1e-6)


def _groups(seed, n, g_cap, kc):
    rng = np.random.RandomState(seed)
    member_idx = rng.randint(0, n, (g_cap, kc)).astype(np.int32)
    member_mask = rng.rand(g_cap, kc) > 0.4
    member_mask[:, 0] = True
    valid = rng.rand(g_cap) > 0.3
    member_mask &= valid[:, None]
    member_idx = np.where(member_mask, member_idx, -1).astype(np.int32)
    # the finest member is always a member: its column is masked in
    first = np.argmax(member_mask, axis=1)
    pick = np.array([rng.choice(np.flatnonzero(m)) if m.any() else 0
                     for m in member_mask])
    finest_pos = np.where(rng.rand(g_cap) > 0.5, first, pick).astype(
        np.int32)
    # anchors: integer voxel coords a few voxels apart, two samples
    return dict(member_idx=member_idx, member_mask=member_mask,
                finest_pos=finest_pos, valid=valid,
                anchor_xyz=rng.randint(-3, 4, (g_cap, 3)).astype(np.float32),
                anchor_item=(np.arange(g_cap) % 2).astype(np.int32))


@pytest.fixture(scope="module")
def j_loss_and_grad():
    def make(cfg):
        def total(f, mask, groups, nf, key):
            out = jgcl.finest_contrastive_loss(f, mask, groups, nf, None,
                                               key, 64, 96, cfg)
            return out.pos_loss + out.finest_loss + out.neg_loss, out
        return jax.jit(jax.value_and_grad(total, has_aux=True))
    return {blk: make(jgcl.GCLLossConfig(block_finest_gradient=blk))
            for blk in (True, False)}


@pytest.mark.parametrize("block", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_finest_contrastive_loss_and_gradient(j_loss_and_grad, block, seed):
    n, g_cap, kc = 800, 200, 6
    f = _features(10 + seed, n)
    mask = np.random.RandomState(seed).rand(n) > 0.1
    gr = _groups(20 + seed, n, g_cap, kc)
    xyz, sid, radius = _neg_filter(30 + seed, n, 2)
    key = jax.random.PRNGKey(40 + seed)
    (_, ref), rgrad = j_loss_and_grad[block](
        jnp.asarray(f), jnp.asarray(mask),
        JGroups(**{k: jnp.asarray(v) for k, v in gr.items()}),
        jgcl.SpatialNegFilter(jnp.asarray(xyz), jnp.asarray(sid),
                              jnp.asarray(radius)), key)

    ft = torch.from_numpy(f).requires_grad_()
    out = tgcl.finest_contrastive_loss(
        ft, torch.from_numpy(mask),
        ColocationGroups(**{k: torch.from_numpy(v) for k, v in gr.items()}),
        tgcl.SpatialNegFilter(torch.from_numpy(xyz), torch.from_numpy(sid),
                              torch.from_numpy(radius)),
        None, 64, 96, tgcl.GCLLossConfig(block_finest_gradient=block),
        replay_loss_draws(key, g_cap, n, 64, 96))
    (out.pos_loss + out.finest_loss + out.neg_loss).backward()
    for name in ("pos_loss", "finest_loss", "neg_loss"):
        want = float(getattr(ref, name))
        assert want > 1e-3, name  # every term is live
        np.testing.assert_allclose(float(getattr(out, name).detach()), want, rtol=0,
                                   atol=1e-5, err_msg=name)
    assert_close_to_max(to_np(ft.grad), rgrad, 1e-5)


_J_LOSSES = {"location": jgcl.location_contrastive_loss,
             "circle": jgcl.location_circle_loss}
_T_LOSSES = {"location": tgcl.location_contrastive_loss,
             "circle": tgcl.location_circle_loss}


@pytest.fixture(scope="module")
def j_kind_loss_and_grad():
    cache = {}

    def get(kind, block, form):
        if (kind, block, form) not in cache:
            cfg = jgcl.GCLLossConfig(block_finest_gradient=block)

            def total(f, mask, groups, pp, ppm, key):
                out = _J_LOSSES[kind](f, mask, groups, pp, ppm, key, 64, 96,
                                      cfg)
                return out.pos_loss + out.finest_loss + out.neg_loss, out
            cache[kind, block, form] = jax.jit(
                jax.value_and_grad(total, has_aux=True))
        return cache[kind, block, form]
    return get


@pytest.mark.parametrize("kind,block,form", [
    ("location", True, "spatial"), ("location", True, "membership"),
    ("location", True, "pairs"), ("circle", True, "spatial"),
    ("circle", False, "spatial"), ("circle", True, "membership"),
    ("circle", True, "pairs")])
def test_location_and_circle_losses_and_gradients(j_kind_loss_and_grad, kind,
                                                  block, form):
    """Pinned selections (gcl_tpu's uniforms replayed); gcl_tpu's
    location_circle_loss is the reference as it stands. The circle loss
    ignores the filter; it is handed over all the same."""
    n, g_cap, kc = 800, 200, 6
    # features near one direction, so that group centroids lie within
    # neg_thresh of one another and the circle negative is live
    f = _features(10, n) * 0.35 + np.float32(1.0) / 4
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    mask = np.random.RandomState(1).rand(n) > 0.1
    gr = _groups(21, n, g_cap, kc)
    jg = JGroups(**{k: jnp.asarray(v) for k, v in gr.items()})
    tg = ColocationGroups(**{k: torch.from_numpy(v) for k, v in gr.items()})
    xyz, sid, radius = _neg_filter(31, n, 2)
    if form == "spatial":
        jpp, jpm = jgcl.SpatialNegFilter(jnp.asarray(xyz), jnp.asarray(sid),
                                         jnp.asarray(radius)), None
        tpp = tgcl.SpatialNegFilter(torch.from_numpy(xyz),
                                    torch.from_numpy(sid),
                                    torch.from_numpy(radius))
    elif form == "membership":
        jpp, jpm = jgcl.member_group_index(jg, n, 16), None
        tpp = tgcl.member_group_index(tg, n, 16)
    else:
        jpp, jpm = jgcl.intra_group_pairs(jg, 4096)
        tpp = tgcl.PairListNegFilter(*tgcl.intra_group_pairs(tg, 4096))
    key = jax.random.PRNGKey(41)
    (_, ref), rgrad = j_kind_loss_and_grad(kind, block, form)(
        jnp.asarray(f), jnp.asarray(mask), jg, jpp, jpm, key)

    ft = torch.from_numpy(f).requires_grad_()
    out = _T_LOSSES[kind](
        ft, torch.from_numpy(mask), tg, tpp, None, 64, 96,
        tgcl.GCLLossConfig(block_finest_gradient=block),
        replay_loss_draws(key, g_cap, n, 64, 96))
    (out.pos_loss + out.finest_loss + out.neg_loss).backward()
    for name in ("pos_loss", "finest_loss", "neg_loss"):
        want = float(getattr(ref, name))
        if not (kind == "location" and name == "finest_loss"):
            assert want > 1e-3, name  # the term is live
        np.testing.assert_allclose(float(getattr(out, name).detach()), want,
                                   rtol=0, atol=1e-5, err_msg=name)
    assert bool(torch.isfinite(ft.grad).all())
    assert_close_to_max(to_np(ft.grad), rgrad, 1e-5)


def test_pair_positive_and_generator_route():
    """The use_pair_group_positive_loss branch and the generator route run
    and give finite, positive losses (their draws are not replayed)."""
    n, g_cap, kc = 400, 100, 6
    gr = _groups(3, n, g_cap, kc)
    xyz, sid, radius = _neg_filter(4, n, 2)
    out = tgcl.finest_contrastive_loss(
        torch.from_numpy(_features(5, n)), torch.ones(n, dtype=torch.bool),
        ColocationGroups(**{k: torch.from_numpy(v) for k, v in gr.items()}),
        tgcl.SpatialNegFilter(torch.from_numpy(xyz), torch.from_numpy(sid),
                              torch.from_numpy(radius)),
        torch.Generator().manual_seed(0), 32, 48,
        tgcl.GCLLossConfig(use_pair_group_positive_loss=True))
    assert all(bool(torch.isfinite(v)) and float(v) > 0 for v in out)
