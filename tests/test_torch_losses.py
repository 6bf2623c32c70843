"""The port's loss machinery against gcl_tpu: stratified sampling (exact,
given the same uniforms), the negative hinge with pinned subsets, and the
finest contrastive loss with its gradient for both block_finest_gradient
values. The two packages cannot share a generator, so the tests draw
gcl_tpu's uniforms from its keys and hand them to the port.

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
    r = torch.from_numpy(np.asarray(jax.random.randint(key, (s,), 0, s)))
    got = tgcl.negative_loss_from_sel(
        torch.from_numpy(f), torch.from_numpy(sel1), torch.from_numpy(v1),
        torch.from_numpy(sel2), torch.from_numpy(v2),
        tgcl.SpatialNegFilter(torch.from_numpy(xyz), torch.from_numpy(sid),
                              torch.from_numpy(radius)),
        None, tgcl.GCLLossConfig(use_hard_negative=hard), r)
    assert float(ref) > 0.01
    np.testing.assert_allclose(float(got), float(ref), rtol=0, atol=1e-5)


def test_other_negative_filters_are_not_ported():
    with pytest.raises(NotImplementedError, match="SpatialNegFilter"):
        tgcl.negative_loss_from_sel(None, None, None, None, None,
                                    torch.zeros(4, 2), None,
                                    tgcl.GCLLossConfig())


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
    return dict(member_idx=member_idx, member_mask=member_mask,
                finest_pos=finest_pos, valid=valid,
                anchor_xyz=np.zeros((g_cap, 3), np.float32),
                anchor_item=np.zeros(g_cap, np.int32))


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
