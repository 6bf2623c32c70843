"""The port's FCGF pair losses (gcl_tpu_torch/losses/pairs.py) against
gcl_tpu's: the hardest-negative and random-negative contrastive losses and
the random and hardest triplet losses. Each test hands both packages the
same features, masks and positive pairs (numpy, from a seed) and the port
the selections gcl_tpu draws from its key (tests/_torch_parity.py:
replay_pair_loss_draws). Loss values and the gradients with respect to f0
and f1 within 1e-5.

The features are unit vectors; every positive pair is a perturbed copy,
so positive distances are small and the negatives' hinges are active.
Some rows of each side are padding, and some positive pairs are masked.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcl_tpu.losses import pairs as jpairs
from gcl_tpu_torch.losses import pairs as tpairs

from _torch_parity import (one_torch_thread,  # noqa: F401
                           replay_pair_loss_draws, to_np)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N0, N1, C, K = 300, 260, 16, 3
TOL = 1e-5
SETTINGS = dict(num_pos=64, num_hn=48, num_rand=80, num_neg=128)
POS_THRESH, NEG_THRESH = 0.1, 1.4


def _inputs(seed):
    """(f0, f1, mask0, mask1, pairs int32[N0 * K, 2], pair_mask)."""
    rng = np.random.RandomState(seed)
    f1 = rng.randn(N1, C).astype(np.float32)
    f1 /= np.linalg.norm(f1, axis=1, keepdims=True)
    partner = rng.randint(0, N1, N0)
    f0 = f1[partner] + 0.15 * rng.randn(N0, C).astype(np.float32)
    f0 /= np.linalg.norm(f0, axis=1, keepdims=True)
    mask0 = rng.rand(N0) > 0.1
    mask1 = rng.rand(N1) > 0.1
    i1 = np.stack([partner, rng.randint(0, N1, N0),
                   rng.randint(0, N1, N0)], 1)
    pairs = np.stack([np.repeat(np.arange(N0), K), i1.reshape(-1)],
                     1).astype(np.int32)
    pair_mask = (np.repeat(mask0, K) & mask1[pairs[:, 1]]
                 & (rng.rand(N0 * K) > 0.3))
    return (f0.astype(np.float32), f1, mask0, mask1, pairs, pair_mask)


def _jax_call(kind, key, f0, f1, m0, m1, pairs, pm):
    s = SETTINGS
    if kind == "hardest_contrastive":
        return jpairs.hardest_contrastive_loss(
            f0, f1, m0, m1, pairs, pm, key, num_pos=s["num_pos"],
            num_hn_samples=s["num_hn"], pos_thresh=POS_THRESH,
            neg_thresh=NEG_THRESH)
    if kind == "contrastive":
        return jpairs.contrastive_loss(f0, f1, m0, m1, pairs, pm, key,
                                       neg_thresh=NEG_THRESH,
                                       num_neg=s["num_neg"])
    if kind == "triplet":
        return jpairs.triplet_loss(f0, f1, m0, m1, pairs, pm, key,
                                   num_pos=s["num_pos"],
                                   num_rand_triplet=s["num_rand"],
                                   neg_thresh=NEG_THRESH)
    return jpairs.hardest_triplet_loss(
        f0, f1, m0, m1, pairs, pm, key, num_pos=s["num_pos"],
        num_hn_samples=s["num_hn"], num_rand_triplet=s["num_rand"],
        neg_thresh=NEG_THRESH)


def _port_call(kind, draws, f0, f1, m0, m1, pairs, pm, generator=None):
    s = SETTINGS
    args = (f0, f1, m0, m1, pairs, pm, generator)
    if kind == "hardest_contrastive":
        return tpairs.hardest_contrastive_loss(
            *args, num_pos=s["num_pos"], num_hn_samples=s["num_hn"],
            pos_thresh=POS_THRESH, neg_thresh=NEG_THRESH, draws=draws)
    if kind == "contrastive":
        return tpairs.contrastive_loss(*args, neg_thresh=NEG_THRESH,
                                       num_neg=s["num_neg"], draws=draws)
    if kind == "triplet":
        return tpairs.triplet_loss(*args, num_pos=s["num_pos"],
                                   num_rand_triplet=s["num_rand"],
                                   neg_thresh=NEG_THRESH, draws=draws)
    return tpairs.hardest_triplet_loss(
        *args, num_pos=s["num_pos"], num_hn_samples=s["num_hn"],
        num_rand_triplet=s["num_rand"], neg_thresh=NEG_THRESH, draws=draws)


def _scalar(out):
    """The loss the trainers minimise, from either package's output."""
    if hasattr(out, "pos_loss"):
        return out.pos_loss + out.neg_loss
    return out.loss


KINDS = ("hardest_contrastive", "contrastive", "triplet", "hardest_triplet")


@pytest.mark.parametrize("seed", (0, 1))
@pytest.mark.parametrize("kind", KINDS)
def test_pair_loss_matches_jax(kind, seed):
    f0, f1, m0, m1, pairs, pm = _inputs(seed)
    key = jax.random.PRNGKey(seed + 5)
    jargs = [jnp.asarray(a) for a in (f0, f1, m0, m1, pairs, pm)]

    def jloss(a, b):
        out = _jax_call(kind, key, a, b, *jargs[2:])
        return _scalar(out), out

    (jtot, jout), (jg0, jg1) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jargs[0], jargs[1])

    draws = replay_pair_loss_draws(kind, key, N0 * K, N0, N1, **SETTINGS)
    tf0 = torch.from_numpy(f0).requires_grad_()
    tf1 = torch.from_numpy(f1).requires_grad_()
    out = _port_call(kind, draws, tf0, tf1,
                     *(torch.from_numpy(a) for a in (m0, m1, pairs, pm)))
    tot = _scalar(out)
    tot.backward()
    for name in out._fields:
        want = float(getattr(jout, name))
        np.testing.assert_allclose(float(getattr(out, name).detach()), want,
                                   rtol=0,
                                   atol=TOL, err_msg=f"{kind} {name}")
        assert want > 1e-3, f"{kind} {name} is not trivially zero"
    np.testing.assert_allclose(float(tot.detach()), float(jtot), rtol=0,
                               atol=TOL)
    for got, want, side in ((tf0.grad, jg0, 0), (tf1.grad, jg1, 1)):
        want = np.asarray(want)
        assert np.abs(want).max() > 1e-4, f"{kind} d/df{side} not zero"
        np.testing.assert_allclose(to_np(got), want, rtol=0, atol=TOL,
                                   err_msg=f"{kind} d loss / d f{side}")


@pytest.mark.parametrize("kind", KINDS)
def test_pair_loss_draws_from_a_generator(kind):
    """Without draws the loss takes its selections from the generator: the
    same seed gives the same loss, another seed another, and padding rows
    and masked pairs receive no gradient."""
    f0, f1, m0, m1, pairs, pm = (torch.from_numpy(a) for a in _inputs(3))
    vals = []
    for seed in (0, 0, 1):
        a = f0.clone().requires_grad_()
        out = _port_call(kind, None, a, f1, m0, m1, pairs, pm,
                         torch.Generator().manual_seed(seed))
        _scalar(out).backward()
        vals.append(float(_scalar(out)))
        assert float(a.grad[~m0].abs().max()) == 0.0
    assert vals[0] == vals[1] != vals[2]
