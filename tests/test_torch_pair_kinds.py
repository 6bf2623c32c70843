"""The port's pair grad_fn for the three trainer kinds besides the
hardest-contrastive one (tests/test_torch_pair_step.py holds that one
through two whole steps): 'contrastive' (random negatives, 2 x num_pos of
them), 'triplet' and 'hardest_triplet', against gcl_tpu's
make_pair_grad_fn on a narrow ResUNetFatBNEXP with the same weights, batch
and replayed draws (tests/_torch_parity.py:replay_pair_step_draws). The
loss and its two reported terms within 1e-5, every gradient within 1e-3
of its tensor's max (the tolerances and the ReLU rule of
tests/test_torch_pair_step.py).
"""
import jax
import numpy as np
import pytest
import torch

from gcl_tpu.train import steps as jsteps
from gcl_tpu_torch.models.weights import flatten_tree, gradients_by_name
from gcl_tpu_torch.train import steps as tsteps

from _torch_parity import (assert_close_to_max, jax_specs,
                           one_torch_thread,  # noqa: F401
                           replay_pair_step_draws, to_np)
from test_torch_pair_step import (B, CFG, CORR_K, N, _models, _pair_batch,
                                  _step_cfg)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

COUNTS = {
    "contrastive": dict(num_neg=2 * CFG["num_pos_per_batch"] * B),
    "triplet": dict(num_pos=CFG["triplet_num_pos"] * B,
                    num_rand=CFG["triplet_num_rand"] * B),
    "hardest_triplet": dict(num_pos=CFG["triplet_num_pos"] * B,
                            num_hn=CFG["triplet_num_hn"] * B,
                            num_rand=CFG["triplet_num_rand"] * B)}


@pytest.mark.parametrize("kind", sorted(COUNTS))
def test_pair_grad_fn_kind_matches_jax(kind):
    jmodel, tmodel, (params, stats), specs = _models(seed=21)
    jgrad = jax.jit(jsteps.make_pair_grad_fn(
        jmodel, jax_specs(specs), _step_cfg(jsteps, specs), kind, CFG))
    batch = _pair_batch(5)
    k = jax.random.PRNGKey(17)
    grads, _, jm = jgrad(params, stats, k, *batch)
    draws = replay_pair_step_draws(k, B, N, N * CORR_K, kind, **COUNTS[kind])
    tm = tsteps.make_pair_grad_fn(tmodel, specs, _step_cfg(tsteps, specs),
                                  kind, CFG)(
        *(torch.from_numpy(a) for a in batch), draws=draws)
    for name in ("loss", "pos_loss", "neg_loss"):
        assert float(jm[name]) > 1e-3, name
        np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=0,
                                   atol=1e-5, err_msg=f"{kind} {name}")
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, grads))
    got = gradients_by_name(tmodel)
    assert got.keys() == want.keys()
    for name in want:
        assert_close_to_max(to_np(got[name]), want[name], 1e-3,
                            f"{kind} grad {name}")
