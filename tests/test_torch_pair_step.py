"""The port's FCGF pair step against gcl_tpu's: build_correspondences
(pairs and mask equal, with the grid search and brute force, on a
transformed pair) and one and two pair train steps of a narrow
ResUNetFatBNEXP (tests/_torch_parity.py:narrow_exp_classes) with the
hardest-contrastive loss, against make_pair_train_step from the same
weights.

The packages cannot share a generator: the test replays gcl_tpu's key
splits (train/steps.py: rng, k = split(rng); side s jitters from
fold_in(k, s), its gates from the split of that key, its noise from the
second half of the split of the rest; the loss draws from k) and hands
the port the same gates, noise and loss selections (PairDraws).

Tolerances. Loss terms within 1e-5; parameters and momentum buffers within
1e-4 of each tensor's max, the gradients (read back from gcl_tpu's
momentum trace) within 1e-3 of it; BN running stats rtol = atol = 1e-4.
As in tests/test_torch_train_step.py, a ReLU input within float32 rounding
of zero can open in one package and not the other and move one channel's
gradient by percents, so the seeds are ones where none does; should a
single channel drift after a numeric change, check it against float64 as
test_torch_train_step.py::test_float32_gradients_match_float64 does before
suspecting a bug.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcl_tpu.data import device_pipeline as jdp
from gcl_tpu.train import steps as jsteps
from gcl_tpu_torch.core.kernel_maps import default_level_caps
from gcl_tpu_torch.data import device_pipeline as tdp
from gcl_tpu_torch.models.weights import (flatten_tree, gradients_by_name,
                                          momentum_by_name,
                                          random_state_dict,
                                          state_dict_to_flax)
from gcl_tpu_torch.train import steps as tsteps

from _torch_parity import (VOXEL, assert_close_to_max, clouds, jax_specs,
                           narrow_exp_classes, one_torch_thread,  # noqa: F401
                           replay_pair_step_draws, strides_of, to_np)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B, P, NV = 2, 1500, 448
N = B * NV
CORR_K = 4
WD, MOM = 1e-4, 0.8
LRS = (0.05, 0.02)
CFG = dict(batch_size=B, num_pos_per_batch=48,
           num_hn_samples_per_batch=64, triplet_num_pos=16,
           triplet_num_hn=16, triplet_num_rand=16, pos_thresh=0.1,
           neg_thresh=1.4, neg_weight=1.0, jitter_feats=True)


def _rigid(rng):
    a = rng.uniform(-0.3, 0.3)
    t = np.eye(4, dtype=np.float32)
    t[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    t[:3, 3] = rng.uniform(-1.0, 1.0, 3) * [1, 1, 0.2]
    return t


def _pair_batch(seed):
    """(points0, pmask0, points1, pmask1, trans [B, 4, 4], radius [B]):
    each side-1 cloud is its side-0 cloud moved by trans, resampled with
    noise."""
    pts0, pmask0 = clouds(seed, B, P)
    rng = np.random.RandomState(seed + 1)
    trans = np.stack([_rigid(rng) for _ in range(B)])
    pts1 = np.empty_like(pts0)
    for b in range(B):
        moved = pts0[b] @ trans[b, :3, :3].T + trans[b, :3, 3]
        pts1[b] = moved + rng.randn(P, 3).astype(np.float32) * 0.03
    pmask1 = pmask0 & (rng.rand(B, P) > 0.05)
    return (pts0, pmask0, pts1.astype(np.float32), pmask1, trans,
            np.array([0.45, 0.4], np.float32))


def _models(seed):
    jcls, tcls = narrow_exp_classes()
    tmodel = tcls(1, 32, bn_momentum=0.05, normalize_feature=True,
                  conv1_kernel_size=5, D=3)
    state = random_state_dict(tmodel, seed=seed)
    tmodel.load_state_dict(state)
    jmodel = jcls(1, 32, bn_momentum=0.05, normalize_feature=True,
                  conv1_kernel_size=5, D=3)
    return jmodel, tmodel, state_dict_to_flax(state), tcls.conv_specs(5)


def _step_cfg(mod, specs, **kw):
    return mod.StepConfig(**{**dict(
        voxel_size=VOXEL, nv_cap=NV,
        level_caps=default_level_caps(N, strides_of(specs), 0.6),
        knn_chunk=128, corr_k=CORR_K, search_cell=None, momentum=MOM,
        weight_decay=WD), **kw})


def _replay_draws(k):
    """The PairDraws of gcl_tpu's grad_fn called with key k."""
    return replay_pair_step_draws(
        k, B, N, N * CORR_K, num_pos=CFG["num_pos_per_batch"] * B,
        num_hn=CFG["num_hn_samples_per_batch"] * B)


def _tree_np(t):
    return flatten_tree(jax.tree_util.tree_map(np.asarray, t))


@pytest.mark.parametrize("cell", (None, 1.2))
def test_build_correspondences_equal_jax(cell):
    """One transformed pair: every (i0, i1) pair and the mask equal, on the
    grid (cell 1.2, cell_cap 4: the per-cell truncation bites) and brute
    force. gcl_tpu runs op by op (jax.disable_jit), the arithmetic its
    program states: under jit XLA's CPU fusion contracts the brute-force
    d2 = |q|^2 + |t|^2 - 2 q.t into fused multiply-adds, which reorders two
    targets whose distances lie within float32 rounding of each other (seen
    here: 0.0544289 against 0.0544295 m^2 for one query at ~5 m)."""
    pts0, pmask0, pts1, pmask1, trans, _ = _pair_batch(3)
    vox = [tdp.voxelize_per_cloud(torch.from_numpy(p), torch.from_numpy(m),
                                  VOXEL, NV)
           for p, m in ((pts0, pmask0), (pts1, pmask1))]
    args = (vox[0].xyz[0], vox[0].mask[0], vox[1].xyz[0], vox[1].mask[0],
            torch.from_numpy(trans[0]), 0.45)
    pairs, mask = tdp.build_correspondences(*args, k=CORR_K, chunk=128,
                                            cell=cell, cell_cap=4)
    with jax.disable_jit():
        jpairs, jmask = jdp.build_correspondences(
            *(jnp.asarray(to_np(a)) for a in args[:5]), 0.45, k=CORR_K,
            chunk=128, cell=cell, cell_cap=4)
    assert pairs.dtype == torch.int32 and pairs.shape == (NV * CORR_K, 2)
    np.testing.assert_array_equal(to_np(mask), np.asarray(jmask))
    np.testing.assert_array_equal(to_np(pairs), np.asarray(jpairs))
    n_hit = int(mask.sum())
    assert n_hit > 0.5 * int(vox[0].mask[0].sum())
    # each hit lies within the radius of its moved source voxel
    x0 = tdp.transform_points(args[0], args[4])[pairs[mask, 0].long()]
    x1 = args[2][pairs[mask, 1].long()]
    assert float(((x0 - x1) ** 2).sum(1).max()) <= 0.45 ** 2 * (1 + 1e-5)


def test_pair_train_steps_match_jax():
    """Two hardest-contrastive pair steps, exact input jitter on, brute-force
    correspondences: loss terms after each, the gradients (from gcl_tpu's
    momentum trace), momentum, parameters and BN running stats."""
    jmodel, tmodel, (params, stats), specs = _models(seed=21)
    tx, jstep = jsteps.make_pair_train_step(
        jmodel, jax_specs(specs), _step_cfg(jsteps, specs),
        "hardest_contrastive", CFG)
    jstate = jsteps.TrainState(params, stats, tx.init(params),
                               jax.random.PRNGKey(4),
                               jnp.zeros((), jnp.int32))
    opt, step = tsteps.make_pair_train_step(
        tmodel, specs, _step_cfg(tsteps, specs), "hardest_contrastive", CFG)
    batch = _pair_batch(5)
    tbatch = tuple(torch.from_numpy(a) for a in batch)
    jbatch = tuple(jnp.asarray(a) for a in batch)
    for i in range(2):
        _, k = jax.random.split(jstate.rng)
        draws = _replay_draws(k)
        assert float(draws.side0.sample_gate_u.max()) > 0.0
        prev_p, prev_m = (_tree_np(jstate.params),
                          _tree_np(jstate.opt_state[1].trace))
        jstate, jm = jstep(jstate, LRS[i], *jbatch)
        tm = step(LRS[i], *tbatch, draws=draws)
        for name in ("loss", "pos_loss", "neg_loss"):
            assert float(jm[name]) > 1e-3, name
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=0, atol=1e-5,
                                       err_msg=f"step {i} {name}")
        assert float(tm["num_pos_pairs"]) > N
        trace = _tree_np(jstate.opt_state[1].trace)
        got = gradients_by_name(tmodel)
        for name, t in trace.items():
            want = t - MOM * prev_m[name] - WD * prev_p[name]
            assert_close_to_max(to_np(got[name]), want, 1e-3,
                                f"step {i} grad {name}")
        for name, want in trace.items():
            assert_close_to_max(to_np(momentum_by_name(tmodel, opt)[name]),
                                want, 1e-4, f"step {i} momentum {name}")
        want_p = _tree_np(jstate.params)
        for name, p in tmodel.named_parameters():
            assert_close_to_max(to_np(p), want_p[name], 1e-4,
                                f"step {i} param {name}")
        _, tstats = state_dict_to_flax(tmodel.state_dict())
        got_s, want_s = flatten_tree(tstats), _tree_np(jstate.batch_stats)
        assert got_s.keys() == want_s.keys() and len(want_s) == 42
        for name in want_s:
            np.testing.assert_allclose(got_s[name], want_s[name], rtol=1e-4,
                                       atol=1e-4, err_msg=f"{i} {name}")


def _random_draws(seed):
    """PairDraws from a seeded torch generator."""
    gen = torch.Generator().manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=gen)

    sides = [tsteps.StepDraws(rand(B), (rand(), torch.randn(
        (N, 1), generator=gen))) for _ in range(2)]
    return tsteps.PairDraws(*sides, tsteps.PairLossDraws(
        pos=rand(CFG["num_pos_per_batch"] * B),
        hn0=rand(CFG["num_hn_samples_per_batch"] * B),
        hn1=rand(CFG["num_hn_samples_per_batch"] * B)))


def test_pair_grad_fn_in_accum_stepper():
    """AccumStepper takes the pair grad_fn as it is (on the grid search):
    after two micro-batches at iter_size 2 the parameters moved once, by
    the SGD step on the mean of the two micro-batches' gradients, each
    computed alone from the same weights and draws."""
    _, tmodel, _, specs = _models(seed=21)
    p0 = {n: p.detach().clone() for n, p in tmodel.named_parameters()}
    cfg = _step_cfg(tsteps, specs, search_cell=1.2)
    batches = [tuple(torch.from_numpy(a) for a in _pair_batch(seed))
               for seed in (5, 6)]
    draws = [_random_draws(seed) for seed in (1, 2)]
    grads = []
    for batch, d in zip(batches, draws):
        alone = _models(seed=21)[1]
        tsteps.make_pair_grad_fn(alone, specs, cfg, "hardest_contrastive",
                                 CFG)(*batch, draws=d)
        grads.append(dict(gradients_by_name(alone)))

    grad_fn = tsteps.make_pair_grad_fn(tmodel, specs, cfg,
                                       "hardest_contrastive", CFG)
    opt = tsteps.make_optimizer(tmodel.parameters(), cfg)
    stepper = tsteps.AccumStepper(opt, grad_fn, 2, "fcgf")
    for i, (batch, d) in enumerate(zip(batches, draws)):
        m = stepper(0.1, *batch, draws=d)
        assert np.isfinite(float(m["loss"])) and float(m["loss"]) > 0
        assert stepper.boundary == (i == 1)
        if i == 0:
            assert all(torch.equal(p, p0[n])
                       for n, p in tmodel.named_parameters())
    for n, p in tmodel.named_parameters():
        # first SGD step: buf = g + wd * p0; p = p0 - lr * buf
        g = (grads[0][n] + grads[1][n]) / 2 + WD * p0[n]
        assert_close_to_max(to_np(p), to_np(p0[n] - 0.1 * g), 1e-5, n)
