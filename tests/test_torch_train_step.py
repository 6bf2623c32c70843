"""The port's train step against gcl_tpu: model gradients in train mode,
two whole GCL steps without jitter (loss terms, gradients, parameters,
momentum buffers, BN running stats after each), one step's gradients
with the exact input jitter on a pinned eps, one step with the hash-grid
group search (search_cell set), gradient accumulation over two
micro-batches (AccumStepper, with the location loss and the membership
filter), the distance-error validation step, and the explicit route: a
whole step over index tables at 2 x 3 clouds (against gcl_tpu's 'auto',
which is the explicit route off a TPU), its conv1 under the literal input
jitter, and a whole step at 5 x 7 = 35 clouds, above the implicit route's
31 (gcl_tpu's graph pinned to method='bsearch' there: its 'auto' loses the
clouds from 31 on off a TPU, see tests/test_torch_join_kmap.py).

JAX runs on the CPU in float32 through its XLA route (sort-join maps, the
scan sparse_conv with its reverse-map VJP, the brute-force radius_knn);
where search_cell is set its group search runs the Pallas windowed top-k
kernel in interpret mode (data.device_pipeline.FORCE_INTERPRET).
The two packages cannot share a generator: the tests replay gcl_tpu's key
splits (train/steps.py, losses/gcl.py) and hand the port the same
uniforms.

Tolerances. Gradients, momentum buffers and parameters pass through 23
convs and 21 batch norms whose float32 sums run in another order in the
two packages (per-offset matmuls here, XLA's scan there): each tensor
within 1e-3 of its max (measured: a few 1e-6). Loss terms: 1e-5 absolute.
BN running stats: rtol = atol = 1e-4.

The gradient of a ReLU network is not continuous in its activations: one
pre-activation within rounding (~1e-6) of zero that falls on the other
side in the other package moves a whole channel's gradient by percents of
the tensor's max on these few hundred rows (seen here: a pre-activation of
-4e-8 against +6e-7, 2.6% on one channel of block3.conv1.kernel). No
tolerance short of that absorbs it, so the seeds below are ones where no
gradient-carrying ReLU sits that close to zero, and torch runs on one
thread so that its sums do not depend on the machine's core count.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcl_tpu.core.kernel_maps import build_graph as j_build_graph
from gcl_tpu.data import device_pipeline as jdp
from gcl_tpu.losses import gcl as jgcl
from gcl_tpu.models.resunet import ResUNetFatBN as JFatBN
from gcl_tpu.train import steps as jsteps
from gcl_tpu_torch.core.kernel_maps import default_level_caps
from gcl_tpu_torch.core.sparse_ops import draw_input_eps
from gcl_tpu_torch.losses.gcl import GCLLossConfig
from gcl_tpu_torch.models.resunet import ResUNetFatBN
from gcl_tpu_torch.models.weights import (flatten_tree, gradients_by_name,
                                          momentum_by_name,
                                          random_state_dict,
                                          state_dict_to_flax)
from gcl_tpu_torch.train import steps as tsteps

from _torch_parity import (VOXEL, assert_close_to_max, clouds, fatbn_specs,
                           jax_specs, replay_loss_draws, strides_of, to_np)

B, C, P, NV = 2, 3, 600, 320
N = B * C * NV
MAX_POS, MAX_HN = 64, 96
SIGMA = 0.01
REL = 1e-3
WD, MOM = 1e-4, 0.8
LRS = (0.01, 0.02)  # lr arrives per step


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed):
    """(points [B, C, P, 3], pmask, transforms [B, C, 4, 4], radius [B]):
    each neighbour cloud is its sample's centre scene seen from the
    neighbour's pose, resampled with noise."""
    centre, pmask = clouds(seed, B, P)
    rng = np.random.RandomState(seed + 1)
    transforms = np.broadcast_to(np.eye(4, dtype=np.float32),
                                 (B, C, 4, 4)).copy()
    pts = np.empty((B, C, P, 3), np.float32)
    for b in range(B):
        for c in range(C):
            if c:
                a = rng.uniform(-0.2, 0.2)
                transforms[b, c, :2, :2] = [[np.cos(a), -np.sin(a)],
                                            [np.sin(a), np.cos(a)]]
                transforms[b, c, :3, 3] = rng.uniform(-1.5, 1.5, 3) * [1, 1,
                                                                       0.1]
            world = centre[b] + rng.randn(P, 3).astype(np.float32) * 0.05
            r, t = transforms[b, c, :3, :3], transforms[b, c, :3, 3]
            pts[b, c] = (world - t) @ r
    pmask = (np.repeat(pmask[:, None], C, axis=1)
             & (rng.rand(B, C, P) > 0.1))
    return pts, pmask, transforms, np.array([0.45, 0.6], np.float32)


def _jax_model():
    return JFatBN(1, 32, bn_momentum=0.05, normalize_feature=True,
                  conv1_kernel_size=5, D=3)


def _port_model(state):
    model = ResUNetFatBN(1, 32, bn_momentum=0.05, normalize_feature=True,
                         conv1_kernel_size=5, D=3)
    model.load_state_dict(state)
    return model


def _caps():
    return default_level_caps(N, strides_of(fatbn_specs()), 0.7)


def _step_cfg(mod, **kw):
    return mod.StepConfig(**{**dict(
        voxel_size=VOXEL, nv_cap=NV, level_caps=_caps(), knn_chunk=128,
        search_cell=None, momentum=MOM, weight_decay=WD), **kw})


@pytest.fixture
def grid_interpret(monkeypatch):
    """gcl_tpu's group search with a cell takes its Pallas kernel in
    interpret mode (off a TPU it would fall to grid_radius_knn)."""
    monkeypatch.setattr(jdp, "FORCE_INTERPRET", True)


def _compare_trees(got: dict, want_tree, rel=REL, what=""):
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, want_tree))
    assert got.keys() == want.keys(), what
    for name in want:
        assert_close_to_max(to_np(got[name]), want[name], rel,
                            f"{what} {name}")


def _compare_stats(model, want_tree):
    _, stats = state_dict_to_flax(model.state_dict())
    got, want = flatten_tree(stats), flatten_tree(
        jax.tree_util.tree_map(np.asarray, want_tree))
    assert got.keys() == want.keys() and len(want) == 2 * 21
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                   atol=1e-4, err_msg=name)


@pytest.fixture(scope="module")
def weights():
    state = random_state_dict(_port_model_shapes(), seed=3)
    return state, state_dict_to_flax(state)


def _port_model_shapes():
    return ResUNetFatBN(1, 32, bn_momentum=0.05, normalize_feature=True,
                        conv1_kernel_size=5, D=3)


@pytest.fixture(scope="module")
def oracle():
    """gcl_tpu's gradients from public pieces, one jit: the geometry of
    make_gcl_grad_fn, model.apply(graph, 1 + eps, ones_exact=False) (the
    feature-reading route), then w_sq * sum of squares against a fixed
    matrix + w_gcl * the finest contrastive loss."""
    model, specs, caps = _jax_model(), jax_specs(fatbn_specs()), _caps()
    cfg = jgcl.GCLLossConfig(block_finest_gradient=False)

    def run(params, stats, points, pmask, transforms, radius, eps, target,
            key, w_sq, w_gcl):
        vox = jdp.voxelize_per_cloud(points.reshape(B * C, P, 3),
                                     pmask.reshape(B * C, P), VOXEL, NV)
        vox_b = jax.tree_util.tree_map(
            lambda x: x.reshape((B, C) + x.shape[1:]), vox)
        groups = jdp.batch_colocation_groups(vox_b, transforms, radius, k=5,
                                             chunk=128, cell=None)
        flat = vox.flatten()
        graph = j_build_graph(flat.coords, flat.mask, specs, caps,
                              sorted_blocks=True, n_clouds=B * C)
        aligned = jax.vmap(jax.vmap(jdp.transform_points))(vox_b.xyz,
                                                           transforms)
        nf = jgcl.SpatialNegFilter(
            aligned.reshape(-1, 3),
            jnp.repeat(jnp.arange(B, dtype=jnp.int32), C * NV), radius)

        def loss(params):
            f, mut = model.apply({"params": params, "batch_stats": stats},
                                 graph, flat.feats + eps, train=True,
                                 ones_exact=False, mutable=["batch_stats"])
            out = jgcl.finest_contrastive_loss(f, flat.mask, groups, nf,
                                               None, key, MAX_POS, MAX_HN,
                                               cfg)
            sq = jnp.sum(((f - target) * flat.mask[:, None]) ** 2)
            gcl = out.pos_loss + out.finest_loss + out.neg_loss
            return w_sq * sq + w_gcl * gcl, (out, mut["batch_stats"], f)

        (total, aux), grads = jax.value_and_grad(loss, has_aux=True)(params)
        return total, aux, grads

    return jax.jit(run)


def _port_geometry(batch):
    """The port's flat voxels and graph of a batch, as grad_fn builds
    them."""
    from gcl_tpu_torch.core.kernel_maps import build_graph
    from gcl_tpu_torch.data.device_pipeline import voxelize_per_cloud

    pts, pmask = torch.from_numpy(batch[0]), torch.from_numpy(batch[1])
    vox = voxelize_per_cloud(pts.reshape(B * C, P, 3),
                             pmask.reshape(B * C, P), VOXEL, NV)
    flat = vox.flatten()
    return flat, build_graph(flat.coords, flat.mask, fatbn_specs(), _caps(),
                             B * C)


def test_model_gradients_match_flax(weights, oracle):
    """Train-mode ResUNetFatBN, loss = sum of squares of (features - a
    fixed random matrix) over valid rows: every parameter gradient and
    every BN running stat."""
    state, (params, stats) = weights
    batch = _batch(31)
    target = np.random.RandomState(0).randn(N, 32).astype(np.float32) * 0.2
    _, (_, new_stats, f_ref), grads = oracle(
        params, stats, *map(jnp.asarray, batch), jnp.zeros((N, 1)),
        jnp.asarray(target), jax.random.PRNGKey(0), 1.0, 0.0)

    model = _port_model(state).train()
    flat, graph = _port_geometry(batch)
    f = model(graph, flat.feats)
    assert f.grad_fn is not None
    (((f - torch.from_numpy(target)) * flat.mask[:, None]) ** 2).sum(
        ).backward()
    np.testing.assert_allclose(to_np(f), np.asarray(f_ref), rtol=0,
                               atol=2e-4)
    got = gradients_by_name(model)
    assert len(got) == 66 and all(g is not None for g in got.values())
    _compare_trees(got, grads, what="grad")
    _compare_stats(model, new_stats)
    # padded rows reach no gradient: final's bias sums valid rows only
    assert float(got["final.bias"].abs().max()) > 0


def test_two_train_steps_without_jitter_match_jax(weights):
    """make_gcl_train_step(jitter=False), search_cell=None, two steps from
    one key. Also proves optax.chain(add_decayed_weights, trace) followed
    by p -= lr * u equal to torch.optim.SGD: gcl_tpu returns no gradients,
    so they are read back from its momentum trace (trace_1 = g_1 + wd *
    p_0; trace_2 = mom * trace_1 + g_2 + wd * p_1).

    The learning rates are small on purpose. After a large step gcl_tpu's
    own float32 gradient was seen to leave the float64 value by 16% on a
    single channel of one conv (lr 0.1 or 0.001 on this batch, second
    step) while the port's float32 gradient stayed within 2e-6 of it:
    test_float32_gradients_match_float64 holds the port to that."""
    state, (params, stats) = weights
    batch = _batch(41)
    loss_args = dict(max_pos_cluster=MAX_POS, max_hn_samples=MAX_HN,
                     pos_weight=1.0, finest_weight=1.0, neg_weight=1.0)
    tx, jstep = jsteps.make_gcl_train_step(
        _jax_model(), jax_specs(fatbn_specs()), _step_cfg(jsteps),
        jgcl.GCLLossConfig(block_finest_gradient=False), "finest",
        jitter=False, **loss_args)
    jstate = jsteps.TrainState(params, stats, tx.init(params),
                               jax.random.PRNGKey(7),
                               jnp.zeros((), jnp.int32))

    model = _port_model(state)
    opt, step = tsteps.make_gcl_train_step(
        model, fatbn_specs(), _step_cfg(tsteps),
        GCLLossConfig(block_finest_gradient=False), "finest", jitter=False,
        **loss_args)
    tbatch = tuple(torch.from_numpy(a) for a in batch)
    jbatch = tuple(jnp.asarray(a) for a in batch)

    def tree_np(t):
        return flatten_tree(jax.tree_util.tree_map(np.asarray, t))

    for i in range(2):
        # replay steps.py: rng, k = split(rng); k_loss, _ = split(k)
        _, k = jax.random.split(jstate.rng)
        k_loss, _ = jax.random.split(k)
        draws = tsteps.StepDraws(loss=replay_loss_draws(k_loss, B * NV, N,
                                                        MAX_POS, MAX_HN))
        prev_p, prev_m = tree_np(jstate.params), tree_np(jstate.opt_state[1]
                                                         .trace)
        jstate, jm = jstep(jstate, LRS[i], *jbatch)
        tm = step(LRS[i], *tbatch, draws=draws)
        for name in ("loss", "pos_loss", "finest_loss", "neg_loss"):
            assert float(jm[name]) > 1e-3, name
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=0, atol=1e-5,
                                       err_msg=f"step {i} {name}")
        for name in ("num_groups", "num_valid_voxels"):
            assert float(tm[name]) == float(jm[name]) > 0
        trace = tree_np(jstate.opt_state[1].trace)
        jgrads = {n: trace[n] - MOM * prev_m[n] - WD * prev_p[n]
                  for n in trace}
        got = gradients_by_name(model)
        for name, want in jgrads.items():
            assert_close_to_max(to_np(got[name]), want, REL,
                                f"step {i} grad {name}")
        _compare_trees(momentum_by_name(model, opt),
                       jstate.opt_state[1].trace, what=f"step {i} momentum")
        _compare_trees(dict(model.named_parameters()), jstate.params,
                       rel=1e-4, what=f"step {i} param")
        _compare_stats(model, jstate.batch_stats)
    assert int(jstate.step) == 2


def test_float32_gradients_match_float64(weights, monkeypatch):
    """The second of two lr = 0.1 steps: the port's float32 gradients
    against the same step in float64 (plain versions, which take any
    float type), each tensor within 1e-4 of its max."""
    from gcl_tpu_torch import kernels
    from gcl_tpu_torch.core import sparse_ops

    state, _ = weights
    tbatch = tuple(torch.from_numpy(a) for a in _batch(41))
    args = (fatbn_specs(), _step_cfg(tsteps),
            GCLLossConfig(block_finest_gradient=False), "finest", MAX_POS,
            MAX_HN, 1.0, 1.0, 1.0)
    gen = torch.Generator().manual_seed(0)
    draws = [tsteps.StepDraws(loss=tsteps.LossDraws(
        torch.rand(MAX_POS, generator=gen), torch.rand(MAX_HN, generator=gen),
        torch.rand(MAX_HN, generator=gen))) for _ in range(2)]
    model = _port_model(state)
    _, step = tsteps.make_gcl_train_step(model, *args, jitter=False)
    step(0.1, *tbatch, draws=draws[0])
    after_one = {k: v.clone() for k, v in model.state_dict().items()}
    m32 = step(0.1, *tbatch, draws=draws[1])
    g32 = {k: v.clone() for k, v in gradients_by_name(model).items()}

    for fn, plain in kernels.KERNELS.values():
        if hasattr(sparse_ops, fn.__name__):   # the conv kernels
            monkeypatch.setattr(sparse_ops, fn.__name__, plain)
    monkeypatch.setattr(sparse_ops, "_require_f32", lambda *a: None)
    m64 = _port_model(after_one).double()
    forward = m64.forward
    monkeypatch.setattr(m64, "forward", lambda graph, feats, **kw: forward(
        graph, feats.double(), **kw))
    out = tsteps.make_gcl_grad_fn(m64, *args, jitter=False)(
        *tbatch, draws=draws[1])
    np.testing.assert_allclose(float(m32["loss"]), float(out["loss"]),
                               rtol=0, atol=1e-5)
    for name, g in gradients_by_name(m64).items():
        assert g.dtype == torch.float64
        assert_close_to_max(to_np(g32[name]), to_np(g), 1e-4, name)


def test_train_step_with_exact_jitter_matches_jax(weights, oracle):
    """jitter=True with pinned draws: the port splits conv1 into the
    presence conv and the scalar eps conv; gcl_tpu's oracle feeds 1 + eps
    through the feature-reading conv. Sample 1's gate is closed."""
    state, (params, stats) = weights
    batch = _batch(54)
    key = jax.random.PRNGKey(13)
    rng = np.random.RandomState(5)
    normal = torch.from_numpy(rng.randn(N, 1).astype(np.float32))
    gate_u = torch.tensor([0.5, 0.99])  # jitter_p = 0.95: sample 1 is off

    model = _port_model(state)
    grad_fn = tsteps.make_gcl_grad_fn(
        model, fatbn_specs(), _step_cfg(tsteps),
        GCLLossConfig(block_finest_gradient=False), "finest", MAX_POS,
        MAX_HN, 1.0, 1.0, 1.0, jitter=True)
    draws = tsteps.StepDraws(
        sample_gate_u=gate_u, jitter=(torch.tensor(0.3), normal),
        loss=replay_loss_draws(key, B * NV, N, MAX_POS, MAX_HN))
    tm = grad_fn(*(torch.from_numpy(a) for a in batch), draws=draws)

    # the same eps for the oracle, from the port's own draw function
    flat, _ = _port_geometry(batch)
    cloud = flat.coords[:, 0]
    rows = ((cloud % C == 0) & (cloud // C == 0)).to(torch.float32)
    eps = draw_input_eps(None, SIGMA, 1.0, flat.mask, rows,
                         gate_u=torch.tensor(0.3), normal=normal)
    assert 50 < int((eps != 0).sum()) <= NV
    total, (out, new_stats, _), grads = oracle(
        params, stats, *map(jnp.asarray, batch), jnp.asarray(to_np(eps)),
        jnp.zeros((N, 32)), key, 0.0, 1.0)
    np.testing.assert_allclose(float(tm["loss"]), float(total), rtol=0,
                               atol=1e-5)
    for name in ("pos_loss", "finest_loss", "neg_loss"):
        np.testing.assert_allclose(float(tm[name]), float(getattr(out, name)),
                                   rtol=0, atol=1e-5, err_msg=name)
    got = gradients_by_name(model)
    _compare_trees(got, grads, what="jitter grad")
    _compare_stats(model, new_stats)
    # the jitter is visible: conv1's gradient differs from the jitter-free
    # one by more than the tolerance
    clean = _port_model(state)
    tsteps.make_gcl_grad_fn(
        clean, fatbn_specs(), _step_cfg(tsteps),
        GCLLossConfig(block_finest_gradient=False), "finest", MAX_POS,
        MAX_HN, 1.0, 1.0, 1.0, jitter=False)(
            *(torch.from_numpy(a) for a in batch), draws=draws)
    g0, g1 = clean.conv1.kernel.grad, got["conv1.kernel"]
    assert float((g0 - g1).abs().max()) > 1e-2 * float(g0.abs().max())


LOSS_ARGS = dict(max_pos_cluster=MAX_POS, max_hn_samples=MAX_HN,
                 pos_weight=1.0, finest_weight=1.0, neg_weight=1.0)


def _tree_np(t):
    return flatten_tree(jax.tree_util.tree_map(np.asarray, t))


def _loss_draws(k, kind="finest"):
    """The loss's uniforms as gcl_tpu's grad_fn draws them from its key k
    (k_loss, _ = split(k))."""
    k_loss, _ = jax.random.split(k)
    d = replay_loss_draws(k_loss, B * NV, N, MAX_POS, MAX_HN)
    return tsteps.StepDraws(loss=d)


def test_train_step_on_the_grid_matches_jax(weights, grid_interpret):
    """search_cell = 1.2 (radii 0.45 and 0.6 = cell / 2): the groups come
    out in home-cell order in both packages, so the pinned group picks
    select the same groups. Loss terms, gradients (from the momentum
    trace), momentum, parameters and BN stats after one step."""
    state, (params, stats) = weights
    batch = _batch(41)
    cfg_kw = dict(search_cell=1.2)
    tx, jstep = jsteps.make_gcl_train_step(
        _jax_model(), jax_specs(fatbn_specs()), _step_cfg(jsteps, **cfg_kw),
        jgcl.GCLLossConfig(block_finest_gradient=False), "finest",
        jitter=False, **LOSS_ARGS)
    jstate = jsteps.TrainState(params, stats, tx.init(params),
                               jax.random.PRNGKey(9),
                               jnp.zeros((), jnp.int32))
    model = _port_model(state)
    opt, step = tsteps.make_gcl_train_step(
        model, fatbn_specs(), _step_cfg(tsteps, **cfg_kw),
        GCLLossConfig(block_finest_gradient=False), "finest", jitter=False,
        **LOSS_ARGS)
    _, k = jax.random.split(jstate.rng)
    prev_p = _tree_np(jstate.params)
    jstate, jm = jstep(jstate, LRS[0], *(jnp.asarray(a) for a in batch))
    tm = step(LRS[0], *(torch.from_numpy(a) for a in batch),
              draws=_loss_draws(k))
    for name in ("loss", "pos_loss", "finest_loss", "neg_loss"):
        assert float(jm[name]) > 1e-3, name
        np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=0,
                                   atol=1e-5, err_msg=name)
    for name in ("num_groups", "num_valid_voxels"):
        assert float(tm[name]) == float(jm[name]) > 0
    trace = _tree_np(jstate.opt_state[1].trace)
    got = gradients_by_name(model)
    for name, want in trace.items():   # trace_1 = g_1 + wd * p_0
        assert_close_to_max(to_np(got[name]), want - WD * prev_p[name], REL,
                            f"grad {name}")
    _compare_trees(momentum_by_name(model, opt), jstate.opt_state[1].trace,
                   what="momentum")
    _compare_trees(dict(model.named_parameters()), jstate.params, rel=1e-4,
                   what="param")
    _compare_stats(model, jstate.batch_stats)
    # the brute-force step finds the same number of groups in other slots
    model2 = _port_model(state)
    _, step2 = tsteps.make_gcl_train_step(
        model2, fatbn_specs(), _step_cfg(tsteps),
        GCLLossConfig(block_finest_gradient=False), "finest", jitter=False,
        **LOSS_ARGS)
    tm2 = step2(LRS[0], *(torch.from_numpy(a) for a in batch),
                draws=_loss_draws(k))
    assert float(tm2["num_groups"]) == float(tm["num_groups"])
    assert abs(float(tm2["loss"]) - float(tm["loss"])) > 1e-4


def test_accum_stepper_matches_jax(weights, grid_interpret):
    """iter_size = 2 with the location loss, the membership filter and the
    grid search: BN stats move after each micro-batch and the parameters do
    not; after the second, ONE SGD step on the mean gradient. The
    accumulator is a gradient tree: it is compared through the bridge's
    gradient-tree layout (flatten_tree) with gcl_tpu's."""
    state, (params, stats) = weights
    cfg_kw = dict(search_cell=1.2, neg_filter="membership", member_r_cap=8)
    loss_cfg = dict(block_finest_gradient=True)
    args = (MAX_POS, MAX_HN, 1.0, 1.0, 1.0)
    jcfg = _step_cfg(jsteps, **cfg_kw)
    jgrad = jsteps.make_gcl_grad_fn(
        _jax_model(), jax_specs(fatbn_specs()), jcfg,
        jgcl.GCLLossConfig(**loss_cfg), "location", *args, jitter=False)
    tx = jsteps.make_optimizer(jcfg)
    jstepper = jsteps.AccumStepper(tx, jgrad, 2)
    jstate = jsteps.TrainState(params, stats, tx.init(params),
                               jax.random.PRNGKey(11),
                               jnp.zeros((), jnp.int32))

    model = _port_model(state)
    tcfg = _step_cfg(tsteps, **cfg_kw)
    tgrad = tsteps.make_gcl_grad_fn(
        model, fatbn_specs(), tcfg, GCLLossConfig(**loss_cfg), "location",
        *args, jitter=False)
    opt = tsteps.make_optimizer(model.parameters(), tcfg)
    stepper = tsteps.AccumStepper(opt, tgrad, 2)
    names = [n for n, _ in model.named_parameters()]

    p0 = {k: v.clone() for k, v in model.named_parameters()}
    for i, seed in enumerate((41, 31)):
        batch = _batch(seed)
        _, k = jax.random.split(jstate.rng)
        jstate, jm = jstepper(jstate, LRS[0],
                              *(jnp.asarray(a) for a in batch))
        tm = stepper(LRS[0], *(torch.from_numpy(a) for a in batch),
                     draws=_loss_draws(k))
        assert float(tm["finest_loss"]) == float(jm["finest_loss"]) == 0
        for name in ("loss", "pos_loss", "neg_loss"):
            assert float(jm[name]) > 1e-3, name
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=0, atol=1e-5,
                                       err_msg=f"micro {i} {name}")
        _compare_stats(model, jstate.batch_stats)
        assert stepper.boundary == jstepper.boundary == (i == 1)
        if i == 0:
            assert all(torch.equal(p, p0[n])
                       for n, p in model.named_parameters())
            _compare_trees(dict(zip(names, stepper.accumulated)),
                           jstepper._acc, what="accumulator")
    assert int(jstate.step) == 1
    _compare_trees(momentum_by_name(model, opt), jstate.opt_state[1].trace,
                   what="momentum")
    _compare_trees(dict(model.named_parameters()), jstate.params, rel=1e-4,
                   what="param")
    assert not torch.equal(model.conv1.kernel, p0["conv1.kernel"])


def test_dist_err_step_matches_jax(weights, grid_interpret):
    """make_dist_err_step (eval mode, the same group search): the mask
    equal, the distance offsets within 1e-5 m and the feature errors of
    unit-norm features within 2e-4 where the mask holds."""
    state, (params, stats) = weights
    batch = _batch(54)
    jdiag = jsteps.make_dist_err_step(
        _jax_model(), jax_specs(fatbn_specs()),
        _step_cfg(jsteps, search_cell=1.2))
    jd, jf, jmask = (np.asarray(a) for a in jdiag(
        params, stats, *(jnp.asarray(a) for a in batch)))
    model = _port_model(state).train()
    diag = tsteps.make_dist_err_step(model, fatbn_specs(),
                                     _step_cfg(tsteps, search_cell=1.2))
    d, f, mask = (to_np(a) for a in diag(
        *(torch.from_numpy(a) for a in batch)))
    assert not model.training
    np.testing.assert_array_equal(mask, jmask)
    assert d.shape == jd.shape == (B * NV * C * 5,) and mask.sum() > 500
    np.testing.assert_allclose(d[mask], jd[mask], rtol=0, atol=1e-5)
    np.testing.assert_allclose(f[mask], jf[mask], rtol=0, atol=2e-4)
    assert np.abs(jd[mask]).max() > 0.5 and jf[mask].max() > 0.05


def _one_step_against_jax(state, params, stats, batch, jcfg, tcfg, key,
                          n_groups, n_rows):
    """One jitter-free 'finest' step in both packages from one key: loss
    terms, gradients (read back from gcl_tpu's momentum trace: trace_1 =
    g_1 + wd * p_0), momentum, parameters and BN stats."""
    tx, jstep = jsteps.make_gcl_train_step(
        _jax_model(), jax_specs(fatbn_specs()), jcfg,
        jgcl.GCLLossConfig(block_finest_gradient=False), "finest",
        jitter=False, **LOSS_ARGS)
    jstate = jsteps.TrainState(params, stats, tx.init(params), key,
                               jnp.zeros((), jnp.int32))
    model = _port_model(state)
    opt, step = tsteps.make_gcl_train_step(
        model, fatbn_specs(), tcfg,
        GCLLossConfig(block_finest_gradient=False), "finest", jitter=False,
        **LOSS_ARGS)
    _, k = jax.random.split(jstate.rng)
    k_loss, _ = jax.random.split(k)
    draws = tsteps.StepDraws(loss=replay_loss_draws(k_loss, n_groups, n_rows,
                                                    MAX_POS, MAX_HN))
    prev_p = _tree_np(jstate.params)
    jstate, jm = jstep(jstate, LRS[0], *(jnp.asarray(a) for a in batch))
    tm = step(LRS[0], *(torch.from_numpy(a) for a in batch), draws=draws)
    for name in ("loss", "pos_loss", "finest_loss", "neg_loss"):
        assert float(jm[name]) > 1e-3, name
        np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=0,
                                   atol=1e-5, err_msg=name)
    for name in ("num_groups", "num_valid_voxels"):
        assert float(tm[name]) == float(jm[name]) > 0
    trace = _tree_np(jstate.opt_state[1].trace)
    got = gradients_by_name(model)
    assert len(got) == 66
    for name, want in trace.items():
        assert_close_to_max(to_np(got[name]), want - WD * prev_p[name], REL,
                            f"grad {name}")
    _compare_trees(momentum_by_name(model, opt), jstate.opt_state[1].trace,
                   what="momentum")
    _compare_trees(dict(model.named_parameters()), jstate.params, rel=1e-4,
                   what="param")
    _compare_stats(model, jstate.batch_stats)
    return tm


def test_explicit_route_train_step_matches_jax(weights, monkeypatch):
    """graph_method='explicit' at 2 x 3 clouds: every conv runs over an
    index table (K12 forward; K12 through the reverse table and K8
    backward), conv1 reading its all-ones features. gcl_tpu's 'auto' is
    the explicit route on the CPU (sort-join tables on the same blocked
    levels)."""
    from gcl_tpu_torch.core import sparse_ops

    state, (params, stats) = weights
    calls = {}
    for name in ("sparse_conv_table_fwd", "sparse_conv_dw",
                 "sparse_conv_implicit_fwd", "occupancy_conv_fwd"):
        real = getattr(sparse_ops, name)
        monkeypatch.setattr(
            sparse_ops, name, lambda *a, _r=real, _n=name, **kw: (
                calls.__setitem__(_n, calls.get(_n, 0) + 1) or _r(*a, **kw)))
    tm = _one_step_against_jax(
        state, params, stats, _batch(41), _step_cfg(jsteps),
        _step_cfg(tsteps, graph_method="explicit"), jax.random.PRNGKey(7),
        B * NV, N)
    # 21 forwards + 20 dX (conv1's input asks for none); 21 dW
    assert calls == {"sparse_conv_table_fwd": 41, "sparse_conv_dw": 21}
    # the implicit route gives the same step to rounding
    model = _port_model(state)
    _, step = tsteps.make_gcl_train_step(
        model, fatbn_specs(), _step_cfg(tsteps),
        GCLLossConfig(block_finest_gradient=False), "finest", jitter=False,
        **LOSS_ARGS)
    _, k = jax.random.split(jax.random.PRNGKey(7))
    tm2 = step(LRS[0], *(torch.from_numpy(a) for a in _batch(41)),
               draws=_loss_draws(k))
    assert abs(float(tm2["loss"]) - float(tm["loss"])) < 1e-5
    assert calls["sparse_conv_implicit_fwd"] == 20


def test_explicit_route_input_jitter_matches_jax(weights, oracle):
    """jitter=True on the explicit route: conv1 is off the occupancy path,
    so it adds the literal input jitter to its features and reads them
    (models.common.SparseConv). gcl_tpu's oracle feeds 1 + eps through
    its feature-reading conv, eps from the same pinned draws."""
    state, (params, stats) = weights
    batch = _batch(54)
    key = jax.random.PRNGKey(13)
    normal = torch.from_numpy(
        np.random.RandomState(5).randn(N, 1).astype(np.float32))
    gate_u = torch.tensor([0.5, 0.99])  # jitter_p = 0.95: sample 1 is off
    model = _port_model(state)
    grad_fn = tsteps.make_gcl_grad_fn(
        model, fatbn_specs(), _step_cfg(tsteps, graph_method="explicit"),
        GCLLossConfig(block_finest_gradient=False), "finest", MAX_POS,
        MAX_HN, 1.0, 1.0, 1.0, jitter=True)
    draws = tsteps.StepDraws(
        sample_gate_u=gate_u, jitter=(torch.tensor(0.3), normal),
        loss=replay_loss_draws(key, B * NV, N, MAX_POS, MAX_HN))
    tm = grad_fn(*(torch.from_numpy(a) for a in batch), draws=draws)
    flat, _ = _port_geometry(batch)
    cloud = flat.coords[:, 0]
    rows = ((cloud % C == 0) & (cloud // C == 0)).to(torch.float32)
    eps = draw_input_eps(None, SIGMA, 1.0, flat.mask, rows,
                         gate_u=torch.tensor(0.3), normal=normal)
    total, (out, new_stats, _), grads = oracle(
        params, stats, *map(jnp.asarray, batch), jnp.asarray(to_np(eps)),
        jnp.zeros((N, 32)), key, 0.0, 1.0)
    np.testing.assert_allclose(float(tm["loss"]), float(total), rtol=0,
                               atol=1e-5)
    for name in ("pos_loss", "finest_loss", "neg_loss"):
        np.testing.assert_allclose(float(tm[name]), float(getattr(out, name)),
                                   rtol=0, atol=1e-5, err_msg=name)
    _compare_trees(gradients_by_name(model), grads, what="jitter grad")
    _compare_stats(model, new_stats)
    # a generator draws noise of the same shape on this route
    gen = torch.Generator().manual_seed(1)
    tm2 = grad_fn(*(torch.from_numpy(a) for a in batch), generator=gen,
                  draws=tsteps.StepDraws(loss=draws.loss))
    assert bool(torch.isfinite(tm2["loss"]))
    assert abs(float(tm2["loss"]) - float(tm["loss"])) > 1e-7


def test_train_step_above_31_clouds_matches_jax(weights, monkeypatch):
    """5 x 7 = 35 tiny clouds: 'auto' leaves the implicit route (its packed
    keys fold cloud ids mod 31) for index tables over unblocked levels.
    gcl_tpu's step is pinned to method='bsearch' for the comparison (only
    in this test; nothing in the package changes)."""
    import functools
    from gcl_tpu.core.kernel_maps import build_graph as j_build

    monkeypatch.setattr(jsteps, "build_graph",
                        functools.partial(j_build, method="bsearch"))
    state, (params, stats) = weights
    b, c, p, nv = 5, 7, 140, 48
    n = b * c * nv
    centre, pmask = clouds(61, b, p)
    rng = np.random.RandomState(62)
    transforms = np.broadcast_to(np.eye(4, dtype=np.float32),
                                 (b, c, 4, 4)).copy()
    transforms[:, 1:, :2, 3] = rng.uniform(-1.0, 1.0, (b, c - 1, 2))
    pts = (centre[:, None] - transforms[:, :, None, :3, 3]
           + rng.randn(b, c, p, 3).astype(np.float32) * 0.05)
    pmask = np.repeat(pmask[:, None], c, axis=1) & (rng.rand(b, c, p) > 0.1)
    batch = (pts.astype(np.float32), pmask, transforms,
             np.full((b,), 0.5, np.float32))
    caps = default_level_caps(n, strides_of(fatbn_specs()), 0.9)
    kw = dict(nv_cap=nv, level_caps=caps)
    tm = _one_step_against_jax(
        state, params, stats, batch, _step_cfg(jsteps, **kw),
        _step_cfg(tsteps, **kw), jax.random.PRNGKey(3), b * nv, n)
    assert float(tm["num_valid_voxels"]) > 30 * 35


def test_c1z_jitter_step_runs(weights):
    """jitter_mode 'c1z' through the whole step, from a generator: finite
    loss, gradients on every parameter, and conv1's gradient differs from
    the jitter-free step's (its parity with gcl_tpu is held in
    test_torch_sparse_ops.py on pinned draws)."""
    state, _ = weights
    tbatch = tuple(torch.from_numpy(a) for a in _batch(54))
    gen = torch.Generator().manual_seed(0)
    draws = tsteps.StepDraws(
        sample_gate_u=torch.tensor([0.5, 0.99]),
        loss=tsteps.LossDraws(*(torch.rand(n, generator=gen)
                                for n in (MAX_POS, MAX_HN, MAX_HN))))
    grads = []
    for jitter in (True, False):
        model = _port_model(state)
        out = tsteps.make_gcl_grad_fn(
            model, fatbn_specs(),
            _step_cfg(tsteps, jitter_mode="c1z", jitter_sigma=0.05),
            GCLLossConfig(), "circle", MAX_POS, MAX_HN, 1.0, 1.0, 1.0,
            jitter=jitter)(*tbatch, generator=gen, draws=draws)
        assert all(bool(torch.isfinite(v)) for v in out.values())
        assert float(out["neg_loss"]) > 0 and float(out["finest_loss"]) > 0
        got = gradients_by_name(model)
        assert len(got) == 66 and all(
            bool(torch.isfinite(g).all()) for g in got.values())
        grads.append(got["conv1.kernel"])
    assert float((grads[0] - grads[1]).abs().max()) > 1e-3 * float(
        grads[1].abs().max())


def test_unported_options_raise():
    """(Kept under its first name.) What still is not ported raises, and an
    option's unknown value is a ValueError; the options ported since
    (jitter_mode 'c1z', neg_filter 'membership', the location and circle
    losses, search_cell, compute_dtype bfloat16) build. A compute type
    other than float32 and bfloat16 (float16) raises."""
    cfg = _step_cfg(tsteps)
    import dataclasses
    args = (GCLLossConfig(), "finest", 8, 8, 1.0, 1.0, 1.0)
    model = torch.nn.Linear(1, 1)
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        tsteps.make_gcl_grad_fn(
            model, fatbn_specs(),
            dataclasses.replace(cfg, compute_dtype=torch.float16), *args)
    for build in (tsteps.make_gcl_grad_fn, tsteps.make_dist_err_step):
        extra = args if build is tsteps.make_gcl_grad_fn else ()
        assert callable(build(
            model, fatbn_specs(),
            dataclasses.replace(cfg, compute_dtype=torch.bfloat16), *extra))
    for bad, match in ((dict(jitter_mode="output"), "jitter_mode"),
                       (dict(neg_filter="hash"), "neg_filter")):
        with pytest.raises(ValueError, match=match):
            tsteps.make_gcl_grad_fn(model, fatbn_specs(),
                                    dataclasses.replace(cfg, **bad), *args)
    with pytest.raises(ValueError, match="triplet"):
        tsteps.make_gcl_grad_fn(model, fatbn_specs(), cfg, GCLLossConfig(),
                                "triplet", 8, 8, 1.0, 1.0, 1.0)
    for ok in (dict(jitter_mode="c1z"), dict(neg_filter="membership"),
               dict(search_cell=1.2, member_r_cap=4)):
        for kind in ("finest", "location", "circle"):
            assert callable(tsteps.make_gcl_grad_fn(
                model, fatbn_specs(), dataclasses.replace(cfg, **ok),
                GCLLossConfig(), kind, 8, 8, 1.0, 1.0, 1.0))
