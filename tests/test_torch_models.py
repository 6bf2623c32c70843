"""Parity of gcl_tpu_torch's ResUNetFatBN with gcl_tpu's flax model, on one
set of seeded weights carried across by models.weights.

Tolerance 2e-4 abs on the L2-normalized float32 features: 20 sparse convs
and 21 norms sum the same products in another order (per-offset matmuls
vs XLA's scan), and the unit-norm outputs keep those rounding differences
well below 1e-4. BN running stats: rtol/atol 1e-4 for the same reason.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcl_tpu.models.resunet import ResUNetFatBN as JFatBN
from gcl_tpu_torch.core.kernel_maps import build_graph, default_level_caps
from gcl_tpu_torch.data.device_pipeline import voxelize_per_cloud
from gcl_tpu_torch.models.resunet import ResUNetFatBN
from gcl_tpu_torch.models.weights import (flax_to_state_dict,
                                          random_state_dict,
                                          state_dict_to_flax)

from _torch_parity import (VOXEL, clouds, fatbn_specs, jax_graph,
                           jax_specs, narrow_exp_classes, strides_of,
                           to_np)

NV = 384


def _jax_model():
    return JFatBN(1, 32, bn_momentum=0.05, normalize_feature=True,
                  conv1_kernel_size=5, D=3)


def _port_model():
    return ResUNetFatBN(1, 32, bn_momentum=0.05, normalize_feature=True,
                        conv1_kernel_size=5, D=3)


@pytest.fixture(scope="module")
def setup():
    specs = fatbn_specs()
    caps = default_level_caps(NV, strides_of(specs), 0.7)
    pts, pmask = clouds(11, 2, 600)
    vox = voxelize_per_cloud(torch.from_numpy(pts), torch.from_numpy(pmask),
                             VOXEL, NV)
    flat = vox.flatten()
    g = build_graph(flat.coords, flat.mask, specs, caps, 2)
    gj = jax_graph(to_np(flat.coords), to_np(flat.mask), specs, caps, 2)
    model = _port_model()
    state = random_state_dict(model, seed=3)
    model.load_state_dict(state)
    params, stats = state_dict_to_flax(state)
    return g, gj, to_np(flat.feats), model, params, stats


def test_weight_tree_matches_flax_and_round_trips():
    """The port's state_dict maps onto the flax variable tree by name with
    identical shapes, and back exactly."""
    cap = 64
    tcoords = np.zeros((cap, 4), np.int32)
    tcoords[:, 1] = np.arange(cap)
    from gcl_tpu.core.kernel_maps import build_graph as j_build
    specs = fatbn_specs()
    variables = jax.eval_shape(  # shapes only: nothing compiles
        lambda: _jax_model().init(
            jax.random.PRNGKey(0),
            j_build(jnp.asarray(tcoords), jnp.asarray(np.ones(cap, bool)),
                    jax_specs(specs), {s: cap for s in strides_of(specs)}),
            jnp.ones((cap, 1)), train=False))
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                    (variables["params"],
                                     variables["batch_stats"]))
    model = _port_model()
    state = random_state_dict(model, seed=0)
    params, stats = state_dict_to_flax(state)
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                  (params, stats)) == shapes
    back = flax_to_state_dict(params, stats)
    assert back.keys() == state.keys()
    for k in state:
        assert torch.equal(back[k], state[k])
    model.load_state_dict(back)


def test_eval_forward_matches_flax(setup):
    g, gj, feats, model, params, stats = setup
    model.eval()
    with torch.no_grad():
        out = to_np(model(g, torch.from_numpy(feats)))
    ref = jax.jit(lambda p, s, gr, f: _jax_model().apply(
        {"params": p, "batch_stats": s}, gr, f, train=False))(
        params, stats, gj, jnp.asarray(feats))
    ref = np.asarray(ref)
    assert out.shape == ref.shape == (2 * NV, 32)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-4)


def test_train_mode_bn_matches_flax(setup):
    """Train-mode forward (masked batch statistics) and the running-stat
    update (momentum 0.05, unbiased variance)."""
    g, gj, feats, _, params, stats = setup
    model = _port_model()
    model.load_state_dict(flax_to_state_dict(params, stats))
    model.train()
    with torch.no_grad():
        out = to_np(model(g, torch.from_numpy(feats)))
    ref, upd = jax.jit(lambda p, s, gr, f: _jax_model().apply(
        {"params": p, "batch_stats": s}, gr, f, train=True,
        mutable=["batch_stats"]))(params, stats, gj, jnp.asarray(feats))
    np.testing.assert_allclose(out, np.asarray(ref), rtol=0, atol=2e-4)
    _, new_stats = state_dict_to_flax(model.state_dict())
    flat_ref = jax.tree_util.tree_leaves_with_path(upd["batch_stats"])
    assert len(flat_ref) == 2 * 21  # 21 norms: mean + var each
    for path, leaf in flat_ref:
        node = new_stats
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, np.asarray(leaf), rtol=1e-4,
                                   atol=1e-4)
    assert not np.allclose(new_stats["norm1"]["mean"],
                           stats["norm1"]["mean"])


def test_exp_eval_forward_matches_flax():
    """A narrow ResUNetFatBNEXP (strides 1/3/9/27, k = 5 strided and
    transposed convs) in eval mode, weights carried across by
    flax_to_state_dict: features within 1e-4 (unit-norm outputs)."""
    jcls, tcls = narrow_exp_classes()
    specs = tcls.conv_specs(5)
    nv = 448
    caps = default_level_caps(nv, strides_of(specs), 0.6)
    pts, pmask = clouds(7, 2, 1500)
    vox = voxelize_per_cloud(torch.from_numpy(pts), torch.from_numpy(pmask),
                             VOXEL, nv)
    flat = vox.flatten()
    g = build_graph(flat.coords, flat.mask, specs, caps, 2)
    gj = jax_graph(to_np(flat.coords), to_np(flat.mask), specs, caps, 2)
    model = tcls(1, 32, bn_momentum=0.05, normalize_feature=True,
                 conv1_kernel_size=5, D=3)
    params, stats = state_dict_to_flax(random_state_dict(model, seed=4))
    model.load_state_dict(flax_to_state_dict(params, stats))
    model.eval()
    feats = to_np(flat.feats)
    with torch.no_grad():
        out = to_np(model(g, torch.from_numpy(feats)))
    jmodel = jcls(1, 32, bn_momentum=0.05, normalize_feature=True,
                  conv1_kernel_size=5, D=3)
    ref = np.asarray(jax.jit(lambda p, s, gr, f: jmodel.apply(
        {"params": p, "batch_stats": s}, gr, f, train=False))(
        params, stats, gj, jnp.asarray(feats)))
    assert out.shape == ref.shape == (2 * nv, 32)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
