"""The port's model zoo against gcl_tpu's (gcl_tpu/models): the registry,
every model's variables through the weights bridge, one train-mode forward
of each family, gradients of an instance-norm model and of
ResUNetFatBNEXP_V2, V2's levels and maps at strides 5 / 10 / 20 / 40, and
masked_instance_mean_var.

Three gcl_tpu names have no norm (NORM_TYPE None: ResUNet2, SimpleNet,
SimpleNet2, SimpleNet3) and raise "Type None, not defined" when built, in
both packages; their families are held here through ResUNetBN2 and
SimpleNetBN, the same layers with batch norm.

Tolerances. Forward features are L2-normalized; both packages sum the same
float32 products in another order, so features agree within 1e-5 and BN
running statistics within rtol = atol = 1e-5. Gradients: each tensor
within 1e-4 of its max (the seeds are ones where no ReLU input sits within
float32 rounding of zero, see tests/test_torch_train_step.py).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gcl_tpu.models as jmodels
from gcl_tpu.core import sparse_ops as jsparse
from gcl_tpu.core.kernel_maps import build_graph as j_build_graph
from gcl_tpu_torch import models as tmodels
from gcl_tpu_torch.core.kernel_maps import (ConvSpec, build_graph,
                                            default_level_caps)
from gcl_tpu_torch.core.sparse_ops import masked_instance_mean_var
from gcl_tpu_torch.models.weights import (flatten_tree, flax_to_state_dict,
                                          gradients_by_name,
                                          random_state_dict,
                                          state_dict_to_flax)

from _torch_parity import (assert_close_to_max, check_graph, jax_graph,
                           jax_map_refs, jax_specs,
                           one_torch_thread,  # noqa: F401
                           strides_of, to_np, voxelized)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NAMES = sorted(m.__name__ for m in jmodels.MODELS)
NO_NORM = ("ResUNet2", "SimpleNet", "SimpleNet2", "SimpleNet3")
HEAD_IN = 8  # the heads' input width


def _kind(name):
    if "Head" in name:
        return "head"
    return "mlp" if "MLP" in name else "sparse"


def _args(name):
    """(args, kwargs) that build ``name`` in either package."""
    if _kind(name) == "mlp":
        return (), dict(in_channel=24, out_points=4, bn_momentum=0.05)
    n_in = HEAD_IN if _kind(name) == "head" else 1
    return (n_in, 16), dict(bn_momentum=0.05, normalize_feature=True,
                            conv1_kernel_size=3, D=3)


_CAP = 64


@functools.lru_cache(maxsize=None)
def _abstract_graph(specs):
    """gcl_tpu's graph of a 64-row level for ``specs``, as shapes only
    (one trace a conv plan, shared by the models that have it)."""
    coords = np.zeros((_CAP, 4), np.int32)
    coords[:, 0] = np.arange(_CAP) // 16
    coords[:, 1] = np.arange(_CAP) % 16
    return jax.eval_shape(lambda: j_build_graph(
        jnp.asarray(coords), jnp.ones(_CAP, bool), jax_specs(specs),
        {s: _CAP for s in strides_of(specs)}))


def _flax_shapes(name):
    """gcl_tpu's variables of ``name`` as zeros of their init shapes
    (jax.eval_shape: nothing compiles)."""
    cls = jmodels.load_model(name)
    args, kw = _args(name)
    model = cls(*args, **kw)
    key = jax.random.PRNGKey(0)
    if _kind(name) == "mlp":
        v = jax.eval_shape(lambda: model.init(
            key, jnp.ones((4, kw["in_channel"])), train=False))
    else:
        v = jax.eval_shape(lambda g: model.init(
            key, g, jnp.ones((_CAP, args[0])), train=False),
            _abstract_graph(tuple(cls.conv_specs(3))))
    return [jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                                   v.get(c, {}))
            for c in ("params", "batch_stats")]


def test_registry_names_equal_gcl_tpu():
    assert sorted(m.__name__ for m in tmodels.MODELS) == NAMES
    assert len(NAMES) == 41
    for name in NAMES:
        assert tmodels.load_model(name).__name__ == name
        assert tmodels.load_model(name).__module__.startswith(
            "gcl_tpu_torch.models.")
    assert jmodels.load_model("NoSuchNet") is None
    with pytest.raises(ValueError, match="not registered"):
        tmodels.load_model("NoSuchNet")


@pytest.mark.parametrize("name", NAMES)
def test_state_dict_matches_flax_init(name):
    """The port's state_dict: the keys and shapes of flax_to_state_dict of
    gcl_tpu's init, and the bridge's round trip exact (the MLPs' dense
    kernels transposed into nn.Linear's weight and back)."""
    args, kw = _args(name)
    if name in NO_NORM:
        with pytest.raises(ValueError, match="Type None"):
            _flax_shapes(name)
        with pytest.raises(ValueError, match="Type None"):
            tmodels.load_model(name)(*args, **kw)
        return
    want = flax_to_state_dict(*_flax_shapes(name))
    model = tmodels.load_model(name)(*args, **kw)
    state = model.state_dict()
    assert state.keys() == want.keys()
    for k in want:
        assert tuple(state[k].shape) == tuple(want[k].shape), k
    if "IN" in name.replace("MLP", "") and "BN" not in name:
        assert not [k for k in state if "block" in k and k.endswith("mean")]
    rnd = random_state_dict(model, seed=1)
    back = flax_to_state_dict(*state_dict_to_flax(rnd))
    assert back.keys() == rnd.keys()
    for k in rnd:
        assert torch.equal(back[k], rnd[k]), k
    model.load_state_dict(back)


# --- forward and gradients --------------------------------------------

NV = 384
V2_CLOUDS = (3.0, 3000, 1536)  # (spread, points, voxel capacity) a cloud
FAMILIES = ("ResUNetBN2", "ResUNetBN2B", "ResUNetIN2", "ResUNetIN2E",
            "ResUNetFatBNEXP_V2", "SimpleNetBN", "SimpleNetIN2E",
            "SimpleNetBN3", "ProjectionHeadConv", "ProjectionHeadMLP",
            "GenerativeMLP")


def _sparse_inputs(name, seed):
    """(port graph, gcl_tpu graph, input features, mask) of two clouds;
    V2's clouds are spread wider and denser (V2_CLOUDS), so that its
    stride-40 level holds more than a few voxels a cloud."""
    specs = tmodels.load_model(name).conv_specs(3)
    scale, n_points, nv = V2_CLOUDS if "V2" in name else (1.0, 700, NV)
    coords, mask = voxelized(seed, 2, nv, n_points=n_points, scale=scale)
    caps = default_level_caps(nv, strides_of(specs), 0.7)
    g = build_graph(torch.from_numpy(coords), torch.from_numpy(mask), specs,
                    caps, 2)
    gj = jax_graph(coords, mask, specs, caps, 2)
    if _kind(name) == "head":
        feats = np.random.RandomState(seed).randn(len(mask), HEAD_IN)
    else:
        feats = np.ones((len(mask), 1))
    return g, gj, feats.astype(np.float32), mask


def _models(name, seed=3):
    args, kw = _args(name)
    model = tmodels.load_model(name)(*args, **kw)
    state = random_state_dict(model, seed)
    model.load_state_dict(state)
    params, stats = state_dict_to_flax(state)
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    return model, jmodels.load_model(name)(*args, **kw), variables


def _compare_stats(model, new_stats, rel=1e-5):
    _, stats = state_dict_to_flax(model.state_dict())
    got = flatten_tree(stats)
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, new_stats))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rel, atol=rel,
                                   err_msg=k)
    return len(want)


@pytest.mark.parametrize("name", FAMILIES)
def test_family_train_forward_matches_flax(name):
    """One train-mode forward of each family through the weights bridge:
    outputs within 1e-5, BN running statistics after it within 1e-5."""
    model, jmodel, variables = _models(name)
    model.train()
    if _kind(name) == "mlp":
        x = np.random.RandomState(0).randn(200, 24).astype(np.float32)
        with torch.no_grad():
            out = to_np(model(torch.from_numpy(x)))
        ref, upd = jax.jit(lambda v, x: jmodel.apply(
            v, x, train=True, mutable=["batch_stats"]))(variables, x)
        assert out.shape == (200, 12)
    else:
        g, gj, feats, mask = _sparse_inputs(name, 11)
        with torch.no_grad():
            out = to_np(model(g, torch.from_numpy(feats)))
        ref, upd = jax.jit(lambda v, gr, f: jmodel.apply(
            v, gr, f, train=True, mutable=["batch_stats"]))(
            variables, gj, jnp.asarray(feats))
        out, ref = out[mask], np.asarray(ref)[mask]
        assert out.shape == (int(mask.sum()), 16)
    assert np.isfinite(out).all() and float(np.abs(out).max()) > 0
    np.testing.assert_allclose(out, np.asarray(ref), rtol=0, atol=1e-5)
    n_stats = _compare_stats(model, upd.get("batch_stats", {}))
    assert (n_stats > 0) == ("IN" not in name and name != "ProjectionHeadConv"
                             or name.startswith("ResUNetIN"))


@pytest.mark.parametrize("name,seed", [("ResUNetIN2", 11),
                                       ("ResUNetFatBNEXP_V2", 12)])
def test_gradients_match_flax(name, seed):
    """Train mode, loss = sum of squares of (features - a fixed random
    matrix) over valid rows: every parameter's gradient within 1e-4 of its
    tensor's max, and the running statistics."""
    model, jmodel, variables = _models(name)
    g, gj, feats, mask = _sparse_inputs(name, seed)
    target = np.random.RandomState(0).randn(len(mask), 16).astype(np.float32)
    m = mask.astype(np.float32)[:, None]

    def loss(params, stats, gr, f):
        out, upd = jmodel.apply({"params": params, "batch_stats": stats},
                                gr, f, train=True, mutable=["batch_stats"])
        return jnp.sum(((out - target) * m) ** 2), upd["batch_stats"]

    (_, new_stats), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(variables["params"], variables["batch_stats"],
                             gj, jnp.asarray(feats))
    model.train()
    out = model(g, torch.from_numpy(feats))
    (((out - torch.from_numpy(target)) * torch.from_numpy(m)) ** 2).sum(
        ).backward()
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, grads))
    got = gradients_by_name(model)
    assert got.keys() == want.keys()
    for k in want:
        assert_close_to_max(to_np(got[k]), want[k], 1e-4, k)
    _compare_stats(model, new_stats, rel=1e-4)
    if "V2" in name:
        for conv in ("conv1_extra", "conv1_tr_extra"):
            assert float(got[f"{conv}.kernel"].abs().max()) > 0, conv


# --- V2's geometry -----------------------------------------------------

def test_v2_levels_and_maps_exact():
    """ResUNetFatBNEXP_V2's levels at strides 5 / 10 / 20 / 40 and every
    map, conv1_extra's (1 -> 5, k = 5, dilation 5) and conv1_tr_extra's
    (5 -> 1, dilation 4) among them, equal gcl_tpu's row for row; so do
    the reverse twins the backward walks, and each map's rqkey is its
    twin's qkey."""
    from gcl_tpu_torch.core.types import map_key
    from gcl_tpu_torch.models.resunet import ResUNetFatBNEXP_V2

    specs = ResUNetFatBNEXP_V2.conv_specs(5)
    assert strides_of(specs) == [1, 5, 10, 20, 40]
    assert ResUNetFatBNEXP_V2.encoder_strides() == (5, 10, 20, 40)
    assert [(s.name, s.in_stride, s.out_stride, s.kernel_size, s.dilation)
            for s in specs] == [
        (s.name, s.in_stride, s.out_stride, s.kernel_size, s.dilation)
        for s in jmodels.load_model("ResUNetFatBNEXP_V2").conv_specs(5)]
    nv = 512
    coords, mask = voxelized(4, 2, nv, n_points=1500, scale=5.0)
    caps = default_level_caps(nv, strides_of(specs), 0.7)
    g, gj = check_graph(coords, mask, specs, caps, 2)
    for s in (5, 10, 20, 40):
        assert int(to_np(g.levels[s].mask).sum()) >= 2 * (1 if s == 40
                                                          else 4), s
    twins = [ConvSpec(sp.name + "_rev", sp.out_stride, sp.in_stride,
                      sp.kernel_size, sp.dilation)
             for sp in specs if "extra" in sp.name]
    refs = jax_map_refs(gj, twins)
    for tw in twins:
        np.testing.assert_array_equal(to_np(g.maps[tw.key].qkey),
                                      refs[tw.key][0])
    for sp in specs:
        if not sp.is_identity_map:
            back = map_key(sp.out_stride, sp.in_stride, sp.kernel_size,
                           sp.dilation)
            assert g.maps[sp.key].rqkey is g.maps[back].qkey
    from gcl_tpu_torch.core.coords import lookup
    for sp in specs:
        if "extra" in sp.name:
            lv = g.levels[sp.in_stride]
            rows = to_np(lookup(lv.skeys, lv.srow, g.maps[sp.key].qkey))
            assert (rows >= 0).sum() > 0, sp.name


# --- instance statistics -----------------------------------------------

def test_masked_instance_mean_var_matches_gcl_tpu():
    """Per-cloud statistics with padding rows, an empty cloud (2) and
    valid rows whose cloud id is num_items (the extra segment) or above
    it (summed nowhere)."""
    rng = np.random.RandomState(0)
    n, c, num_items = 300, 5, 6
    feats = (rng.randn(n, c) * 3 + 1).astype(np.float32)
    bidx = rng.choice([0, 1, 3, 4, 5], n).astype(np.int32)
    bidx[:10] = num_items
    bidx[10:20] = num_items + 3
    mask = rng.rand(n) > 0.2
    mask[20:30] = False
    bidx[20:25] = 2**30  # padding rows carry the pad cloud id
    got = masked_instance_mean_var(torch.from_numpy(feats),
                                   torch.from_numpy(mask),
                                   torch.from_numpy(bidx), num_items)
    want = jax.jit(jsparse.masked_instance_mean_var, static_argnums=3)(
        jnp.asarray(feats), jnp.asarray(mask), jnp.asarray(bidx), num_items)
    for a, b, what in zip(got, want, ("mean", "var")):
        assert a.shape == (n, c)
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-6, err_msg=what)
    # cloud 2 has no row; ids above num_items read the extra segment
    extra = (bidx == num_items) & mask
    np.testing.assert_allclose(to_np(got[0])[10], feats[extra].mean(0),
                               rtol=1e-5)
    np.testing.assert_allclose(to_np(got[0])[15], to_np(got[0])[0])
