"""The bf16 forms of the conv kernels and the bf16 GCL step, against
gcl_tpu in bf16 on the CPU.

Kernels. Each plain bf16 version (the CPU side of K2, K3, K4, K5, K6, K7,
K8, K9 and K12) is held against gcl_tpu's Pallas body in bf16, run in
interpret mode (gcl_tpu.testing.kernel_interpret, interpret=True), on the
same bf16 inputs made from a numpy seed and float32 weights. Both sides
take bf16 products (bf16 weights for K2, K6, K7, K8, K12 and K9's dX
conv; K4 keeps its weights float32 in both) exactly in float32, sum them
in float32 in another order and round once. So a bf16 output (K2, K4,
K6, K7's dX, K9, K12) is required bit-equal on at least 99.9% of its
elements and within one bf16 ulp on the rest; a float32 dW (K3, K5, K7's
dW, K8 in both forms) within 1e-5 of its max.

Step. One GCL train step without jitter (make_gcl_train_step,
compute_dtype bfloat16, as root bench.py runs it) against gcl_tpu's bf16
step on the same batch and weights, through gcl_tpu's XLA route (the scan
sparse_conv in bf16 off a TPU). Per tensor -- the loss terms [loss, pos,
finest, neg] as one, each gradient (read back from gcl_tpu's momentum
trace), each BN running stat -- the gate is

    |port_bf16 - jax_bf16|max <= 2 |jax_bf16 - jax_f32|max + 1e-6:

the two packages may disagree in bf16 by no more than twice what bf16
itself moves the reference. Both packages round each conv once, but sum
in another order, so ~0.1% of a conv's outputs sit one ulp apart (the
kernel tests above); through 23 convs that grows into a difference of
the size of bf16's own (two bf16 runs differ by ~1.4x what either
differs from float32). The batch is tests/test_torch_train_step.py's
and its seed, which that file's docstring pins (no gradient-carrying ReLU
within rounding of zero in float32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcl_tpu_torch import kernels
from gcl_tpu_torch.core import sparse_ops
from gcl_tpu_torch.core.kernel_maps import ConvSpec, build_graph
from gcl_tpu_torch.data.device_pipeline import voxelize_per_cloud

from _torch_parity import (VOXEL, assert_bf16_close, assert_close_to_max,
                           bf16_ordered, clouds, jax_graph, to_np)

DW_REL = 1e-5
KEY = "s1->s1/k3d1"
N_ROWS = 256
CIN, COUT = 16, 32


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).to(torch.bfloat16)


def _j(t: torch.Tensor):
    """A torch tensor as a JAX array of the same values and type."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(to_np(t.float())).astype(jnp.bfloat16)
    return jnp.asarray(to_np(t))


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.fixture(scope="module")
def geo():
    """One cloud's stride-1 level, its k = 3 map on both packages (the
    port's implicit map and index table, gcl_tpu's fused map in interpret
    mode) and bf16 inputs."""
    from gcl_tpu.testing import kernel_interpret

    pts, pmask = clouds(8, 1, 300)
    flat = voxelize_per_cloud(torch.from_numpy(pts), torch.from_numpy(pmask),
                              VOXEL, N_ROWS).flatten()
    specs = [ConvSpec("b", 1, 1, 3)]
    gi = build_graph(flat.coords, flat.mask, specs, {}, 1)
    ge = build_graph(flat.coords, flat.mask, specs, {}, 1, method="explicit")
    with kernel_interpret():
        fm = jax_graph(to_np(flat.coords), to_np(flat.mask), specs, {},
                       1).fused[KEY]
    lv = gi.levels[1]
    mask = to_np(lv.mask).astype(np.float32)[:, None]
    rng = np.random.RandomState(2)
    return dict(
        lv=lv, cmap=gi.maps[KEY], kmap=ge.kmaps[KEY], fm=fm,
        x=_bf16(rng.randn(N_ROWS, CIN).astype(np.float32) * mask),
        w=torch.from_numpy((rng.randn(27, CIN, COUT) * 0.1)
                           .astype(np.float32)),
        up=_bf16(rng.randn(N_ROWS, COUT).astype(np.float32) * mask),
        eps=_bf16(rng.randn(N_ROWS, 1).astype(np.float32) * 0.01 * mask),
        w1=torch.from_numpy((rng.randn(27, 1, COUT) * 0.1)
                            .astype(np.float32)))


def _pallas(fn, *args, jit=True, **kw):
    """A gcl_tpu kernel call in interpret mode, back as numpy float32;
    jitted (one compile of the interpreted grid instead of its steps one
    op at a time) unless ``jit`` is False: XLA's CPU dot takes no bf16 x
    bf16 -> float32 product inside a jit, which the occupancy kernels'
    bit expansion is."""
    from gcl_tpu.testing import kernel_interpret

    with kernel_interpret():
        out = (jax.jit(lambda *a: fn(*a, **kw)) if jit
               else lambda *a: fn(*a, **kw))(*args)
    return jax.tree_util.tree_map(_np, out)


def _geo_kw(fm):
    return dict(win=fm.win, rows=fm.rows, hstarts=fm.hstarts, hnch=fm.hnch,
                hwin=fm.hwin, interpret=True)


def test_k6_forward_matches_pallas_in_bf16(geo):
    from gcl_tpu.core.pallas_conv import fused_conv_fwd

    fm = geo["fm"]
    got = kernels.sparse_conv_implicit_fwd(geo["x"], geo["w"],
                                           geo["cmap"].qkey, geo["lv"].skeys,
                                           geo["lv"].srow)
    assert got.dtype == torch.bfloat16
    ref = _pallas(fused_conv_fwd, _j(geo["x"]), _j(geo["w"]), fm.qkey,
                  fm.starts, fm.nch, fm.tkeys, **_geo_kw(fm))
    assert_bf16_close(got, ref, "K6")


def test_k7_backward_matches_pallas_in_bf16(geo):
    from gcl_tpu.core.sparse_ops import sparse_conv_fused

    fm = geo["fm"]
    dx, dw = kernels.sparse_conv_implicit_bwd(
        geo["x"], geo["up"], geo["w"], geo["cmap"].rqkey, geo["lv"].skeys,
        geo["lv"].srow)
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32

    def vjp(x, w, up):
        _, back = jax.vjp(lambda x, w: sparse_conv_fused(x, w, fm, fm), x, w)
        return back(up)

    rdx, rdw = _pallas(vjp, _j(geo["x"]), _j(geo["w"]), _j(geo["up"]))
    assert_bf16_close(dx, rdx, "K7 dX")
    assert_close_to_max(to_np(dw), rdw, DW_REL, "K7 dW")


def test_k8_matches_pallas_in_bf16(geo):
    """K8 over the implicit map and over the index table (whose rows are
    the implicit map's) against fused_conv_dw, the kernel K8 replaces."""
    from gcl_tpu.core.pallas_conv import fused_conv_dw

    fm, lv = geo["fm"], geo["lv"]
    dw = kernels.sparse_conv_dw(geo["x"], geo["up"], geo["cmap"].qkey,
                                lv.skeys, lv.srow)
    tab = kernels.sparse_conv_dw(geo["x"], geo["up"], geo["kmap"])
    assert dw.dtype == tab.dtype == torch.float32
    ref = _pallas(fused_conv_dw, _j(geo["x"]), _j(geo["up"]), fm.qkey,
                  fm.starts, fm.nch, fm.tkeys, **_geo_kw(fm))
    assert_close_to_max(to_np(dw), ref, DW_REL, "K8 over the implicit map")
    assert_close_to_max(to_np(tab), ref, DW_REL, "K8 over the table")


def test_k12_matches_pallas_in_bf16(geo):
    """K12 through the reverse table (this same-level map is its own
    reverse twin) with flipped, transposed weights, the dX of the explicit
    route, against pallas_conv_fwd, the index-table API over the TPU's
    forward kernel."""
    from gcl_tpu.core.pallas_conv import pallas_conv_fwd

    kmap = geo["kmap"]
    routed = jnp.asarray(np.where(to_np(kmap) < 0, N_ROWS, to_np(kmap)))
    wt = geo["w"].flip(0).transpose(1, 2).contiguous()
    got = kernels.sparse_conv_table_fwd(geo["up"], wt, kmap)
    assert got.dtype == torch.bfloat16
    ref = _pallas(pallas_conv_fwd, _j(geo["up"]), _j(wt), routed,
                  interpret=True)
    assert_bf16_close(got, ref, "K12")


def test_k2_k3_match_pallas_in_bf16(geo):
    """The occupancy conv in bf16 (K2) and its dW from a bf16 gradient
    (K3), through OccupancyConv against gcl_tpu's sparse_conv_c1z."""
    from gcl_tpu.core.sparse_ops import sparse_conv_c1z

    fm, lv = geo["fm"], geo["lv"]
    w1 = geo["w1"].clone().requires_grad_()
    out = sparse_ops.sparse_conv_c1z(w1, geo["cmap"].c1z, lv, torch.bfloat16)
    out.backward(geo["up"])
    assert out.dtype == torch.bfloat16 and w1.grad.dtype == torch.float32

    def vjp(w, up):
        out, back = jax.vjp(lambda w: sparse_conv_c1z(w, fm, jnp.bfloat16),
                            w)
        return out, back(up)[0]

    ref, rdw = _pallas(vjp, _j(geo["w1"]), _j(geo["up"]), jit=False)
    assert_bf16_close(out.detach(), ref, "K2")
    assert_close_to_max(to_np(w1.grad), rdw, DW_REL, "K3")


def test_k4_k5_k9_match_pallas_in_bf16(geo):
    """The scalar-feature conv in bf16 (K4) with its dW (K5) and dX (K9),
    through ScalarConv against gcl_tpu's fused conv of a Cin == 1 input
    (its c1 and co1 kernels)."""
    from gcl_tpu.core.sparse_ops import sparse_conv_fused

    fm, lv, c1z = geo["fm"], geo["lv"], geo["cmap"].c1z
    x = geo["eps"].clone().requires_grad_()
    w1 = geo["w1"].clone().requires_grad_()
    out = sparse_ops.ScalarConv.apply(x, w1, c1z, lv.skeys, lv.srow, None)
    out.backward(geo["up"])
    assert out.dtype == x.grad.dtype == torch.bfloat16
    assert w1.grad.dtype == torch.float32

    def vjp(x, w, up):
        out, back = jax.vjp(lambda x, w: sparse_conv_fused(x, w, fm, fm),
                            x, w)
        return (out,) + back(up)

    ref, rdx, rdw = _pallas(vjp, _j(geo["eps"]), _j(geo["w1"]),
                            _j(geo["up"]))
    assert_bf16_close(out.detach(), ref, "K4")
    assert_bf16_close(x.grad, rdx, "K9")
    assert_close_to_max(to_np(w1.grad), rdw, DW_REL, "K5")


def test_bf16_gate_catches_one_ulp_off_everywhere():
    """The gate refuses what a wrong pair order or a second rounding would
    give: one ulp off on every element, or two ulps on one."""
    ref = torch.randn(64, 32, generator=torch.Generator().manual_seed(0)
                      ).to(torch.bfloat16)
    assert_bf16_close(ref.clone(), ref, "itself")
    up = bf16_ordered(ref) + 1
    off = torch.where(up >= 0, up, -up | 0x8000).to(torch.int16).view(
        torch.bfloat16)
    with pytest.raises(AssertionError, match="bit-equal"):
        assert_bf16_close(off, ref, "one ulp")
    two = ref.clone()
    two[0, 0] = two[0, 0] * (1 + 2 ** -6)
    with pytest.raises(AssertionError, match="ulps apart"):
        assert_bf16_close(two, ref, "two ulps")


# --- one whole bf16 GCL step ----------------------------------------------

@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_bf16_train_step_matches_jax(one_thread):
    from gcl_tpu.losses import gcl as jgcl
    from gcl_tpu.train import steps as jsteps
    from gcl_tpu_torch.losses.gcl import GCLLossConfig
    from gcl_tpu_torch.models.weights import (flatten_tree,
                                              gradients_by_name,
                                              random_state_dict,
                                              state_dict_to_flax)
    from gcl_tpu_torch.train import steps as tsteps
    from test_torch_train_step import (B, MAX_HN, MAX_POS, N, NV, WD,
                                       _batch, _jax_model, _port_model,
                                       _port_model_shapes, _step_cfg)
    from _torch_parity import fatbn_specs, jax_specs, replay_loss_draws

    state = random_state_dict(_port_model_shapes(), seed=3)
    params, stats = state_dict_to_flax(state)
    batch = _batch(41)
    loss_args = dict(max_pos_cluster=MAX_POS, max_hn_samples=MAX_HN,
                     pos_weight=1.0, finest_weight=1.0, neg_weight=1.0)
    lr = 0.01

    def tree_np(t):
        return flatten_tree(jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), t))

    jax_runs = {}
    for name, dt in (("bf16", jnp.bfloat16), ("f32", jnp.float32)):
        tx, jstep = jsteps.make_gcl_train_step(
            _jax_model(), jax_specs(fatbn_specs()),
            _step_cfg(jsteps, compute_dtype=dt),
            jgcl.GCLLossConfig(block_finest_gradient=False), "finest",
            jitter=False, **loss_args)
        jstate = jsteps.TrainState(params, stats, tx.init(params),
                                   jax.random.PRNGKey(7),
                                   jnp.zeros((), jnp.int32))
        new, jm = jstep(jstate, lr, *(jnp.asarray(a) for a in batch))
        trace, p0 = tree_np(new.opt_state[1].trace), tree_np(params)
        jax_runs[name] = dict(
            metrics={k: float(jm[k]) for k in
                     ("loss", "pos_loss", "finest_loss", "neg_loss")},
            grads={n: trace[n] - WD * p0[n] for n in trace},
            stats=tree_np(new.batch_stats))
    # the step's loss uniforms, replayed from the same key (steps.py:
    # rng, k = split(rng); k_loss, _ = split(k))
    _, k = jax.random.split(jax.random.PRNGKey(7))
    k_loss, _ = jax.random.split(k)
    draws = tsteps.StepDraws(loss=replay_loss_draws(k_loss, B * NV, N,
                                                    MAX_POS, MAX_HN))
    model = _port_model(state)
    _, step = tsteps.make_gcl_train_step(
        model, fatbn_specs(), _step_cfg(tsteps, compute_dtype=torch.bfloat16),
        GCLLossConfig(block_finest_gradient=False), "finest", jitter=False,
        **loss_args)
    tm = step(lr, *(torch.from_numpy(a) for a in batch), draws=draws)
    _, tstats = state_dict_to_flax(model.state_dict())
    port = dict(metrics={k: float(tm[k]) for k in jax_runs["bf16"]["metrics"]},
                grads={n: to_np(g) for n, g in
                       gradients_by_name(model).items()},
                stats=flatten_tree(tstats))
    # the loss terms are one tensor [loss, pos, finest, neg] (the loss is
    # the sum of the others); every gradient and BN statistic is one
    for run in (port, *jax_runs.values()):
        run["metrics"] = {"loss terms": np.array(
            [run["metrics"][k] for k in sorted(run["metrics"])])}
    moved = 0
    for part in ("metrics", "grads", "stats"):
        want, ref32 = jax_runs["bf16"][part], jax_runs["f32"][part]
        assert port[part].keys() == want.keys(), part
        for name in want:
            got = np.asarray(port[part][name], np.float32)
            w16 = np.asarray(want[name], np.float32)
            w32 = np.asarray(ref32[name], np.float32)
            drift = float(np.abs(w16 - w32).max())
            err = float(np.abs(got - w16).max())
            assert err <= 2 * drift + 1e-6, (
                f"{part} {name}: port vs gcl_tpu in bf16 {err}, bf16 vs "
                f"float32 in gcl_tpu {drift}")
            moved += drift > 1e-6
    # bf16 moved the reference: the gate is not vacuous
    assert moved > 50
