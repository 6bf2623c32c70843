"""Shared inputs for the gcl_tpu_torch parity tests (tests/test_torch_*.py).

Every input is made once with numpy from a seed and handed to both
packages; results come back to numpy for comparison. JAX stays on the CPU
(tests/conftest.py) and runs its XLA path: build_graph(method='auto')
resolves to sort-join explicit maps plus the scan sparse_conv there.
"""
import numpy as np
import torch

VOXEL = 0.3


def clouds(seed: int, n_clouds: int = 2, n_points: int = 700):
    """Small LiDAR-like clouds, float32[C, P, 3] (a ground patch + posts,
    a few metres across, so a few hundred voxels each) and pmask with a
    few dropped points."""
    rng = np.random.RandomState(seed)
    pts = np.empty((n_clouds, n_points, 3), np.float32)
    for c in range(n_clouds):
        n_g = n_points // 2
        ground = np.concatenate([rng.uniform(-4, 4, (n_g, 2)),
                                 rng.randn(n_g, 1) * 0.05], 1)
        posts = (rng.uniform(-4, 4, (8, 3)) * [1, 1, 0])[
            rng.randint(0, 8, n_points - n_g)]
        posts = posts + rng.randn(n_points - n_g, 3) * [0.3, 0.3, 1.0]
        pts[c] = np.concatenate([ground, posts]) + rng.randn(3) * 2
    pmask = rng.rand(n_clouds, n_points) > 0.05
    return pts, pmask


def fatbn_specs():
    from gcl_tpu_torch.models.resunet import ResUNetFatBN
    return ResUNetFatBN.conv_specs(5)


def strides_of(specs):
    return sorted({s for sp in specs for s in (sp.in_stride, sp.out_stride)})


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def jax_specs(specs):
    from gcl_tpu.core.kernel_maps import ConvSpec as JSpec
    return [JSpec(s.name, s.in_stride, s.out_stride, s.kernel_size,
                  s.dilation) for s in specs]


def jax_graph(coords, mask, specs, caps, n_clouds):
    """gcl_tpu's graph of level-0 rows in the voxelize_per_cloud layout
    (jitted: one compile instead of hundreds of eager op compiles)."""
    import jax
    import jax.numpy as jnp
    from gcl_tpu.core.kernel_maps import build_graph

    jspecs = jax_specs(specs)
    build = jax.jit(lambda c, m: build_graph(
        c, m, jspecs, caps, sorted_blocks=True, n_clouds=n_clouds))
    return build(jnp.asarray(coords), jnp.asarray(mask))


def jax_map_refs(graph, specs):
    """For every forward geometry with a kernel: (query keys as
    _build_fused_maps packs them, _build_kmap's rows), in one jit."""
    import jax
    import jax.numpy as jnp
    from gcl_tpu.core import kernel_maps as jkm
    from gcl_tpu.core.coords import pack_query_keys

    specs = [sp for sp in jax_specs(specs) if not sp.is_identity_map]

    @jax.jit
    def refs(levels):
        out = {}
        for sp in specs:
            offs = jkm.kernel_offsets(sp.kernel_size) * sp.offset_scale
            folded = jkm._fold_clouds(levels[sp.out_stride].coords)
            qk = jax.vmap(lambda o, sp=sp: pack_query_keys(
                folded, o, sp.in_stride))(jnp.asarray(offs))
            km = jkm._build_kmap(levels[sp.out_stride],
                                 levels[sp.in_stride], sp.in_stride, offs)
            out[sp.key] = (qk, km)
        return out

    return jax.tree_util.tree_map(np.asarray, refs(graph.levels))


def assert_close_to_max(got, ref, rel: float, what: str = ""):
    """max|got - ref| <= rel * max|ref|, on arrays of one shape."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = float(np.abs(ref).max())
    assert scale > 0, f"{what}: the reference is all zero"
    err = float(np.abs(got - ref).max())
    assert err <= rel * scale, f"{what}: {err} > {rel} * {scale}"


def bf16_ordered(t: torch.Tensor) -> torch.Tensor:
    """bf16 values as int32 in the order of the values: neighbours in bf16
    differ by one (+0 and -0 are both 0)."""
    bits = t.detach().cpu().contiguous().view(torch.int16).to(torch.int32)
    return torch.where(bits < 0, -(bits & 0x7FFF), bits)


def assert_bf16_close(got, ref, what: str = "", bound=None):
    """got and ref bf16 of one shape (any array of bf16 values): equal bit
    for bit on >= 99.9% of the elements, within one bf16 ulp on the rest:
    the gate for two sums of the same exact products in float32, in
    another order, each rounded to bf16 once. Where a sum cancels, its
    float32 rounding can exceed a bf16 ulp of the result in any order;
    there, with ``bound`` given (a tensor of ref's shape, the two float32
    sums' error bound), the elements may differ by one ulp plus it."""
    got, ref = (
        (t if torch.is_tensor(t) else torch.from_numpy(np.array(t)))
        .detach().cpu().to(torch.bfloat16) for t in (got, ref))
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert bool(ref.float().abs().max() > 0), f"{what}: all zero"
    ulps = (bf16_ordered(got) - bf16_ordered(ref)).abs()
    share = float((ulps == 0).float().mean())
    assert share >= 0.999, f"{what}: bit-equal on {share} of the elements"
    far = ulps > 1
    if bound is None or not bool(far.any()):
        assert int(ulps.max()) <= 1, f"{what}: {int(ulps.max())} ulps apart"
        return
    _, e = torch.frexp(ref.float())
    ulp = torch.where(ref == 0, 0.0, torch.ldexp(torch.ones_like(e, dtype=
                                                              torch.float32),
                                                 e - 8))
    room = ulp + torch.as_tensor(bound).detach().cpu().float()
    diff = (got.float() - ref.float()).abs()
    worst = float((diff[far] / room[far]).max())
    assert worst <= 1, (f"{what}: {int(far.sum())} elements more than one "
                        f"ulp apart, up to {worst} x one ulp + the bound")


def replay_loss_draws(key, n_groups: int, n_voxels: int,
                      max_pos_cluster: int, max_hn_samples: int):
    """The uniforms gcl_tpu's finest_contrastive_loss draws from ``key``
    (its key splits, losses/gcl.py, and sample_without_replacement's one
    uniform call per pick), as the port's LossDraws."""
    import jax
    from gcl_tpu_torch.losses.gcl import LossDraws

    k_sel, _, k_neg = jax.random.split(key, 3)
    k1, k2, _ = jax.random.split(k_neg, 3)

    def u(k, m, n):
        return torch.from_numpy(np.array(
            jax.random.uniform(k, (min(m, n),))))

    return LossDraws(u(k_sel, max_pos_cluster, n_groups),
                     u(k1, max_hn_samples, n_voxels),
                     u(k2, max_hn_samples, n_voxels))
