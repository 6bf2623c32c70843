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
