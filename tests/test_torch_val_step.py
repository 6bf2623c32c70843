"""Parity of gcl_tpu_torch's pair validation step (make_val_step) with
gcl_tpu's, on a narrow ResUNetFatBNEXP (tests/_torch_parity.py) and the
same seeded weights, with the subsamples' uniforms that gcl_tpu draws
from its keys handed to the port.

Tolerances: t_est within 1e-4 (features within 1e-4 feed the same
feature matches, which are held equal first, then 20 float32 6x6
solves); hit_ratio equal; rte, rre and the clamped corr_dist loss within
1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcl_tpu.train.steps import StepConfig as JStepConfig
from gcl_tpu.train.steps import make_val_step as j_make_val_step
from gcl_tpu_torch.core.kernel_maps import default_level_caps
from gcl_tpu_torch.models.weights import random_state_dict, state_dict_to_flax
from gcl_tpu_torch.train.steps import StepConfig, make_val_step

from _torch_parity import (VOXEL, clouds, jax_specs, narrow_exp_classes,
                           one_torch_thread, strides_of, to_np)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NV = 448
SUB = 200


def test_val_step_matches_jax():
    jcls, tcls = narrow_exp_classes()
    specs = tcls.conv_specs(5)
    caps = default_level_caps(NV, strides_of(specs), 0.6)
    model = tcls(1, 32, bn_momentum=0.05, normalize_feature=True,
                 conv1_kernel_size=5, D=3)
    state = random_state_dict(model, seed=8)
    model.load_state_dict(state)
    params, stats = state_dict_to_flax(state)
    pts0, pmask0 = clouds(9, 2, 1500)
    # cloud 1 is cloud 0 moved by whole voxels: the same voxels, so the
    # same features, and correct matches wherever both subsamples hold
    # the voxel
    trans = np.stack([np.eye(4, dtype=np.float32)] * 2)
    trans[:, :3, 3] = [[0.6, -0.9, 0.3], [-0.3, 0.3, 0.0]]
    pts1 = (pts0 + trans[:, None, :3, 3]).astype(np.float32)
    pmask1 = pmask0.copy()
    key = jax.random.PRNGKey(2)

    jstep = j_make_val_step(
        jcls(1, 32, bn_momentum=0.05, normalize_feature=True,
             conv1_kernel_size=5, D=3), jax_specs(specs),
        JStepConfig(voxel_size=VOXEL, nv_cap=NV, level_caps=caps,
                    knn_chunk=128), subsample=SUB)
    ref = jstep(params, stats, key, *(jnp.asarray(a) for a in (
        pts0, pmask0, pts1, pmask1, trans)))
    draws = []
    for k in jax.random.split(key, 2):
        k0, k1 = jax.random.split(k)
        draws.append(tuple(torch.from_numpy(np.array(
            jax.random.uniform(kk, (SUB,)))) for kk in (k0, k1)))
    step = make_val_step(model, specs,
                         StepConfig(voxel_size=VOXEL, nv_cap=NV,
                                    level_caps=caps, knn_chunk=128),
                         subsample=SUB)
    got = step(*(torch.from_numpy(a) for a in (pts0, pmask0, pts1, pmask1,
                                                trans)), draws=draws)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    np.testing.assert_allclose(to_np(got["t_est"]), ref["t_est"], rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(to_np(got["hit_ratio"]), ref["hit_ratio"])
    assert (ref["hit_ratio"] > 0.2).all()
    for k in ("rte", "rre", "loss"):
        np.testing.assert_allclose(to_np(got[k]), ref[k], rtol=0, atol=1e-3)
