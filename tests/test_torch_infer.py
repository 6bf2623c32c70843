"""The serving slice end to end at small caps, against gcl_tpu's
make_feature_extractor + SC2-PCR pipeline (scripts/bench_infer.py).

Tolerances: voxel coords, mask and xyz are exact; features 2e-4 abs (see
test_torch_models.py); the registered transform 1e-3 (see
test_torch_reg.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcl_tpu.models.resunet import ResUNetFatBN as JFatBN
from gcl_tpu.reg.sc2pcr import Matcher as JMatcher
from gcl_tpu.train.steps import StepConfig
from gcl_tpu.train.steps import make_feature_extractor as j_make_extractor
from gcl_tpu_torch.core.kernel_maps import default_level_caps
from gcl_tpu_torch.infer import (kitti_matcher, make_feature_extractor,
                                 random_keypoints, register_pair)
from gcl_tpu_torch.models.resunet import ResUNetFatBN
from gcl_tpu_torch.models.weights import random_state_dict, state_dict_to_flax

from _torch_parity import VOXEL, clouds, fatbn_specs, strides_of, to_np

NV = 384
N_KEY = 200


@pytest.fixture(scope="module")
def pipelines():
    specs = fatbn_specs()
    caps = default_level_caps(NV, strides_of(specs), 0.7)
    model = ResUNetFatBN(1, 32, bn_momentum=0.05, normalize_feature=True,
                         conv1_kernel_size=5, D=3)
    state = random_state_dict(model, seed=7)
    model.load_state_dict(state)
    params, stats = state_dict_to_flax(state)
    extract = make_feature_extractor(model, specs, VOXEL, NV, caps)
    jmodel = JFatBN(1, 32, bn_momentum=0.05, normalize_feature=True,
                    conv1_kernel_size=5, D=3)
    from _torch_parity import jax_specs
    j_extract = j_make_extractor(jmodel, jax_specs(specs),
                                 StepConfig(voxel_size=VOXEL, nv_cap=NV,
                                            level_caps=caps))
    return extract, lambda p, m: j_extract(params, stats, p, m)


def _pair(seed):
    """Cloud 0 and a rotated, shifted copy as cloud 1."""
    pts, pmask = clouds(seed, 2, 700)
    th = np.radians(10.0)
    r = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                  [0, 0, 1]], np.float32)
    pts[1] = pts[0] @ r.T + np.array([0.7, -0.4, 0.1], np.float32)
    pmask[1] = pmask[0]
    return pts, pmask


def test_feature_extractor_matches_jax(pipelines):
    extract, j_extract = pipelines
    pts, pmask = _pair(12)
    vox, f = extract(torch.from_numpy(pts), torch.from_numpy(pmask))
    vj, fj = j_extract(jnp.asarray(pts), jnp.asarray(pmask))
    np.testing.assert_array_equal(to_np(vox.coords), np.asarray(vj.coords))
    np.testing.assert_array_equal(to_np(vox.mask), np.asarray(vj.mask))
    np.testing.assert_array_equal(to_np(vox.xyz), np.asarray(vj.xyz))
    assert f.shape == fj.shape == (2, NV, 32)
    np.testing.assert_allclose(to_np(f), np.asarray(fj), rtol=0, atol=2e-4)


def test_register_pair_matches_jax(pipelines):
    """Pinned keypoints on both sides: the port's register_pair and the
    bench_infer.py pipeline give one transform."""
    extract, j_extract = pipelines
    pts, pmask = _pair(13)
    gen = torch.Generator().manual_seed(0)
    vox, _ = extract(torch.from_numpy(pts), torch.from_numpy(pmask))
    keys = [random_keypoints(vox.mask[c], N_KEY, gen) for c in (0, 1)]
    t, _, _ = register_pair(extract, kitti_matcher(N_KEY),
                            torch.from_numpy(pts), torch.from_numpy(pmask),
                            N_KEY, keypoints=keys)
    vj, fj = j_extract(jnp.asarray(pts), jnp.asarray(pmask))
    sel = [np.asarray(to_np(k)) for k in keys]
    x0, x1 = (vj.xyz[c][sel[c]] for c in (0, 1))
    f0, f1 = (fj[c][sel[c]] for c in (0, 1))
    matcher = JMatcher(inlier_threshold=0.6, num_node="all",
                       use_mutual=False, d_thre=0.1, num_iterations=20,
                       ratio=0.2, nms_radius=0.6, max_points=N_KEY, k1=30,
                       k2=20)
    tj = matcher.estimator(x0[None], x1[None], f0[None], f1[None],
                           jax.random.PRNGKey(0))[0][0]
    assert np.isfinite(to_np(t)).all()
    np.testing.assert_allclose(to_np(t), np.asarray(tj), atol=1e-3)


def test_random_keypoints_pick_valid_rows():
    mask = torch.zeros(50, dtype=torch.bool)
    mask[::3] = True
    gen = torch.Generator().manual_seed(1)
    idx = random_keypoints(mask, 10, gen)
    assert len(set(idx.tolist())) == 10 and mask[idx].all()
