"""The KITTI evaluation entry point end to end on a synthetic mini-KITTI:
gcl_tpu_torch.eval_kitti.main against scripts/test_kitti.py:main (loaded
by path) on one run directory, whose checkpoint gcl_tpu wrote.

The model is a narrow ResUNetFatBNEXP (tests/_torch_parity.py), put in
both packages' load_model by a test-side patch. The scans reach 150 m, so
each cloud has more than the 5000 voxels the runner draws (a permutation,
no repeated point). With random weights a tenth of the voxels still have
another voxel's features to float32 rounding (their neighbourhoods match
up to a translation), so which of two such voxels an argmin takes depends
on the last bits: the two packages' features agree within 1e-4 (checked
here on every cloud), yet feature matches pick another, equally near,
voxel. So gcl_tpu's pipeline is handed the port's features for each cloud
(a test-side patch of its make_feature_extractor, which checks its own
features against them first); everything after the features is the two
entry points' own. SC2-PCR runs at config_KITTI.json's settings with
num_node "all" (its 8000 random nodes of 5000 points would repeat
correspondences, which tie in its seed ranking). The keypoints and
features each entry point hands SC2-PCR must be equal bit for bit. Its
results are held to 1e-2, not 1e-3, and why: SC2-PCR decides
on hard thresholds over all 25M correspondence pairs (cross distance <
0.1, < 0.05, inliers < 0.6 m), and a few pairs within float32 rounding of
one flip between the packages' sums, which moves the refined pose by
millimetres (5e-3 seen; tests/test_torch_reg.py holds SC2-PCR to 1e-3 on
smaller inputs). So each pair's transform within 1e-2, RR equal, RTE
within 1e-2 m, and the RRE's cosine within 1e-6 (near 0 deg arccos turns
a 1e-6 change of a float32 cosine into about 0.01 deg). Then the port with RANSAC (512 hypotheses): finite numbers, and each
pair's transform equal to ransac_pose called directly on the same
keypoints and matches.
"""
import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

import gcl_tpu.models
import gcl_tpu.train
from gcl_tpu.config import default_config as j_default_config
from gcl_tpu.train.checkpoint import save_checkpoint as j_save_checkpoint
from gcl_tpu_torch import eval_kitti
from gcl_tpu_torch.data.synthetic import (generate_synthetic_kitti,
                                          write_split_files)
from gcl_tpu_torch.models.weights import random_state_dict, state_dict_to_flax
from gcl_tpu_torch.reg.matching import find_nn
from gcl_tpu_torch.reg.ransac import ransac_pose

from _torch_parity import narrow_exp_classes, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _test_kitti_module():
    spec = importlib.util.spec_from_file_location(
        "test_kitti_script", os.path.join(REPO, "scripts", "test_kitti.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(root, save_dir, config overrides): a synthetic drive, its split
    files, and a run directory holding config.json and a checkpoint of
    the narrow EXP written by gcl_tpu."""
    root = tmp_path_factory.mktemp("kitti")
    generate_synthetic_kitti(str(root), n_drives=1, n_frames=20, step=2.0,
                             max_range=150.0)
    write_split_files(str(root / "config"), 1)
    save_dir = root / "run"
    save_dir.mkdir()
    cfg = dict(model="NarrowEXP", model_n_out=16, conv1_kernel_size=5,
               voxel_size=0.3, voxel_capacity=8192, point_capacity=16384,
               level_cap_shrink=0.6, knn_chunk=1024,
               complement_pair_dist=2.0, num_complement_one_side=1,
               pair_min_dist=3, pair_max_dist=10, use_old_pose=True)
    with open(save_dir / "config.json", "w") as f:
        json.dump(cfg, f)
    _, tcls = narrow_exp_classes()
    model = tcls(1, 16, bn_momentum=0.05, conv1_kernel_size=5,
                 normalize_feature=True, D=3)
    params, stats = state_dict_to_flax(random_state_dict(model, seed=5))
    j_save_checkpoint(str(save_dir / "best_val_checkpoint.pth"), epoch=1,
                      params=params, batch_stats=stats, opt_state={},
                      config=cfg, best_val=0.0, best_val_epoch=1,
                      best_val_metric="feat_match_ratio")
    return root, save_dir


@pytest.fixture
def narrow_models(monkeypatch):
    jcls, tcls = narrow_exp_classes()
    monkeypatch.setattr(gcl_tpu.models, "load_model",
                        lambda name: {"NarrowEXP": jcls}[name])
    monkeypatch.setattr(eval_kitti, "load_model",
                        lambda name: {"NarrowEXP": tcls}[name])


def _config(make, run, use_ransac: bool):
    """scripts/test_kitti.py's __main__ settings on a fresh config."""
    root, save_dir = run
    config = make()
    with open(save_dir / "config.json") as f:
        config.update(json.load(f))
    config.update(save_dir=str(save_dir), test_phase="test",
                  kitti_root=str(root), test_num_thread=0, LoKITTI=False,
                  LoNUSCENES=False, phase="test", use_RANSAC=use_ransac,
                  ransac_hypotheses=512, downsample_single=1.0,
                  rte_thresh=2.0, rre_thresh=5.0)
    if not use_ransac:
        with open(eval_kitti.SC2_CONFIG) as f:
            config.update(json.load(f))
        config.num_node = "all"
    return config


def _patch_splits(monkeypatch, root):
    """The split files of the synthetic root, for both packages."""
    from gcl_tpu.data import pairs as jpairs
    from gcl_tpu_torch.data import pairs as tpairs
    files = {p: os.path.join(str(root), "config", f"{p}_kitti.txt")
             for p in ("train", "val", "test")}
    for mod in (jpairs, tpairs):
        monkeypatch.setattr(mod.PairComplementKittiDataset, "DATA_FILES",
                            files)


def _ports_features(monkeypatch, port_extract, errs):
    """gcl_tpu's make_feature_extractor, patched to return the port's
    features of each cloud once its own are within 1e-4 of them."""
    real = gcl_tpu.train.make_feature_extractor

    def make(model, specs, step_cfg):
        j_extract = real(model, specs, step_cfg)

        def extract(params, stats, points, pmask):
            vox, f = j_extract(params, stats, points, pmask)
            pvox, pf = port_extract(torch.from_numpy(np.asarray(points)),
                                    torch.from_numpy(np.asarray(pmask)))
            m = np.asarray(vox.mask)
            np.testing.assert_array_equal(pvox.mask.numpy(), m)
            np.testing.assert_array_equal(pvox.xyz.numpy(),
                                          np.asarray(vox.xyz))
            pf = pf.numpy()
            errs.append(float(np.abs(pf[m] - np.asarray(f)[m]).max()))
            assert errs[-1] <= 1e-4
            return vox, jax.numpy.asarray(pf)
        return extract

    monkeypatch.setattr(gcl_tpu.train, "make_feature_extractor", make)


def _recorded_sc2pcr(monkeypatch, module, calls):
    """``module``'s Matcher (gcl_tpu.reg's or eval_kitti's), patched to
    record each pair's inputs (keypoints, features) and transform."""
    class Recording(module.Matcher):
        def estimator(self, *args, **kw):
            out = super().estimator(*args, **kw)
            calls.append([np.asarray(a) for a in args[:4]]
                         + [np.asarray(out[0])[0]])
            return out

    monkeypatch.setattr(module, "Matcher", Recording)


def test_sc2pcr_evaluation_matches_test_kitti(run, narrow_models,
                                              monkeypatch):
    import gcl_tpu.reg
    _patch_splits(monkeypatch, run[0])
    ref_calls, calls = [], []
    _recorded_sc2pcr(monkeypatch, gcl_tpu.reg, ref_calls)
    _recorded_sc2pcr(monkeypatch, eval_kitti, calls)
    config = _config(eval_kitti.default_config, run, False)
    errs = []
    _ports_features(monkeypatch,
                    eval_kitti.load_extractor(config, torch.device("cpu")),
                    errs)
    ref = _test_kitti_module().main(_config(j_default_config, run, False))
    n_pairs = len(eval_kitti.make_data_loader(config, "test", 1))
    assert n_pairs >= 2 and len(errs) == 2 * n_pairs
    got = eval_kitti.main(config, device="cpu")
    assert len(calls) == len(ref_calls) == n_pairs
    for ours, theirs in zip(calls, ref_calls):
        for a, b in zip(ours[:4], theirs[:4]):
            assert a.shape == (1, eval_kitti.N_POINTS, a.shape[2])
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.stack(got["transforms"]),
                                  np.stack([c[4] for c in calls]))
    np.testing.assert_allclose(np.stack(got["transforms"]),
                               np.stack([c[4] for c in ref_calls]), rtol=0,
                               atol=1e-2)
    assert got["rr"] == ref["rr"]
    np.testing.assert_allclose(got["rte"], ref["rte"], rtol=0, atol=1e-2)
    np.testing.assert_allclose(np.cos(np.radians(got["rre"])),
                               np.cos(np.radians(ref["rre"])), rtol=0,
                               atol=1e-6)


def test_ransac_evaluation_runs_and_matches_ransac_pose(run, narrow_models,
                                                        monkeypatch):
    """The FCGF evaluation (feature-NN RANSAC) through the entry point:
    finite RR / RTE / RRE, and each pair's transform that of find_nn +
    ransac_pose on the same keypoints, with the same generator."""
    _patch_splits(monkeypatch, run[0])
    config = _config(eval_kitti.default_config, run, True)
    got = eval_kitti.main(config, device="cpu")
    assert all(np.isfinite(got[k]) for k in ("rr", "rte", "rre"))
    extract = eval_kitti.load_extractor(config, torch.device("cpu"))
    rng = np.random.RandomState(0)
    gen = torch.Generator().manual_seed(0)
    loader = eval_kitti.make_data_loader(config, "test", 1)
    assert len(got["transforms"]) == len(loader) >= 2
    for batch, t_got in zip(loader, got["transforms"]):
        sides = []
        for c in (0, 1):
            vox, f = extract(torch.from_numpy(batch[f"points{c}"]),
                             torch.from_numpy(batch[f"pmask{c}"]))
            m = vox.mask[0]
            sides.append(eval_kitti.random_sample(
                vox.xyz[0][m].numpy(), f[0][m].numpy(), 5000, rng))
        (x0, f0), (x1, f1) = (tuple(map(torch.from_numpy, s))
                              for s in sides)
        nn, _ = find_nn(f0, f1, chunk=config.knn_chunk)
        t_ref, _, _ = ransac_pose(x0, x1[nn], 0.3, generator=gen,
                                  num_hypotheses=512, sample_size=4,
                                  edge_length_ratio=0.9)
        np.testing.assert_array_equal(t_got, t_ref.numpy())


def test_flags_and_device(run):
    """scripts/test_kitti.py's flags onto the run's config.json (SC2-PCR's
    settings from config_KITTI.json without RANSAC), --device cuda by
    default, which raises without a card instead of running on the CPU."""
    root, save_dir = run
    config, device = eval_kitti.parse_config(
        ["--save_dir", str(save_dir), "--kitti_root", str(root),
         "--use_RANSAC", "false", "--pair_min_dist", "4",
         "--pair_max_dist", "9", "--test_num_thread", "0"])
    assert device == "cuda"
    assert (config.model, config.voxel_capacity) == ("NarrowEXP", 8192)
    assert (config.pair_min_dist, config.pair_max_dist) == (4, 9)
    assert (config.num_node, config.inlier_threshold) == (8000, 0.6)
    assert not config.use_RANSAC and config.ransac_hypotheses == 131072
    config, device = eval_kitti.parse_config(
        ["--save_dir", str(save_dir), "--device", "cpu"])
    assert device == "cpu" and config.use_RANSAC and "num_node" not in config
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            eval_kitti.device_of("cuda")


def test_load_model_names_the_models_not_ported():
    """(Kept under its first name.) load_model answers gcl_tpu's names
    with the port's classes, ResUNetBN2C among them; an unknown name
    raises."""
    from gcl_tpu_torch.models import load_model
    from gcl_tpu_torch.models.resunet import ResUNetBN2C, ResUNetFatBNEXP
    assert load_model("ResUNetFatBNEXP") is ResUNetFatBNEXP
    assert gcl_tpu.models.load_model("ResUNetBN2C") is not None
    assert load_model("ResUNetBN2C") is ResUNetBN2C
    with pytest.raises(ValueError, match="not registered"):
        load_model("NoSuchNet")
