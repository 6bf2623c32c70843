"""Parity of the port's host side with gcl_tpu's: the config defaults,
the synthetic dataset writer, KITTI IO, the transforms, the pair
datasets (test and train phase, the ICP cache files) and the loader.
All of it is numpy on the host, so every comparison is exact.

Both packages draw from numpy's global RandomState (point caps, random
scale), so it is seeded alike before each side's sample.
"""
import filecmp
import os

import numpy as np
import pytest

from gcl_tpu.config import default_config as j_default_config
from gcl_tpu.data import kitti_io as jio
from gcl_tpu.data import loader as jloader
from gcl_tpu.data import pairs as jpairs
from gcl_tpu.data import synthetic as jsynth
from gcl_tpu.data import transforms as jtr
from gcl_tpu.data import make_data_loader as j_make_data_loader
from gcl_tpu_torch.config import default_config
from gcl_tpu_torch.data import kitti_io, loader, pairs, synthetic, transforms
from gcl_tpu_torch.utils.timer import AverageMeter

TPU_ONLY = {"conv_tile", "conv_win", "conv_win_down", "conv_pair",
            "conv_fold", "conv_stack"}


def test_config_defaults_match_gcl_tpu():
    ours, ref = default_config(), j_default_config()
    assert set(ref) - set(ours) == TPU_ONLY and set(ours) <= set(ref)
    assert ours == {k: v for k, v in ref.items() if k in ours}
    assert default_config(voxel_size=0.3).voxel_size == 0.3


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("n_drives", [1, 2])
def test_synthetic_writer_is_byte_equal(tmp_path, n_drives):
    for mod, name in ((jsynth, "ref"), (synthetic, "ours")):
        mod.generate_synthetic_kitti(str(tmp_path / name), n_drives,
                                     n_frames=6, step=2.0, seed=3)
        mod.write_split_files(str(tmp_path / name / "config"), n_drives)
    files = _tree(tmp_path / "ref")
    assert files == _tree(tmp_path / "ours") and len(files) > 6
    _, mismatch, errors = filecmp.cmpfiles(tmp_path / "ref",
                                           tmp_path / "ours", files,
                                           shallow=False)
    assert not mismatch and not errors


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """Two copies of one synthetic drive: each package fills its own
    root's ICP cache."""
    out = {}
    for name in ("ref", "ours"):
        root = tmp_path_factory.mktemp(name)
        synthetic.generate_synthetic_kitti(str(root), n_drives=1,
                                           n_frames=30, step=2.0)
        synthetic.write_split_files(str(root / "config"), 1)
        out[name] = root
    return out


def _cfg(make, root, **kw):
    cfg = make(kitti_root=str(root), voxel_size=0.3, point_capacity=4096,
               nghb_point_capacity=6144, pair_min_dist=3, pair_max_dist=10,
               complement_pair_dist=2.0, num_complement_one_side=1,
               use_old_pose=True, use_random_scale=True)
    cfg.update(kw)
    return cfg


@pytest.fixture
def splits(monkeypatch, roots):
    for mod, root in ((jpairs, roots["ref"]), (pairs, roots["ours"])):
        monkeypatch.setattr(
            mod.PairComplementKittiDataset, "DATA_FILES",
            {p: os.path.join(str(root), "config", f"{p}_kitti.txt")
             for p in ("train", "val", "test")})


def test_kitti_io_matches(roots):
    base = str(roots["ours"]) + "/dataset"
    np.testing.assert_array_equal(kitti_io.odometry_poses(base, 0),
                                  jio.odometry_poses(base, 0))
    np.testing.assert_array_equal(kitti_io.slam_poses(base, 0),
                                  jio.slam_poses(base, 0))
    calib = base + "/sequences/00/calib.txt"
    ours, ref = (m.parse_calibration(calib) for m in (kitti_io, jio))
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])
    assert kitti_io.scan_ids(base, 0) == jio.scan_ids(base, 0)
    path = kitti_io.scan_path(base, 0, 4)
    assert path == jio.scan_path(base, 0, 4)
    np.testing.assert_array_equal(kitti_io.read_velodyne_bin(path),
                                  jio.read_velodyne_bin(path))
    poses = kitti_io.odometry_poses(base, 0)
    np.testing.assert_array_equal(
        kitti_io.odometry_pair_transform(poses[3], poses[7]),
        jio.odometry_pair_transform(poses[3], poses[7]))


def test_transforms_match_under_one_random_state():
    pcd = np.random.RandomState(0).randn(100, 3).astype(np.float32)
    feats = np.ones((100, 1), np.float32)
    for mod in (transforms, jtr):
        mod.rng = np.random.RandomState(4)
    ours = [transforms.sample_random_trans(pcd, transforms.rng, 360)
            for _ in range(3)]
    ref = [jtr.sample_random_trans(pcd, jtr.rng, 360) for _ in range(3)]
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(
        transforms.follow_presampled_trans(pcd + 1, ref[0]),
        jtr.follow_presampled_trans(pcd + 1, ref[0]))
    out = []
    for mod in (transforms, jtr):
        np.random.seed(6)
        out.append(mod.Compose([mod.Jitter(), mod.ChromaticShift()])(
            pcd, np.tile(feats, (1, 3)))[1])
    np.testing.assert_array_equal(out[0], out[1])


def _assert_samples_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if k == "meta":
            assert a[k] == b[k]
        else:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("phase,old_pose,old_complement", [
    ("test", True, False), ("train", False, False), ("val", True, True),
    ("train", True, False)])
def test_pair_dataset_samples_equal(roots, splits, phase, old_pose,
                                    old_complement):
    """Samples bit-equal; the GT of the old (odometry) poses refined by
    ICP, the complements' per pair or by the multiway pose graph, computed
    afresh (not read from the ICP caches an earlier case filled)."""
    ds = []
    for mod, make, root in ((pairs, default_config, roots["ours"]),
                            (jpairs, j_default_config, roots["ref"])):
        ds.append(mod.PairComplementKittiDataset(
            phase, random_rotation=phase == "train",
            random_scale=phase == "train", manual_seed=True,
            config=_cfg(make, root, use_old_pose=old_pose,
                        debug_use_old_complement=old_complement,
                        debug_force_icp_recalculation=True)))
    ours, ref = ds
    assert ours.files == ref.files and len(ours) >= 2
    for i in range(min(len(ours), 3)):
        got = []
        for d in (ours, ref):
            np.random.seed(10 + i)
            got.append(d[i])
        _assert_samples_equal(*got)
        assert got[0]["pmask0"].sum() > 100


def test_icp_cache_files_are_interchangeable(roots, splits):
    """Each package's ICP cache of the test pairs holds the same bytes,
    and the port reads gcl_tpu's cache instead of computing its own."""
    cache = "icp"
    for mod, make, root in ((pairs, default_config, roots["ours"]),
                            (jpairs, j_default_config, roots["ref"])):
        mod.PairComplementKittiDataset(
            "test", random_rotation=False, random_scale=False,
            manual_seed=True, config=_cfg(make, root))[0]
    names = sorted(os.listdir(roots["ref"] / cache))
    assert names and names == sorted(os.listdir(roots["ours"] / cache))
    for n in names:
        assert filecmp.cmp(roots["ref"] / cache / n,
                           roots["ours"] / cache / n, shallow=False)
    marker = np.eye(4) * 2.0
    np.save(roots["ref"] / cache / names[0], marker)
    pairs._icp_cache.clear()
    ds = pairs.PairComplementKittiDataset(
        "test", random_rotation=False, random_scale=False, manual_seed=True,
        config=_cfg(default_config, roots["ref"]))
    drive, t_next, t_curr = (int(v) for v in names[0][:-4].split("_"))
    np.testing.assert_array_equal(
        ds._get_icp(drive, t_curr, t_next, None, None, None, None), marker)


def test_loader_batches_match(roots, splits):
    np.random.seed(0)
    ours = loader.make_data_loader(
        _cfg(default_config, roots["ours"]), "test", 1)
    ref = j_make_data_loader(_cfg(j_default_config, roots["ref"]), "test", 1)
    assert len(ours) == len(ref) >= 2
    for a, b in zip(ours, ref):
        _assert_samples_equal(a, b)
    # shuffled order and batching on a plain dataset, in-process and with
    # worker processes
    data = [{"x": np.array([i]), "meta": (i,)} for i in range(11)]
    want = [b["x"][:, 0].tolist() for b in jloader.DataLoader(
        data, batch_size=3, shuffle=True, drop_last=True)]
    for workers in (0, 2):
        got = [b["x"][:, 0].tolist() for b in loader.DataLoader(
            data, batch_size=3, shuffle=True, drop_last=True,
            num_workers=workers)]
        assert got == want and len(got) == 3
    assert loader.collate_stack(data[:2])["meta"] == [(0,), (1,)]


def test_average_meter():
    m = AverageMeter()
    for v in (1.0, 3.0):
        m.update(v)
    assert (m.avg, m.sum, m.count, m.var) == (2.0, 4.0, 2, 1.0)
