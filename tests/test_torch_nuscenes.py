"""The port's nuScenes data path against gcl_tpu's on a synthetic
nuScenes-as-KITTI export: the writer (byte-equal files), and
ColocationNuscenesDataset and PairComplementNuscenesDataset (the same
frame index and, under one np.random state, the same sample arrays),
with the native scan pool on and off.

Covered as tests/test_nuscenes.py covers gcl_tpu's: string log names,
poses.npy trusted as GT without ICP, the train phase's [::3][:1200]
subsample and the LoNUSCENES fixed list (config/file_LoNUSCENES_50.npy).
The KITTI colocation and pair datasets, which hint their scans too, are
held to gcl_tpu's with the pool on and off here as well.

gcl_tpu's datasets read through its own pool, whose library is compiled
into a temporary directory (tests/test_native.py runs `make` in place in
another worker). "Pool off" replaces the port's prefetch_scans with a
no-op: every scan is then read with numpy. With the pool on, each
sample's first read of each of its scans must be a payload the pool
served (a sample that reads a scan twice, as two of a pair's frames'
neighbourhoods may share a frame, reads it from disk the second time:
the pool hands out each hinted payload once).
"""
import filecmp
import os

import numpy as np
import pytest

import gcl_tpu.native as jnative
from gcl_tpu.config import default_config as j_default_config
from gcl_tpu.data import colocation as jcoloc
from gcl_tpu.data import kitti_io as jkitti_io
from gcl_tpu.data import pairs as jpairs
from gcl_tpu.data import synthetic as jsynth
from gcl_tpu_torch import native
from gcl_tpu_torch.config import default_config
from gcl_tpu_torch.data import colocation, kitti_io, pairs, synthetic

from _torch_parity import build_gcl_tpu_native


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("n_logs", [1, 2])
def test_synthetic_nuscenes_writer_is_byte_equal(tmp_path, n_logs):
    for mod, name in ((jsynth, "ref"), (synthetic, "ours")):
        mod.generate_synthetic_nuscenes(str(tmp_path / name), n_logs,
                                        n_frames=5, step=2.0, seed=4)
    files = _tree(tmp_path / "ref")
    assert files == _tree(tmp_path / "ours")
    assert len(files) == n_logs * 6
    assert all(f.startswith("dataset/sequences/n000-synthetic-log-")
               for f in files)
    _, mismatch, errors = filecmp.cmpfiles(tmp_path / "ref",
                                           tmp_path / "ours", files,
                                           shallow=False)
    assert not mismatch and not errors


@pytest.fixture(scope="module")
def nusc_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("nusc")
    synthetic.generate_synthetic_nuscenes(str(root), n_logs=1, n_frames=60,
                                          step=3.0)
    return root


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    """gcl_tpu's pool on its library built in a temporary directory, and
    fresh pools in both packages for this module."""
    if not native.available():
        pytest.skip(f"the host library did not build: "
                    f"{native.build_error()}")
    so = build_gcl_tpu_native(tmp_path_factory.mktemp("gcl_tpu_native"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_SO", so)
        mp.setattr(jnative, "_lib", None)
        mp.setattr(jkitti_io, "_prefetcher", None)
        mp.setattr(kitti_io, "_prefetcher", None)
        assert jnative.available()
        yield


class _Served:
    """The port's pool library with its fetches counted: a fetch that
    returns a payload (n >= 0) was served by the pool."""

    def __init__(self, lib):
        self._lib, self.served = lib, 0

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def gcl_reader_fetch(self, *args):
        n = self._lib.gcl_reader_fetch(*args)
        self.served += n >= 0
        return n


@pytest.fixture(params=["pool on", "pool off"])
def pool(request, pools, monkeypatch):
    """The port's scan reads (paths, None between samples) and the pool's
    served fetches; with the pool off, prefetch_scans does nothing."""
    counts = {"paths": []}
    real_read = kitti_io.read_velodyne_bin

    def read(path):
        counts["paths"].append(path)
        return real_read(path)

    monkeypatch.setattr(kitti_io, "read_velodyne_bin", read)
    if request.param == "pool off":
        monkeypatch.setattr(kitti_io, "prefetch_scans", lambda paths: None)
        counts["served"] = lambda: 0
    else:
        prefetcher = kitti_io._get_prefetcher()
        served = _Served(prefetcher._lib)
        monkeypatch.setattr(prefetcher, "_lib", served)
        counts["served"] = lambda: served.served
    counts["on"] = request.param == "pool on"
    return counts


def _cfg(make, root, **kw):
    cfg = make(kitti_root=str(root), voxel_size=0.3, min_dist=3, max_dist=18,
               num_neighborhood=4, point_capacity=8192, voxel_capacity=4096,
               nghb_point_capacity=8192, pair_min_dist=3, pair_max_dist=10,
               complement_pair_dist=3, num_complement_one_side=2,
               use_old_pose=True, use_random_rotation=True,
               use_random_scale=True)
    cfg.update(kw)
    return cfg


def _samples(ds, idx, pool=None):
    out = []
    for i in idx:
        ds.reset_seed(i)
        np.random.seed(i)
        out.append(ds[i])
        if pool is not None:
            pool["paths"].append(None)
    return out


def _assert_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if k == "meta":
            assert a[k] == b[k]
        else:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _check_pool(pool):
    """Served fetches: one for each distinct scan of each sample with the
    pool on, none with it off."""
    distinct, sample = 0, set()
    for path in pool["paths"]:
        if path is None:
            distinct, sample = distinct + len(sample), set()
        else:
            sample.add(path)
    assert distinct > 0 and not sample
    assert pool["served"]() == (distinct if pool["on"] else 0)


def test_colocation_nuscenes_matches_gcl_tpu(nusc_root, pool):
    """The frame index over string log names and three augmented samples
    equal to gcl_tpu's; poses.npy is the GT (the neighbours' transforms
    are gcl_tpu's pose algebra on it)."""
    kw = dict(random_rotation=True, random_scale=True)
    ds = [mod.ColocationNuscenesDataset("train", config=_cfg(make, nusc_root),
                                        **kw)
          for mod, make in ((colocation, default_config),
                            (jcoloc, j_default_config))]
    assert ds[0].files == ds[1].files and len(ds[0]) >= 3
    assert all(isinstance(f[0], str) and f[0].startswith("n000-")
               for f in ds[0].files)
    idx = range(3)
    for a, b in zip(_samples(ds[0], idx, pool), _samples(ds[1], idx)):
        _assert_equal(a, b)
        assert a["points"].shape == (5, 8192, 3)
        assert a["pmask"].sum(1).min() > 100
    _check_pool(pool)


@pytest.mark.parametrize("phase", ["test", "train"])
def test_pair_nuscenes_matches_gcl_tpu(nusc_root, pool, monkeypatch, phase):
    """Pairs (train: with their neighbourhoods, every third pair kept)
    equal to gcl_tpu's. use_old_pose is on, as the GCL nuScenes wrapper
    passes it, and still no ICP runs: the GT of the unaugmented test pair
    is poses.npy's inv(P[t1]) @ P[t0] (with the test phase's random
    rotation turned off)."""
    def no_icp(*a, **k):
        raise AssertionError("nuScenes poses are trusted: no ICP")

    monkeypatch.setattr(pairs, "registration_icp", no_icp)
    train = phase == "train"
    kw = dict(random_rotation=train, random_scale=train)
    ds = [mod.PairComplementNuscenesDataset(phase, config=_cfg(make,
                                                               nusc_root),
                                            **kw)
          for mod, make in ((pairs, default_config),
                            (jpairs, j_default_config))]
    assert ds[0].files == ds[1].files and len(ds[0]) >= 2
    if train:  # every third of the test phase's pair list
        full = pairs.PairComplementNuscenesDataset(
            "test", config=_cfg(default_config, nusc_root))
        assert len(ds[0].files[0]) == 5  # with the neighbourhoods
        assert [f[:3] for f in ds[0].files] == [
            f[:3] for f in full.files[::3][:1200]]
    idx = range(2)
    for a, b in zip(_samples(ds[0], idx, pool), _samples(ds[1], idx)):
        _assert_equal(a, b)
        assert a["pmask0"].sum() > 100
        if train:
            assert a["nghb_mask0"].any() and a["nghb_mask1"].any()
    if not train:
        log, t0, t1 = ds[0].files[0][:3]
        poses = np.load(os.path.join(nusc_root, "dataset", "sequences",
                                     log, "poses.npy"))
        ds[0].test_augmentation = False  # (the reference hard-codes True)
        s = _samples(ds[0], [0], pool)[0]
        np.testing.assert_array_equal(
            s["trans"],
            (np.linalg.inv(poses[t1]) @ poses[t0]).astype(np.float32))
    _check_pool(pool)


def test_lonuscenes_fixed_list_matches_gcl_tpu(nusc_root):
    """LoNUSCENES: the test phase takes config/file_LoNUSCENES_50.npy's 994
    (log name, t0, t1) rows, as gcl_tpu does, from any working
    directory."""
    ds = [mod.PairComplementNuscenesDataset(
        "test", config=_cfg(make, nusc_root, LoNUSCENES=True),
        random_rotation=False, random_scale=False)
          for mod, make in ((pairs, default_config),
                            (jpairs, j_default_config))]
    assert ds[0].files == ds[1].files and len(ds[0].files) == 994
    log, t0, t1 = ds[0].files[0]
    assert isinstance(log, str) and log.startswith("n008-")
    assert isinstance(t0, int) and isinstance(t1, int)


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti")
    synthetic.generate_synthetic_kitti(str(root), n_drives=1, n_frames=40,
                                       step=2.0)
    synthetic.write_split_files(str(root / "config"), 1)
    return root


def test_kitti_datasets_match_gcl_tpu(kitti_root, pool, monkeypatch):
    """ColocationKittiDataset and PairComplementKittiDataset (train
    phase, SLAM poses, neighbourhoods): two samples each equal to
    gcl_tpu's."""
    files = {p: os.path.join(str(kitti_root), "config", f"{p}_kitti.txt")
             for p in ("train", "val", "test")}
    for cls in (colocation.ColocationKittiDataset,
                jcoloc.ColocationKittiDataset,
                pairs.PairComplementKittiDataset,
                jpairs.PairComplementKittiDataset):
        monkeypatch.setattr(cls, "DATA_FILES", files)
    kw = dict(random_rotation=True, random_scale=True)
    for ours_cls, ref_cls in (
            (colocation.ColocationKittiDataset, jcoloc.ColocationKittiDataset),
            (pairs.PairComplementKittiDataset,
             jpairs.PairComplementKittiDataset)):
        ds = [cls("train", config=_cfg(make, kitti_root, use_old_pose=False),
                  **kw)
              for cls, make in ((ours_cls, default_config),
                                (ref_cls, j_default_config))]
        assert ds[0].files == ds[1].files and len(ds[0]) >= 2
        for a, b in zip(_samples(ds[0], range(2), pool),
                        _samples(ds[1], range(2))):
            _assert_equal(a, b)
    _check_pool(pool)

