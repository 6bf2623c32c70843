"""The port's legacy FCGF datasets (data/legacy.py), their loader dispatch
and the pose-graph cache CLI (data/posegraph.py) against gcl_tpu's, on a
synthetic 3DMatch root (fragments as .ply and .npz, gt.log, overlap lists,
split files) and the synthetic mini-KITTI. All of it is numpy on the host:
with np.random and each dataset's randg seeded alike before each
package's sample, samples are equal bit for bit. Each package fills the
ICP cache of its own copy of the mini-KITTI.
"""
import os

import numpy as np
import pytest

from gcl_tpu.config import default_config as j_default_config
from gcl_tpu.data import legacy as jlegacy
from gcl_tpu.data import make_data_loader as j_make_data_loader
from gcl_tpu.data import pairs as jpairs
from gcl_tpu.data import posegraph as jposegraph
from gcl_tpu_torch.config import default_config
from gcl_tpu_torch.data import legacy, loader, pairs, posegraph, synthetic
from gcl_tpu_torch.utils.pointcloud import write_ply_xyz

LEGACY = ("ThreeDMatchPairDataset", "ThreeDMatchTestDataset",
          "KITTIPairDataset", "KITTINMPairDataset",
          "KITTIRandDistPairDataset")
SCENE = "7-scenes-redkitchen"


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """{"ref", "ours"}: a 3DMatch root and a mini-KITTI root each, with
    the split files of both under <root>/config."""
    out = {}
    rng = np.random.RandomState(0)
    frags = [(rng.rand(700, 3) * [3, 3, 2]).astype(np.float32)
             for _ in range(3)]
    for name in ("ref", "ours"):
        base = tmp_path_factory.mktemp(name)
        threed = base / "threed"
        (threed / SCENE).mkdir(parents=True)
        (threed / f"{SCENE}-evaluation").mkdir()
        with open(threed / f"{SCENE}-evaluation" / "gt.log", "w") as f:
            for i, j in ((0, 1), (1, 2)):
                f.write(f"{i}\t{j}\t3\n")
                np.savetxt(f, np.eye(4) + 0.01 * (i + j), fmt="%.8f")
        for i, x in enumerate(frags):
            write_ply_xyz(str(threed / SCENE / f"cloud_bin_{i}.ply"), x)
            np.savez(threed / f"{SCENE}@seq-01_{i:03d}.npz", pcd=x)
        with open(threed / f"{SCENE}@seq-01-0.30.txt", "w") as f:
            f.write(f"{SCENE}@seq-01_000.npz {SCENE}@seq-01_001.npz 0.5\n"
                    f"{SCENE}@seq-01_001.npz {SCENE}@seq-01_002.npz 0.4\n")
        kitti = base / "kitti"
        synthetic.generate_synthetic_kitti(str(kitti), n_drives=1,
                                           n_frames=20, step=2.0)
        cfg_dir = base / "config"
        synthetic.write_split_files(str(cfg_dir), 1)
        for phase in ("train", "val", "test"):
            (cfg_dir / f"{phase}_3dmatch.txt").write_text(SCENE + "\n")
        out[name] = base
    return out


def _cfg(make, base, **kw):
    cfg = make(threed_match_dir=str(base / "threed"),
               kitti_root=str(base / "kitti"), voxel_size=0.3,
               point_capacity=2048, use_random_scale=True,
               use_random_rotation=True, pair_min_dist=3, pair_max_dist=10,
               complement_pair_dist=2.0, num_complement_one_side=1,
               use_old_pose=True)
    cfg.update(kw)
    return cfg


@pytest.fixture
def splits(monkeypatch, roots):
    """Both packages' datasets read the split files of their own root."""
    for mods, base in (((jlegacy, jpairs), roots["ref"]),
                       ((legacy, pairs), roots["ours"])):
        lg, pr = mods
        cfg_dir = base / "config"
        threed = {p: str(cfg_dir / f"{p}_3dmatch.txt")
                  for p in ("train", "val", "test")}
        kitti = {p: str(cfg_dir / f"{p}_kitti.txt")
                 for p in ("train", "val", "test")}
        for cls in (lg.ThreeDMatchTestDataset, lg.IndoorPairDataset):
            monkeypatch.setattr(cls, "DATA_FILES", threed)
        monkeypatch.setattr(lg.KITTIPairDataset, "DATA_FILES", kitti)
        monkeypatch.setattr(pr.PairComplementKittiDataset, "DATA_FILES",
                            kitti)


def _assert_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_equal(a[k], b[k])
    elif isinstance(a, (tuple, list)) and not isinstance(a, str):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_equal(x, y)
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,phase", [
    ("ThreeDMatchTestDataset", "test"), ("ThreeDMatchPairDataset", "train"),
    ("KITTIPairDataset", "train"), ("KITTIPairDataset", "test"),
    ("KITTINMPairDataset", "val"), ("KITTIRandDistPairDataset", "train")])
def test_legacy_samples_equal(roots, splits, name, phase):
    ds = []
    for mod, make, base in ((legacy, default_config, roots["ours"]),
                            (jlegacy, j_default_config, roots["ref"])):
        ds.append(getattr(mod, name)(phase, random_rotation=True,
                                     random_scale=True,
                                     config=_cfg(make, base)))
    ours, ref = ds
    _assert_equal(ours.files, ref.files)
    assert len(ours) >= 1
    for i in range(min(len(ours), 2)):
        got = []
        for d in (ours, ref):
            np.random.seed(20 + i)
            d.reset_seed(5 + i)
            got.append(d[i])
        _assert_equal(*got)
        if isinstance(got[0], dict):
            assert got[0]["pmask0"].sum() > 100


def test_legacy_loader_dispatch(roots, splits):
    """make_data_loader picks the same class with the same settings from
    config.dataset (val / test) and config.train_dataset (train), and the
    first batches are equal."""
    for name in LEGACY:
        for phase in ("train", "val", "test"):
            if name == "ThreeDMatchTestDataset" and phase != "test":
                continue  # it has only a test set
            kw = dict(dataset=name, train_dataset=name)
            got = []
            for make_loader, make, base in (
                    (loader.make_data_loader, default_config,
                     roots["ours"]),
                    (j_make_data_loader, j_default_config, roots["ref"])):
                got.append(make_loader(_cfg(make, base, **kw), phase, 1))
            ours, ref = got
            for d in (ours.dataset, ref.dataset):
                assert type(d).__name__ == name
            _assert_equal(ours.dataset.files, ref.dataset.files)
            for attr in ("random_rotation", "random_scale", "shuffle",
                         "drop_last"):
                obj = "dataset" if attr.startswith("random") else None
                a = getattr(ours.dataset if obj else ours, attr)
                assert a == getattr(ref.dataset if obj else ref, attr)
    batches = []
    for make_loader, make, base in (
            (loader.make_data_loader, default_config, roots["ours"]),
            (j_make_data_loader, j_default_config, roots["ref"])):
        np.random.seed(3)
        data = make_loader(_cfg(make, base,
                                dataset="ThreeDMatchPairDataset"), "val", 2)
        batches.append(next(iter(data)))
    _assert_equal(*batches)


def test_posegraph_cache_cli_matches(roots, splits):
    """build_cache(limit=1) writes the files gcl_tpu's writes, with equal
    arrays; python -m gcl_tpu_torch.data.posegraph's main on the CPU then
    writes the rest, and a second run finds them all written."""
    names = []
    for mod, make, base in ((posegraph, default_config, roots["ours"]),
                            (jposegraph, j_default_config, roots["ref"])):
        icp = base / "kitti" / "icp"
        before = set(os.listdir(icp)) if icp.exists() else set()
        n = mod.build_cache(_cfg(make, base), phase="train", limit=1)
        new = sorted(set(os.listdir(icp)) - before)
        assert n == len(new) >= 2
        names.append(new)
    assert names[0] == names[1]
    for f in names[0]:
        np.testing.assert_array_equal(
            np.load(roots["ours"] / "kitti" / "icp" / f),
            np.load(roots["ref"] / "kitti" / "icp" / f))
    # the entry point on the CPU fills the rest of the train phase's cache
    icp = roots["ours"] / "kitti" / "icp"
    before = set(os.listdir(icp))
    argv = ["--device", "cpu", "--kitti_root", str(roots["ours"] / "kitti"),
            "--voxel_size", "0.3", "--point_capacity", "2048",
            "--pair_min_dist", "3", "--pair_max_dist", "10",
            "--complement_pair_dist", "2.0", "--num_complement_one_side",
            "1", "--use_old_pose", "true"]
    n = posegraph.main(argv)
    assert n == len(set(os.listdir(icp)) - before) > 0
    assert posegraph.main(argv) == 0  # every file is there now
