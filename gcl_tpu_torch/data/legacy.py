"""Legacy FCGF datasets (a copy of gcl_tpu/data/legacy.py, reference
lib/data_loaders.py:94-729): 3DMatch fragment pairs and the original
KITTI pair samplers, selectable by config.dataset.

Samples are emitted in the same padded-array dict format as data/pairs.py
(points0/points1/trans/search_radius) so the same device pipeline and
trainers consume them.
"""
from __future__ import annotations

import glob
import logging
import os
from typing import Dict, List

import numpy as np

from ..utils.trajectory import read_trajectory
from . import kitti_io
from .pairs import _cap_points, _pad_points, apply_transform
from .transforms import sample_random_trans


class PairDatasetBase:
    """Shared augmentation/config handling (reference :94-132)."""

    AUGMENT = None

    def __init__(self, phase, transform=None, random_rotation=True,
                 random_scale=True, manual_seed=False, config=None):
        self.phase = phase
        self.files: List = []
        self.transform = transform
        self.voxel_size = config.voxel_size
        self.matching_search_voxel_size = (
            config.voxel_size
            * config.positive_pair_search_voxel_size_multiplier)
        self.random_scale = random_scale
        self.min_scale = config.min_scale
        self.max_scale = config.max_scale
        self.random_rotation = random_rotation
        self.rotation_range = config.rotation_range
        self.randg = np.random.RandomState()
        self.config = config
        self.p_cap = int(getattr(config, "point_capacity", 131072))
        if manual_seed:
            self.reset_seed()

    def reset_seed(self, seed=0):
        logging.info(f"Resetting the data loader seed to {seed}")
        self.randg.seed(seed)

    def __len__(self):
        return len(self.files)

    def _pack(self, xyz0, xyz1, trans, search_radius, meta):
        p0, m0 = _pad_points(_cap_points(
            xyz0.astype(np.float32), self.p_cap, np.random), self.p_cap)
        p1, m1 = _pad_points(_cap_points(
            xyz1.astype(np.float32), self.p_cap, np.random), self.p_cap)
        return {"points0": p0, "pmask0": m0, "points1": p1, "pmask1": m1,
                "trans": trans.astype(np.float32),
                "search_radius": np.float32(search_radius), "meta": meta}

    def _augment_pair(self, xyz0, xyz1, trans_gt):
        """Random scale + per-cloud rotation (reference :221-247 pattern).
        Returns (xyz0, xyz1, trans, search_radius)."""
        search_radius = self.matching_search_voxel_size
        if self.random_scale and np.random.rand() < 0.95:
            scale = self.min_scale + \
                (self.max_scale - self.min_scale) * np.random.rand()
            search_radius *= scale
            xyz0 = scale * xyz0
            xyz1 = scale * xyz1
            trans_gt = trans_gt.copy()
            trans_gt[:3, 3] = scale * trans_gt[:3, 3]
        if self.random_rotation:
            t0 = sample_random_trans(xyz0, self.randg, self.rotation_range)
            t1 = sample_random_trans(xyz1, self.randg, self.rotation_range)
            trans = t1 @ trans_gt @ np.linalg.inv(t0)
            xyz0 = apply_transform(xyz0, t0)
            xyz1 = apply_transform(xyz1, t1)
        else:
            trans = trans_gt
        return xyz0, xyz1, trans, search_radius


class ThreeDMatchTestDataset(PairDatasetBase):
    """3DMatch test fragments with gt.log poses (reference :135-183)."""

    DATA_FILES = {"test": "./config/test_3dmatch.txt"}

    def __init__(self, phase, transform=None, random_rotation=True,
                 random_scale=True, manual_seed=False, scene_id=None,
                 config=None, return_ply_names=False):
        super().__init__(phase, transform, random_rotation, random_scale,
                         manual_seed, config)
        assert phase == "test", "Supports only the test set."
        self.root = config.threed_match_dir
        subset_names = open(self.DATA_FILES[phase]).read().split()
        if scene_id is not None:
            subset_names = [subset_names[scene_id]]
        for sname in subset_names:
            traj_file = os.path.join(self.root,
                                     sname + "-evaluation/gt.log")
            assert os.path.exists(traj_file)
            for ctraj in read_trajectory(traj_file):
                self.files.append((sname, ctraj.metadata[0],
                                   ctraj.metadata[1], ctraj.pose))
        self.return_ply_names = return_ply_names

    def __getitem__(self, idx):
        from ..utils.pointcloud import read_ply_xyz

        sname, i, j, t_gt = self.files[idx]
        ply0 = os.path.join(self.root, sname, f"cloud_bin_{i}.ply")
        ply1 = os.path.join(self.root, sname, f"cloud_bin_{j}.ply")
        if self.return_ply_names:
            return sname, ply0, ply1, t_gt
        return sname, read_ply_xyz(ply0), read_ply_xyz(ply1), t_gt


class IndoorPairDataset(PairDatasetBase):
    """3DMatch npz fragment pairs with overlap lists (reference
    :186-281)."""

    OVERLAP_RATIO = None
    DATA_FILES = {
        "train": "./config/train_3dmatch.txt",
        "val": "./config/val_3dmatch.txt",
        "test": "./config/test_3dmatch.txt",
    }

    def __init__(self, phase, transform=None, random_rotation=True,
                 random_scale=True, manual_seed=False, config=None):
        super().__init__(phase, transform, random_rotation, random_scale,
                         manual_seed, config)
        self.root = root = config.threed_match_dir
        logging.info(f"Loading the subset {phase} from {root}")
        subset_names = open(self.DATA_FILES[phase]).read().split()
        for name in subset_names:
            fname = name + "*%.2f.txt" % self.OVERLAP_RATIO
            fnames_txt = glob.glob(root + "/" + fname)
            assert len(fnames_txt) > 0, \
                f"Make sure that the path {root} has data {fname}"
            for fname_txt in fnames_txt:
                with open(fname_txt) as f:
                    content = f.readlines()
                for line in content:
                    parts = line.strip().split()
                    self.files.append([parts[0], parts[1]])

    def __getitem__(self, idx) -> Dict:
        data0 = np.load(os.path.join(self.root, self.files[idx][0]))
        data1 = np.load(os.path.join(self.root, self.files[idx][1]))
        xyz0 = data0["pcd"]
        xyz1 = data1["pcd"]
        xyz0, xyz1, trans, radius = self._augment_pair(
            xyz0, xyz1, np.identity(4))
        return self._pack(xyz0, xyz1, trans, radius,
                          tuple(self.files[idx]))


class ThreeDMatchPairDataset(IndoorPairDataset):
    OVERLAP_RATIO = 0.3


class KITTIPairDataset(PairDatasetBase):
    """Original FCGF KITTI pairs: frames `kitti_max_time_diff` apart,
    ICP-refined odometry GT with on-disk cache (reference :284-536)."""

    DATA_FILES = {
        "train": "./config/train_kitti.txt",
        "val": "./config/val_kitti.txt",
        "test": "./config/test_kitti.txt",
    }
    TEST_RANDOM_ROTATION = False
    IS_ODOMETRY = True
    MIN_TIME_DIFF = 2

    def __init__(self, phase, transform=None, random_rotation=True,
                 random_scale=True, manual_seed=False, config=None):
        if phase == "test":
            random_rotation = self.TEST_RANDOM_ROTATION
        super().__init__(phase, transform, random_rotation, random_scale,
                         manual_seed, config)
        self.root = config.kitti_root + "/dataset"
        self.max_time_diff = config.kitti_max_time_diff
        self.icp_path = os.path.join(config.kitti_root, "icp")
        os.makedirs(self.icp_path, exist_ok=True)
        logging.info(f"Loading the subset {phase} from {self.root}")
        self._prepare(phase)
        print(f"Data size for phase {phase}: {len(self.files)}")

    def _prepare(self, phase):
        drives = [int(d)
                  for d in open(self.DATA_FILES[phase]).read().split()]
        for drive in drives:
            inames = kitti_io.scan_ids(self.root, drive)
            for start_time in inames:
                for time_diff in range(self.MIN_TIME_DIFF,
                                       self.max_time_diff):
                    pair_time = time_diff + start_time
                    if pair_time in inames:
                        self.files.append((drive, start_time, pair_time))

    def _gt(self, drive, t0, t1, xyz0, xyz1):
        """ICP-refined odometry GT with the reference cache layout."""
        from ..reg.icp import registration_icp, voxel_downsample

        key = "%d_%d_%d" % (drive, t0, t1)
        filename = self.icp_path + "/" + key + ".npy"
        if os.path.exists(filename):
            return np.load(filename)
        poses = kitti_io.odometry_poses(self.root, drive)
        m = kitti_io.odometry_pair_transform(poses[t1], poses[t0])
        sub0 = voxel_downsample(xyz0, 0.05)
        sub1 = voxel_downsample(xyz1, 0.05)
        reg = registration_icp(apply_transform(sub0, m), sub1, 0.2,
                               max_iteration=200)
        m2 = m @ reg
        np.save(filename, m2)
        return m2

    def __getitem__(self, idx) -> Dict:
        drive, t0, t1 = self.files[idx]
        xyz0 = kitti_io.read_velodyne_bin(
            kitti_io.scan_path(self.root, drive, t0))
        xyz1 = kitti_io.read_velodyne_bin(
            kitti_io.scan_path(self.root, drive, t1))
        m2 = self._gt(drive, t0, t1, xyz0, xyz1)
        xyz0, xyz1, trans, radius = self._augment_pair(xyz0, xyz1, m2)
        return self._pack(xyz0, xyz1, trans, radius, (drive, t0, t1))


class KITTINMPairDataset(KITTIPairDataset):
    """Pairs at least min_sample_frame_dist (10 m) apart
    (reference :539-626)."""

    def _prepare(self, phase):
        drives = [int(d)
                  for d in open(self.DATA_FILES[phase]).read().split()]
        min_dist = self.config.min_sample_frame_dist
        for drive in drives:
            inames = kitti_io.scan_ids(self.root, drive)
            poses = kitti_io.odometry_poses(self.root, drive)
            Ts = poses[:, :3, 3]
            curr = inames[0]
            while curr in inames:
                d = np.sqrt(((Ts[curr:curr + 1000] - Ts[curr]) ** 2
                             ).sum(-1))
                nxt = np.where(d > min_dist)[0]
                if len(nxt) == 0:
                    break
                nxt = int(nxt[0]) + curr
                if nxt in inames:
                    self.files.append((drive, curr, nxt))
                curr = nxt


class KITTIRandDistPairDataset(KITTIPairDataset):
    """Pairs at random distance d ~ U(5, 45) m (reference :638-729)."""

    def _prepare(self, phase):
        drives = [int(d)
                  for d in open(self.DATA_FILES[phase]).read().split()]
        np.random.seed(0)
        for drive in drives:
            inames = kitti_io.scan_ids(self.root, drive)
            poses = kitti_io.odometry_poses(self.root, drive)
            Ts = poses[:, :3, 3]
            curr = inames[0]
            while curr in inames:
                dist = 5 + np.random.rand() * 40
                d = np.sqrt(((Ts[curr:curr + 1000] - Ts[curr]) ** 2
                             ).sum(-1))
                nxt = np.where(d > dist)[0]
                if len(nxt) == 0:
                    break
                nxt = int(nxt[0]) + curr
                if nxt in inames:
                    self.files.append((drive, curr, nxt))
                curr = nxt + 1
