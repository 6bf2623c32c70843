"""Colocation (GCL) training datasets, host side (port of
gcl_tpu/data/colocation.py: ColocationDatasetBase, ColocationKittiDataset,
ColocationNuscenesDataset).

The host samples a centre frame and its neighbourhood frames in distance
bands along the trajectory, loads the scans, applies the SE(3) + scale
augmentation and emits fixed-capacity point arrays; voxelization and the
colocation-group search run on the device (data/device_pipeline.py). The
helpers it shares with the pair datasets (DATA_FILES, apply_transform,
_cap_points, _pad_points) live in data/pairs.py. Each sample hints its
scans to the native async reader before reading them
(data/kitti_io.py:prefetch_scans).
"""
from __future__ import annotations

import logging
import os
from typing import Dict, List

import numpy as np

from . import kitti_io
from .pairs import DATA_FILES, _cap_points, _pad_points, apply_transform
from .transforms import follow_presampled_trans, sample_random_trans


class ColocationDatasetBase:
    """Shared logic for KITTI/nuScenes colocation sampling."""

    def __init__(self, phase, transform=None, random_rotation=True,
                 random_scale=True, manual_seed=False, config=None):
        assert phase == "train", (
            "Colocation Data Loader loads a point cloud and its "
            "neighbourhood, which is only meaningful during training time!")
        self.phase = phase
        self.files: List = []
        self.transform = transform
        self.voxel_size = config.voxel_size
        self.random_scale = random_scale
        self.min_scale = config.min_scale
        self.max_scale = config.max_scale
        self.random_rotation = random_rotation
        self.rotation_range = config.rotation_range
        self.randg = np.random.RandomState()
        if manual_seed:
            self.reset_seed()
        self.config = config

        self.matching_search_voxel_size = (
            config.voxel_size
            * config.positive_pair_search_voxel_size_multiplier)
        self.MIN_DIST = config.min_dist
        self.MAX_DIST = config.max_dist
        self.num_neighborhood = config.num_neighborhood
        assert self.num_neighborhood % 2 == 0, \
            "Parameter 'num_neighborhood' must be even!"
        # reference: random point discard only for fine voxels (:158-161)
        if config.voxel_size < 0.2:
            self.max_in_p = config.max_in_p
        else:
            self.max_in_p = int(getattr(config, "point_capacity", 131072))
        self.p_cap = min(int(getattr(config, "point_capacity", 131072)),
                         self.max_in_p)
        self.area_length_per_neighbor = (2 * self.MAX_DIST
                                         / self.num_neighborhood)
        assert self.MIN_DIST < self.area_length_per_neighbor, (
            "MIN_DIST is too high compared to area_length_per_neighbor! "
            "Lower MIN_DIST or lower num_neighborhood instead.")

    def reset_seed(self, seed=0):
        logging.info(f"Resetting the data loader seed to {seed}")
        self.randg.seed(seed)

    def __len__(self):
        return len(self.files)

    # -- provided by subclasses ---------------------------------------
    def _poses(self, drive):
        raise NotImplementedError

    def _scan_path(self, drive, t):
        raise NotImplementedError

    def _xyz(self, drive, t):
        return kitti_io.read_velodyne_bin(self._scan_path(drive, t))

    def _prefetch(self, drive, ts):
        kitti_io.prefetch_scans(self._scan_path(drive, t) for t in ts)

    def _neighborhood_frames(self, frame: int):
        """Sample num_neighborhood frames in per-ring distance bands, half
        behind / half ahead (reference :254-295)."""
        list_complement = []
        half = int(self.num_neighborhood / 2)
        bound = max(0, frame - int(10 * self.MAX_DIST))
        left = np.sqrt(
            ((self.Ts[bound:frame] - self.Ts[frame]) ** 2).sum(-1))
        for i in range(half):
            lo = max(self.MIN_DIST, self.area_length_per_neighbor * i)
            hi = max(self.MIN_DIST, self.area_length_per_neighbor * (i + 1))
            d = lo + np.random.rand() * (hi - lo)
            cand = np.where(left > d)[0]
            if len(cand) == 0:
                return True, []
            list_complement.append(bound + cand[-1])
        right = np.sqrt(
            ((self.Ts[frame:frame + int(10 * self.MAX_DIST)]
              - self.Ts[frame]) ** 2).sum(-1))
        for i in range(half):
            lo = max(self.MIN_DIST, self.area_length_per_neighbor * i)
            hi = max(self.MIN_DIST, self.area_length_per_neighbor * (i + 1))
            d = lo + np.random.rand() * (hi - lo)
            cand = np.where(right > d)[0]
            if len(cand) == 0:
                return True, []
            list_complement.append(frame + cand[0])
        return False, list_complement

    def _build_index(self, drives, center_step=11):
        for drive in drives:
            inames = self._scan_ids(drive)
            all_pos = self._poses(drive)
            self.Ts = all_pos[:, :3, 3]
            curr_time = inames[min(int(self.MAX_DIST * 5),
                                   int(len(inames) / 2))]
            np.random.seed(0)
            while curr_time in inames:
                skip, nghb = self._neighborhood_frames(curr_time)
                if skip:
                    curr_time += 1
                else:
                    self.files.append((drive, curr_time, nghb))
                    curr_time += center_step  # reference :204

    def __getitem__(self, idx) -> Dict[str, np.ndarray]:
        drive, t, t_cmpl = self.files[idx]
        all_pos = self._poses(drive)
        pos = all_pos[t]
        pos_cmpl = [all_pos[tt] for tt in t_cmpl]
        # hint all of the sample's scans to the native async reader so
        # the 1 + num_neighborhood disk reads overlap
        self._prefetch(drive, [t] + list(t_cmpl))

        xyz = _cap_points(self._xyz(drive, t), self.max_in_p, np.random)
        xyz_cmpl = [
            _cap_points(self._xyz(drive, tt), self.max_in_p, np.random)
            for tt in t_cmpl]

        # GT: neighbor -> center frame (reference :343-346)
        list_m = [np.linalg.inv(pos) @ p for p in pos_cmpl]

        if self.random_rotation:
            t0 = sample_random_trans(xyz, self.randg, np.pi / 4)
            xyz = apply_transform(xyz, t0)
            for i, x in enumerate(xyz_cmpl):
                tc = follow_presampled_trans(x, t0)
                xyz_cmpl[i] = apply_transform(x, tc)
                list_m[i] = t0 @ list_m[i] @ np.linalg.inv(tc)

        search_radius = self.matching_search_voxel_size
        if self.random_scale and np.random.rand() < 0.95:
            scale = self.min_scale + \
                (self.max_scale - self.min_scale) * np.random.rand()
            search_radius *= scale
            xyz = scale * xyz
            for i in range(len(xyz_cmpl)):
                xyz_cmpl[i] = scale * xyz_cmpl[i]
                list_m[i][:3, 3] = scale * list_m[i][:3, 3]

        c = 1 + len(xyz_cmpl)
        points = np.zeros((c, self.p_cap, 3), np.float32)
        pmask = np.zeros((c, self.p_cap), bool)
        points[0], pmask[0] = _pad_points(
            _cap_points(xyz, self.p_cap, np.random), self.p_cap)
        transforms = np.stack(
            [np.eye(4, dtype=np.float32)]
            + [m.astype(np.float32) for m in list_m])
        for i, x in enumerate(xyz_cmpl):
            points[i + 1], pmask[i + 1] = _pad_points(
                _cap_points(x, self.p_cap, np.random), self.p_cap)
        return {
            "points": points,            # [C, P, 3] own frames
            "pmask": pmask,              # [C, P]
            "transforms": transforms,    # [C, 4, 4] cloud -> center frame
            "search_radius": np.float32(search_radius),
            "meta": (drive, t, tuple(t_cmpl)),
        }


class ColocationKittiDataset(ColocationDatasetBase):
    """GCL-KITTI training sampler (reference :125-421). GT poses from
    SemanticKITTI SLAM (use_old_pose=false in the shipped GCL configs)."""

    DATA_FILES = DATA_FILES

    def __init__(self, phase, transform=None, random_rotation=True,
                 random_scale=True, manual_seed=False, config=None):
        super().__init__(phase, transform, random_rotation, random_scale,
                         manual_seed, config)
        self.root = config.kitti_root + "/dataset"
        logging.info(f"Loading the subset {phase} from {self.root}")
        drives = [int(d) for d in
                  open(self.DATA_FILES[phase]).read().split()]
        self._build_index(drives)
        print(f"Data size for phase {phase}: {len(self.files)}")

    def _scan_ids(self, drive):
        return kitti_io.scan_ids(self.root, drive)

    def _poses(self, drive):
        return kitti_io.slam_poses(self.root, drive)

    def _scan_path(self, drive, t):
        return kitti_io.scan_path(self.root, drive, t)


class ColocationNuscenesDataset(ColocationDatasetBase):
    """GCL-nuScenes training sampler over nuScenes-as-KITTI exports
    (reference :478-699): sequences/<log>/velodyne/*.bin + poses.npy."""

    def __init__(self, phase, transform=None, random_rotation=True,
                 random_scale=True, manual_seed=False, config=None):
        super().__init__(phase, transform, random_rotation, random_scale,
                         manual_seed, config)
        self.root = config.kitti_root + "/dataset"
        logging.info(f"Loading the subset {phase} from {self.root}")
        seq_dir = os.path.join(self.root, "sequences")
        logs = sorted(os.listdir(seq_dir))
        self._build_index(logs)
        print(f"Data size for phase {phase}: {len(self.files)}")

    def _scan_ids(self, dirname):
        import glob
        import os.path as osp
        fnames = glob.glob(
            osp.join(self.root, "sequences", str(dirname),
                     "velodyne", "*.bin"))
        assert fnames, f"no scans under {dirname}"
        return sorted(int(osp.split(f)[-1][:-4]) for f in fnames)

    def _poses(self, dirname):
        return kitti_io.nuscenes_poses(self.root, str(dirname))

    def _scan_path(self, dirname, t):
        return os.path.join(self.root, "sequences", str(dirname),
                            "velodyne", "%06d.bin" % t)
