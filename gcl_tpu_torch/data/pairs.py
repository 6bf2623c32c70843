"""Pair datasets (FCGF training; GCL validation/testing), host side: a
port of gcl_tpu/data/pairs.py, with the helpers it takes from
gcl_tpu/data/colocation.py (DATA_FILES, apply_transform, _cap_points,
_pad_points) copied here.

PairComplementKittiDataset / PairComplementNuscenesDataset rebuild the
reference's lib/complement_data_loader.py:110-1221. Pair sampling along the
trajectory at d ~ U(pair_min_dist, pair_max_dist), hand-curated bad-pair
blacklist, LoKITTI/LoNuScenes fixed pair lists, complement-frame loading
for the train phase, ICP-refined GT (our own ICP, reg/icp.py) with the
same on-disk `icp/` cache format. Voxelization + GT-correspondence search
move to the device pipeline; the host emits padded point arrays.
"""
from __future__ import annotations

import logging
import os
import pathlib
from typing import Dict, List

import numpy as np

from ..reg.icp import registration_icp, voxel_downsample
from . import kitti_io
from .transforms import sample_random_trans

_icp_cache: Dict[str, np.ndarray] = {}

DATA_FILES = {
    "train": "./config/train_kitti.txt",
    "val": "./config/val_kitti.txt",
    "test": "./config/test_kitti.txt",
}


def apply_transform(pts: np.ndarray, trans: np.ndarray) -> np.ndarray:
    trans = trans.astype(np.float32)
    return pts @ trans[:3, :3].T + trans[:3, 3]


def _cap_points(xyz: np.ndarray, p_cap: int, rng) -> np.ndarray:
    if xyz.shape[0] > p_cap:
        sel = rng.choice(xyz.shape[0], size=p_cap, replace=False)
        return xyz[sel]
    return xyz


def _pad_points(xyz: np.ndarray, p_cap: int):
    n = xyz.shape[0]
    out = np.zeros((p_cap, 3), np.float32)
    out[:n] = xyz
    mask = np.zeros(p_cap, bool)
    mask[:n] = True
    return out, mask


def _config_asset(name: str) -> str:
    """Repo config/ fixture path (works from any cwd)."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(repo, "config", name)


class PairComplementKittiDataset:
    """Reference lib/complement_data_loader.py:110-822."""

    icp_voxel_size = 0.05
    DATA_FILES = DATA_FILES
    MIN_DIST = 5
    MAX_DIST = 40
    discard_pairs = [(5, 1151, 1220), (2, 926, 962), (2, 2022, 2054),
                     (1, 250, 266), (0, 3576, 3609), (2, 2943, 2979),
                     (1, 411, 423), (2, 2241, 2271), (0, 1536, 1607),
                     (0, 1338, 1439), (7, 784, 810), (2, 1471, 1498),
                     (2, 3829, 3862), (0, 1780, 1840), (2, 3294, 3356),
                     (2, 2420, 2453), (2, 4146, 4206), (0, 2781, 2829),
                     (0, 3351, 3451), (1, 428, 444), (0, 3073, 3147)]

    def __init__(self, phase, transform=None, random_rotation=True,
                 random_scale=True, manual_seed=False, config=None):
        self.phase = phase
        self.files: List = []
        self.transform = transform
        self.voxel_size = config.voxel_size
        self.random_scale = random_scale
        self.min_scale = config.min_scale
        self.max_scale = config.max_scale
        self.random_rotation = random_rotation
        self.randg = np.random.RandomState()
        if manual_seed:
            self.reset_seed()
        self.config = config
        # reference hard-codes test_augmentation = True (:139)
        self.test_augmentation = True

        self.root = config.kitti_root + "/dataset"
        self.matching_search_voxel_size = (
            config.voxel_size
            * config.positive_pair_search_voxel_size_multiplier)
        if getattr(config, "pair_min_dist", -1) > 0:
            self.MIN_DIST = config.pair_min_dist
        if (getattr(config, "pair_max_dist", -1) > 0
                and config.pair_max_dist >= config.pair_min_dist):
            self.MAX_DIST = config.pair_max_dist
        self.use_old_pose = getattr(config, "use_old_pose", True)
        self.icp_path = os.path.join(
            config.kitti_root, "icp" if self.use_old_pose else "icp_slam")
        pathlib.Path(self.icp_path).mkdir(parents=True, exist_ok=True)
        # debug escapes (reference lib/complement_data_loader.py:180-185):
        # force_icp recomputes GT ignoring the memory + disk caches;
        # use_old_complement selects the reference's "old" per-pair
        # complement ICP instead of multiway pose-graph refinement (:567-575)
        self.force_icp = bool(getattr(
            config, "debug_force_icp_recalculation", False))
        self.use_old_complement = bool(getattr(
            config, "debug_use_old_complement", False))

        self.mutate_neighbour_percentage = getattr(
            config, "mutate_neighbour_percentage", 0.0) or 0.0
        self.mutate_neighbour = self.mutate_neighbour_percentage != 0

        self.min_sample_frame_dist = config.min_sample_frame_dist
        self.complement_pair_dist = config.complement_pair_dist
        self.num_complement_one_side = config.num_complement_one_side
        self.complement_range = (self.num_complement_one_side
                                 * self.complement_pair_dist)
        self.load_neighbourhood = phase != "test"
        self.downsample_single = getattr(config, "downsample_single", 1.0) \
            if phase == "test" else 1.0
        self.p_cap = int(getattr(config, "point_capacity", 131072))
        self.nghb_cap = int(getattr(config, "nghb_point_capacity",
                                    self.p_cap))

        logging.info(f"Loading the subset {phase} from {self.root}")
        fixed = self._fixed_pair_list(phase)
        if fixed is not None:
            self.files = fixed
        else:
            self._prepare(phase)
        print(f"Data size for phase {phase}: {len(self.files)}")

    def _fixed_pair_list(self, phase):
        """Fixed distant-pair rows when the config selects a list
        (reference lib/complement_data_loader.py:199-201), resolved
        against the repo's config/ dir so the cwd does not matter."""
        if phase == "test" and getattr(self.config, "LoKITTI", False):
            return [tuple(int(v) for v in row) for row in
                    np.load(_config_asset("file_LoKITTI_50.npy"))]
        return None

    def reset_seed(self, seed=0):
        logging.info(f"Resetting the data loader seed to {seed}")
        self.randg.seed(seed)

    def __len__(self):
        return len(self.files)

    # ------------------------------------------------------------------
    def _all_pos(self, drive):
        if self.use_old_pose:
            cam = kitti_io.odometry_poses(self.root, drive)
            return cam
        return kitti_io.slam_poses(self.root, drive)

    def _xyz(self, drive, t):
        return kitti_io.read_velodyne_bin(
            kitti_io.scan_path(self.root, drive, t))

    def _prepare(self, phase):
        """Pair index: d ~ U(MIN,MAX) along the trajectory, both ends must
        have a full complement neighborhood (reference :206-250)."""
        drives = [int(d) for d in open(self.DATA_FILES[phase]).read().split()]
        for drive in drives:
            inames = kitti_io.scan_ids(self.root, drive)
            self.Ts = self._all_pos(drive)[:, :3, 3]
            curr_time = inames[min(int(self.complement_range * 5),
                                   int(len(inames) / 2))]
            np.random.seed(0)
            while curr_time in inames:
                dist_tmp = self.MIN_DIST + np.random.rand() * (
                    self.MAX_DIST - self.MIN_DIST)
                right_dist = np.sqrt(((
                    self.Ts[curr_time:curr_time
                            + int(10 * self.complement_range)]
                    - self.Ts[curr_time]) ** 2).sum(-1))
                next_time = np.where(right_dist > dist_tmp)[0]
                if len(next_time) == 0:
                    curr_time += 1
                    continue
                next_time = next_time[0] + curr_time - 1
                skip0, cmpl0 = self._complement_frames(curr_time)
                skip1, cmpl1 = self._complement_frames(next_time)
                skip2 = (drive, curr_time, next_time) in self.discard_pairs
                if skip0 or skip1 or (skip2 and self.use_old_pose):
                    curr_time += 1
                else:
                    if self.load_neighbourhood:
                        self.files.append(
                            (drive, curr_time, next_time, cmpl0, cmpl1))
                    else:
                        self.files.append((drive, curr_time, next_time))
                    curr_time = next_time + 1

    def _complement_frames(self, frame):
        list_complement = []
        bound = max(0, frame - int(10 * self.complement_range))
        left = np.sqrt(
            ((self.Ts[bound:frame] - self.Ts[frame]) ** 2).sum(-1))
        for i in range(self.num_complement_one_side):
            cand = np.where(left > self.complement_pair_dist * (i + 1))[0]
            if len(cand) == 0:
                return True, []
            list_complement.append(bound + cand[-1])
        right = np.sqrt(
            ((self.Ts[frame:frame + int(10 * self.complement_range)]
              - self.Ts[frame]) ** 2).sum(-1))
        for i in range(self.num_complement_one_side):
            cand = np.where(right > self.complement_pair_dist * (i + 1))[0]
            if len(cand) == 0:
                return True, []
            list_complement.append(frame + cand[0])
        return False, list_complement

    def _get_icp(self, drive, t_curr, t_next, xyz_curr, xyz_next,
                 pos_curr, pos_next):
        """GT for (curr <- next): odometry prior + our ICP refinement,
        cached as `<icp_path>/<drive>_<t_next>_<t_curr>.npy` — the exact
        reference cache format (:369-399)."""
        key = "%d_%d_%d" % (drive, t_next, t_curr)
        filename = self.icp_path + "/" + key + ".npy"
        if filename in _icp_cache and not self.force_icp:
            return _icp_cache[filename]
        if os.path.exists(filename) and not self.force_icp:
            m2 = np.load(filename)
        elif self.use_old_pose:
            # xyz args may be lazy thunks (the per-pair complement path
            # passes loaders so cache hits never touch the disk scans)
            if callable(xyz_curr):
                xyz_curr = xyz_curr()
            if callable(xyz_next):
                xyz_next = xyz_next()
            sub_curr = voxel_downsample(xyz_curr, self.icp_voxel_size)
            sub_next = voxel_downsample(xyz_next, self.icp_voxel_size)
            m = kitti_io.odometry_pair_transform(pos_curr, pos_next)
            xyzk_t = apply_transform(sub_next, m)
            reg = registration_icp(xyzk_t, sub_curr, 0.2,
                                   max_iteration=200)
            # composed exactly as the reference (M @ reg.transformation,
            # :388) so cached GT matrices stay interchangeable
            m2 = m @ reg
            np.save(filename, m2)
        else:
            m2 = np.linalg.inv(pos_curr) @ pos_next
            np.save(filename, m2)
        _icp_cache[filename] = m2
        return m2

    def _multiway_icp(self, drive, t_curr, cmpls, xyz_curr, pos_curr,
                      pos_cmpls):
        """Complement GT via multiway pose-graph refinement (reference
        multiway_registration, lib/complement_data_loader.py:466-516):
        all complements of one frame are registered jointly — all-pairs
        ICP, odometry edges certain, loop closures robustified — instead
        of pair-by-pair. Same `icp/` cache files as _get_icp."""
        names = [self.icp_path + "/%d_%d_%d.npy" % (drive, tt, t_curr)
                 for tt in cmpls]
        if all(f in _icp_cache for f in names) and not self.force_icp:
            return [_icp_cache[f] for f in names]
        if all(os.path.exists(f) for f in names) and not self.force_icp:
            ms = [np.load(f) for f in names]
            for f, m in zip(names, ms):
                _icp_cache[f] = m
            return ms

        from . import kitti_io as kio
        from .posegraph import multiway_transforms

        xyz_cmpls = [self._xyz(drive, tt) for tt in cmpls]
        odo = [kio.odometry_pair_transform(pos_curr, pp)
               for pp in pos_cmpls]
        ms = multiway_transforms(xyz_curr, xyz_cmpls, odo,
                                 self.num_complement_one_side,
                                 self.icp_voxel_size)
        for f, m in zip(names, ms):
            np.save(f, np.asarray(m))
            _icp_cache[f] = np.asarray(m)
        return ms

    # ------------------------------------------------------------------
    def __getitem__(self, idx) -> Dict[str, np.ndarray]:
        if self.load_neighbourhood:
            drive, t0, t1, cmpl0, cmpl1 = self.files[idx]
        else:
            drive, t0, t1 = self.files[idx]
            cmpl0 = cmpl1 = []
        all_pos = self._all_pos(drive)
        pos0, pos1 = all_pos[t0], all_pos[t1]
        xyz0 = self._xyz(drive, t0)
        xyz1 = self._xyz(drive, t1)

        m2 = self._get_icp(drive, t1, t0, xyz1, xyz0, pos1, pos0)

        nghb0 = nghb1 = np.zeros((0, 3), np.float32)
        if self.load_neighbourhood:
            pos_c0 = [all_pos[t] for t in cmpl0]
            pos_c1 = [all_pos[t] for t in cmpl1]
            if self.mutate_neighbour:
                for pos_cmpl in (pos_c0, pos_c1):
                    nv = int(self.mutate_neighbour_percentage
                             * 2 * self.num_complement_one_side)
                    vic = np.random.choice(
                        2 * self.num_complement_one_side, nv, replace=False)
                    for v in vic:
                        from scipy.spatial.transform import Rotation
                        ang = (np.random.rand(3) - 0.5) * np.pi * 2
                        rot = Rotation.from_euler("zyx", ang).as_matrix()
                        pos_cmpl[v] = pos_cmpl[v].copy()
                        pos_cmpl[v][:3, :3] = pos_cmpl[v][:3, :3] @ rot
            if self.use_old_pose and self.use_old_complement:
                # reference "old method" (:567-570): per-pair ICP of each
                # complement against its center, same cache files; scans
                # load lazily so cache hits skip the disk reads
                lm0 = [self._get_icp(drive, t0, tt, xyz0,
                                     lambda tt=tt: self._xyz(drive, tt),
                                     pos0, pp)
                       for tt, pp in zip(cmpl0, pos_c0)]
                lm1 = [self._get_icp(drive, t1, tt, xyz1,
                                     lambda tt=tt: self._xyz(drive, tt),
                                     pos1, pp)
                       for tt, pp in zip(cmpl1, pos_c1)]
            elif self.use_old_pose:
                lm0 = self._multiway_icp(drive, t0, cmpl0, xyz0, pos0,
                                         pos_c0)
                lm1 = self._multiway_icp(drive, t1, cmpl1, xyz1, pos1,
                                         pos_c1)
            else:
                lm0 = [np.linalg.inv(pos0) @ p for p in pos_c0]
                lm1 = [np.linalg.inv(pos1) @ p for p in pos_c1]
            c0 = [apply_transform(self._xyz(drive, tt), m)
                  for tt, m in zip(cmpl0, lm0)]
            c1 = [apply_transform(self._xyz(drive, tt), m)
                  for tt, m in zip(cmpl1, lm1)]
            nghb0 = np.concatenate(c0, 0) if c0 else nghb0
            nghb1 = np.concatenate(c1, 0) if c1 else nghb1

        # random rotation (test phase also augments: reference :598-605)
        if self.random_rotation or (self.phase == "test"
                                    and self.test_augmentation):
            rot_range = (np.pi * 2 if (self.phase != "train"
                                       and self.test_augmentation)
                         else np.pi / 4)
            t0m = sample_random_trans(xyz0, self.randg, rot_range)
            t1m = sample_random_trans(xyz1, self.randg, rot_range)
            trans = t1m @ m2 @ np.linalg.inv(t0m)
            xyz0 = apply_transform(xyz0, t0m)
            xyz1 = apply_transform(xyz1, t1m)
            if len(nghb0):
                nghb0 = apply_transform(nghb0, t0m)
            if len(nghb1):
                nghb1 = apply_transform(nghb1, t1m)
        else:
            trans = m2.copy()

        # crop complements to the center scan's radius (reference :620-628)
        if len(nghb0):
            nghb0 = nghb0[(nghb0 ** 2).sum(-1)
                          < np.max((xyz0 ** 2).sum(-1))]
        if len(nghb1):
            nghb1 = nghb1[(nghb1 ** 2).sum(-1)
                          < np.max((xyz1 ** 2).sum(-1))]

        if self.phase == "test" and self.downsample_single != 1.0:
            sel = np.random.choice(
                len(xyz0), int(len(xyz0) * self.downsample_single))
            xyz0 = xyz0[sel]

        search_radius = self.matching_search_voxel_size
        if self.random_scale and np.random.rand() < 0.95:
            scale = self.min_scale + \
                (self.max_scale - self.min_scale) * np.random.rand()
            search_radius *= scale
            xyz0 = scale * xyz0
            xyz1 = scale * xyz1
            trans = trans.copy()
            trans[:3, 3] = scale * trans[:3, 3]

        p0, m0 = _pad_points(_cap_points(xyz0, self.p_cap, np.random),
                             self.p_cap)
        p1, m1 = _pad_points(_cap_points(xyz1, self.p_cap, np.random),
                             self.p_cap)
        n0, nm0 = _pad_points(
            _cap_points(nghb0.astype(np.float32), self.nghb_cap, np.random),
            self.nghb_cap)
        n1, nm1 = _pad_points(
            _cap_points(nghb1.astype(np.float32), self.nghb_cap, np.random),
            self.nghb_cap)
        return {
            "points0": p0, "pmask0": m0,
            "points1": p1, "pmask1": m1,
            "nghb0": n0, "nghb_mask0": nm0,
            "nghb1": n1, "nghb_mask1": nm1,
            "trans": trans.astype(np.float32),  # maps cloud0 -> cloud1
            "search_radius": np.float32(search_radius),
            "meta": (drive, t0, t1),
        }


class PairComplementNuscenesDataset(PairComplementKittiDataset):
    """nuScenes pairs (reference :825-1221): poses trusted directly (no
    ICP), LoNuScenes fixed 994-pair list, train subsample [::3][:1200]."""

    MIN_DIST = 5
    MAX_DIST = 40

    def __init__(self, phase, transform=None, random_rotation=True,
                 random_scale=True, manual_seed=False, config=None):
        self._phase_for_init = phase
        super().__init__(phase, transform, random_rotation, random_scale,
                         manual_seed, config)

    def _fixed_pair_list(self, phase):
        # reference lib/complement_data_loader.py:889-891: the LoNuScenes
        # fixed 994-pair list ((log_name, t0, t1) object rows) replaces
        # test-phase pair sampling
        if phase == "test" and getattr(self.config, "LoNUSCENES", False):
            rows = np.load(_config_asset("file_LoNUSCENES_50.npy"),
                           allow_pickle=True)
            return [(str(r[0]), int(r[1]), int(r[2])) for r in rows]
        return None

    def _all_pos(self, dirname):
        return kitti_io.nuscenes_poses(self.root, str(dirname))

    def _xyz(self, dirname, t):
        return kitti_io.read_velodyne_bin(
            os.path.join(self.root, "sequences", str(dirname),
                         "velodyne", "%06d.bin" % t))

    def _get_icp(self, drive, t_curr, t_next, xyz_curr, xyz_next,
                 pos_curr, pos_next):
        # nuScenes GT poses are trusted directly (reference :1035)
        return np.linalg.inv(pos_curr) @ pos_next

    def _multiway_icp(self, drive, t_curr, cmpls, xyz_curr, pos_curr,
                      pos_cmpls):
        # no ICP / pose graph for nuScenes either — trusted poses
        return [np.linalg.inv(pos_curr) @ pp for pp in pos_cmpls]

    def _prepare(self, phase):
        seq_dir = os.path.join(self.root, "sequences")
        logs = sorted(os.listdir(seq_dir))
        for dirname in logs:
            inames = self._scan_ids(dirname)
            self.Ts = self._all_pos(dirname)[:, :3, 3]
            curr_time = inames[min(int(self.complement_range * 5),
                                   int(len(inames) / 2))]
            np.random.seed(0)
            while curr_time in inames:
                dist_tmp = self.MIN_DIST + np.random.rand() * (
                    self.MAX_DIST - self.MIN_DIST)
                right_dist = np.sqrt(((
                    self.Ts[curr_time:curr_time
                            + int(10 * self.complement_range)]
                    - self.Ts[curr_time]) ** 2).sum(-1))
                next_time = np.where(right_dist > dist_tmp)[0]
                if len(next_time) == 0:
                    curr_time += 1
                    continue
                next_time = next_time[0] + curr_time - 1
                skip0, cmpl0 = self._complement_frames(curr_time)
                skip1, cmpl1 = self._complement_frames(next_time)
                if skip0 or skip1:
                    curr_time += 1
                else:
                    if self.load_neighbourhood:
                        self.files.append(
                            (dirname, curr_time, next_time, cmpl0, cmpl1))
                    else:
                        self.files.append((dirname, curr_time, next_time))
                    curr_time = next_time + 1
        if phase == "train":
            self.files = self.files[::3][:1200]  # reference :929-931

    def _scan_ids(self, dirname):
        import glob
        import os.path as osp
        fnames = glob.glob(
            osp.join(self.root, "sequences", str(dirname),
                     "velodyne", "*.bin"))
        assert fnames, f"no scans under {dirname}"
        return sorted(int(osp.split(f)[-1][:-4]) for f in fnames)
