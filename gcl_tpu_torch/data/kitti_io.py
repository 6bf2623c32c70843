"""KITTI odometry host-side IO: velodyne scans, calib, poses (port of
gcl_tpu/data/kitti_io.py). Datasets hint each sample's scans to the
native async reader (native.ScanPrefetcher, a C++ thread pool of
``GCL_IO_THREADS`` threads, 4 by default), and ``read_velodyne_bin``
serves hinted payloads from it; without the native library every scan
is read with numpy when asked for.

Covers both pose sources the reference uses:
  * GT odometry poses `<root>/dataset/poses/%02d.txt` (camera frame,
    converted with the hard-coded velo2cam extrinsic) — "old pose" path
    (lib/complement_data_loader.py:216-218,343-355)
  * SemanticKITTI SLAM poses `<root>/dataset/sequences/%02d/poses.txt`
    with per-sequence calib Tr (lib/colocation_data_loader.py:207-252)
nuScenes-as-KITTI uses `sequences/<log>/poses.npy` directly
(lib/colocation_data_loader.py:101-117).
"""
from __future__ import annotations

import glob
import os
from functools import lru_cache

import numpy as np

# KITTI velodyne->camera extrinsic (reference
# lib/complement_data_loader.py:343-355; note the stored matrix is
# transposed there and used as row-vector transform).
_VELO2CAM_R = np.array([
    7.533745e-03, -9.999714e-01, -6.166020e-04, 1.480249e-02, 7.280733e-04,
    -9.998902e-01, 9.998621e-01, 7.523790e-03, 1.480755e-02
]).reshape(3, 3)
_VELO2CAM_T = np.array([-4.069766e-03, -7.631618e-02, -2.717806e-01])


def velo2cam_T() -> np.ndarray:
    """The transposed homogeneous velo->cam matrix, exactly as the
    reference's `velo2cam` property (a 4x4 acting on row vectors)."""
    m = np.hstack([_VELO2CAM_R, _VELO2CAM_T.reshape(3, 1)])
    return np.vstack((m, [0, 0, 0, 1])).T


_prefetcher = None


def _get_prefetcher():
    global _prefetcher
    if _prefetcher is None:
        from ..native import ScanPrefetcher

        _prefetcher = ScanPrefetcher(
            n_threads=int(os.environ.get("GCL_IO_THREADS", "4")))
    return _prefetcher


def prefetch_scans(paths) -> None:
    """Hint upcoming scan files to the native async reader
    (native/scan_reader.cpp). Datasets call this with all of a sample's
    scans before reading them, so that the thread pool reads them while
    the host assembles the sample; a no-op without the native library."""
    p = _get_prefetcher()
    for path in paths:
        p.submit(path)


def read_velodyne_bin(path: str) -> np.ndarray:
    """Load an Nx3 float32 point cloud from a KITTI .bin (xyzr);
    serves prefetched payloads from the native reader when hinted."""
    if _prefetcher is not None:
        xyzr = _prefetcher.fetch(path).reshape(-1, 4)
    else:
        xyzr = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    return xyzr[:, :3]


def scan_path(root: str, drive: int, t: int) -> str:
    return root + "/sequences/%02d/velodyne/%06d.bin" % (drive, t)


def scan_ids(root: str, drive: int):
    fnames = glob.glob(root + "/sequences/%02d/velodyne/*.bin" % drive)
    assert len(fnames) > 0, \
        f"Make sure that the path {root} has drive id: {drive}"
    return sorted(int(os.path.split(f)[-1][:-4]) for f in fnames)


def parse_calibration(filename: str):
    calib = {}
    with open(filename) as f:
        for line in f:
            key, content = line.strip().split(":")
            values = [float(v) for v in content.strip().split()]
            pose = np.zeros((4, 4))
            pose[0, :4] = values[0:4]
            pose[1, :4] = values[4:8]
            pose[2, :4] = values[8:12]
            pose[3, 3] = 1.0
            calib[key] = pose
    return calib


@lru_cache(maxsize=64)
def slam_poses(root: str, drive: int) -> np.ndarray:
    """SemanticKITTI SLAM poses mapped into the velodyne frame:
    Tr^-1 @ pose @ Tr (reference lib/colocation_data_loader.py:225-252)."""
    data_path = root + "/sequences/%02d" % drive
    calib = parse_calibration(data_path + "/calib.txt")
    tr = calib["Tr"]
    tr_inv = np.linalg.inv(tr)
    poses = []
    with open(data_path + "/poses.txt") as f:
        for line in f:
            values = [float(v) for v in line.strip().split()]
            pose = np.zeros((4, 4))
            pose[0, :4] = values[0:4]
            pose[1, :4] = values[4:8]
            pose[2, :4] = values[8:12]
            pose[3, 3] = 1.0
            poses.append(tr_inv @ pose @ tr)
    return np.asarray(poses)


@lru_cache(maxsize=64)
def odometry_poses(root: str, drive: int) -> np.ndarray:
    """GT odometry poses (camera frame, one 3x4 row-major per line)."""
    data = np.genfromtxt(root + "/poses/%02d.txt" % drive)
    out = np.zeros((len(data), 4, 4))
    out[:, :3, :4] = data.reshape(-1, 3, 4)
    out[:, 3, 3] = 1.0
    return out


@lru_cache(maxsize=256)
def nuscenes_poses(root: str, dirname: str) -> np.ndarray:
    return np.load(os.path.join(root, "sequences", dirname, "poses.npy"))


def odometry_pair_transform(pos_0: np.ndarray, pos_1: np.ndarray
                            ) -> np.ndarray:
    """Velodyne-frame relative transform from two camera-frame odometry
    poses: M maps cloud 1 into cloud 0's frame (reference
    lib/complement_data_loader.py:379-380 before ICP refinement)."""
    v2c = velo2cam_T()
    return (v2c @ pos_1.T @ np.linalg.inv(pos_0.T) @ np.linalg.inv(v2c)).T
