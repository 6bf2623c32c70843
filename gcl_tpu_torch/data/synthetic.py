"""Synthetic data (numpy only): LiDAR scans, the input of the serving
benchmark, and a miniature KITTI-layout dataset.

``synth_lidar`` is a verbatim copy of the one in the repository's
``bench.py``; the rest is a copy of gcl_tpu/data/synthetic.py: a tiny
world of random structure (ground plane + boxes) and a vehicle driving
through it, written as real `sequences/%02d/velodyne/%06d.bin` scans,
`calib.txt`, `poses.txt` (SLAM layout) and `poses/%02d.txt` (odometry
layout), or as a nuScenes-as-KITTI export
(`sequences/<log>/velodyne/%06d.bin` and `poses.npy`), so the datasets
and the entry points run unmodified on it.
"""
import os
import pathlib

import numpy as np

from .kitti_io import velo2cam_T


def synth_lidar(rng, n_points):
    """LiDAR-like scan: ground disc + vertical structures, ~120 m spread."""
    n_ground = int(n_points * 0.6)
    r = np.sqrt(rng.rand(n_ground)) * 55.0
    th = rng.rand(n_ground) * 2 * np.pi
    ground = np.stack([r * np.cos(th), r * np.sin(th),
                       rng.randn(n_ground) * 0.05], 1)
    n_obj = n_points - n_ground
    centers = rng.randn(64, 3) * [18, 18, 0]
    pick = rng.randint(0, 64, n_obj)
    obj = centers[pick] + rng.randn(n_obj, 3) * [0.6, 0.6, 1.2] \
        + [0, 0, 1.5]
    return np.concatenate([ground, obj]).astype(np.float32)


def _make_world(rng, extent=120.0, n_boxes=60, pts_per_box=150,
                ground_pts=4000):
    pts = []
    g = rng.uniform(-extent, extent, size=(ground_pts, 2))
    pts.append(np.concatenate([g, rng.normal(0, 0.02, (ground_pts, 1))], 1))
    for _ in range(n_boxes):
        c = rng.uniform(-extent, extent, size=2)
        w, d, h = rng.uniform(0.5, 4.0, size=3)
        face = rng.randint(0, 3)
        p = rng.uniform(-0.5, 0.5, size=(pts_per_box, 3)) * [w, d, h]
        p[:, face] = 0.5 * [w, d, h][face] * rng.choice([-1, 1])
        p[:, :2] += c
        p[:, 2] += h / 2
        pts.append(p)
    return np.concatenate(pts).astype(np.float32)


def _scan_from_world(world, pose, max_range=45.0, keep=0.9, rng=None):
    """Points visible from `pose` (translation + rotation), in the sensor
    frame, range-limited like a LiDAR."""
    r = pose[:3, :3]
    t = pose[:3, 3]
    local = (world - t) @ r  # world -> sensor frame (R^T (x - t))
    d = np.linalg.norm(local, axis=1)
    m = (d < max_range) & (d > 1.0)
    if rng is not None and keep < 1.0:
        m &= rng.rand(len(world)) < keep
    return local[m].astype(np.float32)


def _gen_drive(rng, n_frames, step, max_range):
    """Yield (pose [4,4], xyzr [N,4]) along a random smooth trajectory
    through a synthetic world sized to cover it."""
    # world extent must cover the whole trajectory (n_frames * step),
    # or late frames scan empty space and yield near-empty clouds
    extent = max(120.0, n_frames * step + 60.0)
    density = (extent / 120.0) ** 2
    world = _make_world(rng, extent=extent, n_boxes=int(60 * density),
                        ground_pts=int(4000 * density))
    heading = rng.rand() * 2 * np.pi
    pos = np.array([0.0, 0.0, 1.5])
    for _ in range(n_frames):
        heading += rng.normal(0, 0.05)
        pos = pos + step * np.array(
            [np.cos(heading), np.sin(heading), 0.0])
        c, s = np.cos(heading), np.sin(heading)
        T = np.eye(4)
        T[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        T[:3, 3] = pos
        scan = _scan_from_world(world, T, max_range, 0.95, rng)
        xyzr = np.concatenate(
            [scan, np.zeros((len(scan), 1), np.float32)], 1)
        yield T, xyzr


def generate_synthetic_kitti(root: str, n_drives=1, n_frames=60,
                             step=2.0, seed=0, max_range=45.0):
    """Write a synthetic dataset under `root` (the kitti_root). Layout:
    root/dataset/sequences/%02d/{velodyne/*.bin, calib.txt, poses.txt}
    and root/dataset/poses/%02d.txt.
    """
    rng = np.random.RandomState(seed)
    base = pathlib.Path(root) / "dataset"
    (base / "poses").mkdir(parents=True, exist_ok=True)
    v2c = velo2cam_T().T  # column-vector velo->cam

    for drive in range(n_drives):
        seq = base / ("sequences/%02d" % drive)
        (seq / "velodyne").mkdir(parents=True, exist_ok=True)

        poses = []
        for i, (T, xyzr) in enumerate(
                _gen_drive(rng, n_frames, step, max_range)):
            poses.append(T)
            xyzr.tofile(seq / "velodyne" / ("%06d.bin" % i))

        # SLAM-layout poses: poses.txt holds Tr @ T_velo @ Tr^-1 so that
        # slam_poses() (Tr^-1 P Tr) returns the velodyne pose
        tr = np.eye(4)
        tr[:3, 3] = [0.1, -0.05, 0.2]  # nontrivial calib
        with open(seq / "calib.txt", "w") as f:
            for key in ("P0", "P1", "P2", "P3"):
                f.write(key + ": " + " ".join(
                    "%.6e" % v for v in np.eye(3, 4).reshape(-1)) + "\n")
            f.write("Tr: " + " ".join(
                "%.6e" % v for v in tr[:3].reshape(-1)) + "\n")
        with open(seq / "poses.txt", "w") as f:
            for T in poses:
                p = tr @ T @ np.linalg.inv(tr)
                f.write(" ".join("%.9e" % v for v in p[:3].reshape(-1))
                        + "\n")
        # odometry-layout poses (camera frame): P_cam = v2c T_velo v2c^-1
        with open(base / "poses" / ("%02d.txt" % drive), "w") as f:
            for T in poses:
                p = v2c @ T @ np.linalg.inv(v2c)
                f.write(" ".join("%.9e" % v for v in p[:3].reshape(-1))
                        + "\n")
    return str(root)


def generate_synthetic_nuscenes(root: str, n_logs=1, n_frames=60,
                                step=2.0, seed=0, max_range=45.0):
    """Write a synthetic nuScenes-as-KITTI export under `root`: the
    layout assets/export_kitti_minimal.py produces and the nuScenes
    datasets consume -- root/dataset/sequences/<log>/velodyne/%06d.bin
    plus poses.npy ([N, 4, 4] velodyne world poses, used directly as GT;
    reference lib/complement_data_loader.py:1035)."""
    rng = np.random.RandomState(seed)
    base = pathlib.Path(root) / "dataset"
    for li in range(n_logs):
        log = f"n000-synthetic-log-{li:02d}"
        seq = base / "sequences" / log
        (seq / "velodyne").mkdir(parents=True, exist_ok=True)
        poses = []
        for i, (T, xyzr) in enumerate(
                _gen_drive(rng, n_frames, step, max_range)):
            poses.append(T)
            xyzr.tofile(seq / "velodyne" / ("%06d.bin" % i))
        np.save(seq / "poses.npy", np.stack(poses))
    return str(root)


def write_split_files(config_dir: str, n_drives=1):
    """Write train/val/test split files listing all synthetic drives."""
    pathlib.Path(config_dir).mkdir(parents=True, exist_ok=True)
    names = "\n".join("%02d" % d for d in range(n_drives)) + "\n"
    for phase in ("train", "val", "test"):
        with open(os.path.join(config_dir, f"{phase}_kitti.txt"), "w") as f:
            f.write(names)
    return config_dir
