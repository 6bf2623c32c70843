"""Host point-cloud utilities (a copy of gcl_tpu/utils/pointcloud.py)
without Open3D: PLY IO, matching helpers, overlap ratio, random SE(3).
"""
from __future__ import annotations

import numpy as np

from ..reg.icp import voxel_downsample


def read_ply_xyz(path: str) -> np.ndarray:
    """Minimal PLY reader (ascii or binary_little_endian) returning Nx3
    float positions — replaces o3d.io.read_point_cloud for the demo."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l for l in header if l.startswith("format")).split()[1]
        n = int(next(l for l in header
                     if l.startswith("element vertex")).split()[-1])
        props = [l.split() for l in header if l.startswith("property")
                 and not l.startswith("property list")]
        dtypes = {"float": "f4", "float32": "f4", "double": "f8",
                  "uchar": "u1", "uint8": "u1", "int": "i4",
                  "int32": "i4", "ushort": "u2", "short": "i2"}
        names = [p[2] for p in props]
        np_dtype = np.dtype([(p[2], dtypes[p[1]]) for p in props])
        if fmt == "ascii":
            data = np.loadtxt(f, dtype=np_dtype, max_rows=n)
        elif fmt == "binary_little_endian":
            data = np.frombuffer(f.read(n * np_dtype.itemsize),
                                 dtype=np_dtype, count=n)
        else:
            raise ValueError(f"unsupported ply format {fmt}")
        return np.stack([data["x"], data["y"], data["z"]],
                        axis=1).astype(np.float32)


def write_ply_xyz(path: str, xyz: np.ndarray, colors=None):
    n = len(xyz)
    with open(path, "wb") as f:
        hdr = ["ply", "format binary_little_endian 1.0",
               f"element vertex {n}",
               "property float x", "property float y", "property float z"]
        if colors is not None:
            hdr += ["property uchar red", "property uchar green",
                    "property uchar blue"]
        hdr.append("end_header")
        f.write(("\n".join(hdr) + "\n").encode("ascii"))
        if colors is None:
            f.write(xyz.astype("<f4").tobytes())
        else:
            dt = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                           ("r", "u1"), ("g", "u1"), ("b", "u1")])
            rec = np.zeros(n, dt)
            rec["x"], rec["y"], rec["z"] = xyz.T.astype(np.float32)
            c = np.clip(colors * 255, 0, 255).astype(np.uint8)
            rec["r"], rec["g"], rec["b"] = c.T
            f.write(rec.tobytes())


def get_matching_indices(source_xyz, target_xyz, trans, search_voxel_size,
                         K=None):
    """All (i, j) with |T(source_i) - target_j| <= r, K-capped — host
    oracle of the device path (reference util/pointcloud.py:53-66)."""
    from scipy.spatial import cKDTree

    src = source_xyz @ trans[:3, :3].T + trans[:3, 3]
    tree = cKDTree(target_xyz)
    out = []
    hits = tree.query_ball_point(src, search_voxel_size)
    for i, idx in enumerate(hits):
        if K is not None:
            d = np.linalg.norm(target_xyz[idx] - src[i], axis=1)
            idx = [idx[j] for j in np.argsort(d)[:K]]
        for j in idx:
            out.append((i, j))
    return out


def compute_overlap_ratio(xyz0, xyz1, trans, voxel_size):
    """(reference util/pointcloud.py:42-50)."""
    p0 = voxel_downsample(xyz0, voxel_size)
    p1 = voxel_downsample(xyz1, voxel_size)
    m01 = get_matching_indices(p0, p1, trans, voxel_size, 1)
    m10 = get_matching_indices(p1, p0, np.linalg.inv(trans), voxel_size, 1)
    return max(len(m01) / len(p0), len(m10) / len(p1))


def sample_random_trans(pcd, randg=None, rotation_range=360):
    from ..data.transforms import sample_random_trans as _s

    if randg is None:
        randg = np.random.RandomState()
    return _s(pcd, randg, rotation_range)
