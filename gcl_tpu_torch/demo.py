"""Feature-extraction demo (port of the root demo.py, reference
demo.py:25-49): one cloud -> voxelize -> ResUNetBN2C (eval) -> features
-> exact 1-D t-SNE -> the Spectral colormap -> a coloured .ply.

    python -m gcl_tpu_torch.demo [--input CLOUD] [--weights CKPT]

``--input`` is a .ply or a KITTI .bin; without one a synthetic LiDAR scan
is generated (data/synthetic.py's world, RandomState(0)). ``--weights`` is
a checkpoint of the port or of gcl_tpu (train/checkpoint.py); without one
the model takes seeded random weights (models/weights.py, seed 0). It runs
on the CUDA card; ``--device cpu`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .data.kitti_io import read_velodyne_bin
from .data.synthetic import _make_world, _scan_from_world
from .eval_kitti import device_of
from .models import load_model
from .models.weights import random_state_dict
from .train.checkpoint import load_checkpoint
from .utils.misc import extract_features
from .utils.pointcloud import read_ply_xyz
from .utils.timer import synced_time
from .utils.visualization import get_colored_point_cloud_feature_ply

WEIGHT_SEED = 0


def synthetic_scan() -> np.ndarray:
    """The root demo's scan: a world of extent 40 m seen from 1.5 m up."""
    world = _make_world(np.random.RandomState(0), extent=40.0)
    pose = np.eye(4)
    pose[2, 3] = 1.5
    return _scan_from_world(world, pose, max_range=40.0)


def read_cloud(path: Optional[str]) -> np.ndarray:
    """xyz [N, 3] of a .ply or KITTI .bin, or the synthetic scan."""
    if path and path.endswith(".ply"):
        return read_ply_xyz(path)
    if path and path.endswith(".bin"):
        return read_velodyne_bin(path)
    print("no --input given; generating a synthetic LiDAR scan")
    return synthetic_scan()


def demo_model(name: str, n_out: int, conv1_kernel_size: int,
               weights: Optional[str]) -> torch.nn.Module:
    """The model with the checkpoint's weights, or seeded ones."""
    model = load_model(name)(1, n_out, bn_momentum=0.05,
                             normalize_feature=True,
                             conv1_kernel_size=conv1_kernel_size, D=3)
    if weights and os.path.isfile(weights):
        model.load_state_dict(load_checkpoint(weights)["state_dict"])
        print(f"loaded weights from {weights}")
    else:
        model.load_state_dict(random_state_dict(model, WEIGHT_SEED))
    return model


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--input", default=None, type=str,
                    help=".ply or KITTI .bin cloud")
    ap.add_argument("--output", default="demo_features.ply", type=str)
    ap.add_argument("--weights", default=None, type=str)
    ap.add_argument("--model", default="ResUNetBN2C", type=str)
    ap.add_argument("--model_n_out", default=32, type=int)
    ap.add_argument("--voxel_size", default=0.3, type=float)
    ap.add_argument("--conv1_kernel_size", default=5, type=int)
    ap.add_argument("--device", default="cuda", type=str,
                    help="cuda (needs a card) or cpu")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """Run the demo; returns {output, n_points, n_voxels, extract_ms,
    tsne_ms} (the times synchronized on the card)."""
    args = parse_args(argv)
    dev = device_of(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    xyz = read_cloud(args.input)
    model = demo_model(args.model, args.model_n_out, args.conv1_kernel_size,
                       args.weights)

    t0 = synced_time(dev)
    vis_xyz, feature = extract_features(model, xyz,
                                        voxel_size=args.voxel_size,
                                        device=dev)
    t1 = synced_time(dev)
    print(f"extracted {feature.shape[0]} voxel features "
          f"({feature.shape[1]}-D) from {len(xyz)} points")
    out = get_colored_point_cloud_feature_ply(
        vis_xyz, feature.to(torch.float64), args.output, args.voxel_size)
    t2 = synced_time(dev)
    print(f"wrote t-SNE-colored features to {out}")
    stats = {"output": out, "n_points": len(xyz),
             "n_voxels": int(feature.shape[0]),
             "extract_ms": (t1 - t0) * 1e3, "tsne_ms": (t2 - t1) * 1e3}
    print(f"extract {stats['extract_ms']:.1f} ms, t-SNE and PLY "
          f"{stats['tsne_ms']:.1f} ms on {dev}")
    return stats


if __name__ == "__main__":
    main()
