"""Standalone SC2-PCR benchmark loaders over precomputed descriptors (a
copy of scripts/SC2_PCR/dataset.py, reference scripts/SC2_PCR/dataset.py:
8-240): 3DMatch / 3DLoMatch keypoint + descriptor npz files and KITTI test
pairs with FCGF / FPFH features.
"""
from __future__ import annotations

import glob
import os
from typing import List

import numpy as np


class ThreeDLoader:
    """3DMatch test scenes with precomputed descriptors.

    Expects <root>/<scene>/{cloud_bin_i.ply keypoints+descriptors as npz:
    <desc_root>/<scene>/cloud_bin_i.<desc>.npz with 'xyz' and 'feature'}.
    """

    def __init__(self, root, descriptor="fcgf", inlier_threshold=0.10,
                 num_node=5000, use_mutual=True, downsample=0.03,
                 augment_axis=0, augment_rotation=1.0,
                 augment_translation=0.01, select_scene=None):
        self.root = root
        self.descriptor = descriptor
        self.inlier_threshold = inlier_threshold
        self.num_node = num_node
        self.use_mutual = use_mutual
        self.scenes = select_scene or sorted(
            os.listdir(os.path.join(root, "fragments")))
        self.files: List = []
        for scene in self.scenes:
            gt_path = os.path.join(root, "gt_result", scene + "-evaluation")
            for pair_file in sorted(glob.glob(
                    os.path.join(gt_path, "*.npz"))):
                self.files.append((scene, pair_file))

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx):
        scene, pair_file = self.files[idx]
        data = np.load(pair_file)
        return (data["xyz0"], data["xyz1"], data["feat0"], data["feat1"],
                data["gt_trans"])


class KITTILoader:
    """KITTI test pairs with precomputed descriptors (reference
    dataset.py:193-240): npz files with keypoints+features per pair."""

    def __init__(self, root, descriptor="fcgf", inlier_threshold=0.60,
                 num_node=5000, use_mutual=True, augment_axis=0,
                 augment_rotation=1.0, augment_translation=0.01):
        self.root = root
        self.descriptor = descriptor
        assert descriptor in ("fcgf", "fpfh")
        self.inlier_threshold = inlier_threshold
        self.num_node = num_node
        self.use_mutual = use_mutual
        self.files = sorted(glob.glob(
            os.path.join(root, descriptor + "_test", "*.npz")))

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx):
        data = np.load(self.files[idx])
        keys = set(data.keys())
        if {"xyz0", "xyz1"} <= keys:
            return (data["xyz0"], data["xyz1"], data["features0"]
                    if "features0" in keys else data["feat0"],
                    data["features1"] if "features1" in keys
                    else data["feat1"], data["gt_trans"])
        raise KeyError(f"unrecognized npz layout: {sorted(keys)}")
