"""Pair registration as the port's serving and evaluation paths compute it
(frozen copies of gcl_tpu_torch/infer.py's feature extractor, keypoint
draw and pair registration, and of eval_kitti.py's random_sample), over
this package's plain modules."""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .core.kernel_maps import ConvSpec, build_graph
from .data.device_pipeline import voxelize_per_cloud
from .reg.sc2pcr import Matcher, stable_topk_indices


def make_feature_extractor(model: torch.nn.Module,
                           conv_specs: Sequence[ConvSpec], voxel_size: float,
                           nv_cap: int, level_caps: Dict[int, int]):
    """extract(points f32[C, P, 3], pmask bool[C, P]) -> (VoxelizedClouds,
    eval-mode feats f32[C, nv_cap, out_channels])."""
    model.eval()

    @torch.no_grad()
    def extract(points: torch.Tensor, pmask: torch.Tensor):
        vox = voxelize_per_cloud(points, pmask, voxel_size, nv_cap)
        flat = vox.flatten()
        graph = build_graph(flat.coords, flat.mask, conv_specs, level_caps,
                            n_clouds=points.shape[0])
        f = model(graph, flat.feats)
        c, nv = vox.mask.shape
        return vox, f.reshape(c, nv, -1)

    return extract


def random_keypoints(mask: torch.Tensor, n_key: int,
                     generator: torch.Generator) -> torch.Tensor:
    """n_key random valid rows of one cloud (uniform scores from a CPU
    generator, top n_key)."""
    score = torch.rand(mask.shape, generator=generator).to(mask.device)
    score = torch.where(mask, score, -1.0)
    return stable_topk_indices(score, n_key)


def sc2pcr_estimate(matcher: Matcher, xyz: Sequence[torch.Tensor],
                    feats: Sequence[torch.Tensor], mask: Sequence[torch.Tensor],
                    n_key: int, generator: torch.Generator) -> torch.Tensor:
    """The serving pair's transform [4, 4] (cloud 0 -> cloud 1) from each
    cloud's voxel positions, features and mask: n_key keypoints a cloud,
    then SC2-PCR, every random number from ``generator`` in the serving
    path's order."""
    keys = [random_keypoints(mask[c], n_key, generator) for c in (0, 1)]
    x0, x1 = (xyz[c][keys[c]] for c in (0, 1))
    f0, f1 = (feats[c][keys[c]] for c in (0, 1))
    t, _, _, _ = matcher.estimator(x0[None], x1[None], f0[None], f1[None],
                                   generator)
    return t[0]


def random_sample(pcd: np.ndarray, feats: np.ndarray, n: int,
                  rng: np.random.RandomState):
    """Exactly n rows: a permutation's first n, or n drawn with
    replacement from fewer."""
    n1 = pcd.shape[0]
    if n1 == n:
        return pcd, feats
    choice = rng.permutation(n1)[:n] if n1 > n else rng.choice(n1, n)
    return pcd[choice], feats[choice]


def kitti_matcher(settings: dict, n_key: int) -> Matcher:
    """SC2-PCR at a config_json file's settings, ``n_key`` points a side."""
    return Matcher(inlier_threshold=settings["inlier_threshold"],
                   num_node=settings["num_node"],
                   use_mutual=settings["use_mutual"],
                   d_thre=settings["d_thre"],
                   num_iterations=settings["num_iterations"],
                   ratio=settings["ratio"],
                   nms_radius=settings["nms_radius"],
                   max_points=settings["max_points"], k1=settings["k1"],
                   k2=settings["k2"])
