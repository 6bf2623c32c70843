"""The KITTI / LoKITTI / nuScenes benchmark runner (port of
scripts/test_kitti.py): a run directory's config.json and best
checkpoint, features of each test pair's two clouds (each extracted
alone), 5000 points of each drawn with np.random.RandomState(0), then
feature-NN RANSAC (``--use_RANSAC true``, FCGF's evaluation) or SC2-PCR at
scripts/SC2_PCR/config_json/config_KITTI.json's settings, and RR at RTE <
``--rte_thresh`` m and RRE < ``--rre_thresh`` deg, with the mean RTE and
RRE of the pairs under each threshold.

    python -m gcl_tpu_torch.eval_kitti --save_dir RUN --kitti_root ROOT

runs on the CUDA card; ``--device cpu`` runs on the CPU. The checkpoint
may be the port's or one that gcl_tpu wrote (train.checkpoint).
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from .config import default_config
from .core.kernel_maps import default_level_caps
from .data.loader import make_data_loader
from .infer import make_feature_extractor
from .models import load_model
from .reg.matching import find_nn
from .reg.ransac import ransac_pose
from .reg.sc2pcr import Matcher
from .train.checkpoint import load_checkpoint
from .utils.spans import span
from .utils.timer import AverageMeter, Timer

N_POINTS = 5000
SC2_CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts", "SC2_PCR", "config_json",
    "config_KITTI.json")


def random_sample(pcd, feats, n, rng):
    """Exactly n rows: a permutation's first n, or n drawn with
    replacement from fewer; inside the span ``match/sample``."""
    with span("match/sample"):
        n1 = pcd.shape[0]
        if n1 == n:
            return pcd, feats
        if n1 > n:
            choice = rng.permutation(n1)[:n]
        else:
            choice = rng.choice(n1, n)
        return pcd[choice], feats[choice]


def device_of(name: str) -> torch.device:
    """The device the run asked for: 'cuda' needs a card (no fallback)."""
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: torch.cuda.is_available() is "
                           "False (pass --device cpu to run on the CPU)")
    return torch.device(name)


def load_extractor(config, dev: torch.device):
    """The run's model with its best checkpoint's weights, as an eval-mode
    feature extractor (levels and caps as scripts/test_kitti.py sets
    them)."""
    model_cls = load_model(config.model)
    model = model_cls(1, config.model_n_out, bn_momentum=config.bn_momentum,
                      conv1_kernel_size=config.conv1_kernel_size,
                      normalize_feature=config.normalize_feature, D=3)
    state = load_checkpoint(config.save_dir + "/best_val_checkpoint.pth")
    model.load_state_dict(state["state_dict"])
    specs = model_cls.conv_specs(config.conv1_kernel_size)
    strides = sorted({s for sp in specs
                      for s in (sp.in_stride, sp.out_stride)})
    caps = default_level_caps(config.voxel_capacity, strides,
                              config.level_cap_shrink)
    return make_feature_extractor(model.to(dev), specs, config.voxel_size,
                                  config.voxel_capacity, caps)


def main(config, device: str = "cuda",
         max_pairs: Optional[int] = None) -> Dict[str, object]:
    """Evaluate the run in ``config.save_dir`` on ``config.test_phase``.

    The registration's random numbers (RANSAC's minimal samples, SC2-PCR's
    node subsets) come from a CPU torch.Generator seeded with 0.
    ``max_pairs`` stops after that many pairs. Returns {"rr" (%), "rte"
    (m), "rre" (deg)} and, under "transforms", each pair's estimate.
    """
    dev = device_of(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {dev}; tf32: "
          f"matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    test_loader = make_data_loader(config, config.test_phase, 1,
                                   num_threads=config.test_num_thread,
                                   shuffle=False)
    extract = load_extractor(config, dev)
    use_sc2pcr = not config.use_RANSAC
    matcher = Matcher(
        inlier_threshold=config.inlier_threshold, num_node=config.num_node,
        use_mutual=config.use_mutual, d_thre=config.d_thre,
        num_iterations=config.num_iterations, ratio=config.ratio,
        nms_radius=config.nms_radius, max_points=config.max_points,
        k1=config.k1, k2=config.k2) if use_sc2pcr else None
    gen = torch.Generator().manual_seed(0)

    success_meter, rte_meter, rre_meter = (AverageMeter(), AverageMeter(),
                                           AverageMeter())
    data_timer, feat_timer, reg_timer = Timer(), Timer(), Timer()
    rte_thresh, rre_thresh = config.rte_thresh, config.rre_thresh
    print(f"rre thresh: {rre_thresh}; rte_thresh: {rte_thresh}")

    rng = np.random.RandomState(0)
    n_total = len(test_loader)
    transforms = []
    t_start = time.perf_counter()
    data_timer.tic()
    for i, batch in enumerate(test_loader):
        if max_pairs is not None and i >= max_pairs:
            break
        t_gth = np.asarray(batch["trans"][0])
        data_timer.toc()

        feat_timer.tic()
        sides = []
        for c in (0, 1):
            vox, f = extract(
                torch.from_numpy(batch[f"points{c}"]).to(dev),
                torch.from_numpy(batch[f"pmask{c}"]).to(dev))
            m = vox.mask[0]
            sides.append((vox.xyz[0][m].cpu().numpy(),
                          f[0][m].float().cpu().numpy()))
        feat_timer.toc()

        (xyz0s, f0s), (xyz1s, f1s) = (random_sample(x, f, N_POINTS, rng)
                                      for x, f in sides)
        x0, x1, f0, f1 = (torch.from_numpy(a).to(dev)
                          for a in (xyz0s, xyz1s, f0s, f1s))

        reg_timer.tic()
        if not use_sc2pcr:
            nn, _ = find_nn(f0, f1, chunk=config.knn_chunk)
            t_est, _, _ = ransac_pose(
                x0, x1[nn], config.voxel_size * 1.0, generator=gen,
                num_hypotheses=config.ransac_hypotheses, sample_size=4,
                edge_length_ratio=0.9)
        else:
            t_est = matcher.estimator(x0[None], x1[None], f0[None], f1[None],
                                      gen)[0][0]
        t_est = t_est.cpu().numpy()  # waits for the device
        reg_timer.toc()
        transforms.append(t_est)

        rte = np.linalg.norm(t_est[:3, 3] - t_gth[:3, 3])
        tm = t_est[:3, :3].T @ t_gth[:3, :3]
        rre = np.arccos(np.clip((np.trace(tm) - 1) / 2, -1, 1))
        if rte < rte_thresh:
            rte_meter.update(rte)
        if not np.isnan(rre) and rre < np.pi / 180 * rre_thresh:
            rre_meter.update(rre * 180 / np.pi)
        if (rte < rte_thresh and not np.isnan(rre)
                and rre < np.pi / 180 * rre_thresh):
            success_meter.update(1)
        else:
            success_meter.update(0)
            logging.info(f"Failed with RTE: {rte}, RRE: {rre * 180 / np.pi}")
        if i % 10 == 0:
            logging.info(
                f"{i} / {n_total}: Data time: {data_timer.avg}, "
                f"Feat time: {feat_timer.avg}, Reg time: {reg_timer.avg}, "
                f"RTE: {rte_meter.avg}, RRE: {rre_meter.avg}, Success: "
                f"{success_meter.sum} / {success_meter.count} "
                f"({success_meter.avg * 100} %)")
        data_timer.tic()

    wall = time.perf_counter() - t_start
    n_pairs = success_meter.count
    out = {"rr": success_meter.avg * 100, "rte": rte_meter.avg,
           "rre": rre_meter.avg}
    print(f"RTE: {rte_meter.avg}, var: {rte_meter.var}, RRE: "
          f"{rre_meter.avg}, var: {rre_meter.var}, Success: "
          f"{success_meter.sum} / {n_pairs} ({success_meter.avg * 100} %)")
    print(json.dumps({**out, "pairs": n_pairs, "device": str(dev),
                      "data_s": data_timer.avg, "feat_s": feat_timer.avg,
                      "reg_s": reg_timer.avg,
                      "pairs_per_s": n_pairs / wall if wall > 0 else None}))
    return {**out, "transforms": transforms}


def str2bool(v):
    return v.lower() in ("true", "1")


def parse_config(argv=None):
    """scripts/test_kitti.py's flags, plus --device, onto the run's
    config.json: (config, device)."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--save_dir", default=None, type=str)
    parser.add_argument("--test_phase", default="test", type=str)
    parser.add_argument("--LoKITTI", default=False, type=str2bool)
    parser.add_argument("--LoNUSCENES", default=False, type=str2bool)
    parser.add_argument("--test_num_thread", default=5, type=int)
    parser.add_argument("--pair_min_dist", default=None, type=int)
    parser.add_argument("--pair_max_dist", default=None, type=int)
    parser.add_argument("--downsample_single", default=1.0, type=float)
    parser.add_argument("--kitti_root", type=str, default="/data/kitti/")
    parser.add_argument("--use_RANSAC", type=str2bool, default=True)
    parser.add_argument("--ransac_hypotheses", type=int, default=131072)
    parser.add_argument("--rre_thresh", default=5.0, type=float)
    parser.add_argument("--rte_thresh", default=2.0, type=float)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    config = default_config()
    with open(args.save_dir + "/config.json") as f:
        config.update(json.load(f))
    config.save_dir = args.save_dir
    config.test_phase = args.test_phase
    config.kitti_root = args.kitti_root
    config.test_num_thread = args.test_num_thread
    config.LoKITTI = args.LoKITTI
    config.LoNUSCENES = args.LoNUSCENES
    config.phase = "test"
    config.use_RANSAC = args.use_RANSAC
    config.ransac_hypotheses = args.ransac_hypotheses
    if args.LoNUSCENES:
        config.dataset = "PairComplementNuscenesDataset"
        config.use_old_pose = True
    if args.LoKITTI:
        config.dataset = "PairComplementKittiDataset"
    if not config.use_RANSAC:
        with open(SC2_CONFIG) as f:
            config.update(json.load(f))
    if args.pair_min_dist is not None and args.pair_max_dist is not None:
        config.pair_min_dist = args.pair_min_dist
        config.pair_max_dist = args.pair_max_dist
    config.downsample_single = args.downsample_single
    config.rte_thresh = args.rte_thresh
    config.rre_thresh = args.rre_thresh
    return config, args.device


if __name__ == "__main__":
    logging.basicConfig(format="%(asctime)s %(message)s",
                        datefmt="%m/%d %H:%M:%S", level=logging.INFO,
                        handlers=[logging.StreamHandler(sys.stdout)])
    main(*parse_config())
