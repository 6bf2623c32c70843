"""The standalone SC2-PCR KITTI benchmark over precomputed descriptors
(port of scripts/SC2_PCR/test_KITTI.py, reference
scripts/SC2_PCR/test_KITTI.py:18-151): the Matcher on each pair, RR / RE
/ TE (TransformationLoss) and inlier precision / recall / F1
(ClassificationLoss). A config whose "dataset" is 3DMatch or 3DLoMatch
reads the 3DMatch layout (test_3dmatch.py, test_3dlomatch.py).

    python -m gcl_tpu_torch.sc2_pcr.test_kitti --data_root ROOT

reads scripts/SC2_PCR/config_json/config_KITTI.json by default and runs
on the CUDA card; ``--device cpu`` runs on the CPU. SC2-PCR's random node
subsets come from a CPU torch.Generator seeded with ``--seed``;
``--use_icp`` polishes each estimate with 0.10 m point-to-point ICP
(reg/icp.py).
"""
from __future__ import annotations

import argparse
import json
import logging
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..eval_kitti import SC2_CONFIG, device_of
from ..reg.icp import registration_icp
from ..reg.metrics import ClassificationLoss, TransformationLoss
from ..reg.sc2pcr import Matcher
from ..reg.se3 import transform
from ..utils.timer import synced_time
from .dataset import KITTILoader, ThreeDLoader

CONFIG_DIR = os.path.dirname(SC2_CONFIG)
log = logging.getLogger(__name__)


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config_path", type=str, default=SC2_CONFIG)
    ap.add_argument("--data_root", type=str, required=True)
    ap.add_argument("--descriptor", type=str, default="fcgf")
    # the reference's benchmark_utils (scripts/SC2_PCR/benchmark_utils.py:
    # 27-57): set_seed(51) fixed the run's random numbers; icp_refine()
    # optionally polished the estimate with 0.10 m ICP before scoring
    ap.add_argument("--seed", type=int, default=51,
                    help="seed of SC2-PCR's node subsets")
    ap.add_argument("--use_icp", action="store_true",
                    help="refine each estimate with 0.10 m "
                         "point-to-point ICP")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (needs a card) or cpu")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Run the benchmark; returns {"RR" (%), "RE" (deg), "TE" (cm), "F1",
    "ms_per_pair"} (RE and TE over the registered pairs; the time of a
    pair synchronized on the card)."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(message)s",
                        datefmt="%m/%d %H:%M:%S")
    args = parse_args(argv)
    dev = device_of(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(args.config_path) as f:
        cfg = json.load(f)

    if cfg.get("dataset", "KITTI") in ("3DMatch", "3DLoMatch"):
        loader = ThreeDLoader(args.data_root, descriptor=args.descriptor,
                              inlier_threshold=cfg["inlier_threshold"],
                              num_node=cfg["num_node"],
                              downsample=cfg["downsample"])
    else:
        loader = KITTILoader(args.data_root, descriptor=args.descriptor,
                             inlier_threshold=cfg["inlier_threshold"],
                             num_node=cfg["num_node"])
    matcher = Matcher(inlier_threshold=cfg["inlier_threshold"],
                      num_node=cfg["num_node"],
                      use_mutual=cfg["use_mutual"], d_thre=cfg["d_thre"],
                      num_iterations=cfg["num_iterations"],
                      ratio=cfg["ratio"], nms_radius=cfg["nms_radius"],
                      max_points=cfg["max_points"], k1=cfg["k1"],
                      k2=cfg["k2"])
    trans_loss = TransformationLoss(re_thre=cfg["re_thre"],
                                    te_thre=cfg["te_thre"])
    class_loss = ClassificationLoss()
    gen = torch.Generator().manual_seed(args.seed)

    recalls, res, tes, f1s = [], [], [], []
    seconds = 0.0
    for i in range(len(loader)):
        xyz0, xyz1, f0, f1, gt = loader[i]
        t0 = synced_time(dev)
        pred, labels, src_c, tgt_c = matcher.estimator(
            *(torch.from_numpy(np.asarray(a, np.float32)).to(dev)[None]
              for a in (xyz0, xyz1, f0, f1)), gen)
        pred = pred.cpu().numpy()
        if args.use_icp:
            refined = registration_icp(
                src_c[0].cpu().numpy().astype(np.float64),
                tgt_c[0].cpu().numpy().astype(np.float64), 0.10,
                init=pred[0].astype(np.float64))
            pred = refined[None].astype(np.float32)
        seconds += synced_time(dev) - t0
        recall, re, te = trans_loss(pred, gt[None], src_c, tgt_c, labels)
        # gt inlier labels from the GT transform
        warp = transform(src_c, torch.as_tensor(
            np.asarray(gt, np.float32), device=dev)[None])[0]
        gt_labels = (np.linalg.norm((warp - tgt_c[0]).cpu().numpy(), axis=1)
                     < cfg["inlier_threshold"])
        cls = class_loss(labels[0], gt_labels)
        recalls.append(recall)
        if recall > 0:
            res.append(re)
            tes.append(te)
        f1s.append(cls["f1"])
        if i % 10 == 0:
            log.info(f"{i}/{len(loader)} RR={np.mean(recalls):.2f} "
                     f"RE={np.mean(res) if res else 0:.3f} "
                     f"TE={np.mean(tes) if tes else 0:.3f} "
                     f"F1={np.mean(f1s):.3f}")
    stats = {"RR": float(np.mean(recalls)),
             "RE": float(np.mean(res)) if res else 0.0,
             "TE": float(np.mean(tes)) if tes else 0.0,
             "F1": float(np.mean(f1s)),
             "ms_per_pair": seconds * 1e3 / max(len(loader), 1)}
    log.info(f"FINAL RR={stats['RR']:.2f} RE={stats['RE']:.3f}deg "
             f"TE={stats['TE']:.3f}cm F1={stats['F1']:.3f} "
             f"({stats['ms_per_pair']:.1f} ms a pair on {dev})")
    return stats


if __name__ == "__main__":
    main()
