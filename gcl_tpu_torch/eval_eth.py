"""The ETH indoor -> outdoor generalization evaluation (port of
generalization_ETH/evaluate.py, reference generalization_ETH/evaluate.py:
60-289).

Per scene, for every fragment pair with a gt.log entry: voxel features of
both fragments with a trained model, the feature of each ETH keypoint (an
index into its fragment) taken from its nearest voxel (find_nn on
coordinates), mutual-NN correspondences in feature space, their inlier
ratio under the ground truth, and a pose from RANSAC over them (16,384
hypotheses, in gt's direction: fragment id2 into id1's frame). It reports
the feature-match recall (pairs with inlier ratio > 0.05), the mean
inlier ratio of those pairs and the registration recall (RTE < --rr_te m,
RRE < --rr_re deg), per scene and over all scenes.

    python -m gcl_tpu_torch.eval_eth --eth_root ROOT --checkpoint CKPT

runs on the CUDA card; ``--device cpu`` runs on the CPU. RANSAC's minimal
samples come from one CPU torch.Generator seeded with 0.
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .eval_kitti import device_of
from .models import load_model
from .reg.matching import find_nn
from .reg.ransac import ransac_pose
from .train.checkpoint import load_checkpoint
from .utils.misc import extract_features
from .utils.pointcloud import read_ply_xyz
from .utils.timer import synced_time

SCENE_LIST = (
    "gazebo_summer",
    "gazebo_winter",
    "wood_autmn",
    "wood_summer",
)
STAGES = ("extract", "find_nn", "mutual_nn", "ransac")


def get_pcd_xyz(pcdpath: str, filename: str) -> np.ndarray:
    return read_ply_xyz(os.path.join(pcdpath, filename + ".ply"))


def get_eth_keypts(pcd_xyz: np.ndarray, keyptspath: str,
                   filename: str) -> np.ndarray:
    """ETH keypoints are stored as indices into the fragment cloud."""
    key_ind = np.loadtxt(
        os.path.join(keyptspath, filename + "_Keypoints.txt"),
        dtype=np.int64)
    return pcd_xyz[key_ind]


def read_gt_log(path: str) -> Dict[str, np.ndarray]:
    """{'{i}_{j}': 4x4} from an ETH gt.log."""
    out = {}
    with open(path) as f:
        lines = f.readlines()
    for i in range(0, len(lines), 5):
        meta = lines[i].split()
        mat = np.array([[float(v) for v in lines[i + 1 + r].split()]
                        for r in range(4)])
        out[f"{int(meta[0])}_{int(meta[1])}"] = mat
    return out


def mutual_nn(source_desc: torch.Tensor,
              target_desc: torch.Tensor) -> torch.Tensor:
    """Mutually-closest pairs in feature space (reference :62-77), int64
    [M, 2] (source row, target row) in source order."""
    s2t, _ = find_nn(source_desc, target_desc)
    t2s, _ = find_nn(target_desc, source_desc)
    i = torch.arange(len(s2t), device=s2t.device)
    mutual = t2s[s2t] == i
    return torch.stack([i[mutual], s2t[mutual]], 1)


def load_eth_model(args, dev: torch.device) -> torch.nn.Module:
    model = load_model(args.model)(1, args.model_n_out, bn_momentum=0.05,
                                   normalize_feature=True,
                                   conv1_kernel_size=args.conv1_kernel_size,
                                   D=3)
    model.load_state_dict(load_checkpoint(args.checkpoint)["state_dict"])
    return model.to(dev)


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--eth_root", required=True,
                    help="dir with <scene>/{*.ply, Keypoints, gt.log}")
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--model", default="ResUNetFatBN")
    ap.add_argument("--model_n_out", default=32, type=int)
    ap.add_argument("--conv1_kernel_size", default=5, type=int)
    ap.add_argument("--voxel_size", default=0.05, type=float)
    ap.add_argument("--inlier_dist", default=0.1, type=float)
    ap.add_argument("--ransac_dist", default=0.05, type=float)
    ap.add_argument("--rr_te", default=0.3, type=float,
                    help="registration-recall translation threshold (m)")
    ap.add_argument("--rr_re", default=15.0, type=float,
                    help="registration-recall rotation threshold (deg)")
    ap.add_argument("--log_dir", default="",
                    help="write per-scene est .log files here (the "
                         "reference writes them for offline RR "
                         "evaluation, :189-200)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (needs a card) or cpu")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None,
         scenes: Sequence[str] = SCENE_LIST) -> Dict[str, object]:
    """Evaluate ``scenes`` of --eth_root. Returns {"scenes": {scene:
    {"recall" (%), "avg_inlier", "rr" (%), "pairs": [{"pair", "inlier_ratio",
    "rte", "rre", "registered", "transform", "n_mutual", "stage_ms"}]}},
    "recall", "inlier", "rr"} (the all-scene means); stage_ms holds each
    pair's extract, find_nn, mutual_nn and ransac time, synchronized on
    the card."""
    args = parse_args(argv)
    dev = device_of(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = load_eth_model(args, dev)
    gen = torch.Generator().manual_seed(0)

    results: Dict[str, Dict] = {}
    for scene in scenes:
        pcdpath = os.path.join(args.eth_root, scene)
        keyptspath = os.path.join(pcdpath, "Keypoints")
        gt_log = read_gt_log(os.path.join(pcdpath, "gt.log"))
        num_frag = len([f for f in os.listdir(pcdpath)
                        if f.endswith(".ply")])
        est_log = (os.path.join(args.log_dir, f"est_{scene}.log")
                   if args.log_dir else None)
        if est_log:
            os.makedirs(args.log_dir, exist_ok=True)
            open(est_log, "w").close()

        pairs = []
        for id1 in range(num_frag):
            for id2 in range(id1 + 1, num_frag):
                k = f"{id1}_{id2}"
                if k not in gt_log:
                    continue
                x0 = get_pcd_xyz(pcdpath, f"Hokuyo_{id1}")
                x1 = get_pcd_xyz(pcdpath, f"Hokuyo_{id2}")
                kp0 = get_eth_keypts(x0, keyptspath, f"Hokuyo_{id1}")
                kp1 = get_eth_keypts(x1, keyptspath, f"Hokuyo_{id2}")

                marks = [synced_time(dev)]
                v0, f0 = extract_features(model, x0,
                                          voxel_size=args.voxel_size,
                                          device=dev)
                v1, f1 = extract_features(model, x1,
                                          voxel_size=args.voxel_size,
                                          device=dev)
                marks.append(synced_time(dev))
                # nearest-voxel feature at keypoints (reference :110-122)
                kp0_t, kp1_t = (torch.from_numpy(kp).to(dev)
                                for kp in (kp0, kp1))
                nn0, _ = find_nn(kp0_t, v0)
                nn1, _ = find_nn(kp1_t, v1)
                d0, d1 = f0[nn0], f1[nn1]
                marks.append(synced_time(dev))
                corr_t = mutual_nn(d0, d1)
                marks.append(synced_time(dev))
                corr = corr_t.cpu().numpy()
                gt = gt_log[k]  # maps fragment id2 into id1's frame
                frag1 = kp0[corr[:, 0]]
                frag2 = kp1[corr[:, 1]] @ gt[:3, :3].T + gt[:3, 3]
                dist = np.sqrt(((frag1 - frag2) ** 2).sum(1))
                inlier_ratio = float((dist < args.inlier_dist).mean())

                # RANSAC on the mutual-NN keypoint correspondences, in the
                # same direction as gt (id2 -> id1)
                t_est, _, _ = ransac_pose(
                    kp1_t[corr_t[:, 1]], kp0_t[corr_t[:, 0]],
                    args.ransac_dist, generator=gen, num_hypotheses=16384,
                    sample_size=3)
                marks.append(synced_time(dev))
                t_est = t_est.cpu().numpy()
                rte = float(np.linalg.norm(t_est[:3, 3] - gt[:3, 3]))
                cosv = (np.trace(t_est[:3, :3].T @ gt[:3, :3]) - 1) / 2
                rre = float(np.degrees(np.arccos(np.clip(cosv, -1, 1))))
                rr_hit = rte < args.rr_te and rre < args.rr_re
                if est_log:
                    # the reference's .log layout: header + 4x4 rows
                    # (evaluate.py:189-200, already id2 -> id1)
                    with open(est_log, "a") as f:
                        f.write(f"{id1}\t {id2}\t  {num_frag}\n")
                        for r in range(4):
                            f.write("\t ".join(str(t_est[r, cc])
                                               for cc in range(4))
                                    + "\t \n")
                stage_ms = {s: (b - a) * 1e3
                            for s, a, b in zip(STAGES, marks, marks[1:])}
                pairs.append(dict(pair=k, inlier_ratio=inlier_ratio,
                                  rte=rte, rre=rre, registered=rr_hit,
                                  transform=t_est, n_mutual=len(corr),
                                  stage_ms=stage_ms))
                print(f"{scene} {id1}-{id2}: inlier ratio "
                      f"{inlier_ratio:.4f}, RTE {rte:.3f} m, "
                      f"RRE {rre:.2f} deg, registered={rr_hit}; "
                      + ", ".join(f"{s} {ms:.1f} ms"
                                  for s, ms in stage_ms.items()))
        ratios = np.asarray([p["inlier_ratio"] for p in pairs])
        recall = float((ratios > 0.05).mean() * 100) if len(ratios) else 0
        avg_inlier = float(ratios[ratios > 0.05].mean()) \
            if (ratios > 0.05).any() else 0.0
        rr = (float(np.mean([p["registered"] for p in pairs]) * 100)
              if pairs else 0.0)
        print(f"Scene {scene}: feature-match recall {recall:.2f}%, "
              f"avg inlier ratio {avg_inlier:.4f}, "
              f"registration recall {rr:.2f}% "
              f"(TE<{args.rr_te} m, RE<{args.rr_re} deg)")
        results[scene] = dict(recall=recall, avg_inlier=avg_inlier, rr=rr,
                              pairs=pairs)
    out = {"scenes": results,
           "recall": float(np.mean([r["recall"] for r in results.values()])),
           "inlier": float(np.mean([r["avg_inlier"]
                                    for r in results.values()])),
           "rr": float(np.mean([r["rr"] for r in results.values()]))}
    print(f"All scene feature-match recall: {out['recall']}")
    print(f"All scene inliers: {out['inlier']}")
    print(f"All scene registration recall: {out['rr']}")
    return out


if __name__ == "__main__":
    main()
