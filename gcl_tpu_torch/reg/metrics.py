"""Registration metrics: RTE / RRE, registration recall, correspondence
losses (port of gcl_tpu/reg/metrics.py). Transforms and keypoints come as
numpy arrays or tensors; the host-side ones return Python floats."""
from __future__ import annotations

import numpy as np
import torch


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def rte_rre(t_est, t_gt):
    """Relative translation error (m) and rotation error (deg)."""
    t_est, t_gt = _np(t_est), _np(t_gt)
    rte = np.linalg.norm(t_est[:3, 3] - t_gt[:3, 3])
    c = (np.trace(t_est[:3, :3].T @ t_gt[:3, :3]) - 1) / 2
    rre = np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))
    return float(rte), float(rre)


def registration_success(t_est, t_gt, rte_thresh=2.0, rre_thresh=5.0):
    """(success at TE < rte_thresh m and RE < rre_thresh deg, rte, rre)."""
    rte, rre = rte_rre(t_est, t_gt)
    return (rte < rte_thresh and not np.isnan(rre)
            and rre < rre_thresh), rte, rre


def corr_dist(est: torch.Tensor, gth: torch.Tensor, xyz0: torch.Tensor,
              xyz1: torch.Tensor, weight=None, max_dist: float = 1.0):
    """Mean clamped distance between xyz0 moved by est and by gth."""
    xyz0_est = xyz0 @ est[:3, :3].T + est[:3, 3]
    xyz0_gth = xyz0 @ gth[:3, :3].T + gth[:3, 3]
    dists = torch.sqrt(((xyz0_est - xyz0_gth) ** 2).sum(dim=1)).clamp(
        max=max_dist)
    if weight is not None:
        dists = weight * dists
    return dists.mean()


def hit_ratio(xyz0_corr, xyz1_corr, t_gt, thresh):
    """Share of correspondences within ``thresh`` after the GT alignment."""
    t_gt = _np(t_gt)
    aligned = _np(xyz0_corr) @ t_gt[:3, :3].T + t_gt[:3, 3]
    dist = np.sqrt(((aligned - _np(xyz1_corr)) ** 2).sum(1) + 1e-6)
    return float((dist < thresh).mean())


class TransformationLoss:
    """RR / RE / TE at (re_thre deg, te_thre cm), SC2-PCR's evaluation."""

    def __init__(self, re_thre=15, te_thre=30):
        self.re_thre = re_thre
        self.te_thre = te_thre  # centimetres

    def __call__(self, trans, gt_trans, src_keypts, tgt_keypts,
                 pred_labels, gt_labels=None):
        recall = 0.0
        re_l, te_l = [], []
        bs = trans.shape[0]
        for b in range(bs):
            te, re = rte_rre(trans[b], gt_trans[b])
            te *= 100  # cm
            if te < self.te_thre and re < self.re_thre:
                recall += 1
                re_l.append(re)
                te_l.append(te)
        recall = recall * 100 / bs
        re = float(np.mean(re_l)) if re_l else 0.0
        te = float(np.mean(te_l)) if te_l else 0.0
        return recall, re, te


class ClassificationLoss:
    """Inlier precision / recall / F1."""

    def __call__(self, pred_labels, gt_labels):
        pred = _np(pred_labels).reshape(-1) > 0.5
        gt = _np(gt_labels).reshape(-1) > 0.5
        tp = (pred & gt).sum()
        precision = tp / max(pred.sum(), 1)
        recall = tp / max(gt.sum(), 1)
        f1 = 2 * precision * recall / max(precision + recall, 1e-12)
        return dict(precision=float(precision), recall=float(recall),
                    f1=float(f1))
