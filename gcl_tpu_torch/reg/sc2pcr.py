"""SC2-PCR robust registration in eager PyTorch (port of
gcl_tpu/reg/sc2pcr.py).

  1. feature-argmin correspondences
  2. pairwise length consistency (cross_dist)
  3. first-order SC measure + power-iteration confidence
  4. NMS seed picking
  5. SC^2 = (hardSC_tight @ hardSC_tight) * hardSC on seeds
  6. two-stage k1/k2 consensus expansion + weighted-SVD hypotheses,
     best by inlier count
  7. iterative reweighted post-refinement (20 rounds)

The spans (utils.spans) ``sc2pcr/match`` (1), ``sc2pcr/consistency``
(2-3), ``sc2pcr/seeds`` (4-5), ``sc2pcr/hypotheses`` (6) and
``sc2pcr/refine`` (7 and the inlier labels) name the stages in a
profiler trace.

Ties are broken as gcl_tpu breaks them: top-k keeps the lower index
(jax.lax.top_k) and seed ordering is a stable sort, so both are stable
descending sorts here (torch.topk promises no order among equal values).
float32 matmuls must not run in TF32 on the card
(torch.backends.cuda.matmul.allow_tf32 = False, PyTorch's default).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..utils.spans import span
from .procrustes import rigid_transform_3d
from .se3 import transform


def _norm(d: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, written as jnp.linalg.norm."""
    return torch.sqrt((d * d).sum(dim=-1))


def stable_topk_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last axis, ties by lower
    index first (jax.lax.top_k's order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True)[1][..., :k]


class Matcher:
    def __init__(self, inlier_threshold=0.10, num_node="all",
                 use_mutual=True, d_thre=0.1, num_iterations=10, ratio=0.2,
                 nms_radius=0.1, max_points=8000, k1=30, k2=20):
        self.inlier_threshold = inlier_threshold
        self.num_node = num_node
        self.use_mutual = use_mutual
        self.d_thre = d_thre
        self.num_iterations = num_iterations
        self.ratio = ratio
        self.nms_radius = nms_radius
        self.max_points = max_points
        self.k1 = k1
        self.k2 = k2

    def cal_leading_eigenvector(self, m: torch.Tensor) -> torch.Tensor:
        """Power iteration, fixed number of iterations."""
        v = torch.ones_like(m[..., :, 0:1])
        for _ in range(self.num_iterations):
            v = m @ v
            v = v / (torch.sqrt((v * v).sum(dim=-2, keepdim=True)) + 1e-6)
        return v[..., 0]

    def pick_seeds(self, dists, scores, r, max_num):
        """Parallel NMS. scores [1, N]; returns [1, max_num] indices."""
        relation = (scores.T >= scores) | (dists[0] >= r)
        is_local_max = relation.to(torch.float32).min(dim=-1).values
        score_local_max = scores * is_local_max
        return stable_topk_indices(score_local_max, max_num)

    def cal_seed_trans(self, seeds, sc2_measure, src_keypts, tgt_keypts):
        """Per-seed consensus expansion + weighted-SVD hypotheses; the best
        by inlier count."""
        bs = src_keypts.shape[0]
        k1, k2 = self.k1, self.k2
        if k1 > sc2_measure.shape[2]:
            k1 = k2 = 4

        def take(pts, idx):  # pts [bs, N, 3], idx [bs, S, k] -> [bs,S,k,3]
            flat = idx.reshape(bs, -1, 1).expand(-1, -1, 3)
            return torch.gather(pts, 1, flat).reshape(*idx.shape, 3)

        # stage 1: k1 most compatible correspondences per seed
        knn_idx = stable_topk_indices(sc2_measure, k1)      # [bs, S, k1]
        src_knn = take(src_keypts, knn_idx)
        tgt_knn = take(tgt_keypts, knn_idx)
        src_dist = _norm(src_knn[:, :, :, None] - src_knn[:, :, None])
        tgt_dist = _norm(tgt_knn[:, :, :, None] - tgt_knn[:, :, None])
        cross = torch.abs(src_dist - tgt_dist)
        hard = (cross < self.d_thre).to(torch.float32)
        local_sc2 = hard[:, :, :1] @ hard                   # [bs,S,1,k1]

        # stage 2: k2 densest within the k1 subset
        fine = stable_topk_indices(local_sc2[:, :, 0], k2)  # [bs,S,k2]
        fidx = fine[..., None].expand(-1, -1, -1, 3)
        src_f = torch.gather(src_knn, 2, fidx)
        tgt_f = torch.gather(tgt_knn, 2, fidx)
        sd = _norm(src_f[:, :, :, None] - src_f[:, :, None])
        td = _norm(tgt_f[:, :, :, None] - tgt_f[:, :, None])
        cross = torch.abs(sd - td)
        local_sc = torch.clamp(1 - cross ** 2 / self.d_thre ** 2, min=0.0)
        m = local_sc.reshape(-1, k2, k2)
        m = m * (1.0 - torch.eye(k2, dtype=m.dtype, device=m.device))
        w = self.cal_leading_eigenvector(m)
        w = w.reshape(bs, -1, k2)
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-6)

        seed_trans = rigid_transform_3d(
            src_f.reshape(-1, k2, 3), tgt_f.reshape(-1, k2, 3),
            w.reshape(-1, k2)).reshape(bs, -1, 4, 4)

        pred = (torch.einsum("bsij,bnj->bsni", seed_trans[:, :, :3, :3],
                             src_keypts)
                + seed_trans[:, :, None, :3, 3])
        l2 = _norm(pred - tgt_keypts[:, None])
        fitness = (l2 < self.inlier_threshold).sum(dim=-1)
        best = torch.argmax(fitness, dim=1)
        return seed_trans[torch.arange(bs, device=best.device), best]

    def post_refinement(self, trans, src_keypts, tgt_keypts, it_num,
                        weights=None):
        """Iterative reweighted Kabsch over the current inliers."""
        thr = 0.10 if self.inlier_threshold == 0.10 else 1.2
        for _ in range(it_num):
            warped = transform(src_keypts, trans)
            l2 = _norm(warped - tgt_keypts)
            inlier = (l2 < thr).to(torch.float32)
            w = inlier / (1 + (l2 / thr) ** 2)
            trans = rigid_transform_3d(src_keypts, tgt_keypts, w)
        return trans

    def match_pair(self, src_keypts, tgt_keypts, src_features,
                   tgt_features, generator: Optional[torch.Generator] = None):
        """Coarse correspondences via feature argmin (normalized features:
        distance = 2 - 2 cos). With num_node != 'all', ``generator`` draws
        the random node subsets."""
        n_src = src_features.shape[1]
        n_tgt = tgt_features.shape[1]
        if self.num_node != "all":
            dev = src_features.device
            src_sel = torch.randint(0, n_src, (self.num_node,),
                                    generator=generator).to(dev)
            tgt_sel = torch.randint(0, n_tgt, (self.num_node,),
                                    generator=generator).to(dev)
            src_features = src_features[:, src_sel]
            tgt_features = tgt_features[:, tgt_sel]
            src_keypts = src_keypts[:, src_sel]
            tgt_keypts = tgt_keypts[:, tgt_sel]
        d = 2 - 2 * (src_features[0] @ tgt_features[0].T)
        source_idx = torch.argmin(d, dim=1)
        return src_keypts, tgt_keypts[:, source_idx]

    def SC2_PCR(self, src_keypts, tgt_keypts):
        """Core estimator. Inputs [bs, N, 3] with N <= max_points; returns
        [bs, 4, 4]."""
        num_corr = src_keypts.shape[1]
        with span("sc2pcr/consistency"):
            src_dist = _norm(src_keypts[:, :, None] - src_keypts[:, None])
            tgt_dist = _norm(tgt_keypts[:, :, None] - tgt_keypts[:, None])
            cross = torch.abs(src_dist - tgt_dist)
            sc = torch.clamp(1.0 - cross ** 2 / self.d_thre ** 2, min=0.0)
            hard = (cross < self.d_thre).to(torch.float32)
            confidence = self.cal_leading_eigenvector(sc)

        with span("sc2pcr/seeds"):
            seeds = self.pick_seeds(src_dist, confidence, self.nms_radius,
                                    int(num_corr * self.ratio))
            hard_tight = (cross < self.d_thre / 2).to(torch.float32)
            sidx = seeds[:, :, None].expand(-1, -1, num_corr)
            seed_hard = torch.gather(hard, 1, sidx)
            seed_hard_tight = torch.gather(hard_tight, 1, sidx)
            sc2 = (seed_hard_tight @ hard_tight) * seed_hard

        with span("sc2pcr/hypotheses"):
            trans = self.cal_seed_trans(seeds, sc2, src_keypts, tgt_keypts)
        with span("sc2pcr/refine"):
            return self.post_refinement(trans, src_keypts, tgt_keypts, 20)

    def estimator(self, src_keypts, tgt_keypts, src_features, tgt_features,
                  generator: Optional[torch.Generator] = None):
        """Full pipeline. Returns (pred_trans, pred_labels, src_keypts_corr,
        tgt_keypts_corr)."""
        with span("sc2pcr/match"):
            src_c, tgt_c = self.match_pair(src_keypts, tgt_keypts,
                                           src_features, tgt_features,
                                           generator)
            if src_c.shape[1] > self.max_points:
                src_c = src_c[:, :self.max_points]
                tgt_c = tgt_c[:, :self.max_points]
        pred_trans = self.SC2_PCR(src_c, tgt_c)
        with span("sc2pcr/refine"):
            warped = transform(src_c, pred_trans)
            dist = _norm(warped - tgt_c)
            labels = (dist < self.inlier_threshold).to(torch.float32)
        return pred_trans, labels, src_c, tgt_c
