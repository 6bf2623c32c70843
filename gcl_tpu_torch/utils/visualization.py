"""Feature visualization (port of gcl_tpu/utils/visualization.py): embed
per-point features to 1-D with t-SNE, map the embedding through the
Spectral colormap and write a coloured PLY.

Neither scikit-learn nor matplotlib is needed:

- ``embed_tsne`` is an **exact** 1-D t-SNE in torch, on the features'
  device. gcl_tpu calls scikit-learn's default, Barnes-Hut, which
  approximates what the exact method computes. It follows
  ``sklearn/manifold/_t_sne.py`` with ``method="exact"`` step for step:
  the perplexity binary search (perplexity 40, float32 squared distances,
  float64 probabilities), the joint P, the KL gradient of a Student-t
  with one degree of freedom, ``learning_rate="auto"``, 250 iterations at
  early exaggeration 12 and momentum 0.5, then momentum 0.8 up to 300,
  per-parameter gains (min_gain 0.01), a convergence check every 50
  iterations, the embedding in float32 and its update in float64 (numpy
  promotes the float64 learning rate), and PCA's first component as the
  initialisation. It needs the N x N joint P in float64 (8 N^2 bytes: 34
  GB at N = 65,536); P and the gradient are computed in row chunks so
  that nothing else of that size is held.
- ``spectral_colors`` is matplotlib's ``Spectral`` colormap: its 256-entry
  lookup table built from ColorBrewer's 11 anchor colours (matplotlib's
  ``_cm.py:_Spectral_data``) as ``LinearSegmentedColormap.from_list``
  builds it, indexed as ``Colormap.__call__`` indexes floats.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .pointcloud import write_ply_xyz

# matplotlib's _cm.py:_Spectral_data (ColorBrewer's Spectral, 11 classes)
_SPECTRAL_DATA = (
    (0.61960784313725492, 0.003921568627450980, 0.25882352941176473),
    (0.83529411764705885, 0.24313725490196078, 0.30980392156862746),
    (0.95686274509803926, 0.42745098039215684, 0.2627450980392157),
    (0.99215686274509807, 0.68235294117647061, 0.38039215686274508),
    (0.99607843137254903, 0.8784313725490196, 0.54509803921568623),
    (1.0, 1.0, 0.74901960784313726),
    (0.90196078431372551, 0.96078431372549022, 0.59607843137254901),
    (0.6705882352941176, 0.8666666666666667, 0.64313725490196083),
    (0.4, 0.76078431372549016, 0.6470588235294118),
    (0.19607843137254902, 0.53333333333333333, 0.74117647058823533),
    (0.36862745098039218, 0.30980392156862746, 0.63529411764705879),
)
_LUT_SIZE = 256

PERPLEXITY = 40.0
EARLY_EXAGGERATION = 12.0
EXPLORATION_ITER = 250
MAX_ITER = 300
N_ITER_CHECK = 50
MIN_GAIN = 0.01
MIN_GRAD_NORM = 1e-7
MACHINE_EPSILON = float(np.finfo(np.double).eps)
# the binary search's constants, C floats in sklearn/manifold/_utils.pyx
_EPSILON_DBL = float(np.float32(1e-8))
_PERPLEXITY_TOLERANCE = float(np.float32(1e-5))
_SEARCH_STEPS = 100
# entries of one row chunk's [rows, N] temporaries: large on the card,
# cache-sized on the CPU
_CHUNK_ELEMENTS = {"cuda": 1 << 25, "cpu": 1 << 18}


def _spectral_lut() -> np.ndarray:
    """float64[256, 3]: matplotlib's _create_lookup_table over the anchors,
    evenly spaced on [0, 1], per channel."""
    anchors = np.array(_SPECTRAL_DATA, dtype=float)
    x = np.linspace(0, 1, len(anchors)) * (_LUT_SIZE - 1)
    xind = (_LUT_SIZE - 1) * np.linspace(0, 1, _LUT_SIZE) ** 1.0
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.empty((_LUT_SIZE, 3))
    for c in range(3):
        y = anchors[:, c]
        lut[:, c] = np.concatenate([[y[0]],
                                    distance * (y[ind] - y[ind - 1])
                                    + y[ind - 1], [y[-1]]])
    return np.clip(lut, 0.0, 1.0)


def spectral_colors(t) -> np.ndarray:
    """float64[N, 3] RGB of values t in [0, 1] under the Spectral colormap:
    entry int(t * 256) of the table, 1.0 taking the last entry, values
    below 0 the first and above 1 the last, NaN black (matplotlib's
    under, over and bad colours)."""
    xa = np.array(t, copy=True)
    if xa.dtype.kind != "f":
        xa = xa.astype(float)
    xa *= _LUT_SIZE
    bad = np.isnan(xa)
    idx = np.clip(np.where(bad, 0, xa), 0, _LUT_SIZE - 1).astype(int)
    colors = _spectral_lut()[idx]
    colors[bad] = 0.0
    return colors


def pca_init(x: torch.Tensor) -> torch.Tensor:
    """t-SNE's PCA initialisation, float32[N]: the projection on the first
    principal component of x [N, D] (the covariance's top eigenvector, its
    largest entry made positive, as sklearn's svd_flip with
    u_based_decision=False), cast to float32 and scaled to std 1e-4."""
    x = x.to(torch.float64)
    xc = x - x.mean(dim=0)
    cov = xc.T @ xc / (x.shape[0] - 1)
    v = torch.linalg.eigh(cov)[1][:, -1]
    v = v * torch.sign(v[torch.argmax(v.abs())])
    y = (xc @ v).to(torch.float32)
    return y / y.std(unbiased=False) * 1e-4


def _row_chunks(n: int, device: torch.device):
    """[lo, hi) row ranges whose [rows, n] temporaries fit the budget."""
    rows = max(1, _CHUNK_ELEMENTS.get(device.type, 1 << 18) // max(n, 1))
    return [(lo, min(lo + rows, n)) for lo in range(0, n, rows)]


def _block_pairs(n: int, device: torch.device):
    """The square blocks ((a0, a1), (b0, b1)) of an n x n symmetric matrix
    on and above its diagonal, each within the budget."""
    size = max(1, math.isqrt(_CHUNK_ELEMENTS.get(device.type, 1 << 18)))
    edges = [(lo, min(lo + size, n)) for lo in range(0, n, size)]
    return [(a, b) for i, a in enumerate(edges) for b in edges[i:]]


def _conditional_p(d: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """sklearn's _binary_search_perplexity for a chunk of rows: float32
    squared distances d [R, N] (row r is point rows[r]) -> float64 p_j|i
    [R, N], each row's precision searched to perplexity 40; each step
    computes the rows still searching (a row that converged keeps its
    values)."""
    r_n = d.shape[0]
    dev = d.device
    beta = torch.ones(r_n, dtype=torch.float64, device=dev)
    beta_min = torch.full_like(beta, -math.inf)
    beta_max = torch.full_like(beta, math.inf)
    idx = torch.arange(r_n, device=dev)  # the rows still searching
    p = torch.zeros(d.shape, dtype=torch.float64, device=dev)
    desired = math.log(PERPLEXITY)
    for _ in range(_SEARCH_STEPS):
        da = d[idx].to(torch.float64)
        b = beta[idx]
        pc = torch.exp(-da * b[:, None])
        pc[torch.arange(len(idx), device=dev), rows[idx]] = 0.0
        sum_p = pc.sum(dim=1)
        sum_p = torch.where(sum_p == 0.0, _EPSILON_DBL, sum_p)
        pc /= sum_p[:, None]
        entropy = torch.log(sum_p) + b * (da * pc).sum(dim=1)
        diff = entropy - desired
        p[idx] = pc
        step = diff.abs() > _PERPLEXITY_TOLERANCE
        up = diff > 0.0
        lo, hi = beta_min[idx], beta_max[idx]
        raised = torch.where(torch.isinf(hi), b * 2.0, (b + hi) / 2.0)
        lowered = torch.where(torch.isinf(lo), b / 2.0, (b + lo) / 2.0)
        beta_min[idx] = torch.where(up, b, lo)
        beta_max[idx] = torch.where(up, hi, b)
        beta[idx] = torch.where(up, raised, lowered)
        idx = idx[step]
        if len(idx) == 0:
            break
    return p


def joint_probabilities(x: torch.Tensor) -> torch.Tensor:
    """The joint P of exact t-SNE, float64 [N, N] (diagonal 0): squared
    euclidean distances of x [N, D] in float64 (clipped at 0, diagonal 0)
    cast to float32, conditional probabilities at perplexity 40,
    symmetrised, normalised, floored at machine epsilon."""
    x = x.to(torch.float64)
    n = x.shape[0]
    sq = (x * x).sum(dim=1)
    p = torch.empty((n, n), dtype=torch.float64, device=x.device)
    for lo, hi in _row_chunks(n, x.device):
        rows = torch.arange(lo, hi, device=x.device)
        d = (-2.0 * (x[lo:hi] @ x.T) + sq[lo:hi, None] + sq[None, :]
             ).clamp_min(0.0)
        d[rows - lo, rows] = 0.0
        p[lo:hi] = _conditional_p(d.to(torch.float32), rows)
    for (a0, a1), (b0, b1) in _block_pairs(n, x.device):  # P + P.T
        s = p[a0:a1, b0:b1] + p[b0:b1, a0:a1].T
        p[a0:a1, b0:b1] = s
        p[b0:b1, a0:a1] = s.T
    sum_p = max(float(p.sum()), MACHINE_EPSILON)
    p /= sum_p
    p.clamp_min_(MACHINE_EPSILON)
    p.fill_diagonal_(0.0)
    return p


def _kl_divergence(y: torch.Tensor, p: torch.Tensor, compute_error: bool):
    """(KL(P || Q) or NaN, float32 gradient [N]) at the embedding y
    float32[N], as sklearn's _kl_divergence with one degree of freedom:
    w_ij = 1 / (1 + (y_i - y_j)^2) in float64, Q = max(w / sum w, eps),
    grad_i = 4 sum_j (P_ij - Q_ij) w_ij (y_i - y_j), the last difference
    taken in float32 as sklearn takes it. P, Q and w are symmetric and
    that difference antisymmetric (exactly, in IEEE arithmetic), so each
    block above the diagonal also gives the rows of its mirror image."""
    yd = y.to(torch.float64)
    n = yd.shape[0]
    pairs = _block_pairs(n, y.device)
    z = yd.new_zeros(())
    for (a0, a1), (b0, b1) in pairs:
        d = yd[a0:a1, None] - yd[None, b0:b1]
        s = d.square_().add_(1.0).reciprocal_().sum()
        z += s if a0 == b0 else 2.0 * s
    z -= n  # w_ii = 1 on the diagonal
    grad = torch.zeros(n, dtype=torch.float64, device=y.device)
    kl = yd.new_zeros(())
    for (a0, a1), (b0, b1) in pairs:
        d = yd[a0:a1, None] - yd[None, b0:b1]
        w = d.square_().add_(1.0).reciprocal_()
        q = torch.div(w, z).clamp_min_(MACHINE_EPSILON)
        pc = p[a0:a1, b0:b1]
        if compute_error:  # P's diagonal is 0: the pairs i != j only
            s = torch.where(pc > 0, pc * torch.log(pc / q), 0.0).sum()
            kl += s if a0 == b0 else 2.0 * s
        m = torch.sub(pc, q).mul_(w).mul_(y[a0:a1, None] - y[None, b0:b1])
        grad[a0:a1] += m.sum(dim=1)
        if a0 != b0:
            grad[b0:b1] -= m.sum(dim=0)
    return (float(kl) if compute_error else math.nan,
            grad.to(torch.float32) * 4.0)


def _gradient_descent(y, p, it, max_iter, momentum, learning_rate,
                      n_iter_without_progress):
    """sklearn's _gradient_descent: momentum, per-parameter gains, a check
    every N_ITER_CHECK iterations. Returns (y, error, last iteration)."""
    y = y.clone()
    update = torch.zeros_like(y, dtype=torch.float64)
    gains = torch.ones_like(y)
    error = best_error = float(np.finfo(float).max)
    best_iter = i = it
    for i in range(it, max_iter):
        check = (i + 1) % N_ITER_CHECK == 0
        error, grad = _kl_divergence(y, p, check or i == max_iter - 1)
        inc = update * grad < 0.0
        gains = torch.where(inc, gains + 0.2, gains * 0.8).clamp_min_(
            MIN_GAIN)
        grad = grad * gains
        update = momentum * update - learning_rate * grad.to(torch.float64)
        y = (y.to(torch.float64) + update).to(torch.float32)
        if check:
            if error < best_error:
                best_error, best_iter = error, i
            elif i - best_iter > n_iter_without_progress:
                break
            if float(torch.linalg.vector_norm(grad)) <= MIN_GRAD_NORM:
                break
    return y, error, i


def tsne_1d(x: torch.Tensor, init: torch.Tensor | None = None
            ) -> torch.Tensor:
    """Exact 1-D t-SNE of x [N, D] (perplexity 40, 300 iterations,
    learning rate "auto"), float32[N] on x's device; ``init`` float32[N]
    (default: pca_init(x))."""
    y = pca_init(x) if init is None else init.to(x.device, torch.float32)
    p = joint_probabilities(x)
    learning_rate = max(x.shape[0] / EARLY_EXAGGERATION / 4, 50.0)
    p *= EARLY_EXAGGERATION
    y, _, it = _gradient_descent(y, p, 0, EXPLORATION_ITER, 0.5,
                                 learning_rate, EXPLORATION_ITER)
    p /= EARLY_EXAGGERATION
    y, _, _ = _gradient_descent(y, p, it + 1, MAX_ITER, 0.8, learning_rate,
                                MAX_ITER)
    return y


def embed_tsne(data) -> torch.Tensor:
    """1-D exact t-SNE embedding of the rows of ``data`` (a tensor, on its
    device, or an array), scaled to [0, 1], float32[N]."""
    x = torch.as_tensor(data)
    t = tsne_1d(x)
    return (t - t.min()) / (t.max() - t.min())


def get_colored_point_cloud_feature_ply(xyz, feature, path,
                                        voxel_size=0.025):
    """t-SNE-colour the features and write the points as a coloured PLY
    (gcl_tpu's; ``voxel_size`` is unused there too). Returns the path."""
    t = embed_tsne(feature)
    colors = spectral_colors(t.cpu().numpy())
    write_ply_xyz(path, np.asarray(torch.as_tensor(xyz).cpu(), np.float32),
                  colors)
    return path
