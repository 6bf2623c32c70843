"""R1: the inlier counts of RANSAC's hypotheses, every hypothesis in one
launch.

``ransac_score`` launches the CUDA kernel of ``csrc/ransac_score.cu`` on
CUDA tensors and takes the plain PyTorch version below on CPU tensors. It
replaces no TPU kernel: gcl_tpu scores in XLA (gcl_tpu/reg/ransac.py, a
lax.map over batches of 1024 hypotheses), and the plain version scores as
that map does. The kernel's counts equal the plain version's bit for bit:
it rounds each squared distance as the plain version's cuBLAS product,
elementwise kernels and reduction round it (see the source's notes), and
compares it with the least float32 whose correctly rounded root reaches
the threshold (``squared_threshold``) in place of taking the root.
"""
from __future__ import annotations

import numpy as np
import torch

from .build import check, load_library

HYPOTHESIS_BATCH = 1024  # hypotheses a batch of the plain version


def squared_threshold(distance_threshold: float) -> float:
    """The least float32 s whose correctly rounded square root is at least
    float32(distance_threshold), or 0 where that threshold is not above 0.
    The root is monotone, so for a squared sum s >= 0, sqrt(s) < threshold
    exactly when s < squared_threshold (and a NaN compares false both
    ways)."""
    with np.errstate(over="ignore"):  # past float32's range: inf
        thr = np.float32(distance_threshold)
        if not thr > 0:  # no root of a sum of squares is below it
            return 0.0
        s = np.float32(np.float64(thr) * np.float64(thr))
    down, up = np.float32(0), np.float32(np.inf)
    while s > 0 and np.sqrt(np.nextafter(s, down)) >= thr:
        s = np.nextafter(s, down)
    while np.sqrt(s) < thr:
        s = np.nextafter(s, up)
    return float(s)


def ransac_score_plain(src: torch.Tensor, tgt: torch.Tensor,
                       valid: torch.Tensor, trans: torch.Tensor,
                       ok: torch.Tensor,
                       distance_threshold: float) -> torch.Tensor:
    """Plain version: HYPOTHESIS_BATCH hypotheses at a time, each batch's
    moved points [HYPOTHESIS_BATCH, N, 3] in memory."""
    fit = []
    for tr, okb in zip(torch.split(trans, HYPOTHESIS_BATCH),
                       torch.split(ok, HYPOTHESIS_BATCH)):
        moved = src[None] @ tr[:, :3, :3].transpose(1, 2) + tr[:, None, :3, 3]
        d = moved - tgt[None]
        d = torch.sqrt((d * d).sum(dim=-1))                # [B, N]
        inl = (d < distance_threshold) & valid[None]
        fit.append(inl.sum(dim=1) * okb.long())
    return torch.cat(fit)


def ransac_score(src: torch.Tensor, tgt: torch.Tensor, valid: torch.Tensor,
                 trans: torch.Tensor, ok: torch.Tensor,
                 distance_threshold: float) -> torch.Tensor:
    """fitness[h] = ok[h] ? #{n : valid[n] and |R_h src[n] + t_h - tgt[n]|
    < distance_threshold} : 0, as int64[H].

    src / tgt float32[N, 3] (row n of each a correspondence), valid
    bool[N], trans float32[H, 4, 4] (R_h | t_h in its first three rows),
    ok bool[H] (hypotheses that may score).
    """
    if src.dim() != 2 or src.shape[1] != 3 or tgt.shape != src.shape:
        raise ValueError(f"expected src and tgt [N, 3] of one shape, got "
                         f"{tuple(src.shape)} and {tuple(tgt.shape)}")
    if trans.dim() != 3 or trans.shape[1:] != (4, 4):
        raise ValueError(f"expected trans [H, 4, 4], got {tuple(trans.shape)}")
    if valid.shape != src.shape[:1] or ok.shape != trans.shape[:1]:
        raise ValueError("valid must be [N] and ok [H]")
    for name, t, dtype in (("src", src, torch.float32),
                           ("tgt", tgt, torch.float32),
                           ("trans", trans, torch.float32),
                           ("valid", valid, torch.bool),
                           ("ok", ok, torch.bool)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != src.device:
            raise ValueError(f"{name} on {t.device}, src on {src.device}")
    if src.device.type == "cpu":
        return ransac_score_plain(src, tgt, valid, trans, ok,
                                  distance_threshold)
    if src.device.type != "cuda":
        raise ValueError(f"unsupported device {src.device}")
    src, tgt, valid, trans, ok = (t.contiguous()
                                  for t in (src, tgt, valid, trans, ok))
    if trans.data_ptr() % 16:  # the kernel reads a fit's rows as float4
        trans = trans.clone()
    h, n = trans.shape[0], src.shape[0]
    fitness = torch.empty(h, dtype=torch.int64, device=src.device)
    stream = torch.cuda.current_stream(src.device).cuda_stream
    err = load_library().ransac_score(
        src.data_ptr(), tgt.data_ptr(), valid.data_ptr(), trans.data_ptr(),
        ok.data_ptr(), fitness.data_ptr(), n, h,
        squared_threshold(distance_threshold), stream)
    check(err, "ransac_score")
    ransac_score.launches += 1
    ransac_score.hypotheses += h
    return fitness


ransac_score.launches = 0
ransac_score.hypotheses = 0
