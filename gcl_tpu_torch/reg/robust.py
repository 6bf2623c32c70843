"""Robust linearised pose estimation, the validation step's pose (port of
gcl_tpu/reg/robust.py): 20 rounds of small-angle weighted least squares
with Geman-McClure-style reweighting, ``par`` halved every 5 rounds."""
from __future__ import annotations

from typing import Optional

import torch


def _get_trans(x: torch.Tensor) -> torch.Tensor:
    """x [6] = (rx, ry, rz, tx, ty, tz) -> 4x4 with R = Rz Ry Rx."""
    cx, sx = torch.cos(x[0]), torch.sin(x[0])
    cy, sy = torch.cos(x[1]), torch.sin(x[1])
    cz, sz = torch.cos(x[2]), torch.sin(x[2])
    o, z = torch.ones_like(cx), torch.zeros_like(cx)
    rx = torch.stack([o, z, z, z, cx, -sx, z, sx, cx]).reshape(3, 3)
    ry = torch.stack([cy, z, sy, z, o, z, -sy, z, cy]).reshape(3, 3)
    rz = torch.stack([cz, -sz, z, sz, cz, z, z, z, o]).reshape(3, 3)
    t = torch.eye(4, dtype=x.dtype, device=x.device)
    t[:3, :3] = rz @ ry @ rx
    t[:3, 3] = x[3:]
    return t


def _build_system(pts0: torch.Tensor, pts1: torch.Tensor,
                  weight: torch.Tensor):
    """The linearisation A x = b, rows weighted by weight [N, 1]."""
    z = torch.zeros_like(pts0[:, 0])
    o = torch.ones_like(pts0[:, 0])
    a0 = torch.stack([z, pts0[:, 2], -pts0[:, 1], o, z, z], 1)
    a1 = torch.stack([-pts0[:, 2], z, pts0[:, 0], z, o, z], 1)
    a2 = torch.stack([pts0[:, 1], -pts0[:, 0], z, z, z, o], 1)
    w = torch.cat([weight, weight, weight], 0)
    a = w * torch.cat([a0, a1, a2], 0)
    b = w * (pts1 - pts0).T.reshape(-1)[:, None]
    return a, b


def est_quad_linear_robust(pts0: torch.Tensor, pts1: torch.Tensor,
                           weight: Optional[torch.Tensor] = None,
                           mask: Optional[torch.Tensor] = None,
                           iters: int = 20) -> torch.Tensor:
    """T [4, 4] aligning pts0 onto pts1 ([N, 3] each); ``mask`` bool[N]
    zeroes the weight of padded rows."""
    n = pts0.shape[0]
    dt, dev = pts0.dtype, pts0.device
    if weight is None:
        weight = torch.ones((n, 1), dtype=dt, device=dev)
    m = None if mask is None else mask[:, None].to(dt)
    if m is not None:
        weight = weight * m
    eye6 = 1e-9 * torch.eye(6, dtype=dt, device=dev)
    pts0_curr = pts0
    trans = torch.eye(4, dtype=dt, device=dev)
    par = 1.0
    for i in range(iters):
        if i > 0 and i % 5 == 0:
            par = par / 2.0
        a, b = _build_system(pts0_curr, pts1, weight)
        x = torch.linalg.solve(a.T @ a + eye6, a.T @ b)[:, 0]
        tc = _get_trans(x)
        pts0_curr = pts0_curr @ tc[:3, :3].T + tc[:3, 3]
        weight = par / (torch.sqrt(((pts0_curr - pts1) ** 2).sum(1))[:, None]
                        + par)
        if m is not None:
            weight = weight * m
        trans = tc @ trans
    return trans
