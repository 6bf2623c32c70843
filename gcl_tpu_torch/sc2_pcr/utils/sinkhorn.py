"""Sinkhorn optimal-transport matching in the log domain (port of
scripts/SC2_PCR/utils/sinkhorn.py, reference
scripts/SC2_PCR/utils/sinkhorn.py:9-80) in torch: an auxiliary matcher."""
from __future__ import annotations

import math

import torch


def log_sinkhorn_iterations(z: torch.Tensor, log_mu: torch.Tensor,
                            log_nu: torch.Tensor, iters: int
                            ) -> torch.Tensor:
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(z + v[None, :], dim=1)
        v = log_nu - torch.logsumexp(z + u[:, None], dim=0)
    return z + u[:, None] + v[None, :]


def log_optimal_transport(scores: torch.Tensor, alpha: float,
                          iters: int) -> torch.Tensor:
    """Differentiable OT with a dustbin row and column (SuperGlue-style),
    the formulation the reference's sinkhorn util implements: scores [m,
    n] -> log transport plan [m + 1, n + 1]."""
    m, n = scores.shape
    alpha = torch.as_tensor(alpha, dtype=scores.dtype, device=scores.device)
    couplings = torch.cat([
        torch.cat([scores, alpha.expand(m, 1)], dim=1),
        torch.cat([alpha.expand(1, n), alpha.expand(1, 1)], dim=1)])
    norm = -math.log(m + n)
    log_mu = torch.cat([torch.full((m,), norm, dtype=scores.dtype,
                                   device=scores.device),
                        torch.full((1,), math.log(n) + norm,
                                   dtype=scores.dtype,
                                   device=scores.device)])
    log_nu = torch.cat([torch.full((n,), norm, dtype=scores.dtype,
                                   device=scores.device),
                        torch.full((1,), math.log(m) + norm,
                                   dtype=scores.dtype,
                                   device=scores.device)])
    z = log_sinkhorn_iterations(couplings, log_mu, log_nu, iters)
    return z - norm
