"""Dense generative MLPs (port of gcl_tpu/models/mlp.py): the reference's
point-upsampling experiment heads, registered for API parity and unused by
the shipped configs. They map dense [N, in_channel] features to
out_points * 3 coordinates through Linear -> ReLU -> BatchNorm stacks.
"""
from __future__ import annotations

import math

import torch
from torch import nn


class DenseBatchNorm(nn.Module):
    """flax.linen.BatchNorm over the rows of a dense [N, C] input, as
    gcl_tpu's MLPs build it (momentum 1 - bn_momentum): train mode
    normalizes with the batch mean and the biased variance E[x^2] -
    E[x]^2 (flax's fast variance, clipped at 0) and moves the running
    statistics by ``bn_momentum`` towards them, the running variance to
    the BIASED batch variance (torch.nn.BatchNorm1d takes the unbiased
    one); eval mode uses the running statistics. Parameters ``scale`` and
    ``bias``, buffers ``mean`` and ``var``, as flax names them."""

    def __init__(self, features: int, bn_momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = 1.0 - bn_momentum, eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training:
            mean = xf.mean(dim=0)
            var = ((xf * xf).mean(dim=0) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                self.var.copy_(m * self.var + (1.0 - m) * var)
        else:
            mean, var = self.mean, self.var
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.scale)
        return (y + self.bias).to(x.dtype)


def _dense(n_in: int, n_out: int) -> nn.Linear:
    """nn.Linear with flax Dense's init: lecun-normal weights (a normal of
    variance 1 / fan_in truncated at two deviations), zero bias. Its
    weight is [out, in]; the flax kernel is [in, out] (models.weights
    transposes)."""
    layer = nn.Linear(n_in, n_out)
    std = math.sqrt(1.0 / n_in) / 0.87962566103423978
    nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std, b=2 * std)
    nn.init.zeros_(layer.bias)
    return layer


class _GenerativeMLPBase(nn.Module):
    CHANNELS = [None, 512, 128, None]

    def __init__(self, in_channel: int = 125, out_points: int = 6,
                 bn_momentum: float = 0.1):
        super().__init__()
        hidden = [c for c in self.CHANNELS if c is not None]
        n_in = in_channel
        for i, ch in enumerate(hidden):
            self.add_module(f"dense{i+1}", _dense(n_in, ch))
            self.add_module(f"bn{i+1}", DenseBatchNorm(ch, bn_momentum))
            n_in = ch
        self.n_hidden = len(hidden)
        self.dense_out = _dense(n_in, out_points * 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[N, in_channel] -> [N, out_points * 3]; train mode is
        nn.Module.train()."""
        for i in range(1, self.n_hidden + 1):
            x = torch.relu(getattr(self, f"dense{i}")(x))
            x = getattr(self, f"bn{i}")(x)
        return torch.relu(self.dense_out(x))


class GenerativeMLP(_GenerativeMLPBase):
    CHANNELS = [None, 512, 128, None]


class GenerativeMLP_98(_GenerativeMLPBase):
    CHANNELS = [None, 512, 256, None]


class GenerativeMLP_54(_GenerativeMLPBase):
    CHANNELS = [None, 32, 16, None]


class GenerativeMLP_4(_GenerativeMLPBase):
    CHANNELS = [None, 16, None]


class GenerativeMLP_11_10_9(_GenerativeMLPBase):
    CHANNELS = [None, 2048, 1024, 512, None]
