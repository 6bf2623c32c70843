"""Projection heads (port of gcl_tpu/models/projection_head.py).
Registered alternatives; the shipped configs do not use them.

Both read real features (in_channels wide), so neither has an occupancy
conv1: a conv1_jitter falls through to SparseConv's literal input jitter.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..core.kernel_maps import ConvSpec
from ..core.types import SparseGraph
from .common import SparseConv
from .residual_block import BasicBlock


class ProjectionHeadConv(nn.Module):
    """One sparse conv, in_channels -> out_channels."""

    @classmethod
    def conv_specs(cls, conv1_kernel_size: int) -> Tuple[ConvSpec, ...]:
        return (ConvSpec("conv1", 1, 1, conv1_kernel_size, 1),)

    def __init__(self, in_channels: int = 128, out_channels: int = 16,
                 bn_momentum: Optional[float] = None,
                 normalize_feature: Optional[bool] = None,
                 conv1_kernel_size: Optional[int] = None, D: int = 3,
                 num_items: int = 64):
        super().__init__()
        self.conv1 = SparseConv(in_channels, out_channels,
                                self.conv_specs(conv1_kernel_size)[0])

    def forward(self, graph: SparseGraph, feats: torch.Tensor,
                conv1_jitter=None, generator=None,
                jitter_draws=None) -> torch.Tensor:
        return self.conv1(feats, graph, conv1_jitter, generator,
                          jitter_draws)


class ProjectionHeadMLP(nn.Module):
    """conv1 (in_channels -> CHANNEL) -> a residual block (named norm1, as
    in gcl_tpu) -> relu -> conv2 (CHANNEL -> out_channels), all at stride
    1."""

    CHANNEL = 128
    BLOCK_NORM_TYPE = "BN"

    @classmethod
    def conv_specs(cls, conv1_kernel_size: int) -> Tuple[ConvSpec, ...]:
        return (ConvSpec("conv1", 1, 1, conv1_kernel_size, 1),
                ConvSpec("block", 1, 1, 3, 1))

    def __init__(self, in_channels: int = 128, out_channels: int = 16,
                 bn_momentum: float = 0.1,
                 normalize_feature: Optional[bool] = None,
                 conv1_kernel_size: Optional[int] = None, D: int = 3,
                 num_items: int = 64):
        super().__init__()
        c1 = self.conv_specs(conv1_kernel_size)[0]
        self.conv1 = SparseConv(in_channels, self.CHANNEL, c1)
        self.norm1 = BasicBlock(self.CHANNEL, self.CHANNEL, 1,
                                self.BLOCK_NORM_TYPE,
                                bn_momentum=bn_momentum, num_items=num_items)
        self.conv2 = SparseConv(self.CHANNEL, out_channels, c1)

    def forward(self, graph: SparseGraph, feats: torch.Tensor,
                conv1_jitter=None, generator=None,
                jitter_draws=None) -> torch.Tensor:
        x = self.conv1(feats, graph, conv1_jitter, generator, jitter_draws)
        x = torch.relu(self.norm1(x, graph))
        return self.conv2(x, graph)
