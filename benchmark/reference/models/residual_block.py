"""Sparse residual block: conv3x3 -> norm -> relu -> conv3x3 -> norm, plus
identity, then relu (port of gcl_tpu/models/residual_block.py)."""
from __future__ import annotations

import torch
from torch import nn

from ..core.kernel_maps import ConvSpec
from ..core.types import SparseGraph
from .common import SparseConv, get_norm


class BasicBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride_level: int,
                 norm_type: str = "BN", dilation: int = 1,
                 bn_momentum: float = 0.1, num_items: int = 64):
        super().__init__()
        self.stride_level = stride_level
        spec = ConvSpec("block_conv", stride_level, stride_level, 3,
                        dilation)
        self.conv1 = SparseConv(inplanes, planes, spec)
        self.norm1 = get_norm(norm_type, planes, bn_momentum, num_items)
        self.conv2 = SparseConv(planes, planes, spec)
        self.norm2 = get_norm(norm_type, planes, bn_momentum, num_items)

    def forward(self, x: torch.Tensor, graph: SparseGraph) -> torch.Tensor:
        level = graph.levels[self.stride_level]
        mb = (level.mask, level.coords[:, 0])
        out = torch.relu(self.norm1(self.conv1(x, graph), *mb))
        out = self.norm2(self.conv2(out, graph), *mb)
        return torch.relu(out + x)
