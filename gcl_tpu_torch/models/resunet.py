"""Sparse residual U-Net (port of gcl_tpu/models/resunet.py: ResUNet2,
ResUNetFatBN, GCL's default backbone, and ResUNetFatBNEXP, the FCGF
baseline's).

conv1 (k=conv1_kernel_size, occupancy) -> block1 -> 3x (strided conv +
residual block) encoder -> 3x (transpose conv + skip concat + residual
block) decoder -> 1x1 conv1_tr -> relu -> 1x1 final (bias) -> optional L2
normalization. Geometry comes precomputed in a SparseGraph built for
``conv_specs()``. The variants with a dilated conv1_extra and the IN
variants are not ported.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..core.kernel_maps import ConvSpec
from ..core.sparse_ops import l2_normalize
from ..core.types import SparseGraph
from .common import SparseConv, get_norm
from .residual_block import BasicBlock


class ResUNet2(nn.Module):
    NORM_TYPE = None
    BLOCK_NORM_TYPE = "BN"
    CHANNELS = [None, 32, 64, 128, 256]
    TR_CHANNELS = [None, 32, 64, 64, 128]
    STRIDES = [1, 2, 2, 2]
    KERNEL_SIZES = [None, 3, 3, 3]
    DILATIONS = [1, 1, 1, 1]

    @classmethod
    def encoder_strides(cls) -> Tuple[int, ...]:
        """Tensor stride after conv1, conv2, conv3, conv4."""
        s = 1
        out = [s]
        for i in (1, 2, 3):
            s *= cls.STRIDES[i]
            out.append(s)
        return tuple(out)

    @classmethod
    def conv_specs(cls, conv1_kernel_size: int) -> Tuple[ConvSpec, ...]:
        """Every distinct conv geometry of this variant (for build_graph)."""
        es = cls.encoder_strides()
        specs = [ConvSpec("conv1", 1, 1, conv1_kernel_size, cls.DILATIONS[0]),
                 ConvSpec("block1", es[0], es[0], 3, 1)]
        for i in (1, 2, 3):
            specs.append(ConvSpec(f"conv{i+1}", es[i - 1], es[i],
                                  cls.KERNEL_SIZES[i], cls.DILATIONS[i]))
            specs.append(ConvSpec(f"block{i+1}", es[i], es[i], 3, 1))
        for i in (3, 2, 1):
            specs.append(ConvSpec(f"conv{i+1}_tr", es[i], es[i - 1],
                                  cls.KERNEL_SIZES[i], cls.DILATIONS[i]))
            specs.append(ConvSpec(f"block{i+1}_tr", es[i - 1], es[i - 1],
                                  3, 1))
        return tuple(specs)

    def __init__(self, in_channels: int = 3, out_channels: int = 32,
                 bn_momentum: float = 0.1,
                 normalize_feature: Optional[bool] = None,
                 conv1_kernel_size: Optional[int] = None, D: int = 3):
        super().__init__()
        if self.KERNEL_SIZES[0] is not None:
            raise NotImplementedError("conv1_extra variants are not ported")
        CH, TR = self.CHANNELS, self.TR_CHANNELS
        es = self.encoder_strides()
        self.normalize_feature = normalize_feature
        m = bn_momentum

        self.conv1 = SparseConv(in_channels, CH[1],
                                ConvSpec("conv1", 1, 1, conv1_kernel_size,
                                         self.DILATIONS[0]),
                                occupancy=True)
        self.norm1 = get_norm(self.NORM_TYPE, CH[1], m)
        self.block1 = BasicBlock(CH[1], CH[1], es[0], self.BLOCK_NORM_TYPE,
                                 bn_momentum=m)
        for i in (1, 2, 3):
            self.add_module(f"conv{i+1}", SparseConv(
                CH[i], CH[i + 1],
                ConvSpec(f"conv{i+1}", es[i - 1], es[i],
                         self.KERNEL_SIZES[i], self.DILATIONS[i])))
            self.add_module(f"norm{i+1}",
                            get_norm(self.NORM_TYPE, CH[i + 1], m))
            self.add_module(f"block{i+1}", BasicBlock(
                CH[i + 1], CH[i + 1], es[i], self.BLOCK_NORM_TYPE,
                bn_momentum=m))
        in_ch = CH[4]
        for i in (3, 2, 1):
            self.add_module(f"conv{i+1}_tr", SparseConv(
                in_ch, TR[i + 1],
                ConvSpec(f"conv{i+1}_tr", es[i], es[i - 1],
                         self.KERNEL_SIZES[i], self.DILATIONS[i])))
            self.add_module(f"norm{i+1}_tr",
                            get_norm(self.NORM_TYPE, TR[i + 1], m))
            self.add_module(f"block{i+1}_tr", BasicBlock(
                TR[i + 1], TR[i + 1], es[i - 1], self.BLOCK_NORM_TYPE,
                bn_momentum=m))
            in_ch = TR[i + 1] + CH[i]  # after the skip concat
        self.conv1_tr = SparseConv(in_ch, TR[1],
                                   ConvSpec("conv1_tr", 1, 1, 1, 1))
        self.final = SparseConv(TR[1], out_channels,
                                ConvSpec("final", 1, 1, 1, 1),
                                use_bias=True)

    def forward(self, graph: SparseGraph, feats: torch.Tensor,
                conv1_jitter=None, generator=None,
                jitter_draws=None) -> torch.Tensor:
        """Features of every level-1 row, [N_1, out_channels]. ``feats``
        is the all-ones occupancy input of conv1. ``conv1_jitter``:
        optional (sigma, p, row_sel, exact), the train-time input jitter
        owned by conv1 (models.common.SparseConv), drawn from
        ``generator`` or handed in as ``jitter_draws``. Train mode is
        nn.Module.train()."""
        es = self.encoder_strides()
        mask = {s: graph.levels[s].mask for s in set(es)}

        out_s1 = self.conv1(feats, graph, conv1_jitter, generator,
                            jitter_draws)
        out_s1 = self.norm1(out_s1, mask[1])
        out_s1 = self.block1(out_s1, graph)
        out = torch.relu(out_s1)

        skips = {}
        for i in (1, 2, 3):
            y = getattr(self, f"conv{i+1}")(out, graph)
            y = getattr(self, f"norm{i+1}")(y, mask[es[i]])
            y = getattr(self, f"block{i+1}")(y, graph)
            skips[i] = y  # pre-relu, as in the reference
            out = torch.relu(y)

        for i in (3, 2, 1):
            y = getattr(self, f"conv{i+1}_tr")(out, graph)
            y = getattr(self, f"norm{i+1}_tr")(y, mask[es[i - 1]])
            y = torch.relu(getattr(self, f"block{i+1}_tr")(y, graph))
            out = torch.cat([y, skips[i - 1] if i > 1 else out_s1], dim=1)

        out = torch.relu(self.conv1_tr(out, graph))
        out = self.final(out, graph)
        if self.normalize_feature:
            out = l2_normalize(out)
        return out


class ResUNetFatBN(ResUNet2):
    """GCL's default backbone."""

    NORM_TYPE = "BN"
    CHANNELS = [None, 32, 64, 128, 256]
    TR_CHANNELS = [None, 128, 128, 128, 256]


class ResUNetFatBNEXP(ResUNet2):
    """The FCGF baseline's backbone: stride-3 encoder levels (1, 3, 9, 27)
    with k = 5 strided and transposed convs."""

    NORM_TYPE = "BN"
    CHANNELS = [None, 32, 64, 128, 256]
    TR_CHANNELS = [None, 128, 128, 128, 256]
    STRIDES = [1, 3, 3, 3]
    KERNEL_SIZES = [None, 5, 5, 5]
    DILATIONS = [1, 1, 1, 1]
