"""Sparse residual U-Net family (port of gcl_tpu/models/resunet.py: ResUNet2
and every variant gcl_tpu registers, with its channel lists letter for
letter).

conv1 (k=conv1_kernel_size, occupancy) [+ the dilated conv1_extra down to
stride 5 when KERNEL_SIZES[0] is set] -> block1 -> 3x (strided conv +
residual block) encoder -> 3x (transpose conv + skip concat + residual
block) decoder [+ conv1_tr_extra back to stride 1] -> 1x1 conv1_tr ->
relu -> 1x1 final (bias) -> optional L2 normalization. Geometry comes
precomputed in a SparseGraph built for ``conv_specs()``. NORM_TYPE is the
norm after each conv, BLOCK_NORM_TYPE the one inside the residual blocks
(instance norm in the IN2 variants).
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

_EXTRA_STRIDE = 5  # conv1_extra's stride and dilation
_EXTRA_TR_DILATION = 4  # conv1_tr_extra's dilation


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
        """Tensor stride after conv1[+extra], conv2, conv3, conv4."""
        s = _EXTRA_STRIDE if cls.KERNEL_SIZES[0] is not None else 1
        out = [s]
        for i in (1, 2, 3):
            s *= cls.STRIDES[i]
            out.append(s)
        return tuple(out)

    @classmethod
    def conv_specs(cls, conv1_kernel_size: int) -> Tuple[ConvSpec, ...]:
        """Every distinct conv geometry of this variant (for build_graph)."""
        es = cls.encoder_strides()
        specs = [ConvSpec("conv1", 1, 1, conv1_kernel_size, cls.DILATIONS[0])]
        if cls.KERNEL_SIZES[0] is not None:
            specs.append(cls._extra_spec())
        specs.append(ConvSpec("block1", es[0], es[0], 3, 1))
        for i in (1, 2, 3):
            specs.append(ConvSpec(f"conv{i+1}", es[i - 1], es[i],
                                  cls.KERNEL_SIZES[i], cls.DILATIONS[i]))
            specs.append(ConvSpec(f"block{i+1}", es[i], es[i], 3, 1))
        for i in (3, 2, 1):
            specs.append(ConvSpec(f"conv{i+1}_tr", es[i], es[i - 1],
                                  cls.KERNEL_SIZES[i], cls.DILATIONS[i]))
            specs.append(ConvSpec(f"block{i+1}_tr", es[i - 1], es[i - 1],
                                  3, 1))
        if cls.KERNEL_SIZES[0] is not None:
            specs.append(cls._extra_tr_spec())
        return tuple(specs)

    @classmethod
    def _extra_spec(cls) -> ConvSpec:
        return ConvSpec("conv1_extra", 1, _EXTRA_STRIDE, cls.KERNEL_SIZES[0],
                        _EXTRA_STRIDE)

    @classmethod
    def _extra_tr_spec(cls) -> ConvSpec:
        return ConvSpec("conv1_tr_extra", _EXTRA_STRIDE, 1,
                        cls.KERNEL_SIZES[0], _EXTRA_TR_DILATION)

    def __init__(self, in_channels: int = 3, out_channels: int = 32,
                 bn_momentum: float = 0.1,
                 normalize_feature: Optional[bool] = None,
                 conv1_kernel_size: Optional[int] = None, D: int = 3,
                 num_items: int = 64):
        """``num_items``: the most clouds a batch holds, for the instance
        norms (gcl_tpu's default, 64)."""
        super().__init__()
        CH, TR = self.CHANNELS, self.TR_CHANNELS
        es = self.encoder_strides()
        self.normalize_feature = normalize_feature
        extra = self.KERNEL_SIZES[0] is not None

        def norm(ch):
            return get_norm(self.NORM_TYPE, ch, bn_momentum, num_items)

        def block(ch, stride):
            return BasicBlock(ch, ch, stride, self.BLOCK_NORM_TYPE,
                              bn_momentum=bn_momentum, num_items=num_items)

        self.conv1 = SparseConv(in_channels, CH[1],
                                ConvSpec("conv1", 1, 1, conv1_kernel_size,
                                         self.DILATIONS[0]),
                                occupancy=True)
        self.norm1 = norm(CH[1])
        if extra:
            self.conv1_extra = SparseConv(CH[1], CH[1], self._extra_spec())
            self.norm1_extra = norm(CH[1])
        self.block1 = block(CH[1], es[0])
        for i in (1, 2, 3):
            self.add_module(f"conv{i+1}", SparseConv(
                CH[i], CH[i + 1],
                ConvSpec(f"conv{i+1}", es[i - 1], es[i],
                         self.KERNEL_SIZES[i], self.DILATIONS[i])))
            self.add_module(f"norm{i+1}", norm(CH[i + 1]))
            self.add_module(f"block{i+1}", block(CH[i + 1], es[i]))
        in_ch = CH[4]
        for i in (3, 2, 1):
            self.add_module(f"conv{i+1}_tr", SparseConv(
                in_ch, TR[i + 1],
                ConvSpec(f"conv{i+1}_tr", es[i], es[i - 1],
                         self.KERNEL_SIZES[i], self.DILATIONS[i])))
            self.add_module(f"norm{i+1}_tr", norm(TR[i + 1]))
            self.add_module(f"block{i+1}_tr", block(TR[i + 1], es[i - 1]))
            in_ch = TR[i + 1] + CH[i]  # after the skip concat
        if extra:
            self.conv1_tr_extra = SparseConv(in_ch, TR[2],
                                             self._extra_tr_spec())
            self.norm1_tr_extra = norm(TR[1])
            in_ch = TR[2]
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
        mb = {s: (graph.levels[s].mask, graph.levels[s].coords[:, 0])
              for s in set((1,) + es)}

        out_s1 = self.conv1(feats, graph, conv1_jitter, generator,
                            jitter_draws)
        out_s1 = self.norm1(out_s1, *mb[1])
        if self.KERNEL_SIZES[0] is not None:
            out_s1 = self.conv1_extra(torch.relu(out_s1), graph)
            out_s1 = self.norm1_extra(out_s1, *mb[es[0]])
        out_s1 = self.block1(out_s1, graph)
        out = torch.relu(out_s1)

        skips = {}
        for i in (1, 2, 3):
            y = getattr(self, f"conv{i+1}")(out, graph)
            y = getattr(self, f"norm{i+1}")(y, *mb[es[i]])
            y = getattr(self, f"block{i+1}")(y, graph)
            skips[i] = y  # pre-relu, as in the reference
            out = torch.relu(y)

        for i in (3, 2, 1):
            y = getattr(self, f"conv{i+1}_tr")(out, graph)
            y = getattr(self, f"norm{i+1}_tr")(y, *mb[es[i - 1]])
            y = torch.relu(getattr(self, f"block{i+1}_tr")(y, graph))
            out = torch.cat([y, skips[i - 1] if i > 1 else out_s1], dim=1)

        if self.KERNEL_SIZES[0] is not None:
            out = self.norm1_tr_extra(self.conv1_tr_extra(out, graph),
                                      *mb[1])
            out = torch.relu(out)
        out = torch.relu(self.conv1_tr(out, graph))
        out = self.final(out, graph)
        if self.normalize_feature:
            out = l2_normalize(out)
        return out


class ResUNetBN2(ResUNet2):
    NORM_TYPE = "BN"


class ResUNetBN2B(ResUNet2):
    NORM_TYPE = "BN"
    CHANNELS = [None, 32, 64, 128, 256]
    TR_CHANNELS = [None, 64, 64, 64, 64]


class ResUNetBN2C(ResUNet2):
    NORM_TYPE = "BN"
    CHANNELS = [None, 32, 64, 128, 256]
    TR_CHANNELS = [None, 64, 64, 64, 128]


class ResUNetBN2D(ResUNet2):
    NORM_TYPE = "BN"
    CHANNELS = [None, 32, 64, 128, 256]
    TR_CHANNELS = [None, 64, 64, 128, 128]


class ResUNetBN2E(ResUNet2):
    NORM_TYPE = "BN"
    CHANNELS = [None, 128, 128, 128, 256]
    TR_CHANNELS = [None, 64, 128, 128, 128]


class ResUNetFatBN(ResUNet2):
    """GCL's default backbone."""

    NORM_TYPE = "BN"
    CHANNELS = [None, 32, 64, 128, 256]
    TR_CHANNELS = [None, 128, 128, 128, 256]


class ResUNetIN2(ResUNet2):
    NORM_TYPE = "BN"
    BLOCK_NORM_TYPE = "IN"


class ResUNetIN2B(ResUNetBN2B):
    NORM_TYPE = "BN"
    BLOCK_NORM_TYPE = "IN"


class ResUNetIN2C(ResUNetBN2C):
    NORM_TYPE = "BN"
    BLOCK_NORM_TYPE = "IN"


class ResUNetIN2D(ResUNetBN2D):
    NORM_TYPE = "BN"
    BLOCK_NORM_TYPE = "IN"


class ResUNetIN2E(ResUNetBN2E):
    NORM_TYPE = "BN"
    BLOCK_NORM_TYPE = "IN"


class ResUNetFatBNEXP(ResUNet2):
    """The FCGF baseline's backbone: stride-3 encoder levels (1, 3, 9, 27)
    with k = 5 strided and transposed convs."""

    NORM_TYPE = "BN"
    CHANNELS = [None, 32, 64, 128, 256]
    TR_CHANNELS = [None, 128, 128, 128, 256]
    STRIDES = [1, 3, 3, 3]
    KERNEL_SIZES = [None, 5, 5, 5]
    DILATIONS = [1, 1, 1, 1]


class ResUNetFatBNEXP_V2(ResUNet2):
    """An extra k = 5 pair: conv1_extra down to stride 5 at dilation 5 and
    conv1_tr_extra back at dilation 4, so the encoder levels are 5, 10,
    20 and 40."""

    NORM_TYPE = "BN"
    CHANNELS = [None, 32, 64, 128, 256]
    TR_CHANNELS = [None, 128, 128, 128, 256]
    STRIDES = [1, 2, 2, 2]
    KERNEL_SIZES = [5, 3, 3, 3]
    DILATIONS = [1, 1, 1, 1]
