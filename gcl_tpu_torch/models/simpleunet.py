"""Non-residual sparse U-Nets at three depths (port of
gcl_tpu/models/simpleunet.py: _SimpleUNetBase and its 20 classes, with
their channel lists letter for letter). Registered alternatives; the
shipped configs do not use them.

conv1 (k=conv1_kernel_size, occupancy) -> DEPTH x (stride-2 k=3 conv +
norm + relu) encoder -> DEPTH x (k=3 transpose conv + norm + relu + skip
concat) decoder -> k=3 conv1_tr + norm + relu -> 1x1 final (bias) ->
optional L2 normalization.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..core.kernel_maps import ConvSpec
from ..core.sparse_ops import l2_normalize
from ..core.types import SparseGraph
from .common import SparseConv, get_norm


class _SimpleUNetBase(nn.Module):
    """Shared machinery: ``DEPTH`` stride-2 encoder convs, the mirrored
    transpose-conv decoder with skip concats, a k=3 conv1_tr + norm +
    relu, a 1x1 final with bias."""

    NORM_TYPE = None
    CHANNELS = [None, 32, 64, 128]
    TR_CHANNELS = [None, 32, 32, 64]
    DEPTH = 2  # number of stride-2 downsamples

    @classmethod
    def encoder_strides(cls) -> Tuple[int, ...]:
        return tuple(2 ** i for i in range(cls.DEPTH + 1))  # 1, 2, 4, ...

    @classmethod
    def conv_specs(cls, conv1_kernel_size: int) -> Tuple[ConvSpec, ...]:
        es = cls.encoder_strides()
        specs = [ConvSpec("conv1", 1, 1, conv1_kernel_size, 1)]
        for i in range(1, cls.DEPTH + 1):
            specs.append(ConvSpec(f"conv{i+1}", es[i - 1], es[i], 3, 1))
            specs.append(ConvSpec(f"conv{i+1}_tr", es[i], es[i - 1], 3, 1))
        specs.append(ConvSpec("conv1_tr", 1, 1, 3, 1))
        return tuple(specs)

    def __init__(self, in_channels: int = 3, out_channels: int = 32,
                 bn_momentum: float = 0.1,
                 normalize_feature: Optional[bool] = None,
                 conv1_kernel_size: Optional[int] = None, D: int = 3,
                 num_items: int = 64):
        super().__init__()
        CH, TR, depth = self.CHANNELS, self.TR_CHANNELS, self.DEPTH
        es = self.encoder_strides()
        self.normalize_feature = normalize_feature

        def norm(ch):
            return get_norm(self.NORM_TYPE, ch, bn_momentum, num_items)

        self.conv1 = SparseConv(in_channels, CH[1],
                                ConvSpec("conv1", 1, 1, conv1_kernel_size,
                                         1), occupancy=True)
        self.norm1 = norm(CH[1])
        for i in range(1, depth + 1):
            self.add_module(f"conv{i+1}", SparseConv(
                CH[i], CH[i + 1], ConvSpec(f"conv{i+1}", es[i - 1], es[i],
                                           3, 1)))
            self.add_module(f"norm{i+1}", norm(CH[i + 1]))
        in_ch = CH[depth + 1]
        for i in range(depth, 0, -1):
            self.add_module(f"conv{i+1}_tr", SparseConv(
                in_ch, TR[i + 1], ConvSpec(f"conv{i+1}_tr", es[i],
                                           es[i - 1], 3, 1)))
            self.add_module(f"norm{i+1}_tr", norm(TR[i + 1]))
            in_ch = TR[i + 1] + CH[i]  # after the skip concat
        self.conv1_tr = SparseConv(in_ch, TR[1],
                                   ConvSpec("conv1_tr", 1, 1, 3, 1))
        self.norm1_tr = norm(TR[1])
        self.final = SparseConv(TR[1], out_channels,
                                ConvSpec("final", 1, 1, 1, 1),
                                use_bias=True)

    def forward(self, graph: SparseGraph, feats: torch.Tensor,
                conv1_jitter=None, generator=None,
                jitter_draws=None) -> torch.Tensor:
        """As ResUNet2.forward: features of every level-1 row."""
        es = self.encoder_strides()
        mb = {s: (graph.levels[s].mask, graph.levels[s].coords[:, 0])
              for s in es}

        skips = {}
        out = self.conv1(feats, graph, conv1_jitter, generator, jitter_draws)
        out = self.norm1(out, *mb[1])
        skips[0] = out
        out = torch.relu(out)
        for i in range(1, self.DEPTH + 1):
            y = getattr(self, f"conv{i+1}")(out, graph)
            y = getattr(self, f"norm{i+1}")(y, *mb[es[i]])
            skips[i] = y
            out = torch.relu(y)

        for i in range(self.DEPTH, 0, -1):
            y = getattr(self, f"conv{i+1}_tr")(out, graph)
            y = torch.relu(getattr(self, f"norm{i+1}_tr")(y, *mb[es[i - 1]]))
            out = torch.cat([y, skips[i - 1]], dim=1)

        out = torch.relu(self.norm1_tr(self.conv1_tr(out, graph), *mb[1]))
        out = self.final(out, graph)
        if self.normalize_feature:
            out = l2_normalize(out)
        return out


class SimpleNet(_SimpleUNetBase):
    pass


class SimpleNetIN(SimpleNet):
    NORM_TYPE = "IN"


class SimpleNetBN(SimpleNet):
    NORM_TYPE = "BN"


class SimpleNetBNE(SimpleNetBN):
    CHANNELS = [None, 16, 32, 32]
    TR_CHANNELS = [None, 16, 16, 32]


class SimpleNetINE(SimpleNetBNE):
    NORM_TYPE = "IN"


class SimpleNet2(_SimpleUNetBase):
    CHANNELS = [None, 32, 64, 128, 256]
    TR_CHANNELS = [None, 32, 32, 64, 64]
    DEPTH = 3


class SimpleNetIN2(SimpleNet2):
    NORM_TYPE = "IN"


class SimpleNetBN2(SimpleNet2):
    NORM_TYPE = "BN"


class SimpleNetBN2B(SimpleNet2):
    NORM_TYPE = "BN"
    CHANNELS = [None, 32, 64, 128, 256]
    TR_CHANNELS = [None, 64, 64, 64, 64]


class SimpleNetBN2C(SimpleNet2):
    NORM_TYPE = "BN"
    CHANNELS = [None, 32, 64, 128, 256]
    TR_CHANNELS = [None, 32, 64, 64, 128]


class SimpleNetBN2D(SimpleNet2):
    NORM_TYPE = "BN"
    CHANNELS = [None, 32, 64, 128, 256]
    TR_CHANNELS = [None, 32, 64, 64, 128]


class SimpleNetBN2E(SimpleNet2):
    NORM_TYPE = "BN"
    CHANNELS = [None, 16, 32, 64, 128]
    TR_CHANNELS = [None, 16, 32, 32, 64]


class SimpleNetIN2E(SimpleNetBN2E):
    NORM_TYPE = "IN"


class SimpleNet3(_SimpleUNetBase):
    CHANNELS = [None, 32, 64, 128, 256, 512]
    TR_CHANNELS = [None, 32, 32, 64, 64, 128]
    DEPTH = 4


class SimpleNetIN3(SimpleNet3):
    NORM_TYPE = "IN"


class SimpleNetBN3(SimpleNet3):
    NORM_TYPE = "BN"


class SimpleNetBN3B(SimpleNet3):
    NORM_TYPE = "BN"
    CHANNELS = [None, 32, 64, 128, 256, 512]
    TR_CHANNELS = [None, 32, 64, 64, 64, 128]


class SimpleNetBN3C(SimpleNet3):
    NORM_TYPE = "BN"
    CHANNELS = [None, 32, 64, 128, 256, 512]
    TR_CHANNELS = [None, 32, 64, 64, 128, 128]


class SimpleNetBN3D(SimpleNet3):
    NORM_TYPE = "BN"
    CHANNELS = [None, 32, 64, 128, 256, 512]
    TR_CHANNELS = [None, 32, 64, 64, 128, 256]


class SimpleNetBN3E(SimpleNet3):
    NORM_TYPE = "BN"
    CHANNELS = [None, 16, 32, 64, 128, 256]
    TR_CHANNELS = [None, 16, 32, 32, 64, 128]
