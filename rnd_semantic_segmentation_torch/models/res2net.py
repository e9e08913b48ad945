"""Res2Net-v1b backbone (counterpart of the JAX package's models/res2net.py),
on NCHW tensors.

``res2net50_v1b_26w_4s``: a deep stem (three 3x3 convolutions, the first of
stride 2, then ``bn1`` and a 3x3 max pool), and four stages of
``Bottle2neck`` blocks (3, 4, 6, 3).  A block splits the output of its 1x1
convolution into ``scale`` groups of ``width = floor(planes * 26 / 64)``
channels; each of the first ``scale - 1`` goes through its own 3x3
convolution, BN and ReLU, added to the previous group's result first in a
``normal`` block; the last passes unchanged (``normal``) or through a 3x3
average pool of the block's stride (``stage``, the first block of a stage).
The shortcut of a stage's first block is an average pool of the stride
(``ceil_mode=True``, padding not counted), a 1x1 convolution and BN.  Each
block is a ``RematBlock`` (``MODEL.REMAT_BLOCKS``, models/remat.py).

Attribute names give the reference's ``state_dict`` keys (``conv1.0``,
``conv1.1``, ``conv1.3``, ``conv1.4``, ``conv1.6``, ``bn1``,
``layer2.0.convs.1``, ``layer2.0.bns.1``, ``layer2.0.downsample.1``,
``layer2.0.downsample.2``), which ``PRANET_RULES`` of the JAX package's
ckpt/torch_import.py maps.  The JAX shortcut pool floors its output size,
the reference's (and this one) rounds up: the two agree on even sides, and
every side the JAX model runs is even (a multiple of 32 at the input).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch import nn

from ..ops import avg_pool, max_pool
from .layers import BatchNorm, Conv2d, relu
from .remat import RematBlock


class Bottle2neck(RematBlock):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 has_downsample: bool = False, base_width: int = 26, scale: int = 4,
                 stype: str = "normal"):
        super().__init__()
        width = int(math.floor(planes * (base_width / 64.0)))
        self.width, self.scale, self.stype, self.stride = width, scale, stype, stride
        self.nums = 1 if scale == 1 else scale - 1
        self.conv1 = Conv2d(inplanes, width * scale, 1, bias=False)
        self.bn1 = BatchNorm(width * scale)
        self.convs = nn.ModuleList(Conv2d(width, width, 3, stride, padding=1, bias=False)
                                   for _ in range(self.nums))
        self.bns = nn.ModuleList(BatchNorm(width) for _ in range(self.nums))
        self.conv3 = Conv2d(width * scale, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm(planes * 4)
        self.downsample = (nn.Sequential(
            nn.AvgPool2d(stride, stride, ceil_mode=True, count_include_pad=False),
            Conv2d(inplanes, planes * 4, 1, bias=False),
            BatchNorm(planes * 4)) if has_downsample else None)

    def body(self, x: torch.Tensor) -> torch.Tensor:
        out = relu(self.bn1(self.conv1(x)))
        spx = torch.split(out, self.width, dim=1)
        outs, sp = [], None
        for i in range(self.nums):
            sp = spx[i] if (i == 0 or self.stype == "stage") else sp + spx[i]
            sp = relu(self.bns[i](self.convs[i](sp)))
            outs.append(sp)
        if self.scale != 1 and self.stype == "normal":
            outs.append(spx[self.nums])
        elif self.scale != 1 and self.stype == "stage":
            outs.append(avg_pool(spx[self.nums], 3, self.stride, padding=1))
        out = self.bn3(self.conv3(torch.cat(outs, dim=1)))
        residual = x if self.downsample is None else self.downsample(x)
        return relu(out + residual)


class Res2Net(nn.Module):
    """res2net50_v1b_26w_4s without its pooling and classifier; returns the
    taps ``layer1``..``layer4`` (256, 512, 1024 and 2048 channels at strides
    4, 8, 16 and 32) as ``{name: tensor}``.

    ``gc_blocks=True`` is the Res2Net_GC variant: a GCNet ``ContextBlock2d``
    (models/contextagg.py) on the input of layers 2-4, ``layer2_gcb`` to
    ``layer4_gcb``, named after the JAX package's scopes."""

    damp_norms = True  # models.build.randomize_weights_ damps its norms

    def __init__(self, layers: Tuple[int, int, int, int] = (3, 4, 6, 3),
                 base_width: int = 26, scale: int = 4, gc_blocks: bool = False):
        super().__init__()
        self.conv1 = nn.Sequential(
            Conv2d(3, 32, 3, 2, padding=1, bias=False), BatchNorm(32), nn.ReLU(),
            Conv2d(32, 32, 3, 1, padding=1, bias=False), BatchNorm(32), nn.ReLU(),
            Conv2d(32, 64, 3, 1, padding=1, bias=False))
        self.bn1 = BatchNorm(64)
        inplanes = 64
        for idx, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers)):
            stride = 1 if idx == 0 else 2
            if gc_blocks and idx > 0:
                from .contextagg import ContextBlock2d  # contextagg builds on Res2Net

                self.add_module(f"layer{idx + 1}_gcb", ContextBlock2d(inplanes, inplanes))
            layer = []
            for b in range(blocks):
                layer.append(Bottle2neck(
                    inplanes, planes, stride=stride if b == 0 else 1,
                    has_downsample=b == 0 and (stride != 1 or inplanes != planes * 4),
                    base_width=base_width, scale=scale,
                    stype="stage" if b == 0 else "normal"))
                inplanes = planes * 4
            self.add_module(f"layer{idx + 1}", nn.Sequential(*layer))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = max_pool(relu(self.bn1(self.conv1(x))), 3, 2, padding=1)
        taps = {}
        for name in ("layer1", "layer2", "layer3", "layer4"):
            if hasattr(self, f"{name}_gcb"):
                x = getattr(self, f"{name}_gcb")(x)
            x = getattr(self, name)(x)
            taps[name] = x
        return taps
