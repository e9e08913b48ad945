"""The research segmentation nets on the deep-stem dilated ResNet
(counterpart of the JAX package's models/seg_nets.py), on NCHW tensors.

GALDNet, CCNet (Seg_Model), PSPNet and DualSeg share one backbone: a stem of
three 3x3 convolutions (64 stride 2, 64, 128), a 3x3 stride-2 max pool, and
ResNet stages whose layer3 keeps stride 1 at dilation 2 and layer4 at
dilation 4 with multi-grid (1, 2, 4) on its blocks' 3x3 convs: output stride
8.  The pool floors its output size, as the JAX ``max_pool`` does, where the
reference asks for ceil mode: the two agree where the stem conv's output
side is odd (769 gives 385 and an OS8 map of 97 either way) and differ by one
where it is even (768 gives 384, then 96 here and 97 there).  Each net adds
a head on layer4 and a layer3 auxiliary classifier (``dsn``) and returns
``(main, dsn)`` at the OS8 resolution; upsampling to the label size is the
caller's.

  * GALDNetFull — GALDHead(2048 -> 512);
  * CCNetSegModel — RCCAModule with ``recurrence`` criss-cross passes; the
    attention takes Cq = 64 and C = 512, which reaches kernels #1 and #2 on
    CUDA tensors;
  * PSPNetFull — PSPModule then a 1x1 classifier;
  * PSPHead — ICNet's encoder: the backbone at multi-grid (1, 1, 1) and a
    PSPModule, returning the 512-channel features;
  * DualSegNet — DualGCNHead.

No MODEL.NAME builds them, in either package: they are built directly.  The
nets keep the reference's keys (ccnet.py, GALDNet.py): the backbone's
attributes sit on the net itself (``conv1`` to ``bn3``, ``layer3.0.conv2``,
``layer1.0.downsample.1``), then ``head.*`` and ``dsn.0``, ``dsn.1``,
``dsn.3``.  ``ckpt/torch_import.py`` (``RESEARCH_RULES``) maps the JAX scopes
(``backbone/stem_conv0``, ``backbone/bn1`` for the third stem norm,
``dsn/cls``) to them.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ..ops import max_pool
from .contextagg import GALDHead, PSPModule
from .layers import BatchNorm, Conv2d, relu
from .zoo import DualGCNHead, RCCAModule


class _CCBottleneck(nn.Module):
    """Bottleneck whose 3x3 conv takes the stride and dilation * multi_grid."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
                 multi_grid: int = 1, has_downsample: bool = False):
        super().__init__()
        d = dilation * multi_grid
        self.conv1, self.bn1 = Conv2d(inplanes, planes, 1, bias=False), BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride, padding=d, dilation=d, bias=False)
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm(planes * 4)
        self.downsample = (nn.Sequential(Conv2d(inplanes, planes * 4, 1, stride, bias=False),
                                         BatchNorm(planes * 4)) if has_downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = relu(self.bn1(self.conv1(x)))
        out = relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return relu(out + identity)


class DilatedSegBackbone(nn.Module):
    """Deep-stem OS8 ResNet; ``forward`` returns the (layer3, layer4) taps."""

    damp_norms = True  # models.build.randomize_weights_ damps its norms

    def __init__(self, layers: Tuple[int, int, int, int] = (3, 4, 23, 3),
                 layer4_grids: Sequence[int] = (1, 2, 4)):
        super().__init__()
        self.conv1, self.bn1 = Conv2d(3, 64, 3, 2, padding=1, bias=False), BatchNorm(64)
        self.conv2, self.bn2 = Conv2d(64, 64, 3, 1, padding=1, bias=False), BatchNorm(64)
        self.conv3, self.bn3 = Conv2d(64, 128, 3, 1, padding=1, bias=False), BatchNorm(128)
        inplanes = 128
        plan = ((64, layers[0], 1, 1, None), (128, layers[1], 2, 1, None),
                (256, layers[2], 1, 2, None), (512, layers[3], 1, 4, tuple(layer4_grids)))
        for idx, (planes, blocks, stride, dilation, grids) in enumerate(plan):
            layer = []
            for b in range(blocks):
                layer.append(_CCBottleneck(
                    inplanes, planes, stride=stride if b == 0 else 1, dilation=dilation,
                    multi_grid=grids[b % len(grids)] if grids else 1,
                    has_downsample=b == 0 and (stride != 1 or inplanes != planes * 4)))
                inplanes = planes * 4
            self.add_module(f"layer{idx + 1}", nn.Sequential(*layer))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2),
                         (self.conv3, self.bn3)):
            x = relu(bn(conv(x)))
        x = max_pool(x, 3, 2, padding=1)
        x = self.layer2(self.layer1(x))
        l3 = self.layer3(x)
        return l3, self.layer4(l3)


class _DSN(nn.Sequential):
    """The layer3 auxiliary classifier: 3x3 conv+BN+ReLU, 1x1 classifier."""

    def __init__(self, num_classes: int):
        super().__init__(Conv2d(1024, 512, 3, padding=1), BatchNorm(512), nn.ReLU(),
                         Conv2d(512, num_classes, 1))


class GALDNetFull(DilatedSegBackbone):
    def __init__(self, num_classes: int = 19, layers=(3, 4, 23, 3)):
        super().__init__(layers)
        self.head = GALDHead(2048, 512, num_classes)
        self.dsn = _DSN(num_classes)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        l3, l4 = super().forward(x)
        return self.head(l4), self.dsn(l3)


class CCNetSegModel(DilatedSegBackbone):
    def __init__(self, num_classes: int = 19, recurrence: int = 2, layers=(3, 4, 23, 3)):
        super().__init__(layers)
        self.head = RCCAModule(2048, 512, num_classes, recurrence=recurrence)
        self.dsn = _DSN(num_classes)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        l3, l4 = super().forward(x)
        return self.head(l4), self.dsn(l3)


class PSPNetFull(DilatedSegBackbone):
    def __init__(self, num_classes: int = 19, layers=(3, 4, 23, 3)):
        super().__init__(layers)
        self.head = nn.Sequential(PSPModule(2048, 512), Conv2d(512, num_classes, 1))
        self.dsn = _DSN(num_classes)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        l3, l4 = super().forward(x)
        return self.head(l4), self.dsn(l3)


class PSPHead(DilatedSegBackbone):
    def __init__(self, layers=(3, 4, 6, 3)):
        super().__init__(layers, layer4_grids=(1, 1, 1))
        self.head = PSPModule(2048, 512)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(super().forward(x)[1])


class DualSegNet(DilatedSegBackbone):
    def __init__(self, num_classes: int = 19, layers=(3, 4, 23, 3)):
        super().__init__(layers)
        self.head = DualGCNHead(2048, 512, num_classes)
        self.dsn = _DSN(num_classes)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        l3, l4 = super().forward(x)
        return self.head(l4), self.dsn(l3)
