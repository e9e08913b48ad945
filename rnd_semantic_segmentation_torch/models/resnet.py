"""Dilated ResNet backbones (counterpart of the JAX package's models/resnet.py),
on NCHW tensors.

The torchvision graph: ResNet18/34/50/101/152 and the two ResNeXt rows, an
injectable norm (``"bn"`` or ``"frozen"``, see ``layers.make_norm``) and
``replace_stride_with_dilation``.  Three details decide parity with the
reference:
  * the stride of a Bottleneck sits on ``conv2``, the 3x3, as in torchvision;
  * the first block of a dilated stage keeps the previous stage's dilation
    (layer3 block 0 has dilation 1, layer4 block 0 dilation 2 at output
    stride 8); only the later blocks take the doubled value;
  * the downsample branch exists only on block 0, when the stride is not 1
    or the channel count changes, as ``downsample.0`` (conv) and
    ``downsample.1`` (norm).
Each residual unit is a ``RematBlock`` (``MODEL.REMAT_BLOCKS``, models/remat.py).
Attribute names give the reference's ``state_dict`` keys
(``layer3.0.conv2.weight``, ``layer1.0.downsample.1.running_mean``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from ..ops import max_pool
from .layers import Conv2d, make_norm, relu
from .remat import RematBlock


class BasicBlock(RematBlock):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
                 has_downsample: bool = False, norm=None, groups: int = 1,
                 base_width: int = 64):
        super().__init__()
        del dilation, groups, base_width  # torchvision's BasicBlock is never dilated
        norm = norm or make_norm("bn")
        self.conv1 = Conv2d(inplanes, planes, 3, stride, padding=1, bias=False)
        self.bn1 = norm(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, padding=1, bias=False)
        self.bn2 = norm(planes)
        self.downsample = (nn.Sequential(Conv2d(inplanes, planes, 1, stride, bias=False),
                                         norm(planes)) if has_downsample else None)

    def body(self, x: torch.Tensor) -> torch.Tensor:
        out = relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return relu(out + identity)


class Bottleneck(RematBlock):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
                 has_downsample: bool = False, norm=None, groups: int = 1,
                 base_width: int = 64):
        super().__init__()
        norm = norm or make_norm("bn")
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = Conv2d(inplanes, width, 1, bias=False)
        self.bn1 = norm(width)
        self.conv2 = Conv2d(width, width, 3, stride, padding=dilation, dilation=dilation,
                            groups=groups, bias=False)
        self.bn2 = norm(width)
        self.conv3 = Conv2d(width, planes * 4, 1, bias=False)
        self.bn3 = norm(planes * 4)
        self.downsample = (nn.Sequential(Conv2d(inplanes, planes * 4, 1, stride, bias=False),
                                         norm(planes * 4)) if has_downsample else None)

    def body(self, x: torch.Tensor) -> torch.Tensor:
        out = relu(self.bn1(self.conv1(x)))
        out = relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return relu(out + identity)


_ARCHS = {
    # name: (block, layers, groups, width_per_group)
    "resnet18": (BasicBlock, (2, 2, 2, 2), 1, 64),
    "resnet34": (BasicBlock, (3, 4, 6, 3), 1, 64),
    "resnet50": (Bottleneck, (3, 4, 6, 3), 1, 64),
    "resnet101": (Bottleneck, (3, 4, 23, 3), 1, 64),
    "resnet152": (Bottleneck, (3, 8, 36, 3), 1, 64),
    "resnext50_32x4d": (Bottleneck, (3, 4, 6, 3), 32, 4),
    "resnext101_32x8d": (Bottleneck, (3, 4, 23, 3), 32, 8),
}


class ResNet(nn.Module):
    """The torchvision ResNet without its pooling and classifier, returning
    the taps named in ``return_layers`` (the reference's
    IntermediateLayerGetter) as ``{name: tensor}``."""

    damp_norms = True  # models.build.randomize_weights_ damps its norms

    def __init__(self, arch: str = "resnet101",
                 replace_stride_with_dilation: Tuple[bool, bool, bool] = (False, False, False),
                 norm_kind: str = "bn", return_layers: Tuple[str, ...] = ("layer4",)):
        super().__init__()
        if arch not in _ARCHS:
            raise NotImplementedError(f"ResNet arch {arch!r}: one of {sorted(_ARCHS)}")
        block, layer_sizes, groups, base_width = _ARCHS[arch]
        norm = make_norm(norm_kind)
        self.return_layers = tuple(return_layers)
        self.conv1 = Conv2d(3, 64, 7, 2, padding=3, bias=False)
        self.bn1 = norm(64)
        inplanes, dilation = 64, 1
        for idx, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layer_sizes)):
            stride = 1 if idx == 0 else 2
            prev_dilation = dilation  # the first block keeps the previous dilation
            if idx > 0 and replace_stride_with_dilation[idx - 1]:
                dilation *= stride
                stride = 1
            layer = []
            for b in range(blocks):
                s = stride if b == 0 else 1
                has_ds = b == 0 and (s != 1 or inplanes != planes * block.expansion)
                layer.append(block(inplanes, planes, stride=s,
                                   dilation=prev_dilation if b == 0 else dilation,
                                   has_downsample=has_ds, norm=norm, groups=groups,
                                   base_width=base_width))
                inplanes = planes * block.expansion
            self.add_module(f"layer{idx + 1}", nn.Sequential(*layer))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = relu(self.bn1(self.conv1(x)))
        x = max_pool(x, 3, 2, padding=1)
        taps = {}
        for name in ("layer1", "layer2", "layer3", "layer4"):
            x = getattr(self, name)(x)
            if name in self.return_layers:
                taps[name] = x
        return taps


def output_channels(arch: str) -> int:
    block, _, _, _ = _ARCHS[arch]
    return 512 * block.expansion
