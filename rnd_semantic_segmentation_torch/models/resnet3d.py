"""3D ResNet encoder (counterpart of the JAX package's models/resnet3d.py,
encoders/resnet3d.py in kenshohara's 3D-ResNets layout), on NCTHW tensors.

``Conv3d`` is ``nn.Conv3d`` (weights OIDHW, no bias unless asked) computing
in its input's type; ``BatchNorm3d`` is ``nn.BatchNorm3d`` (eps 1e-5,
momentum 0.1, the unbiased batch variance in the running statistics, as
the JAX ``BatchNorm3d`` keeps them); ``max_pool3d`` a 3x3x3 stride-2 pool
with padding 1.  Shortcut type B (a conv on the downsample branch); the
forward returns the four stage taps, as the segmentation zoo uses the
encoder (no classifier).  Keys: ``conv1``, ``bn1``, ``layer2.0.conv1``,
``layer2.0.downsample.0`` and ``.1``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import cast_param, relu


class Conv3d(nn.Conv3d):
    def __init__(self, cin: int, cout: int, kernel_size=(3, 3, 3), stride=(1, 1, 1),
                 padding=(1, 1, 1), bias: bool = False):
        super().__init__(cin, cout, kernel_size, stride, padding, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, cast_param(self.weight, x), cast_param(self.bias, x))


def BatchNorm3d(num_features: int) -> nn.BatchNorm3d:
    return nn.BatchNorm3d(num_features, eps=1e-5, momentum=0.1)


def max_pool3d(x: torch.Tensor, kernel: int = 3, stride: int = 2,
               padding: int = 1) -> torch.Tensor:
    return F.max_pool3d(x, kernel, stride, padding)


class BasicBlock3d(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 has_downsample: bool = False):
        super().__init__()
        s = (stride,) * 3
        self.conv1, self.bn1 = Conv3d(inplanes, planes, stride=s), BatchNorm3d(planes)
        self.conv2, self.bn2 = Conv3d(planes, planes), BatchNorm3d(planes)
        self.downsample = (nn.Sequential(Conv3d(inplanes, planes, (1, 1, 1), s, (0, 0, 0)),
                                         BatchNorm3d(planes)) if has_downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return relu(out + identity)


class ResNet3D(nn.Module):
    """An r3d-18-style backbone on [N, C, T, H, W]; returns the layer1 to
    layer4 taps."""

    damp_norms = True  # models.build.randomize_weights_ damps its norms

    def __init__(self, layers: Tuple[int, int, int, int] = (2, 2, 2, 2),
                 conv1_t_size: int = 7, conv1_t_stride: int = 1, in_channels: int = 3):
        super().__init__()
        self.conv1 = Conv3d(in_channels, 64, (conv1_t_size, 7, 7), (conv1_t_stride, 2, 2),
                            (conv1_t_size // 2, 3, 3))
        self.bn1 = BatchNorm3d(64)
        inplanes = 64
        for idx, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers)):
            stride = 1 if idx == 0 else 2
            layer = []
            for b in range(blocks):
                s = stride if b == 0 else 1
                layer.append(BasicBlock3d(inplanes, planes, s,
                                          b == 0 and (s != 1 or inplanes != planes)))
                inplanes = planes
            self.add_module(f"layer{idx + 1}", nn.Sequential(*layer))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = max_pool3d(relu(self.bn1(self.conv1(x))))
        taps = []
        for idx in range(1, 5):
            x = getattr(self, f"layer{idx}")(x)
            taps.append(x)
        return tuple(taps)
