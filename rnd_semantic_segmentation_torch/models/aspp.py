"""DeepLabV2 family (counterpart of the JAX package's models/aspp.py), on NCHW
tensors: the dilated ResNet and VGG16 feature extractors and the ASPP-V2 head.

  * ``ResNetFeatureExtractor``: ResNet with
    ``replace_stride_with_dilation=(False, True, True)``, output stride 8,
    tapped at ``layer4``; the norm is ``FrozenBatchNorm2d`` when
    ``freeze_bn``.  The ResNet sits under ``self.backbone``, which gives the
    reference's keys (``backbone.layer3.0.conv2.weight``).
  * ``ASPPClassifierV2``: four biased 3x3 convs at dilations 6, 12, 18, 24
    (padding equal to the dilation) in ``conv2d_list``, summed, then resized
    in float32 to ``size`` with align_corners=True.  Weights start N(0, 0.01)
    and biases at 0, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops import max_pool, resize_bilinear
from .layers import Conv2d
from .resnet import ResNet

# (out_channels of each conv) per block; pools follow blocks 1-3
_VGG16_BLOCKS = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512), (512, 512, 512))
VGG16_CHANNELS = 1024


class ResNetFeatureExtractor(nn.Module):
    def __init__(self, backbone_name: str = "resnet101", freeze_bn: bool = False):
        super().__init__()
        self.backbone = ResNet(backbone_name, replace_stride_with_dilation=(False, True, True),
                               norm_kind="frozen" if freeze_bn else "bn",
                               return_layers=("layer4",))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.backbone(x)["layer4"]


class _MaxPool2x2(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool(x, 2, 2)


class VGG16FeatureExtractor(nn.Module):
    def __init__(self):
        super().__init__()
        layers, in_ch = [], 3
        for b, widths in enumerate(_VGG16_BLOCKS):
            d = 2 if b == 4 else 1
            for w in widths:
                layers += [Conv2d(in_ch, w, 3, padding=d, dilation=d), nn.ReLU()]
                in_ch = w
            if b < 4:  # block 4's pool (index 23) is dropped, and block 5's
                layers.append(_MaxPool2x2() if b < 3 else nn.Identity())
        self.features = nn.Sequential(*layers)
        self.fc6 = Conv2d(in_ch, VGG16_CHANNELS, 3, padding=4, dilation=4)
        self.fc7 = Conv2d(VGG16_CHANNELS, VGG16_CHANNELS, 3, padding=4, dilation=4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.features(x)
        return torch.relu(self.fc7(torch.relu(self.fc6(x))))


class ASPPClassifierV2(nn.Module):
    def __init__(self, in_channels: int, num_classes: int,
                 dilation_series: Sequence[int] = (6, 12, 18, 24)):
        super().__init__()
        self.conv2d_list = nn.ModuleList(
            Conv2d(in_channels, num_classes, 3, padding=d, dilation=d, bias=True)
            for d in dilation_series)
        for conv in self.conv2d_list:
            nn.init.normal_(conv.weight, 0.0, 0.01)
            nn.init.zeros_(conv.bias)

    def forward(self, x: torch.Tensor,
                size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        out = self.conv2d_list[0](x)
        for conv in self.conv2d_list[1:]:
            out = out + conv(x)
        if size is not None:
            out = resize_bilinear(out.float(), size, align_corners=True)
        return out
