"""DeepLabV2 family (counterpart of the JAX package's models/aspp.py), on NCHW
tensors: a dilated ResNet feature extractor and the ASPP-V2 head.

  * ``ResNetFeatureExtractor``: ResNet with
    ``replace_stride_with_dilation=(False, True, True)``, output stride 8,
    tapped at ``layer4``; the norm is ``FrozenBatchNorm2d`` when
    ``freeze_bn``.  The ResNet sits under ``self.backbone``, which gives the
    reference's keys (``backbone.layer3.0.conv2.weight``).
  * ``ASPPClassifierV2``: four biased 3x3 convs at dilations 6, 12, 18, 24
    (padding equal to the dilation) in ``conv2d_list``, summed, then resized
    in float32 to ``size`` with align_corners=True.  Weights start N(0, 0.01)
    and biases at 0, as in the JAX package.

The VGG16 feature extractor (``deeplab_vgg16``) comes with a later slice.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops import resize_bilinear
from .layers import Conv2d
from .resnet import ResNet


class ResNetFeatureExtractor(nn.Module):
    def __init__(self, backbone_name: str = "resnet101", freeze_bn: bool = False):
        super().__init__()
        self.backbone = ResNet(backbone_name, replace_stride_with_dilation=(False, True, True),
                               norm_kind="frozen" if freeze_bn else "bn",
                               return_layers=("layer4",))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.backbone(x)["layer4"]


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
