"""PraNet: the parallel reverse-attention network for polyp segmentation
(counterpart of the JAX package's models/pranet.py), on NCHW tensors.

  * ``BasicConv2d`` is a convolution and a BN, with no activation;
  * ``RFBModified``, the receptive-field block: four branches (1x1; then
    1xk, kx1 and a 3x3 of dilation k for k = 3, 5, 7), ``conv_cat`` over
    their concatenation, plus ``conv_res`` of the input, then ReLU;
  * ``Aggregation``, the dense partial decoder over the three RFB outputs,
    with ``align_corners=True`` 2x upsampling, ending in a 1-channel 1x1
    convolution ``conv5`` with a bias;
  * three reverse-attention branches on layer4, layer3 and layer2: each
    multiplies the features by ``1 - sigmoid(crop)`` (the previous map
    resized to their size) and adds its 1-channel result to the crop.

The forward returns the four 1-channel lateral maps at the input size (the
aggregation map x8, then the branches' maps x32, x16 and x8), resized to the
explicit size ``floor(dim * s)`` with ``align_corners=False`` in float32
(the maps are float32 whatever the activations' type), and with
``with_tap`` also the layer4 features, FADA's discriminator tap.

``backbone`` is ``res2net50`` (Res2Net50-v1b) or a torchvision ResNet of
models/resnet.py (``resnet50``: the CRANet variant, BatchNorm, no dilation,
taps layer1..layer4).  Attribute names give the reference's ``state_dict``
keys (``resnet.layer1.0.convs.0``, ``rfb2_1.branch1.2.conv``,
``agg1.conv_upsample4.bn``, ``ra4_conv5.conv``), which ``PRANET_RULES`` and
``CRANET_RULES`` of the JAX package's ckpt/torch_import.py map.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
from torch import nn

from ..ops import resize_bilinear, scaled_size
from .layers import BatchNorm, Conv2d, relu
from .res2net import Res2Net
from .resnet import _ARCHS, ResNet

_Pair = Union[int, Tuple[int, int]]


class BasicConv2d(nn.Module):
    def __init__(self, in_planes: int, out_planes: int, kernel_size: _Pair = 1,
                 stride: int = 1, padding: _Pair = 0, dilation: int = 1):
        super().__init__()
        self.conv = Conv2d(in_planes, out_planes, kernel_size, stride, padding=padding,
                           dilation=dilation, bias=False)
        self.bn = BatchNorm(out_planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x))


class RFBModified(nn.Module):
    def __init__(self, in_channel: int, out_channel: int):
        super().__init__()
        oc = out_channel
        self.branch0 = nn.Sequential(BasicConv2d(in_channel, oc, 1))
        for i, k in enumerate((3, 5, 7), start=1):
            self.add_module(f"branch{i}", nn.Sequential(
                BasicConv2d(in_channel, oc, 1),
                BasicConv2d(oc, oc, (1, k), padding=(0, k // 2)),
                BasicConv2d(oc, oc, (k, 1), padding=(k // 2, 0)),
                BasicConv2d(oc, oc, 3, padding=k, dilation=k)))
        self.conv_cat = BasicConv2d(4 * oc, oc, 3, padding=1)
        self.conv_res = BasicConv2d(in_channel, oc, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cat = torch.cat([self.branch0(x), self.branch1(x), self.branch2(x),
                         self.branch3(x)], dim=1)
        return relu(self.conv_cat(cat) + self.conv_res(x))


def _up(v: torch.Tensor) -> torch.Tensor:
    return resize_bilinear(v, (v.shape[-2] * 2, v.shape[-1] * 2), align_corners=True)


class Aggregation(nn.Module):
    def __init__(self, channel: int):
        super().__init__()
        ch = channel
        for i in (1, 2, 3, 4):
            self.add_module(f"conv_upsample{i}", BasicConv2d(ch, ch, 3, padding=1))
        self.conv_upsample5 = BasicConv2d(2 * ch, 2 * ch, 3, padding=1)
        self.conv_concat2 = BasicConv2d(2 * ch, 2 * ch, 3, padding=1)
        self.conv_concat3 = BasicConv2d(3 * ch, 3 * ch, 3, padding=1)
        self.conv4 = BasicConv2d(3 * ch, 3 * ch, 3, padding=1)
        self.conv5 = Conv2d(3 * ch, 1, 1)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor, x3: torch.Tensor) -> torch.Tensor:
        x2_1 = self.conv_upsample1(_up(x1)) * x2
        x3_1 = self.conv_upsample2(_up(_up(x1))) * self.conv_upsample3(_up(x2)) * x3
        x2_2 = self.conv_concat2(torch.cat([x2_1, self.conv_upsample4(_up(x1))], dim=1))
        x3_2 = self.conv_concat3(torch.cat([x3_1, self.conv_upsample5(_up(x2_2))], dim=1))
        return self.conv5(self.conv4(x3_2))


def _scale(v: torch.Tensor, s: float) -> torch.Tensor:
    return resize_bilinear(v.float(), scaled_size(v.shape[-2:], s), align_corners=False)


class PraNet(nn.Module):
    def __init__(self, channel: int = 32, backbone: str = "res2net50",
                 with_tap: bool = False):
        super().__init__()
        if backbone == "res2net50":
            self.resnet = Res2Net()
            expansion = 4
        elif backbone in _ARCHS:
            self.resnet = ResNet(backbone, return_layers=("layer1", "layer2", "layer3",
                                                          "layer4"))
            expansion = _ARCHS[backbone][0].expansion
        else:
            raise NotImplementedError(f"pranet backbone {backbone!r}: res2net50 or one of "
                                      f"{sorted(_ARCHS)}")
        c2, c3, c4 = (planes * expansion for planes in (128, 256, 512))
        self.with_tap = with_tap
        self.rfb2_1 = RFBModified(c2, channel)
        self.rfb3_1 = RFBModified(c3, channel)
        self.rfb4_1 = RFBModified(c4, channel)
        self.agg1 = Aggregation(channel)
        self.ra4_conv1 = BasicConv2d(c4, 256, 1)
        self.ra4_conv2 = BasicConv2d(256, 256, 5, padding=2)
        self.ra4_conv3 = BasicConv2d(256, 256, 5, padding=2)
        self.ra4_conv4 = BasicConv2d(256, 256, 5, padding=2)
        self.ra4_conv5 = BasicConv2d(256, 1, 1)
        for level, c in ((3, c3), (2, c2)):
            self.add_module(f"ra{level}_conv1", BasicConv2d(c, 64, 1))
            self.add_module(f"ra{level}_conv2", BasicConv2d(64, 64, 3, padding=1))
            self.add_module(f"ra{level}_conv3", BasicConv2d(64, 64, 3, padding=1))
            self.add_module(f"ra{level}_conv4", BasicConv2d(64, 1, 3, padding=1))

    def _reverse_attention(self, crop: torch.Tensor, x: torch.Tensor, convs) -> torch.Tensor:
        """``crop + branch((1 - sigmoid(crop)) * x)``: ReLU after every
        convolution of the branch but the first and the last.  The crop, a
        float32 resize, is cast to ``x``'s type first, as in the JAX package."""
        crop = crop.to(x.dtype)
        h = convs[0]((1.0 - torch.sigmoid(crop)) * x)
        for conv in convs[1:-1]:
            h = relu(conv(h))
        return convs[-1](h) + crop

    def forward(self, x: torch.Tensor):
        taps = self.resnet(x)
        x2, x3, x4 = taps["layer2"], taps["layer3"], taps["layer4"]
        ra5_feat = self.agg1(self.rfb4_1(x4), self.rfb3_1(x3), self.rfb2_1(x2))
        lateral_map_5 = _scale(ra5_feat, 8.0)
        h4 = self._reverse_attention(_scale(ra5_feat, 0.25), x4, [
            self.ra4_conv1, self.ra4_conv2, self.ra4_conv3, self.ra4_conv4, self.ra4_conv5])
        lateral_map_4 = _scale(h4, 32.0)
        h3 = self._reverse_attention(_scale(h4, 2.0), x3, [
            self.ra3_conv1, self.ra3_conv2, self.ra3_conv3, self.ra3_conv4])
        lateral_map_3 = _scale(h3, 16.0)
        h2 = self._reverse_attention(_scale(h3, 2.0), x2, [
            self.ra2_conv1, self.ra2_conv2, self.ra2_conv3, self.ra2_conv4])
        lateral_map_2 = _scale(h2, 8.0)
        maps = (lateral_map_5, lateral_map_4, lateral_map_3, lateral_map_2)
        return maps + (x4,) if self.with_tap else maps
