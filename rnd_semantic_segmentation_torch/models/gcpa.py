"""GCPA-CC ("GALD") encoder, decoder and their context modules.

Counterpart of the JAX package's models/gcpa.py, on NCHW tensors, with the
reference's ``state_dict`` keys (``conva.0.weight``, ``long_relation.gamma``,
``local_attention_4.dconv1.0.weight``, ``fam45.conv0.weight``,
``linear2.weight``):

  * CrissCrossAttention — 1x1 q/k/v convs, the criss-cross core of
    ops/ccattn.py, and a learnable ``gamma`` (zero at init) on the residual;
  * LocalAttenModule — two depthwise 3x3 stride-2 VALID conv+BN+ReLU, an
    align_corners=True upsample and a sigmoid mask: x + x*mask;
  * FAM — the three-input interweaved aggregation;
  * SpatialCGNL — grouped dot-product global attention (CGNL, linear
    kernel): per (image, group) one scalar <p, g> over all its channels and
    pixels scales t, then a grouped 1x1 conv ``z``, GroupNorm ``gn`` and the
    residual; GALDBlock — a depthwise 3x3 stride-2 VALID conv+BN+ReLU
    (``down``), SpatialCGNL (``long_relation``), an align_corners=True
    upsample and LocalAttenModule (``local_attention``), the keys of the
    reference's contextagg/GALDNet.py;
  * GCPAEncoder / GCPADecoder — HarDNet68 taps; conva, one criss-cross
    module applied twice with shared weights, three local-attention branches,
    the FAM cascade and four per-scale heads upsampled (align_corners=False)
    to the input size, returned as (out5, out4, out3, out2).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..ops import resize_bilinear
from ..ops.ccattn import cc_attention_core
from .hardnet import HarDNet
from .layers import BatchNorm, Conv2d, GroupNorm, relu


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


class CrissCrossAttention(nn.Module):
    def __init__(self, in_dim: int):
        super().__init__()
        cq = max(in_dim // 8, 1)
        self.query_conv = Conv2d(in_dim, cq, 1)
        self.key_conv = Conv2d(in_dim, cq, 1)
        self.value_conv = Conv2d(in_dim, in_dim, 1)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = cc_attention_core(_nhwc(self.query_conv(x)), _nhwc(self.key_conv(x)),
                                _nhwc(self.value_conv(x)))
        out = out.permute(0, 3, 1, 2)
        return (self.gamma * out.float()).to(x.dtype) + x


def _dconv(channels: int) -> nn.Sequential:
    return nn.Sequential(Conv2d(channels, channels, 3, 2, padding=0, groups=channels),
                         BatchNorm(channels), nn.ReLU())


class LocalAttenModule(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        self.dconv1 = _dconv(in_channels)
        self.dconv2 = _dconv(in_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = x
        y = self.dconv2(self.dconv1(x))
        y = resize_bilinear(y.float(), x.shape[-2:], align_corners=True)
        mask = torch.sigmoid(y).to(res.dtype)
        return res + res * mask


class SpatialCGNL(nn.Module):
    def __init__(self, inplanes: int, planes: int, use_scale: bool = False,
                 groups: int = 8):
        super().__init__()
        self.planes, self.use_scale, self.groups = planes, use_scale, groups
        self.t = Conv2d(inplanes, planes, 1, bias=False)
        self.p = Conv2d(inplanes, planes, 1, bias=False)
        self.g = Conv2d(inplanes, planes, 1, bias=False)
        self.z = Conv2d(planes, inplanes, 1, groups=groups, bias=False)
        self.gn = GroupNorm(groups, inplanes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        gch = self.planes // self.groups
        tg, pg, gg = (conv(x).float().view(b, self.groups, gch, h, w)
                      for conv in (self.t, self.p, self.g))
        att = (pg * gg).sum(dim=(2, 3, 4), keepdim=True)  # [B,G,1,1,1]
        if self.use_scale:
            att = att / float(gch * h * w) ** 0.5
        out = (att * tg).view(b, self.planes, h, w).to(x.dtype)
        return self.gn(self.z(out)) + x


class GALDBlock(nn.Module):
    def __init__(self, inplane: int, plane: int):
        super().__init__()
        self.down = _dconv(inplane)
        self.long_relation = SpatialCGNL(inplane, plane)
        self.local_attention = LocalAttenModule(inplane)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.long_relation(self.down(x))
        y = resize_bilinear(y.float(), x.shape[-2:], align_corners=True).to(x.dtype)
        return self.local_attention(y)


class FAM(nn.Module):
    """Feature Interweaved Aggregation Module."""

    def __init__(self, in_left: int, in_down: int, in_right: int,
                 interplanes: int = 256):
        super().__init__()
        p = interplanes
        self.conv0, self.bn0 = Conv2d(in_left, p, 3, padding=1), BatchNorm(p)
        self.conv1, self.bn1 = Conv2d(in_down, p, 3, padding=1), BatchNorm(p)
        self.conv2, self.bn2 = Conv2d(in_right, p, 3, padding=1), BatchNorm(p)
        self.conv_d1 = Conv2d(p, p, 3, padding=1)
        self.conv_l = Conv2d(p, p, 3, padding=1)
        self.conv_d2 = Conv2d(p, p, 3, padding=1)
        self.conv3 = Conv2d(3 * p, p, 3, padding=1)
        self.bn3 = BatchNorm(p)

    def forward(self, left, down, right):
        left = relu(self.bn0(self.conv0(left)))
        down = relu(self.bn1(self.conv1(down)))
        right = relu(self.bn2(self.conv2(right)))
        lsize = left.shape[-2:]

        def to_left(t):
            return resize_bilinear(t.float(), lsize).to(left.dtype)

        z1 = relu(self.conv_l(left) * to_left(down))
        z2 = relu(to_left(self.conv_d1(down)) * left)
        z3 = relu(to_left(self.conv_d2(right)) * left)
        out = self.conv3(torch.cat([z1, z2, z3], dim=1))
        return relu(self.bn3(out))


class GCPAEncoder(nn.Module):
    """HarDNet68 wrapper returning the 4 taps."""

    def __init__(self):
        super().__init__()
        self.hardnet = HarDNet(arch=68)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return self.hardnet(x)


class GCPADecoder(nn.Module):
    """GCPA-CC decoder producing 4 per-scale class maps at input resolution."""

    def __init__(self, num_classes: int = 19, interplanes: int = 256):
        super().__init__()
        p = interplanes
        self.conva = nn.Sequential(Conv2d(1024, p, 3, padding=1, bias=False),
                                   BatchNorm(p), nn.ReLU())
        self.long_relation = CrissCrossAttention(p)
        self.local_attention_4 = LocalAttenModule(p)
        self.local_attention_3 = LocalAttenModule(p)
        self.local_attention_2 = LocalAttenModule(p)
        self.fam45 = FAM(640, p, p, p)
        self.fam34 = FAM(320, p, p, p)
        self.fam23 = FAM(128, p, p, p)
        self.linear5 = Conv2d(p, num_classes, 3, padding=1)
        self.linear4 = Conv2d(p, num_classes, 3, padding=1)
        self.linear3 = Conv2d(p, num_classes, 3, padding=1)
        self.linear2 = Conv2d(p, num_classes, 3, padding=1)

    def forward(self, x: torch.Tensor, hardnetout) -> Tuple[torch.Tensor, ...]:
        out2, out3, out4, out5_ = hardnetout  # 128@/4, 320@/8, 640@/16, 1024@/32
        size = x.shape[-2:]
        out5_ = self.conva(out5_)
        # two passes through the SAME criss-cross module (shared weights)
        out5_c = self.long_relation(self.long_relation(out5_))

        out4_c = self.local_attention_4(out5_c)
        out3_c = self.local_attention_3(out5_c)
        out2_c = self.local_attention_2(out5_c)

        out5 = out5_
        out4 = self.fam45(out4, out5, out4_c)
        out3 = self.fam34(out3, out4, out3_c)
        out2 = self.fam23(out2, out3, out2_c)

        heads = []
        for head, feat in ((self.linear5, out5), (self.linear4, out4),
                           (self.linear3, out3), (self.linear2, out2)):
            heads.append(resize_bilinear(head(feat).float(), size, align_corners=False))
        return tuple(heads)  # (out5, out4, out3, out2)
