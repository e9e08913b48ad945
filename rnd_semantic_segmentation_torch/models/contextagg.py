"""Context-aggregation heads of the research zoo (counterpart of the JAX
package's models/contextagg.py), on NCHW tensors.

  * CA / SRM / SA — channel attention from a pooled global feature,
    self-refinement (a 512-channel conv split into a scale and a shift),
    spatial attention;
  * SmallLocalAttenModule — a depthwise 1x1 conv+BN+ReLU sigmoid mask:
    x + x*mask;
  * GALDHead — conva, GALDBlock, convb, then the bottleneck on [x, out] and
    its classifier (per-interplanes, as the JAX package corrects the
    reference's hard-coded 512);
  * GCPAGALDNet — Res2Net50 + the GALD head + CA globals + SRM refinement +
    the FAM cascade, five outputs;
  * PSPModule — pyramid pooling: ``F.adaptive_avg_pool2d`` bins (the JAX
    ``_adaptive_avg_pool`` computes the same bins), a 1x1 conv+BN+ReLU per
    bin size, an align_corners=True upsample, concatenation and a 3x3
    bottleneck;
  * ContextBlock2d / SNLBlock2d / GCHead — the GCNet global-context block
    (softmax attention pooling or the mean, then ``channel_add`` and
    ``channel_mul`` transforms, added before multiplied as in the JAX
    package), its one-conv simplification, and its segmentation head;
  * gkern / min_max_norm / HolisticAttention — a fixed 31x31 gaussian blur
    of an attention map, min-max normalised per channel, as a gate on x.

Keys are the reference's where the JAX docstrings cite one (GALDNet.py:
``conva.0``, ``a2block.down.0``, ``bottleneck.3`` for the classifier;
PSPNet.py: ``stages.0.1``, ``bottleneck.0``; gcnet.py:
``channel_add_conv.1``, a LayerNorm of shape (C, 1, 1)); elsewhere they are
the JAX scopes (``ca45.conv0``, ``conva_gald_conv``).
``ckpt/torch_import.py`` (``RESEARCH_RULES``) maps the two.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import resize_bilinear
from .gcpa import FAM, GALDBlock
from .layers import BatchNorm, Conv2d, LayerNormCHW, relu
from .res2net import Res2Net


def _global_mean(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=(2, 3), keepdim=True)


def _conv_bn_relu(cin: int, cout: int, k: int = 3) -> nn.Sequential:
    return nn.Sequential(Conv2d(cin, cout, k, padding=k // 2, bias=False),
                         BatchNorm(cout), nn.ReLU())


def _bottleneck_classifier(cin: int, interplanes: int, num_classes: int) -> nn.Sequential:
    """3x3 conv+BN+ReLU and the 1x1 classifier, at index 3 as in the reference."""
    return nn.Sequential(Conv2d(cin, interplanes, 3, padding=1, bias=False),
                         BatchNorm(interplanes), nn.ReLU(),
                         Conv2d(interplanes, num_classes, 1))


class CA(nn.Module):
    """Channel attention: global-pooled ``down`` gates a 1x1-projected ``left``."""

    def __init__(self, in_left: int, in_down: int):
        super().__init__()
        self.conv0, self.bn0 = Conv2d(in_left, 256, 1), BatchNorm(256)
        self.conv1 = Conv2d(in_down, 256, 1)
        self.conv2 = Conv2d(256, 256, 1)

    def forward(self, left: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
        left = relu(self.bn0(self.conv0(left)))
        down = relu(self.conv1(_global_mean(down)))
        return left * torch.sigmoid(self.conv2(down))


class SRM(nn.Module):
    """Self-refinement: conv->256, then conv->512 split into (w, b)."""

    def __init__(self, in_channel: int):
        super().__init__()
        self.conv1, self.bn1 = Conv2d(in_channel, 256, 3, padding=1), BatchNorm(256)
        self.conv2 = Conv2d(256, 512, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out1 = relu(self.bn1(self.conv1(x)))
        out2 = self.conv2(out1)
        return relu(out2[:, :256] * out1 + out2[:, 256:])


class SA(nn.Module):
    """Spatial attention: ``down`` produces a (w, b) affine map over ``left``."""

    def __init__(self, in_left: int, in_down: int):
        super().__init__()
        self.conv0, self.bn0 = Conv2d(in_left, 256, 3, padding=1), BatchNorm(256)
        self.conv2 = Conv2d(in_down, 512, 3, padding=1)

    def forward(self, left: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
        left = relu(self.bn0(self.conv0(left)))
        down_1 = resize_bilinear(self.conv2(down).float(), left.shape[-2:]).to(left.dtype)
        return relu(down_1[:, :256] * left + down_1[:, 256:])


class SmallLocalAttenModule(nn.Module):
    def __init__(self, inplane: int):
        super().__init__()
        self.dconv1 = nn.Sequential(Conv2d(inplane, inplane, 1, groups=inplane),
                                    BatchNorm(inplane), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + x * torch.sigmoid(self.dconv1(x))


class GALDHead(nn.Module):
    def __init__(self, inplanes: int, interplanes: int = 512, num_classes: int = 19):
        super().__init__()
        self.conva = _conv_bn_relu(inplanes, interplanes)
        self.a2block = GALDBlock(interplanes, interplanes // 2)
        self.convb = _conv_bn_relu(interplanes, interplanes)
        self.bottleneck = _bottleneck_classifier(inplanes + interplanes, interplanes,
                                                 num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.convb(self.a2block(self.conva(x)))
        return self.bottleneck(torch.cat([x, out], dim=1))


class GCPAGALDNet(nn.Module):
    """Res2Net50 + GALD head + CA globals + SRM + FAM cascade; returns the
    head's map upsampled 32x and the four per-scale maps at the input size,
    all float32."""

    def __init__(self, num_classes: int = 1):
        super().__init__()
        self.resnet = Res2Net()
        self.ca45, self.ca35, self.ca25 = CA(2048, 2048), CA(2048, 2048), CA(2048, 2048)
        self.conva_gald_conv = Conv2d(2048, 256, 3, padding=1, bias=False)
        self.conva_gald_bn = BatchNorm(256)
        self.a2block_gald = GALDBlock(256, 128)
        self.convb_gald_conv = Conv2d(256, 256, 3, padding=1, bias=False)
        self.convb_gald_bn = BatchNorm(256)
        self.bottleneck_gald_conv = Conv2d(2048 + 256, 256, 3, padding=1, bias=False)
        self.bottleneck_gald_bn = BatchNorm(256)
        self.bottleneck_gald_cls = Conv2d(256, num_classes, 1)
        self.srm5, self.srm4, self.srm3, self.srm2 = SRM(256), SRM(256), SRM(256), SRM(256)
        self.fam45 = FAM(1024, 256, 256)
        self.fam34 = FAM(512, 256, 256)
        self.fam23 = FAM(256, 256, 256)
        for name in ("linear5", "linear4", "linear3", "linear2"):
            setattr(self, name, Conv2d(256, num_classes, 3, padding=1))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        size = x.shape[-2:]
        taps = self.resnet(x)
        out2, out3, out4, out5_ = (taps[f"layer{i}"] for i in (1, 2, 3, 4))
        out4_a, out3_a, out2_a = (ca(out5_, out5_) for ca in (self.ca45, self.ca35, self.ca25))

        out5__ = relu(self.conva_gald_bn(self.conva_gald_conv(out5_)))
        out5__ = self.a2block_gald(out5__)
        head = relu(self.convb_gald_bn(self.convb_gald_conv(out5__)))
        head = relu(self.bottleneck_gald_bn(self.bottleneck_gald_conv(
            torch.cat([out5_, head], dim=1))))
        head = self.bottleneck_gald_cls(head)
        x5_head_out = resize_bilinear(head.float(), (head.shape[2] * 32, head.shape[3] * 32))

        out5 = self.srm5(out5__)
        out4 = self.srm4(self.fam45(out4, out5, out4_a))
        out3 = self.srm3(self.fam34(out3, out4, out3_a))
        out2 = self.srm2(self.fam23(out2, out3, out2_a))
        outs = [x5_head_out]
        for head_conv, feat in ((self.linear5, out5), (self.linear4, out4),
                                (self.linear3, out3), (self.linear2, out2)):
            outs.append(resize_bilinear(head_conv(feat).float(), size))
        return tuple(outs)


class PSPModule(nn.Module):
    def __init__(self, features: int, out_features: int = 512,
                 sizes: Sequence[int] = (1, 2, 3, 6)):
        super().__init__()
        self.stages = nn.ModuleList(
            nn.Sequential(nn.AdaptiveAvgPool2d((s, s)),
                          Conv2d(features, out_features, 1, bias=False),
                          BatchNorm(out_features), nn.ReLU())
            for s in sizes)
        self.bottleneck = _conv_bn_relu(features + len(sizes) * out_features, out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        priors = [x] + [resize_bilinear(stage(x).float(), (h, w), align_corners=True)
                        .to(x.dtype) for stage in self.stages]
        return self.bottleneck(torch.cat(priors, dim=1))


def _attention_pool(conv_mask: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """[B, C, 1, 1]: x's pixels weighted by the softmax of a 1x1 conv's map."""
    b, c, h, w = x.shape
    mask = torch.softmax(conv_mask(x).view(b, 1, h * w), dim=2)
    return torch.einsum("bcp,bop->bco", x.view(b, c, h * w), mask).view(b, c, 1, 1)


class ContextBlock2d(nn.Module):
    def __init__(self, inplanes: int, planes: int, pool: str = "att",
                 fusions: Sequence[str] = ("channel_add",), ratio: int = 8):
        super().__init__()
        self.pool, self.fusions = pool, tuple(fusions)
        hidden = planes // ratio
        if pool == "att":
            self.conv_mask = Conv2d(inplanes, 1, 1)
        for fusion in ("channel_add", "channel_mul"):
            if fusion in self.fusions:
                setattr(self, f"{fusion}_conv", nn.Sequential(
                    Conv2d(inplanes, hidden, 1), LayerNormCHW(hidden), nn.ReLU(),
                    Conv2d(hidden, inplanes, 1)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        context = _attention_pool(self.conv_mask, x) if self.pool == "att" else _global_mean(x)
        out = x
        if "channel_add" in self.fusions:
            out = out + self.channel_add_conv(context)
        if "channel_mul" in self.fusions:
            out = out * torch.sigmoid(self.channel_mul_conv(context))
        return out


class SNLBlock2d(ContextBlock2d):
    """Simplified GCNet block: one 1x1 channel transform per fusion."""

    def __init__(self, inplanes: int, planes: int, pool: str = "att",
                 fusions: Sequence[str] = ("channel_add",)):
        nn.Module.__init__(self)
        self.pool, self.fusions = pool, tuple(fusions)
        if pool == "att":
            self.conv_mask = Conv2d(inplanes, 1, 1)
        for fusion in ("channel_add", "channel_mul"):
            if fusion in self.fusions:
                setattr(self, f"{fusion}_conv", Conv2d(inplanes, planes, 1))


class GCHead(nn.Module):
    def __init__(self, inplanes: int, interplanes: int = 512, num_classes: int = 19):
        super().__init__()
        self.conva = _conv_bn_relu(inplanes, interplanes)
        self.a2block = ContextBlock2d(interplanes, interplanes)
        self.convb = _conv_bn_relu(interplanes, interplanes)
        self.bottleneck = _bottleneck_classifier(inplanes + interplanes, interplanes,
                                                 num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.convb(self.a2block(self.conva(x)))
        return self.bottleneck(torch.cat([x, out], dim=1))


def gkern(kernlen: int = 16, nsig: float = 3.0) -> np.ndarray:
    """Gaussian kernel from normal CDF differences, normalised to sum 1."""
    interval = (2 * nsig + 1.0) / kernlen
    xs = np.linspace(-nsig - interval / 2.0, nsig + interval / 2.0, kernlen + 1)
    cdf = 0.5 * (1 + np.vectorize(math.erf)(xs / math.sqrt(2)))
    kern1d = np.diff(cdf)
    kernel_raw = np.sqrt(np.outer(kern1d, kern1d))
    return kernel_raw / kernel_raw.sum()


def min_max_norm(x: torch.Tensor) -> torch.Tensor:
    """Per image and channel, (x - min) / (max - min + 1e-8) over the pixels."""
    mx = x.amax(dim=(2, 3), keepdim=True)
    mn = x.amin(dim=(2, 3), keepdim=True)
    return (x - mn) / (mx - mn + 1e-8)


class HolisticAttention(nn.Module):
    """A fixed 31x31 gaussian blur of a one-channel attention map, min-max
    normalised, its maximum with the map gating x."""

    def __init__(self):
        super().__init__()
        kernel = np.float32(gkern(31, 4))[None, None]
        self.gaussian_kernel = nn.Parameter(torch.from_numpy(kernel))

    def forward(self, attention: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        soft = F.conv2d(attention.float(), self.gaussian_kernel, padding=15)
        soft = min_max_norm(soft)
        return x * torch.maximum(soft, attention.float()).to(x.dtype)
