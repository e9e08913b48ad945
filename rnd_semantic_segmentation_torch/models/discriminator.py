"""Adversarial discriminators for FADA (counterpart of the JAX package's
models/discriminator.py), on NCHW tensors.

  * ``PixelDiscriminator``: the FADA discriminator.  A trunk of two 3x3
    convs, each followed by LeakyReLU(0.2), the second to ``ndf // 2``
    channels; two 3x3 class heads, ``cls1`` (source distribution) and
    ``cls2`` (target distribution), joined along the channel axis to 2C;
    then, when ``size`` is given, a float32 bilinear resize with
    align_corners=True.  The trunk is the Sequential ``D`` (convs at 0 and 2),
    which gives the reference's keys ``D.0.weight``, ``D.2.weight``.
  * ``FCDiscriminator``: four stride-2 4x4 convs with LeakyReLU(0.2) and a
    stride-2 4x4 classifier to one channel; kept for parity with the JAX
    package, no training loop uses it.

Unlike flax, ``nn.Conv2d`` takes its input channels up front:
``models/build.py`` sizes them from the tap the discriminator reads.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops import resize_bilinear
from .layers import Conv2d, leaky_relu


class PixelDiscriminator(nn.Module):
    def __init__(self, in_channels: int, ndf: int = 512, num_classes: int = 1):
        super().__init__()
        self.D = nn.Sequential(
            Conv2d(in_channels, ndf, 3, padding=1), nn.LeakyReLU(0.2),
            Conv2d(ndf, ndf // 2, 3, padding=1), nn.LeakyReLU(0.2))
        self.cls1 = Conv2d(ndf // 2, num_classes, 3, padding=1)
        self.cls2 = Conv2d(ndf // 2, num_classes, 3, padding=1)

    def forward(self, x: torch.Tensor,
                size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        h = self.D(x)
        out = torch.cat([self.cls1(h), self.cls2(h)], dim=1)
        if size is not None:
            out = resize_bilinear(out.float(), tuple(size), align_corners=True)
        return out


class FCDiscriminator(nn.Module):
    def __init__(self, in_channels: int, ndf: int = 64):
        super().__init__()
        widths = [in_channels] + [ndf * m for m in (1, 2, 4, 8)]
        for i in range(4):
            setattr(self, f"conv{i + 1}", Conv2d(widths[i], widths[i + 1], 4, 2, padding=1))
        self.classifier = Conv2d(widths[-1], 1, 4, 2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(4):
            x = leaky_relu(getattr(self, f"conv{i + 1}")(x), 0.2)
        return self.classifier(x)
