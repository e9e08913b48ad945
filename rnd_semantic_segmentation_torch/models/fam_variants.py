"""The research variants of GALD's FAM (counterpart of the JAX package's
models/fam_variants.py, gcpa_gald.py:109-545), on NCHW tensors: fusions of
the (left, down, right) taps gated by attention, beside the live FAM of
models/gcpa.py.

  * FAMAG (:109-201) — three additive attention gates (one-channel psi
    masks).  Its 1x1 convs carry padding 1, as in the reference, so each
    call grows the map by 2: a left tap of H x W gives an output of
    (H + 2) x (W + 2);
  * FAMAGv3 (:203-296) — FAMAG whose first branch is gated at the down
    tap's resolution and upsampled back;
  * FAMPra (:392-468) — the live FAM, then PraNet's reverse attention
    ``1 - sigmoid(crop)`` over its channels; returns (features, a one-channel
    map);
  * FAMSCWS (:469-545) — each branch weighted by a pooled scalar, their sum
    divided by the sum of the weights.

Each takes its taps' channel counts, which the JAX modules read off their
inputs.  Keys are the JAX scopes (``l0.conv``, ``psi_1.bn``, ``conv_out``;
FAMPra's FAM under ``fam.``, with the live FAM's own keys ``conv0``-
``conv3``, ``bn0``-``bn3``; FAMSCWS's branch convs ``conv0``-``conv2``, as
the live FAM's).  Maps are resized (bilinear, align_corners=False) to the
left branch's size where they differ.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..ops import resize_bilinear
from .contextagg import _global_mean
from .gcpa import FAM
from .layers import BatchNorm, Conv2d, relu


def _fit(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    return resize_bilinear(t, ref.shape[-2:])


class _ConvBN(nn.Module):
    """The reference's 1x1 conv with padding 1, and its BN."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = Conv2d(cin, cout, 1, padding=1)
        self.bn = BatchNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x))


class _Psi(nn.Module):
    """1x1 conv to one channel, BN, sigmoid: the gate."""

    def __init__(self, cin: int):
        super().__init__()
        self.conv = Conv2d(cin, 1, 1)
        self.bn = BatchNorm(1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.bn(self.conv(x)))


class FAMAG(nn.Module):
    def __init__(self, in_left: int, in_down: int, in_right: int, interplanes: int = 256,
                 v3: bool = False):
        super().__init__()
        ip, self.v3 = interplanes, v3
        self.l0, self.d0, self.psi_1 = _ConvBN(in_left, ip), _ConvBN(in_down, ip), _Psi(ip)
        self.l1, self.d1, self.psi_2 = _ConvBN(in_left, ip), _ConvBN(in_down, ip), _Psi(ip)
        self.l2, self.r2, self.psi_3 = _ConvBN(in_left, ip), _ConvBN(in_right, ip), _Psi(ip)
        self.conv_out = Conv2d(3 * ip, ip, 3, padding=1)
        self.bn_out = BatchNorm(ip)

    def forward(self, left, down, right):
        # branch 1: low guides high
        left1, down1 = self.l0(left), self.d0(down)
        if self.v3:
            psi1 = self.psi_1(relu(_fit(left1, down1) + down1))
            zdl = _fit(down1 * psi1, left1)
        else:
            down1 = _fit(down1, left1)
            zdl = down1 * self.psi_1(relu(left1 + down1))
        # branch 2: high guides low
        left2 = self.l1(left)
        zld = left2 * self.psi_2(relu(left2 + _fit(self.d1(down), left2)))
        # branch 3: context guides low
        left3 = self.l2(left)
        zlr = left3 * self.psi_3(relu(left3 + _fit(self.r2(right), left3)))
        out = self.conv_out(torch.cat([zdl, zld, zlr], dim=1))
        return relu(self.bn_out(out))


def FAMAGv3(in_left: int, in_down: int, in_right: int, interplanes: int = 256) -> FAMAG:
    return FAMAG(in_left, in_down, in_right, interplanes, v3=True)


class FAMPra(nn.Module):
    """The live FAM, then PraNet's reverse attention on a crop map
    (gcpa_gald.py:392-468)."""

    def __init__(self, in_left: int, in_down: int, in_right: int, interplanes: int = 256):
        super().__init__()
        self.fam = FAM(in_left, in_down, in_right, interplanes)
        self.linear = Conv2d(interplanes, 1, 3, padding=1)

    def forward(self, left, down, right, crop) -> Tuple[torch.Tensor, torch.Tensor]:
        out = self.fam(left, down, right)
        rev = (1.0 - torch.sigmoid(crop.float())).to(out.dtype)
        out = rev * out  # the one-channel reverse mask over every channel
        return out, self.linear(out)


class FAMSCWS(nn.Module):
    """The FAM branches weighted by pooled scalars (gcpa_gald.py:469-545)."""

    def __init__(self, in_left: int, in_down: int, in_right: int, interplanes: int = 256):
        super().__init__()
        p = interplanes
        self.conv0, self.bn0 = Conv2d(in_left, p, 3, padding=1), BatchNorm(p)
        self.conv1, self.bn1 = Conv2d(in_down, p, 3, padding=1), BatchNorm(p)
        self.conv2, self.bn2 = Conv2d(in_right, p, 3, padding=1), BatchNorm(p)
        self.conv_d1 = Conv2d(p, p, 3, padding=1)
        self.conv_l = Conv2d(p, p, 3, padding=1)
        self.conv_d2 = Conv2d(p, p, 3, padding=1)
        self.conv_att1 = Conv2d(p, 1, 3, padding=1)
        self.conv_att2 = Conv2d(p, 1, 3, padding=1)
        self.conv_att3 = Conv2d(p, 1, 3, padding=1)
        self.conv3 = Conv2d(p, p, 3, padding=1)
        self.bn3 = BatchNorm(p)

    def forward(self, left, down, right):
        left = relu(self.bn0(self.conv0(left)))
        down = relu(self.bn1(self.conv1(down)))
        right = relu(self.bn2(self.conv2(right)))

        def weighted(z, conv):
            att = _global_mean(conv(z))
            return att * z, att

        z1, a1 = weighted(relu(self.conv_l(left) * _fit(down, left)), self.conv_att1)
        z2, a2 = weighted(relu(_fit(self.conv_d1(down), left) * left), self.conv_att2)
        z3, a3 = weighted(relu(_fit(self.conv_d2(right), left) * left), self.conv_att3)
        out = self.conv3((z1 + z2 + z3) / (a1 + a2 + a3))
        return relu(self.bn3(out))
