"""Attention-EfficientNet-UNet decoder (the "attn" family; counterpart of the
JAX package's models/attn_unet.py), on NCHW tensors.

  * AdditiveAttnGate: alpha = sigmoid(conv(ReLU(conv_g(g) + conv_x(up2x(x))))),
    resized back to x's size and multiplied onto x (bilinear,
    align_corners=False);
  * UNet decoder: ConvTranspose2d(4, 2, 1, bias=False) upsamplers, decode
    blocks of two conv3x3 + BN + LeakyReLU, a 1x1 head per level: five
    outputs at scales (1, 1/2, 1/4, 1/8, 1/16).

``AttnEfficientNetUnet`` is the single-module variant (the ``attnwrap``
family): the encoder and the decoder under one module, so its keys are the
attn family's two parts with ``encoder.`` and ``decoder.`` in front.

Submodule names give the reference's ``state_dict`` keys: ``attn_mid.conv_g``,
``mid_upsampler``, ``ups_1..4``, ``decode_1..4.{0,1,3,4}``, ``out_0..4.0``.
The reference also defines a ``decode_0`` that its forward never calls; it is
left out here, and a checkpoint's ``decode_0`` keys are ignored on loading.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..ops import resize_bilinear
from .efficientnet import EfficientNetEncoder
from .layers import BatchNorm, Conv2d, ConvTranspose2d

_DEPTH_MAP = {
    # d5 (head), d4, d3, d2, d1, d0
    "efficientnet-b0": (1280, 112, 40, 24, 16, 8),
    "efficientnet-b1": (1280, 112, 40, 24, 16, 8),
    "efficientnet-b2": (1408, 120, 48, 24, 16, 8),
    "efficientnet-b3": (1536, 136, 48, 32, 24, 12),
    "efficientnet-b4": (1792, 160, 56, 32, 24, 12),
}


class AdditiveAttnGate(nn.Module):
    """Gates x [B,Cx,H,W] by a signal g [B,Cg,2H,2W] from the encoder."""

    def __init__(self, x_channels: int, g_channels: int):
        super().__init__()
        self.conv_g = Conv2d(g_channels, g_channels, 1, bias=True)
        self.conv_x = Conv2d(x_channels, g_channels, 1, bias=False)
        self.conv_group = Conv2d(g_channels, x_channels, 1, bias=True)

    def forward(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        up_x = resize_bilinear(x, (2 * h, 2 * w))
        alpha = torch.relu(self.conv_g(g) + self.conv_x(up_x))
        alpha = torch.sigmoid(self.conv_group(alpha))
        return resize_bilinear(alpha, (h, w)) * x


def _decode_block(in_channels: int, out_channels: int) -> nn.Sequential:
    return nn.Sequential(
        Conv2d(in_channels, out_channels // 2, 3, padding=1),
        BatchNorm(out_channels // 2), nn.LeakyReLU(0.01),
        Conv2d(out_channels // 2, out_channels, 3, padding=1),
        BatchNorm(out_channels), nn.LeakyReLU(0.01))


class AttnDecoder(nn.Module):
    output_scales = (1.0, 0.5, 0.25, 0.125, 0.0625)

    def __init__(self, backbone_name: str = "efficientnet-b2", num_classes: int = 2):
        super().__init__()
        d5, d4, d3, d2, d1, d0 = _DEPTH_MAP[backbone_name]
        up = lambda cin, cout: ConvTranspose2d(cin, cout, 4, 2, 1, bias=False)
        head = lambda cin: nn.Sequential(Conv2d(cin, num_classes, 1))
        self.attn_mid = AdditiveAttnGate(d5, d4)
        self.mid_upsampler = up(d5, d4)
        self.decode_4 = _decode_block(2 * d4, d4)
        self.attn_4 = AdditiveAttnGate(d4, d3)
        self.out_4 = head(d4)
        self.ups_4 = up(d4, d3)
        self.decode_3 = _decode_block(2 * d3, d3)
        self.attn_3 = AdditiveAttnGate(d3, d2)
        self.out_3 = head(d3)
        self.ups_3 = up(d3, d2)
        self.decode_2 = _decode_block(2 * d2, d2)
        self.attn_2 = AdditiveAttnGate(d2, d1)
        self.out_2 = head(d2)
        self.ups_2 = up(d2, d1)
        self.decode_1 = _decode_block(2 * d1, d1)
        self.out_1 = head(d1)
        self.ups_1 = up(d1, d0)
        self.out_0 = head(d0)

    def forward(self, endpoints: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        encode_1, encode_2 = endpoints["reduction_1"], endpoints["reduction_2"]
        encode_3, encode_4 = endpoints["reduction_3"], endpoints["reduction_4"]
        middle = endpoints["reduction_5"]

        up_middle = self.mid_upsampler(self.attn_mid(middle, encode_4))
        decode_4 = self.decode_4(torch.cat([encode_4, up_middle], dim=1))
        up_4 = self.ups_4(self.attn_4(decode_4, encode_3))
        decode_3 = self.decode_3(torch.cat([encode_3, up_4], dim=1))
        up_3 = self.ups_3(self.attn_3(decode_3, encode_2))
        decode_2 = self.decode_2(torch.cat([encode_2, up_3], dim=1))
        up_2 = self.ups_2(self.attn_2(decode_2, encode_1))
        decode_1 = self.decode_1(torch.cat([encode_1, up_2], dim=1))
        up_1 = self.ups_1(decode_1)
        return (self.out_0(up_1), self.out_1(decode_1), self.out_2(decode_2),
                self.out_3(decode_3), self.out_4(decode_4))


class AttnEfficientNetUnet(nn.Module):
    """``decoder(encoder(x))`` as one module (the reference's
    ``AttnEfficientNetUnet``, trained by its ``AttnWrapTrainer``)."""

    def __init__(self, backbone_name: str = "efficientnet-b2", num_classes: int = 2,
                 fused_mbconv: bool = False):
        super().__init__()
        self.encoder = EfficientNetEncoder(backbone_name, fused_mbconv=fused_mbconv)
        self.decoder = AttnDecoder(backbone_name, num_classes)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, ...]:
        return self.decoder(self.encoder(x, generator))
