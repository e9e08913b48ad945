"""Whole segmentation nets of the research zoo (counterpart of the JAX
package's models/nets_zoo.py), on NCHW tensors.

  * UNet — the classic encoder/decoder, bilinear (align_corners=True)
    upsampling and skips, sigmoid probabilities out (cenet.py:487-581);
  * CENet — CE-Net: a ResNet34 encoder (models/resnet.py), a DAC centre
    (cascaded atrous convs, four variants) and an SPP block (pooled
    one-channel maps), a decoder of 1x1 convs around stride-2 transposed
    convs with skips, and its variants (``dac``, ``use_spp``,
    ``apply_sigmoid``); CENetOCT is its 12-class logits form
    (cenet.py:19-252, 428-484);
  * BiSeNetV1 — a spatial path and a ResNet18 context path with attention
    refinement, feature fusion and heads that end in a pixel shuffle
    (BiseNet.py).

Keys are the JAX scopes (``inc.conv0``, ``resnet.layer1.0.conv1``,
``dblock.dilate2``, ``decoder4.deconv2``, ``arm32.conv.conv``): the JAX
docstrings cite no torch keys for these nets.  ``ckpt/torch_import.py``
(``RESEARCH_RULES``) carries the JAX variables over; the transposed convs
(``decoderN.deconv2``, ``finaldeconv1``) are ``layers.ConvTranspose2d``, so
MODEL.SUBPIXEL_DECONV reaches them.

BiSeNetV1's pixel shuffle takes the channels in the JAX package's order,
``(row phase, column phase, class)``, which is ``ops.s2d.depth_to_space``;
``nn.PixelShuffle`` takes ``(class, row phase, column phase)``.  The JAX
order is kept, so that the same weights give the same maps.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import max_pool, resize_bilinear
from ..ops.s2d import depth_to_space
from .contextagg import _global_mean
from .layers import BatchNorm, Conv2d, ConvTranspose2d, relu
from .resnet import ResNet


class _DoubleConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv0, self.bn0 = Conv2d(in_ch, out_ch, 3, padding=1), BatchNorm(out_ch)
        self.conv1, self.bn1 = Conv2d(out_ch, out_ch, 3, padding=1), BatchNorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return relu(self.bn1(self.conv1(relu(self.bn0(self.conv0(x))))))


class UNet(nn.Module):
    """Classic UNet (cenet.py:554-581); returns sigmoid probabilities.  The
    sides must be multiples of 16."""

    def __init__(self, n_classes: int = 1, in_channels: int = 3):
        super().__init__()
        self.inc = _DoubleConv(in_channels, 64)
        self.down1, self.down2 = _DoubleConv(64, 128), _DoubleConv(128, 256)
        self.down3, self.down4 = _DoubleConv(256, 512), _DoubleConv(512, 512)
        self.up1, self.up2 = _DoubleConv(1024, 256), _DoubleConv(512, 128)
        self.up3, self.up4 = _DoubleConv(256, 64), _DoubleConv(128, 64)
        self.outc = Conv2d(64, n_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.inc(x)
        x2 = self.down1(max_pool(x1, 2, 2))
        x3 = self.down2(max_pool(x2, 2, 2))
        x4 = self.down3(max_pool(x3, 2, 2))
        x5 = self.down4(max_pool(x4, 2, 2))

        def up(a, b, block):
            a = resize_bilinear(a, (a.shape[2] * 2, a.shape[3] * 2), align_corners=True)
            return block(torch.cat([b, a], dim=1))

        h = up(up(up(up(x5, x4, self.up1), x3, self.up2), x2, self.up3), x1, self.up4)
        return torch.sigmoid(self.outc(h))


class DACBlock(nn.Module):
    """Dense atrous convolution (cenet.py:19-39): the 1x1 and the dilated
    convs are shared across the cascades, as in the reference."""

    def __init__(self, c: int):
        super().__init__()
        self.dilate1 = Conv2d(c, c, 3, padding=1, dilation=1)
        self.dilate2 = Conv2d(c, c, 3, padding=3, dilation=3)
        self.dilate3 = Conv2d(c, c, 3, padding=5, dilation=5)
        self.conv1x1 = Conv2d(c, c, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d1 = relu(self.dilate1(x))
        d2 = relu(self.conv1x1(self.dilate2(x)))
        d3 = relu(self.conv1x1(self.dilate2(self.dilate1(x))))
        d4 = relu(self.conv1x1(self.dilate3(self.dilate2(self.dilate1(x)))))
        return x + d1 + d2 + d3 + d4


class DACBlockNoAtrous(DACBlock):
    """The DAC cascade with plain 3x3 convs (cenet.py:42-63): three distinct
    convs, the 1x1 shared."""

    def __init__(self, c: int):
        super().__init__(c)
        self.dilate2 = Conv2d(c, c, 3, padding=1)
        self.dilate3 = Conv2d(c, c, 3, padding=1)


class DACBlockInception(nn.Module):
    """Inception-style DAC (cenet.py:66-88): shared 1x1 and 3x3 convs, the
    concatenation fused by a 2c -> c 1x1, one residual tap."""

    def __init__(self, c: int):
        super().__init__()
        self.dilate1 = Conv2d(c, c, 1)
        self.dilate3 = Conv2d(c, c, 3, padding=1)
        self.conv1x1 = Conv2d(2 * c, c, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d1 = relu(self.dilate1(x))
        d2 = relu(self.dilate3(self.dilate1(x)))
        dc = relu(self.conv1x1(torch.cat([d1, d2], dim=1)))
        return x + relu(self.dilate1(dc))


class DACBlockInceptionBlocks(nn.Module):
    """Parallel 1x1, 3x3, 5x5 and max-pool branches, summed, with no
    residual ``x`` term (cenet.py:91-112)."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1x1 = Conv2d(c, c, 1)
        self.conv3x3 = Conv2d(c, c, 3, padding=1)
        self.conv5x5 = Conv2d(c, c, 5, padding=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d1 = relu(self.conv1x1(x))
        d2 = relu(self.conv3x3(self.conv1x1(x)))
        d3 = relu(self.conv5x5(self.conv1x1(x)))
        return d1 + d2 + d3 + max_pool(x, 3, 1, padding=1)


class SPPBlock(nn.Module):
    """Max pools of 2, 3, 5 and 6 (floor mode), one shared 1x1 conv to one
    channel each, upsampled (align_corners=False) and put before x
    (cenet.py:140-161); the map must be at least 6 x 6."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv2d(c, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        size = x.shape[-2:]
        outs = [resize_bilinear(self.conv(max_pool(x, k, k)), size) for k in (2, 3, 5, 6)]
        return torch.cat(outs + [x], dim=1)


class _CEDecoderBlock(nn.Module):
    def __init__(self, in_ch: int, n_filters: int):
        super().__init__()
        c4 = in_ch // 4
        self.conv1, self.norm1 = Conv2d(in_ch, c4, 1), BatchNorm(c4)
        self.deconv2 = ConvTranspose2d(c4, c4, 3, 2, padding=1, output_padding=1)
        self.norm2 = BatchNorm(c4)
        self.conv3, self.norm3 = Conv2d(c4, n_filters, 1), BatchNorm(n_filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = relu(self.norm1(self.conv1(x)))
        x = relu(self.norm2(self.deconv2(x)))
        return relu(self.norm3(self.conv3(x)))


_DAC_BLOCKS = {
    "atrous": DACBlock,
    "no_atrous": DACBlockNoAtrous,
    "inception": DACBlockInception,
    "inception_blocks": DACBlockInceptionBlocks,
}


class CENet(nn.Module):
    """CE-Net on a ResNet34 encoder (cenet.py:195-252) and its variants:

      * defaults                              -> CE_Net_ (DAC + SPP, sigmoid)
      * dac="no_atrous", use_spp=False        -> CE_Net_backbone_DAC_without_atrous
      * dac="inception", use_spp=False        -> CE_Net_backbone_DAC_with_inception
      * dac="inception_blocks", use_spp=False -> CE_Net_backbone_inception_blocks
      * apply_sigmoid=False (12 classes)      -> CE_Net_OCT (cenet.py:428-484)

    The sides must be multiples of 32, and with SPP at least 192."""

    def __init__(self, num_classes: int = 1, dac: str = "atrous", use_spp: bool = True,
                 apply_sigmoid: bool = True):
        super().__init__()
        self.apply_sigmoid = apply_sigmoid
        self.resnet = ResNet("resnet34", return_layers=("layer1", "layer2", "layer3", "layer4"))
        self.dblock = _DAC_BLOCKS[dac](512)
        self.spp = SPPBlock(512) if use_spp else None
        self.decoder4 = _CEDecoderBlock(516 if use_spp else 512, 256)
        self.decoder3 = _CEDecoderBlock(256, 128)
        self.decoder2 = _CEDecoderBlock(128, 64)
        self.decoder1 = _CEDecoderBlock(64, 64)
        self.finaldeconv1 = ConvTranspose2d(64, 32, 4, 2, padding=1)
        self.finalconv2 = Conv2d(32, 32, 3, padding=1)
        self.finalconv3 = Conv2d(32, num_classes, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        taps = self.resnet(x)
        e1, e2, e3, e4 = (taps[k] for k in ("layer1", "layer2", "layer3", "layer4"))
        e4 = self.dblock(e4)
        if self.spp is not None:
            e4 = self.spp(e4)  # 512 + 4 channels
        d4 = self.decoder4(e4) + e3
        d3 = self.decoder3(d4) + e2
        d2 = self.decoder2(d3) + e1
        d1 = self.decoder1(d2)
        out = relu(self.finaldeconv1(d1))
        out = relu(self.finalconv2(out))
        out = self.finalconv3(out)
        return torch.sigmoid(out) if self.apply_sigmoid else out


def CENetOCT(num_classes: int = 12) -> CENet:
    """CE_Net_OCT (cenet.py:428-484): the base CE-Net centre, logits out."""
    return CENet(num_classes=num_classes, dac="atrous", use_spp=True, apply_sigmoid=False)


# ------------------------------------------------------------------ BiSeNet V1 ----
class _ConvBNReLU(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, ks: int = 3, stride: int = 1,
                 padding: int = 1):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, ks, stride, padding=padding, bias=False)
        self.bn = BatchNorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return relu(self.bn(self.conv(x)))


class AttentionRefinementModule(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = _ConvBNReLU(in_ch, out_ch)
        self.conv_atten = Conv2d(out_ch, out_ch, 1, bias=False)
        self.bn_atten = BatchNorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat = self.conv(x)
        atten = torch.sigmoid(self.bn_atten(self.conv_atten(_global_mean(feat))))
        return feat * atten


class FeatureFusionModule(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.convblk = _ConvBNReLU(in_ch, out_ch, ks=1, padding=0)
        self.conv1 = Conv2d(out_ch, out_ch // 4, 1, bias=False)
        self.conv2 = Conv2d(out_ch // 4, out_ch, 1, bias=False)

    def forward(self, fsp: torch.Tensor, fcp: torch.Tensor) -> torch.Tensor:
        feat = self.convblk(torch.cat([fsp, fcp], dim=1))
        atten = torch.sigmoid(self.conv2(relu(self.conv1(_global_mean(feat)))))
        return feat * atten + feat


def _upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class BiSeNetV1(nn.Module):
    """Spatial path and a ResNet18 context path (taps of 128, 256 and 512
    channels at 1/8, 1/16, 1/32).  Returns ``(out, out16, out32)`` at the
    input size, or ``out`` without ``output_aux``.  The sides must be
    multiples of 32."""

    def __init__(self, n_classes: int, output_aux: bool = True):
        super().__init__()
        self.n_classes, self.output_aux = n_classes, output_aux
        self.cp_resnet = ResNet("resnet18", return_layers=("layer2", "layer3", "layer4"))
        self.conv_avg = _ConvBNReLU(512, 128, ks=1, padding=0)
        self.arm32 = AttentionRefinementModule(512, 128)
        self.conv_head32 = _ConvBNReLU(128, 128)
        self.arm16 = AttentionRefinementModule(256, 128)
        self.conv_head16 = _ConvBNReLU(128, 128)
        self.sp_conv1 = _ConvBNReLU(3, 64, ks=7, stride=2, padding=3)
        self.sp_conv2 = _ConvBNReLU(64, 64, stride=2)
        self.sp_conv3 = _ConvBNReLU(64, 64, stride=2)
        self.sp_conv_out = _ConvBNReLU(64, 128, ks=1, padding=0)
        self.ffm = FeatureFusionModule(256, 256)
        heads = [("conv_out", 256, 256, 8)]
        if output_aux:
            heads += [("conv_out16", 128, 64, 8), ("conv_out32", 128, 64, 16)]
        for name, cin, mid, factor in heads:
            setattr(self, f"{name}_conv", _ConvBNReLU(cin, mid))
            setattr(self, f"{name}_out", Conv2d(mid, n_classes * factor * factor, 1))

    def _head(self, name: str, x: torch.Tensor, factor: int) -> torch.Tensor:
        y = getattr(self, f"{name}_out")(getattr(self, f"{name}_conv")(x))
        return depth_to_space(y, factor)

    def forward(self, x: torch.Tensor):
        taps = self.cp_resnet(x)
        feat16, feat32 = taps["layer3"], taps["layer4"]
        avg = self.conv_avg(_global_mean(feat32))
        f32 = self.arm32(feat32) + avg
        f32_up = self.conv_head32(_upsample_nearest_2x(f32))  # nn.Upsample's default: nearest
        f16 = self.arm16(feat16) + f32_up
        f16_up = self.conv_head16(_upsample_nearest_2x(f16))

        sp = self.sp_conv_out(self.sp_conv3(self.sp_conv2(self.sp_conv1(x))))
        out = self._head("conv_out", self.ffm(sp, f16_up), 8)
        if not self.output_aux:
            return out
        return (out, self._head("conv_out16", f16_up, 8),
                self._head("conv_out32", f32_up, 16))

