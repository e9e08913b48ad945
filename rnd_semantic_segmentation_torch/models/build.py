"""Model registry (counterpart of the JAX package's models/build.py).

MODEL.NAME is ``<family>_<backbone>``.  The port builds the ``deeplab``
family with a ResNet backbone (``deeplab_resnet{18,34,50,101,152}``: dilated
ResNet + ASPP-V2, FrozenBN when ``MODEL.FREEZE_BN``) or VGG16
(``deeplab_vgg16``: VGG16-FCN + ASPP-V2, no norm), the ``gald`` family
(HarDNet68 + GCPA-CC), the ``attn`` family (EfficientNet-B0..B4 encoder +
attention-gated UNet decoder, parts ``encoder`` and ``decoder``) and its
single-module variant ``attnwrap`` (part ``model``) and the ``pranet``
family (``pranet_res2net50``, and ``pranet_resnet50``, the CRANet variant:
one part ``model`` whose forward also returns the layer4 tap, Adam at 1/8
of the base LR); every other family raises NotImplementedError until its
slice is ported.
``build_adversarial_discriminator`` gives FADA's ``PixelDiscriminator``
for a family's discriminator tap.
``MODEL.REMAT_BLOCKS`` turns on every ``RematBlock`` of the built parts
(models/remat.py): the residual units of ResNet and Res2Net, HarDNet's
blocks and EfficientNet's MBConv blocks; VGG16 has none.
``MODEL.FUSED_MBCONV`` reaches the attn encoder as a constructor argument: in
eval mode its eligible MBConv blocks then run the fused kernel of
ops/mbconv.py.  ``MODEL.S2D_MAX_CHANNELS`` and ``MODEL.SUBPIXEL_DECONV``
set the exact conv rewrites of ops/s2d.py and ops/subpixel.py on every conv
of the built parts (``set_conv_rewrites``).  ``MODEL.FREEZE_BN`` reaches the
deeplab ResNet backbones only, as in the JAX package: the attn and pranet
norms train on batch statistics, although both pranet configs set it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
from torch import nn

from .aspp import VGG16_CHANNELS, ASPPClassifierV2, ResNetFeatureExtractor, VGG16FeatureExtractor
from .attn_unet import _DEPTH_MAP, AttnDecoder, AttnEfficientNetUnet
from .discriminator import PixelDiscriminator
from .efficientnet import EfficientNetEncoder
from .gcpa import CrissCrossAttention, GCPADecoder, GCPAEncoder
from ..ckpt.torch_import import conv_scopes
from .layers import Conv2d, ConvTranspose2d, FrozenBatchNorm2d
from .pranet import PraNet
from .remat import set_remat_blocks
from .resnet import _ARCHS, ResNet, output_channels


def split_model_name(name: str) -> Tuple[str, str]:
    family, _, backbone = name.partition("_")
    return family, backbone


@dataclasses.dataclass
class SegmentorSpec:
    """Everything orchestration needs to run one family uniformly.

    ``modules``: named submodels, each with its own checkpoint part.
    ``lr_mults``: LR multiplier per module name.
    ``optimizer``: 'sgd' | 'adam'.
    ``disc_tap``: which forward intermediate feeds the FADA discriminator.
    """

    family: str
    backbone: str
    modules: Dict[str, nn.Module]
    lr_mults: Dict[str, float]
    optimizer: str
    ckpt_prefix: str
    disc_tap: str


def build_segmentor(cfg) -> SegmentorSpec:
    spec = _build_segmentor(cfg)
    for module in spec.modules.values():
        set_remat_blocks(module, bool(cfg.MODEL.REMAT_BLOCKS))
        set_conv_rewrites(module, int(cfg.MODEL.S2D_MAX_CHANNELS),
                          bool(cfg.MODEL.SUBPIXEL_DECONV))
    assign_quant_keys(spec.family, spec.modules)
    return spec


def set_conv_rewrites(module: nn.Module, s2d_max_channels: int, subpixel: bool) -> int:
    """Sets the exact rewrites on every conv of ``module``: the
    space-to-depth threshold (MODEL.S2D_MAX_CHANNELS, 0 for none) on each
    ``layers.Conv2d`` and the sub-pixel switch (MODEL.SUBPIXEL_DECONV) on
    each ``layers.ConvTranspose2d``.  The JAX package sets both as process
    policies at build time; here they are the layers' own, so that every
    thread, ``torch.export`` and every loader process see them alike.
    Returns the number of convs touched."""
    count = 0
    for m in module.modules():
        if isinstance(m, Conv2d):
            m.set_s2d(s2d_max_channels)
            count += 1
        elif isinstance(m, ConvTranspose2d):
            m.set_subpixel(subpixel)
            count += 1
    return count


def assign_quant_keys(family: str, modules: Dict[str, nn.Module]) -> None:
    """Gives every ``layers.Conv2d`` of each part its quantization key
    (``quant_key``), the flax scope path of the JAX package's conv, from the
    weight bridge's rule tables (``ckpt.torch_import.conv_scopes``).  Two
    convs of two parts may share a key, as in the JAX package: calibration
    then takes the larger absmax of the two and both use that scale."""
    for part, module in modules.items():
        named = dict(module.named_modules())
        convs = [n for n, m in named.items() if isinstance(m, Conv2d)]
        for name, scope in conv_scopes(family, part, named, convs).items():
            named[name].quant_key = scope


def _build_segmentor(cfg) -> SegmentorSpec:
    family, backbone = split_model_name(cfg.MODEL.NAME)
    if family == "deeplab":
        if backbone == "vgg16":
            # torchvision's vgg16 has no norm: MODEL.FREEZE_BN has nothing to freeze
            features, channels = VGG16FeatureExtractor(), VGG16_CHANNELS
        elif backbone.startswith("resnet") and backbone in _ARCHS:
            features = ResNetFeatureExtractor(backbone, freeze_bn=bool(cfg.MODEL.FREEZE_BN))
            channels = output_channels(backbone)
        else:
            raise NotImplementedError(
                f"deeplab backbone {backbone!r}: one of vgg16, resnet18, resnet34, "
                f"resnet50, resnet101, resnet152")
        return SegmentorSpec(
            family=family, backbone=backbone,
            modules={"feature_extractor": features,
                     "classifier": ASPPClassifierV2(channels, cfg.MODEL.NUM_CLASSES)},
            lr_mults={"feature_extractor": 1.0, "classifier": 10.0},
            optimizer="sgd", ckpt_prefix="Aspp", disc_tap="features",
        )
    if family == "gald":
        if backbone not in ("", "hardnet68"):
            # HarDNet39 and 85 exist (models/hardnet.py) but give no taps, in
            # the JAX package too: the GCPA decoder reads HarDNet68's four
            raise NotImplementedError(f"gald backbone {backbone!r}: only hardnet68, the one "
                                      f"HarDNet with taps for the GCPA decoder")
        return SegmentorSpec(
            family=family, backbone="hardnet68",
            modules={"encoder": GCPAEncoder(),
                     "decoder": GCPADecoder(num_classes=cfg.MODEL.NUM_CLASSES)},
            lr_mults={"encoder": 1.0, "decoder": 10.0},
            optimizer="adam", ckpt_prefix="Gald", disc_tap="hardnetout3",
        )
    if family in ("attn", "attnwrap"):
        bb = backbone or "efficientnet-b2"
        if bb not in _DEPTH_MAP:
            raise NotImplementedError(f"{family} backbone {bb!r}: one of "
                                      f"{sorted(_DEPTH_MAP)}")
        fused = bool(cfg.MODEL.FUSED_MBCONV)
        if family == "attnwrap":
            return SegmentorSpec(
                family=family, backbone=bb,
                modules={"model": AttnEfficientNetUnet(
                    bb, cfg.MODEL.NUM_CLASSES, fused_mbconv=fused)},
                lr_mults={"model": 1.0},
                optimizer="adam", ckpt_prefix="AttnWrap", disc_tap="reduction_5",
            )
        return SegmentorSpec(
            family=family, backbone=bb,
            modules={"encoder": EfficientNetEncoder(bb, fused_mbconv=fused),
                     "decoder": AttnDecoder(bb, num_classes=cfg.MODEL.NUM_CLASSES)},
            lr_mults={"encoder": 1.0, "decoder": 10.0},
            optimizer="adam", ckpt_prefix="Attn", disc_tap="reduction_5",
        )
    if family == "pranet":
        bb = backbone or "res2net50"
        return SegmentorSpec(
            family=family, backbone=bb,
            modules={"model": PraNet(backbone=bb, with_tap=True)},
            lr_mults={"model": 0.125},  # Adam at BASE_LR / 8, as the reference trainer
            optimizer="adam", ckpt_prefix="PraNet", disc_tap="layer4",
        )
    raise NotImplementedError(
        f"model family {family!r} is not ported yet (the port builds 'deeplab', "
        f"'gald', 'attn', 'attnwrap' and 'pranet')")


def tap_channels(spec: SegmentorSpec) -> int:
    """The channels of the feature that feeds the FADA discriminator, read
    from the modules that consume or make it: the ASPP head's input (deeplab),
    the GCPA decoder's first conv on the last HarDNet tap (gald), the
    EfficientNet head conv (attn), the RFB block on layer4 (pranet).
    attnwrap has no tap, as in the JAX package, so FADA cannot train it."""
    fam = spec.family
    if fam == "deeplab":
        return spec.modules["classifier"].conv2d_list[0].in_channels
    if fam == "gald":
        return spec.modules["decoder"].conva[0].in_channels
    if fam == "attn":
        return spec.modules["encoder"].encoder._conv_head.out_channels
    if fam == "pranet":
        return spec.modules["model"].rfb4_1.conv_res.conv.in_channels
    raise NotImplementedError(
        f"{fam}: no discriminator tap (the single-module variant returns none); "
        f"FADA trains deeplab, gald, attn and pranet")


def build_adversarial_discriminator(cfg, spec: SegmentorSpec) -> PixelDiscriminator:
    """FADA's discriminator: ndf 256 (the JAX package's ``mid_nc``), two heads
    of NUM_CLASSES.  Its input channels are the tap's (``tap_channels``),
    where the JAX package's table (``_DISC_FEATURES``) is thrown away by flax,
    and would be wrong for resnet18/34 (512) and EfficientNets other than B2."""
    return PixelDiscriminator(tap_channels(spec), ndf=256, num_classes=cfg.MODEL.NUM_CLASSES)


@torch.no_grad()
def randomize_weights_(module: nn.Module, seed: int, gamma: float = 0.7) -> nn.Module:
    """Fills every parameter and BN statistic from ``seed``, in place.

    For tests and the on-card smoke run, where no trained weights exist.
    Conv weights are normal with variance 1.7/fan_in, which keeps GALD's
    logits of order 1 to 5; biases and BN affines are small and nonzero,
    running statistics random, and every criss-cross ``gamma`` is set to
    ``gamma``: at its init value 0 the attention would contribute nothing.
    The norms of a residual net, whose class sets ``damp_norms`` (ResNet,
    Res2Net, the deep-stem research nets of models/seg_nets.py with their
    heads, B2ResNet, SEResNet, RepVGG, the classification hubs, ResNet3D),
    take weights in [0.25, 0.75]: with running
    statistics (FrozenBN always, BatchNorm in eval mode) nothing normalises
    the sum of a residual block, and at [0.5, 1.5] each block about doubles
    the second moment of its input, so that ResNet101's 33 blocks take the
    logits past 1e5; a Bottleneck branch passes three norms, and halving
    them shrinks it about 64-fold, which keeps the logits of order 1.
    The draws are made on the CPU, so a seed gives the same weights on
    every device.
    """
    gen = torch.Generator().manual_seed(seed)

    def uniform(t, lo, hi):
        t.copy_(torch.rand(t.shape, generator=gen) * (hi - lo) + lo)

    damped = {id(n) for m in module.modules() if getattr(m, "damp_norms", False)
              for n in m.modules()}
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d)):
            # OI(D)HW, or IOHW for a transposed conv: 4 of its 16 taps reach an output
            fan_in = (m.weight[0].numel() if not isinstance(m, nn.ConvTranspose2d)
                      else m.weight.shape[0] * 4)
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                           * (1.7 / fan_in) ** 0.5)
            if m.bias is not None:
                uniform(m.bias, -0.1, 0.1)
        elif isinstance(m, (nn.BatchNorm2d, nn.BatchNorm3d, FrozenBatchNorm2d)):
            uniform(m.weight, *((0.25, 0.75) if id(m) in damped else (0.5, 1.5)))
            uniform(m.bias, -0.2, 0.2)
            uniform(m.running_mean, -0.2, 0.2)
            uniform(m.running_var, 0.5, 1.5)
        elif isinstance(m, CrissCrossAttention):
            m.gamma.fill_(gamma)
    return module
