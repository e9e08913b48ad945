"""Encoders of the research zoo (counterpart of the JAX package's
models/encoders_zoo.py), on NCHW tensors.

  * RepVGG — blocks of three branches (3x3 conv+BN, 1x1 conv+BN and, where
    the shape allows, an identity BN) in train form, and their deploy form,
    one 3x3 conv with a bias (encoders/repvgg.py:35-230).
    ``repvgg_reparam`` (``repvgg_model_convert``, :443-462) folds a
    train-form ``state_dict`` into the deploy form's;
  * B2ResNet — a ResNet50 whose layer3 and layer4 fork into two branches
    (encoders/resnet.py:149-197);
  * B2VGG — a VGG16 whose blocks 4 and 5 fork (encoders/vgg.py), with its
    average pools at the front of blocks 2 to 5;
  * SEResNet — basic blocks with a squeeze-excitation gate (SENet.py);
  * DeepLabV3 — a dilated ResNet at output stride 16, the ASPP of
    DeepLabV3ASPP and a 1x1 classifier, upsampled to the input
    (contextagg/aspp.py);
  * DeepLabV3ASPP — rates (6, 12, 18), a 1x1 branch and image pooling,
    projected by a 1x1 conv (encoders/aspp.py:401-486).

RepVGG keeps the reference's keys (``stage0.rbr_dense.conv.weight``,
``stage1.0.rbr_1x1.bn.running_var``, ``stage2.1.rbr_identity.weight``,
``stage1.0.rbr_reparam.bias``); the ResNet-shaped nets the torchvision
layout (``layer3_1.0.conv2.weight``, ``layer2.0.downsample.1.weight``); the
others the JAX scopes (``conv4_1_0``, ``b1_conv``, ``project_bn``).
``ckpt/torch_import.py`` (``RESEARCH_RULES``) carries the JAX variables over.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
from torch import nn

from ..ops import avg_pool, max_pool, resize_bilinear
from .contextagg import _global_mean
from .layers import BatchNorm, Conv2d, relu
from .resnet import Bottleneck, ResNet, output_channels
from .zoo import SEBlock


class _ConvBN(nn.Sequential):
    def __init__(self, cin: int, cout: int, k: int, stride: int, padding: int, groups: int):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, stride, padding=padding, groups=groups, bias=False)
        self.bn = BatchNorm(cout)


class RepVGGBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 groups: int = 1, deploy: bool = False):
        super().__init__()
        self.deploy = deploy
        if deploy:
            self.rbr_reparam = Conv2d(in_channels, out_channels, 3, stride, padding=1,
                                      groups=groups, bias=True)
            return
        self.rbr_identity = (BatchNorm(in_channels)
                             if in_channels == out_channels and stride == 1 else None)
        self.rbr_dense = _ConvBN(in_channels, out_channels, 3, stride, 1, groups)
        self.rbr_1x1 = _ConvBN(in_channels, out_channels, 1, stride, 0, groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.deploy:
            return relu(self.rbr_reparam(x))
        out = self.rbr_dense(x) + self.rbr_1x1(x)
        if self.rbr_identity is not None:
            out = out + self.rbr_identity(x)
        return relu(out)


_REPVGG_SPECS = {
    "RepVGG-A0": dict(num_blocks=(2, 4, 14, 1), width=(0.75, 0.75, 0.75, 2.5), groups={}),
    "RepVGG-A1": dict(num_blocks=(2, 4, 14, 1), width=(1, 1, 1, 2.5), groups={}),
    "RepVGG-A2": dict(num_blocks=(2, 4, 14, 1), width=(1.5, 1.5, 1.5, 2.75), groups={}),
    "RepVGG-B1": dict(num_blocks=(4, 6, 16, 1), width=(2, 2, 2, 4), groups={}),
}


class RepVGG(nn.Module):
    """The feature-extractor form: returns the four stage outputs (no
    pooling and classifier head)."""

    damp_norms = True  # models.build.randomize_weights_ damps its norms

    def __init__(self, arch: str = "RepVGG-A0", deploy: bool = False):
        super().__init__()
        spec = _REPVGG_SPECS[arch]
        widths = spec["width"]
        in_planes = min(64, int(64 * widths[0]))
        self.stage0 = RepVGGBlock(3, in_planes, stride=2, deploy=deploy)
        layer_idx = 1
        for s, (nb, base) in enumerate(zip(spec["num_blocks"], (64, 128, 256, 512))):
            planes = int(base * widths[s])
            blocks = []
            for b in range(nb):
                blocks.append(RepVGGBlock(in_planes, planes, stride=2 if b == 0 else 1,
                                          groups=spec["groups"].get(layer_idx, 1),
                                          deploy=deploy))
                in_planes = planes
                layer_idx += 1
            self.add_module(f"stage{s + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = self.stage0(x)
        taps = []
        for s in range(1, 5):
            x = getattr(self, f"stage{s}")(x)
            taps.append(x)
        return tuple(taps)


def repvgg_reparam(state_dict: Mapping[str, torch.Tensor], eps: float = 1e-5
                   ) -> Dict[str, torch.Tensor]:
    """A train-form RepVGG ``state_dict`` -> the deploy form's: each block's
    three branches folded into one 3x3 kernel and bias (repvgg.py
    ``get_equivalent_kernel_bias``).  A BN folds as ``k * gamma / std`` and
    ``beta - mean * gamma / std`` with ``std = sqrt(var + eps)``; the 1x1
    kernel is padded to 3x3, the identity is a 3x3 kernel with a one at the
    centre of channel ``o % Cin`` for output ``o``.  Computed in float64 and
    returned in float32."""
    sd = {k: v.detach().double().cpu() for k, v in state_dict.items()}
    blocks = sorted({k[:-len(".rbr_dense.conv.weight")] for k in sd
                     if k.endswith(".rbr_dense.conv.weight")})

    def fold(kernel, bn):
        t = sd[f"{bn}.weight"] / torch.sqrt(sd[f"{bn}.running_var"] + eps)
        return kernel * t.view(-1, 1, 1, 1), sd[f"{bn}.bias"] - sd[f"{bn}.running_mean"] * t

    out: Dict[str, torch.Tensor] = {}
    for block in blocks:
        k3, b3 = fold(sd[f"{block}.rbr_dense.conv.weight"], f"{block}.rbr_dense.bn")
        k1, b1 = fold(sd[f"{block}.rbr_1x1.conv.weight"], f"{block}.rbr_1x1.bn")
        kernel, bias = k3 + nn.functional.pad(k1, (1, 1, 1, 1)), b3 + b1
        if f"{block}.rbr_identity.weight" in sd:
            cout, cin = k3.shape[:2]
            idk = torch.zeros_like(k3)
            idk[torch.arange(cout), torch.arange(cout) % cin, 1, 1] = 1.0
            ki, bi = fold(idk, f"{block}.rbr_identity")
            kernel, bias = kernel + ki, bias + bi
        out[f"{block}.rbr_reparam.weight"] = kernel.float()
        out[f"{block}.rbr_reparam.bias"] = bias.float()
    return out


class B2ResNet(nn.Module):
    """A ResNet50 forking into two layer3/layer4 branches
    (encoders/resnet.py:149-197); returns the branches' outputs (x1, x2)."""

    damp_norms = True  # models.build.randomize_weights_ damps its norms

    def __init__(self):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, 2, padding=3, bias=False)
        self.bn1 = BatchNorm(64)
        plan = (("layer1", 64, 3, 1, 64), ("layer2", 128, 4, 2, 256),
                ("layer3_1", 256, 6, 2, 512), ("layer4_1", 512, 3, 2, 1024),
                ("layer3_2", 256, 6, 2, 512), ("layer4_2", 512, 3, 2, 1024))
        for name, planes, blocks, stride, inplanes in plan:
            layer = []
            for b in range(blocks):
                s = stride if b == 0 else 1
                has_ds = b == 0 and (s != 1 or inplanes != planes * 4)
                layer.append(Bottleneck(inplanes, planes, stride=s, has_downsample=has_ds))
                inplanes = planes * 4
            self.add_module(name, nn.Sequential(*layer))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = max_pool(relu(self.bn1(self.conv1(x))), 3, 2, padding=1)
        x = self.layer2(self.layer1(x))
        return self.layer4_1(self.layer3_1(x)), self.layer4_2(self.layer3_2(x))


# the shared blocks; each but the first starts with a 2x2 average pool
_B2VGG_PLAN = (("conv1", (64, 64), False), ("conv2", (128, 128), True),
               ("conv3", (256, 256, 256), True))


class B2VGG(nn.Module):
    """Two-branch VGG (encoders/vgg.py B2_VGG): conv1-3 shared, blocks 4 and
    5 forked; no norm, so train mode changes nothing."""

    def __init__(self):
        super().__init__()
        cin = 3
        for scope, widths, _ in _B2VGG_PLAN:
            for i, w in enumerate(widths):
                self.add_module(f"{scope}_{i}", Conv2d(cin, w, 3, padding=1))
                cin = w
        for suffix in ("_1", "_2"):
            c = cin
            for block in ("conv4", "conv5"):
                for i in range(3):
                    self.add_module(f"{block}{suffix}_{i}", Conv2d(c, 512, 3, padding=1))
                    c = 512

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        for scope, widths, pool in _B2VGG_PLAN:
            if pool:
                x = avg_pool(x, 2, 2)
            for i in range(len(widths)):
                x = relu(getattr(self, f"{scope}_{i}")(x))

        def branch(y, suffix):
            for block in ("conv4", "conv5"):
                y = avg_pool(y, 2, 2)
                for i in range(3):
                    y = relu(getattr(self, f"{block}{suffix}_{i}")(y))
            return y

        return branch(x, "_1"), branch(x, "_2")


class SEBasicBlock(nn.Module):
    """A ResNet basic block with a squeeze-excitation gate before the sum
    (SENet.py)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 has_downsample: bool = False, reduction: int = 16):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 3, stride, padding=1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.se = SEBlock(planes, reduction)
        self.downsample = (nn.Sequential(Conv2d(inplanes, planes, 1, stride, bias=False),
                                         BatchNorm(planes)) if has_downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = relu(self.bn1(self.conv1(x)))
        out = self.se(self.bn2(self.conv2(out)))
        identity = x if self.downsample is None else self.downsample(x)
        return relu(out + identity)


class SEResNet(nn.Module):
    """SE-ResNet encoder (SENet.py); returns the four stage taps."""

    damp_norms = True  # models.build.randomize_weights_ damps its norms

    def __init__(self, layers: Tuple[int, int, int, int] = (2, 2, 2, 2)):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, 2, padding=3, bias=False)
        self.bn1 = BatchNorm(64)
        inplanes = 64
        for idx, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers)):
            stride = 1 if idx == 0 else 2
            layer = []
            for b in range(blocks):
                s = stride if b == 0 else 1
                layer.append(SEBasicBlock(inplanes, planes, s,
                                          b == 0 and (s != 1 or inplanes != planes)))
                inplanes = planes
            self.add_module(f"layer{idx + 1}", nn.Sequential(*layer))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = max_pool(relu(self.bn1(self.conv1(x))), 3, 2, padding=1)
        taps = []
        for idx in range(1, 5):
            x = getattr(self, f"layer{idx}")(x)
            taps.append(x)
        return tuple(taps)


class DeepLabV3ASPP(nn.Module):
    """Rates-(6, 12, 18) atrous pyramid, a 1x1 branch and a global-pool
    branch (upsampled, align_corners=False), projected by a 1x1 conv
    (encoders/aspp.py:401-486, the output-stride-16 rates)."""

    def __init__(self, in_channels: int, out_channels: int = 256,
                 rates: Tuple[int, ...] = (6, 12, 18)):
        super().__init__()
        self.rates = tuple(rates)
        self.b0_conv = Conv2d(in_channels, out_channels, 1, bias=False)
        self.b0_bn = BatchNorm(out_channels)
        for i, r in enumerate(self.rates):
            self.add_module(f"b{i + 1}_conv", Conv2d(in_channels, out_channels, 3, padding=r,
                                                     dilation=r, bias=False))
            self.add_module(f"b{i + 1}_bn", BatchNorm(out_channels))
        self.gp_conv = Conv2d(in_channels, out_channels, 1, bias=False)
        self.gp_bn = BatchNorm(out_channels)
        self.project_conv = Conv2d((len(self.rates) + 2) * out_channels, out_channels, 1,
                                   bias=False)
        self.project_bn = BatchNorm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branches = [relu(getattr(self, f"b{i}_bn")(getattr(self, f"b{i}_conv")(x)))
                    for i in range(len(self.rates) + 1)]
        g = relu(self.gp_bn(self.gp_conv(_global_mean(x))))
        branches.append(resize_bilinear(g, x.shape[-2:]))
        return relu(self.project_bn(self.project_conv(torch.cat(branches, dim=1))))


class DeepLabV3(nn.Module):
    """DeepLabv3 (contextagg/aspp.py Atrous_ResNet + DeepLabv3): a ResNet
    whose layer4 is dilated (output stride 16), DeepLabV3ASPP and a 1x1
    classifier, upsampled (align_corners=False) to the input size."""

    def __init__(self, num_classes: int = 19, backbone_arch: str = "resnet50"):
        super().__init__()
        self.backbone = ResNet(backbone_arch, replace_stride_with_dilation=(False, False, True),
                               return_layers=("layer4",))
        self.aspp = DeepLabV3ASPP(output_channels(backbone_arch), 256)
        self.classifier = Conv2d(256, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.classifier(self.aspp(self.backbone(x)["layer4"]))
        return resize_bilinear(out.float(), x.shape[-2:])
