"""EfficientNet-B0..B4 backbone with UNet endpoint taps (counterpart of the
JAX package's models/efficientnet.py), on NCHW tensors.

The behaviour of ``efficientnet_pytorch.EfficientNet`` with
``extract_endpoints``, under the same ``state_dict`` keys: endpoints
``reduction_1..4`` are the features just before each spatial downsampling and
``reduction_5`` is the swish-activated head conv output (1280*width channels
at /32).  MBConv: expand 1x1 -> depthwise (TF-SAME padding) -> squeeze-excite
(reduction on the pre-expansion channels) -> project 1x1, with the identity
added on stride-1 blocks of equal width.  BN eps 1e-3, momentum 0.01.

With ``fused_mbconv`` an eligible block (eval mode, expansion, stride 1) runs
its expand conv, both BatchNorms, both swishes and the depthwise conv as one
call of ``ops.mbconv.fused_mbconv_core``: one CUDA kernel launch for CUDA
tensors.  The BatchNorm affines and the converted weights are folded once per
weight state and cached on the block, keyed on the ``_version`` and storage of
every tensor the fold reads and on the input's type, so weights loaded or
changed in place after construction are honoured.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.mbconv import fused_mbconv_applies, fused_mbconv_core
from .layers import BatchNorm, Conv2d, swish

# (width_coefficient, depth_coefficient, resolution, dropout)
_PARAMS = {
    "efficientnet-b0": (1.0, 1.0, 224, 0.2),
    "efficientnet-b1": (1.0, 1.1, 240, 0.2),
    "efficientnet-b2": (1.1, 1.2, 260, 0.3),
    "efficientnet-b3": (1.2, 1.4, 300, 0.3),
    "efficientnet-b4": (1.4, 1.8, 380, 0.4),
}

# (num_repeat, kernel, stride, expand_ratio, in_filters, out_filters, se_ratio)
_BLOCK_ARGS = (
    (1, 3, 1, 1, 32, 16, 0.25),
    (2, 3, 2, 6, 16, 24, 0.25),
    (2, 5, 2, 6, 24, 40, 0.25),
    (3, 3, 2, 6, 40, 80, 0.25),
    (3, 5, 1, 6, 80, 112, 0.25),
    (4, 5, 2, 6, 112, 192, 0.25),
    (1, 3, 1, 6, 192, 320, 0.25),
)

BN_EPS, BN_MOMENTUM = 1e-3, 0.01


def round_filters(filters: int, width: float, divisor: int = 8) -> int:
    filters *= width
    new_f = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new_f < 0.9 * filters:
        new_f += divisor
    return int(new_f)


def round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


def head_channels(backbone_name: str) -> int:
    return round_filters(1280, _PARAMS[backbone_name][0])


def block_list(backbone_name: str) -> List[Tuple[int, int, int, int, int, float]]:
    """The variant's flat block list, as efficientnet-pytorch builds it:
    (kernel, stride, expand_ratio, in_filters, out_filters, se_ratio)."""
    width, depth, _, _ = _PARAMS[backbone_name]
    blocks = []
    for (r, k, s, e, fi, fo, se) in _BLOCK_ARGS:
        fi, fo = round_filters(fi, width), round_filters(fo, width)
        blocks.append((k, s, e, fi, fo, se))
        blocks.extend([(k, 1, e, fo, fo, se)] * (round_repeats(r, depth) - 1))
    return blocks


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TF-SAME padding (before, after) of one axis: the output has
    ceil(size/stride) positions and the odd pixel goes after."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class _SameConv(nn.Conv2d):
    """Conv with TF-style SAME padding worked out from the input's size
    (Conv2dStaticSamePadding semantics).  At stride 2 the padding can be
    asymmetric, which ``nn.Conv2d(padding=...)`` cannot express."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int = 1, groups: int = 1, bias: bool = False):
        super().__init__(in_channels, out_channels, kernel, stride=stride,
                         groups=groups, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        top, bottom = same_padding(x.shape[-2], self.kernel_size[0], self.stride[0])
        left, right = same_padding(x.shape[-1], self.kernel_size[1], self.stride[1])
        if top or bottom or left or right:
            x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, self.weight, self.bias, self.stride, 0, 1, self.groups)


def fold_bn(bn: nn.BatchNorm2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode affine of a BatchNorm, y = x*s + b, in float32."""
    s = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    return s, bn.bias.float() - bn.running_mean.float() * s


class MBConvBlock(nn.Module):
    def __init__(self, in_filters: int, out_filters: int, kernel: int, stride: int,
                 expand_ratio: int, se_ratio: float, drop_connect_rate: float = 0.0,
                 fused_mbconv: bool = False):
        super().__init__()
        self.in_filters, self.out_filters = in_filters, out_filters
        self.kernel, self.stride, self.expand_ratio = kernel, stride, expand_ratio
        self.se_ratio = se_ratio
        self.drop_connect_rate = drop_connect_rate
        self.fused_mbconv = fused_mbconv
        self._fold_key, self._folded = None, None
        filters = in_filters * expand_ratio
        bn = lambda ch: BatchNorm(ch, eps=BN_EPS, momentum=BN_MOMENTUM)
        if expand_ratio != 1:
            self._expand_conv = _SameConv(in_filters, filters, 1)
            self._bn0 = bn(filters)
        self._depthwise_conv = _SameConv(filters, filters, kernel, stride, groups=filters)
        self._bn1 = bn(filters)
        if se_ratio > 0:
            se_ch = max(1, int(in_filters * se_ratio))
            self._se_reduce = Conv2d(filters, se_ch, 1)
            self._se_expand = Conv2d(se_ch, filters, 1)
        self._project_conv = _SameConv(filters, out_filters, 1)
        self._bn2 = bn(out_filters)

    def takes_fused_path(self, x: torch.Tensor) -> bool:
        return (self.fused_mbconv and not self.training and self.expand_ratio != 1
                and self.stride == 1
                and fused_mbconv_applies(x.shape, self.kernel,
                                         self.in_filters * self.expand_ratio))

    def train(self, mode: bool = True):
        self._fold_key, self._folded = None, None
        return super().train(mode)

    def _fold(self, dtype: torch.dtype):
        """``(w_exp, s0, b0, w_dw, s1, b1)`` for the fused core.  Cached when
        autograd is off; with it on (no cache) the fold keeps its graph."""
        def fold():
            s0, b0 = fold_bn(self._bn0)
            s1, b1 = fold_bn(self._bn1)
            return (self._expand_conv.weight.flatten(1).to(dtype), s0, b0,
                    self._depthwise_conv.weight.squeeze(1).float(), s1, b1)

        if torch.is_grad_enabled():
            return fold()
        read = (self._expand_conv.weight, self._depthwise_conv.weight,
                *(getattr(bn, name) for bn in (self._bn0, self._bn1)
                  for name in ("weight", "bias", "running_mean", "running_var")))
        key = (dtype,) + tuple((t._version, t.data_ptr(), t.device) for t in read)
        if key != self._fold_key:
            self._folded, self._fold_key = fold(), key
        return self._folded

    def segment_fused(self, x: torch.Tensor) -> torch.Tensor:
        """Expand conv to second swish in one ``fused_mbconv_core`` call."""
        w_exp, s0, b0, w_dw, s1, b1 = self._fold(x.dtype)
        return fused_mbconv_core(x.contiguous(), w_exp, s0, b0, w_dw, s1, b1)

    def segment_unfused(self, x: torch.Tensor) -> torch.Tensor:
        if self.expand_ratio != 1:
            x = swish(self._bn0(self._expand_conv(x)))
        return swish(self._bn1(self._depthwise_conv(x)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inputs = x
        x = self.segment_fused(x) if self.takes_fused_path(x) else self.segment_unfused(x)
        if self.se_ratio > 0:
            s = x.mean(dim=(2, 3), keepdim=True)
            s = self._se_expand(swish(self._se_reduce(s)))
            x = torch.sigmoid(s) * x
        x = self._bn2(self._project_conv(x))
        if self.stride == 1 and self.in_filters == self.out_filters:
            if self.training and self.drop_connect_rate > 0:
                raise NotImplementedError(
                    "drop-connect (stochastic depth) comes with the attn training slice")
            x = x + inputs
        return x


class EfficientNet(nn.Module):
    """The backbone, with efficientnet-pytorch's attribute names."""

    def __init__(self, backbone_name: str, drop_connect_rate: float, fused_mbconv: bool):
        super().__init__()
        width = _PARAMS[backbone_name][0]
        bn = lambda ch: BatchNorm(ch, eps=BN_EPS, momentum=BN_MOMENTUM)
        stem = round_filters(32, width)
        self._conv_stem = _SameConv(3, stem, 3, 2)
        self._bn0 = bn(stem)
        blocks = block_list(backbone_name)
        self._blocks = nn.ModuleList(
            MBConvBlock(fi, fo, k, s, e, se,
                        drop_connect_rate=drop_connect_rate * idx / len(blocks),
                        fused_mbconv=fused_mbconv)
            for idx, (k, s, e, fi, fo, se) in enumerate(blocks))
        head = head_channels(backbone_name)
        self._conv_head = _SameConv(blocks[-1][4], head, 1)
        self._bn1 = bn(head)

    def extract_endpoints(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = swish(self._bn0(self._conv_stem(x)))
        endpoints: Dict[str, torch.Tensor] = {}
        prev = x
        for block in self._blocks:
            x = block(prev)
            if prev.shape[2] > x.shape[2]:
                endpoints[f"reduction_{len(endpoints) + 1}"] = prev
            prev = x
        x = swish(self._bn1(self._conv_head(x)))
        endpoints[f"reduction_{len(endpoints) + 1}"] = x
        return endpoints


class EfficientNetEncoder(nn.Module):
    """Returns endpoints {reduction_1..reduction_5}.  Like the reference's
    wrapper it holds the backbone as ``self.encoder``, which gives the
    ``encoder.`` prefix of the checkpoint keys."""

    def __init__(self, backbone_name: str = "efficientnet-b2",
                 drop_connect_rate: float = 0.2, fused_mbconv: bool = False):
        super().__init__()
        if backbone_name not in _PARAMS:
            raise NotImplementedError(f"backbone {backbone_name!r}: the port has "
                                      f"{sorted(_PARAMS)}")
        self.backbone_name = backbone_name
        self.encoder = EfficientNet(backbone_name, drop_connect_rate, fused_mbconv)

    @property
    def blocks(self) -> nn.ModuleList:
        return self.encoder._blocks

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.encoder.extract_endpoints(x)
