"""Core building blocks on NCHW tensors (counterpart of the JAX package's models/layers.py).

``Conv2d`` is ``nn.Conv2d`` (weights OIHW) and ``ConvTranspose2d`` is
``nn.ConvTranspose2d`` (weights IOHW; the JAX package stores the same kernel
flipped, in correlation orientation).  ``BatchNorm`` is ``nn.BatchNorm2d``,
by default with eps 1e-5 and momentum 0.1 (the EfficientNet encoder asks for
1e-3 and 0.01), which in eval mode applies its running statistics.
``FrozenBatchNorm2d`` is the reference's buffers-only norm of the DeepLab
backbones, and ``make_norm`` picks one of the two by ``MODEL.FREEZE_BN``.
``Conv1d`` and ``Linear`` cast their parameters as ``Conv2d`` does.
``GroupNorm`` (the CGNL heads) and ``LayerNormCHW`` (the GCNet channel
transform, ``nn.LayerNorm([C, 1, 1])``) normalise in float32.
``relu``, ``relu6``, ``leaky_relu`` and ``swish`` are the plain functions.

The precision rule is the JAX package's: a layer computes in the type of its
input (MODEL.DTYPE on the training paths: float32 or bfloat16).  Parameters
and buffers stay float32 and are cast to that type where they are used: the
convolutions cast weight and bias in ``forward``; ``nn.BatchNorm2d`` keeps
its statistics in float32 and returns the input's type; FrozenBN folds its
buffers in float32 and applies them in the input's type.  No autocast: its
op lists would promote a bfloat16 activation that meets a float32 parameter
in an elementwise op, where the JAX package keeps the activation's type.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.mbconv import swish  # noqa: F401  (x * sigmoid(x), shared with the kernel's plain version)
from ..ops.s2d import block_taps, conv2d_s2d, s2d_applies
from ..ops.subpixel import conv_transpose_subpixel, phase_taps
from ..serve.quant import current_quant, module_path

def cast_param(p: Optional[torch.Tensor], x: torch.Tensor) -> Optional[torch.Tensor]:
    """``p`` in ``x``'s type (itself when they agree), ``None`` kept."""
    return None if p is None else p.to(x.dtype)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in its input's type, its parameters cast.

    Inside a ``quant_scope`` (serve/quant.py) the conv goes through the
    context's ``conv2d`` under its ``quant_key``, the JAX package's flax
    scope path, which ``models.build.build_segmentor`` assigns; where the
    context declines (None) it takes its float path.  Outside a quant scope,
    a conv whose ``s2d_max_channels`` (``set_s2d``: MODEL.S2D_MAX_CHANNELS,
    set by ``build_segmentor``) admits it runs as the exact space-to-depth
    rewrite of ops/s2d.py."""

    quant_key: Optional[str] = None
    s2d_max_channels: int = 0

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.register_buffer("s2d_taps", None, persistent=False)

    def set_s2d(self, max_channels: int) -> None:
        """Sets the rewrite's threshold; where it could apply (an odd kernel
        other than 1x1, stride 1 or 2), the block weight's gather index is
        kept as a buffer (not in the ``state_dict``) on the weight's device."""
        self.s2d_max_channels = int(max_channels)
        kh, kw = self.kernel_size
        taps = None
        if (self.s2d_max_channels and kh % 2 == 1 and kw % 2 == 1 and (kh, kw) != (1, 1)
                and self.stride in ((1, 1), (2, 2))):
            taps = block_taps(kh, kw, self.stride[0], self.weight.device)
        self.register_buffer("s2d_taps", taps, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qctx = current_quant()
        if qctx is not None:
            y = qctx.conv2d(module_path(self), x, self.weight, self.bias, self.stride,
                            self.padding, self.dilation, self.groups)
            if y is not None:
                return y
        elif s2d_applies(x.shape, self.weight.shape, self.stride, self.padding,
                         self.dilation, self.groups, self.s2d_max_channels):
            y = conv2d_s2d(x, cast_param(self.weight, x), self.stride, self.padding,
                           self.s2d_taps)
            return y if self.bias is None else y + cast_param(self.bias, x).view(1, -1, 1, 1)
        return self._conv_forward(x, cast_param(self.weight, x), cast_param(self.bias, x))


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` computing in its input's type (the graph convolutions'
    1x1 transforms over [B, C, N] tokens)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, cast_param(self.weight, x), cast_param(self.bias, x))


class Linear(nn.Linear):
    """``nn.Linear`` computing in its input's type."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, cast_param(self.weight, x), cast_param(self.bias, x))


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` computing in its input's type, its parameters
    cast; the output size is the layer's own (no ``output_size``).  Under
    ``set_subpixel(True)`` (MODEL.SUBPIXEL_DECONV, set by ``build_segmentor``)
    a strided one runs as the exact phase decomposition of ops/subpixel.py."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.register_buffer("subpixel_taps", None, persistent=False)

    def set_subpixel(self, enabled: bool) -> None:
        """Turns the rewrite on or off for this layer: on where it applies (a
        stride above 1, groups and dilation 1), with the phase weight's gather
        index kept as a buffer (not in the ``state_dict``) on the weight's
        device."""
        taps = None
        if enabled and max(self.stride) > 1 and self.groups == 1 and self.dilation == (1, 1):
            taps = phase_taps(*self.kernel_size, self.stride, self.padding,
                              self.output_padding, self.weight.device)
        self.register_buffer("subpixel_taps", taps, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.subpixel_taps is not None:
            y = conv_transpose_subpixel(x, cast_param(self.weight, x), self.stride,
                                        self.padding, self.output_padding, self.subpixel_taps)
            return y if self.bias is None else y + cast_param(self.bias, x).view(1, -1, 1, 1)
        return F.conv_transpose2d(x, cast_param(self.weight, x), cast_param(self.bias, x),
                                  self.stride, self.padding, self.output_padding,
                                  self.groups, self.dilation)


def BatchNorm(num_features: int, eps: float = 1e-5,
              momentum: float = 0.1) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(num_features, eps=eps, momentum=momentum)


class FrozenBatchNorm2d(nn.Module):
    """Buffers-only BatchNorm: ``x * scale + (bias - running_mean * scale)``
    with ``scale = weight * rsqrt(running_var)``, in training as in eval.

    There is **no epsilon**, as in the reference (and unlike torchvision's
    ``FrozenBatchNorm2d``, which adds 1e-5).  The four buffers carry the
    reference's names, so a ``state_dict`` reads ``bn1.running_mean``; no
    parameter means the optimizer never sees them.
    """

    def __init__(self, num_features: int):
        super().__init__()
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight * torch.rsqrt(self.running_var)
        shift = self.bias - self.running_mean * scale
        return x * cast_param(scale, x).view(1, -1, 1, 1) + cast_param(shift, x).view(1, -1, 1, 1)


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` (eps 1e-5), computed in float32 and returned in its
    input's type, as the JAX package's ``GroupNorm``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                            self.eps).to(x.dtype)


class LayerNormCHW(nn.LayerNorm):
    """``nn.LayerNorm([C, 1, 1])`` on a [B, C, 1, 1] context tensor: the mean
    and variance over the channels, the affine of shape (C, 1, 1), in float32,
    returned in the input's type."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__([channels, 1, 1], eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(x.dtype)


def make_norm(kind: str):
    """``"bn"``: ``nn.BatchNorm2d`` (eps 1e-5, momentum 0.1); ``"frozen"``:
    ``FrozenBatchNorm2d``.  Returns the constructor, called with the channels."""
    if kind == "bn":
        return BatchNorm
    if kind == "frozen":
        return FrozenBatchNorm2d
    raise ValueError(f"unknown norm kind {kind!r}")


def relu(x: torch.Tensor) -> torch.Tensor:
    return F.relu(x)


def relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 6.0)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)
