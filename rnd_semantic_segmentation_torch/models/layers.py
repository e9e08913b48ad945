"""Core building blocks on NCHW tensors (counterpart of the JAX package's models/layers.py).

``Conv2d`` is ``nn.Conv2d`` (weights OIHW) and ``ConvTranspose2d`` is
``nn.ConvTranspose2d`` (weights IOHW; the JAX package stores the same kernel
flipped, in correlation orientation).  ``BatchNorm`` is ``nn.BatchNorm2d``,
by default with eps 1e-5 and momentum 0.1 (the EfficientNet encoder asks for
1e-3 and 0.01), which in eval mode applies its running statistics.  ``relu``,
``relu6``, ``leaky_relu`` and ``swish`` are the plain functions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.mbconv import swish  # noqa: F401  (x * sigmoid(x), shared with the kernel's plain version)

Conv2d = nn.Conv2d
ConvTranspose2d = nn.ConvTranspose2d


def BatchNorm(num_features: int, eps: float = 1e-5,
              momentum: float = 0.1) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(num_features, eps=eps, momentum=momentum)


def relu(x: torch.Tensor) -> torch.Tensor:
    return F.relu(x)


def relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 6.0)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)
