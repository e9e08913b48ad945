"""Core building blocks on NCHW tensors (counterpart of the JAX package's models/layers.py).

``Conv2d`` is ``nn.Conv2d`` (weights OIHW), ``BatchNorm`` is
``nn.BatchNorm2d`` with eps 1e-5 and momentum 0.1, which in eval mode applies
its running statistics, and ``relu`` / ``relu6`` are the plain functions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

Conv2d = nn.Conv2d


def BatchNorm(num_features: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(num_features, eps=1e-5, momentum=0.1)


def relu(x: torch.Tensor) -> torch.Tensor:
    return F.relu(x)


def relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 6.0)
