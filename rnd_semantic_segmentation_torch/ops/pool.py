"""Pooling on NCHW tensors (counterpart of the JAX package's ops/pool.py).

``max_pool`` is ``nn.MaxPool2d(kernel, stride, padding)``: -inf padding,
floor mode, as the HarDNet stem and its down-sampling steps use it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["max_pool"]


def max_pool(x: torch.Tensor, kernel: int, stride: int, padding: int = 0) -> torch.Tensor:
    return F.max_pool2d(x, kernel, stride, padding)
