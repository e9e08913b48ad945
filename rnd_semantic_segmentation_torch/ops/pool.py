"""Pooling on NCHW tensors (counterpart of the JAX package's ops/pool.py).

``max_pool`` is ``nn.MaxPool2d(kernel, stride, padding)``: -inf padding,
floor mode, as the HarDNet stem and its down-sampling steps use it.
``avg_pool`` is ``F.avg_pool2d(kernel, stride, padding, count_include_pad)``
in floor mode: Res2Net's ``stage`` blocks (3x3, padding 1, padding counted)
and PraNet's structure loss (31x31, stride 1, padding 15), which the JAX
package computes for kernels of 7 and more as two separable window sums, an
XLA rewrite of the same function.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["avg_pool", "max_pool"]


def max_pool(x: torch.Tensor, kernel: int, stride: int, padding: int = 0) -> torch.Tensor:
    return F.max_pool2d(x, kernel, stride, padding)


def avg_pool(x: torch.Tensor, kernel: int, stride: int, padding: int = 0,
             count_include_pad: bool = True) -> torch.Tensor:
    return F.avg_pool2d(x, kernel, stride, padding, count_include_pad=count_include_pad)
