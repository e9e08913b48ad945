"""Gradient reversal layer (counterpart of the JAX package's models/grl.py).

The identity forward and ``-lambd * g`` backward.  Kept for parity and for
DANN-style objectives; the FADA loop alternates its optimizers instead.
"""

from __future__ import annotations

import torch


class _GradientReverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, lambd: float) -> torch.Tensor:
        ctx.lambd = lambd
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return -ctx.lambd * g, None


def gradient_reverse(x: torch.Tensor, lambd: float = 1.0) -> torch.Tensor:
    return _GradientReverse.apply(x, lambd)
