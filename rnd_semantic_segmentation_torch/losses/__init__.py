"""Losses (counterpart of the JAX package's losses/__init__.py), on NCHW logits.

This slice has ``cross_entropy``, the loss of the gald and deeplab families;
the Tversky, BCE, Dice and structure losses come with their families.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: int = 255) -> torch.Tensor:
    """Softmax CE, mean over the pixels whose label is not ``ignore_index``.

    logits ``[B,C,H,W]`` (any float type, promoted to float32), labels
    ``[B,H,W]`` integer.  The sum is divided by ``max(count_valid, 1)``, so a
    batch in which every pixel is ignored gives 0 and zero gradients, where
    ``F.cross_entropy(..., reduction="mean")`` would give NaN.
    """
    labels = labels.long()
    total = F.cross_entropy(logits.float(), labels, ignore_index=ignore_index,
                            reduction="sum")
    count = (labels != ignore_index).sum().clamp(min=1)
    return total / count
