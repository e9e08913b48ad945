"""Bilinear resize on NCHW tensors (counterpart of the JAX package's ops/resize.py).

The JAX package spells ``F.interpolate(mode="bilinear")`` out as two
interpolation-matrix products; here it is the PyTorch op itself, in both
``align_corners`` flavours.  Resizing to the input size is the identity, as
there.  ``scaled_size`` is the output size of a resize by a factor:
``floor(dim * s)`` per side, which PraNet resizes to explicitly (a resize
with ``scale_factor=s`` maps coordinates by ``1/s`` instead of ``in/out``
and differs wherever ``dim * s`` is not an integer).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

__all__ = ["resize_bilinear", "scaled_size"]


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """Resizes ``x`` [N,C,H,W] to ``size`` = (H_out, W_out), computing in f32."""
    size = (int(size[0]), int(size[1]))
    if tuple(x.shape[-2:]) == size:
        return x
    out = F.interpolate(x.float(), size=size, mode="bilinear",
                        align_corners=align_corners)
    return out.to(x.dtype)


def scaled_size(size: Sequence[int], scale: float) -> Tuple[int, int]:
    """``(floor(size[0] * scale), floor(size[1] * scale))``."""
    return int(size[0] * scale), int(size[1] * scale)
