"""The one place where the port picks its device and sets float32 matmul modes."""

from __future__ import annotations

import torch


def resolve_device(name: str) -> torch.device:
    """``MODEL.DEVICE`` -> a ``torch.device``; raises rather than fall back.

    TF32 is switched off for convolutions and matmuls: the JAX eval path
    computes in float32 end to end, and cuDNN would otherwise run float32
    convolutions in TF32 (about three decimal digits).
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"MODEL.DEVICE={name!r} but torch.cuda.is_available() "
                           f"is False; set MODEL.DEVICE cpu to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"MODEL.DEVICE={name!r}: the port runs on 'cuda' or 'cpu'")
    return device
