"""The one place where the port picks its device and its training compute
type, and sets float32 matmul modes."""

from __future__ import annotations

import torch


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg) -> torch.dtype:
    """MODEL.DTYPE as a torch type: float32 or bfloat16, the types the
    kernels take; another raises ``NotImplementedError`` that names it."""
    name = str(cfg.MODEL.DTYPE)
    if name not in COMPUTE_DTYPES:
        raise NotImplementedError(f"MODEL.DTYPE {name!r}: the port trains in "
                                  f"{' or '.join(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[name]


def resolve_device(name: str) -> torch.device:
    """``MODEL.DEVICE`` -> a ``torch.device``; raises rather than fall back.

    TF32 is switched off for convolutions and matmuls: the JAX eval path
    and a float32 training step compute in float32 end to end, and cuDNN
    would otherwise run float32 convolutions in TF32 (about three decimal
    digits).  A bfloat16 step (MODEL.DTYPE) is not touched by the switch.
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
