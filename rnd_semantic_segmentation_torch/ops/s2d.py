"""Space-to-depth convolution: an exact rewrite of a narrow conv (counterpart
of the JAX package's ops/s2d.py), on NCHW activations and OIHW weights.

A 2x2 spatial block is packed into the channels, so that the same conv runs
as a conv at half the resolution with four times the operand widths, at
16/9 the multiply-adds for a 3x3 kernel.  The JAX package made it for the
TPU's 128-wide matrix unit, which the narrow branch convs of PraNet's
Res2Net (26-208 channels) and its RFB decoder (32) fill badly.

``conv2d_s2d(x, weight, stride, padding)`` computes ``F.conv2d(x, weight,
stride=stride, padding=padding)`` (up to the order of float sums) by
  1. applying the conv's padding up front,
  2. packing the padded input with ``space_to_depth`` (block 2),
  3. laying the [Co, Ci, kh, kw] weight out as a block-space weight,
     [4Co, 4Ci, kh', kw'] for stride 1 (every output phase is produced) or
     [Co, 4Ci, kh', kw'] for stride 2 (the conv's own stride is the block
     step), with kh' = kh // 2 + 1,
  4. a conv without padding in block space, then ``depth_to_space`` for
     stride 1.

The block weight is gathered from the layer's own weight through a static
index (each (phase, tap) pair has exactly one slot), so parameters,
checkpoints and gradients stay those of the plain conv.

``layers.Conv2d`` takes the rewrite where ``s2d_applies``: its threshold
``s2d_max_channels`` (MODEL.S2D_MAX_CHANNELS, set on every conv of a built
segmentor by ``models.build.build_segmentor``) is at least the conv's wider
side, and ``s2d_supported`` holds.  The JAX package keeps the threshold in a
context variable read at trace time; an attribute of the layer is seen alike
by the server's threads, ``torch.export`` and loader processes.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def space_to_depth(x: torch.Tensor, b: int = 2) -> torch.Tensor:
    """[B,C,H,W] -> [B,b*b*C,H/b,W/b]; channel ``(row phase * b + column phase)
    * C + c``, the JAX package's order."""
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // b, b, w // b, b)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(n, b * b * c, h // b, w // b)


def depth_to_space(x: torch.Tensor, b: int = 2) -> torch.Tensor:
    """The inverse of :func:`space_to_depth`."""
    n, cbb, h, w = x.shape
    c = cbb // (b * b)
    x = x.reshape(n, b, b, c, h, w)
    return x.permute(0, 3, 4, 1, 5, 2).reshape(n, c, h * b, w * b)


@functools.lru_cache(maxsize=None)
def _block_taps(kh: int, kw: int, stride: int) -> tuple:
    """For each (output phase, input phase, s, t) slot of the block weight,
    the flat tap ``u * kw + v`` of the conv weight that lands there, or
    ``kh * kw`` (a zero) where none does, as nested tuples.

    Stride 1: out[2i+p] = sum_u K[u] * xpad[2i+p+u]; writing the padded row
    as 2s+a gives a = (p+u) % 2, s = (p+u) // 2, one slot per tap.
    Stride 2: the output phase is 0 only."""
    kh2, kw2 = kh // 2 + 1, kw // 2 + 1
    phases = 4 if stride == 1 else 1
    taps = [[[[kh * kw] * kw2 for _ in range(kh2)] for _ in range(4)] for _ in range(phases)]
    for out_phase in range(phases):
        ph, q = divmod(out_phase, 2)
        for u in range(kh):
            a, s = (ph + u) % 2, (ph + u) // 2
            for v in range(kw):
                c_, t = (q + v) % 2, (q + v) // 2
                taps[out_phase][a * 2 + c_][s][t] = u * kw + v
    return tuple(tuple(tuple(tuple(r) for r in m) for m in p) for p in taps)


def block_taps(kh: int, kw: int, stride: int, device=None) -> torch.Tensor:
    """``_block_taps`` as a long tensor [P, 4, kh', kw'] on ``device``:
    ``layers.Conv2d`` keeps it as a buffer, so that no call copies it to
    the card."""
    return torch.tensor(_block_taps(kh, kw, stride), dtype=torch.long, device=device)


def block_weight(weight: torch.Tensor, stride: int, taps: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """[Co,Ci,kh,kw] -> [4Co,4Ci,kh',kw'] (stride 1) or [Co,4Ci,kh',kw']
    (stride 2), by one gather from ``weight`` and a zero; ``taps`` is
    ``block_taps``'s index, made here when not given."""
    co, ci, kh, kw = weight.shape
    if taps is None:
        taps = block_taps(kh, kw, stride, weight.device)
    flat = torch.cat([weight.reshape(co, ci, kh * kw), weight.new_zeros(co, ci, 1)], dim=2)
    g = flat[:, :, taps]                                  # [Co, Ci, P, 4, kh', kw']
    phases, kh2, kw2 = taps.shape[0], taps.shape[2], taps.shape[3]
    return g.permute(2, 0, 3, 1, 4, 5).reshape(phases * co, 4 * ci, kh2, kw2)


def s2d_supported(x_shape, weight_shape, stride, padding, dilation, groups: int) -> bool:
    """Dilation 1, stride 1 or 2 on both axes, an odd kernel, groups 1, even
    padded sides (at least the kernel for stride 2) and a map of at least
    2 x 2."""
    sh, sw = _pair(stride)
    dh, dw = _pair(dilation)
    if isinstance(padding, str):
        return False
    ph, pw = _pair(padding)
    kh, kw = weight_shape[2], weight_shape[3]
    h, w = x_shape[2], x_shape[3]
    return (groups == 1 and dh == dw == 1
            and (sh, sw) in ((1, 1), (2, 2))
            and kh % 2 == 1 and kw % 2 == 1
            and (h + 2 * ph) % 2 == 0 and (w + 2 * pw) % 2 == 0
            and (sh == 1 or h + 2 * ph >= kh)
            and h >= 2 and w >= 2)


def s2d_applies(x_shape, weight_shape, stride, padding, dilation, groups: int,
                max_channels: int) -> bool:
    """The rewrite's gate: a threshold above 0 that the conv's wider side
    does not pass, a kernel other than 1x1 (whose block weight would be
    block-diagonal: nothing gained), and ``s2d_supported``."""
    if not max_channels:
        return False
    co, cig, kh, kw = weight_shape
    if max(cig * groups, co) > max_channels or (kh == 1 and kw == 1):
        return False
    return s2d_supported(x_shape, weight_shape, stride, padding, dilation, groups)


def conv2d_s2d(x: torch.Tensor, weight: torch.Tensor, stride=1, padding=1,
               taps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The space-to-depth execution of ``F.conv2d(x, weight, None, stride,
    padding)`` (see the module docstring); no bias.  ``taps``: the conv's
    ``block_taps`` index, made here when not given."""
    sh, _ = _pair(stride)
    ph, pw = _pair(padding)
    _, _, h, w = x.shape
    kh, kw = weight.shape[2], weight.shape[3]
    xb = space_to_depth(F.pad(x, (pw, pw, ph, ph)), 2)
    yb = F.conv2d(xb, block_weight(weight, sh, taps))
    if sh == 1:
        # the block conv gives (H + 2p) / 2 - kh' + 1 blocks: H / 2 exactly
        # for SAME padding, more for less padding, sliced off
        return depth_to_space(yb, 2)[:, :, :h + 2 * ph - kh + 1, :w + 2 * pw - kw + 1]
    return yb[:, :, :(h + 2 * ph - kh) // 2 + 1, :(w + 2 * pw - kw) // 2 + 1]
