"""Sub-pixel (phase-decomposed) transposed convolution (counterpart of the
JAX package's ops/subpixel.py), on NCHW activations and the IOHW weight of
``nn.ConvTranspose2d``.

A transposed conv of stride s spends (s*s - 1) / (s*s) of its multiply-adds
on the zeros it inserts between the input's pixels when it is lowered as a
dilated conv.  Each of its s x s output phases is an ordinary small
correlation of the undilated input with an s-strided subset of the kernel's
taps: ``conv_transpose_subpixel`` runs all the phases as one dense conv
(output channels ``phase * Co + o``) over a padded input, then interleaves
them (a pixel shuffle).  The result is ``F.conv_transpose2d(x, weight,
None, stride, padding, output_padding)``, up to the order of float sums.

``layers.ConvTranspose2d`` takes it where ``subpixel`` is set
(MODEL.SUBPIXEL_DECONV, set on every transposed conv of a built segmentor by
``models.build.build_segmentor``), the stride is above 1, groups and
dilation are 1.  The phase weight is gathered from the layer's own weight
through a static index, so parameters and gradients stay the layer's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def _axis_plan(h: int, k: int, s: int, p: int, op: int):
    """The static plan of one axis: for each phase r, its (t, u) taps, and
    the window the phases share.

    out[o] with o = s*m + r:  out = sum_t K[u(r, t)] * X[m + t], where K is
    the kernel in correlation orientation (the conv weight flipped) and
    u(r, t) = (k-1-p) - r + s*t where 0 <= u < k.
    Returns (out_len, taps, t0, kp, n_phase, pad_lo, pad_hi, j0)."""
    out_len = (h - 1) * s - 2 * p + k + op
    base = k - 1 - p
    taps, ts = {}, []
    for r in range(s):
        taps[r] = []
        for u in range(k):
            num = r + u - base
            if num % s == 0:
                taps[r].append((num // s, u))
                ts.append(num // s)
    t0, t1 = min(ts), max(ts)
    kp = t1 - t0 + 1                      # taps of a phase's common window
    n_phase = -(-out_len // s)            # rows of the longest phase
    pad_lo = max(0, -t0)
    j0 = t0 + pad_lo                      # the window's offset for m = 0
    pad_hi = max(0, (j0 + n_phase - 1 + kp - 1) - (h + pad_lo - 1))
    return out_len, taps, t0, kp, n_phase, pad_lo, pad_hi, j0


def phase_taps(kh: int, kw: int, stride, padding, output_padding=0,
               device=None) -> torch.Tensor:
    """For each (phase, th, tw) slot of the phase weight, the flat tap
    ``uh * kw + uw`` of the correlation-oriented kernel, or ``kh * kw`` (a
    zero), as a long tensor [s*s, kp_h, kp_w] on ``device``.  It depends on
    the layer alone (not on the input's size): ``layers.ConvTranspose2d``
    keeps it as a buffer, so that no call copies it to the card."""
    (sh, sw), (ph, pw), (oph, opw) = _pair(stride), _pair(padding), _pair(output_padding)
    _, tap_h, t0h, kph, *_ = _axis_plan(1, kh, sh, ph, oph)
    _, tap_w, t0w, kpw, *_ = _axis_plan(1, kw, sw, pw, opw)
    taps = [[[kh * kw] * kpw for _ in range(kph)] for _ in range(sh * sw)]
    for rh in range(sh):
        for th, uh in tap_h[rh]:
            for rw in range(sw):
                for tw, uw in tap_w[rw]:
                    taps[rh * sw + rw][th - t0h][tw - t0w] = uh * kw + uw
    return torch.tensor(taps, dtype=torch.long, device=device)


def conv_transpose_subpixel(x: torch.Tensor, weight: torch.Tensor, stride, padding,
                            output_padding=0, taps: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """``F.conv_transpose2d(x, weight, None, stride, padding, output_padding)``
    by phase decomposition; ``weight`` [Ci, Co, kh, kw]; no bias, groups 1,
    dilation 1.  ``taps``: the layer's ``phase_taps`` index, made here when
    not given."""
    ci, co, kh, kw = weight.shape
    (sh, sw), (ph, pw), (oph, opw) = _pair(stride), _pair(padding), _pair(output_padding)
    b, _, h, w = x.shape
    oh, tap_h, t0h, kph, nmh, lo_h, hi_h, j0h = _axis_plan(h, kh, sh, ph, oph)
    ow, tap_w, t0w, kpw, nmw, lo_w, hi_w, j0w = _axis_plan(w, kw, sw, pw, opw)
    if taps is None:
        taps = phase_taps(kh, kw, stride, padding, output_padding, weight.device)
    corr = weight.flip(2, 3).reshape(ci, co, kh * kw)       # correlation orientation
    flat = torch.cat([corr, weight.new_zeros(ci, co, 1)], dim=2)
    kb = flat[:, :, taps].permute(2, 1, 0, 3, 4).reshape(sh * sw * co, ci, kph, kpw)
    yp = F.conv2d(F.pad(x, (lo_w, hi_w, lo_h, hi_h)), kb)
    # every phase's rows m sit at the conv positions j0 + m
    yph = yp[:, :, j0h:j0h + nmh, j0w:j0w + nmw].reshape(b, sh, sw, co, nmh, nmw)
    y = yph.permute(0, 3, 4, 1, 5, 2).reshape(b, co, nmh * sh, nmw * sw)
    return y[:, :, :oh, :ow]
