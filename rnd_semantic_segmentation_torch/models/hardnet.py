"""HarDNet encoders (counterpart of the JAX package's models/hardnet.py):
HarDNet68, and HarDNet39 and HarDNet85 from the same arch table
(hardnet_68.py:163-198).

``base`` is the reference's sequential ModuleList, so parameter names are the
reference's ``state_dict`` keys (``base.4.layers.3.conv.weight``).  For
HarDNet68 the forward returns the four taps at base indices 4, 9, 12 and 15
that the GCPA decoder reads: 128 channels at /4, 320 at /8, 640 at /16, 1024
at /32.  The JAX ``HarDNet`` collects taps for arch 68 only, and returns an
empty tuple for 39 and 85 after running every layer; the port does the same,
with the same parameters (so no GCPA decoder sits on them, and
``gald_hardnet85`` is refused by ``models.build``).
Each ``HarDBlock`` is a ``RematBlock`` (``MODEL.REMAT_BLOCKS``, models/remat.py).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from ..ops import max_pool
from .layers import BatchNorm, Conv2d, relu6
from .remat import RematBlock


def _get_link(layer: int, base_ch: int, growth_rate: int, grmul: float):
    """Returns (out_channels, in_channels, link) of one HarDBlock layer."""
    if layer == 0:
        return base_ch, 0, []
    out_channels = growth_rate
    link: List[int] = []
    for i in range(10):
        dv = 2 ** i
        if layer % dv == 0:
            link.append(layer - dv)
            if i > 0:
                out_channels *= grmul
    out_channels = int(int(out_channels + 1) / 2) * 2
    in_channels = 0
    for i in link:
        ch, _, _ = _get_link(i, base_ch, growth_rate, grmul)
        in_channels += ch
    return out_channels, in_channels, link


def hardblock_out_channels(in_channels: int, growth_rate: int, grmul: float,
                           n_layers: int) -> int:
    out = 0
    for i in range(n_layers):
        outch, _, _ = _get_link(i + 1, in_channels, growth_rate, grmul)
        if i % 2 == 0 or i == n_layers - 1:
            out += outch
    return out


class ConvLayer(nn.Module):
    """Conv (no bias) + BN + ReLU6."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3,
                 stride: int = 1):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, kernel, stride,
                           padding=kernel // 2, bias=False)
        self.norm = BatchNorm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return relu6(self.norm(self.conv(x)))


class HarDBlock(RematBlock):
    def __init__(self, in_channels: int, growth_rate: int, grmul: float,
                 n_layers: int):
        super().__init__()
        self.links = []
        layers = []
        for i in range(n_layers):
            outch, inch, link = _get_link(i + 1, in_channels, growth_rate, grmul)
            self.links.append(link)
            layers.append(ConvLayer(inch, outch))
        self.layers = nn.ModuleList(layers)
        self.out_channels = hardblock_out_channels(in_channels, growth_rate,
                                                   grmul, n_layers)

    def body(self, x: torch.Tensor) -> torch.Tensor:
        layers_ = [x]
        for link, layer in zip(self.links, self.layers):
            tin = [layers_[i] for i in link]
            layers_.append(layer(torch.cat(tin, dim=1) if len(tin) > 1 else tin[0]))
        # the odd layers and the last one (the block input is not kept)
        t = len(layers_)
        return torch.cat([layers_[i] for i in range(t) if i == t - 1 or i % 2 == 1], dim=1)


class MaxPool(nn.Module):
    """A parameter-free ``base`` entry, so that indices match the reference."""

    def __init__(self, kernel: int, stride: int, padding: int = 0):
        super().__init__()
        self.kernel, self.stride, self.padding = kernel, stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool(x, self.kernel, self.stride, self.padding)


_HARDNET_ARCHS = {
    68: dict(first_ch=(32, 64), ch_list=(128, 256, 320, 640, 1024),
             gr=(14, 16, 20, 40, 160), grmul=1.7,
             n_layers=(8, 16, 16, 16, 4), down_samp=(1, 0, 1, 1, 0)),
    39: dict(first_ch=(24, 48), ch_list=(96, 320, 640, 1024),
             gr=(16, 20, 64, 160), grmul=1.6,
             n_layers=(4, 16, 8, 4), down_samp=(1, 1, 1, 0)),
    85: dict(first_ch=(48, 96), ch_list=(192, 256, 320, 480, 720, 1280),
             gr=(24, 24, 28, 36, 48, 256), grmul=1.7,
             n_layers=(8, 16, 16, 16, 16, 4), down_samp=(1, 0, 1, 0, 1, 0)),
}
_TAPS = {68: (4, 9, 12, 15)}


class HarDNet(nn.Module):
    """HarDNet backbone returning the 4 feature taps the GCPA decoder reads
    (HarDNet68), or none (39, 85)."""

    def __init__(self, arch: int = 68):
        super().__init__()
        if arch not in _HARDNET_ARCHS:
            raise NotImplementedError(f"HarDNet{arch}: one of {sorted(_HARDNET_ARCHS)}")
        self.taps = _TAPS.get(arch, ())
        spec = _HARDNET_ARCHS[arch]
        first_ch, ch_list = spec["first_ch"], spec["ch_list"]
        base: List[nn.Module] = [ConvLayer(3, first_ch[0], kernel=3, stride=2),
                                 ConvLayer(first_ch[0], first_ch[1], kernel=3),
                                 MaxPool(3, 2, padding=1)]
        ch = first_ch[1]
        for i, n_layers in enumerate(spec["n_layers"]):
            blk = HarDBlock(ch, spec["gr"][i], spec["grmul"], n_layers)
            base.append(blk)
            base.append(ConvLayer(blk.out_channels, ch_list[i], kernel=1))
            ch = ch_list[i]
            if spec["down_samp"][i] == 1:
                base.append(MaxPool(2, 2))
        self.base = nn.ModuleList(base)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        taps = []
        for i, layer in enumerate(self.base):
            x = layer(x)
            if i in self.taps:
                taps.append(x)
        return tuple(taps)
