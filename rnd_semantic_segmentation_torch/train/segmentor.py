"""Segmentor: one forward for every family (counterpart of the JAX package's
train/segmentor.py).  This slice has the gald branch, in eval mode:
``decoder(x, encoder(x))``, whose discriminator tap is the last encoder tap.
"""

from __future__ import annotations

import torch
from torch import nn

from ..models.build import SegmentorSpec


class Segmentor(nn.Module):
    def __init__(self, spec: SegmentorSpec, num_classes: int):
        super().__init__()
        self.spec = spec
        self.num_classes = num_classes
        self.parts = nn.ModuleDict(spec.modules)

    def forward(self, x: torch.Tensor):
        """Returns (outputs tuple, disc_tap feature); x is NCHW float."""
        fam = self.spec.family
        if fam == "gald":
            taps = self.parts["encoder"](x)
            outs = self.parts["decoder"](x, taps)
            return outs, taps[3]
        raise NotImplementedError(fam)
