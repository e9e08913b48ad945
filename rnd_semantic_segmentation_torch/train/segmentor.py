"""Segmentor: one forward for every family (counterpart of the JAX package's
train/segmentor.py).  This slice has the gald branch:
``decoder(x, encoder(x))``, whose discriminator tap is the last encoder tap.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..models.build import SegmentorSpec


class Segmentor(nn.Module):
    def __init__(self, spec: SegmentorSpec, num_classes: int):
        super().__init__()
        self.spec = spec
        self.num_classes = num_classes
        self.parts = nn.ModuleDict(spec.modules)

    def forward(self, x: torch.Tensor, label_size: Optional[Tuple[int, int]] = None,
                train: bool = False):
        """Returns (outputs tuple, disc_tap feature); x is NCHW float.

        ``train=True`` puts every BatchNorm on batch statistics and updates
        its running statistics; ``train=False`` applies the running ones.
        ``label_size`` is for the families whose head resizes to the label;
        gald's heads are at the input size already.
        """
        if self.training != train:
            self.train(train)
        fam = self.spec.family
        if fam == "gald":
            taps = self.parts["encoder"](x)
            outs = self.parts["decoder"](x, taps)
            return outs, taps[3]
        raise NotImplementedError(fam)
