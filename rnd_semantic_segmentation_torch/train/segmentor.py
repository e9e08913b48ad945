"""Segmentor: one forward for every family (counterpart of the JAX package's
train/segmentor.py).  deeplab: ``classifier(feature_extractor(x),
label_size)``, one output at the label size, tapped at the backbone
features.  gald: ``decoder(x, encoder(x))``, whose discriminator tap is the
last encoder tap.  attn: ``decoder(encoder(x))`` with five outputs
at scales 1 to 1/16, tapped at ``reduction_5``.  attnwrap: the same forward
as one ``model`` part, with no tap (``None``), as in the JAX package.
pranet: the ``model`` part's four lateral maps at the input size (x8 of the
aggregation, then the reverse-attention maps of layer4, layer3 and layer2),
tapped at layer4.
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
                train: bool = False, generator: Optional[torch.Generator] = None):
        """Returns (outputs tuple, disc_tap feature); x is NCHW float.

        ``train=True`` puts every BatchNorm on batch statistics and updates
        its running statistics; ``train=False`` applies the running ones.  A
        ``FrozenBatchNorm2d`` applies its buffers either way.
        ``label_size`` is for the deeplab head, which resizes to it (the input
        size when None); the gald, attn and pranet heads are at the input size.
        ``generator`` (on x's device) feeds the attn encoder's drop-connect,
        which in train mode needs one; the other families take no draws.
        """
        fam = self.spec.family
        if self.training != train:
            self.train(train)
        if fam == "deeplab":
            fea = self.parts["feature_extractor"](x)
            size = tuple(label_size) if label_size is not None else tuple(x.shape[-2:])
            return (self.parts["classifier"](fea, size),), fea
        if fam == "gald":
            taps = self.parts["encoder"](x)
            outs = self.parts["decoder"](x, taps)
            return outs, taps[3]
        if fam == "attn":
            endpoints = self.parts["encoder"](x, generator)
            return self.parts["decoder"](endpoints), endpoints["reduction_5"]
        if fam == "attnwrap":
            return self.parts["model"](x, generator), None
        if fam == "pranet":
            outs = self.parts["model"](x)
            return tuple(outs[:4]), outs[4]
        raise NotImplementedError(fam)
