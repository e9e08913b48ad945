"""Model registry (counterpart of the JAX package's models/build.py).

MODEL.NAME is ``<family>_<backbone>``.  This slice of the port builds the
``gald`` family (HarDNet68 + GCPA-CC); every other family raises
NotImplementedError until its slice is ported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
from torch import nn

from .gcpa import CrissCrossAttention, GCPADecoder, GCPAEncoder


def split_model_name(name: str) -> Tuple[str, str]:
    family, _, backbone = name.partition("_")
    return family, backbone


@dataclasses.dataclass
class SegmentorSpec:
    """Everything orchestration needs to run one family uniformly.

    ``modules``: named submodels, each with its own checkpoint part.
    ``lr_mults``: LR multiplier per module name.
    ``optimizer``: 'sgd' | 'adam'.
    ``disc_tap``: which forward intermediate feeds the FADA discriminator.
    """

    family: str
    backbone: str
    modules: Dict[str, nn.Module]
    lr_mults: Dict[str, float]
    optimizer: str
    ckpt_prefix: str
    disc_tap: str


def build_segmentor(cfg) -> SegmentorSpec:
    family, backbone = split_model_name(cfg.MODEL.NAME)
    if family == "gald":
        if backbone not in ("", "hardnet68"):
            raise NotImplementedError(f"gald backbone {backbone!r}: only hardnet68")
        return SegmentorSpec(
            family=family, backbone="hardnet68",
            modules={"encoder": GCPAEncoder(),
                     "decoder": GCPADecoder(num_classes=cfg.MODEL.NUM_CLASSES)},
            lr_mults={"encoder": 1.0, "decoder": 10.0},
            optimizer="adam", ckpt_prefix="Gald", disc_tap="hardnetout3",
        )
    raise NotImplementedError(
        f"model family {family!r} is not ported yet (the port builds 'gald')")


@torch.no_grad()
def randomize_weights_(module: nn.Module, seed: int, gamma: float = 0.7) -> nn.Module:
    """Fills every parameter and BN statistic from ``seed``, in place.

    For tests and the on-card smoke run, where no trained weights exist.
    Conv weights are normal with variance 1.7/fan_in, which keeps GALD's
    logits of order 1 to 5; biases and BN affines are small and nonzero,
    running statistics random, and every criss-cross ``gamma`` is set to
    ``gamma``: at its init value 0 the attention would contribute nothing.
    The draws are made on the CPU, so a seed gives the same weights on
    every device.
    """
    gen = torch.Generator().manual_seed(seed)

    def uniform(t, lo, hi):
        t.copy_(torch.rand(t.shape, generator=gen) * (hi - lo) + lo)

    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                           * (1.7 / fan_in) ** 0.5)
            if m.bias is not None:
                uniform(m.bias, -0.1, 0.1)
        elif isinstance(m, nn.BatchNorm2d):
            uniform(m.weight, 0.5, 1.5)
            uniform(m.bias, -0.2, 0.2)
            uniform(m.running_mean, -0.2, 0.2)
            uniform(m.running_var, 0.5, 1.5)
        elif isinstance(m, CrissCrossAttention):
            m.gamma.fill_(gamma)
    return module
