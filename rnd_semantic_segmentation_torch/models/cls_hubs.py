"""Classification hubs of the research zoo (counterpart of the JAX
package's models/cls_hubs.py), on NCHW tensors.

  * NLResNet — the CIFAR-style ResNet (3x3 stride-1 stem, no max pool, a
    4x4 average pool before the classifier) with an optional embedded
    ``NLBlockND`` before the last block of layer3 (nonlocal.py:251-323);
  * CGNLResNet — the ImageNet-style bottleneck ResNet with an optional
    SpatialNL, SpatialCGNL or SpatialCGNLx block before the last block of
    layer3 (cgnonlocal.py:390-552), average-pooled, dropout in training,
    then the classifier.

Both reuse the residual blocks of models/resnet.py and the blocks of
models/zoo.py and models/gcpa.py.  The reference NL-ResNet gives NLBlockND
``planes``, not ``planes * expansion``, as its channel count, which breaks
its own Bottleneck depths; the JAX package's NLBlockND reads its channels off
its input, so every depth works, and so does the port's: the block is built
for the channels that reach it.  The classifier's input is the flattened
pooled map, whose size the constructor takes (``input_size``, the side of
the square input: 32 for CIFAR, 224 for ImageNet), where flax reads it off
the first call.

Keys: ``layer3.1.conv2.weight`` for the blocks, ``layer3_nl.*`` for the
inserted block (its JAX scope), ``linear`` and ``fc`` for the classifiers.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import avg_pool, max_pool
from .gcpa import SpatialCGNL
from .layers import BatchNorm, Conv2d, Linear, relu
from .resnet import BasicBlock, Bottleneck
from .zoo import NLBlockND, SpatialCGNLx, SpatialNL

_NL_ARCHS = {
    "resnet18": (BasicBlock, (2, 2, 2, 2), 1),
    "resnet34": (BasicBlock, (3, 4, 6, 3), 1),
    "resnet50": (Bottleneck, (3, 4, 6, 3), 4),
    "resnet101": (Bottleneck, (3, 4, 23, 3), 4),
    "resnet152": (Bottleneck, (3, 8, 36, 3), 4),
}


def _stages(net: nn.Module, block, layers, expansion: int, nl_factory) -> None:
    """Adds ``layer1``-``layer4`` to ``net``, and ``layer3_nl`` from
    ``nl_factory(channels)`` where it gives one."""
    inplanes = 64
    for idx, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers)):
        stride = 1 if idx == 0 else 2
        layer = []
        for b in range(blocks):
            if idx == 2 and b == blocks - 1:
                nl = nl_factory(inplanes)
                if nl is not None:
                    net.layer3_nl = nl
            s = stride if b == 0 else 1
            has_ds = b == 0 and (s != 1 or inplanes != planes * expansion)
            layer.append(block(inplanes, planes, stride=s, has_downsample=has_ds))
            inplanes = planes * expansion
        net.add_module(f"layer{idx + 1}", nn.Sequential(*layer))


def _run_stages(net: nn.Module, x: torch.Tensor) -> torch.Tensor:
    for idx in range(1, 5):
        layer = getattr(net, f"layer{idx}")
        if idx == 3 and net.layer3_nl is not None:
            x = layer[:-1](x)
            x = layer[-1](net.layer3_nl(x))
        else:
            x = layer(x)
    return x


class NLResNet(nn.Module):
    """CIFAR-style (non-local) classification ResNet (nonlocal.py:251-295)."""

    damp_norms = True  # models.build.randomize_weights_ damps its norms

    def __init__(self, arch: str = "resnet18", num_classes: int = 10, non_local: bool = False,
                 input_size: int = 32):
        super().__init__()
        block, layers, expansion = _NL_ARCHS[arch]
        self.conv1 = Conv2d(3, 64, 3, 1, padding=1, bias=False)
        self.bn1 = BatchNorm(64)
        self.layer3_nl: Optional[nn.Module] = None
        _stages(self, block, layers, expansion,
                lambda c: NLBlockND(c, mode="embedded") if non_local else None)
        side = (input_size // 8) // 4
        self.linear = Linear(512 * expansion * side * side, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _run_stages(self, relu(self.bn1(self.conv1(x))))
        return self.linear(avg_pool(x, 4, 4).flatten(1))


class CGNLResNet(nn.Module):
    """ImageNet-style ResNet with NL, CGNL or CGNLx context in layer3
    (cgnonlocal.py:390-505); ``nl_type`` in {None, "nl", "cgnl", "cgnlx"},
    and ``nl_nums=1`` inserts one block before layer3's last residual unit.
    The dropout before the classifier draws from torch's default generator
    in train mode (the JAX net from its ``dropout`` rng)."""

    damp_norms = True  # models.build.randomize_weights_ damps its norms

    def __init__(self, arch: str = "resnet50", num_classes: int = 1000,
                 nl_type: Optional[str] = None, nl_nums: int = 0, pool_size: int = 7,
                 dropout_rate: float = 0.5, input_size: int = 224):
        super().__init__()
        _, layers, _ = _NL_ARCHS[arch]
        self.pool_size, self.dropout_rate = pool_size, dropout_rate
        self.conv1 = Conv2d(3, 64, 7, 2, padding=3, bias=False)
        self.bn1 = BatchNorm(64)
        self.layer3_nl: Optional[nn.Module] = None
        _stages(self, Bottleneck, layers, 4,
                lambda c: _nl_block(nl_type, c) if nl_nums and nl_type else None)
        side = input_size // 32 - pool_size + 1
        self.fc = Linear(2048 * side * side, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = max_pool(relu(self.bn1(self.conv1(x))), 3, 2, padding=1)
        x = avg_pool(_run_stages(self, x), self.pool_size, 1).flatten(1)
        if self.training and self.dropout_rate > 0:
            x = F.dropout(x, self.dropout_rate, training=True)
        return self.fc(x)


def _nl_block(nl_type: str, inplanes: int) -> nn.Module:
    half = inplanes // 2
    if nl_type == "nl":
        return SpatialNL(inplanes, half, use_scale=True)
    if nl_type == "cgnl":
        return SpatialCGNL(inplanes, half, use_scale=False, groups=8)
    if nl_type == "cgnlx":
        return SpatialCGNLx(inplanes, half, groups=8, order=3, use_scale=False)
    raise ValueError(f"unknown nl_type {nl_type!r}")
