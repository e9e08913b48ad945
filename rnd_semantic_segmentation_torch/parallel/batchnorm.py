"""BatchNorm with its statistics over every rank's shard of the batch
(counterpart of the JAX package's ``BatchNorm`` with ``axis_name``,
models/layers.py:156-209).

``nn.SyncBatchNorm`` is not used: it refuses CPU tensors once a process
group is up, and the gloo worlds of the CPU tests need them.

In training mode in a world of more than one, each rank takes E[x] and
E[x^2] over its shard in float32, whatever the input's type; one
gradient-carrying all-reduce averages them over the ranks (the shards are of
equal size, so this is the mean over the global batch); the variance is
``E[x^2] - E[x]^2``, as in the JAX module, and ``running_var`` takes its
unbiased form over the global count ``n * world``.  The output is
``(x - mean) * rsqrt(var + eps) * weight + bias`` computed in float32 and
returned in the input's type (the precision rule of models/layers.py).  In
a world of one, and in eval mode, the module is exactly ``nn.BatchNorm2d``
(whose variance is computed another way; the two agree to rounding).
"""

from __future__ import annotations

import torch
from torch import nn

from .dist import all_reduce_sum, world_size


class CrossRankBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with the same parameters, buffers and state-dict
    keys, whose training-mode statistics span every rank."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        world = world_size()
        if not self.training or world == 1:
            return super().forward(x)
        c = x.shape[1]
        xf = x.float()
        local = torch.cat([xf.mean(dim=(0, 2, 3)), (xf * xf).mean(dim=(0, 2, 3))])
        mean, mean2 = (all_reduce_sum(local) / world).split(c)
        var = mean2 - mean * mean
        if self.track_running_stats:
            with torch.no_grad():
                self.num_batches_tracked += 1
                momentum = (1.0 / float(self.num_batches_tracked) if self.momentum is None
                            else self.momentum)
                n = (x.numel() // c) * world
                unbiased = var * (n / max(n - 1, 1))
                self.running_mean.mul_(1 - momentum).add_(mean.detach(), alpha=momentum)
                self.running_var.mul_(1 - momentum).add_(unbiased.detach(), alpha=momentum)
        inv = torch.rsqrt(var + self.eps)
        if self.weight is not None:
            inv = inv * self.weight
        y = (xf - mean.view(1, c, 1, 1)) * inv.view(1, c, 1, 1)
        if self.bias is not None:
            y = y + self.bias.view(1, c, 1, 1)
        return y.to(x.dtype)


def convert_batchnorm(module: nn.Module) -> nn.Module:
    """Makes every ``nn.BatchNorm2d`` of ``module`` a ``CrossRankBatchNorm2d``
    in place, keeping its parameters, buffers and every reference to it (the
    class is swapped; the subclass adds no state).  ``FrozenBatchNorm2d`` is
    no ``nn.BatchNorm2d`` and stays as it is.  Returns ``module``."""
    for m in module.modules():
        if type(m) is nn.BatchNorm2d:
            m.__class__ = CrossRankBatchNorm2d
    return module
