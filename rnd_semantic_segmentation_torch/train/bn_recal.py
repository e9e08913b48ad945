"""BatchNorm running statistics re-estimated over a few batches (counterpart
of the JAX package's train/bn_recal.py; ``torch.optim.swa_utils.update_bn``
does the same).

A short run from random weights leaves the running statistics far from the
batch statistics the model trained with: the EfficientNet encoder's
momentum of 0.01 converges over hundreds of steps.  Every ``nn.BatchNorm2d``
running mean and variance becomes the plain average, over the batches, of
each batch's statistics (the variance the unbiased one, which is what torch
and the JAX package keep), whatever the layer's momentum: each momentum is
set to ``None`` (torch's cumulative average) after ``reset_running_stats``,
train-mode forwards run under ``no_grad``, then the momenta, the counters
``num_batches_tracked`` and the module's mode are restored.  The counters
end where they were, as the JAX package has none to move.  A
``FrozenBatchNorm2d``'s buffers are not touched, nor those of a BatchNorm
that no train-mode forward reached (the JAX package keeps a leaf whose
probed momentum is 0).
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch
from torch import nn


@torch.no_grad()
def recalibrate_batch_stats(segmentor, batches: Iterable,
                            generator: Optional[torch.Generator] = None,
                            seed: int = 0) -> int:
    """Re-estimates the running statistics of ``segmentor``'s BatchNorms in
    place over ``batches`` ([B,H,W,3] images or ``{"image": ...}`` dicts,
    NHWC as the loader gives them, on the segmentor's device).  Drop-connect
    draws from ``generator``, reseeded with ``seed`` before each forward (the
    JAX function passes one key to every forward).  The forwards run in the
    batches' type (MODEL.DTYPE after the device augmentation, float32 from
    the loader), as the JAX function's do.  Returns the number of batches."""
    images = [(b["image"] if isinstance(b, dict) else b) for b in batches]
    if not images:
        return 0
    norms = [m for m in segmentor.modules() if isinstance(m, nn.BatchNorm2d)]
    saved = [(m.momentum, m.running_mean.clone(), m.running_var.clone(),
              m.num_batches_tracked.clone()) for m in norms]
    was_training = segmentor.training
    for m in norms:
        m.reset_running_stats()
        m.momentum = None
    try:
        for image in images:
            x = image.permute(0, 3, 1, 2).contiguous()
            if generator is not None:
                generator.manual_seed(seed)
            segmentor(x, train=True, generator=generator)
    finally:
        for m, (momentum, mean, var, tracked) in zip(norms, saved):
            if int(m.num_batches_tracked) == 0:  # no forward reached it
                m.running_mean.copy_(mean)
                m.running_var.copy_(var)
            m.momentum = momentum
            m.num_batches_tracked.copy_(tracked)
        segmentor.train(was_training)
    return len(images)
