"""Optimizers and the train state (counterpart of the JAX package's train/state.py).

The reference keeps a separate optimizer per model part, each with its own LR
(the decoder or classifier at 10x the backbone), and checkpoints are keyed by
part.  The port mirrors that: ``TrainState.optimizers`` holds one
``torch.optim`` optimizer per part of the ``SegmentorSpec``.

  * SGD(momentum, weight_decay): g += wd*p; v = mu*v + g; p -= lr*v
  * Adam(betas, eps[, weight_decay as L2]): bias-corrected moments,
    ``m_hat / (sqrt(v_hat) + eps)``

The LR is written into the param group every iteration (the reference rewrites
``param_group['lr']`` each step), so the optimizers are built with LR 0 and
``apply_updates`` sets ``lr * lr_mult`` before it steps.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Tuple

import torch


@dataclasses.dataclass
class TrainState:
    optimizers: Dict[str, torch.optim.Optimizer]
    step: int = 0          # global iteration counter


def make_optimizer(kind: str, params: Iterable[torch.nn.Parameter],
                   momentum: float = 0.9, weight_decay: float = 0.0,
                   betas: Tuple[float, float] = (0.9, 0.999),
                   eps: float = 1e-8) -> torch.optim.Optimizer:
    params = list(params)
    if kind == "sgd":
        return torch.optim.SGD(params, lr=0.0, momentum=momentum,
                               weight_decay=weight_decay)
    if kind == "adam":
        return torch.optim.Adam(params, lr=0.0, betas=betas, eps=eps,
                                weight_decay=weight_decay)
    raise NotImplementedError(kind)


def make_optimizers(spec, cfg) -> Dict[str, torch.optim.Optimizer]:
    """One optimizer per part.  Adam families take no weight decay, except
    attn; SGD families take SOLVER.MOMENTUM and SOLVER.WEIGHT_DECAY."""
    opts = {}
    for name, module in spec.modules.items():
        if spec.optimizer == "sgd":
            opts[name] = make_optimizer("sgd", module.parameters(),
                                        momentum=cfg.SOLVER.MOMENTUM,
                                        weight_decay=cfg.SOLVER.WEIGHT_DECAY)
        else:
            wd = cfg.SOLVER.WEIGHT_DECAY if spec.family in ("attn", "attnwrap") else 0.0
            opts[name] = make_optimizer("adam", module.parameters(), weight_decay=wd)
    return opts


def apply_updates(optimizer: torch.optim.Optimizer, lr: float,
                  grad_clip: float = 0.0) -> None:
    """One optimizer step at this iteration's LR, after an elementwise clamp
    of the gradients to [-grad_clip, grad_clip] when ``grad_clip > 0``."""
    for group in optimizer.param_groups:
        group["lr"] = lr
        if grad_clip:
            for p in group["params"]:
                if p.grad is not None:
                    p.grad.clamp_(-grad_clip, grad_clip)
    optimizer.step()
