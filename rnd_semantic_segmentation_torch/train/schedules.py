"""LR schedules, pure functions of the step or epoch (counterpart of the JAX
package's train/schedules.py).

  * poly: ``base * (1 - iter/max_iter)^power`` per iteration, the default
    LR_METHOD of the deeplab, gald and FADA loops;
  * step decay: ``base * rate^(epoch // decay_epoch)``;
  * warmup_cosine: linear warm-up ``(epoch+1)/warmup`` for epoch < warmup, then
    the closed form of cosine annealing with period ``t_max``;
  * gradual_warmup_cosine: the LR scaled by ``(mult-1)*epoch/total + 1`` while
    warming up, then cosine annealing on ``base*mult``.

They take Python numbers and return Python floats.
"""

from __future__ import annotations

import math
from typing import Callable


def poly_lr(base_lr: float, iteration, max_iter: int, power: float = 0.9) -> float:
    # clamped: an iteration count past max_iter (a resume, several optimizer
    # steps per batch) floors at 0 and never reaches negative**0.9
    return base_lr * max(1.0 - iteration / max_iter, 0.0) ** power


def step_decay_lr(base_lr: float, epoch, decay_rate: float = 0.1,
                  decay_epoch: int = 30) -> float:
    return base_lr * decay_rate ** (epoch // decay_epoch)


def warmup_cosine_lr(base_lr: float, epoch, t_max: int = 50,
                     warmup_epochs: int = 5, eta_min: float = 0.0) -> float:
    if epoch < warmup_epochs:
        return base_lr * (epoch + 1) / warmup_epochs
    offset = epoch - warmup_epochs
    return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * offset / t_max)) / 2


def gradual_warmup_cosine_lr(base_lr: float, epoch, multiplier: float = 8.0,
                             total_epoch: int = 5, t_max: int = 100,
                             eta_min: float = 0.0) -> float:
    if epoch <= total_epoch:
        return base_lr * ((multiplier - 1.0) * epoch / total_epoch + 1.0)
    target = base_lr * multiplier
    offset = epoch - total_epoch
    return eta_min + (target - eta_min) * (1 + math.cos(math.pi * offset / t_max)) / 2


def build_lr_schedule(cfg, steps_per_epoch: int) -> Callable:
    """``lr(iteration, epoch)`` from the SOLVER config (LR_METHOD dispatch)."""
    method = cfg.SOLVER.LR_METHOD
    base = cfg.SOLVER.BASE_LR
    if method == "poly":
        max_iter = cfg.SOLVER.EPOCHS * steps_per_epoch
        return lambda it, ep: poly_lr(base, it, max_iter, cfg.SOLVER.LR_POWER)
    if method == "step":
        return lambda it, ep: step_decay_lr(base, ep, cfg.SOLVER.DECAY_RATE,
                                            cfg.SOLVER.DECAY_EPOCH)
    if method == "warmup_cosine":
        return lambda it, ep: warmup_cosine_lr(base, ep)
    if method == "gradual_warmup":
        return lambda it, ep: gradual_warmup_cosine_lr(base, ep)
    raise NotImplementedError(method)
