"""Online self-distillation train step (counterpart of
``make_online_distill_step`` in the JAX package's train/distill.py).

A frozen teacher, a second ``Segmentor`` of the same spec, labels each batch
inside the step: its logits (``outputs[-1]`` for gald and pranet, the last
decoder head and lateral map 2; ``outputs[0]`` for deeplab and attn) at the
image's size become pseudo-labels, and the student takes one train step on
them.  Softmax heads: the argmax of a float32 softmax, with its maximum
probability as the confidence.  A 1-channel sigmoid head (pranet): ``p >=
0.5``, with ``max(p, 1 - p)`` as the confidence.  Above a threshold of 0,
a pixel whose confidence is below it becomes INPUT.IGNORE_LABEL; only the
cross-entropy families (deeplab, gald) take one, as only their losses
ignore a label.

The image is cast to MODEL.DTYPE before the teacher's forward, so the
teacher computes in it too (on the card the attn teacher's fused MBConv
kernel then runs in bfloat16); the pseudo-labels come from a float32 softmax
or sigmoid.  SOLVER.REMAT rematerialises the student's forward and loss.

In a world of more than one process the student's CE or Tversky loss spans
the group, its gradients are averaged over the ranks before its update and
the reported loss is the ranks' mean; the teacher labels each rank's shard.

The student's step is the JAX online step, not the port's source step: no
gradient clamp (pranet's 0.5 is absent, SOLVER.GRAD_CLIP is not read), no
SOLVER.ACCUM_STEPS micro-batches, and the LR ``lr_sched(state.step,
epoch0)`` times each part's ``spec.lr_mults``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..models.remat import remat_wrap
from ..parallel.dist import average_gradients, mean_over_ranks, world_size
from .segmentor import Segmentor
from .state import TrainState, apply_updates
from ..utils.device import compute_dtype
from .steps import check_step_knobs, make_family_loss, make_lr_schedule, step_seed

THRESHOLDLESS_FAMILIES = ("pranet", "attn", "attnwrap")


def teacher_logits(teacher: Segmentor, x: torch.Tensor) -> torch.Tensor:
    """The teacher's eval-mode logits [B,C,H,W] at the size of ``x`` (NCHW)."""
    outputs, _ = teacher(x, label_size=tuple(x.shape[2:]), train=False)
    return outputs[-1] if teacher.spec.family in ("gald", "pranet") else outputs[0]


def pseudo_labels(logits: torch.Tensor, threshold: float = 0.0,
                  ignore_label: int = 255) -> torch.Tensor:
    """[B,C,H,W] logits -> [B,H,W] int32 pseudo-labels (see the module's
    docstring)."""
    if logits.shape[1] == 1:
        p = torch.sigmoid(logits[:, 0].float())
        pseudo = (p >= 0.5).to(torch.int32)
        conf = torch.maximum(p, 1.0 - p)
    else:
        probs = torch.softmax(logits.float(), dim=1)
        pseudo = torch.argmax(probs, dim=1).to(torch.int32)
        conf = probs.amax(dim=1)
    if threshold > 0:
        pseudo = torch.where(conf >= threshold, pseudo, ignore_label)
    return pseudo


def make_online_distill_step(segmentor: Segmentor, cfg, steps_per_epoch: int,
                             state: TrainState, teacher: Segmentor,
                             confidence_threshold: float = 0.0,
                             seed: Optional[int] = None) -> Callable:
    """Returns ``step(batch, epoch0) -> {"loss", "lr"}``, built like
    ``make_src_train_step``: it updates the student ``segmentor``,
    ``state.optimizers`` and ``state.step`` in place.  ``teacher`` is put in
    eval mode with its parameters frozen; its forward runs under
    ``no_grad`` (so the fused MBConv kernel may run in it).  Drop-connect
    draws from the step's generator, seeded with ``step_seed(seed,
    state.step)`` (``seed`` defaults to ``cfg.SEED``).  A threshold above 0
    on pranet, attn or attnwrap raises ``ValueError``: their losses have no
    ignore label."""
    spec = segmentor.spec
    if confidence_threshold > 0 and spec.family in THRESHOLDLESS_FAMILIES:
        raise ValueError(
            f"DISTILL.CONFIDENCE_THRESHOLD is not supported for the {spec.family} family: "
            f"its loss has no ignore-label mechanism")
    check_step_knobs(cfg)
    loss_fn = make_family_loss(spec, cfg.MODEL.NUM_CLASSES, cfg.INPUT.IGNORE_LABEL,
                               across_ranks=world_size() > 1)
    lr_sched = make_lr_schedule(spec, cfg, steps_per_epoch)
    ignore = cfg.INPUT.IGNORE_LABEL
    seed = cfg.SEED if seed is None else seed
    teacher.eval().requires_grad_(False)
    device = next(segmentor.parameters()).device
    generator = torch.Generator(device=device)
    dtype = compute_dtype(cfg)

    def student_loss(x, pseudo):
        outputs, _ = segmentor(x, label_size=tuple(pseudo.shape[1:3]), train=True,
                               generator=generator)
        return loss_fn(outputs, pseudo)

    student_loss = remat_wrap(student_loss, cfg, spec.modules.values(), generator)

    def step_fn(batch: Dict[str, torch.Tensor], epoch0) -> Dict[str, float]:
        x = batch["image"].to(dtype).permute(0, 3, 1, 2).contiguous()
        with torch.no_grad():
            pseudo = pseudo_labels(teacher_logits(teacher, x), confidence_threshold, ignore)
        for opt in state.optimizers.values():
            opt.zero_grad(set_to_none=True)
        generator.manual_seed(step_seed(seed, state.step))
        loss = student_loss(x, pseudo)
        loss.backward()
        for module in spec.modules.values():
            average_gradients(module.parameters())
        lr = lr_sched(float(state.step), epoch0)
        for name, opt in state.optimizers.items():
            apply_updates(opt, lr * spec.lr_mults[name])
        state.step += 1
        return {"loss": float(mean_over_ranks(loss.detach())), "lr": lr}

    return step_fn
