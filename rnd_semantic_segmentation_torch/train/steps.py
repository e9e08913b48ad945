"""Source-supervised train step (counterpart of the JAX package's train/steps.py).

One call does the forward in train mode, the family's loss, the backward and
one optimizer step per part at this iteration's LR.

Loss wiring per family:
  * deeplab: CE(ignore=255) on the ASPP output at the label size.
  * gald: deep supervision, CE(ignore=255) on the four heads weighted
    1.0/0.8/0.6/0.4 on (out2, out3, out4, out5).
  * attn, attnwrap: the sum over the five outputs (scales 1 to 1/16) of
    0.5*Tversky + 0.5*BCE against the one-hot labels resized bilinearly
    (align_corners=False) to each output's size; an ignored pixel (255) has
    a one-hot row of zeros, as ``jax.nn.one_hot`` gives it.
  * pranet: the sum over the four lateral maps of ``structure_loss``
    against the label cast to a float mask ``[B,1,H,W]``; the step clamps
    each gradient element to [-0.5, 0.5] (SOLVER.GRAD_CLIP, when set,
    instead).

Precision (MODEL.DTYPE, float32 or bfloat16): the step casts the image to it
and the model computes in it (models/layers.py); parameters, their gradients,
the optimizer's state and every loss stay float32.  SOLVER.REMAT (none, full,
dots) rematerialises each micro-batch's forward and loss in the backward
(models/remat.py ``remat_wrap``).

In a world of more than one process (parallel/dist.py) each rank steps on
its slice of the global batch: the CE and Tversky losses span the group
(``make_family_loss(..., across_ranks=True)``), each part's gradients are
averaged over the ranks after the backward and before the clamp and the
optimizer, and the reported loss is the ranks' mean, the global batch's.
Under SOLVER.ACCUM_STEPS micro-batch i is the union of the ranks' i-th
slices of their shards.

LR schedules follow the reference trainers: poly per iteration for deeplab and
gald, per-epoch warm-up and cosine for pranet and attn whatever
SOLVER.LR_METHOD says.  Head parts get their 10x through ``spec.lr_mults``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from .. import losses
from ..models.remat import remat_mode, remat_wrap
from ..ops import resize_bilinear
from ..parallel.dist import average_gradients, mean_over_ranks, world_size
from ..utils.device import compute_dtype
from ..utils.seeding import mix_seed
from .schedules import (
    gradual_warmup_cosine_lr,
    poly_lr,
    step_decay_lr,
    warmup_cosine_lr,
)
from .segmentor import Segmentor
from .state import TrainState, apply_updates


def make_family_loss(spec, num_classes: int, ignore_label: int = 255,
                     across_ranks: bool = False) -> Callable:
    """``loss_fn(outputs, label)``; ``across_ranks`` makes CE and Tversky
    global-batch losses over the process group (losses/__init__.py)."""
    fam = spec.family

    def ce(logits, label):
        return losses.cross_entropy(logits, label, ignore_label, across_ranks=across_ranks)

    if fam == "deeplab":
        def loss_fn(outputs, label):
            return ce(outputs[0], label)
        return loss_fn
    if fam == "gald":
        def loss_fn(outputs, label):
            out5, out4, out3, out2 = outputs
            return (ce(out2, label) * 1.0 + ce(out3, label) * 0.8
                    + ce(out4, label) * 0.6 + ce(out5, label) * 0.4)
        return loss_fn
    if fam in ("attn", "attnwrap"):
        def loss_fn(outputs, label):
            classes = torch.arange(num_classes, device=label.device).view(1, -1, 1, 1)
            onehot = (label.long().unsqueeze(1) == classes).float()
            total = torch.zeros((), dtype=torch.float32, device=label.device)
            for out in outputs:  # scales 1, 1/2, 1/4, 1/8, 1/16
                scaled = resize_bilinear(onehot, out.shape[-2:])
                total = total + 0.5 * losses.tversky_loss(out, scaled,
                                                          across_ranks=across_ranks) \
                              + 0.5 * losses.bce_with_logits(out, scaled)
            return total
        return loss_fn
    if fam == "pranet":
        def loss_fn(outputs, label):
            mask = label.unsqueeze(1).float()
            total = losses.structure_loss(outputs[0], mask)
            for out in outputs[1:]:
                total = total + losses.structure_loss(out, mask)
            return total
        return loss_fn
    raise NotImplementedError(fam)


def step_seed(seed: int, step: int) -> int:
    """The seed of one step's drop-connect draws: a pure function of
    ``(seed, step)``, as ``jax.random.fold_in(key, step)`` is in the JAX
    step, so a resumed run draws what the uninterrupted one drew
    (``utils.seeding.mix_seed``)."""
    return mix_seed(seed, step)


def make_lr_schedule(spec, cfg, steps_per_epoch: int) -> Callable:
    """``lr(iteration, epoch0)`` with epoch0 the 0-based epoch.

    The family comes first: pranet and attn have fixed schedules whatever
    SOLVER.LR_METHOD says.  SOLVER.LR_BATCH_REF > 0 scales the base LR
    linearly with the batch size, and SOLVER.WARMUP_ITERS > 0 puts a linear
    ramp per iteration on top of whatever the family uses."""
    fam = spec.family
    base = cfg.SOLVER.BASE_LR
    method = cfg.SOLVER.LR_METHOD
    ref_batch = int(cfg.SOLVER.LR_BATCH_REF or 0)
    if ref_batch > 0:
        base = base * cfg.SOLVER.BATCH_SIZE / ref_batch
    if fam == "pranet":
        sched = lambda it, ep0: gradual_warmup_cosine_lr(base, ep0)
    elif fam in ("attn", "attnwrap"):
        sched = lambda it, ep0: warmup_cosine_lr(base, ep0)
    elif method == "poly":
        max_iter = cfg.SOLVER.EPOCHS * steps_per_epoch
        sched = lambda it, ep0: poly_lr(base, it, max_iter, cfg.SOLVER.LR_POWER)
    elif method == "step":
        sched = lambda it, ep0: step_decay_lr(base, ep0, cfg.SOLVER.DECAY_RATE,
                                              cfg.SOLVER.DECAY_EPOCH)
    else:
        raise NotImplementedError(method)
    warmup_iters = int(cfg.SOLVER.WARMUP_ITERS or 0)
    if warmup_iters <= 0:
        return sched
    return lambda it, ep0: sched(it, ep0) * min(1.0, (it + 1.0) / warmup_iters)


def check_step_knobs(cfg) -> None:
    """MODEL.DTYPE and SOLVER.REMAT must be values the port takes
    (``compute_dtype``, ``remat_mode``)."""
    compute_dtype(cfg)
    remat_mode(cfg)


def make_src_train_step(segmentor: Segmentor, cfg, steps_per_epoch: int,
                        state: TrainState, seed: Optional[int] = None) -> Callable:
    """Returns ``step(batch, epoch0) -> {"loss", "lr"}``; it updates the
    segmentor's parameters and BN statistics, ``state.optimizers`` and
    ``state.step`` in place.

    batch: ``{"image": [B,H,W,3] float, "label": [B,H,W] int}`` tensors on the
    segmentor's device, in the loader's NHWC layout.  The image is cast to
    MODEL.DTYPE, in which the model computes; the loss is float32.

    The step owns a ``torch.Generator`` on the segmentor's device, which the
    attn families' drop-connect draws from: it is seeded with
    ``step_seed(seed, state.step)`` at the start of every step (``seed``
    defaults to ``cfg.SEED``, as the JAX step's ``base_rng`` does).
    """
    check_step_knobs(cfg)
    spec = segmentor.spec
    loss_fn = make_family_loss(spec, cfg.MODEL.NUM_CLASSES, cfg.INPUT.IGNORE_LABEL,
                               across_ranks=world_size() > 1)
    lr_sched = make_lr_schedule(spec, cfg, steps_per_epoch)
    grad_clip = cfg.SOLVER.GRAD_CLIP or (0.5 if spec.family == "pranet" else 0.0)
    accum = max(int(cfg.SOLVER.ACCUM_STEPS), 1)
    seed = cfg.SEED if seed is None else seed
    device = next(segmentor.parameters()).device
    generator = torch.Generator(device=device)
    dtype = compute_dtype(cfg)

    def micro_loss(xs, ys):
        outputs, _ = segmentor(xs, label_size=ys.shape[1:3], train=True, generator=generator)
        return loss_fn(outputs, ys) / accum

    micro_loss = remat_wrap(micro_loss, cfg, spec.modules.values(), generator)

    def step_fn(batch: Dict[str, torch.Tensor], epoch0) -> Dict[str, float]:
        x = batch["image"].to(dtype).permute(0, 3, 1, 2).contiguous()
        label = batch["label"]
        for opt in state.optimizers.values():
            opt.zero_grad(set_to_none=True)
        # micro-batches: gradients are averaged and BN statistics chain from
        # one to the next (a bigger batch at 1/accum of the activation memory)
        b = x.shape[0] // accum
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        generator.manual_seed(step_seed(seed, state.step))
        for i in range(accum):
            loss = micro_loss(x[i * b:(i + 1) * b], label[i * b:(i + 1) * b])
            loss.backward()
            total += loss.detach()
        for module in spec.modules.values():
            average_gradients(module.parameters())
        lr = lr_sched(float(state.step), epoch0)
        for name, opt in state.optimizers.items():
            apply_updates(opt, lr * spec.lr_mults[name], grad_clip=grad_clip)
        state.step += 1
        return {"loss": float(mean_over_ranks(total)), "lr": lr}

    return step_fn
