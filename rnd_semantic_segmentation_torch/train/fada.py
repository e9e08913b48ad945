"""FADA adversarial domain-adaptation train step (counterpart of the JAX
package's train/fada.py).

One call runs the reference's three phases:

  1. the source forward in train mode and its segmentation loss: CE on
     ``outputs / 1.8`` for deeplab and gald, the five-scale Tversky + BCE on
     the raw outputs for attn, the structure loss on the four raw maps for
     pranet;
  2. the target forward in train mode (BatchNorm statistics chain on from the
     source forward) and the generator's adversarial loss
     ``ADV_WEIGHT * softCE(D(tgt_tap, tgt_size), [tgt_soft | 0])``; one
     backward of the sum reaches the segmentor's parameters only, where D is
     a constant (the reference zeroes D's gradients before D's own step);
     then one optimizer step per part;
  3. D's step on the taps of the pre-update forwards, detached:
     ``0.5 * softCE(D(src_tap), [src_soft | 0]) + 0.5 * softCE(D(tgt_tap), [0 | tgt_soft])``.

The soft labels are ``min(softmax(final / 1.8), 0.9)``, detached, where
``final`` is the first output (deeplab, attn; pranet's lateral map 5, not
the map 2 that eval reads, as in the JAX step) or out2, the last (gald).  A
1-channel ``final`` (pranet) gives ``[1 - sigmoid(final / 1.8),
sigmoid(final / 1.8)]``, clipped the same way.

Both domains are cast to MODEL.DTYPE, in which the segmentor and D compute
(D on the taps in that type); the soft labels and the four losses are
float32.  SOLVER.REMAT rematerialises the generator's loss (both forwards, D
on the target tap and the two losses) in its backward; D's own step reads
the taps and soft labels that the first run gave.

In a world of more than one process the segmentation loss spans the group
(``make_family_loss(..., across_ranks=True)``), the segmentor's gradients
are averaged over the ranks before its update and D's before D's, and the
four losses reported are the ranks' means.

LRs: poly per iteration on ``BASE_LR`` and ``BASE_LR_D`` for deeplab, gald
and pranet, warm-up cosine per epoch on both for attn, each segmentor part at its
``lr_mults``.  Like the JAX step it reads neither LR_METHOD, LR_BATCH_REF,
WARMUP_ITERS, ACCUM_STEPS nor GRAD_CLIP.  D trains with Adam (betas 0.9,
0.99, eps 1e-8, no weight decay), the parts with ``make_optimizers``'.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from .. import losses
from ..models.remat import remat_wrap
from ..parallel.dist import average_gradients, mean_over_ranks, world_size
from .schedules import poly_lr, warmup_cosine_lr
from .segmentor import Segmentor
from .state import TrainState, apply_updates, make_optimizer
from ..utils.device import compute_dtype
from .steps import check_step_knobs, make_family_loss, step_seed

TEMPERATURE = 1.8
SOFT_CLIP = 0.9
DISC_PART = "model_D"  # D's name in the train state and in a checkpoint


def make_disc_optimizer(disc: nn.Module) -> torch.optim.Optimizer:
    return make_optimizer("adam", disc.parameters(), betas=(0.9, 0.99))


def _soft_label(final: torch.Tensor) -> torch.Tensor:
    z = final.detach().float() / TEMPERATURE
    if z.shape[1] == 1:
        p = torch.sigmoid(z)
        soft = torch.cat([1.0 - p, p], dim=1)
    else:
        soft = torch.softmax(z, dim=1)
    return soft.clamp(max=SOFT_CLIP)


def make_fada_train_step(segmentor: Segmentor, disc: nn.Module, cfg,
                         steps_per_epoch: int, state: TrainState,
                         seed: Optional[int] = None) -> Callable:
    """Returns ``step(src_batch, tgt_batch, epoch0) -> metrics``, the floats
    ``loss_seg``, ``loss_adv_tgt``, ``loss_D_src``, ``loss_D_tgt``, ``lr``
    and ``lr_D``; it updates the segmentor, D, ``state.optimizers`` (the
    parts' and D's under ``DISC_PART``) and ``state.step`` in place.

    Batches are ``{"image": [B,H,W,3] float, "label": [B,H,W] int}`` on the
    segmentor's device; the target's label is not read.  The step's
    ``torch.Generator`` (attn drop-connect) is seeded with
    ``step_seed(seed, state.step)`` before each of the two forwards, so both
    domains draw the same masks, as both JAX forwards take one key.
    """
    check_step_knobs(cfg)
    spec = segmentor.spec
    loss_fn = make_family_loss(spec, cfg.MODEL.NUM_CLASSES, cfg.INPUT.IGNORE_LABEL,
                               across_ranks=world_size() > 1)
    adv_weight = float(cfg.SOLVER.ADV_WEIGHT)
    max_iter = cfg.SOLVER.EPOCHS * steps_per_epoch
    epoch_sched = spec.family == "attn"
    raw_outputs = spec.family in ("attn", "pranet")  # 1.8 shapes the soft labels only

    def lr_at(base, it, epoch0):
        if epoch_sched:
            return warmup_cosine_lr(base, epoch0)
        return poly_lr(base, it, max_iter, cfg.SOLVER.LR_POWER)

    final = (lambda outs: outs[-1]) if spec.family == "gald" else (lambda outs: outs[0])
    seg_params = [p for m in spec.modules.values() for p in m.parameters()]
    seed = cfg.SEED if seed is None else seed
    generator = torch.Generator(device=seg_params[0].device)
    dtype = compute_dtype(cfg)

    def forward(x):
        generator.manual_seed(step_seed(seed, state.step))
        outputs, tap = segmentor(x, label_size=x.shape[-2:], train=True, generator=generator)
        return outputs, tap

    def gen_loss(src_x, src_label, tgt_x):
        src_outputs, src_tap = forward(src_x)
        scaled = src_outputs if raw_outputs else tuple(o / TEMPERATURE for o in src_outputs)
        loss_seg = loss_fn(scaled, src_label)
        src_soft = _soft_label(final(src_outputs))
        tgt_outputs, tgt_tap = forward(tgt_x)
        tgt_soft = _soft_label(final(tgt_outputs))
        loss_adv = adv_weight * losses.soft_label_cross_entropy(
            disc(tgt_tap, tgt_x.shape[-2:]),
            torch.cat([tgt_soft, torch.zeros_like(tgt_soft)], dim=1))
        return loss_seg + loss_adv, loss_seg, loss_adv, src_tap, tgt_tap, src_soft, tgt_soft

    gen_loss = remat_wrap(gen_loss, cfg, tuple(spec.modules.values()) + (disc,), generator)

    def step_fn(src_batch: Dict[str, torch.Tensor], tgt_batch: Dict[str, torch.Tensor],
                epoch0) -> Dict[str, float]:
        for opt in state.optimizers.values():
            opt.zero_grad(set_to_none=True)
        src_x, tgt_x = (b["image"].to(dtype).permute(0, 3, 1, 2).contiguous()
                        for b in (src_batch, tgt_batch))
        src_size, tgt_size = tuple(src_x.shape[-2:]), tuple(tgt_x.shape[-2:])
        total, loss_seg, loss_adv, src_tap, tgt_tap, src_soft, tgt_soft = gen_loss(
            src_x, src_batch["label"], tgt_x)
        zeros = torch.zeros_like(tgt_soft)
        # inputs=: D is a constant of the generator's loss, its .grad stays empty
        total.backward(inputs=seg_params)
        for module in spec.modules.values():
            average_gradients(module.parameters())
        it = float(state.step)
        lr = lr_at(cfg.SOLVER.BASE_LR, it, epoch0)
        for name in spec.modules:
            apply_updates(state.optimizers[name], lr * spec.lr_mults[name])

        src_tap, tgt_tap = src_tap.detach(), tgt_tap.detach()
        loss_d_src = 0.5 * losses.soft_label_cross_entropy(
            disc(src_tap, src_size), torch.cat([src_soft, torch.zeros_like(src_soft)], dim=1))
        loss_d_tgt = 0.5 * losses.soft_label_cross_entropy(
            disc(tgt_tap, tgt_size), torch.cat([zeros, tgt_soft], dim=1))
        (loss_d_src + loss_d_tgt).backward()
        average_gradients(disc.parameters())
        lr_d = lr_at(cfg.SOLVER.BASE_LR_D, it, epoch0)
        apply_updates(state.optimizers[DISC_PART], lr_d)
        state.step += 1
        values = mean_over_ranks(torch.stack([
            loss_seg.detach(), loss_adv.detach(), loss_d_src.detach(),
            loss_d_tgt.detach()])).tolist()  # one device sync
        return dict(zip(("loss_seg", "loss_adv_tgt", "loss_D_src", "loss_D_tgt"), values),
                    lr=lr, lr_D=lr_d)

    return step_fn
