"""Losses (counterpart of the JAX package's losses/__init__.py), on NCHW logits.

``cross_entropy`` is the loss of the gald and deeplab families;
``bce_with_logits`` and ``tversky_loss`` make up the attn family's (Tversky
with alpha 0.7 and eps 1, and BCE, at each of its five scales);
``soft_label_cross_entropy`` is FADA's discriminator and adversarial loss;
``structure_loss`` is the pranet family's, on each of its four maps.
``compound_loss`` (a weighted sum of losses) and ``generalized_dice_loss``
are the research utilities no family trains with.  Every reduction is in
float32, whatever the type of the logits.

``across_ranks=True`` (the train steps, in a world of more than one process)
makes the two losses that are not a mean of per-image terms global-batch
losses: ``cross_entropy`` divides by the count of valid pixels over every
rank, and ``tversky_loss`` sums tp, fn and fp over every rank before its
ratio.  Each is scaled so that the mean over the ranks of their gradients
is the gradient of the loss over the global batch, and so that the ranks'
mean of the values is its value.  BCE, the soft-label CE and the structure
loss are means over equal shards: the plain mean over the ranks is theirs.
In a world of one the flag changes nothing.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F

from ..ops import avg_pool
from ..parallel.dist import all_reduce_, all_reduce_sum, world_size


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: int = 255, across_ranks: bool = False) -> torch.Tensor:
    """Softmax CE, mean over the pixels whose label is not ``ignore_index``.

    logits ``[B,C,H,W]`` (any float type, promoted to float32), labels
    ``[B,H,W]`` integer.  The sum is divided by ``max(count_valid, 1)``, so a
    batch in which every pixel is ignored gives 0 and zero gradients, where
    ``F.cross_entropy(..., reduction="mean")`` would give NaN.  With
    ``across_ranks`` the count is the group's, and the rank's sum is
    weighted by the world size.
    """
    labels = labels.long()
    total = F.cross_entropy(logits.float(), labels, ignore_index=ignore_index,
                            reduction="sum")
    count = (labels != ignore_index).sum()
    world = world_size() if across_ranks else 1
    if world > 1:
        return total * world / all_reduce_(count).clamp(min=1)
    return total / count.clamp(min=1)


def bce_with_logits(pred: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid BCE over every element; ``label`` is a float target of
    ``pred``'s shape (soft at the edges of a resized one-hot mask)."""
    return F.binary_cross_entropy_with_logits(pred.float(), label.float())


def tversky_loss(pred: torch.Tensor, label: torch.Tensor, alpha: float = 0.7,
                 eps: float = 1.0, across_ranks: bool = False) -> torch.Tensor:
    """Tversky loss per class over (B, H, W), averaged over the classes.

    pred ``[B,C,H,W]`` logits, label ``[B,C,H,W]`` one-hot (or its resized,
    soft version).  ``1 - mean_c (tp + eps) / (tp + alpha*fn + (1-alpha)*fp + eps)``
    with the sigmoid probabilities, so false negatives weigh ``alpha``.
    With ``across_ranks`` the three sums span the group.
    """
    probs = torch.sigmoid(pred.float())
    label = label.float()
    dims = (0, 2, 3)
    tp = (probs * label).sum(dims)
    fn = (label * (1 - probs)).sum(dims)
    fp = (probs * (1 - label)).sum(dims)
    if across_ranks and world_size() > 1:
        tp, fn, fp = all_reduce_sum(torch.stack([tp, fn, fp])).unbind(0)
    return 1.0 - ((tp + eps) / (tp + alpha * fn + (1 - alpha) * fp + eps)).mean()


def soft_label_cross_entropy(pred: torch.Tensor, soft_label: torch.Tensor) -> torch.Tensor:
    """``-mean over pixels of sum_c soft_c * log_softmax(pred)_c``.

    pred and soft_label ``[B,C,H,W]``, the class axis dim 1; the mean runs
    over B, H and W."""
    per_pixel = -(soft_label.float() * F.log_softmax(pred.float(), dim=1)).sum(1)
    return per_pixel.mean()


def structure_loss(pred: torch.Tensor, mask: torch.Tensor,
                   paper_weighted_bce: bool = False) -> torch.Tensor:
    """PraNet's structure loss: a BCE term plus a weighted IoU, where the
    weight ``1 + 5 * |avg_pool(mask, 31, 1, 15) - mask|`` (padding counted)
    stresses the pixels near a boundary.

    pred ``[B,1,H,W]`` logits, mask ``[B,1,H,W]`` float.  The BCE term is
    the plain mean of the elementwise BCE by default: the reference calls
    ``binary_cross_entropy_with_logits(..., reduce='none')``, and a truthy
    ``reduce`` means a mean, so its later weighting divides a scalar by
    nothing.  ``paper_weighted_bce=True`` weights it per image as the paper
    means to.  The IoU is ``1 - (inter + 1) / (union - inter + 1)`` per image,
    and the loss is the mean over images of the two terms' sum.
    """
    pred, mask = pred.float(), mask.float()
    weit = 1.0 + 5.0 * (avg_pool(mask, 31, 1, padding=15) - mask).abs()
    bce = F.binary_cross_entropy_with_logits(pred, mask, reduction="none")
    dims = (1, 2, 3)
    wbce = ((weit * bce).sum(dims) / weit.sum(dims)) if paper_weighted_bce else bce.mean()
    p = torch.sigmoid(pred)
    inter = (p * mask * weit).sum(dims)
    union = ((p + mask) * weit).sum(dims)
    wiou = 1.0 - (inter + 1.0) / (union - inter + 1.0)
    return (wbce + wiou).mean()


def compound_loss(losses: Sequence[Callable[..., torch.Tensor]],
                  weights: Optional[Sequence[float]] = None) -> Callable[..., torch.Tensor]:
    """The weighted sum of ``losses``, each called on the same inputs; the
    weights default to 1/N each (attn/loss.py:42-64)."""
    if weights is None:
        weights = [1.0 / len(losses)] * len(losses)

    def fn(*inputs) -> torch.Tensor:
        return sum(w * loss_fn(*inputs) for loss_fn, w in zip(losses, weights))

    return fn


def generalized_dice_loss(output: torch.Tensor, target: torch.Tensor, eps: float = 1e-5,
                          weight_type: str = "square", ignore_label: int = 255) -> torch.Tensor:
    """The generalized Dice loss over the softmax of ``output``
    (utility.py:399-447).

    output ``[B,C,H,W]`` logits; target ``[B,H,W]`` labels, whose
    ``ignore_label`` pixels drop out of both sums, or a ``[B,C,H,W]`` one-hot.
    Each class weighs ``1 / (n_c^2 + eps)`` (``square``), ``1 / (n_c + eps)``
    (``identity``) or ``1 / (sqrt(n_c) + eps)`` (``sqrt``), with ``n_c`` the
    class's count in the target."""
    c = output.shape[1]
    out = F.softmax(output.float().permute(0, 2, 3, 1).reshape(-1, c), dim=-1)
    if target.dim() == 3:
        t = target.reshape(-1).long()
        valid = (t != ignore_label).unsqueeze(1)
        out = out * valid
        onehot = F.one_hot(torch.where(valid[:, 0], t, 0), c).float() * valid
    else:
        onehot = target.float().permute(0, 2, 3, 1).reshape(-1, c)
    target_sum = onehot.sum(0)
    if weight_type == "square":
        class_weights = 1.0 / (target_sum * target_sum + eps)
    elif weight_type == "identity":
        class_weights = 1.0 / (target_sum + eps)
    elif weight_type == "sqrt":
        class_weights = 1.0 / (torch.sqrt(target_sum) + eps)
    else:
        raise ValueError(f"bad weight_type {weight_type!r}")
    intersect_sum = ((out * onehot).sum(0) * class_weights).sum()
    denom_sum = ((out * out + onehot * onehot).sum(0) * class_weights).sum() + eps
    return 1.0 - 2.0 * intersect_sum / denom_sum
