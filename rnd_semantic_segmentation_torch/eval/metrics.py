"""Evaluation metrics on the model's device (counterpart of the JAX package's
eval/metrics.py).

  * ``intersection_and_union`` — intersection, union, target and output areas
    per class, with the ignore label masked out of all four;
  * ``confusion_matrix`` — one ``torch.bincount`` on ``K*true + pred``;
  * ``AverageMeter`` — macro and micro mIoU/F1 accumulation on the host:
    macro averages each update's IoU/F1, micro accumulates the global areas.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def intersection_and_union(output: torch.Tensor, target: torch.Tensor, num_classes: int,
                           ignore_index: int = 255) -> Tuple[torch.Tensor, ...]:
    """Areas (intersection, union, target, output), each [num_classes] float32.

    ``output`` and ``target`` are integer class maps of one shape (any rank).
    Pixels whose target is ``ignore_index`` count in none of the areas.
    """
    output = output.reshape(-1).long()
    target = target.reshape(-1).long()
    valid = target != ignore_index

    def area(classes, keep):
        # pixels to leave out, and classes past the last, fall into a spare bin
        keep = keep & (classes >= 0) & (classes < num_classes)
        binned = torch.where(keep, classes, torch.full_like(classes, num_classes))
        return torch.bincount(binned, minlength=num_classes + 1)[:num_classes].float()

    area_out, area_tgt = area(output, valid), area(target, valid)
    area_inter = area(output, valid & (output == target))
    return area_inter, area_out + area_tgt - area_inter, area_tgt, area_out


def confusion_matrix(pred: torch.Tensor, target: torch.Tensor, num_classes: int,
                     ignore_index: int = 255) -> torch.Tensor:
    """[C,C] int64 confusion matrix (rows = true, cols = predicted)."""
    pred = pred.reshape(-1).long()
    target = target.reshape(-1).long()
    valid = target != ignore_index
    idx = torch.where(valid, target * num_classes + pred,
                      torch.full_like(target, num_classes * num_classes))
    counts = torch.bincount(idx, minlength=num_classes * num_classes + 1)
    return counts[:num_classes * num_classes].reshape(num_classes, num_classes)


class AverageMeter:
    """Macro+micro IoU/F1 accumulator (host side, numpy)."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.reset()

    def reset(self):
        z = np.zeros(self.num_classes, np.float64)
        self.intersection_sum = z.copy()
        self.union_sum = z.copy()
        self.target_sum = z.copy()
        self.res_sum = z.copy()
        self.iou_sum = z.copy()
        self.f1_sum = z.copy()
        self.count = 0

    def update(self, intersection, union, target, res):
        intersection, union, target, res = (
            np.asarray(a, np.float64) for a in (intersection, union, target, res))
        self.intersection_sum += intersection
        self.union_sum += union
        self.target_sum += target
        self.res_sum += res
        self.iou_sum += intersection / (union + 1e-10)
        self.f1_sum += 2 * intersection / (target + res + 1e-10)
        self.count += 1

    @property
    def macro_iou(self):
        return self.iou_sum / max(self.count, 1)

    @property
    def macro_f1(self):
        return self.f1_sum / max(self.count, 1)

    @property
    def micro_iou(self):
        return self.intersection_sum / (self.union_sum + 1e-10)

    @property
    def micro_f1(self):
        return 2 * self.intersection_sum / (self.target_sum + self.res_sum + 1e-10)

    @property
    def micro_precision(self):
        return self.intersection_sum / (self.res_sum + 1e-10)  # TP / (TP + FP)

    @property
    def micro_recall(self):
        return self.intersection_sum / (self.target_sum + 1e-10)  # TP / (TP + FN)

    def summary(self, logger=None):
        lines = [
            "Macro metric, val result: mIoU/mF1 {:.4f}/{:.4f}.".format(
                float(np.mean(self.macro_iou)), float(np.mean(self.macro_f1))),
            "Micro metric, val result: mIoU/mF1 {:.4f}/{:.4f}.".format(
                float(np.mean(self.micro_iou)), float(np.mean(self.micro_f1))),
        ]
        for i in range(self.num_classes):
            lines.append("Macro metric, class {} iou/f1 score: {:.4f}/{:.4f}.".format(
                i, self.macro_iou[i], self.macro_f1[i]))
            lines.append("Micro metric, class {} iou/f1 score: {:.4f}/{:.4f}.".format(
                i, self.micro_iou[i], self.micro_f1[i]))
        if logger is not None:
            for line in lines:
                logger.info(line)
        return {
            "macro_miou": float(np.mean(self.macro_iou)),
            "macro_mf1": float(np.mean(self.macro_f1)),
            "micro_miou": float(np.mean(self.micro_iou)),
            "micro_mf1": float(np.mean(self.micro_f1)),
            "micro_precision": float(np.mean(self.micro_precision)),
            "micro_recall": float(np.mean(self.micro_recall)),
            "per_class_macro_iou": self.macro_iou.tolist(),
            "per_class_macro_f1": self.macro_f1.tolist(),
        }
