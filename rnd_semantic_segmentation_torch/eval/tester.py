"""Evaluation loop and probability heads (counterpart of the JAX package's
eval/tester.py).

One loop for every ported family; the families differ in the probability head:
  * deeplab — the ASPP output -> bilinear (align_corners=True) to the label
    size -> softmax over classes; ``TEST.MULTI_SCALE`` (over
    ``TEST.SCALES``, with mirrors when ``TEST.FLIP_TTA``) or else
    ``TEST.FLIP_TTA`` averages test-time augmentations (eval/tta.py), which
    take one image a batch and raise ``ValueError`` on more;
  * gald — decoder ``out2`` -> bilinear (align_corners=False) to the label
    size -> softmax over classes;
  * attn and attnwrap — ``sigmoid(out_0)`` in float32, one channel per
    class; the mask is its argmax;
  * pranet — lateral map 2 (the last output) -> bilinear
    (align_corners=False) to the label size -> sigmoid -> min-max
    normalised over the whole batch -> ``[1 - p, p]``.  The minimum and
    maximum are the batch's, so one image's probabilities depend on the
    others in its batch, as in the JAX package.  ``test()`` pads no batch,
    so its statistics are the JAX ones over the valid rows; the server's
    zero rows of a padded bucket take part, as they do in the JAX server
    (``TEST.BATCH_SIZE 1``, or ``--max-batch 1``, makes each mask depend on
    its own image alone).

``Tester(cfg, logger)`` is what the serving daemon builds: the model on its
device, the checkpoint loader for reference-layout ``.pth`` files and the
trainer's checkpoints (``resume <file.pth>``; ``resume latest`` or an empty
``resume`` takes the newest ``{Prefix}-N.pth`` in OUTPUT_DIR), and
``_probs_impl``.  With a ``test_loader``, ``test()`` runs the metric loop:
batches go to the device through the loader's prefetch, the argmax, the
per-class areas and the confusion matrix are computed there, and their small
results are fetched once after the loop; the summary (macro and micro
mIoU/F1) is logged and ``<family>_confusion_matrix.json`` is written to
OUTPUT_DIR.  With ``saveres`` each image's argmax is also written as a
palette PNG (the render config's ``palette``) to
``PSEUDO_DIR/inference/<DATASETS.TEST>/<name>.png``, at the label's size: the
pseudo-labels of self-distillation.  Quantized eval raises until its slice
is ported; the confusion-matrix heat map and multi-device eval are not
ported.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ckpt.checkpoint_io import latest_checkpoint
from ..ckpt.torch_import import load_part, load_reference_checkpoint
from ..data.loader import device_prefetch
from ..models.build import build_segmentor
from ..ops import resize_bilinear
from ..train.segmentor import Segmentor
from ..utils import dump_json, resolve_device
from . import tta
from .metrics import AverageMeter, confusion_matrix, intersection_and_union
from .palette import save_pseudo_label


class Tester:
    __test__ = False  # not a pytest class

    def __init__(self, cfg, logger, test_loader=None,
                 trainid2name: Optional[Dict] = None, saveres: bool = False,
                 palette: Optional[Sequence[int]] = None):
        if saveres and palette is None:
            raise ValueError("saveres writes palette PNGs: pass the render config's palette")
        self.cfg = cfg
        self.logger = logger
        self.test_loader = test_loader
        self.trainid2name = trainid2name or {}
        self.saveres = saveres
        self.palette = palette
        self.device = resolve_device(cfg.MODEL.DEVICE)
        self.spec = build_segmentor(cfg)
        self.segmentor = Segmentor(self.spec, cfg.MODEL.NUM_CLASSES)
        self.segmentor.to(self.device).eval()

    # -- checkpoint ----------------------------------------------------------
    def _load_checkpoint(self):
        path = self.cfg.resume
        if path in ("", "latest"):
            # an empty resume evaluates the newest checkpoint in OUTPUT_DIR, as
            # `latest` does: the train_src -> test loop of the JAX Tester
            path = latest_checkpoint(self.cfg.OUTPUT_DIR, self.spec.ckpt_prefix)
            if not path:
                raise FileNotFoundError(
                    f"resume={self.cfg.resume or '(empty)'}: no "
                    f"{self.spec.ckpt_prefix}-N.pth checkpoint in OUTPUT_DIR "
                    f"{self.cfg.OUTPUT_DIR!r}; pass `resume <file.pth>` or train first")
        if not path.endswith(".pth"):
            raise NotImplementedError(
                f"resume={path}: the port reads reference-layout .pth files only "
                f"so far (Orbax directories are a later slice)")
        self.logger.info(f"Loading checkpoint from {path}")
        parts = load_reference_checkpoint(path)
        for name, module in self.spec.modules.items():
            if name not in parts:
                raise KeyError(f"checkpoint {path} lacks part {name!r} needed by "
                               f"{self.cfg.MODEL.NAME}")
            load_part(module, parts[name], name)

    # -- probability head ------------------------------------------------------
    @torch.inference_mode()
    def _probs_impl(self, x: torch.Tensor, label_size: Tuple[int, int]) -> torch.Tensor:
        """x [B,3,H,W] float32 on the model's device -> probs [B,C,H',W']."""
        fam = self.spec.family
        if fam == "deeplab":
            def forward(image, size):
                outputs, _ = self.segmentor(image, label_size=size)
                return outputs[0]

            test = self.cfg.TEST
            if test.MULTI_SCALE:
                return tta.multi_scale_inference(forward, x, label_size,
                                                 flip=bool(test.FLIP_TTA),
                                                 scales=tuple(test.SCALES))
            if test.FLIP_TTA:
                return tta.inference(forward, x, label_size, flip=True)
            out = resize_bilinear(forward(x, label_size).float(), label_size,
                                  align_corners=True)
            return torch.softmax(out, dim=1)
        if fam == "gald":
            outputs, _ = self.segmentor(x)
            out = resize_bilinear(outputs[-1].float(), label_size, align_corners=False)
            return torch.softmax(out, dim=1)
        if fam in ("attn", "attnwrap"):
            outputs, _ = self.segmentor(x)
            return torch.sigmoid(outputs[0].float())
        if fam == "pranet":
            outputs, _ = self.segmentor(x)
            out = resize_bilinear(outputs[-1].float(), label_size, align_corners=False)
            p = torch.sigmoid(out)[:, 0]
            p = (p - p.min()) / (p.max() - p.min() + 1e-8)  # over the whole batch
            return torch.stack([1 - p, p], dim=1)
        raise NotImplementedError(fam)

    # -- loop --------------------------------------------------------------------
    @torch.inference_mode()
    def test(self) -> Dict:
        cfg = self.cfg
        if self.test_loader is None:
            raise ValueError("Tester.test() needs the test_loader it was built without")
        if cfg.TEST.QUANT != "none":
            raise NotImplementedError(
                f"TEST.QUANT={cfg.TEST.QUANT}: quantized eval is not ported yet")
        nc, ignore = cfg.MODEL.NUM_CLASSES, cfg.INPUT.IGNORE_LABEL
        pending = []  # per batch: areas [4,C] and confusion matrix, on the device
        batches = device_prefetch(iter(self.test_loader), cfg.DATA_PIPE.PREFETCH,
                                  self.device)
        for batch in batches:
            x = batch["image"].permute(0, 3, 1, 2).contiguous()
            label = batch["label"]
            pred = self._probs_impl(x, tuple(label.shape[1:3])).argmax(dim=1)
            if self.saveres:
                for mask, name in zip(pred.cpu().numpy(), batch["name"]):
                    save_pseudo_label(mask, self.palette, cfg.PSEUDO_DIR,
                                      cfg.DATASETS.TEST, name)
            pending.append((torch.stack(intersection_and_union(pred, label, nc, ignore)),
                            confusion_matrix(pred, label, nc, ignore)))

        meter = AverageMeter(nc)
        cmt = np.zeros((nc, nc), np.int64)
        for areas, batch_cmt in pending:
            meter.update(*areas.cpu().numpy())
            cmt += batch_cmt.cpu().numpy()
        self.confusion = cmt
        summary = meter.summary(self.logger)
        dump_json(os.path.join(cfg.OUTPUT_DIR, f"{self.spec.family}_confusion_matrix.json"),
                  {"cmt": cmt.tolist(), "classes": list(self.trainid2name.values())})
        return summary
