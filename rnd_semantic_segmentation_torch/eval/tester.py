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
pseudo-labels of self-distillation.  Beside the JSON, the heat map of the
row-normalised matrix goes to ``<family>_confusion_matrix.png``
(``utils/plots.py``).

``TEST.QUANT`` (none, int8, fake, auto) quantizes the eval forward after
post-training calibration (serve/quant.py): ``make_quant_context`` calibrates
on the first ``TEST.QUANT_CALIB_BATCHES`` batches of the test loader and
applies the JAX Tester's policy (``auto``: float32 above
``TEST.QUANT_MAX_AREA`` pixels, reason ``geometry``, or when the argmax
agreement with float32 on the first batch stays below
``TEST.QUANT_AGREEMENT_FLOOR`` after ``repair_exclusions``, reason
``accuracy``; ``repaired`` when the repair reached it), and ``test()`` runs
inside its scope.  ``quant_report`` records the outcome.

In a world of more than one process (``cli.test`` under DIST.INITIALIZE)
each rank evaluates its ``process_shard`` of the test set, pads a short
batch to its loader's batch size with ignore-label rows (as the JAX
``_pad_batch`` does; the pranet head's min-max spans the real rows), and
the per-batch areas and the confusion matrix are summed over the ranks in
int64 after the loop, so that the summary is the one of the global batches.
The primary process alone writes the JSON and the heat map; each rank
writes the ``--saveres`` PNGs of its own shard.  ``TEST.QUANT`` then
evaluates in float32 with the reason ``multiprocess``, as the JAX Tester
does.
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
from ..parallel.dist import all_reduce_, check_world, process_is_primary, world_size
from ..serve.quant import (QuantConfig, argmax_agreement, calibrate_segmentor, quant_error_report,
                           quant_scope, repair_exclusions, resolve_mode)
from ..train.segmentor import Segmentor
from ..utils import dump_json, resolve_device
from ..utils.plots import plot_confusion_matrix
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
        check_world(cfg)
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
    def _probs_impl(self, x: torch.Tensor, label_size: Tuple[int, int],
                    valid: Optional[int] = None) -> torch.Tensor:
        """x [B,3,H,W] float32 on the model's device -> probs [B,C,H',W'].
        ``valid``: the batch's real rows are its first ``valid``, the rest
        padding; only the pranet head, whose min-max spans the batch, reads
        it."""
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
            real = p[:valid] if valid is not None else p
            p = (p - real.min()) / (real.max() - real.min() + 1e-8)  # over the whole batch
            return torch.stack([1 - p, p], dim=1)
        raise NotImplementedError(fam)

    # -- quantization ------------------------------------------------------------
    def _loader_input(self, batch) -> Tuple[torch.Tensor, Tuple[int, int]]:
        """A loader batch -> the model input [B,3,H,W] on the device, and the
        label size."""
        x = torch.as_tensor(batch["image"]).to(self.device).permute(0, 3, 1, 2).contiguous()
        size = (tuple(np.shape(batch["label"])[1:3]) if "label" in batch
                else tuple(x.shape[-2:]))
        return x, size

    def make_quant_context(self):
        """``TEST.QUANT`` != none: calibrates activation scales on the first
        ``TEST.QUANT_CALIB_BATCHES`` batches of the test loader and returns a
        ``QuantContext`` (None for float32), with the JAX Tester's policy.
        Explicit int8 and fake are honoured, with a warning when they miss
        the agreement floor.  Cached: calibration runs once per Tester; the
        outcome is in ``self.quant_report``."""
        if hasattr(self, "_qctx"):
            return self._qctx
        requested = self.cfg.TEST.QUANT
        self.quant_report = {"requested": requested, "mode": "none", "agreement": None,
                             "reason": ""}
        w, h = self.cfg.INPUT.INPUT_SIZE_TEST
        mode = resolve_mode(requested, area=int(w) * int(h),
                            max_area=self.cfg.TEST.QUANT_MAX_AREA, device=self.device)
        if requested == "none":
            self._qctx = None
            return None
        if world_size() > 1:
            # each rank would calibrate on its own shard and take other scales
            self.logger.warning(f"TEST.QUANT={requested}: quantized eval is not supported "
                                f"under multi-process eval (world size {world_size()}); "
                                f"evaluating in float32")
            self.quant_report["reason"] = "multiprocess"
            self._qctx = None
            return None
        if mode == "none":
            self.logger.info(f"TEST.QUANT=auto: {w}x{h} exceeds QUANT_MAX_AREA="
                             f"{self.cfg.TEST.QUANT_MAX_AREA}; evaluating in float32")
            self.quant_report["reason"] = "geometry"
            self._qctx = None
            return None
        if mode != requested and requested != "auto":
            self.logger.info(f"TEST.QUANT={requested}: torch._int_mm fails on "
                             f"{self.device}; using the '{mode}' path")
        if self.test_loader is None:
            raise ValueError(f"TEST.QUANT={requested} calibrates on the test_loader the "
                             f"Tester was built without")
        qcfg = QuantConfig(mode=mode, calib_batches=self.cfg.TEST.QUANT_CALIB_BATCHES,
                           min_channels=self.cfg.TEST.QUANT_MIN_CHANNELS)
        ctx = calibrate_segmentor(self.segmentor, self.test_loader, config=qcfg)

        floor = float(self.cfg.TEST.QUANT_AGREEMENT_FLOOR)
        if floor > 0:
            x, ls = self._loader_input(next(iter(self.test_loader)))
            agreement = argmax_agreement(self._probs_impl, x, ls, ctx)
            self.quant_report["agreement"] = agreement
            if agreement < floor:
                if requested == "auto":
                    max_ex = int(self.cfg.TEST.QUANT_REPAIR_MAX)
                    if max_ex > 0:
                        agreement, excluded = repair_exclusions(
                            self._probs_impl, x, ls, ctx, floor, max_exclude=max_ex,
                            logger=self.logger)
                        self.quant_report["agreement"] = agreement
                        self.quant_report["excluded"] = excluded
                    if agreement < floor:
                        self.logger.info(f"TEST.QUANT=auto: argmax agreement {agreement:.3f} "
                                         f"< floor {floor} even after repair; evaluating "
                                         f"in float32")
                        self.quant_report["reason"] = "accuracy"
                        self._qctx = None
                        return None
                    self.quant_report["reason"] = "repaired"
                else:
                    self.logger.warning(
                        f"TEST.QUANT={requested}: argmax agreement {agreement:.3f} < floor "
                        f"{floor}; honouring the explicit request (TEST.QUANT auto gates "
                        f"on accuracy)")
        self.quant_report["mode"] = mode
        self.logger.info(f"eval quantization: {quant_error_report(ctx)}")
        self._qctx = ctx
        return ctx

    # -- loop --------------------------------------------------------------------
    def test(self) -> Dict:
        if self.test_loader is None:
            raise ValueError("Tester.test() needs the test_loader it was built without")
        with quant_scope(self.make_quant_context()):
            return self._test_loop()

    @torch.inference_mode()
    def _test_loop(self) -> Dict:
        cfg = self.cfg
        nc, ignore = cfg.MODEL.NUM_CLASSES, cfg.INPUT.IGNORE_LABEL
        multi = world_size() > 1
        areas, cmt = [], torch.zeros((nc, nc), dtype=torch.int64, device=self.device)
        batches = device_prefetch(iter(self.test_loader), cfg.DATA_PIPE.PREFETCH,
                                  self.device)
        for batch in batches:
            n_real = int(batch["image"].shape[0])
            if multi:
                batch = self._pad_batch(batch, self.test_loader.batch_size)
            x = batch["image"].permute(0, 3, 1, 2).contiguous()
            label = batch["label"]
            pred = self._probs_impl(x, tuple(label.shape[1:3]),
                                    valid=n_real if multi else None).argmax(dim=1)
            if self.saveres:
                for mask, name in zip(pred[:n_real].cpu().numpy(), batch["name"]):
                    save_pseudo_label(mask, self.palette, cfg.PSEUDO_DIR,
                                      cfg.DATASETS.TEST, name)
            # areas are whole pixel counts: int64 sums them exactly over ranks
            areas.append(torch.stack(intersection_and_union(pred, label, nc, ignore)).long())
            cmt += confusion_matrix(pred, label, nc, ignore)
        # batch i of every rank makes up global batch i (equal shards)
        areas = all_reduce_(torch.stack(areas) if areas else
                            torch.zeros((0, 4, nc), dtype=torch.int64, device=self.device))
        cmt = all_reduce_(cmt).cpu().numpy()

        meter = AverageMeter(nc)
        for batch_areas in areas.cpu().numpy():
            meter.update(*batch_areas)
        self.confusion = cmt
        summary = meter.summary(self.logger)
        if process_is_primary():
            dump_json(os.path.join(cfg.OUTPUT_DIR,
                                   f"{self.spec.family}_confusion_matrix.json"),
                      {"cmt": cmt.tolist(), "classes": list(self.trainid2name.values())})
            plot_confusion_matrix(
                cmt, list(self.trainid2name.values()) or [str(i) for i in range(nc)],
                out_path=os.path.join(cfg.OUTPUT_DIR,
                                      f"{self.spec.family}_confusion_matrix.png"))
        return summary

    def _pad_batch(self, batch, rows: int):
        """A short batch padded to ``rows`` with zero images and ignore-label
        rows, which count in no area."""
        pad = rows - int(batch["image"].shape[0])
        if pad <= 0:
            return batch
        image, label = batch["image"], batch["label"]
        return {**batch,
                "image": torch.cat([image, image.new_zeros((pad,) + image.shape[1:])]),
                "label": torch.cat([label, label.new_full((pad,) + label.shape[1:],
                                                          self.cfg.INPUT.IGNORE_LABEL)])}
