"""Evaluation head (counterpart of the JAX package's eval/tester.py).

This slice has what the serving daemon uses: the model on its device, the
checkpoint loader for reference-layout ``.pth`` files and the trainer's
checkpoints (``resume <file.pth>`` or ``resume latest``), and the gald
probability head ``_probs_impl``: decoder ``out2`` -> bilinear
(align_corners=False) to the label size -> softmax over classes.  The
multi-device eval and the metric loop come with a later slice.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ckpt.checkpoint_io import latest_checkpoint
from ..ckpt.torch_import import load_part, load_reference_checkpoint
from ..models.build import build_segmentor
from ..ops import resize_bilinear
from ..train.segmentor import Segmentor
from ..utils import resolve_device


class Tester:
    __test__ = False  # not a pytest class

    def __init__(self, cfg, logger):
        self.cfg = cfg
        self.logger = logger
        self.device = resolve_device(cfg.MODEL.DEVICE)
        self.spec = build_segmentor(cfg)
        self.segmentor = Segmentor(self.spec, cfg.MODEL.NUM_CLASSES)
        self.segmentor.to(self.device).eval()

    # -- checkpoint ----------------------------------------------------------
    def _load_checkpoint(self):
        path = self.cfg.resume
        if path == "latest":
            path = latest_checkpoint(self.cfg.OUTPUT_DIR, self.spec.ckpt_prefix)
        if not path:
            raise FileNotFoundError(
                f"resume={self.cfg.resume or '(empty)'}: the port needs `resume "
                f"<file.pth>`, or `resume latest` with a {self.spec.ckpt_prefix}-N.pth "
                f"in OUTPUT_DIR {self.cfg.OUTPUT_DIR!r}")
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
        if fam == "gald":
            outputs, _ = self.segmentor(x)
            out = resize_bilinear(outputs[-1].float(), label_size, align_corners=False)
            return torch.softmax(out, dim=1)
        raise NotImplementedError(fam)
