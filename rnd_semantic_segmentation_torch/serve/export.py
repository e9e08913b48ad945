"""Deployment export of the eval head (counterpart of the JAX package's
serve/export.py): ``torch.export`` of the ``Tester``'s probability head and
an argmax to int32 class ids, with the parameters inside the program.

The program takes [N,H,W,3] float32 images (the JAX artifact's input) at
the batch and test geometry it was exported at, and returns [N,H,W] int32
class ids.  Quantization composes: the quant context is entered while the
head is traced, so an ``int8`` export holds ``aten._int_mm`` and the scales
as constants.  Kernels #1 and #3 are the operators
``rnd_seg_torch::cc_attention_fwd`` and ``rnd_seg_torch::fused_mbconv_fwd``
(ops/ccattn.py, ops/mbconv.py), which the program records by name: a
consumer imports ``rnd_semantic_segmentation_torch.ops`` (``load_exported``
does) so that they resolve.

Artifact: ``<out>.pt2`` (``torch.export.save``) and ``<out>.json`` with the
JAX metadata keys: ``model``, ``num_classes``, ``input``, ``input_dtype``,
``output``, ``quant`` (the resolved mode), ``platforms`` and ``bytes``.
``platforms`` is the device the program was traced on (``cuda`` or
``cpu``); the program runs there only, so any other request (``tpu``
included) raises ``ValueError``.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from .quant import quant_scope

__all__ = ["export_eval", "load_exported"]


class _ArgmaxHead(nn.Module):
    """[N,H,W,3] float32 -> [N,H,W] int32: the Tester's head under ``qctx``."""

    def __init__(self, tester, label_size, qctx):
        super().__init__()
        self.segmentor = tester.segmentor  # its parameters go inside the program
        self._tester, self._label_size, self._qctx = tester, label_size, qctx

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        # NCHW in memory, as the Tester's callers give it: convolutions on the
        # permuted view would run (and round) channels-last
        x = image.permute(0, 3, 1, 2).contiguous()
        with quant_scope(self._qctx):
            probs = self._tester._probs_impl(x, self._label_size)
        return probs.argmax(dim=1).to(torch.int32)


def export_eval(tester, batch_size: int, out_path: str, quant_ctx=None,
                platforms: Optional[Sequence[str]] = None, logger=None) -> dict:
    """Exports ``tester``'s eval head (checkpoint loaded) at a fixed batch
    and input geometry; returns the metadata (also in ``<out>.json``)."""
    cfg = tester.cfg
    device = tester.device.type
    if platforms and list(platforms) != [device]:
        raise ValueError(f"platforms {list(platforms)}: a program traced on {device} runs "
                         f"on {device} only")
    w, h = (int(v) for v in cfg.INPUT.INPUT_SIZE_TEST)
    head = _ArgmaxHead(tester, (h, w), quant_ctx).eval()
    example = torch.zeros((batch_size, h, w, 3), dtype=torch.float32, device=tester.device)
    with torch.no_grad():
        program = torch.export.export(head, (example,))
    os.makedirs(os.path.dirname(os.path.abspath(out_path)) or ".", exist_ok=True)
    torch.export.save(program, out_path + ".pt2")
    meta = {
        "model": cfg.MODEL.NAME,
        "num_classes": cfg.MODEL.NUM_CLASSES,
        "input": [batch_size, h, w, 3],
        "input_dtype": "float32",
        "output": "argmax class ids, int32 [N,H,W]",
        # the resolved mode: the context's, not what the config asked for
        "quant": quant_ctx.mode if quant_ctx is not None else "none",
        "platforms": [device],
        "bytes": os.path.getsize(out_path + ".pt2"),
    }
    with open(out_path + ".json", "w") as f:
        json.dump(meta, f, indent=1)
    if logger:
        logger.info(f"exported {meta['model']} -> {out_path}.pt2 "
                    f"({meta['bytes'] / 1e6:.1f} MB, platforms={meta['platforms']})")
    return meta


def load_exported(out_path: str):
    """Returns ``(call, meta)``: ``call(images [N,H,W,3] float32 numpy)`` ->
    class ids [N,H,W] int32 numpy, run on the device the program was traced
    on, with TF32 off as everywhere in the port (``resolve_device``): cuDNN
    would otherwise run the program's float32 convolutions in TF32."""
    from ..ops import ccattn, mbconv  # noqa: F401  (register the kernels' operators)
    from ..utils import resolve_device

    with open(out_path + ".json") as f:
        meta = json.load(f)
    if meta["platforms"] not in (["cuda"], ["cpu"]):
        raise ValueError(f"{out_path}.json: platforms {meta['platforms']}; the port's "
                         f"programs run on cuda or cpu")
    device = resolve_device(meta["platforms"][0])
    module = torch.export.load(out_path + ".pt2").module()

    def call(image: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            out = module(torch.as_tensor(np.asarray(image, np.float32), device=device))
        return out.cpu().numpy()

    return call, meta
