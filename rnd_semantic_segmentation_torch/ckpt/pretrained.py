"""MODEL.WEIGHTS: a pretrained backbone laid over freshly built modules
(counterpart of the JAX package's ckpt/pretrained.py).

The file is a local ``.pth`` in the backbone's published layout: a
torchvision ResNet or VGG16 (deeplab), ``hardnet68.pth`` (gald),
Res2Net50-v1b (pranet) or efficientnet-pytorch (attn, attnwrap).  A URL is
not fetched: it raises ``FileNotFoundError``, as a missing file does.  The
file may hold its state dict under ``state_dict``; a ``module.`` prefix on
every key is dropped; entries that are not tensors are left out.

``PRETRAINED_LAYOUTS`` in ckpt/torch_import.py says where each key lands.
Keys holding ``num_batches_tracked``, ``fc.`` or ``_fc.`` (and, per layout,
VGG16's ``classifier.`` and HarDNet's ``base.19``) are skipped.  A key with
no home in the model raises ``KeyError`` and a shape that differs raises
``ValueError``, before any tensor is written.  BatchNorm statistics go where
the model keeps them: ``FrozenBatchNorm2d`` buffers under MODEL.FREEZE_BN
(deeplab's ResNet), ``nn.BatchNorm2d`` running statistics otherwise.
Tensors the file does not name keep their initial values.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Mapping

import torch
from torch import nn

from .torch_import import PRETRAINED_LAYOUTS, PRETRAINED_SKIP


def _layout_key(family: str, backbone: str):
    if family == "deeplab":
        return family, "vgg16" if backbone == "vgg16" else "resnet"
    if family in ("attn", "attnwrap"):
        return family, "efficientnet"
    if family == "gald":
        return family, "hardnet68"
    return family, backbone


def read_backbone_file(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a backbone ``.pth`` on the CPU, by key."""
    if path.startswith("http"):
        raise FileNotFoundError(
            f"MODEL.WEIGHTS is a URL ({path}); this environment has no network "
            f"egress: download the .pth and point MODEL.WEIGHTS at it")
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, Mapping) and "state_dict" in obj:
        obj = obj["state_dict"]
    sd = {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)}
    if sd and all(k.startswith("module.") for k in sd):
        sd = {k[len("module."):]: v for k, v in sd.items()}
    return sd


def load_pretrained_backbone(spec, cfg, modules: Mapping[str, nn.Module]
                             ) -> Mapping[str, nn.Module]:
    """Lays the ``.pth`` of ``cfg.MODEL.WEIGHTS`` over the backbone of
    ``modules`` (``{part: module}``), in place; nothing when it is empty.
    ``spec`` is a ``SegmentorSpec`` or a MODEL.NAME (``family_backbone``)."""
    weights = cfg.MODEL.WEIGHTS
    if not weights:
        return modules
    if isinstance(spec, str):
        family, _, backbone = spec.partition("_")
    else:
        family, backbone = spec.family, spec.backbone
    layout = _layout_key(family, backbone)
    if layout not in PRETRAINED_LAYOUTS:
        raise NotImplementedError(f"MODEL.WEIGHTS: no pretrained layout for {family} "
                                  f"with backbone {backbone!r}")
    part, prefix, skip, renames = PRETRAINED_LAYOUTS[layout]
    target = modules[part].state_dict()
    updates = {}
    for key, value in read_backbone_file(weights).items():
        if any(s in key for s in PRETRAINED_SKIP + skip):
            continue
        name = prefix + key
        for pattern, rep in renames:
            if re.search(pattern, name):
                if rep is None:
                    raise KeyError(f"pretrained key {key!r} has no home in the "
                                   f"{family} {part} ({weights})")
                name = re.sub(pattern, rep, name)
        if name not in target:
            raise KeyError(f"pretrained key {key!r} ({name}) missing in the {family} "
                           f"{part} ({weights})")
        if tuple(target[name].shape) != tuple(value.shape):
            raise ValueError(f"shape mismatch at {name}: model {tuple(target[name].shape)} "
                             f"vs ckpt {tuple(value.shape)} ({weights})")
        updates[name] = value
    with torch.no_grad():
        for name, value in updates.items():
            target[name].copy_(value)
    return modules
