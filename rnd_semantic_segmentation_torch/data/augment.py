"""Augmentation pipeline factory (counterpart of the JAX package's data/augment.py).

The port has the transforms of ``AUG.NAME gald`` and ``none`` (the identity)
and the test transform of ``AUG.NAME attn`` (the identity too: the dataset
resizes, and blur, rotation, jitter and flips are training augmentations).
attn's training pipeline and the pra and aspp pipelines come with their
slices.
"""

from __future__ import annotations


class Augmenter:
    def __init__(self, cfg, mode: str = "train", is_source: bool = True):
        self.cfg = cfg
        self.mode = mode
        self.is_source = is_source

    def build_transform(self):
        name = self.cfg.AUG.NAME
        if name in ("gald", "none"):
            return lambda image, label: (image, label)
        if name == "attn":
            if self.mode == "train":
                raise NotImplementedError(
                    "AUG.NAME attn in train mode (motion blur, rotation, jitter, "
                    "flips) comes with the attn training slice")
            return lambda image, label: (image, label)
        raise NotImplementedError(f"AUG.NAME {name!r} is not ported yet")
