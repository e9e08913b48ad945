"""Augmentation pipeline factory (counterpart of the JAX package's data/augment.py).

This slice has the test transform of ``AUG.NAME gald`` (and ``none``): the
identity.  The attn, pra and aspp pipelines come with their slices.
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
        raise NotImplementedError(f"AUG.NAME {name!r} is not ported yet")
