"""Augmentation pipeline factory (counterpart of the JAX package's data/augment.py).

The port has the transforms of ``AUG.NAME aspp`` (train and test), ``gald``
and ``none`` (the identity), and the test transform of ``AUG.NAME attn``
(the identity too: the dataset resizes, and blur, rotation, jitter and flips
are training augmentations).  attn's training pipeline and the pra pipeline
come with their slices.

``aspp`` in train mode: ColorJitter (source domain only), then ``Resize`` to
the domain's train size when INPUT.INPUT_SCALES_TRAIN is (1, 1) or else
``RandomScale`` and ``RandomCrop(pad_if_needed)``, then
``RandomHorizontalFlip`` when INPUT.HORIZONTAL_FLIP_PROB_TRAIN > 0, then
``ToArray`` and ``Normalize``.  In test mode: ``Resize`` of the image alone
to INPUT.INPUT_SIZE_TEST, ``ToArray``, ``Normalize``.  Every random
transform of one ``Augmenter`` draws from its ``rng``, a ``random.Random``
(unseeded unless the caller passes one).
"""

from __future__ import annotations

import random
from typing import Optional

from . import transforms as T


class Augmenter:
    def __init__(self, cfg, mode: str = "train", is_source: bool = True,
                 rng: Optional[random.Random] = None):
        self.cfg = cfg
        self.mode = mode
        self.is_source = is_source
        self.rng = rng or random.Random()

    def build_transform(self):
        name = self.cfg.AUG.NAME
        if name in ("gald", "none"):
            return lambda image, label: (image, label)
        if name == "aspp":
            return self.aspp_trans()
        if name == "attn":
            if self.mode == "train":
                raise NotImplementedError(
                    "AUG.NAME attn in train mode (motion blur, rotation, jitter, "
                    "flips) comes with the attn training slice")
            return lambda image, label: (image, label)
        raise NotImplementedError(f"AUG.NAME {name!r} is not ported yet")

    def aspp_trans(self):
        cfg, rng = self.cfg, self.rng
        normalize = [T.ToArray(), T.Normalize(mean=cfg.INPUT.PIXEL_MEAN,
                                              std=cfg.INPUT.PIXEL_STD,
                                              to_bgr255=cfg.INPUT.TO_BGR255)]
        if self.mode != "train":
            w, h = cfg.INPUT.INPUT_SIZE_TEST
            return T.Compose([T.Resize((h, w), resize_label=False)] + normalize)
        w, h = (cfg.INPUT.SOURCE_INPUT_SIZE_TRAIN if self.is_source
                else cfg.INPUT.TARGET_INPUT_SIZE_TRAIN)
        trans = []
        if self.is_source:
            trans.append(T.ColorJitter(brightness=cfg.INPUT.BRIGHTNESS,
                                       contrast=cfg.INPUT.CONTRAST,
                                       saturation=cfg.INPUT.SATURATION,
                                       hue=cfg.INPUT.HUE, rng=rng))
        scales = cfg.INPUT.INPUT_SCALES_TRAIN
        if scales[0] == scales[1] == 1:
            trans.append(T.Resize((h, w)))
        else:
            trans += [T.RandomScale(scale=scales, rng=rng),
                      T.RandomCrop(size=(h, w), pad_if_needed=True, rng=rng)]
        if cfg.INPUT.HORIZONTAL_FLIP_PROB_TRAIN > 0:
            trans.append(T.RandomHorizontalFlip(cfg.INPUT.HORIZONTAL_FLIP_PROB_TRAIN, rng=rng))
        return T.Compose(trans + normalize)
