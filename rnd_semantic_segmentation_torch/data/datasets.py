"""Datasets (counterpart of the JAX package's data/datasets.py).

This slice has ``SyntheticDataset``: random-blob segmentation data made from a
seed, with which the train and eval CLIs run with no data on disk.  It draws
from the same ``RandomState(seed*100003 + index)`` stream as the JAX
package's, so both packages see the same pixels.  The GTA5, Cityscapes,
Kvasir and BLI readers come with the data slice.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class SyntheticDataset:
    """Deterministic random-blob segmentation data for tests and benchmarks.

    ``shift="swap"`` produces a covariate-shifted TARGET domain for
    domain-adaptation tests: the blob signal moves to the opposite channel
    and global brightness drops (same labels, shifted inputs)."""

    def __init__(self, size: Tuple[int, int] = (352, 352), num_classes: int = 2,
                 length: int = 64, transform=None, seed: int = 0, debug=False,
                 shift: str = "none"):
        self.size = size
        self.num_classes = num_classes
        self.length = length
        self.transform = transform
        self.seed = seed
        self.debug = debug
        self.shift = shift
        self.image_paths = [f"synthetic_{i:05d}" for i in range(length)]

    def __len__(self) -> int:
        return len(self.image_paths)

    def _gen(self, index):
        """(image, label, name) before the paired transform."""
        rng = np.random.RandomState(self.seed * 100003 + index)
        h, w = self.size
        image = rng.rand(h, w, 3).astype(np.float32)
        yy, xx = np.mgrid[0:h, 0:w]
        label = np.zeros((h, w), np.float32)
        for c in range(1, self.num_classes):
            cy, cx = rng.randint(0, h), rng.randint(0, w)
            r = rng.randint(min(h, w) // 8, min(h, w) // 3)
            label[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = c
        # paint the blobs into the image so the task is learnable
        image[..., 0] += 0.5 * (label > 0)
        image = np.clip(image, 0, 1)
        if self.shift == "swap":
            # severe: signal channel flipped + brightness drop
            image = np.ascontiguousarray(image[..., ::-1]) * 0.7
        elif self.shift == "blend":
            # moderate: half the signal leaks to the opposite channel
            image = np.ascontiguousarray(
                0.5 * image + 0.5 * image[..., ::-1]) * 0.8
        elif self.shift == "dim":
            # mild: global brightness/contrast shift (BN-stat mismatch)
            image = np.clip(0.55 * image + 0.3, 0, 1)
        return image, label, self.image_paths[index]

    def __getitem__(self, index):
        if self.debug:
            index = 0
        image, label, name = self._gen(index)
        if self.transform is not None:
            image, label = self.transform(image, label)
        return np.asarray(image), np.asarray(label), name
