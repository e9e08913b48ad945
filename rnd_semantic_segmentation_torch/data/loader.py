"""Host-side input preparation (counterpart of the JAX package's data/loader.py).

This slice has ``preprocess_eval_image``; the batched loader comes with the
training slice.
"""

from __future__ import annotations

import numpy as np


def preprocess_eval_image(image, transform) -> np.ndarray:
    """An RGB image (PIL or HWC array) -> model-input float32 HWC via a test
    transform, with the collate rescale rule: uint8 outputs (identity
    pipelines) are divided by 255, float outputs pass through."""
    img, _ = transform(image, None)
    img = np.asarray(img)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    return img.astype(np.float32)
