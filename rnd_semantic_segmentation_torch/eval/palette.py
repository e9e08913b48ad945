"""Palette PNG export of predictions and pseudo-labels (counterpart of the JAX
package's eval/palette.py).

``get_color_palette`` turns an HxW array of class ids into a P-mode PIL image
with the render config's palette; ``save_pseudo_label`` writes it to
``PSEUDO_DIR/inference/<dataset>/<image name>.png``, the files that
self-distillation reads as labels.  PIL writes the file: the bytes may
differ from those of the JAX package's libpng writer, the decoded indices
and palette do not.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
from PIL import Image


def get_color_palette(pred: np.ndarray, palette: Sequence[int]) -> Image.Image:
    label = Image.fromarray(pred.astype("uint8")).convert("P")
    label.putpalette(list(palette))
    return label


def save_pseudo_label(pred: np.ndarray, palette: Sequence[int], pseudo_dir: str,
                      dataset_name: str, image_name: str) -> str:
    """Writes the palette PNG of ``pred``; returns its path."""
    out_dir = os.path.join(pseudo_dir, "inference", dataset_name)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, os.path.splitext(os.path.basename(image_name))[0] + ".png")
    get_color_palette(pred, palette).save(path)
    return path
