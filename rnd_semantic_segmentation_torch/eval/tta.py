"""Test-time augmentation of the deeplab head: flip and multi-scale inference
(counterpart of the JAX package's eval/tta.py), on NCHW tensors.

  * ``inference``: with ``flip``, the mirrored image rides in the same batch
    as the original; the logits are resized (align_corners=True) to the label
    size, softmaxed, and the mirrored half is flipped back and averaged in.
  * ``multi_scale_inference``: the image resized (align_corners=True) by each
    of ``scales``, each through ``inference`` without flip, and with ``flip``
    each mirror too; the probabilities are averaged.

Both take one image, as the JAX functions do (they add up ``output[0]`` and
``output[1]``); a batch of more than one raises ``ValueError`` instead of
mixing images.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

from ..ops import resize_bilinear

ForwardFn = Callable[[torch.Tensor, Tuple[int, int]], torch.Tensor]
# ForwardFn(image_batch [B,3,H,W], label_size) -> logits [B,C,H',W']


def _one_image(image: torch.Tensor) -> None:
    if image.shape[0] != 1:
        raise ValueError(f"test-time augmentation takes one image a batch, got "
                         f"{image.shape[0]}: set TEST.BATCH_SIZE 1 with TEST.FLIP_TTA "
                         f"or TEST.MULTI_SCALE")


def inference(forward: ForwardFn, image: torch.Tensor, label_size: Tuple[int, int],
              flip: bool = True) -> torch.Tensor:
    """One scale -> softmax probabilities [1,C,H,W] at ``label_size``."""
    _one_image(image)
    if flip:
        image = torch.cat([image, image.flip(-1)], dim=0)
    output = resize_bilinear(forward(image, label_size).float(), label_size,
                             align_corners=True)
    output = torch.softmax(output, dim=1)
    if flip:
        return ((output[0] + output[1].flip(-1)) / 2)[None]
    return output[:1]


def multi_scale_inference(forward: ForwardFn, image: torch.Tensor,
                          label_size: Tuple[int, int], flip: bool = True,
                          scales: Sequence[float] = (0.7, 1.0, 1.3)) -> torch.Tensor:
    """Probabilities [1,C,H,W] averaged over ``scales`` (and their mirrors)."""
    _one_image(image)
    h, w = image.shape[-2:]
    output = None
    for s in scales:
        scaled = resize_bilinear(image, (int(h * s), int(w * s)), align_corners=True)
        pred = inference(forward, scaled, label_size, flip=False)
        output = pred if output is None else output + pred
        if flip:
            pred = inference(forward, scaled.flip(-1), label_size, flip=False)
            output = output + pred.flip(-1)
    return output / (len(scales) * (2 if flip else 1))
