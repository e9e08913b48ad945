"""Host-side paired image/label transforms, PIL and numpy only (the port's own
copy of the JAX package's data/transforms.py).

Compose, ToArray, Normalize (optionally to BGR x 255), Resize (bicubic image,
nearest label), RandomScale, RandomCrop (pad_if_needed, label fill 255),
RandomHorizontalFlip and ColorJitter.  Outputs are HWC float32 images and HxW
labels, the loader's layout.

The random transforms draw from ``rng``, in the order and with the calls of
the JAX package, which draws from the ``random`` module's global generator:
a ``random.Random(s)`` gives the draws that ``random.seed(s)`` gives there.
Without ``rng`` a transform draws from that global generator too, which each
loader worker process reseeds.
"""

from __future__ import annotations

import numbers
import random
from typing import Optional, Tuple

import numpy as np
from PIL import Image, ImageEnhance


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, image, label):
        for t in self.transforms:
            image, label = t(image, label)
        return image, label


class ToArray:
    """PIL -> float32 HWC in [0, 1]; a PIL label -> float32 numpy."""

    def __call__(self, image, label):
        image = np.asarray(image, dtype=np.float32) / 255.0
        if isinstance(label, Image.Image):
            label = np.asarray(label, dtype=np.float32)
        return image, label


class Normalize:
    def __init__(self, mean, std, to_bgr255: bool = False):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.to_bgr255 = to_bgr255

    def __call__(self, image, label):
        if self.to_bgr255:
            image = image[..., ::-1] * 255.0
        image = (image - self.mean) / self.std
        return image.astype(np.float32), label


class Resize:
    """size=(h, w); bicubic for the image, nearest for the label."""

    def __init__(self, size: Tuple[int, int], resize_label: bool = True):
        self.size = tuple(size)
        self.resize_label = resize_label

    def __call__(self, image, label):
        h, w = self.size
        image = _as_pil(image).resize((w, h), Image.BICUBIC)
        if self.resize_label and label is not None:
            if isinstance(label, np.ndarray):
                label = np.asarray(Image.fromarray(label).resize((w, h), Image.NEAREST))
            else:
                label = label.resize((w, h), Image.NEAREST)
        return image, label


class RandomScale:
    def __init__(self, scale: Tuple[float, float], size=None, resize_label: bool = True,
                 rng: Optional[random.Random] = None):
        self.scale = scale
        self.size = size
        self.resize_label = resize_label
        self.rng = random if rng is None else rng

    def __call__(self, image, label):
        image = _as_pil(image)
        w, h = image.size
        if self.size:
            h, w = self.size
        s = self.scale[0] + (self.scale[1] - self.scale[0]) * self.rng.random()
        size = (int(h * s), int(w * s))
        image = image.resize((size[1], size[0]), Image.BICUBIC)
        if self.resize_label and label is not None:
            label = _as_pil_label(label).resize((size[1], size[0]), Image.NEAREST)
        return image, label


class RandomCrop:
    def __init__(self, size, pad_if_needed: bool = False, fill: int = 0,
                 label_fill: int = 255, rng: Optional[random.Random] = None):
        self.size = (size, size) if isinstance(size, numbers.Number) else tuple(size)
        self.pad_if_needed = pad_if_needed
        self.fill = fill
        self.label_fill = label_fill
        self.rng = random if rng is None else rng

    def __call__(self, image, label):
        image = _as_pil(image)
        label = _as_pil_label(label) if label is not None else None
        th, tw = self.size
        if self.pad_if_needed:
            pad_w = max(tw - image.size[0], 0)
            pad_h = max(th - image.size[1], 0)
            if pad_w or pad_h:
                image = _pad(image, pad_w, pad_h, self.fill)
                if label is not None:
                    label = _pad(label, pad_w, pad_h, self.label_fill)
        w, h = image.size
        i = self.rng.randint(0, h - th)
        j = self.rng.randint(0, w - tw)
        image = image.crop((j, i, j + tw, i + th))
        if label is not None:
            label = label.crop((j, i, j + tw, i + th))
        return image, label


class RandomHorizontalFlip:
    def __init__(self, p: float = 0.5, rng: Optional[random.Random] = None):
        self.p = p
        self.rng = random if rng is None else rng

    def __call__(self, image, label):
        if self.rng.random() < self.p:
            image = _as_pil(image).transpose(Image.FLIP_LEFT_RIGHT)
            if label is not None:
                if isinstance(label, np.ndarray):
                    label = label[:, ::-1].copy()
                else:
                    label = label.transpose(Image.FLIP_LEFT_RIGHT)
        return image, label


class ColorJitter:
    """torchvision-semantics color jitter on PIL images (random op order)."""

    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0, hue=0.0,
                 rng: Optional[random.Random] = None):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue
        self.rng = random if rng is None else rng

    def __call__(self, image, label):
        image = _as_pil(image)
        rng, ops = self.rng, []
        if self.brightness:
            f = rng.uniform(max(0, 1 - self.brightness), 1 + self.brightness)
            ops.append(lambda im, f=f: ImageEnhance.Brightness(im).enhance(f))
        if self.contrast:
            f = rng.uniform(max(0, 1 - self.contrast), 1 + self.contrast)
            ops.append(lambda im, f=f: ImageEnhance.Contrast(im).enhance(f))
        if self.saturation:
            f = rng.uniform(max(0, 1 - self.saturation), 1 + self.saturation)
            ops.append(lambda im, f=f: ImageEnhance.Color(im).enhance(f))
        if self.hue:
            f = rng.uniform(-self.hue, self.hue)
            ops.append(lambda im, f=f: _shift_hue(im, f))
        rng.shuffle(ops)
        for op in ops:
            image = op(image)
        return image, label


def _as_pil(image) -> Image.Image:
    if isinstance(image, Image.Image):
        return image
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = np.clip(arr * 255.0 if arr.max() <= 1.5 else arr, 0, 255).astype(np.uint8)
    return Image.fromarray(arr)


def _as_pil_label(label) -> Image.Image:
    if isinstance(label, Image.Image):
        return label
    return Image.fromarray(np.asarray(label))


def _pad(img: Image.Image, pad_w: int, pad_h: int, fill) -> Image.Image:
    out = Image.new(img.mode, (img.size[0] + pad_w, img.size[1] + pad_h), fill)
    out.paste(img, (0, 0))
    return out


def _shift_hue(img: Image.Image, factor: float) -> Image.Image:
    hsv = np.asarray(img.convert("HSV")).copy()
    hsv[..., 0] = (hsv[..., 0].astype(np.int16) + int(factor * 255)) % 256
    return Image.fromarray(hsv, "HSV").convert("RGB")
