"""Augmentation pipeline factory (counterpart of the JAX package's data/augment.py).

The port has the transforms of ``AUG.NAME aspp``, ``attn`` and ``pra`` (train
and test), and ``gald`` and ``none`` (the identity).  ``cv2_resize`` is the
bilinear resize of image and label that the Kvasir-fold and BLI readers apply
after their transform.

``attn`` in train mode (the reference's albumentations pipeline, rebuilt on
PIL and numpy): with probability AUG.PROB at all, then each with its own
probability, a motion blur (the mean of k in {3, 5, 7} copies of the image
rolled along one of four directions; float stays float, uint8 stays uint8),
a rotation by an angle in [-90, 90] degrees (the image bilinear through
PIL, which returns uint8; the label nearest, through float32),
``ColorJitter(0.2, 0.2, 0.2, 0.2)`` (uint8 out), and a flip by the
albumentations codes 0 (vertical), 1 (horizontal) and -1 (both).  The
dtypes are the JAX package's: the collate divides a uint8 batch by 255 and
passes a float one through.  In test mode ``attn`` is the identity: the
dataset resizes.

``aspp`` in train mode: ColorJitter (source domain only), then ``Resize`` to
the domain's train size when INPUT.INPUT_SCALES_TRAIN is (1, 1) or else
``RandomScale`` and ``RandomCrop(pad_if_needed)``, then
``RandomHorizontalFlip`` when INPUT.HORIZONTAL_FLIP_PROB_TRAIN > 0, then
``ToArray`` and ``Normalize``.  In test mode: ``Resize`` of the image alone
to INPUT.INPUT_SIZE_TEST, ``ToArray``, ``Normalize``.

With ``DATA_PIPE.DEVICE_AUG`` a train-mode ``Augmenter`` keeps only the
host's share (``_device_stub``), and ``data/device_pipe.py`` does the rest
on the batch's device: ``pra`` crops as below and resizes to
INPUT.TRAINSIZE squared, uint8 out; ``aspp`` takes ``RandomScale`` and
``RandomCrop(pad_if_needed)`` only when INPUT.INPUT_SCALES_TRAIN is not
(1, 1), then ``ToArray``; ``attn``, ``gald`` and ``none`` are the identity.
Test mode keeps the host's transforms.

``pra`` in train mode: a rotation by k x 90 degrees (k in 0..3), a flip by
the albumentations codes 0, 1, -1 or none, ``ColorJitter(0.2, 0.2, 0.2,
0.1)``, then with probability 1/2 (and only when both sides exceed 220) a
220 x 220 crop, at random or centred with equal odds; in both modes then a
resize to INPUT.TRAINSIZE squared (image bilinear, label nearest through
float32), the image to float32 / 255 and normalised with the ImageNet mean
and std.

Every random transform of one ``Augmenter`` draws from its ``rng``, in the
order and with the calls the JAX package makes on the ``random`` module.
Without an ``rng`` from the caller that is the ``random`` module's global
generator, as in the JAX package, so each loader worker process, which
reseeds it, makes its own draws.
"""

from __future__ import annotations

import random
from typing import Optional

import numpy as np
from PIL import Image

from . import transforms as T
from .device_pipe import device_aug_active

PRA_CROP = 220
IMAGENET_MEAN = np.asarray((0.485, 0.456, 0.406), np.float32)
IMAGENET_STD = np.asarray((0.229, 0.224, 0.225), np.float32)


def cv2_resize(image, label, size=(512, 512)):
    """Bilinear resize of the image and of the label to ``size`` (w, h).  The
    label goes through a float32 image, bilinear too, as the reference's
    ``cv2.resize`` does: binary masks come out with fractions at their edges,
    which the collate truncates."""
    w, h = size
    image = np.asarray(T._as_pil(image).resize((w, h), Image.BILINEAR))
    if label is None:
        return image, None
    label = Image.fromarray(np.asarray(label).astype(np.float32)).resize((w, h),
                                                                        Image.BILINEAR)
    return image, np.asarray(label)


def _pra_random_crop(image, label, rng: random.Random, crop: int = PRA_CROP):
    """With probability 1/2, when both sides exceed ``crop``: a crop x crop
    window of image and label, at random or centred with equal odds."""
    if rng.random() < 0.5 and min(image.shape[:2]) > crop:
        h, w = image.shape[:2]
        if rng.random() < 0.5:
            i, j = rng.randint(0, h - crop), rng.randint(0, w - crop)
        else:
            i, j = (h - crop) // 2, (w - crop) // 2
        image = image[i:i + crop, j:j + crop]
        label = label[i:i + crop, j:j + crop]
    return image, label


def _pra_resize(image, label, trainsize: int):
    """The image bilinear and the label nearest (through float32) to
    trainsize x trainsize; PIL images out."""
    im = T._as_pil(image).resize((trainsize, trainsize), Image.BILINEAR)
    lb = Image.fromarray(label.astype(np.float32)).resize((trainsize, trainsize),
                                                         Image.NEAREST)
    return im, lb


def _motion_blur(image: np.ndarray, ksize: int, rng: random.Random) -> np.ndarray:
    """The mean of ``ksize`` copies of ``image`` rolled by -k//2..k//2 pixels
    along a direction drawn from ``rng`` (rows, columns, or a diagonal)."""
    arr = image.astype(np.float32)
    direction = rng.choice(["h", "v", "d1", "d2"])
    acc = np.zeros_like(arr)
    offs = range(-(ksize // 2), ksize // 2 + 1)
    for o in offs:
        if direction == "h":
            acc += np.roll(arr, o, axis=1)
        elif direction == "v":
            acc += np.roll(arr, o, axis=0)
        elif direction == "d1":
            acc += np.roll(np.roll(arr, o, axis=0), o, axis=1)
        else:
            acc += np.roll(np.roll(arr, o, axis=0), -o, axis=1)
    return (acc / len(offs)).astype(image.dtype)


class Augmenter:
    def __init__(self, cfg, mode: str = "train", is_source: bool = True,
                 rng: Optional[random.Random] = None):
        self.cfg = cfg
        self.mode = mode
        self.is_source = is_source
        self.rng = random if rng is None else rng

    def build_transform(self):
        name = self.cfg.AUG.NAME
        if name not in ("gald", "none", "aspp", "attn", "pra"):
            raise ValueError(f"AUG.NAME {name!r}: the pipelines are attn, pra, aspp, gald and "
                             f"none (the JAX package takes any other name as the identity)")
        if device_aug_active(self.cfg, self.mode):
            return self._device_stub(name)
        if name in ("gald", "none"):
            return lambda image, label: (image, label)
        if name == "aspp":
            return self.aspp_trans()
        if name == "attn":
            if self.mode == "train":
                return self.attn_trans
            return lambda image, label: (image, label)
        return self.pra_trans

    def _device_stub(self, name):
        """The host's share of a train transform under DATA_PIPE.DEVICE_AUG:
        the geometry that needs the image before the collate.  Its draws come
        from ``self.rng`` in the JAX package's order."""
        cfg, rng = self.cfg, self.rng
        if name == "pra":
            def fn(image, label):
                image, label = _pra_random_crop(np.asarray(image), np.asarray(label), rng)
                im, lb = _pra_resize(image, label, cfg.INPUT.TRAINSIZE)
                # uint8 out: the collate's /255 gives the device [0, 1]
                return np.asarray(im), np.asarray(lb)
            return fn
        if name == "aspp":
            trans = [T.ToArray()]
            scales = cfg.INPUT.INPUT_SCALES_TRAIN
            if not scales[0] == scales[1] == 1:
                w, h = (cfg.INPUT.SOURCE_INPUT_SIZE_TRAIN if self.is_source
                        else cfg.INPUT.TARGET_INPUT_SIZE_TRAIN)
                trans = [T.RandomScale(scale=scales, rng=rng),
                         T.RandomCrop(size=(h, w), pad_if_needed=True, rng=rng)] + trans
            return T.Compose(trans)
        # attn, gald, none: the readers' resize still runs; the rest is the device's
        return lambda image, label: (image, label)

    def attn_trans(self, image, label):
        """One image and label through the train-mode ``attn`` pipeline."""
        aug, rng = self.cfg.AUG, self.rng
        image, label = np.asarray(image), np.asarray(label)
        if rng.random() > aug.PROB:
            return image, label
        if rng.random() < aug.BLUR_PROB:
            image = _motion_blur(image, rng.choice([3, 5, 7]), rng)
        if rng.random() < aug.ROTATE_PROB:
            angle = rng.uniform(-90, 90)
            im = T._as_pil(image).rotate(angle, Image.BILINEAR)
            lb = Image.fromarray(label.astype(np.float32)).rotate(angle, Image.NEAREST)
            image, label = np.asarray(im), np.asarray(lb).astype(label.dtype)
        if rng.random() < aug.JITTER_PROB:
            im, _ = T.ColorJitter(0.2, 0.2, 0.2, 0.2, rng=rng)(image, None)
            image = np.asarray(im)
        if rng.random() < aug.FLIP_PROB:
            code = rng.choice([0, 1, -1])
            if code in (0, -1):
                image, label = image[::-1].copy(), label[::-1].copy()
            if code in (1, -1):
                image, label = image[:, ::-1].copy(), label[:, ::-1].copy()
        return image, label

    def pra_trans(self, image, label):
        """One image and label through the ``pra`` pipeline of ``self.mode``."""
        rng = self.rng
        image, label = np.asarray(image), np.asarray(label)
        if self.mode == "train":
            k = rng.randint(0, 3)
            if k:
                image, label = np.rot90(image, k).copy(), np.rot90(label, k).copy()
            code = rng.choice([0, 1, -1, None])
            if code in (0, -1):
                image, label = image[::-1].copy(), label[::-1].copy()
            if code in (1, -1):
                image, label = image[:, ::-1].copy(), label[:, ::-1].copy()
            im, _ = T.ColorJitter(0.2, 0.2, 0.2, 0.1, rng=rng)(image, None)
            image, label = _pra_random_crop(np.asarray(im), label, rng)
        im, lb = _pra_resize(image, label, self.cfg.INPUT.TRAINSIZE)
        image = (np.asarray(im, np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
        return image.astype(np.float32), np.asarray(lb)

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
