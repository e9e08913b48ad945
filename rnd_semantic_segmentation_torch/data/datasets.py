"""Datasets (counterpart of the JAX package's data/datasets.py).

Every reader returns ``(image, label, name)`` as numpy arrays after its paired
transform, with the JAX package's dtypes, and the port keeps its own copy of
each label table:
  * ``KvasirDataSet`` / ``KvasirFoldDataset`` (the ``kvasir_*`` and
    ``polyp_*`` names): k-fold folders (``_kfold_image_paths``: a folder whose
    name holds the ``cross_val`` digit is the val fold), ``images/`` paired
    with ``masks/``; ``KvasirDataSet`` remaps {0: 0, 1: 1} with ignore fill,
    ``KvasirFoldDataset`` takes channel 0 of the mask and, after the
    transform, resizes image and mask bilinearly (``cv2_resize``) to
    INPUT.SOURCE_INPUT_SIZE_TRAIN or INPUT.INPUT_SIZE_TEST;
  * ``CityscapesDataSet``: ``leftImg8bit/<mode>/<city>/*.png`` paired with
    ``gtFine/<mode>/<city>/<stem>_gtFine_labelIds.png``, the 34 -> 19 train id
    remap, or the SYNTHIA 16-class one when ``num_classes == 16``;
    ``CityscapesSelfDistillDataSet`` reads the labels from the pseudo-label
    PNGs that ``cli.test --saveres`` exports, with an identity remap over the
    train ids;
  * ``GTA5FoldDataSet``: k-fold folders, ``images/`` with ``labels/``, the
    19-class remap;
  * ``BLIDataset``: ``images/*.{JPG,jpg,png,jpeg}`` with the mask
    ``masks/<name[:-5]>.png`` read as 0/255 and divided by 255, resized
    after the transform to INPUT.TARGET_INPUT_SIZE_TRAIN or
    INPUT.INPUT_SIZE_TEST.  The mask name drops five characters whatever the
    extension, as the JAX package does: ``abc.jpeg`` pairs with ``abc.png``,
    but ``abc.jpg`` with ``ab.png``, a name one letter short;
  * ``SynthiaDataSet``: ``RGB/`` with ``GT/LABELS/`` (channel 0), the SYNTHIA
    16-class remap, optionally filtered by a list file;
  * ``SyntheticDataset``: random-blob data made from a seed, drawing from the
    same ``RandomState(seed*100003 + index)`` stream as the JAX package's, so
    both packages see the same pixels; ``SyntheticSelfDistillDataset`` pairs
    its images with exported pseudo-label PNGs.

Remapped labels are float32 images (``remap_labels``); Kvasir-fold and BLI
masks come out of a bilinear float32 resize, and the collate truncates every
label to int32.  Images are decoded by PIL, or, when ``build_dataset`` set
``use_native_decode`` (DATA_PIPE.NATIVE_DECODE), by the libjpeg/libpng
decoder of ``native_decode``; a file it cannot decode goes through PIL,
counted in ``native_fallbacks`` and logged, as the JAX package falls back.
Labels are PIL's in both cases.  Every class keeps the reference's
``debug`` flag, which pins the index to 0.
"""

from __future__ import annotations

import logging
import os
from glob import glob
from typing import Dict, Tuple

import numpy as np
from PIL import Image

from . import native_decode
from .augment import cv2_resize

CITYSCAPES_ID_TO_TRAINID = {
    7: 0, 8: 1, 11: 2, 12: 3, 13: 4, 17: 5, 19: 6, 20: 7, 21: 8, 22: 9,
    23: 10, 24: 11, 25: 12, 26: 13, 27: 14, 28: 15, 31: 16, 32: 17, 33: 18,
}
CITYSCAPES_TRAINID2NAME = {
    0: "road", 1: "sidewalk", 2: "building", 3: "wall", 4: "fence", 5: "pole",
    6: "light", 7: "sign", 8: "vegetation", 9: "terrain", 10: "sky",
    11: "person", 12: "rider", 13: "car", 14: "truck", 15: "bus", 16: "train",
    17: "motocycle", 18: "bicycle",
}
SYNTHIA_ID_TO_TRAINID = {
    7: 0, 8: 1, 11: 2, 12: 3, 13: 4, 17: 5, 19: 6, 20: 7, 21: 8, 23: 9,
    24: 10, 25: 11, 26: 12, 28: 13, 32: 14, 33: 15,
}
SYNTHIA_TRAINID2NAME = {
    0: "road", 1: "sidewalk", 2: "building", 3: "wall", 4: "fence", 5: "pole",
    6: "light", 7: "sign", 8: "vegetation", 9: "sky", 10: "person",
    11: "rider", 12: "car", 13: "bus", 14: "motocycle", 15: "bicycle",
}


def remap_labels(label: np.ndarray, id_to_trainid: Dict[int, int],
                 ignore_label: int = 255) -> np.ndarray:
    """float32 train ids; every id outside the table becomes ``ignore_label``."""
    out = np.full(label.shape, ignore_label, dtype=np.float32)
    for k, v in id_to_trainid.items():
        out[label == k] = v
    return out


def _kfold_image_paths(data_root: str, mode: str, cross_val: int) -> list:
    """``<fold>/images/*.png`` of every fold folder under ``data_root``: in
    train mode the folders whose name does not hold the digits of
    ``cross_val``, otherwise those whose name does (a substring test)."""
    paths = []
    for kfold_path in glob(data_root + "/*/"):
        name = os.path.basename(kfold_path[:-1])
        in_fold = str(cross_val) in name
        if (mode == "train") != in_fold:
            paths += sorted(glob(os.path.join(kfold_path, "images") + "/*.png"))
    return paths


def _open_label(path: str) -> np.ndarray:
    return np.array(Image.open(path), dtype=np.float32)


class _Base:
    image_paths: list
    debug: bool = False
    transform = None
    use_native_decode: bool = False  # set by build_dataset from DATA_PIPE.NATIVE_DECODE
    native_fallbacks: int = 0        # files the native decoder refused, in this process

    def __len__(self) -> int:
        return len(self.image_paths)

    def _path(self, index: int) -> str:
        return self.image_paths[0 if self.debug else index]

    def _open_rgb(self, path: str) -> Image.Image:
        if self.use_native_decode:
            arr = native_decode.decode(path)
            if arr is not None:
                return Image.fromarray(arr)  # uint8 [H,W,3]: mode RGB
            self.native_fallbacks += 1
            logging.getLogger(__name__).warning(
                f"native decoder refused {path}; decoded with PIL "
                f"({self.native_fallbacks} in this process)")
        return Image.open(path).convert("RGB")

    def _finish(self, image, label, name):
        if self.transform is not None:
            image, label = self.transform(image, label)
        return np.asarray(image), np.asarray(label), name


class KvasirDataSet(_Base):
    def __init__(self, data_root, num_classes=2, mode="train", cross_val=0,
                 transform=None, ignore_label=255, debug=False):
        self.image_paths = _kfold_image_paths(data_root, mode, cross_val or 0)
        self.id_to_trainid = {0: 0, 1: 1}
        self.ignore_label = ignore_label
        self.transform = transform
        self.debug = debug

    def __getitem__(self, index):
        path = self._path(index)
        img_name = os.path.basename(path)
        img_dir = os.path.dirname(os.path.dirname(path))
        image = self._open_rgb(path)
        label = _open_label(os.path.join(img_dir, "masks", img_name))
        label = Image.fromarray(remap_labels(label, self.id_to_trainid, self.ignore_label))
        return self._finish(image, label, img_name[:-4])


class KvasirFoldDataset(_Base):
    def __init__(self, cfg, data_root, mode="train", cross_val=0, transform=None,
                 debug=False):
        self.cfg = cfg
        self.mode = mode
        self.transform = transform
        self.debug = debug
        self.image_paths = _kfold_image_paths(data_root, mode, cross_val or 0)

    def __getitem__(self, index):
        path = self._path(index)
        img_name = os.path.basename(path)
        img_dir = os.path.dirname(os.path.dirname(path))
        image = np.asarray(self._open_rgb(path))
        mask = np.asarray(Image.open(os.path.join(img_dir, "masks", img_name)))
        if mask.ndim == 3:
            mask = mask[..., 0]
        if self.transform is not None:
            image, mask = self.transform(image, mask)
        size = (self.cfg.INPUT.SOURCE_INPUT_SIZE_TRAIN if self.mode == "train"
                else self.cfg.INPUT.INPUT_SIZE_TEST)
        image, mask = cv2_resize(image, mask, size)
        return image, mask, img_name[:-4]


class CityscapesDataSet(_Base):
    def __init__(self, data_root, num_classes=19, mode="train", transform=None,
                 ignore_label=255, debug=False):
        self.mode = mode
        self.data_root = data_root
        self.transform = transform
        self.ignore_label = ignore_label
        self.debug = debug
        self.image_paths = []
        for img_dir in sorted(glob(os.path.join(data_root, f"leftImg8bit/{mode}") + "/*/")):
            self.image_paths += sorted(glob(img_dir + "/*.png"))
        if num_classes == 16:  # SYNTHIA target mode
            self.id_to_trainid = SYNTHIA_ID_TO_TRAINID
            self.trainid2name = SYNTHIA_TRAINID2NAME
        else:
            self.id_to_trainid = CITYSCAPES_ID_TO_TRAINID
            self.trainid2name = CITYSCAPES_TRAINID2NAME

    def _label_path(self, path: str) -> str:
        img_name = os.path.basename(path)
        city = os.path.basename(os.path.dirname(path))
        return os.path.join(self.data_root, "gtFine", self.mode, city,
                            img_name.split("_leftImg8bit")[0] + "_gtFine_labelIds.png")

    def _label(self, path: str) -> np.ndarray:
        return remap_labels(_open_label(self._label_path(path)), self.id_to_trainid,
                            self.ignore_label)

    def __getitem__(self, index):
        path = self._path(index)
        image = self._open_rgb(path)
        label = Image.fromarray(self._label(path))
        return self._finish(image, label, os.path.basename(path)[:-4])


class CityscapesSelfDistillDataSet(CityscapesDataSet):
    """Pseudo-label training set: the labels are the PNGs in ``label_dir``
    (``PSEUDO_DIR/inference/<dataset>/`` of ``cli.test --saveres``), each
    named as its image; ids outside the train ids become ignore."""

    def __init__(self, data_root, label_dir, num_classes=19, mode="train",
                 transform=None, ignore_label=255, debug=False):
        super().__init__(data_root, num_classes, mode, transform, ignore_label, debug)
        self.label_dir = label_dir

    def _label(self, path: str) -> np.ndarray:
        label = _open_label(os.path.join(self.label_dir, os.path.basename(path)))
        identity = {k: k for k in self.trainid2name}
        return remap_labels(label, identity, self.ignore_label)


class GTA5FoldDataSet(_Base):
    def __init__(self, cfg, data_root, mode="train", cross_val=0, transform=None,
                 debug=False, ignore_label=255):
        self.cfg = cfg
        self.transform = transform
        self.ignore_label = ignore_label
        self.debug = debug
        self.image_paths = _kfold_image_paths(data_root, mode, cross_val or 0)
        self.id_to_trainid = CITYSCAPES_ID_TO_TRAINID
        self.trainid2name = CITYSCAPES_TRAINID2NAME

    def __getitem__(self, index):
        path = self._path(index)
        img_name = os.path.basename(path)
        img_dir = os.path.dirname(os.path.dirname(path))
        image = self._open_rgb(path)
        label = _open_label(os.path.join(img_dir, "labels", img_name))
        label = Image.fromarray(remap_labels(label, self.id_to_trainid, self.ignore_label))
        return self._finish(image, label, img_name[:-4])


class BLIDataset(_Base):
    EXTENSIONS = ("JPG", "jpg", "png", "jpeg")

    def __init__(self, cfg, data_root, mode="train", transform=None, debug=False):
        self.cfg = cfg
        self.mode = mode
        self.transform = transform
        self.debug = debug
        self.image_paths = [p for p in sorted(glob(os.path.join(data_root, "images") + "/*.*"))
                            if p.endswith(self.EXTENSIONS)]

    @staticmethod
    def mask_path(path: str) -> str:
        """``masks/<name[:-5]>.png``: right for ``.jpeg`` names only."""
        img_dir = os.path.dirname(os.path.dirname(path))
        return os.path.join(img_dir, "masks", os.path.basename(path)[:-5] + ".png")

    def __getitem__(self, index):
        path = self._path(index)
        image = np.asarray(self._open_rgb(path))
        mask = np.asarray(Image.open(self.mask_path(path)))
        if mask.ndim == 3:
            mask = mask[..., 0]
        mask = (mask / 255).astype(np.uint8)
        if self.transform is not None:
            image, mask = self.transform(image, mask)
        size = (self.cfg.INPUT.TARGET_INPUT_SIZE_TRAIN if self.mode == "train"
                else self.cfg.INPUT.INPUT_SIZE_TEST)
        image, mask = cv2_resize(image, mask, size)
        return image, mask, os.path.basename(path)[:-5]


class SynthiaDataSet(_Base):
    """SYNTHIA-RAND-CITYSCAPES: images under ``RGB/``, labels under
    ``GT/LABELS/`` (class ids in channel 0), remapped to the 16-class
    Cityscapes-compatible train ids; ``data_list`` (one image name a line)
    filters the images when the file exists."""

    ID_TO_TRAINID = {3: 0, 4: 1, 2: 2, 21: 3, 5: 4, 7: 5, 15: 6, 9: 7,
                     6: 8, 1: 9, 10: 10, 17: 11, 8: 12, 19: 13, 12: 14, 11: 15}

    def __init__(self, data_root, data_list="", num_classes=16, mode="train",
                 transform=None, ignore_label=255, debug=False):
        self.data_root = data_root
        self.transform = transform
        self.ignore_label = ignore_label
        self.debug = debug
        self.image_paths = sorted(glob(os.path.join(data_root, "RGB") + "/*.png"))
        if data_list and os.path.exists(data_list):
            with open(data_list) as fh:
                names = {line.strip() for line in fh}
            self.image_paths = [p for p in self.image_paths if os.path.basename(p) in names]

    def __getitem__(self, index):
        path = self._path(index)
        img_name = os.path.basename(path)
        image = self._open_rgb(path)
        label = np.asarray(Image.open(os.path.join(self.data_root, "GT/LABELS", img_name)))
        if label.ndim == 3:
            label = label[..., 0]
        label = Image.fromarray(remap_labels(label.astype(np.float32), self.ID_TO_TRAINID,
                                             self.ignore_label))
        return self._finish(image, label, img_name[:-4])


class SyntheticDataset(_Base):
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
        return self._finish(*self._gen(0 if self.debug else index))


class SyntheticSelfDistillDataset(SyntheticDataset):
    """The synthetic images paired with the pseudo-label PNGs that
    ``cli.test --saveres`` exported into ``label_dir``
    (``PSEUDO_DIR/inference/<dataset>/``), one ``<name>.png`` an image."""

    def __init__(self, label_dir: str, **kw):
        super().__init__(**kw)
        self.label_dir = label_dir

    def _gen(self, index):
        image, _, name = super()._gen(index)
        label = _open_label(os.path.join(self.label_dir, f"{name}.png"))
        return image, label, name
