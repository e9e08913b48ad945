"""Small dataset trees on disk, in each reader's layout, for the tests on the
CPU and the on-card smoke run (chip_smoke.py): the repository holds no
image, so both write what the readers of data/datasets.py read.

``write_dataset_trees(root, seed, trees)`` writes GTA5, Cityscapes, Kvasir
and BLI trees from ``seed``; each image is ``scene``: smooth noise with
discs of label ids tinted in, so that no codec sees a constant image.
PIL and numpy only.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
from PIL import Image

# the trees chip_smoke.py writes, per dataset: (train images, val or test
# images, size), the size a (w, h) or a range ((w, h) least, (w, h) most) to
# draw each image's from; Kvasir-SEG's frames run from 332x487 to 1350x1080
KVASIR_SIZES = ((332, 487), (1350, 1080))
DATA_TREES = {"gta5": (12, 4, (1914, 1052)), "cityscapes": (12, 4, (2048, 1024)),
              "kvasir": (120, 8, KVASIR_SIZES), "bli": (20, 8, KVASIR_SIZES)}
CITY = "aachen"


def draw_size(rng: np.random.RandomState, size) -> tuple:
    if isinstance(size[0], int):
        return tuple(size)
    (w0, h0), (w1, h1) = size
    return int(rng.randint(w0, w1 + 1)), int(rng.randint(h0, h1 + 1))


def scene(rng: np.random.RandomState, size, ids, background: int, blobs: int = 6):
    """A photograph's stand-in: smooth noise (coarse noise upsampled
    bilinearly, plus grain) with ``blobs`` discs, each of an id from ``ids``,
    tinted into the image; returns the uint8 HxWx3 image and the uint8 HxW
    label (``background`` outside the discs)."""
    w, h = draw_size(rng, size)
    coarse = rng.randint(0, 256, (max(h // 32, 2), max(w // 32, 2), 3)).astype(np.uint8)
    image = np.asarray(Image.fromarray(coarse).resize((w, h), Image.BILINEAR), np.int16)
    image = image + rng.randint(-12, 13, (h, w, 3), dtype=np.int16)
    label = np.full((h, w), background, np.uint8)
    yy, xx = np.ogrid[:h, :w]
    for _ in range(blobs):
        cy, cx = rng.randint(0, h), rng.randint(0, w)
        r = rng.randint(max(min(h, w) // 16, 1), max(min(h, w) // 4, 2))
        disc = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
        label[disc] = ids[rng.randint(len(ids))]
        image[disc] = (image[disc] + rng.randint(0, 256, 3)) // 2
    return np.clip(image, 0, 255).astype(np.uint8), label


def write_dataset_trees(root: str, seed: int = 0, trees=None) -> dict:
    """Writes each dataset of ``trees`` (DATA_TREES by default) under ``root``
    in its on-disk layout, from ``seed``; returns {dataset: files written}.

      gta5/fold{0,1}/{images,labels}/NNNNN.png  labelIds 0..33; with
          DATASETS.CROSS_VAL 0 fold0 is val and fold1 train
      cityscapes/leftImg8bit/{train,val}/<city>/<city>_NNNNNN_000019_leftImg8bit.png
      cityscapes/gtFine/{train,val}/<city>/<city>_NNNNNN_000019_gtFine_labelIds.png
      kvasir/fold{0,1}/{images,masks}/NNNNN.png  masks 0/1, one channel
      BLI/{train,test}/images/NNNNN.jpeg, BLI/{train,test}/masks/NNNNN.png  masks 0/255

    The images are encoded on a pool of threads."""
    rng = np.random.RandomState(seed)
    trees = DATA_TREES if trees is None else trees
    city_ids, polyp = list(range(34)), [1]
    jobs, written = [], {}

    def add(path, array, **kw):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        jobs.append((path, array, kw))

    for dataset, (n_train, n_val, size) in trees.items():
        splits = ((("fold1", n_train), ("fold0", n_val)) if dataset in ("gta5", "kvasir")
                  else (("train", n_train), ("val" if dataset == "cityscapes" else "test",
                                             n_val)))
        count = 0
        for split, n in splits:
            for _ in range(n):
                count += 1
                if dataset == "gta5":
                    image, label = scene(rng, size, city_ids, 7)
                    base = os.path.join(root, "gta5", split)
                    add(os.path.join(base, "images", f"{count:05d}.png"), image)
                    add(os.path.join(base, "labels", f"{count:05d}.png"), label)
                elif dataset == "cityscapes":
                    image, label = scene(rng, size, city_ids, 7)
                    stem = f"{CITY}_{count:06d}_000019"
                    add(os.path.join(root, "cityscapes", "leftImg8bit", split, CITY,
                                     f"{stem}_leftImg8bit.png"), image)
                    add(os.path.join(root, "cityscapes", "gtFine", split, CITY,
                                     f"{stem}_gtFine_labelIds.png"), label)
                elif dataset == "kvasir":
                    image, label = scene(rng, size, polyp, 0, blobs=2)
                    base = os.path.join(root, "kvasir", split)
                    add(os.path.join(base, "images", f"{count:05d}.png"), image)
                    add(os.path.join(base, "masks", f"{count:05d}.png"), label)
                else:
                    image, label = scene(rng, size, polyp, 0, blobs=2)
                    base = os.path.join(root, "BLI", split)
                    add(os.path.join(base, "images", f"{count:05d}.jpeg"), image, quality=90)
                    add(os.path.join(base, "masks", f"{count:05d}.png"), label * 255)
        written[dataset] = 2 * count

    def save(job):
        path, array, kw = job
        Image.fromarray(array).save(path, **kw)

    with ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(save, jobs))
    return written
