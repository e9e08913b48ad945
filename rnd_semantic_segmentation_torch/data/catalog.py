"""Dataset name catalog and build functions (counterpart of the JAX package's
data/catalog.py).

This slice knows the ``synthetic_*`` names (``synthetic_train``,
``synthetic_val``, and the covariate-shifted ``synthetic_shift[_swap|_blend|_dim]_*``
target domains), whose size comes from the config; every other name raises
NotImplementedError until the data slice is ported.
"""

from __future__ import annotations

from .augment import Augmenter
from .datasets import SyntheticDataset


class DatasetCatalog:
    @staticmethod
    def get(cfg, name: str, mode: str, num_classes: int, transform=None,
            cross_val=None):
        if "synthetic" in name and "distill" not in name:
            w, h = cfg.INPUT.SOURCE_INPUT_SIZE_TRAIN if mode == "train" \
                else cfg.INPUT.INPUT_SIZE_TEST
            shift = "none"
            for variant in ("swap", "blend", "dim"):  # synthetic_shift[_<v>]
                if variant in name:
                    shift = variant
            if shift == "none" and "shift" in name:
                shift = "swap"
            return SyntheticDataset(size=(h, w), num_classes=num_classes,
                                    transform=transform, seed=cfg.DATA_PIPE.SEED,
                                    shift=shift, length=cfg.DATASETS.SYNTHETIC_LENGTH)
        raise NotImplementedError(
            f"dataset {name!r} is not ported yet: the port reads the synthetic_* "
            f"datasets only so far")


def build_dataset(cfg, mode: str = "train", is_source: bool = True):
    assert mode in ("train", "val", "test")
    if cfg.DATA_PIPE.NATIVE_DECODE:
        raise NotImplementedError("DATA_PIPE.NATIVE_DECODE is not ported yet")
    transform = Augmenter(cfg, mode, is_source).build_transform()
    if mode == "train":
        name = cfg.DATASETS.SOURCE_TRAIN if is_source else cfg.DATASETS.TARGET_TRAIN
    else:
        name = cfg.DATASETS.TEST
    ds_mode = {"train": "train", "val": "val"}.get(mode) or name.split("_")[-1]
    return DatasetCatalog.get(cfg, name, ds_mode, num_classes=cfg.MODEL.NUM_CLASSES,
                              transform=transform, cross_val=cfg.DATASETS.CROSS_VAL)
