"""Dataset name catalog and build functions (counterpart of the JAX package's
data/catalog.py).

``DatasetCatalog.DATASETS`` maps each name of the configs to its folder under
DATASETS.DATASET_DIR; ``DatasetCatalog.get`` picks the reader by substring,
in the JAX package's order: ``synthetic`` (``distill``: the pseudo-label
variant, its labels in PSEUDO_DIR/inference/synthetic_val), ``gta5``,
``synthia``, ``cityscapes`` (``distill``: labels in the name's
``label_dir``), ``kvasir``, ``polyp``, ``bli``.  A name in none of these
raises RuntimeError.  The synthetic sizes come from the config
(INPUT.SOURCE_INPUT_SIZE_TRAIN in train mode, else INPUT.INPUT_SIZE_TEST;
DATASETS.SYNTHETIC_LENGTH images).

``build_dataset`` gives the reader of DATASETS.SOURCE_TRAIN or TARGET_TRAIN
in train mode, and of DATASETS.TEST otherwise, with the ``Augmenter``'s
transform; in test mode the reader's mode is the last word of the name
(``cityscapes_train`` reads the train split).  DATA_PIPE.NATIVE_DECODE
sets the reader's ``use_native_decode``, as the JAX ``_apply_pipe_options``
does, after loading the libjpeg/libpng decoder (``native_decode``), which
raises when it cannot be built or loaded: there is no quiet fallback to PIL.
"""

from __future__ import annotations

import os
from typing import Optional

from . import native_decode
from .augment import Augmenter
from .datasets import (
    BLIDataset,
    CityscapesDataSet,
    CityscapesSelfDistillDataSet,
    GTA5FoldDataSet,
    KvasirDataSet,
    KvasirFoldDataset,
    SynthiaDataSet,
    SyntheticDataset,
    SyntheticSelfDistillDataset,
)


class DatasetCatalog:
    DATASETS = {
        "gta5_train": {"data_dir": "gta5", "data_list": "gta5_train_list.txt"},
        "gta5_val": {"data_dir": "gta5", "data_list": "gta5_train_list.txt"},
        "synthia_train": {"data_dir": "synthia", "data_list": "synthia_train_list.txt"},
        "cityscapes_train": {"data_dir": "cityscapes", "data_list": "cityscapes_train_list.txt"},
        "cityscapes_self_distill_train": {
            "data_dir": "cityscapes", "data_list": "cityscapes_train_list.txt",
            "label_dir": "cityscapes/soft_labels/inference/cityscapes_train"},
        "cityscapes_val": {"data_dir": "cityscapes", "data_list": "cityscapes_val_list.txt"},
        "kvasir_train": {"data_dir": "kvasir", "data_list": ""},
        "kvasir_val": {"data_dir": "kvasir", "data_list": ""},
        "polyp_train": {"data_dir": "kvasir", "data_list": ""},
        "polyp_val": {"data_dir": "kvasir", "data_list": ""},
        "bli_train": {"data_dir": "BLI/train", "data_list": ""},
        "bli_val": {"data_dir": "BLI/test", "data_list": ""},
        "synthetic_train": {"data_dir": "", "data_list": ""},
        "synthetic_val": {"data_dir": "", "data_list": ""},
        # the covariate-shifted target domain and the pseudo-label variant
        "synthetic_shift_train": {"data_dir": "", "data_list": ""},
        "synthetic_shift_val": {"data_dir": "", "data_list": ""},
        "synthetic_self_distill_train": {"data_dir": "", "data_list": ""},
    }

    @staticmethod
    def get(cfg, name: str, mode: str, num_classes: int, transform=None,
            cross_val: Optional[int] = None):
        data_dir = cfg.DATASETS.DATASET_DIR
        attrs = DatasetCatalog.DATASETS.get(name, {"data_dir": name})
        root = os.path.join(data_dir, attrs["data_dir"])
        if "synthetic" in name:
            w, h = cfg.INPUT.SOURCE_INPUT_SIZE_TRAIN if mode == "train" \
                else cfg.INPUT.INPUT_SIZE_TEST
            shift = "none"
            for variant in ("swap", "blend", "dim"):  # synthetic_shift[_<v>]
                if variant in name:
                    shift = variant
            if shift == "none" and "shift" in name:
                shift = "swap"
            kw = dict(size=(h, w), num_classes=num_classes, transform=transform,
                      seed=cfg.DATA_PIPE.SEED, shift=shift,
                      length=cfg.DATASETS.SYNTHETIC_LENGTH)
            if "distill" in name:
                label_dir = os.path.join(cfg.PSEUDO_DIR, "inference", "synthetic_val")
                return SyntheticSelfDistillDataset(label_dir, **kw)
            return SyntheticDataset(**kw)
        if "gta5" in name:
            return GTA5FoldDataSet(cfg, root, mode=mode, cross_val=cross_val,
                                   transform=transform)
        if "synthia" in name:
            return SynthiaDataSet(root, data_list=os.path.join(data_dir,
                                                               attrs.get("data_list", "")),
                                  num_classes=num_classes, mode=mode, transform=transform)
        if "cityscapes" in name:
            if "distill" in name:
                label_dir = os.path.join(data_dir, attrs["label_dir"])
                return CityscapesSelfDistillDataSet(root, label_dir, num_classes=num_classes,
                                                    mode=mode, transform=transform)
            return CityscapesDataSet(root, num_classes=num_classes, mode=mode,
                                     transform=transform)
        if "kvasir" in name:
            return KvasirDataSet(root, num_classes=num_classes, mode=mode,
                                 cross_val=cross_val, transform=transform)
        if "polyp" in name:
            return KvasirFoldDataset(cfg, root, mode=mode, cross_val=cross_val,
                                     transform=transform)
        if "bli" in name:
            return BLIDataset(cfg, root, mode=mode, transform=transform)
        raise RuntimeError(f"Dataset not available: {name}")


def build_dataset(cfg, mode: str = "train", is_source: bool = True):
    assert mode in ("train", "val", "test")
    transform = Augmenter(cfg, mode, is_source).build_transform()
    if mode == "train":
        name = cfg.DATASETS.SOURCE_TRAIN if is_source else cfg.DATASETS.TARGET_TRAIN
    else:
        name = cfg.DATASETS.TEST
    ds_mode = {"train": "train", "val": "val"}.get(mode) or name.split("_")[-1]
    dataset = DatasetCatalog.get(cfg, name, ds_mode, num_classes=cfg.MODEL.NUM_CLASSES,
                                 transform=transform, cross_val=cfg.DATASETS.CROSS_VAL)
    if cfg.DATA_PIPE.NATIVE_DECODE:
        native_decode.load_library()
        dataset.use_native_decode = True
    return dataset
