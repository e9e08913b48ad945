from .augment import Augmenter
from .catalog import DatasetCatalog, build_dataset
from .datasets import SyntheticDataset
from .loader import (DataLoader, build_collate_fn, default_collate,
                     device_prefetch, preprocess_eval_image)

__all__ = ["Augmenter", "DatasetCatalog", "DataLoader", "SyntheticDataset",
           "build_collate_fn", "build_dataset", "default_collate",
           "device_prefetch", "preprocess_eval_image"]
