from .augment import Augmenter, cv2_resize
from .catalog import DatasetCatalog, build_dataset
from .datasets import SyntheticDataset
from .loader import (DataLoader, build_collate_fn, default_collate,
                     device_prefetch, preprocess_eval_image)
from .overlap import measure_overlap, stage_times

__all__ = ["Augmenter", "DatasetCatalog", "DataLoader", "SyntheticDataset",
           "build_collate_fn", "build_dataset", "cv2_resize", "default_collate",
           "device_prefetch", "measure_overlap", "preprocess_eval_image", "stage_times"]
