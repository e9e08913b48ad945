"""Logger setup: file + stream handlers (utility.py:238-249 semantics)."""

from __future__ import annotations

import logging
import os


def setup_logger(name: str, save_dir: str, distributed_rank: int = 0) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    if logger.handlers:
        return logger
    fmt = logging.Formatter("%(asctime)s [%(levelname)s] %(message)s")
    if distributed_rank == 0:
        stream = logging.StreamHandler()
        stream.setFormatter(fmt)
        logger.addHandler(stream)
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            fh = logging.FileHandler(os.path.join(save_dir, name + ".txt"))
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger
