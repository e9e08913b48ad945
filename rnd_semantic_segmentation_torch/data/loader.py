"""Host data loader with worker threads and device prefetch (counterpart of
the JAX package's data/loader.py).

Decode and augmentation run on host threads, batches are stacked NHWC as in
the JAX package, and ``device_prefetch`` keeps ``DATA_PIPE.PREFETCH`` batches
in flight to the device through pinned host buffers.  The shuffle order is
``np.random.default_rng((seed, epoch)).permutation``, the JAX package's, so
both packages draw the same batches.  Worker processes and per-process shards
come with the parallelism slice and raise here.

Collate conventions: uint8 HWC images -> float/255; float images pass
through; labels -> int32 [B,H,W].
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np
import torch


def preprocess_eval_image(image, transform) -> np.ndarray:
    """An RGB image (PIL or HWC array) -> model-input float32 HWC via a test
    transform, with the collate rescale rule: uint8 outputs (identity
    pipelines) are divided by 255, float outputs pass through."""
    img, _ = transform(image, None)
    img = np.asarray(img)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    return img.astype(np.float32)


def default_collate(samples):
    images, labels, names = zip(*samples)
    images = np.stack([np.asarray(im) for im in images], axis=0)
    if images.dtype == np.uint8:
        images = images.astype(np.float32) / 255.0
    labels = np.stack([np.asarray(l) for l in labels], axis=0)
    if labels.ndim == 4:  # [B,H,W,1] -> [B,H,W]
        labels = labels[..., 0]
    labels = labels.astype(np.int32)
    return {"image": images.astype(np.float32), "label": labels,
            "name": list(names)}


# with NHWC arrays the attn and pranet collates reduce to the default
COLLATE_FNS = {"attn": default_collate, "pranet": default_collate,
               None: default_collate, "None": default_collate}


def build_collate_fn(cfg):
    return COLLATE_FNS.get(cfg.AUG.COLLATE, default_collate)


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, num_workers: int = 4,
                 collate_fn=None, seed: int = 0, process_shard: bool = False,
                 worker_processes: int = 0):
        if process_shard:
            raise NotImplementedError(
                "process_shard: per-process loader shards come with the port's "
                "parallelism slice")
        if int(worker_processes) > 0:
            raise NotImplementedError(
                "DATA_PIPE.WORKER_PROCESSES > 0: loader worker processes are not "
                "ported yet; the port's loader uses DATA_PIPE.NUM_WORKERS threads")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(num_workers, 1)
        self.collate_fn = collate_fn or default_collate
        self.seed = seed
        self._epoch = 0  # advanced per __iter__; see set_epoch

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        """Pins the shuffle order of the NEXT iteration to a pure function of
        (seed, epoch), so a run resumed at epoch k shuffles epoch k as the
        uninterrupted run did."""
        self._epoch = int(epoch)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.shuffle:
            order = np.random.default_rng(
                (self.seed, self._epoch)).permutation(len(self.dataset))
            self._epoch += 1  # callers that never set_epoch still reshuffle
        else:
            order = np.arange(len(self.dataset))
        if self.drop_last:
            order = order[: len(self) * self.batch_size]
        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            # pipeline two batches ahead of the consumer
            pending = []
            for idxs in batches:
                pending.append(pool.map(self.dataset.__getitem__, idxs))
                if len(pending) > 2:
                    yield self.collate_fn(list(pending.pop(0)))
            for fut in pending:
                yield self.collate_fn(list(fut))


def device_prefetch(iterator, size: int = 2, device="cpu"):
    """Keeps ``size`` batches in flight to ``device``: arrays become tensors
    there, everything else passes through.  To a CUDA device an array goes
    through a pinned host buffer and an asynchronous copy; PyTorch's pinned
    allocator caches the buffers and hands one out again only after the copy
    that read it has finished."""
    device = torch.device(device)

    def put(batch):
        out = {}
        for k, v in batch.items():
            if isinstance(v, np.ndarray):
                v = torch.from_numpy(v)
                if device.type == "cuda":
                    v = v.pin_memory().to(device, non_blocking=True)
            out[k] = v
        return out

    buf = []
    for batch in iterator:
        buf.append(put(batch))
        if len(buf) >= max(int(size), 1):
            yield buf.pop(0)
    while buf:
        yield buf.pop(0)
