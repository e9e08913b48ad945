"""Host data loader with worker threads or processes, and device prefetch
(counterpart of the JAX package's data/loader.py).

Decode and augmentation run on host threads (DATA_PIPE.NUM_WORKERS) or, with
``worker_processes > 0`` (DATA_PIPE.WORKER_PROCESSES), in that many forked
worker processes (``_ProcessPool``); batches are stacked NHWC as in the JAX
package, and ``device_prefetch`` keeps ``DATA_PIPE.PREFETCH`` batches in
flight to the device through pinned host buffers, in the parent.  The shuffle
order is ``np.random.default_rng((seed, epoch)).permutation``, the JAX
package's, so both packages draw the same batches, in the same order with
threads or processes.

Two ways to split the data over a world of processes (parallel/dist.py):
  * ``process_shard`` (eval): ``DistributedSampler`` semantics, the JAX
    package's: process i of n takes ``order[i::n][:len // n]`` and batches
    it; the last ``len % n`` items of the order are left out
    (``left_out``);
  * ``global_batch_slice(rank, world)`` (the trainers): every rank walks
    the same global order and batches, and loads only its ``batch_size /
    world`` contiguous rows of each, so that a step of ``world`` ranks sees
    the batch of one process.

Collate conventions: uint8 HWC images -> float/255; float images pass
through; labels -> int32 [B,H,W].
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import random
import shutil
import tempfile
import traceback
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from ..parallel.dist import rank, world_size


def preprocess_eval_image(image, transform) -> np.ndarray:
    """An RGB image (PIL or HWC array) -> model-input float32 HWC via a test
    transform, with the collate rescale rule: uint8 outputs (identity
    pipelines) are divided by 255, float outputs pass through.  The label is
    a float32 zero image of the image's size, as in the JAX package: the
    ``pra`` transform resizes it with the image."""
    h, w = ((image.height, image.width) if hasattr(image, "height")
            else np.asarray(image).shape[:2])
    img, _ = transform(image, np.zeros((h, w), np.float32))
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


def _spill(batch: dict, path: str) -> dict:
    """Writes the arrays of ``batch`` one after another into the file
    ``path``; returns what ``_unspill`` needs to read them back."""
    arrays, rest, offset = [], {}, 0
    with open(path, "wb") as fh:
        for key, value in batch.items():
            if isinstance(value, np.ndarray):
                value = np.ascontiguousarray(value)
                value.tofile(fh)
                arrays.append((key, value.shape, value.dtype.str, offset))
                offset += value.nbytes
            else:
                rest[key] = value
    return {"path": path, "arrays": arrays, "rest": rest}


def _unspill(spilled: dict) -> dict:
    """The batch ``_spill`` wrote; removes its file."""
    path = spilled["path"]
    batch = {key: np.fromfile(path, dtype=np.dtype(dtype), count=int(np.prod(shape)),
                              offset=offset).reshape(shape)
             for key, shape, dtype, offset in spilled["arrays"]}
    os.remove(path)
    return {**batch, **spilled["rest"]}


def _worker_main(dataset, collate_fn, task_q, result_q, seed, worker_id, spill_dir):
    """A worker process: takes ``(serial, seq, indices)`` tasks and puts
    ``(serial, seq, spilled batch, error)`` results, the batch's arrays in a
    file of ``spill_dir`` (``_spill``).  It runs ``__getitem__`` and the
    collate only, numpy and PIL, and no torch operation: it was forked from a
    process that may hold a CUDA context and torch's thread pools, which a
    child must not touch.  ``random`` and ``np.random`` are reseeded per
    worker, as in the JAX package: an ``Augmenter`` built without its own
    ``rng`` draws from ``random``, so the workers' augmentation draws differ,
    and equal the JAX workers' for the same seed.  As with torch's workers,
    the draws depend on the number of workers."""
    np.random.seed((int(seed) + 7919 * (worker_id + 1)) % (2 ** 32))
    random.seed(int(seed) + 104729 * (worker_id + 1))
    while True:
        task = task_q.get()
        if task is None:
            return
        serial, seq, idxs = task
        try:
            batch = collate_fn([dataset[i] for i in idxs])
            spilled = _spill(batch, os.path.join(spill_dir, f"{serial}-{seq}.batch"))
            result_q.put((serial, seq, spilled, None))
        except Exception:  # the parent raises it, with this traceback
            result_q.put((serial, seq, None, traceback.format_exc()))


class _ProcessPool:
    """Persistent fork-based loader workers, the process counterpart of
    torch's ``DataLoader(num_workers=N)``.

    Threads cannot run the per-item Python and PIL work in parallel (the
    interpreter lock), so this pool uses processes.  The dataset is inherited
    by fork (copy-on-write, nothing pickled), each worker has its own task
    queue (round-robin by batch sequence number), and one shared result queue
    feeds a reorder buffer in the parent, so the batches come in the order
    the threads give.  Results carry the iteration's serial, so the batches
    still in flight from an abandoned iteration are dropped.  A batch's
    arrays come back through a file in the pool's temporary directory (under
    TMPDIR), and only the file's name and the arrays' layout through the
    queue: a pipe moves data 64 KB a system call, which on a sandboxed host
    made the transfer of a batch of 20 float32 images at 512x512 slower than
    making it.  ``close()`` removes the directory with whatever is left in it.

    A fork copies only the calling thread: a lock that another thread of the
    parent held at that moment stays held in the child.  ``DataLoader`` forks
    when it is built (the CLIs build loaders before the first training step),
    the workers never call torch, and ``get`` raises when a worker died or
    when all have been silent for ``_STALL_LIMIT_S``, instead of waiting
    forever.  A failed fork raises; there is no fallback to threads."""

    _GET_TIMEOUT_S = 5.0
    _STALL_LIMIT_S = 300.0

    def __init__(self, dataset, collate_fn, num_procs: int, seed: int):
        ctx = multiprocessing.get_context("fork")
        self.closed = False
        self._spill_dir = tempfile.mkdtemp(prefix="loader_batches_")
        self._result_q = ctx.Queue()
        self._task_qs = [ctx.Queue() for _ in range(num_procs)]
        self._procs = []
        for wid, tq in enumerate(self._task_qs):
            p = ctx.Process(target=_worker_main,
                            args=(dataset, collate_fn, tq, self._result_q, seed, wid,
                                  self._spill_dir),
                            daemon=True)
            try:
                p.start()
            except BaseException:
                self.close()
                raise
            self._procs.append(p)

    def submit(self, serial: int, seq: int, idxs) -> None:
        self._task_qs[seq % len(self._task_qs)].put((serial, seq, [int(i) for i in idxs]))

    def get(self, serial: int):
        """The next ``(seq, batch)`` of iteration ``serial``; results of other
        iterations are dropped."""
        waited = 0.0
        while True:
            try:
                got_serial, seq, batch, err = self._result_q.get(timeout=self._GET_TIMEOUT_S)
            except queue.Empty:
                dead = [p for p in self._procs if not p.is_alive()]
                if dead:
                    self.close()
                    raise RuntimeError("loader worker process(es) died: " + ", ".join(
                        f"pid={p.pid} exitcode={p.exitcode}" for p in dead))
                waited += self._GET_TIMEOUT_S
                if waited >= self._STALL_LIMIT_S:
                    self.close()
                    raise RuntimeError(
                        f"loader workers alive but silent for {waited:.0f} s: a lock "
                        f"inherited by the fork, or a stuck __getitem__; set "
                        f"DATA_PIPE.WORKER_PROCESSES 0 (threads), or build the loaders "
                        f"before the first device work")
                continue
            waited = 0.0
            if got_serial != serial:
                if batch is not None:
                    os.remove(batch["path"])
                continue
            if err is not None:
                self.close()
                raise RuntimeError(f"loader worker failed:\n{err}")
            return seq, _unspill(batch)

    def close(self) -> None:
        """Stops and joins every worker (terminating those that do not stop
        within 5 s) and closes the queues; a second call does nothing."""
        if self.closed:
            return
        self.closed = True
        for tq in self._task_qs:
            try:
                tq.put(None)
            except (ValueError, OSError):
                pass
        for p in self._procs:
            p.join(timeout=5)
        for p in self._procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        for q_ in [*self._task_qs, self._result_q]:
            q_.cancel_join_thread()
            q_.close()
        shutil.rmtree(self._spill_dir, ignore_errors=True)


class DataLoader:
    """``worker_processes > 0`` moves decode, augmentation and collate from
    the thread pool to that many forked worker processes (``_ProcessPool``,
    forked when the loader is built); the batches and their order are the
    threads' for a deterministic dataset.  ``close()`` stops the workers;
    they also stop when the loader is garbage-collected.

    ``process_shard`` takes the shard of process ``process_index`` of
    ``process_count`` (by default this process's rank and world size); its
    ``batch_size`` is the per-process one."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, num_workers: int = 4,
                 collate_fn=None, seed: int = 0, process_shard: bool = False,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None,
                 worker_processes: int = 0):
        self.process_shard = process_shard
        self.process_index = rank() if process_index is None else int(process_index)
        self.process_count = world_size() if process_count is None else int(process_count)
        self._slice = (0, 1)  # (rank, world) of global_batch_slice
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(num_workers, 1)
        self.collate_fn = collate_fn or default_collate
        self.seed = seed
        self._epoch = 0  # advanced per __iter__; see set_epoch
        self.worker_processes = int(worker_processes)
        self._pool: Optional[_ProcessPool] = None
        self._iter_serial = 0  # one per __iter__ of the process path
        if self.worker_processes > 0:
            self._ensure_pool()

    def _local_len(self) -> int:
        n = len(self.dataset)
        return n // self.process_count if self.process_shard else n

    def __len__(self):
        n = self._local_len()
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def left_out(self) -> List[int]:
        """The dataset indices that no process takes under ``process_shard``
        (the last ``len % process_count`` of the order); empty otherwise."""
        if not self.process_shard:
            return []
        per = self._local_len()
        return [int(i) for i in self._order()[per * self.process_count:]]

    def global_batch_slice(self, rank_: int, world: int) -> "DataLoader":
        """From the next iteration on, loads only rows ``[rank_ * b, (rank_ + 1)
        * b)`` of each global batch, ``b = batch_size / world``; the order and
        the batches stay the global ones.  Returns the loader."""
        if self.process_shard or not self.drop_last:
            raise ValueError("global_batch_slice splits whole global batches: it takes "
                             "drop_last and no process_shard")
        if self.batch_size % world or not 0 <= rank_ < world:
            raise ValueError(f"batch_size={self.batch_size}: a slice of rank {rank_} of "
                             f"a world of {world} needs a batch the world divides")
        self._slice = (int(rank_), int(world))
        return self

    def _order(self) -> np.ndarray:
        if self.shuffle:
            return np.random.default_rng((self.seed, self._epoch)).permutation(
                len(self.dataset))
        return np.arange(len(self.dataset))

    def set_epoch(self, epoch: int) -> None:
        """Pins the shuffle order of the NEXT iteration to a pure function of
        (seed, epoch), so a run resumed at epoch k shuffles epoch k as the
        uninterrupted run did."""
        self._epoch = int(epoch)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self._order()
        if self.shuffle:
            self._epoch += 1  # callers that never set_epoch still reshuffle
        if self.process_shard:
            per = self._local_len()
            order = order[self.process_index::self.process_count][:per]
        if self.drop_last:
            order = order[: len(self) * self.batch_size]
        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        rank_, world = self._slice
        if world > 1:
            rows = self.batch_size // world
            batches = [idxs[rank_ * rows:(rank_ + 1) * rows] for idxs in batches]
        if self.worker_processes > 0:
            yield from self._iter_procs(batches)
            return

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            # pipeline two batches ahead of the consumer
            pending = []
            for idxs in batches:
                pending.append(pool.map(self.dataset.__getitem__, idxs))
                if len(pending) > 2:
                    yield self.collate_fn(list(pending.pop(0)))
            for fut in pending:
                yield self.collate_fn(list(fut))

    def _ensure_pool(self) -> _ProcessPool:
        if self._pool is None or self._pool.closed:
            pool = _ProcessPool(self.dataset, self.collate_fn, self.worker_processes,
                                self.seed)
            weakref.finalize(self, _ProcessPool.close, pool)  # workers die with the loader
            self._pool = pool
        return self._pool

    def _iter_procs(self, batches) -> Iterator[Dict[str, np.ndarray]]:
        pool = self._ensure_pool()
        self._iter_serial += 1
        serial = self._iter_serial
        depth = max(2 * self.worker_processes, 2)  # batches in flight at most
        next_submit = next_yield = 0
        reorder: Dict[int, dict] = {}
        while next_yield < len(batches):
            while next_submit < len(batches) and next_submit - next_yield < depth:
                pool.submit(serial, next_submit, batches[next_submit])
                next_submit += 1
            while next_yield not in reorder:
                seq, batch = pool.get(serial)
                reorder[seq] = batch
            yield reorder.pop(next_yield)
            next_yield += 1

    def close(self) -> None:
        """Stops the worker processes (nothing to do with threads)."""
        if self._pool is not None:
            self._pool.close()
            self._pool = None


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
