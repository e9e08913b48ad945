"""Checkpoints written in the background (counterpart of the JAX package's
``save_checkpoint(..., wait=False)`` and ``wait_for_checkpoints`` in
ckpt/orbax_io.py), for SOLVER.ASYNC_CHECKPOINT.

``snapshot`` copies every tensor of a checkpoint to host memory, in order,
before it returns: a CUDA tensor into pinned memory by an asynchronous copy
on the current stream, which the next step's kernels follow, so they cannot
change what is copied; a CPU tensor by a clone.  One writer thread then
waits for those copies (a CUDA event), ``torch.save``s the checkpoint to a
temporary file and renames it into place, as the synchronous save does.

A write's exception is kept and raised in the caller's thread by the next
``wait`` (or ``wait_for_checkpoints``), never dropped.
``wait_for_checkpoints`` waits for every writer of the process, so that a
``resume latest`` or a load never reads a checkpoint while it is written.
"""

from __future__ import annotations

import os
import threading
import weakref
from concurrent.futures import Future, ThreadPoolExecutor
from typing import List, Mapping, Optional

import torch

_WRITERS: "weakref.WeakSet[AsyncCheckpointWriter]" = weakref.WeakSet()
_WRITERS_LOCK = threading.Lock()


def write_file(path: str, ckpt) -> str:
    """``torch.save`` to a temporary name, then renamed to ``path``: a run cut
    during the write leaves no half-written checkpoint behind."""
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    torch.save(ckpt, tmp)
    os.replace(tmp, path)
    return path


def snapshot(obj):
    """``obj`` with every tensor copied to host memory (see the module's
    docstring); returns ``(copy, event)``, ``event`` the CUDA event that the
    copies end before, or None when no tensor was on a card."""
    cuda = []

    def copy(o):
        if isinstance(o, torch.Tensor):
            o = o.detach()
            if o.is_cuda:
                host = torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                host.copy_(o, non_blocking=True)
                cuda.append(o.device)
                return host
            return o.clone()
        if isinstance(o, Mapping):
            return {k: copy(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return type(o)(copy(v) for v in o)
        return o

    out = copy(obj)
    event = None
    if cuda:
        event = torch.cuda.Event()
        event.record()
    return out, event


def _write_after(event: Optional[torch.cuda.Event], path: str, ckpt) -> str:
    if event is not None:
        event.synchronize()
    return write_file(path, ckpt)


class AsyncCheckpointWriter:
    """One background thread that writes checkpoints in the order given."""

    def __init__(self):
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt-writer")
        self._pending: List[Future] = []
        with _WRITERS_LOCK:
            _WRITERS.add(self)

    def submit(self, path: str, ckpt) -> None:
        """Snapshots ``ckpt`` now and writes it to ``path`` in the background."""
        copy, event = snapshot(ckpt)
        self._pending.append(self._pool.submit(_write_after, event, path, copy))

    def wait(self) -> None:
        """Waits for every write submitted so far; raises the first error."""
        pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()

    def close(self) -> None:
        """Waits, then stops the thread."""
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)


def wait_for_checkpoints() -> None:
    """Waits for the writes of every writer of this process."""
    with _WRITERS_LOCK:
        writers = list(_WRITERS)
    for writer in writers:
        writer.wait()
