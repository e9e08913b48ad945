"""Training checkpoints (counterpart of the JAX package's ckpt/orbax_io.py,
with the same function names).

A checkpoint is one file ``{Prefix}-{epoch}.pth`` in the reference's layout:
the per-part ``state_dict``s under the part names, the per-part optimizer
states under ``optimizer_<part>``, and ``epoch`` and ``step``.  It holds
tensors and plain Python containers only, so it loads with
``torch.load(..., weights_only=True)``, and
``torch_import.load_reference_checkpoint`` reads the model parts of it for
``Tester`` and the server.

``save_checkpoint(..., writer=...)`` hands the file to an
``async_writer.AsyncCheckpointWriter`` (SOLVER.ASYNC_CHECKPOINT): the
tensors are copied before it returns, the file is written in the
background.  ``latest_checkpoint`` and ``load_checkpoint`` first wait for
every write in flight in the process.
"""

from __future__ import annotations

import os
import re
from typing import Mapping, Optional

import torch
from torch import nn

from ..train.state import TrainState
from .async_writer import AsyncCheckpointWriter, wait_for_checkpoints, write_file
from .torch_import import load_part

OPTIMIZER_PREFIX = "optimizer_"


def checkpoint_name(output_dir: str, prefix: str, epoch: int) -> str:
    return os.path.join(output_dir, f"{prefix}-{epoch}.pth")


def _found(output_dir: str, prefix: str):
    if not os.path.isdir(output_dir):
        return []
    pattern = re.compile(rf"{re.escape(prefix)}-(\d+)\.pth")
    return sorted((int(m.group(1)), os.path.join(output_dir, entry))
                  for entry in os.listdir(output_dir)
                  if (m := pattern.fullmatch(entry)))


def latest_checkpoint(output_dir: str, prefix: str) -> Optional[str]:
    wait_for_checkpoints()
    found = _found(output_dir, prefix)
    return found[-1][1] if found else None


def prune_checkpoints(output_dir: str, prefix: str, keep: int) -> None:
    """Keeps only the newest ``keep`` checkpoints of ``prefix``; ``keep < 0``
    keeps all, ``keep == 0`` deletes all."""
    if keep < 0:
        return
    found = _found(output_dir, prefix)
    for _, path in (found[:-keep] if keep > 0 else found):
        os.remove(path)


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, Mapping):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save_checkpoint(path: str, modules: Mapping[str, nn.Module], state: TrainState,
                    epoch: int, writer: Optional[AsyncCheckpointWriter] = None) -> str:
    """Writes the file under a temporary name and renames it, so a run cut
    during the save leaves no half-written checkpoint behind; with a
    ``writer``, in its background thread, after the tensors were copied."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    ckpt = {"epoch": int(epoch), "step": int(state.step)}
    for name, module in modules.items():
        ckpt[name] = module.state_dict()
        ckpt[OPTIMIZER_PREFIX + name] = state.optimizers[name].state_dict()
    if writer is not None:
        writer.submit(path, ckpt)
        return path
    return write_file(path, _to_cpu(ckpt))


def load_checkpoint(path: str, modules: Mapping[str, nn.Module],
                    state: TrainState) -> int:
    """Restores the parts, their optimizers and the step counter in place;
    returns the epoch to start from (the saved one plus 1)."""
    wait_for_checkpoints()
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    for name, module in modules.items():
        if name not in ckpt or OPTIMIZER_PREFIX + name not in ckpt:
            raise KeyError(f"checkpoint {path} lacks part {name!r} or its optimizer")
        load_part(module, ckpt[name], name)
        state.optimizers[name].load_state_dict(ckpt[OPTIMIZER_PREFIX + name])
    state.step = int(ckpt["step"])
    return int(ckpt["epoch"]) + 1
