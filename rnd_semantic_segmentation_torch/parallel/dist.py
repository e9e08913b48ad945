"""Data parallelism over processes (counterpart of the JAX package's
parallel/mesh.py and parallel/shmap.py).

One process holds one device.  ``initialize_distributed`` starts
``torch.distributed`` from the variables ``torchrun`` sets (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``): NCCL when
MODEL.DEVICE is ``cuda``, gloo when it is ``cpu``.  A caller may start the
group itself first (a world of two on one card over gloo, say); then it is
left as it is.  Without DIST.INITIALIZE the world is one process and every
function here is a no-op.

The explicit collectives of the shmap program, not a
``DistributedDataParallel`` wrapper: the steps average each part's
gradients with one flattened all-reduce (``average_gradients``) after the
backward and before the clamp and the optimizer, and report the ranks' mean
loss (``mean_over_ranks``).  ``all_reduce_sum`` carries gradients (its
backward all-reduces the gradient), which the losses that are not a mean of
per-image terms and the BatchNorm across ranks need.

SOLVER.BATCH_SIZE (and TEST.BATCH_SIZE) stays the global batch: each rank
takes its ``1 / world`` share of it (``DataLoader.global_batch_slice``
raises when the world does not divide it).  ``rank_rows`` gives a rank its
rows of a draw made for the global batch, so that the random numbers of a
sample do not depend on the number of ranks.
"""

from __future__ import annotations

import os
from typing import Iterable

import torch
import torch.distributed as dist
from torch import nn


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def process_is_primary() -> bool:
    return rank() == 0


def local_rank(default: int = 0) -> int:
    """``LOCAL_RANK`` when ``torchrun`` set it, else ``default`` (the CLIs'
    ``--local_rank``)."""
    return int(os.environ.get("LOCAL_RANK", default))


def check_world(cfg) -> None:
    """The DIST knobs against the world this process is in: a world of more
    than one needs DIST.INITIALIZE, DIST.NUM_DEVICES must be 0 or the world
    size, and DIST.SPATIAL_PARALLEL > 1 (height sharding) is not ported."""
    if cfg.DIST.SPATIAL_PARALLEL > 1:
        raise NotImplementedError(
            "not ported yet: DIST.SPATIAL_PARALLEL > 1 (height sharding needs halo "
            "exchanges around every conv)")
    world = world_size()
    if world > 1 and not cfg.DIST.INITIALIZE:
        raise ValueError(f"a world of {world} processes needs DIST.INITIALIZE True")
    num = int(cfg.DIST.NUM_DEVICES)
    if num not in (0, world):
        raise ValueError(
            f"DIST.NUM_DEVICES={num}: one process holds one device, so it is 0 or the "
            f"world size ({world})")


def initialize_distributed(cfg, default_local_rank: int = 0) -> None:
    """Starts the process group when DIST.INITIALIZE asks for it and none is
    up, through ``env://``; pins the process to ``cuda:LOCAL_RANK`` when
    MODEL.DEVICE is ``cuda``.  Then checks the DIST knobs (``check_world``)."""
    if cfg.DIST.INITIALIZE and not is_distributed():
        device = torch.device(cfg.MODEL.DEVICE)
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"MODEL.DEVICE={cfg.MODEL.DEVICE!r} but "
                                   f"torch.cuda.is_available() is False")
            torch.cuda.set_device(local_rank(default_local_rank))
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method="env://")
    check_world(cfg)


def rank_rows(draw: torch.Tensor, rows: int) -> torch.Tensor:
    """This rank's ``rows`` rows of ``draw``, a draw made for the global
    batch (``rows * world`` rows): rank r takes rows ``[r*rows, (r+1)*rows)``,
    its contiguous slice of the global batch."""
    start = rank() * rows
    return draw[start:start + rows]


def all_reduce_sum(tensor: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks, with gradients: its backward sums the
    gradient over the ranks.  The tensor itself in a world of one."""
    if world_size() == 1:
        return tensor
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(tensor)


def mean_over_ranks(value: torch.Tensor) -> torch.Tensor:
    """The ranks' mean of a detached tensor (a step's reported loss)."""
    world = world_size()
    if world == 1:
        return value
    value = value.detach().clone()
    dist.all_reduce(value)
    return value / world


def average_gradients(params: Iterable[nn.Parameter]) -> None:
    """Replaces each gradient by its mean over the ranks: one all-reduce of
    the gradients flattened into one buffer.  Parameters without a gradient
    are left out, on every rank alike (the same program runs on each)."""
    world = world_size()
    if world == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= world
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n


@torch.no_grad()
def broadcast_module(module: nn.Module, src: int = 0) -> None:
    """Rank ``src``'s parameters and buffers into every rank's ``module``
    (the counterpart of ``replicate_state``)."""
    if world_size() == 1:
        return
    for tensor in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(tensor.data, src)


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def all_reduce_(tensor: torch.Tensor) -> torch.Tensor:
    """Sums ``tensor`` over the ranks in place (no gradient); returns it."""
    if world_size() > 1:
        dist.all_reduce(tensor)
    return tensor

