"""Rematerialisation: ``MODEL.REMAT_BLOCKS`` and ``SOLVER.REMAT`` (counterparts
of ``nn.remat`` in the JAX package's backbones and of ``remat_wrap`` in its
train/steps.py), with ``torch.utils.checkpoint`` (non-reentrant).

``checkpoint_call`` runs a function so that autograd keeps its inputs only and
runs it again in the backward.  Two things of the recompute would differ from
flax's ``nn.remat``, which throws the recompute's state away, and both are
guarded here:

  * a train-mode ``nn.BatchNorm2d`` updates its running statistics and
    ``num_batches_tracked`` in every forward, the recompute's included: the
    recompute runs with those buffers saved before it and put back after it,
    so they end bit-equal to a run without rematerialisation;
  * ``torch.utils.checkpoint`` restores the default generators only: an
    explicit ``torch.Generator`` (drop-connect's) would draw other masks in the
    recompute.  ``generator=`` is set back to its state at the first call for
    the recompute, then to where it was.  ``MBConvBlock`` needs neither: it
    draws its mask before its rematerialised body and passes it in.

``RematBlock`` is a module whose ``forward`` runs ``body`` through
``checkpoint_call`` when its ``remat`` is on, it is in train mode and
autograd records: the residual units of ResNet and Res2Net, HarDNet's
``HarDBlock`` and EfficientNet's ``MBConvBlock``, as in the JAX package (VGG16
is not rematerialised there either).  ``set_remat_blocks`` turns them on in a
module; it adds no parameter and renames no ``state_dict`` key, so a
checkpoint loads with the knob on or off.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Iterable, Optional

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

REMAT_MODES = ("none", "full", "dots")
_OFF = ("none", "", "0", "false")
_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``dots_with_no_batch_dims_saveable``: the products with no batch
    dimension (``mm``, ``addmm``) are kept; everything else, convolutions and
    ``bmm`` included, is recomputed."""
    del ctx, args, kwargs
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _running_norms(modules: Iterable[nn.Module]):
    return [m for mod in modules for m in mod.modules()
            if isinstance(m, nn.modules.batchnorm._BatchNorm) and m.track_running_stats]


@contextlib.contextmanager
def _replay(norms, generator: Optional[torch.Generator], start, inner):
    """The recompute's context: the BatchNorm buffers saved before it and put
    back after it, ``generator`` set to ``start`` and then back; ``inner``
    (a selective policy's recompute context) inside, so that these copies
    stay outside its view of the ops."""
    with torch.no_grad():
        saved = [(m.running_mean.clone(), m.running_var.clone(),
                  m.num_batches_tracked.clone()) for m in norms]
    current = None if generator is None else generator.get_state()
    if generator is not None:
        generator.set_state(start)
    try:
        with inner:
            yield
    finally:
        with torch.no_grad():
            for m, (mean, var, tracked) in zip(norms, saved):
                m.running_mean.copy_(mean)
                m.running_var.copy_(var)
                m.num_batches_tracked.copy_(tracked)
        if generator is not None:
            generator.set_state(current)


def checkpoint_call(fn: Callable, *args, modules: Iterable[nn.Module] = (),
                    generator: Optional[torch.Generator] = None,
                    context_fn: Optional[Callable] = None):
    """``fn(*args)`` under ``torch.utils.checkpoint(use_reentrant=False)``.
    The running statistics of the BatchNorms in ``modules`` and the state of
    ``generator`` come out of the recompute as they went in (see the module's
    docstring); ``context_fn`` is a selective policy's pair of contexts."""
    norms = _running_norms(modules)
    start = None if generator is None else generator.get_state()

    def contexts():
        forward, recompute = (context_fn() if context_fn is not None
                              else (contextlib.nullcontext(), contextlib.nullcontext()))
        return forward, _replay(norms, generator, start, recompute)

    return checkpoint(fn, *args, use_reentrant=False, context_fn=contexts)


def remat_mode(cfg) -> str:
    """``SOLVER.REMAT`` as one of ``REMAT_MODES``; another value raises
    ``ValueError``, as in the JAX package."""
    mode = str(cfg.SOLVER.REMAT).lower()
    if mode in _OFF:
        return "none"
    if mode not in REMAT_MODES:
        raise ValueError(f"SOLVER.REMAT must be none|full|dots, got {mode!r}")
    return mode


def remat_wrap(compute: Callable, cfg, modules: Iterable[nn.Module],
               generator: Optional[torch.Generator] = None) -> Callable:
    """``SOLVER.REMAT`` around a step's loss closure ``compute(*tensors)``:
    ``none`` returns it as it is; ``full`` keeps its inputs only and runs it
    again in the backward; ``dots`` keeps the outputs of ``mm`` and ``addmm``
    besides (``_dots_policy``).  In the port's models no layer is such a
    product: every layer is a convolution, the criss-cross core's plain
    version is a ``bmm`` and its kernel a custom function, and the bilinear
    resize is ``F.interpolate``, where the JAX resize is two products; so
    ``dots`` recomputes what ``full`` does.  A step with ``SOLVER.ACCUM_STEPS``
    wraps each micro-batch's closure."""
    mode = remat_mode(cfg)
    if mode == "none":
        return compute
    modules = tuple(modules)
    context_fn = (functools.partial(create_selective_checkpoint_contexts, _dots_policy)
                  if mode == "dots" else None)
    return lambda *args: checkpoint_call(compute, *args, modules=modules,
                                         generator=generator, context_fn=context_fn)


class RematBlock(nn.Module):
    """A block that ``MODEL.REMAT_BLOCKS`` rematerialises: subclasses define
    ``body``; ``forward`` runs it through ``checkpoint_call`` when ``remat``
    is on, the block is in train mode and autograd records."""

    remat = False

    def body(self, *args):
        raise NotImplementedError

    def forward(self, *args):
        if self.remat and self.training and torch.is_grad_enabled():
            return checkpoint_call(self.body, *args, modules=(self,))
        return self.body(*args)


def set_remat_blocks(module: nn.Module, on: bool = True) -> nn.Module:
    """Turns every ``RematBlock`` in ``module`` on (or off); returns it."""
    for m in module.modules():
        if isinstance(m, RematBlock):
            m.remat = bool(on)
    return module
