"""Profiling: parameter and FLOP counts, and trace capture (counterpart of
the JAX package's utils/profiling.py).

The reference's thop-based ``CalParams`` (core/utils/utils.py:41-54) becomes
``cal_params``, whose FLOPs are ``torch.utils.flop_counter.FlopCounterMode``'s
(convolutions, matrix products and attention; elementwise ops count
nothing), where the JAX package asks XLA's cost model; ``trace`` records a
``torch.profiler`` trace for TensorBoard or Perfetto (Chrome's trace
format), where the JAX package records ``jax.profiler``'s.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Dict, Iterable, Mapping, Union

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode


def count_params(params: Union[nn.Module, Mapping, Iterable[torch.Tensor]]) -> int:
    """The number of scalars in a module's parameters (its buffers, such as
    BatchNorm statistics, not counted: the JAX count is of ``params`` only),
    a mapping of tensors, or an iterable of tensors."""
    if isinstance(params, nn.Module):
        params = params.parameters()
    elif isinstance(params, Mapping):
        params = params.values()
    return sum(int(p.numel()) for p in params)


class _BytesMode(TorchDispatchMode):
    """Sums, over every aten op dispatched, the bytes of its tensor inputs and
    outputs: each op reads its inputs once and writes its outputs once, with
    no cache and no fusion."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        leaves = tree_flatten((args, kwargs or {}))[0] + tree_flatten(out)[0]
        self.bytes += sum(t.numel() * t.element_size() for t in leaves
                          if isinstance(t, torch.Tensor))
        return out


def cal_params(fn: Callable, *example_args) -> Dict[str, float]:
    """FLOPs and memory traffic of one call ``fn(*example_args)``.

    ``flops`` are ``FlopCounterMode``'s (a multiply-add counts 2);
    ``bytes_accessed`` is the sum over every aten op of the bytes of its
    tensor inputs and outputs, an upper bound of the traffic a fusing
    compiler would leave, where the JAX package reports XLA's estimate of
    the fused program."""
    counter, traffic = FlopCounterMode(display=False), _BytesMode()
    with torch.no_grad(), counter, traffic:
        fn(*example_args)
    flops = float(counter.get_total_flops())
    return {"flops": flops, "gflops": flops / 1e9, "bytes_accessed": float(traffic.bytes)}


def clever_format(value: float, suffix: str = "") -> str:
    for unit in ("", "K", "M", "G", "T", "P"):
        if abs(value) < 1000:
            return f"{value:.3f}{unit}{suffix}"
        value /= 1000
    return f"{value:.3f}E{suffix}"


@contextlib.contextmanager
def trace(log_dir: str, chrome: bool = False):
    """``torch.profiler`` over the block, the card's kernels too where one
    is present.  The trace goes to ``log_dir`` as TensorBoard's profiler
    plugin reads it, or, with ``chrome``, as one ``trace.json`` in Chrome's
    trace format (chrome://tracing, Perfetto).  Yields the profiler."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    if chrome:
        handler = lambda prof: prof.export_chrome_trace(  # noqa: E731
            os.path.join(log_dir, "trace.json"))
    else:
        handler = torch.profiler.tensorboard_trace_handler(log_dir)
    with torch.profiler.profile(activities=activities, on_trace_ready=handler) as prof:
        yield prof


def print_model_stats(fn: Callable, params, *example_args, logger=None) -> Dict:
    """Logs (or prints) the FLOPs and the parameter count of ``fn`` on
    ``example_args``; returns ``cal_params``'s dict with ``params`` added."""
    stats = cal_params(fn, *example_args)
    n_params = count_params(params)
    lines = [
        "[Statistics Information]",
        f"FLOPs: {clever_format(stats['flops'])}",
        f"Params: {clever_format(n_params)}",
    ]
    for line in lines:
        (logger.info if logger else print)(line)
    return {**stats, "params": n_params}
