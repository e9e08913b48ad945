"""DEBUG.CHECKIFY: float checks over a whole train step (counterpart of the
JAX package's ``wrap_step_checkify``, train/steps.py, which functionalises
``checkify.float_checks`` over the jitted step and throws after it).

``FloatChecks`` is a ``TorchDispatchMode`` that sees every aten op of the
step: the forward, the backward and the optimizer's update.  It flags
  * a floating-point output that holds a NaN, of an op that computes (a view
    or an op that only moves or copies data passes a NaN on and is not
    checked, as checkify checks the primitives that can make one:
    ``jax._src.checkify.nan_primitives``; an overflow to Inf is not flagged,
    as there), and
  * a division whose tensor divisor holds a zero (checkify's "division by
    zero").
So that the checks never wait for the card, the index of the first flagged
op stays in a device tensor, updated by two small ops per op, and is read
once, when the step has ended; the op's name and the innermost module that
ran it (kept by global forward hooks while the step runs; ops of the
backward and of the optimizer name none) are kept on the host by index.

``wrap_step_checkify(step_fn, modules)`` returns a step that runs
``step_fn`` under the checks and raises ``FloatingPointError`` after it when
an op was flagged.  The step's in-place updates have then been made: the
parameters hold the step's result, where the JAX step's caller keeps its
old state.  A step that raises nothing is bit-equal to the step without the
checks, which read the tensors and change none.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_DIVISIONS = {"div", "div_", "_foreach_div", "_foreach_div_", "true_divide", "true_divide_",
              "floor_divide", "floor_divide_"}
# ops that move, copy or select data (views aside): they pass a NaN on
_MOVES = {"clone", "copy_", "_to_copy", "contiguous", "cat", "stack", "index", "index_select",
          "gather", "repeat", "constant_pad_nd", "where", "masked_fill", "fill_", "zero_",
          "new_zeros", "new_empty", "empty_like", "zeros_like", "lift_fresh"}


class FloatChecks(TorchDispatchMode):
    """Records the first op whose float output holds a NaN, or whose tensor
    divisor holds a zero; ``first()`` reads the record once."""

    def __init__(self, module_names: Optional[Mapping[int, str]] = None):
        super().__init__()
        self.module_names = dict(module_names or {})
        self.stack: List[str] = []
        self.ops: List[tuple] = []
        self.flag: Optional[torch.Tensor] = None

    def _note(self, bad: torch.Tensor, what: str, op: str) -> None:
        index = len(self.ops)
        self.ops.append((what, op, self.stack[-1] if self.stack else None))
        if self.flag is None:
            self.flag = torch.full((), -1, dtype=torch.long, device=bad.device)
        elif self.flag.device != bad.device:
            bad = bad.to(self.flag.device)
        self.flag = torch.where((self.flag < 0) & bad, index, self.flag)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if name in _DIVISIONS and len(args) > 1:
            divisors = [t for t in tree_flatten(args[1])[0] if isinstance(t, torch.Tensor)]
            for t in divisors:
                self._note((t == 0).any(), "division by zero", str(func))
        out = func(*args, **kwargs)
        if func.is_view or name in _MOVES:
            return out
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and t.is_floating_point() and t.numel():
                self._note(torch.isnan(t).any(), "nan generated", str(func))
        return out

    def first(self) -> Optional[tuple]:
        """(what, aten op, module or None) of the first flagged op, or None;
        one read from the device."""
        if self.flag is None:
            return None
        index = int(self.flag)
        return self.ops[index] if index >= 0 else None

    def push(self, module, *_):
        self.stack.append(self.module_names.get(id(module), type(module).__name__))

    def pop(self, *_):
        if self.stack:
            self.stack.pop()


def module_names(modules: Mapping[str, nn.Module]) -> Dict[int, str]:
    """``{id(module): "part.path"}`` over every submodule of the parts."""
    return {id(m): f"{part}.{name}" if name else part
            for part, module in modules.items() for name, m in module.named_modules()}


def wrap_step_checkify(step_fn: Callable, modules: Mapping[str, nn.Module]) -> Callable:
    """``step_fn`` under ``FloatChecks``; raises ``FloatingPointError``,
    naming the aten op and the innermost of ``modules``' submodules that ran
    it, after a step in which an op was flagged."""
    names = module_names(modules)

    def step(*args, **kwargs):
        checks = FloatChecks(names)
        pre = nn.modules.module.register_module_forward_pre_hook(checks.push)
        post = nn.modules.module.register_module_forward_hook(checks.pop)
        try:
            with checks:
                out = step_fn(*args, **kwargs)
        finally:
            pre.remove()
            post.remove()
        bad = checks.first()
        if bad is not None:
            what, op, where = bad
            raise FloatingPointError(
                f"{what}: aten op {op}" + (f" in module {where}" if where else
                                              " (outside the modules' forward)"))
        return out

    return step
