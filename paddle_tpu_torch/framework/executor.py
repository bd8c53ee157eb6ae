"""Executor: eager op-by-op execution of a block on one torch device.

Counterpart of ``paddle_tpu/framework/executor.py``.  The JAX executor
traces a whole block into one XLA program; here ``Executor.run`` walks the
block's ops in order and runs each op's PyTorch lowering on the
executor's device, under ``torch.no_grad()`` (the auto-derived grad ops
turn autograd on for themselves).  The Scope holds torch tensors on that
device.  A persistable var that an op writes (an optimizer's ParamOut,
the LR counter) goes back into the scope as a new tensor after the run:
nothing is updated in place.

The JAX executor's telemetry, non-finite guard, compile cache and
pipelines wait for later slices.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..ops.registry import LowerContext, lower_op
from .core import (Block, Program, Variable, default_main_program,
                   dtype_to_np, dtype_to_torch)

__all__ = ["Executor", "Scope", "global_scope", "scope_guard",
           "analyze_block", "lower_block"]


# ---------------------------------------------------------------------------
# Scope: name -> tensor holder
# ---------------------------------------------------------------------------
class Scope:
    def __init__(self, parent: Optional["Scope"] = None):
        self._vars: Dict[str, Any] = {}
        self.parent = parent

    def var(self, name: str):
        """Create-or-get."""
        return self._vars.setdefault(name, None)

    def find_var(self, name: str):
        s: Optional[Scope] = self
        while s is not None:
            if name in s._vars:
                return s._vars[name]
            s = s.parent
        return None

    def has_var(self, name: str) -> bool:
        s: Optional[Scope] = self
        while s is not None:
            if name in s._vars:
                return True
            s = s.parent
        return False

    def set_var(self, name: str, value):
        self._vars[name] = value

    def local_var_names(self) -> List[str]:
        return list(self._vars)


_global_scope = Scope()
_scope_stack: List[Scope] = [_global_scope]


def global_scope() -> Scope:
    return _scope_stack[-1]


class scope_guard:
    def __init__(self, scope: Scope):
        self.scope = scope

    def __enter__(self):
        _scope_stack.append(self.scope)
        return self.scope

    def __exit__(self, *exc):
        _scope_stack.pop()
        return False


# ---------------------------------------------------------------------------
# Block analysis: classify vars into feed / state-in / state-out
# ---------------------------------------------------------------------------

def _op_io(op, block):
    """Effective (reads, writes) of an op, descending into control-flow
    sub-blocks so state read only inside a branch or loop counts."""
    reads = list(op.input_arg_names())
    writes = list(op.output_arg_names())
    prog = block.program
    for key in ("sub_block", "true_block", "false_block"):
        idx = op.attr(key, None)
        if idx is None:
            continue
        sub = prog.block(idx)
        sub_written: set = set()
        for o in sub.ops:
            r, w = _op_io(o, sub)
            reads.extend(n for n in r if n not in sub_written)
            sub_written.update(w)
    return reads, writes


def analyze_block(block: Block, feed_names: Sequence[str]):
    """Returns (state_in, state_out): vars the run must read from / write
    back into the scope."""
    written: set = set()
    state_in: List[str] = []
    state_out: List[str] = []
    seen_in: set = set(feed_names)
    seen_out: set = set()
    for op in block.ops:
        op_reads, _ = _op_io(op, block)
        for name in op_reads:
            if name in seen_in or name in written or not name:
                continue
            if block._find_var_recursive(name) is not None:
                # persistable state, or a temp read before it is written
                # here (a var a previous partial run left in the scope)
                state_in.append(name)
                seen_in.add(name)
        for name in op.output_arg_names():
            if not name:
                continue
            written.add(name)
            v = block._find_var_recursive(name)
            if v is not None and v.persistable and name not in seen_out:
                state_out.append(name)
                seen_out.add(name)
    return state_in, state_out


def lower_block(block: Block, env: Dict[str, Any], device,
                random_seed: int = 0, is_test: bool = False,
                step: int = 0) -> LowerContext:
    """Run every op of `block` eagerly on `device`; `env` (name -> tensor)
    receives the outputs.  `step` is the executor's run count, which
    seeds stochastic ops together with `random_seed`; the program's
    ``_amp_lowering`` turns on the AMP autocast."""
    ctx = LowerContext(block, env, device, random_seed=random_seed,
                       is_test=is_test, step=step,
                       amp=getattr(block.program, "_amp_lowering", None))
    for op in block.ops:
        if op.type in ("feed", "fetch"):
            continue
        lower_op(ctx, op)
    return ctx


def to_tensor(value, device: torch.device, dtype=None) -> torch.Tensor:
    """numpy array / Python scalar / tensor -> tensor on `device` (and
    `dtype`, a canonical string, when given)."""
    tdt = dtype_to_torch(dtype) if dtype is not None else None
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=tdt)
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16":  # ml_dtypes, as to_numpy returns it
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(
            device=device, dtype=tdt)
    return torch.as_tensor(arr, device=device, dtype=tdt)


def to_numpy(t) -> np.ndarray:
    """A fetch as numpy.  A bfloat16 tensor becomes an ml_dtypes.bfloat16
    array with the same bits, as the JAX package's np.asarray gives it."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    if t.dtype == torch.bfloat16:
        try:
            import ml_dtypes
        except ImportError as e:
            raise ImportError("a bfloat16 fetch as numpy needs the "
                              "ml_dtypes package; fetch with "
                              "return_numpy=False instead") from e
        return t.detach().view(torch.int16).cpu().numpy().view(
            ml_dtypes.bfloat16)
    return t.detach().cpu().numpy()


def _scope_value(scope: Scope, name: str, device: torch.device):
    val = scope.find_var(name)
    if val is None:
        raise RuntimeError(
            f"variable {name!r} has no value in scope; did you run "
            f"the startup program first?")
    if isinstance(val, torch.Tensor):
        if val.device != device:
            raise RuntimeError(
                f"variable {name!r} lives on {val.device}, but this run is "
                f"on {device}")
        return val
    return to_tensor(val, device)


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------
class Executor:
    """``Executor(place)``: ``place`` None means the card (``cuda:0``);
    ``CPUPlace()`` the CPU.  API mirrors the JAX package's
    run(program, feed, fetch_list, scope, return_numpy)."""

    def __init__(self, place=None):
        self.place = place
        self.device = resolve_device(place)
        self._step = 0  # runs so far; each run draws fresh random numbers

    def run(self, program: Optional[Program] = None,
            feed: Optional[Dict[str, Any]] = None,
            fetch_list: Optional[Sequence] = None,
            scope: Optional[Scope] = None,
            return_numpy: bool = True):
        program = program or default_main_program()
        fetch_names = _fetch_names(fetch_list)
        scope = scope or global_scope()
        block = program.global_block()
        feed_vals = _prepare_feed(block, dict(feed or {}), self.device)
        state_in, state_out = analyze_block(block, list(feed_vals))
        env: Dict[str, Any] = dict(feed_vals)
        for n in state_in:
            env[n] = _scope_value(scope, n, self.device)
        for n in fetch_names:
            block.var(n)  # raises if unknown
        self._step += 1
        with torch.no_grad():
            lower_block(block, env, self.device,
                        random_seed=program.random_seed, step=self._step)
        for n in state_out:
            scope.set_var(n, env[n])
        fetches = [env[n] for n in fetch_names]
        if return_numpy:
            return [to_numpy(f) for f in fetches]
        return fetches


def _fetch_names(fetch_list) -> List[str]:
    names = []
    for f in fetch_list or []:
        if isinstance(f, Variable):
            names.append(f.name)
        elif isinstance(f, str):
            names.append(f)
        else:
            raise TypeError(f"bad fetch entry: {f!r}")
    return names


def _prepare_feed(block: Block, feed: Dict[str, Any],
                  device: torch.device) -> Dict[str, torch.Tensor]:
    """Feeds as tensors on `device`, in the var's dtype, in sorted-name
    order (the JAX executor's canonical feed order)."""
    out = {}
    for name, value in sorted(feed.items()):
        dtype = None
        shape = None
        if block.has_var(name):
            v = block.var(name)
            dtype, shape = v.dtype, v.shape
        if isinstance(value, torch.Tensor):
            t = to_tensor(value, device, dtype)
        else:
            arr = np.asarray(value)
            if dtype is not None and dtype != "bfloat16" \
                    and arr.dtype != dtype_to_np(dtype):
                arr = arr.astype(dtype_to_np(dtype))
            t = to_tensor(arr, device, dtype)
        if shape is not None and len(shape) == t.dim() + 1 and \
                shape[-1] == 1:
            # labels fed as (N,) for (N,1) vars, as the reference allows
            t = t.reshape(tuple(t.shape) + (1,))
        out[name] = t
    return out
