"""Operator registry: shape inference, PyTorch lowering, auto-derived grads.

Counterpart of ``paddle_tpu/ops/registry.py``.  Each op type registers
``infer`` (build-time shape/dtype inference, run at op-append time),
``lower`` (a function from a LowerContext, name -> torch tensor, to the
op's outputs) and ``grad``: ``'auto'`` (default) makes backward emit a
generic ``<type>_grad`` op whose lowering re-runs the forward lowering
under autograd and calls ``torch.autograd.grad`` (the JAX package calls
``jax.vjp``), a callable builds custom grad op descs, None marks a
non-differentiable op.  The JAX package composes the lowerings of a
block into one traced XLA program; the port runs them one by one,
eagerly, on the context's device.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from ..errors import NotFoundError, UnimplementedError, op_error_context
from ..framework.core import (Block, Operator, Variable, convert_dtype,
                              dtype_to_torch, grad_var_name)

__all__ = [
    "OpDef", "register_op", "get_op_def", "has_op", "infer_op_shape",
    "LowerContext", "lower_op", "all_registered_ops",
]


class LowerContext:
    """Environment for lowering a block: var name -> torch tensor on
    ``device``; the program's random seed and the executor's run count
    (``step``) for stochastic ops; ``amp``, the program's
    ``_amp_lowering`` ({"dtype", "white", "black"}) or None."""

    def __init__(self, block: Block, env: Dict[str, Any],
                 device: torch.device, random_seed: int = 0,
                 is_test: bool = False, step: int = 0, amp=None):
        self.block = block
        self.env = env
        self.device = torch.device(device)
        self.random_seed = int(random_seed or 0)
        self.is_test = is_test
        self.step = int(step)
        self.amp = amp

    def get(self, name: str):
        if name not in self.env:
            raise KeyError(
                f"variable {name!r} has no value during lowering; "
                f"known: {sorted(self.env)[:20]}...")
        return self.env[name]

    def get_input(self, op: Operator, slot: str):
        name = op.single_input(slot)
        return None if name is None else self.get(name)

    def get_inputs(self, op: Operator, slot: str) -> List[Any]:
        return [self.get(n) for n in op.input(slot)]

    def set_output(self, op: Operator, slot: str, value):
        name = op.single_output(slot)
        if name is not None:
            self.env[name] = value

    def rng(self, op: Operator) -> torch.Generator:
        """Per-op generator on the context's device, seeded from the
        program's random seed, the run count and the op's build-time
        ``__op_seed__`` (the JAX package folds the same three into its
        key).  Lowering the same op again within one run, as its
        auto-derived grad does, draws the same numbers; the next run
        draws new ones."""
        g = torch.Generator(device=self.device)
        key = (self.random_seed, self.step, int(op.attr("__op_seed__", 0)))
        g.manual_seed(hash(key) % (1 << 63))
        return g


class OpDef:
    def __init__(self, type: str,
                 infer: Optional[Callable[[Operator, Block], None]] = None,
                 lower: Optional[Callable[[LowerContext, Operator], None]] = None,
                 grad=None, stateful_outputs: Sequence[str] = ()):
        self.type = type
        self.infer = infer
        self.lower = lower
        # None = non-differentiable; 'auto' = autograd of the forward
        # lowering; callable(fwd_op, block, helper) -> list of grad op specs
        self.grad = grad
        # output slots aliasing an input (in-place update semantics, e.g.
        # an optimizer's ParamOut)
        self.stateful_outputs = tuple(stateful_outputs)


_REGISTRY: Dict[str, OpDef] = {}


def register_op(type: str, *, infer=None, lower=None, grad="auto",
                stateful_outputs=()):
    """Register an op type.  Usable directly or as a decorator on `lower`."""
    if lower is None:
        def deco(fn):
            register_op(type, infer=infer, lower=fn, grad=grad,
                        stateful_outputs=stateful_outputs)
            return fn
        return deco
    _REGISTRY[type] = OpDef(type, infer=infer, lower=lower, grad=grad,
                            stateful_outputs=stateful_outputs)
    return _REGISTRY[type]


def get_op_def(type: str) -> OpDef:
    if type not in _REGISTRY:
        raise KeyError(f"op type {type!r} is not registered "
                       f"({len(_REGISTRY)} ops known)")
    return _REGISTRY[type]


def has_op(type: str) -> bool:
    return type in _REGISTRY


def all_registered_ops() -> List[str]:
    return sorted(_REGISTRY)


# global monotonically increasing op seed for per-op randomness
_OP_SEED = [0]


def reset_op_seed(value: int = 0):
    """Reset the per-op randomness counter (test isolation / building two
    programs that must carry identical op seeds)."""
    _OP_SEED[0] = value


def infer_op_shape(op: Operator, block: Block):
    _OP_SEED[0] += 1
    op.attrs.setdefault("__op_seed__", _OP_SEED[0])
    opdef = _REGISTRY.get(op.type)
    if opdef is None:
        raise NotFoundError(f"cannot append unregistered op {op.type!r}")
    if opdef.infer is not None:
        with op_error_context(op, block, phase="shape inference"):
            opdef.infer(op, block)


_AMP_CASTABLE = (torch.float16, torch.bfloat16, torch.float32)


def _lower_with_amp(ctx: LowerContext, opdef: "OpDef", op: Operator):
    """Autocast wrapper: white-list ops see low-precision float inputs,
    black-list ops see float32; a grad op casts like its forward.  The
    env bindings are restored afterwards, so other consumers keep the
    original precision (master weights stay float32 in the scope)."""
    amp = ctx.amp
    target = None
    if amp is not None:
        base = op.type[:-5] if op.type.endswith("_grad") else op.type
        if base in amp["white"]:
            target = dtype_to_torch(amp["dtype"])
        elif base in amp["black"]:
            target = torch.float32
    if target is None:
        opdef.lower(ctx, op)
        return
    saved = {}
    for name in op.input_arg_names():
        v = ctx.env.get(name)
        if isinstance(v, torch.Tensor) and v.dtype in _AMP_CASTABLE \
                and v.dtype != target:
            saved[name] = v
            ctx.env[name] = v.to(target)
    opdef.lower(ctx, op)
    written = set(op.output_arg_names())
    for n, v in saved.items():
        if n not in written:  # an in-place output keeps its new value
            ctx.env[n] = v


def lower_op(ctx: LowerContext, op: Operator):
    opdef = _REGISTRY.get(op.type)
    if opdef is None or opdef.lower is None:
        raise UnimplementedError(f"no lowering for op {op.type!r}")
    with op_error_context(op, ctx.block, phase="lowering"):
        _lower_with_amp(ctx, opdef, op)


# ---------------------------------------------------------------------------
# Shared infer-shape helpers
# ---------------------------------------------------------------------------

def set_out(op: Operator, block: Block, slot: str, shape, dtype,
            **var_kwargs):
    """Create/refresh the output var's shape+dtype in the block."""
    for name in op.output(slot):
        v = block._find_var_recursive(name)
        if v is None:
            v = block.create_var(name=name)
        v.shape = tuple(int(s) for s in shape) if shape is not None else None
        v.dtype = convert_dtype(dtype)
        for k, val in var_kwargs.items():
            setattr(v, k, val)


def in_var(op: Operator, block: Block, slot: str) -> Variable:
    return block.var(op.single_input(slot))


def same_as_input(input_slot="X", output_slot="Out"):
    def infer(op: Operator, block: Block):
        x = in_var(op, block, input_slot)
        set_out(op, block, output_slot, x.shape, x.dtype)
    return infer


def broadcast_shapes(s1, s2, axis=-1):
    """Paddle-style broadcast: y's dims align to x starting at `axis`;
    -1 means trailing alignment (numpy rule)."""
    s1, s2 = list(s1), list(s2)
    if len(s2) > len(s1):
        s1, s2 = s2, s1
    if axis == -1:
        axis = len(s1) - len(s2)
    padded = [1] * axis + s2 + [1] * (len(s1) - axis - len(s2))
    out = []
    for a, b in zip(s1, padded):
        if a == -1 or b == -1:
            out.append(-1)
        elif a == 1:
            out.append(b)
        elif b == 1 or a == b:
            out.append(a)
        else:
            raise ValueError(f"cannot broadcast shapes {s1} vs {s2}")
    return tuple(out)


# ---------------------------------------------------------------------------
# Auto-grad: autograd of the forward lowering
# ---------------------------------------------------------------------------

def build_auto_grad_specs(fwd_op: Operator, block: Block,
                          no_grad_set: set) -> List[dict]:
    """Emit the generic ``<type>_grad`` op desc for `fwd_op`.

    Inputs: every forward input slot and output slot under its own name,
    plus ``<slot>@GRAD`` for each forward output.  Outputs: ``<slot>@GRAD``
    for each differentiable (float, not stop_gradient, not in
    `no_grad_set`) forward input; "" marks the others.
    """
    inputs: Dict[str, List[str]] = {}
    for slot, names in fwd_op.inputs.items():
        inputs[slot] = list(names)
    for slot, names in fwd_op.outputs.items():
        inputs[slot] = list(names)
        inputs[slot + "@GRAD"] = [grad_var_name(n) for n in names]
    outputs: Dict[str, List[str]] = {}
    for slot, names in fwd_op.inputs.items():
        grads = []
        for n in names:
            v = block._find_var_recursive(n)
            differentiable = (
                v is not None and not v.stop_gradient and n not in no_grad_set
                and convert_dtype(v.dtype).startswith(("float", "bfloat")))
            grads.append(grad_var_name(n) if differentiable else "")
        if any(grads):
            outputs[slot + "@GRAD"] = grads
    if not outputs:
        return []
    attrs = dict(fwd_op.attrs)
    attrs["__fwd_type__"] = fwd_op.type
    attrs["__fwd_inputs__"] = {k: list(v) for k, v in fwd_op.inputs.items()}
    attrs["__fwd_outputs__"] = {k: list(v) for k, v in fwd_op.outputs.items()}
    # the full desc only when differentiating a grad op (double backward):
    # its own __fwd_* attrs would be clobbered by the flat keys above
    if fwd_op.type.endswith("_grad"):
        attrs["__fwd_desc__"] = dict(
            type=fwd_op.type,
            inputs={k: list(v) for k, v in fwd_op.inputs.items()},
            outputs={k: list(v) for k, v in fwd_op.outputs.items()},
            attrs=dict(fwd_op.attrs))
    return [dict(type=fwd_op.type + "_grad", inputs=inputs, outputs=outputs,
                 attrs=attrs)]


def _lower_auto_grad(ctx: LowerContext, gop: Operator):
    """Lowering of an auto-derived ``<type>_grad`` op.

    Re-lowers the forward op under ``torch.enable_grad()`` (the executor
    runs under no_grad) on detached copies of its differentiable inputs,
    then ``torch.autograd.grad`` with the recorded cotangents.  The
    re-lowering uses this run's generator seeds, so a stochastic op
    replays its forward's draw.
    """
    fwd_type = gop.attr("__fwd_type__")
    fwd_inputs: Dict[str, List[str]] = gop.attr("__fwd_inputs__")
    fwd_outputs: Dict[str, List[str]] = gop.attr("__fwd_outputs__")
    opdef = get_op_def(fwd_type)

    # which (slot, idx) need grads, in a stable order
    wanted: List[tuple] = []
    for gslot, gnames in gop.outputs.items():
        slot = gslot[:-len("@GRAD")]
        for i, gname in enumerate(gnames):
            if gname:
                wanted.append((slot, i, gname))
    diff_names: List[str] = []
    for slot, i, _ in wanted:
        n = fwd_inputs[slot][i]
        if n not in diff_names:
            diff_names.append(n)
    out_order: List[str] = []
    for names in fwd_outputs.values():
        for n in names:
            if n not in out_order:
                out_order.append(n)

    desc = gop.attr("__fwd_desc__")
    if desc is not None:
        fwd_attrs = dict(desc["attrs"])
    else:
        fwd_attrs = {k: v for k, v in gop.attrs.items()
                     if not k.startswith("__fwd_")}
    fwd_op = Operator(ctx.block, fwd_type, fwd_inputs, fwd_outputs, fwd_attrs)

    env = {n: ctx.get(n) for ns in fwd_inputs.values() for n in ns
           if n not in diff_names}
    primals = [ctx.get(n).detach().requires_grad_(True) for n in diff_names]
    env.update(zip(diff_names, primals))
    sub = LowerContext(ctx.block, env, ctx.device,
                       random_seed=ctx.random_seed, is_test=ctx.is_test,
                       step=ctx.step, amp=ctx.amp)
    with torch.enable_grad():
        _lower_with_amp(sub, opdef, fwd_op)

    # cotangent names were recorded in the op's <slot>@GRAD inputs at
    # build time; a missing cotangent counts as zeros
    cot_name = {}
    for slot, names in fwd_outputs.items():
        gnames = gop.inputs.get(slot + "@GRAD", [])
        for i, n in enumerate(names):
            if i < len(gnames) and gnames[i]:
                cot_name[n] = gnames[i]
    outs, cots = [], []
    for n in out_order:
        ov = env.get(n)
        g = ctx.env.get(cot_name.get(n, grad_var_name(n)))
        if not isinstance(ov, torch.Tensor) or not ov.requires_grad \
                or g is None:
            continue  # not connected to the inputs, or a zero cotangent
        outs.append(ov)
        cots.append(g.to(ov.dtype).reshape(ov.shape))
    grads = (torch.autograd.grad(outs, primals, cots, allow_unused=True)
             if outs else [None] * len(primals))
    grad_by_name = {n: torch.zeros_like(p) if g is None else g
                    for n, p, g in zip(diff_names, primals, grads)}

    written = set()
    for slot, i, gname in wanted:
        if gname in written:
            # one fwd var in several slots of THIS op (e.g. x*x): autograd
            # already summed every path into its grad
            continue
        val = grad_by_name[fwd_inputs[slot][i]]
        # accumulate across DIFFERENT consumers of the fwd var
        if gname in ctx.env and gop.attr("__accumulate__", False):
            val = ctx.env[gname] + val
        ctx.env[gname] = val
        written.add(gname)


def infer_auto_grad(gop: Operator, block: Block):
    """Grad vars mirror the shape/dtype of their forward vars."""
    fwd_inputs: Dict[str, List[str]] = gop.attr("__fwd_inputs__")
    for gslot, gnames in gop.outputs.items():
        slot = gslot[:-len("@GRAD")]
        for i, gname in enumerate(gnames):
            if not gname:
                continue
            src = block.var(fwd_inputs[slot][i])
            v = block._find_var_recursive(gname)
            if v is None:
                v = block.create_var(name=gname)
            v.shape, v.dtype = src.shape, src.dtype


def ensure_grad_op_registered(fwd_type: str) -> str:
    gtype = fwd_type + "_grad"
    if gtype not in _REGISTRY:
        _REGISTRY[gtype] = OpDef(gtype, infer=infer_auto_grad,
                                 lower=_lower_auto_grad, grad="auto")
    return gtype
