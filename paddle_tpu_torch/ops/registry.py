"""Operator registry: shape inference, PyTorch lowering, auto-derived grads.

Counterpart of ``paddle_tpu/ops/registry.py``.  Each op type registers
``infer`` (build-time shape/dtype inference, run at op-append time),
``lower`` (a function from a LowerContext, name -> torch tensor, to the
op's outputs) and ``grad``: ``'auto'`` (default) makes backward emit a
generic ``<type>_grad`` op whose lowering calls ``torch.autograd.grad``
on the autograd graph its forward op kept (the JAX package calls
``jax.vjp`` on a re-lowered forward, and XLA's CSE drops the second
forward; a grad op that a later ``gradients()`` pass differentiates
re-lowers its forward too, with ``create_graph``), a callable builds
custom grad op descs, None marks a non-differentiable op.  The executor lowers a block's ops in order on
the context's device (framework/executor.py), on the card inside one
captured CUDA graph.
"""
from __future__ import annotations

import copy
import re
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from ..errors import NotFoundError, UnimplementedError, op_error_context
from ..framework.core import (Block, Operator, OpRole, Variable,
                              convert_dtype, dtype_to_torch, grad_var_name)
from ..framework.selected_rows import SelectedRowsValue

__all__ = [
    "OpDef", "register_op", "get_op_def", "has_op", "infer_op_shape",
    "LowerContext", "lower_op", "all_registered_ops", "plan_grads",
    "run_seed",
]


class LowerContext:
    """Environment for lowering a block: var name -> torch tensor on
    ``device``; the program's random seed and the executor's run count
    (``step``) that seed stochastic ops; ``amp``, the program's
    ``_amp_lowering`` ({"dtype", "white", "black"}) or None.

    What the executor's compiled step adds (``plan_grads`` builds the
    first four):

    * ``keep``: forward op index -> the input names its grad op
      differentiates.  Such an op runs under autograd on detached leaves
      of those inputs, and its graph is kept in ``saved`` for its grad op
      (no second forward, unless the program itself re-emits it: under
      recompute the kept op is the re-emitted copy).
    * ``grad_source``: grad op index -> (its forward's index, whether this
      grad op is the last to read the kept graph).
    * ``dead``: grad outputs that no op reads, no fetch names and no
      state holds; they are not computed.
    * ``differentiated``: the forward ops whose values a grad op
      differentiates: those in ``keep`` and, under recompute, the
      originals of the re-emitted ops in it.  Ops that pick their
      kernel by whether a grad op reads them (``mul`` and ``rms_norm`` on
      the card, ``mul`` on the CPU) ask ``differentiates()``, so an
      original and its re-emitted copy compute the same bits.
    * ``generators``: (op seed, draw) -> torch.Generator, owned by the
      caller so that a captured graph keeps them registered (see
      ``rng``); ``seeding`` False leaves their seeds to the caller (a
      capture).
    * ``in_place``: the scope state this run may write into (the
      entry's state read and rebound; empty under the non-finite guard).
      A state output (``set_state``) whose input is one of them is
      written into that input's storage, the port's counterpart of the
      reference's donated buffers; any other input (a feed, say) is
      never written.
    """

    def __init__(self, block: Block, env: Dict[str, Any],
                 device: torch.device, random_seed: int = 0,
                 is_test: bool = False, step: int = 0, amp=None,
                 keep=None, grad_source=None, dead=(), generators=None,
                 in_place=(), seeding: bool = True, differentiated=()):
        self.block = block
        self.env = env
        self.device = torch.device(device)
        self.random_seed = int(random_seed or 0)
        self.is_test = is_test
        self.step = int(step)
        self.amp = amp
        self.keep: Dict[int, Sequence[str]] = keep or {}
        self.grad_source: Dict[int, tuple] = grad_source or {}
        self.dead = frozenset(dead)
        self.differentiated = frozenset(differentiated)
        self.generators: Dict[tuple, torch.Generator] = \
            {} if generators is None else generators
        self.seeding = seeding
        self.draws: Dict[int, int] = {}  # op seed -> its draws this run
        self.in_place = frozenset(in_place)
        self.op_index = -1  # the index in block.ops of the op lowering now
        # (name, dtype) -> (source tensor, cast): one AMP cast per tensor
        # per run, whichever ops read it
        self.casts: Dict[tuple, tuple] = {}
        # id(value) -> (value, detached leaf) shared by the kept forwards
        # that differentiate the same value
        self.leaves: Dict[int, tuple] = {}
        # forward op index -> (leaf by input name, output by original
        # name); the most graphs kept at once this run
        self.saved: Dict[int, tuple] = {}
        self.peak_saved = 0

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

    def set_state(self, op: Operator, out_slot: str, in_slot: str, value):
        """Bind `value` to the state output `out_slot`, which aliases the
        input `in_slot` (an op's ``stateful_outputs``).  Where the input
        is state in ``in_place`` it is written into the input tensor's
        storage (no autograd graph goes with it) and the output binds
        that tensor; otherwise the output binds `value` (the non-finite
        guard needs the old state until it has chosen, and a fed value is
        the caller's)."""
        name = op.single_output(out_slot)
        if name is None:
            return
        dst = self.get_input(op, in_slot)
        if name in self.in_place and name == op.single_input(in_slot) and \
                isinstance(dst, torch.Tensor) and dst.shape == value.shape:
            if value is not dst:
                dst.copy_(value.detach())
            value = dst
        self.env[name] = value

    def free(self, name: str):
        """Drop `name`'s value (after its last reader) and the casts and
        leaves made from it."""
        v = self.env.pop(name, None)
        self.leaves.pop(id(v), None)
        for dt in _AMP_CASTABLE:
            hit = self.casts.pop((name, dt), None)
            if hit is not None:
                self.leaves.pop(id(hit[1]), None)

    def differentiates(self) -> bool:
        """Whether a grad op differentiates the op lowering now (see
        ``differentiated``)."""
        return self.op_index in self.differentiated

    def rng(self, op: Operator, fold: int = 0) -> torch.Generator:
        """A generator for the op's draw on the context's device, made at
        its first use in ``generators``.  Every draw of an op seed in a
        run gets its own generator, keyed (op seed, n-th draw of that
        seed in the run), seeded from the program's random seed, the run
        count (``step``) and the op's build-time ``__op_seed__`` alone
        (``run_seed``; the JAX package folds the same three into its
        key).  So every draw of one op seed in a run gives the same
        numbers, as the JAX package's key does: a forward op re-emitted
        by recompute (which keeps the original's ``__op_seed__``) draws
        the original's mask.  And a run draws what any executor draws at
        that run count, whatever run its entry first ran at: a resumed
        run draws the masks of the run it resumes.  A captured entry's
        generators are registered with its CUDA graph and seeded by the
        executor before each replay (``seeding`` False here); a grad op
        reads its forward's mask from the kept graph.  A nonzero `fold`
        (an op's draws that must differ from one another, as each layer
        of a multi-layer ``rnn``'s dropout) is folded into the seed, and
        keys its generator beside the op seed and the draw."""
        seed = int(op.attr("__op_seed__", 0))
        n = self.draws.get(seed, 0)
        self.draws[seed] = n + 1
        key = (seed, n, int(fold))
        g = self.generators.get(key)
        if g is None:
            g = self.generators[key] = torch.Generator(device=self.device)
        if self.seeding:
            g.manual_seed(run_seed(self.random_seed, self.step, seed, fold))
        return g


def run_seed(random_seed: int, step: int, op_seed: int,
             fold: int = 0) -> int:
    """The seed of an op's generator at run `step` (`fold` 0: the op's
    plain draw)."""
    key = (int(random_seed), int(step), int(op_seed))
    if fold:
        key += (int(fold),)
    return hash(key) % (1 << 63)


# the suffixes append_backward(checkpoints=...) gives a re-emitted
# forward op's outputs (framework/backward.py)
_RECOMPUTED = re.compile(r"@RC(?:_DISCARD)?\d+$")


def original_name(name: str) -> str:
    """`name` without a recompute suffix: the forward output a re-emitted
    op's output stands for (its grad op names the original)."""
    return _RECOMPUTED.sub("", name)


class OpDef:
    def __init__(self, type: str,
                 infer: Optional[Callable[[Operator, Block], None]] = None,
                 lower: Optional[Callable[[LowerContext, Operator], None]] = None,
                 grad=None, stateful_outputs: Sequence[str] = (),
                 selected_rows: bool = False):
        self.type = type
        self.infer = infer
        self.lower = lower
        # None = non-differentiable; 'auto' = autograd of the forward
        # lowering; callable(fwd_op, block, helper) -> list of grad op specs
        self.grad = grad
        # output slots aliasing an input (in-place update semantics, e.g.
        # an optimizer's ParamOut)
        self.stateful_outputs = tuple(stateful_outputs)
        # whether the lowering takes a SelectedRows input (lower_op raises
        # for one that does not)
        self.selected_rows = selected_rows


_REGISTRY: Dict[str, OpDef] = {}


def register_op(type: str, *, infer=None, lower=None, grad="auto",
                stateful_outputs=(), selected_rows=False):
    """Register an op type.  Usable directly or as a decorator on `lower`.
    `selected_rows` marks a lowering that takes SelectedRows inputs."""
    if lower is None:
        def deco(fn):
            register_op(type, infer=infer, lower=fn, grad=grad,
                        stateful_outputs=stateful_outputs,
                        selected_rows=selected_rows)
            return fn
        return deco
    _REGISTRY[type] = OpDef(type, infer=infer, lower=lower, grad=grad,
                            stateful_outputs=stateful_outputs,
                            selected_rows=selected_rows)
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


def _writes_state(ctx: LowerContext, op: Operator) -> bool:
    """Whether `op` writes a persistable variable."""
    for n in op.output_arg_names():
        v = ctx.block._find_var_recursive(n)
        if v is not None and v.persistable:
            return True
    return False


def _amp_target(ctx: LowerContext, op: Operator) -> Optional[torch.dtype]:
    """The dtype AMP gives `op`'s float inputs: low precision for the
    white list, float32 for the black list, None otherwise; a grad op
    casts like its forward.  Fluid's AMP rewrites only the forward and
    its gradients, so gradients are summed, clipped and applied at
    float32 into float32 state: an op of the Optimize role (clip, update,
    gradient merge's average and reset, the moving averages) sees
    float32, and an op outside the forward and its grad ops that writes
    persistable state (gradient merge's accumulate) sees its inputs as
    they are."""
    amp = ctx.amp
    if amp is None:
        return None
    role = op.attr("op_role", OpRole.Forward)
    if role & OpRole.Optimize:
        return torch.float32
    if (role & OpRole.Backward and not op.attr("__accumulate__", False)
            and _writes_state(ctx, op)):
        return None
    base = op.type[:-5] if op.type.endswith("_grad") else op.type
    if base in amp["white"]:
        return dtype_to_torch(amp["dtype"])
    if base in amp["black"]:
        return torch.float32
    return None


def _cast(ctx: LowerContext, name: str, v, target):
    """`v` (the value of `name`) in `target`, cast once per run: later
    readers of the same value get the same cast."""
    if not (isinstance(v, torch.Tensor) and v.dtype in _AMP_CASTABLE
            and v.dtype != target):
        return v
    hit = ctx.casts.get((name, target))
    if hit is not None and hit[0] is v:
        return hit[1]
    c = v.to(target)
    ctx.casts[(name, target)] = (v, c)
    return c


def _lower_with_amp(ctx: LowerContext, opdef: "OpDef", op: Operator):
    """Autocast wrapper: white-list ops see low-precision float inputs,
    black-list ops see float32.  The env bindings are restored
    afterwards, so other consumers keep the original precision (master
    weights stay float32 in the scope)."""
    target = _amp_target(ctx, op)
    if target is None:
        opdef.lower(ctx, op)
        return
    saved = {}
    for name in op.input_arg_names():
        v = ctx.env.get(name)
        c = _cast(ctx, name, v, target)
        if c is not v:
            saved[name] = v
            ctx.env[name] = c
    opdef.lower(ctx, op)
    written = set(op.output_arg_names())
    for n, v in saved.items():
        if n not in written:  # an in-place output keeps its new value
            ctx.env[n] = v


def _lower_kept(ctx: LowerContext, opdef: "OpDef", op: Operator,
                primals: Sequence[str]):
    """Lower a forward op whose grad op is in the block under autograd:
    its `primals` inputs (AMP-cast first, as the grad op would see them)
    become detached leaves, and the leaves and the op's outputs are kept
    in ``ctx.saved`` until the grad op has read them."""
    target = _amp_target(ctx, op)
    env = {}
    for name in op.input_arg_names():
        v = ctx.get(name)
        if target is not None:
            v = _cast(ctx, name, v, target)
        if name in primals:
            hit = ctx.leaves.get(id(v))
            if hit is None or hit[0] is not v:
                hit = (v, v.detach().requires_grad_(True))
                ctx.leaves[id(v)] = hit
            v = hit[1]
        env[name] = v
    sub = copy.copy(ctx)  # shares generators, casts, leaves, saved
    sub.env = env
    grad_op = opdef.lower is _lower_auto_grad
    with torch.enable_grad():
        if grad_op:  # a grad op that a later grad op differentiates
            _differentiable_grad(sub, op)
        else:
            opdef.lower(sub, op)
    outs = {n: env[n] for n in op.output_arg_names() if n in env}
    if grad_op and op.attr("__accumulate__", False):
        # the kept graph holds this op's own terms; the block's value sums
        # them into the other consumers' terms, as _lower_auto_grad does
        ctx.env.update({n: ctx.env[n] + v if n in ctx.env else v
                        for n, v in outs.items()})
    else:
        ctx.env.update(outs)
    ctx.saved[ctx.op_index] = ({n: env[n] for n in primals},
                               {original_name(n): v for n, v in outs.items()})
    ctx.peak_saved = max(ctx.peak_saved, len(ctx.saved))


def lower_op(ctx: LowerContext, op: Operator, index: int = -1):
    """Lower `op`, the `index`-th op of ``ctx.block`` (the key of the
    context's ``keep`` / ``grad_source`` plans)."""
    opdef = _REGISTRY.get(op.type)
    if opdef is None or opdef.lower is None:
        raise UnimplementedError(f"no lowering for op {op.type!r}")
    ctx.op_index = index
    if not opdef.selected_rows:
        for name in op.input_arg_names():
            if isinstance(ctx.env.get(name), SelectedRowsValue):
                raise NotImplementedError(
                    f"op {op.type!r} got the SelectedRows value of "
                    f"{name!r}; the port's sparse gradients reach only the "
                    f"ops ported with them (the rest of the op catalog is "
                    f"ROADMAP.md queue 1, item 7)")
    with op_error_context(op, ctx.block, phase="lowering"):
        primals = ctx.keep.get(index)
        if primals is not None:
            _lower_kept(ctx, opdef, op, primals)
        elif opdef.lower is _lower_auto_grad:
            opdef.lower(ctx, op)  # casts nothing: its forward already did
        else:
            _lower_with_amp(ctx, opdef, op)
    for name in op.output_arg_names():  # a write ends the casts of the old
        for dt in _AMP_CASTABLE:       # value, in place or not
            ctx.casts.pop((name, dt), None)


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


def _grad_slots(gop: Operator, dead=frozenset()) -> List[tuple]:
    """(forward input slot, index, grad name) of every grad `gop` writes,
    in a stable order, leaving out the names in `dead`."""
    wanted = []
    for gslot, gnames in gop.outputs.items():
        slot = gslot[:-len("@GRAD")]
        for i, gname in enumerate(gnames):
            if gname and gname not in dead:
                wanted.append((slot, i, gname))
    return wanted


def _lower_auto_grad(ctx: LowerContext, gop: Operator):
    """Lowering of an auto-derived ``<type>_grad`` op:
    ``torch.autograd.grad`` of the outputs its forward op kept
    (``ctx.saved``, see ``_lower_kept``) against the forward's leaves,
    with the recorded cotangents.  Nothing is lowered again: a
    stochastic forward's draw is in the kept graph.  Grad outputs in
    ``ctx.dead`` are not computed."""
    fwd_inputs: Dict[str, List[str]] = gop.attr("__fwd_inputs__")
    fwd_outputs: Dict[str, List[str]] = gop.attr("__fwd_outputs__")
    wanted = _grad_slots(gop, ctx.dead)
    if not wanted:
        return
    source = ctx.grad_source.get(ctx.op_index)
    saved = None if source is None else ctx.saved.get(source[0])
    if saved is None:
        raise RuntimeError(
            f"{gop.type}: its forward {gop.attr('__fwd_type__')!r} op (outputs "
            f"{fwd_outputs}) was not lowered with its autograd graph kept in "
            f"this run; a grad op needs its forward earlier in the same block")
    leaves, outputs = saved
    if source[1]:  # the last grad op of this forward: free its graph
        del ctx.saved[source[0]]
    diff_names: List[str] = []
    for slot, i, _ in wanted:
        n = fwd_inputs[slot][i]
        if n not in diff_names:
            diff_names.append(n)
    primals = [leaves[n] for n in diff_names]

    # cotangent names were recorded in the op's <slot>@GRAD inputs at
    # build time; a missing cotangent counts as zeros
    cot_name = {}
    for slot, names in fwd_outputs.items():
        gnames = gop.inputs.get(slot + "@GRAD", [])
        for i, n in enumerate(names):
            if i < len(gnames) and gnames[i]:
                cot_name[n] = gnames[i]
    outs, cots, seen = [], [], set()
    for names in fwd_outputs.values():
        for n in names:
            ov = outputs.get(n)
            g = ctx.env.get(cot_name.get(n, grad_var_name(n)))
            if n in seen or not isinstance(ov, torch.Tensor) or \
                    not ov.requires_grad or g is None:
                continue  # not connected to the inputs, or a zero cotangent
            seen.add(n)
            outs.append(ov)
            cots.append(g.to(ov.dtype).reshape(ov.shape))
    # retain_graph: leaves (and their casts) are shared by the kept
    # forwards that read the same value; each graph goes with its outputs
    grads = (torch.autograd.grad(outs, primals, cots, allow_unused=True,
                                 retain_graph=True)
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


def _differentiable_grad(ctx: LowerContext, gop: Operator):
    """Lower the auto-derived grad op `gop` as a function of its inputs in
    ``ctx.env`` whose results keep a graph back to them, for a later grad
    op to differentiate (higher-order ``gradients``): its forward op is
    lowered again on those inputs (a grad op's own forward recursively,
    from the ``__fwd_desc__`` recorded at build time) and differentiated
    with ``create_graph``, as the JAX package takes ``jax.vjp`` of the
    re-lowered forward.  Writes every grad output into ``ctx.env``,
    without accumulating (the caller sums into the block's value)."""
    fwd_inputs: Dict[str, List[str]] = gop.attr("__fwd_inputs__")
    fwd_outputs: Dict[str, List[str]] = gop.attr("__fwd_outputs__")
    desc = gop.attr("__fwd_desc__")
    attrs = dict(desc["attrs"]) if desc is not None else {
        k: v for k, v in gop.attrs.items() if not k.startswith("__fwd_")}
    fwd_op = Operator(ctx.block, gop.attr("__fwd_type__"), fwd_inputs,
                      fwd_outputs, attrs)
    wanted = _grad_slots(gop)
    diff_names: List[str] = []
    for slot, i, _ in wanted:
        n = fwd_inputs[slot][i]
        if n not in diff_names:
            diff_names.append(n)
    env = {n: ctx.get(n) for names in fwd_inputs.values() for n in names}
    for n in diff_names:
        if not env[n].requires_grad:  # no graph reaches it from outside
            env[n] = env[n].detach().requires_grad_(True)
    sub = copy.copy(ctx)
    sub.env, sub.casts, sub.op_index = env, {}, -1
    sub.differentiated = frozenset({-1})  # the training kernels
    sub.in_place = frozenset()  # state was written by the op's first run
    fdef = get_op_def(fwd_op.type)
    if fdef.lower is _lower_auto_grad:
        _differentiable_grad(sub, fwd_op)
    else:
        _lower_with_amp(sub, fdef, fwd_op)
    outs, cots, seen = [], [], set()
    for slot, names in fwd_outputs.items():
        gnames = gop.inputs.get(slot + "@GRAD", [])
        for i, n in enumerate(names):
            ov = env.get(n)
            g = ctx.env.get(gnames[i]) if i < len(gnames) and gnames[i] \
                else None
            if n in seen or not isinstance(ov, torch.Tensor) or \
                    not ov.requires_grad or g is None:
                continue
            seen.add(n)
            outs.append(ov)
            cots.append(g.to(ov.dtype).reshape(ov.shape))
    primals = [env[n] for n in diff_names]
    grads = (torch.autograd.grad(outs, primals, cots, allow_unused=True,
                                 create_graph=True)
             if outs else [None] * len(primals))
    by_name = {n: torch.zeros_like(p) if g is None else g
               for n, p, g in zip(diff_names, primals, grads)}
    for slot, i, gname in wanted:
        ctx.env[gname] = by_name[fwd_inputs[slot][i]]


# grad ops with a lowering of their own whose outputs the dead-grad pass
# covers as it covers the auto-derived ones' (the op skips a dead output)
SPARSE_GRAD_OPS = frozenset({"lookup_table_sparse_grad"})


def _frozen(slots: Dict[str, List[str]]) -> tuple:
    return tuple(sorted((k, tuple(v)) for k, v in slots.items()))


def plan_grads(ops: Sequence[tuple], live: set) -> tuple:
    """The grad side of a compiled step over `ops` ((index, op) pairs of
    one block): (keep, grad_source, dead, differentiated) as
    ``LowerContext`` takes them.  `live` holds every name some op reads,
    a fetch names or the state holds; an auto-derived grad op's output
    outside it is dead.  Each auto-derived grad op with a live output is
    paired with the latest op before it of its forward's type, inputs
    and outputs, which then keeps its graph for the inputs whose grads
    are live.  A ``lookup_table_sparse_grad`` output outside `live` is
    dead too.  A forward re-emitted by recompute has the inputs the
    grad op's ``__fwd_inputs__`` name and its outputs renamed
    (``@RC<k>``, ``@RC_DISCARD<n>``) where the grad op names the
    originals, so outputs are compared by ``original_name``: the grad op
    pairs with the re-emitted copy, and the original keeps no graph.  A
    grad op that a later ``gradients()`` pass differentiates is itself
    kept (it re-lowers its forward, ``_differentiable_grad``) and reads
    no kept graph; its forward counts as differentiated.  Raises for a
    grad op whose forward is not before it in the block."""
    forward_at: Dict[tuple, int] = {}
    writes: Dict[int, tuple] = {}  # op index -> (type, original outputs)
    first_at: Dict[tuple, int] = {}  # the first op of each such pair
    pairs = []
    dead = set()
    for i, op in ops:
        opdef = _REGISTRY.get(op.type)
        if op.type in SPARSE_GRAD_OPS:
            dead.update(n for n in op.output_arg_names()
                        if n and n not in live)
        outs = _frozen({k: [original_name(n) for n in v]
                        for k, v in op.outputs.items()})
        # a grad op is a forward too, of the grad ops a later gradients()
        # pass emits for it
        forward_at[(op.type, _frozen(op.inputs), outs)] = i
        writes[i] = (op.type, outs)
        first_at.setdefault(writes[i], i)
        if opdef is None or opdef.lower is not _lower_auto_grad:
            continue
        dead.update(n for n in op.output_arg_names()
                    if n and n not in live)
        wanted = _grad_slots(op, dead)
        if not wanted:
            continue
        fwd_inputs = op.attr("__fwd_inputs__")
        f = forward_at.get((op.attr("__fwd_type__"), _frozen(fwd_inputs),
                            _frozen(op.attr("__fwd_outputs__"))))
        if f is None:
            raise RuntimeError(
                f"grad op {op.type!r} (index {i}) has no forward op before "
                f"it in its block; the port differentiates the autograd "
                f"graph its forward kept")
        pairs.append((i, f, {fwd_inputs[slot][j] for slot, j, _ in wanted}))
    # A grad op that a later grad op differentiates is kept: it re-lowers
    # its forward (_differentiable_grad) and reads no kept graph, so its
    # own pairing is dropped.  Latest first: whether an op is kept is
    # settled by the grad ops after it.
    keep: Dict[int, set] = {}
    relowered = set()
    for i, f, names in reversed(pairs):
        if i in keep:
            relowered.add(f)
            continue
        keep.setdefault(f, set()).update(names)
    pairs = [(i, f) for i, f, _ in pairs if i not in keep]
    last = {f: i for i, f in pairs}
    grad_source = {i: (f, last[f] == i) for i, f in pairs}
    # a kept forward and its original (itself unless re-emitted); a
    # forward that a kept grad op lowers again computes as it would kept
    differentiated = set(keep) | relowered | {
        first_at[writes[f]] for f in set(keep) | relowered}
    return ({f: frozenset(names) for f, names in keep.items()},
            grad_source, frozenset(dead), frozenset(differentiated))


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
