"""Control-flow op lowerings: ``conditional_block``, ``cond2``, ``while``
and ``increment``.

Counterpart of ``paddle_tpu/ops/control_flow_ops.py:61-168``.  As the
JAX package lowers a sub-block into the same trace (``lax.cond``,
``lax.while_loop``), a sub-block here lowers into the same run: its ops
go through ``lower_op`` on a child context (``_sub_context``) that sees
every value of the enclosing block and shares its device, AMP lists,
run count and generators.  No nested executor runs.

The step on the card is one captured CUDA graph, which cannot read a
predicate on the host.  So:

* ``conditional_block`` and ``cond2`` compute their branches every run
  into fresh tensors (the child context writes no state in place: its
  ``in_place`` is empty) and select on the device: each ``Out`` of a
  ``conditional_block`` becomes ``torch.where(pred, new, old)``, written
  into the state tensor's own storage where the run updates that state
  in place, so a false step leaves every output bit-identical and the
  step stays captured; ``cond2`` selects between its two branches'
  outputs.  This is the JAX package's own Lookahead idiom (a pair of
  where-selects fused into the step).  The branch's cost is paid on
  every run, taken or not.
* ``while``, whose trip count depends on the data, runs its body op by
  op while its condition, read on the host once an iteration, holds.  A
  program holding a ``while`` is never captured: on the card each of
  its runs is an eager run of the executor (``CompiledStep.eager_only``,
  counted in ``eager_runs`` and ``Executor.cache_info``), never the CPU.
  ``LOOP_COUNTS`` counts the condition's host reads and the iterations.

``increment`` (the LR schedule's and the merge's step counter): no grad,
``Out`` aliases ``X`` and is written into X's storage where the run
updates state in place; the step is a Python number, so a captured step
copies nothing from the host.  Its shape inference gives Out the shape
and dtype of X; the JAX package's infers nothing, so an out-of-place
``increment`` there leaves its output unshaped and the next op's shape
inference raises (``tests/test_torch_control_flow.py``).
``run_program`` waits for its caller, ROADMAP queue 1 item 8.
"""
from __future__ import annotations

import copy
import types
from typing import Dict

import torch

from .registry import LowerContext, lower_op, register_op, same_as_input

# host reads of a while's condition and the iterations of its body, in
# every run of this process
LOOP_COUNTS = types.SimpleNamespace(host_reads=0, iterations=0)

# the attributes that name an op's sub-blocks
SUB_BLOCK_ATTRS = ("sub_block", "true_block", "false_block")


def holds_loop(block) -> bool:
    """Whether `block` or a block under one of its ops holds a ``while``
    (a program that runs eagerly on the card)."""
    for op in block.ops:
        if op.type == "while":
            return True
        for key in SUB_BLOCK_ATTRS:
            idx = op.attr(key, None)
            if idx is not None and holds_loop(block.program.block(idx)):
                return True
    return False


def _sub_context(ctx: LowerContext, block, env: Dict[str, object]
                 ) -> LowerContext:
    """A context that lowers `block` into `env`: the enclosing context's
    device, random seed, run count, AMP lists and generators, but no
    grad plans, no casts of its own and no state written in place."""
    sub = copy.copy(ctx)
    sub.block = block
    sub.env = env
    sub.keep, sub.grad_source, sub.dead = {}, {}, frozenset()
    sub.differentiated = frozenset()
    sub.in_place = frozenset()
    sub.casts, sub.leaves, sub.saved = {}, {}, {}
    return sub


def _lower_sub(ctx: LowerContext, block, env: Dict[str, object]):
    sub = _sub_context(ctx, block, env)
    for o in block.ops:
        lower_op(sub, o)
    return env


def _predicate(value) -> torch.Tensor:
    if value.numel() != 1:
        raise TypeError(
            f"the condition must be a scalar (1-element) tensor, got shape "
            f"{tuple(value.shape)}: reduce it first (e.g. reduce_any / "
            f"reduce_all) or compare to a scalar")
    return value.reshape(()).to(torch.bool)


def _keep_outer_shapes(op, block):
    # the Out vars keep their outer shapes; the sub-block's ops ran their
    # own inference at append time
    pass


@register_op("conditional_block", infer=_keep_outer_shapes, grad=None)
def _conditional_block(ctx: LowerContext, op):
    """Every ``Out`` var keeps its incoming value where ``Cond`` is false
    (it must have one, as in the reference); the branch is computed
    either way and selected on the device."""
    sub = ctx.block.program.block(op.attr("sub_block"))
    out_names = [n for n in op.output("Out") if n]
    for n in out_names:
        if n not in ctx.env:
            raise KeyError(
                f"conditional_block: {n!r} has no value before the branch; "
                f"outputs must be initialized (reference semantics)")
    pred = _predicate(ctx.get_input(op, "Cond"))
    env = _lower_sub(ctx, sub, dict(ctx.env))
    for n in out_names:
        old, new = ctx.env[n], env[n]
        if new is old:
            continue
        new = new.to(old.dtype)
        if n in ctx.in_place and new.shape == old.shape:
            torch.where(pred, new, old, out=old)
        else:
            ctx.env[n] = torch.where(pred, new, old)


@register_op("cond2", infer=_keep_outer_shapes, grad=None)
def _cond2(ctx: LowerContext, op):
    """Two branches (``layers.cond``): both computed, their declared
    outputs selected on the device.  Branch side effects on outer vars
    do not propagate, as in the reference."""
    pred = _predicate(ctx.get_input(op, "Cond"))
    prog = ctx.block.program
    t_env = _lower_sub(ctx, prog.block(op.attr("true_block")),
                       dict(ctx.env))
    f_env = _lower_sub(ctx, prog.block(op.attr("false_block")),
                       dict(ctx.env))
    out_names = [n for n in op.output("Out") if n]
    for n, t, f in zip(out_names, op.attr("true_outs"),
                       op.attr("false_outs")):
        ctx.env[n] = torch.where(pred, t_env[t], f_env[f])


@register_op("while", infer=_keep_outer_shapes, grad=None)
def _while(ctx: LowerContext, op):
    """The body lowers op by op while ``Condition`` holds, read on the
    host before each iteration; the loop vars, ``Out`` and the condition
    come back to the enclosing block."""
    sub = ctx.block.program.block(op.attr("sub_block"))
    cond_name = op.single_input("Condition")
    loop_names = [n for n in op.input("X") if n]
    out_names = [n for n in op.output("Out") if n] or loop_names
    env = dict(ctx.env)
    while True:
        LOOP_COUNTS.host_reads += 1
        if not bool(_predicate(env[cond_name])):
            break
        LOOP_COUNTS.iterations += 1
        _lower_sub(ctx, sub, env)
    for n in dict.fromkeys(loop_names + out_names + [cond_name]):
        ctx.env[n] = env[n]


@register_op("increment", infer=same_as_input(), grad=None,
             stateful_outputs=("Out",))
def _increment(ctx, op):
    x = ctx.get_input(op, "X")
    step = op.attr("step", 1.0)
    if not (x.is_floating_point() or x.is_complex()):
        step = int(step)  # as a tensor of x's dtype would round it
    ctx.set_state(op, "Out", "X", x + step)

