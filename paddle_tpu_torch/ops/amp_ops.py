"""AMP support ops: ``check_finite_and_unscale`` and
``update_loss_scaling``.

Counterpart of ``paddle_tpu/ops/amp_ops.py``.  The first unscales the
gradients (``x.float() / scale``, cast back to x's dtype: a division, as
the reference lowers it, never a multiply by the reciprocal, which rounds
otherwise) and reports whether any of them is inf or NaN; the second is
the dynamic loss-scale state machine (grow after ``incr_every_n_steps``
good steps, shrink after ``decr_every_n_nan_or_inf`` bad ones, never
below 1e-8) and zeroes every gradient of a non-finite step, so the
optimizer ops that follow, which still run, see zeros (the JAX
package's stand-in for the reference's conditional skip).

Everything stays on the device: the flag and the state machine are
tensors (no ``.item()``, no Python branch on a value), so both ops run
inside a captured CUDA graph.  The scale and the two counters are state
written in place (``LowerContext.set_state``): they keep their storage
across replays.
"""
from __future__ import annotations

import torch

from ..framework.core import Block, Operator
from .registry import LowerContext, register_op


def _cfau_infer(op: Operator, block: Block):
    for xn, on in zip(op.input("X"), op.output("Out")):
        xv, ov = block.var(xn), block.var(on)
        ov.shape, ov.dtype = xv.shape, xv.dtype
    fi = op.single_output("FoundInfinite")
    if fi:
        v = block.var(fi)
        v.shape, v.dtype = (1,), "bool"


@register_op("check_finite_and_unscale", infer=_cfau_infer, grad=None,
             stateful_outputs=("Out",))
def _check_finite_and_unscale(ctx: LowerContext, op: Operator):
    scale = ctx.get_input(op, "Scale")
    finite = []
    for name, x in zip(op.output("Out"), ctx.get_inputs(op, "X")):
        xf = x.float() / scale
        finite.append(torch.isfinite(xf).all())
        ctx.env[name] = xf.to(x.dtype)
    found = torch.zeros((1,), dtype=torch.bool, device=ctx.device)
    if finite:
        found = found | ~torch.stack(finite).all()
    ctx.set_output(op, "FoundInfinite", found)


def _uls_infer(op: Operator, block: Block):
    for xn, on in zip(op.input("X"), op.output("Out")):
        xv, ov = block.var(xn), block.var(on)
        ov.shape, ov.dtype = xv.shape, xv.dtype
    for slot, dt in (("LossScaling", "float32"),
                     ("OutGoodSteps", "int32"), ("OutBadSteps", "int32")):
        n = op.single_output(slot)
        if n:
            v = block.var(n)
            v.shape, v.dtype = (1,), dt


@register_op("update_loss_scaling", infer=_uls_infer, grad=None,
             stateful_outputs=("Out", "LossScaling", "OutGoodSteps",
                               "OutBadSteps"))
def _update_loss_scaling(ctx: LowerContext, op: Operator):
    """The reference's update_loss_scaling_op.h UpdateLossScalingFunctor,
    as the JAX package lowers it."""
    found = ctx.get_input(op, "FoundInfinite").reshape(())
    scale = ctx.get_input(op, "PrevLossScaling")
    good = ctx.get_input(op, "InGoodSteps")
    bad = ctx.get_input(op, "InBadSteps")
    incr_n = op.attr("incr_every_n_steps", 1000)
    decr_n = op.attr("decr_every_n_nan_or_inf", 2)
    incr_ratio = op.attr("incr_ratio", 2.0)
    decr_ratio = op.attr("decr_ratio", 0.5)

    bad_n = torch.where(found, bad + 1, torch.zeros_like(bad))
    good_n = torch.where(found, torch.zeros_like(good), good + 1)
    shrink = bad_n >= decr_n
    grow = good_n >= incr_n
    new_scale = torch.where(shrink, scale * decr_ratio,
                            torch.where(grow, scale * incr_ratio, scale))
    new_scale = torch.clamp(new_scale, min=1e-8)
    bad_n = torch.where(shrink, torch.zeros_like(bad_n), bad_n)
    good_n = torch.where(grow, torch.zeros_like(good_n), good_n)

    xs = ctx.get_inputs(op, "X")
    if not op.attr("stop_update", False):
        xs = [torch.where(found, torch.zeros((), dtype=x.dtype,
                                             device=x.device), x)
              for x in xs]
    for name, x in zip(op.output("Out"), xs):
        ctx.env[name] = x
    ctx.set_state(op, "LossScaling", "PrevLossScaling", new_scale)
    ctx.set_state(op, "OutGoodSteps", "InGoodSteps", good_n)
    ctx.set_state(op, "OutBadSteps", "InBadSteps", bad_n)
