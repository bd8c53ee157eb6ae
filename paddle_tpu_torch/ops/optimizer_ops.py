"""Optimizer op lowerings: ``sgd``, ``adam`` and ``adamw`` on a dense
gradient.

Counterpart of ``paddle_tpu/ops/optimizer_ops.py:46-63,97-147,196-199``.  The
update (param, grad, state) -> (param', state') is computed in float32 as
the reference computes it, in the parameter's and the state's own
storage where the run updates state in place (the port's counterpart of
the reference's donated buffers); under the executor's non-finite guard
it is bound as new tensors instead, and the executor selects.
Registered grad=None with their aliased outputs as
``stateful_outputs``.  The SelectedRows / ``lazy_mode`` path waits.
"""
from __future__ import annotations

import torch

from ..framework.core import Block, Operator
from .registry import LowerContext, in_var, register_op, set_out

_ADAM_ALIASES = (("ParamOut", "Param"), ("Moment1Out", "Moment1"),
                 ("Moment2Out", "Moment2"), ("Beta1PowOut", "Beta1Pow"),
                 ("Beta2PowOut", "Beta2Pow"))


def _adam_infer(op: Operator, block: Block):
    for out_slot, in_slot in _ADAM_ALIASES:
        if op.output(out_slot):
            src = in_var(op, block, in_slot)
            set_out(op, block, out_slot, src.shape, src.dtype)


def _adam(ctx: LowerContext, op: Operator):
    """Adam; ``adamw`` first decays the parameter, p * (1 - lr * coeff)
    (decoupled weight decay; ``with_decay`` False sets coeff to 0).

    Where every output aliases its input, every such input is state the
    run updates in place (``ctx.in_place``) and the parameter is float32
    (the master weights), the same arithmetic runs in the inputs' own
    storage (``mul_`` / ``add_`` / ``sub_`` of the very terms the
    functional form adds), so no copy pass follows it."""
    p = ctx.get_input(op, "Param")
    g = ctx.get_input(op, "Grad").float()
    m1 = ctx.get_input(op, "Moment1")
    m2 = ctx.get_input(op, "Moment2")
    b1p = ctx.get_input(op, "Beta1Pow")
    b2p = ctx.get_input(op, "Beta2Pow")
    lr = ctx.get_input(op, "LearningRate")
    b1 = op.attr("beta1", 0.9)
    b2 = op.attr("beta2", 0.999)
    if op.single_input("Beta1Tensor"):
        b1 = ctx.get_input(op, "Beta1Tensor")
    if op.single_input("Beta2Tensor"):
        b2 = ctx.get_input(op, "Beta2Tensor")
    eps = op.attr("epsilon", 1e-8)
    coeff = 0.0
    if op.type == "adamw":
        coeff = op.attr("coeff", 0.01) if op.attr("with_decay", True) \
            else 0.0
    # lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t), as the reference's adam_op
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    if p.dtype == torch.float32 and all(
            op.single_output(o) == op.single_input(i)
            and op.single_input(i) in ctx.in_place
            for o, i in _ADAM_ALIASES):
        if op.type == "adamw":
            p.mul_(1.0 - lr * coeff)
        m1.mul_(b1).add_((1 - b1) * g)
        m2.mul_(b2).add_((1 - b2) * g * g)
        p.sub_(lr_t * m1 / (torch.sqrt(m2) + eps * torch.sqrt(1 - b2p)))
        b1p.mul_(b1)
        b2p.mul_(b2)
        for out_slot, in_slot in _ADAM_ALIASES:
            ctx.set_output(op, out_slot, ctx.get_input(op, in_slot))
        return
    if op.type == "adamw":
        p = p * (1.0 - lr * coeff)
    m1n = b1 * m1 + (1 - b1) * g
    m2n = b2 * m2 + (1 - b2) * g * g
    pf = p.float() - lr_t * m1n / (torch.sqrt(m2n) + eps * torch.sqrt(1 - b2p))
    for (out_slot, in_slot), value in zip(_ADAM_ALIASES, (
            pf.to(p.dtype), m1n, m2n, b1p * b1, b2p * b2)):
        ctx.set_state(op, out_slot, in_slot, value)


for _t in ("adam", "adamw"):
    register_op(_t, infer=_adam_infer, lower=_adam, grad=None,
                stateful_outputs=tuple(a for a, _ in _ADAM_ALIASES))


def _sgd_infer(op: Operator, block: Block):
    src = in_var(op, block, "Param")
    set_out(op, block, "ParamOut", src.shape, src.dtype)


@register_op("sgd", infer=_sgd_infer, grad=None,
             stateful_outputs=("ParamOut",))
def _sgd(ctx: LowerContext, op: Operator):
    """p - lr * g, in the parameter's dtype (the reference's dense
    branch)."""
    p = ctx.get_input(op, "Param")
    g = ctx.get_input(op, "Grad")
    lr = ctx.get_input(op, "LearningRate")
    ctx.set_state(op, "ParamOut", "Param", p - lr * g.to(p.dtype))
