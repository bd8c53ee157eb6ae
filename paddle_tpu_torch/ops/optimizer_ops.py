"""Optimizer op lowerings: ``adam`` and ``adamw`` on a dense gradient.

Counterpart of ``paddle_tpu/ops/optimizer_ops.py:97-147,196-199``.  A
pure update (param, grad, state) -> (param', state') in float32; the
executor writes the new tensors back into the scope, so nothing is
updated in place.  Registered grad=None with their aliased outputs as
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
    (decoupled weight decay; ``with_decay`` False sets coeff to 0)."""
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
    if op.type == "adamw":
        coeff = op.attr("coeff", 0.01) if op.attr("with_decay", True) \
            else 0.0
        p = p * (1.0 - lr * coeff)
    m1n = b1 * m1 + (1 - b1) * g
    m2n = b2 * m2 + (1 - b2) * g * g
    # lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t), as the reference's adam_op
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    pf = p.float() - lr_t * m1n / (torch.sqrt(m2n) + eps * torch.sqrt(1 - b2p))
    ctx.set_output(op, "ParamOut", pf.to(p.dtype))
    ctx.set_output(op, "Moment1Out", m1n)
    ctx.set_output(op, "Moment2Out", m2n)
    ctx.set_output(op, "Beta1PowOut", b1p * b1)
    ctx.set_output(op, "Beta2PowOut", b2p * b2)


for _t in ("adam", "adamw"):
    register_op(_t, infer=_adam_infer, lower=_adam, grad=None,
                stateful_outputs=tuple(a for a, _ in _ADAM_ALIASES))
