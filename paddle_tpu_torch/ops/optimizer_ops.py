"""Optimizer op lowerings: ``sgd``, ``momentum``, ``adam``, ``adamw`` and
``adagrad``, on a dense or a SelectedRows gradient.

Counterpart of ``paddle_tpu/ops/optimizer_ops.py:46-199`` and
``:224-254``.  The update (param, grad, state) -> (param', state') is
computed in float32 as the reference computes it, in the parameter's and
the state's own storage where the run updates state in place (the port's
counterpart of the reference's donated buffers); under the executor's
non-finite guard it is bound as new tensors instead, and the executor
selects.  Registered grad=None with their aliased outputs as
``stateful_outputs``.

A SelectedRows gradient (an embedding looked up with ``is_sparse``):
``sgd`` and ``adagrad`` merge it and update the touched rows only;
``adam`` / ``adamw`` with ``lazy_mode`` do the same for the parameter and
both moments (AdamW's decay stays dense: it is decoupled from the
gradient); ``momentum`` and ``adam`` without ``lazy_mode`` densify it,
since every row moves with a zero gradient.  A touched-rows update gathers
the merged rows (``framework/selected_rows.py`` ``touched``), computes
them and copies them back with ``index_copy_``: the merge makes the rows
unique, so the gathers and copies are deterministic on the card.
"""
from __future__ import annotations

import torch

from ..framework.core import Block, Operator
from ..framework.selected_rows import densify, is_selected_rows, touched
from .registry import LowerContext, in_var, register_op, set_out


def _opt_infer(*alias_pairs):
    """Outputs mirror the shape and dtype of the aliased input slot."""
    def infer(op: Operator, block: Block):
        for out_slot, in_slot in alias_pairs:
            if op.output(out_slot):
                src = in_var(op, block, in_slot)
                set_out(op, block, out_slot, src.shape, src.dtype)
    return infer


def _in_place(ctx: LowerContext, op: Operator, out_slot: str,
              in_slot: str) -> bool:
    name = op.single_output(out_slot)
    return name == op.single_input(in_slot) and name in ctx.in_place


def _write_rows(ctx: LowerContext, op: Operator, out_slot: str,
                in_slot: str, idx: torch.Tensor, rows: torch.Tensor,
                dst: torch.Tensor = None):
    """Bind the state output `out_slot` (aliasing `in_slot`) to `dst` (by
    default the input) with the rows `idx` replaced by `rows`: in the
    input's storage where the run updates it in place, else as a new
    tensor."""
    name = op.single_output(out_slot)
    if name is None:
        return
    if dst is None:
        dst = ctx.get_input(op, in_slot)
    rows = rows.to(dst.dtype)
    if _in_place(ctx, op, out_slot, in_slot):
        ctx.env[name] = dst.index_copy_(0, idx, rows)
    else:
        ctx.env[name] = dst.index_copy(0, idx, rows)


_ADAM_ALIASES = (("ParamOut", "Param"), ("Moment1Out", "Moment1"),
                 ("Moment2Out", "Moment2"), ("Beta1PowOut", "Beta1Pow"),
                 ("Beta2PowOut", "Beta2Pow"))


def _adam_attrs(ctx: LowerContext, op: Operator):
    """(beta1, beta2, epsilon, AdamW's decay coefficient) of the op."""
    b1 = op.attr("beta1", 0.9)
    b2 = op.attr("beta2", 0.999)
    if op.single_input("Beta1Tensor"):
        b1 = ctx.get_input(op, "Beta1Tensor")
    if op.single_input("Beta2Tensor"):
        b2 = ctx.get_input(op, "Beta2Tensor")
    coeff = 0.0
    if op.type == "adamw":
        coeff = op.attr("coeff", 0.01) if op.attr("with_decay", True) \
            else 0.0
    return b1, b2, op.attr("epsilon", 1e-8), coeff


def _adam(ctx: LowerContext, op: Operator):
    """Adam; ``adamw`` first decays the parameter, p * (1 - lr * coeff)
    (decoupled weight decay; ``with_decay`` False sets coeff to 0).  A
    SelectedRows gradient takes ``_adam_lazy`` under ``lazy_mode`` and is
    densified otherwise (every row moves, with a zero gradient where no id
    was looked up).

    Where every output aliases its input, every such input is state the
    run updates in place (``ctx.in_place``) and the parameter is float32
    (the master weights), the same arithmetic runs in the inputs' own
    storage (``mul_`` / ``add_`` / ``sub_`` of the very terms the
    functional form adds), so no copy pass follows it."""
    g = ctx.get_input(op, "Grad")
    if is_selected_rows(g):
        if op.attr("lazy_mode", False):
            return _adam_lazy(ctx, op, g)
        g = g.to_dense()
    g = g.float()
    p = ctx.get_input(op, "Param")
    m1 = ctx.get_input(op, "Moment1")
    m2 = ctx.get_input(op, "Moment2")
    b1p = ctx.get_input(op, "Beta1Pow")
    b2p = ctx.get_input(op, "Beta2Pow")
    lr = ctx.get_input(op, "LearningRate")
    b1, b2, eps, coeff = _adam_attrs(ctx, op)
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


def _adam_lazy(ctx: LowerContext, op: Operator, grad):
    """``lazy_mode`` (the reference's adam_op.h:269): only the rows the
    SelectedRows gradient touches update, in the parameter and in both
    moments; AdamW's decay still scales every row first."""
    p = ctx.get_input(op, "Param")
    m1 = ctx.get_input(op, "Moment1")
    m2 = ctx.get_input(op, "Moment2")
    b1p = ctx.get_input(op, "Beta1Pow")
    b2p = ctx.get_input(op, "Beta2Pow")
    lr = ctx.get_input(op, "LearningRate")
    b1, b2, eps, coeff = _adam_attrs(ctx, op)
    if op.type == "adamw":
        p = p.mul_(1.0 - lr * coeff) if _in_place(
            ctx, op, "ParamOut", "Param") else p * (1.0 - lr * coeff)
    idx, g = touched(grad.merge())
    g = g.float()
    m1n = b1 * m1[idx] + (1 - b1) * g
    m2n = b2 * m2[idx] + (1 - b2) * g * g
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    prn = p[idx].float() - lr_t * m1n / (torch.sqrt(m2n)
                                         + eps * torch.sqrt(1 - b2p))
    _write_rows(ctx, op, "ParamOut", "Param", idx, prn, dst=p)
    _write_rows(ctx, op, "Moment1Out", "Moment1", idx, m1n)
    _write_rows(ctx, op, "Moment2Out", "Moment2", idx, m2n)
    ctx.set_state(op, "Beta1PowOut", "Beta1Pow", b1p * b1)
    ctx.set_state(op, "Beta2PowOut", "Beta2Pow", b2p * b2)


for _t in ("adam", "adamw"):
    register_op(_t, infer=_opt_infer(*_ADAM_ALIASES), lower=_adam,
                grad=None, selected_rows=True,
                stateful_outputs=tuple(a for a, _ in _ADAM_ALIASES))


@register_op("sgd", infer=_opt_infer(("ParamOut", "Param")), grad=None,
             stateful_outputs=("ParamOut",), selected_rows=True)
def _sgd(ctx: LowerContext, op: Operator):
    """p - lr * g, in the parameter's dtype (the reference's dense
    branch); a SelectedRows gradient is merged and only its rows move
    (the reference's sgd_op.h:73)."""
    p = ctx.get_input(op, "Param")
    g = ctx.get_input(op, "Grad")
    lr = ctx.get_input(op, "LearningRate")
    if is_selected_rows(g):
        idx, vals = touched(g.merge())
        _write_rows(ctx, op, "ParamOut", "Param", idx,
                    p[idx] - lr * vals.to(p.dtype))
        return
    ctx.set_state(op, "ParamOut", "Param", p - lr * g.to(p.dtype))


@register_op("momentum", infer=_opt_infer(("ParamOut", "Param"),
                                          ("VelocityOut", "Velocity")),
             grad=None, stateful_outputs=("ParamOut", "VelocityOut"),
             selected_rows=True)
def _momentum(ctx: LowerContext, op: Operator):
    """v' = mu * v + g; p' = p - lr * v' (Nesterov: p - (g + mu * v') *
    lr), with the reference's optional ``l2_decay`` folded into g.  A
    SelectedRows gradient densifies: the reference's sparse momentum is
    the dense one (every velocity decays)."""
    p = ctx.get_input(op, "Param")
    g = densify(ctx.get_input(op, "Grad")).to(p.dtype)
    v = ctx.get_input(op, "Velocity")
    lr = ctx.get_input(op, "LearningRate")
    mu = op.attr("mu", 0.9)
    if op.attr("regularization_method", "") == "l2_decay":
        g = g + op.attr("regularization_coeff", 0.0) * p
    v_new = mu * v + g
    if op.attr("use_nesterov", False):
        p_new = p - (g + mu * v_new) * lr
    else:
        p_new = p - lr * v_new
    ctx.set_state(op, "ParamOut", "Param", p_new)
    ctx.set_state(op, "VelocityOut", "Velocity", v_new)


@register_op("adagrad", infer=_opt_infer(("ParamOut", "Param"),
                                         ("MomentOut", "Moment")),
             grad=None, stateful_outputs=("ParamOut", "MomentOut"),
             selected_rows=True)
def _adagrad(ctx: LowerContext, op: Operator):
    """m' = m + g * g; p' = p - lr * g / (sqrt(m') + eps), in float32.  A
    SelectedRows gradient is merged and only its rows move (the
    reference's adagrad_op SelectedRows branch)."""
    p = ctx.get_input(op, "Param")
    g = ctx.get_input(op, "Grad")
    m = ctx.get_input(op, "Moment")
    lr = ctx.get_input(op, "LearningRate")
    eps = op.attr("epsilon", 1e-6)
    if is_selected_rows(g):
        idx, gv = touched(g.merge())
        gv = gv.float()
        mn = m[idx] + gv * gv
        prn = p[idx].float() - lr * gv / (torch.sqrt(mn) + eps)
        _write_rows(ctx, op, "ParamOut", "Param", idx, prn)
        _write_rows(ctx, op, "MomentOut", "Moment", idx, mn)
        return
    g = g.float()
    mn = m + g * g
    p_new = p.float() - lr * g / (torch.sqrt(mn) + eps)
    ctx.set_state(op, "ParamOut", "Param", p_new.to(p.dtype))
    ctx.set_state(op, "MomentOut", "Moment", mn)
