"""Optimizer op lowerings: ``sgd``, ``momentum``, ``adam``, ``adamw`` and
``adagrad``, on a dense or a SelectedRows gradient; ``adamax``,
``adadelta``, ``rmsprop``, ``lamb``, ``lars_momentum``, ``ftrl``,
``dpsgd``, ``proximal_gd``, ``decayed_adagrad``, ``proximal_adagrad``
and ModelAverage's ``average_accumulates`` on a dense one.

Counterpart of ``paddle_tpu/ops/optimizer_ops.py``, all sixteen.  The
update (param, grad, state) -> (param', state') is computed in float32
as the reference computes it, in the parameter's and
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


# ---------------------------------------------------------------------------
# The rest of the family (paddle_tpu/ops/optimizer_ops.py:202-536): dense
# gradients, float32 arithmetic, every state output through set_state
# ---------------------------------------------------------------------------

def _reg_opt(op_type, alias_pairs, lower):
    register_op(op_type, infer=_opt_infer(*alias_pairs), lower=lower,
                grad=None, stateful_outputs=tuple(a for a, _ in alias_pairs))


def _set_states(ctx: LowerContext, op: Operator, alias_pairs, values):
    for (out_slot, in_slot), value in zip(alias_pairs, values):
        ctx.set_state(op, out_slot, in_slot, value)


def _dense_grad(ctx: LowerContext, op: Operator) -> torch.Tensor:
    return ctx.get_input(op, "Grad").float()


_ADAMAX = (("ParamOut", "Param"), ("MomentOut", "Moment"),
           ("InfNormOut", "InfNorm"))


def _adamax(ctx: LowerContext, op: Operator):
    """m' = b1 m + (1 - b1) g; u' = max(b2 u, |g|);
    p' = p - lr / (1 - b1^t) * m' / (u' + eps).  Beta1Pow is advanced by
    the optimizer's own ``scale`` op, as in the reference."""
    p = ctx.get_input(op, "Param")
    g = _dense_grad(ctx, op)
    b1p = ctx.get_input(op, "Beta1Pow")
    lr = ctx.get_input(op, "LearningRate")
    b1, b2 = op.attr("beta1", 0.9), op.attr("beta2", 0.999)
    eps = op.attr("epsilon", 1e-8)
    mn = b1 * ctx.get_input(op, "Moment") + (1 - b1) * g
    inf_n = torch.maximum(b2 * ctx.get_input(op, "InfNorm"), g.abs())
    p_new = p.float() - (lr / (1 - b1p)) * (mn / (inf_n + eps))
    _set_states(ctx, op, _ADAMAX, (p_new.to(p.dtype), mn, inf_n))


_reg_opt("adamax", _ADAMAX, _adamax)

_ADADELTA = (("ParamOut", "Param"), ("AvgSquaredGradOut", "AvgSquaredGrad"),
             ("AvgSquaredUpdateOut", "AvgSquaredUpdate"))


def _adadelta(ctx: LowerContext, op: Operator):
    """E[g^2]' = rho E[g^2] + (1 - rho) g^2;
    u = -sqrt((E[u^2] + eps) / (E[g^2]' + eps)) g; p' = p + u;
    E[u^2]' = rho E[u^2] + (1 - rho) u^2 (no learning rate)."""
    p = ctx.get_input(op, "Param")
    g = _dense_grad(ctx, op)
    avg_upd = ctx.get_input(op, "AvgSquaredUpdate")
    rho = op.attr("rho", 0.95)
    eps = op.attr("epsilon", 1e-6)
    avg_sq_n = rho * ctx.get_input(op, "AvgSquaredGrad") + (1 - rho) * g * g
    upd = -torch.sqrt((avg_upd + eps) / (avg_sq_n + eps)) * g
    avg_upd_n = rho * avg_upd + (1 - rho) * upd * upd
    _set_states(ctx, op, _ADADELTA,
                ((p.float() + upd).to(p.dtype), avg_sq_n, avg_upd_n))


_reg_opt("adadelta", _ADADELTA, _adadelta)

_RMSPROP = (("ParamOut", "Param"), ("MeanSquareOut", "MeanSquare"),
            ("MomentOut", "Moment"), ("MeanGradOut", "MeanGrad"))


def _rmsprop(ctx: LowerContext, op: Operator):
    """ms' = rho ms + (1 - rho) g^2; centered, mg' = rho mg + (1 - rho) g
    and the denominator ms' - mg'^2 + eps, else ms' + eps;
    mom' = momentum mom + lr g / sqrt(denominator); p' = p - mom'."""
    p = ctx.get_input(op, "Param")
    g = _dense_grad(ctx, op)
    lr = ctx.get_input(op, "LearningRate")
    rho = op.attr("decay", 0.9)
    eps = op.attr("epsilon", 1e-10)
    ms_n = rho * ctx.get_input(op, "MeanSquare") + (1 - rho) * g * g
    if op.attr("centered", False):
        mg_n = rho * ctx.get_input(op, "MeanGrad") + (1 - rho) * g
        denom = ms_n - mg_n * mg_n + eps
        ctx.set_state(op, "MeanGradOut", "MeanGrad", mg_n)
    else:
        denom = ms_n + eps
    mom_n = op.attr("momentum", 0.0) * ctx.get_input(op, "Moment") + \
        lr * g / torch.sqrt(denom)
    _set_states(ctx, op, _RMSPROP[:3],
                ((p.float() - mom_n).to(p.dtype), ms_n, mom_n))


_reg_opt("rmsprop", _RMSPROP, _rmsprop)


def _lamb(ctx: LowerContext, op: Operator):
    """Adam's moments, bias-corrected, give r = m^ / (sqrt(v^) + eps) +
    wd p; the step is lr * trust * r with trust = ||p|| / ||r||, or 1
    where either norm is 0 (You et al. 2020)."""
    p = ctx.get_input(op, "Param")
    g = _dense_grad(ctx, op)
    b1p = ctx.get_input(op, "Beta1Pow")
    b2p = ctx.get_input(op, "Beta2Pow")
    lr = ctx.get_input(op, "LearningRate")
    b1, b2 = op.attr("beta1", 0.9), op.attr("beta2", 0.999)
    eps = op.attr("epsilon", 1e-6)
    pf = p.float()
    m1n = b1 * ctx.get_input(op, "Moment1") + (1 - b1) * g
    m2n = b2 * ctx.get_input(op, "Moment2") + (1 - b2) * g * g
    r = (m1n / (1 - b1p)) / (torch.sqrt(m2n / (1 - b2p)) + eps) + \
        op.attr("weight_decay", 0.01) * pf
    p_norm = torch.linalg.vector_norm(pf)
    r_norm = torch.linalg.vector_norm(r)
    trust = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm,
                        torch.ones_like(p_norm))
    _set_states(ctx, op, _ADAM_ALIASES,
                ((pf - lr * trust * r).to(p.dtype), m1n, m2n, b1p * b1,
                 b2p * b2))


_reg_opt("lamb", _ADAM_ALIASES, _lamb)

_VELOCITY = (("ParamOut", "Param"), ("VelocityOut", "Velocity"))


def _lars_momentum(ctx: LowerContext, op: Operator):
    """A layer-wise rate lr * coeff * ||p|| / (||g|| + decay ||p|| + eps)
    (lr where either norm is 0); v' = mu v + local_lr (g + decay p);
    p' = p - v' (You, Gitman, Ginsburg 2017)."""
    p = ctx.get_input(op, "Param")
    g = _dense_grad(ctx, op)
    lr = ctx.get_input(op, "LearningRate")
    coeff = op.attr("lars_coeff", 0.001)
    decay = op.attr("lars_weight_decay", 0.0005)
    pf = p.float()
    p_norm = torch.linalg.vector_norm(pf)
    g_norm = torch.linalg.vector_norm(g)
    local_lr = torch.where(
        (p_norm > 0) & (g_norm > 0),
        lr * coeff * p_norm / (g_norm + decay * p_norm
                               + op.attr("epsilon", 0.0)), lr)
    v_new = op.attr("mu", 0.9) * ctx.get_input(op, "Velocity") + \
        local_lr * (g + decay * pf)
    _set_states(ctx, op, _VELOCITY, ((pf - v_new).to(p.dtype), v_new))


_reg_opt("lars_momentum", _VELOCITY, _lars_momentum)

_FTRL = (("ParamOut", "Param"), ("SquaredAccumOut", "SquaredAccumulator"),
         ("LinearAccumOut", "LinearAccumulator"))


def _ftrl(ctx: LowerContext, op: Operator):
    """FTRL-proximal at any ``lr_power``: n' = n + g^2;
    z' = z + g - (n'^-power - n^-power) / lr * p;
    p' = (clip(z', -l1, l1) - z') / (n'^-power / lr + 2 l2) where
    |z'| > l1, else 0."""
    p = ctx.get_input(op, "Param")
    g = _dense_grad(ctx, op)
    sq = ctx.get_input(op, "SquaredAccumulator")
    lr = ctx.get_input(op, "LearningRate")
    l1, l2 = op.attr("l1", 0.0), op.attr("l2", 0.0)
    power = op.attr("lr_power", -0.5)
    new_sq = sq + g * g
    sigma = (torch.pow(new_sq, -power) - torch.pow(sq, -power)) / lr
    new_lin = ctx.get_input(op, "LinearAccumulator") + g - sigma * p.float()
    x = torch.clamp(new_lin, -l1, l1) - new_lin
    y = torch.pow(new_sq, -power) / lr + 2 * l2
    p_new = torch.where(new_lin.abs() > l1, x / y, torch.zeros_like(x))
    _set_states(ctx, op, _FTRL, (p_new.to(p.dtype), new_sq, new_lin))


_reg_opt("ftrl", _FTRL, _ftrl)

_PARAM = (("ParamOut", "Param"),)


def _dpsgd(ctx: LowerContext, op: Operator):
    """Differentially private SGD: the gradient clipped to norm ``clip``,
    plus normal noise of std sigma * clip from the op's own generator
    (``LowerContext.rng``), over ``batch_size``."""
    p = ctx.get_input(op, "Param")
    g = _dense_grad(ctx, op)
    lr = ctx.get_input(op, "LearningRate")
    clip = op.attr("clip", 10.0)
    scale = torch.clamp(clip / (torch.linalg.vector_norm(g) + 1e-12),
                        max=1.0)
    noise = torch.randn(g.shape, generator=ctx.rng(op), device=g.device,
                        dtype=g.dtype) * (op.attr("sigma", 1.0) * clip)
    g_priv = (g * scale + noise) / op.attr("batch_size", 16.0)
    ctx.set_state(op, "ParamOut", "Param",
                  (p.float() - lr * g_priv).to(p.dtype))


_reg_opt("dpsgd", _PARAM, _dpsgd)


def _shrink(prox, lr, l1, l2):
    """The proximal step: soft-threshold by lr * l1, then scale by
    1 / (1 + lr * l2)."""
    return torch.sign(prox) * torch.clamp(prox.abs() - lr * l1, min=0.0) \
        / (1.0 + lr * l2)


def _proximal_gd(ctx: LowerContext, op: Operator):
    p = ctx.get_input(op, "Param")
    g = _dense_grad(ctx, op)
    lr = ctx.get_input(op, "LearningRate")
    p_new = _shrink(p.float() - lr * g, lr, op.attr("l1", 0.0),
                    op.attr("l2", 0.0))
    ctx.set_state(op, "ParamOut", "Param", p_new.to(p.dtype))


_reg_opt("proximal_gd", _PARAM, _proximal_gd)

_MOMENT = (("ParamOut", "Param"), ("MomentOut", "Moment"))


def _decayed_adagrad(ctx: LowerContext, op: Operator):
    """m' = decay m + (1 - decay) g^2; p' = p - lr g / (sqrt(m') + eps)."""
    p = ctx.get_input(op, "Param")
    g = _dense_grad(ctx, op)
    lr = ctx.get_input(op, "LearningRate")
    decay = op.attr("decay", 0.95)
    mn = decay * ctx.get_input(op, "Moment") + (1 - decay) * g * g
    p_new = p.float() - lr * g / (torch.sqrt(mn) + op.attr("epsilon", 1e-6))
    _set_states(ctx, op, _MOMENT, (p_new.to(p.dtype), mn))


_reg_opt("decayed_adagrad", _MOMENT, _decayed_adagrad)


def _proximal_adagrad(ctx: LowerContext, op: Operator):
    """Adagrad's moment, then the proximal step at lr / sqrt(m')."""
    p = ctx.get_input(op, "Param")
    g = _dense_grad(ctx, op)
    m_new = ctx.get_input(op, "Moment") + g * g
    lr_eff = ctx.get_input(op, "LearningRate") / torch.sqrt(m_new)
    p_new = _shrink(p.float() - lr_eff * g, lr_eff, op.attr("l1", 0.0),
                    op.attr("l2", 0.0))
    _set_states(ctx, op, _MOMENT, (p_new.to(p.dtype), m_new))


_reg_opt("proximal_adagrad", _MOMENT, _proximal_adagrad)

# the reference kernel's kMaxNumAccumulates: sum_1 spills into sum_2 at
# every multiple of it, bounding sum_1's float error
MAX_NUM_ACCUMULATES = 16384

_AVERAGE = (("OutSum1", "InSum1"), ("OutSum2", "InSum2"),
            ("OutSum3", "InSum3"),
            ("OutNumAccumulates", "InNumAccumulates"),
            ("OutOldNumAccumulates", "InOldNumAccumulates"),
            ("OutNumUpdates", "InNumUpdates"))


def _average_accumulates(ctx: LowerContext, op: Operator):
    """ModelAverage's sliding window (the reference's
    average_accumulates_op.h): updates and accumulates count up and sum_1
    adds the parameter; at every MAX_NUM_ACCUMULATES updates sum_1 spills
    into sum_2; once the accumulates reach the window (updates times
    ``average_window``, within [min_average_window,
    max_average_window]) sum_3 takes sum_1 + sum_2, both restart and the
    count moves to old_num_accumulates.  The branches are selects on the
    device."""
    p = ctx.get_input(op, "Param").float()
    s1 = ctx.get_input(op, "InSum1") + p
    s2 = ctx.get_input(op, "InSum2")
    s3 = ctx.get_input(op, "InSum3")
    n_acc = ctx.get_input(op, "InNumAccumulates") + 1
    old_n = ctx.get_input(op, "InOldNumAccumulates")
    n_upd = ctx.get_input(op, "InNumUpdates") + 1
    zeros = torch.zeros_like(s1)

    spill = torch.remainder(n_upd, MAX_NUM_ACCUMULATES) == 0
    s2 = torch.where(spill, s2 + s1, s2)
    s1 = torch.where(spill, zeros, s1)

    # max(min(updates * rate, max_window), min_window), in float32; the
    # bounds are Python numbers, so a captured step copies nothing
    window = torch.clamp(torch.clamp(
        n_upd.float() * op.attr("average_window", 0.0),
        max=float(op.attr("max_average_window", 2 ** 31 - 1))),
        min=float(op.attr("min_average_window", 10000)))
    rotate = n_acc.float() >= window
    s3 = torch.where(rotate, s1 + s2, s3)
    s1 = torch.where(rotate, zeros, s1)
    s2 = torch.where(rotate, zeros, s2)
    old_n = torch.where(rotate, n_acc, old_n)
    n_acc = torch.where(rotate, torch.zeros_like(n_acc), n_acc)
    _set_states(ctx, op, _AVERAGE, (s1, s2, s3, n_acc, old_n, n_upd))


_reg_opt("average_accumulates", _AVERAGE, _average_accumulates)
