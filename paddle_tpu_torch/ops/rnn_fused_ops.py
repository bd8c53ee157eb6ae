"""The fused single-op recurrences ``lstm``, ``lstmp``, ``gru``, ``rnn``
and ``cudnn_lstm`` in PyTorch.

Counterpart of ``paddle_tpu/ops/rnn_fused_ops.py``: each op is a Python
loop over T of whole-batch steps with the per-step math of the
reference's ``lax.scan``, on the padded [B, T, ...] + Lengths
representation.  Each keeps its own conventions, which are not one
another's:

* ``lstm`` / ``lstmp`` / ``rnn``'s LSTM take gates [candidate, input,
  forget, output]; peepholes (``use_peepholes``, Bias [7H]) add wi c_prev
  and wf c_prev to the input and forget gates, wo c_new to the output
  gate.  ``lstmp``'s recurrent state is r = act(h ProjWeight).
* ``gru`` takes the projected input [B, T, 3H] and Weight [H, 3H] packing
  (update, reset | candidate); ``origin_mode`` gives h' = u h + (1 - u) c,
  else (1 - u) h + u c, which ``rnn``'s GRU mode always takes.
* Every op here freezes the carry past a row's length and outputs zeros
  there (``alive * new``); ``sequence_ops``' ``lstm_rnn`` / ``gru_rnn``
  repeat the frozen state instead.

The recurrent products go through ``sequence_ops.step_product`` (the
product kernel on the card where no grad op differentiates the op,
counted), the layers' input projections through
``math_ops.forward_product``.
``rnn``'s dropout between layers draws each layer's mask from its own
generator (``LowerContext.rng(op, fold=layer)``); the reference draws one
key for every layer, so its layers share one mask.
"""
from __future__ import annotations

import torch

from .math_ops import forward_product
from .registry import in_var, register_op, set_out
from .sequence_ops import step_product


def _alive(t, lengths, like):
    return (t < lengths)[:, None].to(like.dtype)


def _order(T, reverse):
    return range(T - 1, -1, -1) if reverse else range(T)


def _lstm_scan(xs, lengths, w, h0, c0, diff, peep=None, reverse=False):
    """xs [B, T, 4H] projected gates (bias in), w [H, 4H]; returns (hidden
    [B, T, H], cell [B, T, H], last h, last c)."""
    H = w.shape[0]
    h, c = h0, c0
    hs, cs = [None] * xs.shape[1], [None] * xs.shape[1]
    for t in _order(xs.shape[1], reverse):
        z = xs[:, t] + step_product(h, w, diff)
        g, i, f, o = (z[:, :H], z[:, H:2 * H], z[:, 2 * H:3 * H],
                      z[:, 3 * H:])
        if peep is not None:
            i = i + peep[0] * c
            f = f + peep[1] * c
        i, f = torch.sigmoid(i), torch.sigmoid(f)
        c_new = f * c + i * torch.tanh(g)
        if peep is not None:
            o = o + peep[2] * c_new
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        alive = _alive(t, lengths, h_new)
        h = alive * h_new + (1 - alive) * h
        c = alive * c_new + (1 - alive) * c
        hs[t], cs[t] = alive * h_new, alive * c_new
    return torch.stack(hs, 1), torch.stack(cs, 1), h, c


def _gru_scan(xs, lengths, w, h0, diff, origin=False, reverse=False):
    """xs [B, T, 3H] projected (bias in), w [H, 3H] = (update, reset |
    candidate); returns (hidden [B, T, H], last h)."""
    H = w.shape[0]
    w_ur, w_c = w[:, :2 * H], w[:, 2 * H:]
    h = h0
    hs = [None] * xs.shape[1]
    for t in _order(xs.shape[1], reverse):
        xt = xs[:, t]
        g = xt[:, :2 * H] + step_product(h, w_ur, diff)
        u, r = torch.sigmoid(g[:, :H]), torch.sigmoid(g[:, H:])
        c = torch.tanh(xt[:, 2 * H:] + step_product(r * h, w_c, diff))
        h_new = u * h + (1 - u) * c if origin else (1 - u) * h + u * c
        alive = _alive(t, lengths, h_new)
        h = alive * h_new + (1 - alive) * h
        hs[t] = alive * h_new
    return torch.stack(hs, 1), h


def _rnn_scan(xs, lengths, w, h0, diff, act, reverse=False):
    """xs [B, T, H] projected (bias in), w [H, H]: h' = act(x + h w)."""
    h = h0
    hs = [None] * xs.shape[1]
    for t in _order(xs.shape[1], reverse):
        h_new = act(xs[:, t] + step_product(h, w, diff))
        alive = _alive(t, lengths, h_new)
        h = alive * h_new + (1 - alive) * h
        hs[t] = alive * h_new
    return torch.stack(hs, 1), h


def _peepholes(bias, H, use):
    """(gate bias [4H], (wi, wf, wo) or None) from Bias [4H] / [7H]."""
    if not use:
        return bias, None
    pw = bias[..., 4 * H:].reshape(-1)
    return bias[..., :4 * H], (pw[:H], pw[H:2 * H], pw[2 * H:])


def _initial(ctx, op, slot, B, H, like):
    if op.input(slot):
        return ctx.get_input(op, slot)
    return torch.zeros((B, H), dtype=like.dtype, device=like.device)


def _lstm_infer(op, block):
    x = in_var(op, block, "Input")
    H = in_var(op, block, "Weight").shape[0]
    set_out(op, block, "Hidden", (x.shape[0], x.shape[1], H), x.dtype)
    set_out(op, block, "Cell", (x.shape[0], x.shape[1], H), x.dtype)


@register_op("lstm", infer=_lstm_infer)
def _lstm(ctx, op):
    """LSTM over the projected Input [B, T, 4H] (reference lstm_op.cc),
    optional H0 / C0, peepholes and ``is_reverse``."""
    x = ctx.get_input(op, "Input")
    w = ctx.get_input(op, "Weight")         # [H, 4H]
    H = w.shape[0]
    b, peep = _peepholes(ctx.get_input(op, "Bias"), H,
                         op.attr("use_peepholes", False))
    B = x.shape[0]
    hs, cs, _, _ = _lstm_scan(
        x + b.reshape(1, 1, -1), ctx.get_input(op, "Lengths"), w,
        _initial(ctx, op, "H0", B, H, x), _initial(ctx, op, "C0", B, H, x),
        ctx.differentiates(), peep=peep,
        reverse=bool(op.attr("is_reverse", False)))
    ctx.set_output(op, "Hidden", hs)
    ctx.set_output(op, "Cell", cs)


def _lstmp_infer(op, block):
    x = in_var(op, block, "Input")
    H, P = in_var(op, block, "ProjWeight").shape
    set_out(op, block, "Projection", (x.shape[0], x.shape[1], P),
            x.dtype)
    set_out(op, block, "Cell", (x.shape[0], x.shape[1], H), x.dtype)


@register_op("lstmp", infer=_lstmp_infer)
def _lstmp(ctx, op):
    """LSTM with a recurrent projection (reference lstmp_op.cc): the
    recurrent state is r = act(h ProjWeight) [B, P], Weight [P, 4H],
    ``proj_activation`` tanh or identity."""
    x = ctx.get_input(op, "Input")
    w = ctx.get_input(op, "Weight")          # [P, 4H]
    wp = ctx.get_input(op, "ProjWeight")     # [H, P]
    lengths = ctx.get_input(op, "Lengths")
    H, P = wp.shape
    b, peep = _peepholes(ctx.get_input(op, "Bias"), H,
                         op.attr("use_peepholes", False))
    act = op.attr("proj_activation", "tanh")
    if act not in ("tanh", "identity"):
        raise NotImplementedError(
            f"lstmp proj_activation {act!r}: the port takes 'tanh' and "
            f"'identity', as the reference computes them (ROADMAP.md "
            f"queue 1, item 7)")
    diff = ctx.differentiates()
    xs = x + b.reshape(1, 1, -1)
    B, T = x.shape[:2]
    r = torch.zeros((B, P), dtype=x.dtype, device=x.device)
    c = torch.zeros((B, H), dtype=x.dtype, device=x.device)
    rs, cs = [None] * T, [None] * T
    for t in _order(T, bool(op.attr("is_reverse", False))):
        z = xs[:, t] + step_product(r, w, diff)
        g, i, f, o = (z[:, :H], z[:, H:2 * H], z[:, 2 * H:3 * H],
                      z[:, 3 * H:])
        if peep is not None:
            i = i + peep[0] * c
            f = f + peep[1] * c
        i, f = torch.sigmoid(i), torch.sigmoid(f)
        c_new = f * c + i * torch.tanh(g)
        if peep is not None:
            o = o + peep[2] * c_new
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        r_new = step_product(h_new, wp, diff)
        if act == "tanh":
            r_new = torch.tanh(r_new)
        alive = _alive(t, lengths, r_new)
        r = alive * r_new + (1 - alive) * r
        c = alive * c_new + (1 - alive) * c
        rs[t], cs[t] = alive * r_new, alive * c_new
    ctx.set_output(op, "Projection", torch.stack(rs, 1))
    ctx.set_output(op, "Cell", torch.stack(cs, 1))


def _gru_infer(op, block):
    x = in_var(op, block, "Input")
    H = in_var(op, block, "Weight").shape[0]
    set_out(op, block, "Hidden", (x.shape[0], x.shape[1], H), x.dtype)


@register_op("gru", infer=_gru_infer)
def _gru(ctx, op):
    """Fused GRU (reference gru_op.cc) over the projected Input [B, T, 3H],
    optional Bias and H0, ``origin_mode``, ``is_reverse``."""
    x = ctx.get_input(op, "Input")
    w = ctx.get_input(op, "Weight")
    H = w.shape[0]
    if op.input("Bias"):
        x = x + ctx.get_input(op, "Bias").reshape(1, 1, -1)
    hs, _ = _gru_scan(x, ctx.get_input(op, "Lengths"), w,
                      _initial(ctx, op, "H0", x.shape[0], H, x),
                      ctx.differentiates(),
                      origin=bool(op.attr("origin_mode", False)),
                      reverse=bool(op.attr("is_reverse", False)))
    ctx.set_output(op, "Hidden", hs)


# ---------------------------------------------------------------------------
# the multi-layer rnn (reference 2.0 rnn op / cudnn_lstm_op.cc)
# ---------------------------------------------------------------------------

RNN_MODES = ("LSTM", "GRU", "RNN_TANH", "RNN_RELU")


def _rnn_op_infer(op, block):
    x = in_var(op, block, "Input")
    H = int(op.attr("hidden_size"))
    nd = 2 if op.attr("is_bidirec", False) else 1
    L = int(op.attr("num_layers", 1))
    set_out(op, block, "Out", (x.shape[0], x.shape[1], H * nd), x.dtype)
    set_out(op, block, "LastH", (L * nd, x.shape[0], H), x.dtype)
    if op.output("LastC"):
        set_out(op, block, "LastC", (L * nd, x.shape[0], H), x.dtype)


def _rnn_op_lower(ctx, op):
    """Multi-layer, optionally bidirectional LSTM / GRU / RNN_TANH /
    RNN_RELU.  WeightList holds (w_ih [Din, kH], w_hh [H, kH], b_ih [kH],
    b_hh [kH]) a layer and direction, the forward direction first.
    Between layers (not after the last) ``dropout_prob`` zeroes an
    element with that probability and scales the rest by 1 / (1 - p);
    each layer draws its own mask."""
    x = ctx.get_input(op, "Input")
    lengths = ctx.get_input(op, "Lengths")
    weights = ctx.get_inputs(op, "WeightList")
    mode = op.attr("mode", "LSTM")
    if mode not in RNN_MODES:
        raise ValueError(f"rnn mode {mode!r}: one of {RNN_MODES}")
    H = int(op.attr("hidden_size"))
    L = int(op.attr("num_layers", 1))
    ndir = 2 if op.attr("is_bidirec", False) else 1
    drop = float(op.attr("dropout_prob", 0.0))
    diff = ctx.differentiates()
    B, T = x.shape[:2]
    zeros = torch.zeros((B, H), dtype=x.dtype, device=x.device)
    lasth, lastc = [], []
    out = x
    wi = 0
    for layer in range(L):
        dirs = []
        for d in range(ndir):
            w_ih, w_hh, b_ih, b_hh = weights[wi:wi + 4]
            wi += 4
            proj = forward_product(out.reshape(B * T, -1), w_ih,
                                   diff).reshape(B, T, -1) + (b_ih + b_hh)
            rev = d == 1
            if mode == "LSTM":
                hs, _, h_l, c_l = _lstm_scan(proj, lengths, w_hh, zeros,
                                             zeros, diff, reverse=rev)
                lastc.append(c_l)
            elif mode == "GRU":
                hs, h_l = _gru_scan(proj, lengths, w_hh, zeros, diff,
                                    reverse=rev)
            else:
                act = torch.tanh if mode == "RNN_TANH" else torch.relu
                hs, h_l = _rnn_scan(proj, lengths, w_hh, zeros, diff, act,
                                    reverse=rev)
            lasth.append(h_l)
            dirs.append(hs)
        out = torch.cat(dirs, -1) if ndir > 1 else dirs[0]
        if drop and layer < L - 1:
            keep = torch.rand(tuple(out.shape),
                              generator=ctx.rng(op, fold=layer),
                              dtype=torch.float32,
                              device=out.device) < 1.0 - drop
            out = torch.where(keep, out / (1.0 - drop),
                              torch.zeros((), dtype=out.dtype,
                                          device=out.device))
    ctx.set_output(op, "Out", out)
    ctx.set_output(op, "LastH", torch.stack(lasth))
    if op.output("LastC") and lastc:
        ctx.set_output(op, "LastC", torch.stack(lastc))


register_op("rnn", infer=_rnn_op_infer, lower=_rnn_op_lower)
# cudnn_lstm is the pre-2.0 surface of the same op
register_op("cudnn_lstm", infer=_rnn_op_infer, lower=_rnn_op_lower)
