"""Masked sequence ops, the TensorArray pair and the single-layer
``lstm_rnn`` / ``gru_rnn`` recurrences in PyTorch.

Counterpart of ``paddle_tpu/ops/sequence_ops.py`` (all 17 ops), with its
representation: a sequence batch is a dense [B, T, ...] tensor and an
integer lengths vector [B] on the device, and every op masks by the
lengths.  Nothing reads a length on the host, so every op can be captured
in a CUDA graph.

* ``write_to_array`` / ``read_from_array`` index a fixed-capacity buffer
  [cap, *item] by a device index as ``lax.dynamic_update_index_in_dim`` /
  ``dynamic_index_in_dim`` do: a negative index counts from the end once,
  then the index is clamped into [0, cap - 1] (``index_copy`` and plain
  indexing would raise or wrap instead).
* ``lstm_rnn`` and ``gru_rnn`` run a Python loop over T of whole-batch
  steps, the per-step math of the reference's ``lax.scan``; past a row's
  length the carry freezes and Out repeats the last live state.  Their
  products, like ``sequence_conv``'s, go through
  ``math_ops.forward_product``: where no grad op differentiates the op
  (serving) a row's bits do not depend on its batchmates (the product
  kernel on the card, the chunked sum on the CPU).  A recurrence's step
  products (here and in ``rnn_fused_ops``) are ``step_product``'s, which
  counts its launches of the product kernel in its own ``.launches``.
* ``sequence_pool``'s sums over time, where no grad op differentiates
  the op and X is float32, are ``math_ops.ordered_sum``'s, for the same
  reason.
"""
from __future__ import annotations

import torch

from ..framework.core import dtype_to_torch
from .cuda import gemm
from .math_ops import forward_product, ordered_sum
from .registry import in_var, register_op, same_as_input, set_out


def step_product(a, b, differentiated):
    """One step's product of a recurrence, ``forward_product``'s; the
    product kernel's launches it made are counted in ``.launches`` too,
    the recurrences' share of ``gemm.matmul``'s."""
    before = gemm.matmul.launches
    out = forward_product(a, b, differentiated)
    step_product.launches += gemm.matmul.launches - before
    return out


step_product.launches = 0


def counters():
    """(owner, attribute) of the count kept here: the recurrences'
    launches of the product kernel."""
    return ((step_product, "launches"),)


def _steps(n, like):
    """arange(n) on `like`'s device (int64)."""
    return torch.arange(n, device=like.device)


def _valid(lengths, n):
    """[B, n] bool: position < the row's length."""
    return _steps(n, lengths)[None, :] < lengths[:, None]


def _bcast(mask, ndim):
    """`mask` [B, T] with unit dims appended up to rank `ndim`."""
    return mask.reshape(tuple(mask.shape) + (1,) * (ndim - mask.dim()))


def _gather_time(x, src):
    """x [B, T, ...] gathered along time by src [B, T'] (int64)."""
    idx = _bcast(src, x.dim()).expand(
        (src.shape[0], src.shape[1]) + tuple(x.shape[2:]))
    return torch.gather(x, 1, idx)


def _time_sum(ctx, x):
    """x [B, T, ...] summed over time: in one fixed order where no grad
    op differentiates the op and x is float32."""
    if x.dtype == torch.float32 and not ctx.differentiates():
        return ordered_sum(x, 1)
    return x.sum(1)


# ---------------------------------------------------------------------------
# sequence mask / pool / softmax / reverse / expand_as
# ---------------------------------------------------------------------------

def _seq_mask_infer(op, block):
    x = in_var(op, block, "X")
    maxlen = op.attrs.get("maxlen", -1)
    b = x.shape[0] if x.shape else -1
    set_out(op, block, "Y", (b, maxlen if maxlen > 0 else -1),
            op.attrs.get("out_dtype", "float32"))


@register_op("sequence_mask", infer=_seq_mask_infer, grad=None)
def _sequence_mask(ctx, op):
    lengths = ctx.get_input(op, "X")
    maxlen = op.attr("maxlen", -1)
    if maxlen <= 0:
        raise ValueError("sequence_mask needs a static maxlen")
    mask = _valid(lengths, maxlen)
    ctx.set_output(op, "Y", mask.to(dtype_to_torch(
        op.attr("out_dtype", "float32"))))


def _pool_infer(op, block):
    x = in_var(op, block, "X")
    set_out(op, block, "Out", (x.shape[0],) + tuple(x.shape[2:]), x.dtype)


@register_op("sequence_pool", infer=_pool_infer)
def _sequence_pool(ctx, op):
    x = ctx.get_input(op, "X")
    lengths = ctx.get_input(op, "Lengths")
    m = _bcast(_valid(lengths, x.shape[1]), x.dim()).to(x.dtype)
    pool = op.attr("pool_type", "average").lower()
    per_row = (-1,) + (1,) * (x.dim() - 2)
    if pool in ("average", "avg", "mean"):
        denom = lengths.to(x.dtype).clamp_min(1).reshape(per_row)
        out = _time_sum(ctx, x * m) / denom
    elif pool == "sum":
        out = _time_sum(ctx, x * m)
    elif pool == "sqrt":
        denom = torch.sqrt(lengths.to(x.dtype).clamp_min(1)).reshape(per_row)
        out = _time_sum(ctx, x * m) / denom
    elif pool == "max":
        neg = (torch.finfo(x.dtype).min if x.dtype.is_floating_point
               else torch.iinfo(x.dtype).min)
        out = torch.where(m > 0, x, torch.full((), neg, dtype=x.dtype,
                                               device=x.device)).amax(1)
    elif pool == "last":
        idx = (lengths - 1).clamp_min(0).reshape(-1, 1)
        out = _gather_time(x, idx).squeeze(1)
    elif pool == "first":
        out = x[:, 0]
    else:
        raise ValueError(f"unknown pool_type {pool!r}")
    ctx.set_output(op, "Out", out)


@register_op("sequence_softmax", infer=same_as_input())
def _sequence_softmax(ctx, op):
    x = ctx.get_input(op, "X")          # [B, T]
    mask = _valid(ctx.get_input(op, "Lengths"), x.shape[1])
    z = torch.where(mask, x, torch.full((), -1e30, dtype=x.dtype,
                                        device=x.device))
    z = z - z.amax(1, keepdim=True)
    e = torch.exp(z) * mask.to(x.dtype)
    ctx.set_output(op, "Out", e / e.sum(1, keepdim=True).clamp_min(1e-30))


@register_op("sequence_reverse", infer=same_as_input())
def _sequence_reverse(ctx, op):
    """Position i of a row takes position len - 1 - i; padding stays."""
    x = ctx.get_input(op, "X")          # [B, T, ...]
    lengths = ctx.get_input(op, "Lengths")
    pos = _steps(x.shape[1], x)[None, :]
    src = torch.where(pos < lengths[:, None], lengths[:, None] - 1 - pos,
                      pos)
    ctx.set_output(op, "Out", _gather_time(x, src))


def _seq_expand_as_infer(op, block):
    x = in_var(op, block, "X")          # [B, ...]
    times = op.attrs.get("maxlen", -1)
    set_out(op, block, "Out", (x.shape[0], times) + tuple(x.shape[1:]),
            x.dtype)


@register_op("sequence_expand_as", infer=_seq_expand_as_infer)
def _sequence_expand_as(ctx, op):
    """A per-sequence vector broadcast across its (masked) time steps."""
    x = ctx.get_input(op, "X")
    maxlen = op.attr("maxlen")
    m = _bcast(_valid(ctx.get_input(op, "Lengths"), maxlen),
               x.dim() + 1).to(x.dtype)
    out = x[:, None].expand((x.shape[0], maxlen) + tuple(x.shape[1:]))
    ctx.set_output(op, "Out", out * m)


# ---------------------------------------------------------------------------
# TensorArray
# ---------------------------------------------------------------------------

def _array_index(i, cap):
    """The device index `i` as lax's dynamic indexing takes it: negative
    counts from the end once, then clamped into [0, cap - 1]; [1] int64."""
    i = i.reshape(1).to(torch.int64)
    return torch.where(i < 0, i + cap, i).clamp(0, cap - 1)


def _wta_infer(op, block):
    arr = in_var(op, block, "Array")
    set_out(op, block, "Out", arr.shape, arr.dtype)


@register_op("write_to_array", infer=_wta_infer)
def _write_to_array(ctx, op):
    arr = ctx.get_input(op, "Array")    # [cap, *item]
    x = ctx.get_input(op, "X")
    i = _array_index(ctx.get_input(op, "I"), arr.shape[0])
    ctx.set_output(op, "Out", arr.index_copy(
        0, i, x.to(arr.dtype).reshape((1,) + tuple(arr.shape[1:]))))


def _rfa_infer(op, block):
    arr = in_var(op, block, "Array")
    set_out(op, block, "Out", tuple(arr.shape[1:]), arr.dtype)


@register_op("read_from_array", infer=_rfa_infer)
def _read_from_array(ctx, op):
    arr = ctx.get_input(op, "Array")
    i = _array_index(ctx.get_input(op, "I"), arr.shape[0])
    ctx.set_output(op, "Out", arr.index_select(0, i)[0])


# ---------------------------------------------------------------------------
# recurrent cells over time: lstm_rnn / gru_rnn
# ---------------------------------------------------------------------------

def _rnn_infer(op, block):
    x = in_var(op, block, "X")          # [B, T, D]
    hid = op.attrs["hidden_size"]
    set_out(op, block, "Out", (x.shape[0], x.shape[1], hid), x.dtype)
    set_out(op, block, "LastH", (x.shape[0], hid), x.dtype)
    if op.output("LastC"):
        set_out(op, block, "LastC", (x.shape[0], hid), x.dtype)


def _freeze(alive, new, old):
    """`new` where the row is alive, else `old` (the reference's
    arithmetic select)."""
    return alive * new + (1 - alive) * old


@register_op("lstm_rnn", infer=_rnn_infer)
def _lstm_rnn(ctx, op):
    """Single-layer LSTM over [B, T, D], gates [i, f, g, o] of one fused
    [D + H, 4H] product a step; past a row's length the state freezes and
    Out repeats it."""
    x = ctx.get_input(op, "X")
    w = ctx.get_input(op, "W")          # [D+H, 4H]
    b = ctx.get_input(op, "B")          # [4H]
    lengths = ctx.get_input(op, "Lengths")
    H = op.attr("hidden_size")
    diff = ctx.differentiates()
    h = torch.zeros((x.shape[0], H), dtype=x.dtype, device=x.device)
    c = torch.zeros_like(h)
    hs = []
    for t in range(x.shape[1]):
        z = step_product(torch.cat([x[:, t], h], -1), w, diff) + b
        i, f, g, o = torch.split(z, H, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        c_new = f * c + i * torch.tanh(g)
        h_new = o * torch.tanh(c_new)
        alive = (t < lengths)[:, None].to(x.dtype)
        h = _freeze(alive, h_new, h)
        c = _freeze(alive, c_new, c)
        hs.append(h)
    ctx.set_output(op, "Out", torch.stack(hs, 1))
    ctx.set_output(op, "LastH", h)
    ctx.set_output(op, "LastC", c)


@register_op("gru_rnn", infer=_rnn_infer)
def _gru_rnn(ctx, op):
    """Single-layer GRU over [B, T, D]: (r, z) = sigmoid([x, h] W[:, :2H]),
    h~ = tanh([x, r h] W[:, 2H:]), h' = (1 - z) h + z h~; past a row's
    length the state freezes and Out repeats it."""
    x = ctx.get_input(op, "X")
    w = ctx.get_input(op, "W")          # [D+H, 3H]
    b = ctx.get_input(op, "B")          # [3H]
    lengths = ctx.get_input(op, "Lengths")
    H = op.attr("hidden_size")
    diff = ctx.differentiates()
    w_rz, w_h = w[:, :2 * H], w[:, 2 * H:]
    b_rz, b_h = b[:2 * H], b[2 * H:]
    h = torch.zeros((x.shape[0], H), dtype=x.dtype, device=x.device)
    hs = []
    for t in range(x.shape[1]):
        xt = x[:, t]
        rz = torch.sigmoid(
            step_product(torch.cat([xt, h], -1), w_rz, diff) + b_rz)
        r, z = rz[:, :H], rz[:, H:]
        hbar = torch.tanh(
            step_product(torch.cat([xt, r * h], -1), w_h, diff) + b_h)
        h_new = (1 - z) * h + z * hbar
        h = _freeze((t < lengths)[:, None].to(x.dtype), h_new, h)
        hs.append(h)
    ctx.set_output(op, "Out", torch.stack(hs, 1))
    ctx.set_output(op, "LastH", h)


# ---------------------------------------------------------------------------
# the long tail (reference operators/sequence_ops/*), padded [B, T, ...] +
# Lengths throughout
# ---------------------------------------------------------------------------

def _seq_conv_infer(op, block):
    x = in_var(op, block, "X")                 # [B, T, D]
    w = in_var(op, block, "Filter")            # [ctx_len*D, M]
    set_out(op, block, "Out", (x.shape[0], x.shape[1], w.shape[1]),
            x.dtype)


@register_op("sequence_conv", infer=_seq_conv_infer)
def _sequence_conv(ctx, op):
    """Context-window convolution over time: step t's feature is the
    flattened [context_length, D] window from t + context_start, zero
    outside [0, the row's length), times Filter; steps past the length
    are zero."""
    x = ctx.get_input(op, "X")
    w = ctx.get_input(op, "Filter")
    lengths = ctx.get_input(op, "Lengths")
    start = op.attr("context_start", 0)
    B, T, D = x.shape
    t_idx = _steps(T, x)
    cols = []
    for j in range(op.attr("context_length")):
        pos = t_idx + start + j
        valid = (pos >= 0)[None, :] & (pos[None, :] < lengths[:, None])
        g = x[:, pos.clamp(0, T - 1)]          # [B, T, D]
        cols.append(torch.where(valid[..., None], g, torch.zeros(
            (), dtype=x.dtype, device=x.device)))
    win = torch.cat(cols, 2)                   # [B, T, clen*D]
    out = forward_product(win.reshape(B * T, -1), w,
                          ctx.differentiates()).reshape(B, T, -1)
    mask = _valid(lengths, T)[..., None]
    ctx.set_output(op, "Out", out * mask.to(out.dtype))


def _seq_expand_infer(op, block):
    x = in_var(op, block, "X")
    y = in_var(op, block, "Y")
    set_out(op, block, "Out", (x.shape[0], y.shape[1]) + tuple(
        x.shape[2:]), x.dtype)


@register_op("sequence_expand", infer=_seq_expand_infer)
def _sequence_expand(ctx, op):
    """Each row's first step broadcast across Y's valid steps (the
    reference's ref_level 0, padded)."""
    x = ctx.get_input(op, "X")                 # [B, Tx, ...]
    maxlen = ctx.get_input(op, "Y").shape[1]
    first = x[:, 0]
    out = first[:, None].expand((x.shape[0], maxlen) + tuple(first.shape[1:]))
    m = _bcast(_valid(ctx.get_input(op, "YLengths"), maxlen), out.dim())
    ctx.set_output(op, "Out", out * m.to(x.dtype))


def _seq_pad_infer(op, block):
    x = in_var(op, block, "X")
    set_out(op, block, "Out", x.shape, x.dtype)
    set_out(op, block, "Length", (x.shape[0],), "int64")


@register_op("sequence_pad", infer=_seq_pad_infer)
def _sequence_pad(ctx, op):
    """The tail past each length set to PadValue; Length the lengths."""
    x = ctx.get_input(op, "X")
    lengths = ctx.get_input(op, "Lengths")
    pad = ctx.get_input(op, "PadValue").reshape(()).to(x.dtype)
    m = _bcast(_valid(lengths, x.shape[1]), x.dim())
    ctx.set_output(op, "Out", torch.where(m, x, pad))
    ctx.set_output(op, "Length", lengths.to(torch.int64))


@register_op("sequence_unpad", infer=same_as_input())
def _sequence_unpad(ctx, op):
    """The tail past each length zeroed (shapes stay fixed)."""
    x = ctx.get_input(op, "X")
    m = _bcast(_valid(ctx.get_input(op, "Lengths"), x.shape[1]), x.dim())
    ctx.set_output(op, "Out", x * m.to(x.dtype))


def _seq_concat_infer(op, block):
    xs = [block.var(n) for n in op.input("X")]
    T = sum(x.shape[1] for x in xs)
    set_out(op, block, "Out", (xs[0].shape[0], T) + tuple(
        xs[0].shape[2:]), xs[0].dtype)


@register_op("sequence_concat", infer=_seq_concat_infer)
def _sequence_concat(ctx, op):
    """Per row, the valid prefixes of the inputs one after another,
    left-compacted by a stable sort of the valid slots before the
    padding; zero past the summed lengths."""
    xs = ctx.get_inputs(op, "X")
    lens = ctx.get_inputs(op, "Lengths")
    cat = torch.cat(xs, 1)
    valid = torch.cat([_valid(n, x.shape[1]) for x, n in zip(xs, lens)], 1)
    order = torch.argsort(torch.where(valid, 0, 1), dim=1, stable=True)
    out = _gather_time(cat, order)
    total = lens[0]
    for n in lens[1:]:
        total = total + n
    m = _bcast(_valid(total, cat.shape[1]), cat.dim())
    ctx.set_output(op, "Out", out * m.to(out.dtype))


@register_op("sequence_slice", infer=same_as_input())
def _sequence_slice(ctx, op):
    """Per row [offset, offset + length), left-aligned, zero after."""
    x = ctx.get_input(op, "X")
    offset = ctx.get_input(op, "Offset").reshape(-1)
    length = ctx.get_input(op, "Length").reshape(-1)
    T = x.shape[1]
    t_idx = _steps(T, x)[None, :]
    src = (offset[:, None] + t_idx).clamp(0, T - 1).to(torch.int64)
    m = _bcast(t_idx < length[:, None], x.dim())
    ctx.set_output(op, "Out", _gather_time(x, src) * m.to(x.dtype))


def _seq_erase_infer(op, block):
    x = in_var(op, block, "X")
    set_out(op, block, "Out", x.shape, x.dtype)
    if op.output("OutLengths"):
        set_out(op, block, "OutLengths", (x.shape[0],), "int64")


@register_op("sequence_erase", infer=_seq_erase_infer, grad=None)
def _sequence_erase(ctx, op):
    """The listed tokens dropped, the rest compacted left, zero after;
    OutLengths the new lengths."""
    x = ctx.get_input(op, "X")                 # [B, T] int
    lengths = ctx.get_input(op, "Lengths")
    t_idx = _steps(x.shape[1], x)[None, :]
    keep = t_idx < lengths[:, None]
    for t in op.attr("tokens", []):
        keep = keep & (x != t)
    order = torch.argsort(torch.where(keep, 0, 1), dim=1, stable=True)
    out = torch.gather(x, 1, order)
    new_len = keep.sum(1)
    ctx.set_output(op, "Out", torch.where(t_idx < new_len[:, None], out,
                                          torch.zeros_like(out)))
    if op.output("OutLengths"):
        ctx.set_output(op, "OutLengths", new_len.to(torch.int64))


def _seq_enum_infer(op, block):
    x = in_var(op, block, "X")
    set_out(op, block, "Out",
            (x.shape[0], x.shape[1], op.attr("win_size")), x.dtype)


@register_op("sequence_enumerate", infer=_seq_enum_infer, grad=None)
def _sequence_enumerate(ctx, op):
    """Sliding windows of win_size ids a step, pad_value past each row's
    end."""
    x = ctx.get_input(op, "X")                 # [B, T] int
    lengths = ctx.get_input(op, "Lengths")
    T = x.shape[1]
    pos = _steps(T, x)[:, None] + _steps(op.attr("win_size"), x)[None, :]
    g = x[:, pos.clamp(0, T - 1)]              # [B, T, win]
    valid = pos[None] < lengths[:, None, None]
    ctx.set_output(op, "Out", torch.where(valid, g, torch.full(
        (), op.attr("pad_value", 0), dtype=x.dtype, device=x.device)))
