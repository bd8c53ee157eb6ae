"""Tensor creation / manipulation op lowerings in PyTorch.

Counterpart of ``paddle_tpu/ops/tensor_ops.py`` for the ops on the BERT
and Llama paths: ``fill_constant``, ``fill_any_like``, ``assign_value``,
``uniform_random``, ``gaussian_random``, ``truncated_gaussian_random``,
``range``, ``reshape2``/``transpose2``, ``squeeze2``/``unsqueeze2``,
``slice``, ``tile``, ``lookup_table_v2`` (with its sparse grad,
``lookup_table_sparse_grad``), ``where``, ``arg_max`` / ``arg_min``
(generation's greedy pick), for the masked-gather MLM head ``expand``,
``stack`` and ``gather_nd``, for Wide&Deep ``concat`` and ``flatten2``,
and for ``layers.accuracy`` ``top_k`` / ``top_k_v2``.
Reshape, transpose and slice return views where PyTorch can, as the JAX
package leaves layout to XLA.  Randomness comes from a per-op ``torch.Generator`` (LowerContext.rng); it
draws other numbers than jax.random from the same seed.
"""
from __future__ import annotations

import math
from collections import OrderedDict

import numpy as np
import torch

from ..framework.core import (Block, Operator, VarType, dtype_to_torch,
                              grad_var_name)
from ..framework.selected_rows import SelectedRowsValue
from .registry import (LowerContext, build_auto_grad_specs, in_var,
                       register_op, set_out)


# ---------------------------------------------------------------------------
# creation ops
# ---------------------------------------------------------------------------

def _fill_infer(op: Operator, block: Block):
    set_out(op, block, "Out", op.attr("shape", []),
            op.attr("dtype", "float32"))


@register_op("fill_constant", infer=_fill_infer, grad=None)
def _fill_constant(ctx: LowerContext, op: Operator):
    dtype = dtype_to_torch(op.attr("dtype", "float32"))
    value = op.attr("value", 0.0)
    if op.attr("str_value", ""):
        value = float(op.attr("str_value"))
    shape = tuple(op.attr("shape", []))
    if op.single_input("ValueTensor"):
        value = ctx.get_input(op, "ValueTensor")
        out = value.reshape(()).to(dtype).expand(shape).clone()
    else:
        out = torch.full(shape, value, dtype=dtype, device=ctx.device)
    ctx.set_output(op, "Out", out)


def _fill_like_infer(op, block):
    x = in_var(op, block, "X")
    dt = op.attr("dtype", -1)
    set_out(op, block, "Out", x.shape, x.dtype if dt in (-1, None, "") else dt)


@register_op("fill_any_like", infer=_fill_like_infer, grad=None)
def _fill_any_like(ctx: LowerContext, op: Operator):
    x = ctx.get_input(op, "X")
    dt = op.attr("dtype", -1)
    dtype = x.dtype if dt in (-1, None, "") else dtype_to_torch(dt)
    ctx.set_output(op, "Out", torch.full(tuple(x.shape), op.attr("value", 0.0),
                                         dtype=dtype, device=x.device))


# assign_value's constants on their devices, by (bytes, numpy dtype,
# shape, dtype, device), the least recently used dropped past
# CONSTANTS_CACHED: a captured step cannot copy from pageable host memory,
# so a constant is copied to the card once, in the eager run, and a
# device copy of it (which a capture can take) is each run's value
CONSTANTS_CACHED = 256
_CONSTANTS: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()


def _constant(arr: np.ndarray, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    key = (arr.tobytes(), arr.dtype.str, arr.shape, dtype, str(device))
    t = _CONSTANTS.get(key)
    if t is None:
        t = torch.as_tensor(arr, device=device).to(dtype)
        _CONSTANTS[key] = t
        while len(_CONSTANTS) > CONSTANTS_CACHED:
            _CONSTANTS.popitem(last=False)
    else:
        _CONSTANTS.move_to_end(key)
    return t.clone()


@register_op("assign_value", infer=_fill_infer, grad=None)
def _assign_value(ctx, op):
    """A constant from the op's attrs (the first of ``fp32_values``,
    ``int32_values``, ``int64_values``, ``bool_values``, ``values`` that
    is set), reshaped to ``shape``; zeros where none is.  The host copy
    is made once a device (``_constant``), so the op can be captured."""
    dtype = dtype_to_torch(op.attr("dtype", "float32"))
    shape = tuple(op.attr("shape", []))
    for key in ("fp32_values", "int32_values", "int64_values", "bool_values",
                "values"):
        vals = op.attr(key)
        if vals is not None and (not isinstance(vals, list) or vals):
            arr = np.asarray(vals).reshape(shape)
            ctx.set_output(op, "Out", _constant(arr, dtype, ctx.device))
            return
    ctx.set_output(op, "Out", torch.zeros(shape, dtype=dtype,
                                          device=ctx.device))


def _range_infer(op, block):
    # shape only known statically when start/end/step are attrs
    try:
        n = int(np.ceil((op.attr("end") - op.attr("start")) / op.attr("step")))
    except TypeError:
        n = -1
    set_out(op, block, "Out", [n], op.attr("dtype", "float32"))


@register_op("range", infer=_range_infer, grad=None)
def _range(ctx, op):
    dtype = dtype_to_torch(op.attr("dtype", "float32"))
    ctx.set_output(op, "Out", torch.arange(
        op.attr("start"), op.attr("end"), op.attr("step"), dtype=dtype,
        device=ctx.device))


@register_op("uniform_random", infer=_fill_infer, grad=None)
def _uniform_random(ctx, op):
    dtype = dtype_to_torch(op.attr("dtype", "float32"))
    shape = tuple(op.attr("shape", []))
    lo, hi = op.attr("min", -1.0), op.attr("max", 1.0)
    u = torch.rand(shape, generator=ctx.rng(op), dtype=torch.float32,
                   device=ctx.device)
    ctx.set_output(op, "Out", (u * (hi - lo) + lo).to(dtype))


@register_op("gaussian_random", infer=_fill_infer, grad=None)
def _gaussian_random(ctx, op):
    dtype = dtype_to_torch(op.attr("dtype", "float32"))
    shape = tuple(op.attr("shape", []))
    mean, std = op.attr("mean", 0.0), op.attr("std", 1.0)
    z = torch.randn(shape, generator=ctx.rng(op), dtype=torch.float32,
                    device=ctx.device)
    ctx.set_output(op, "Out", (z * std + mean).to(dtype))


# the standard normal's CDF at -2 and 2, as erf(x / sqrt 2) bounds
_TRUNC_LO, _TRUNC_HI = math.erf(-2.0 / math.sqrt(2.0)), \
    math.erf(2.0 / math.sqrt(2.0))


@register_op("truncated_gaussian_random", infer=_fill_infer, grad=None)
def _truncated_gaussian_random(ctx, op):
    """A normal draw truncated to two standard deviations, by the inverse
    CDF of a uniform draw over [-2, 2]'s share of it (jax.random's
    ``truncated_normal`` method), then scaled by std and shifted by
    mean."""
    dtype = dtype_to_torch(op.attr("dtype", "float32"))
    shape = tuple(op.attr("shape", []))
    mean, std = op.attr("mean", 0.0), op.attr("std", 1.0)
    u = torch.rand(shape, generator=ctx.rng(op), dtype=torch.float32,
                   device=ctx.device)
    z = math.sqrt(2.0) * torch.erfinv(u * (_TRUNC_HI - _TRUNC_LO) + _TRUNC_LO)
    z = torch.clamp(z, -2.0, 2.0)
    ctx.set_output(op, "Out", (z * std + mean).to(dtype))


# ---------------------------------------------------------------------------
# reshape / transpose / slice / tile
# ---------------------------------------------------------------------------

def _infer_reshape_shape(in_shape, target):
    """Paddle's reshape target: 0 copies the input dim, one -1 takes the
    rest."""
    target = list(target)
    if -1 in target:
        known = 1
        for s in target:
            if s not in (-1, 0):
                known *= s
        for i, s in enumerate(target):
            if s == 0:
                target[i] = in_shape[i]
                known *= in_shape[i]
        total = int(np.prod([s for s in in_shape]))
        target[target.index(-1)] = (total // known) if known else -1
    else:
        for i, s in enumerate(target):
            if s == 0:
                target[i] = in_shape[i]
    return target


def _reshape_infer(op: Operator, block: Block):
    x = in_var(op, block, "X")
    shape = op.attr("shape", [])
    if -1 in (x.shape or ()):  # dynamic batch flows through
        out = list(shape)
        for i, s in enumerate(out):
            if s == 0:
                out[i] = x.shape[i]
    else:
        out = _infer_reshape_shape(list(x.shape), shape)
    set_out(op, block, "Out", out, x.dtype)
    if op.output("XShape"):
        set_out(op, block, "XShape", [0] + list(x.shape), x.dtype)


def _reshape_lower(ctx: LowerContext, op: Operator):
    x = ctx.get_input(op, "X")
    if op.single_input("Shape"):
        shape = [int(s) for s in ctx.get_input(op, "Shape").tolist()]
    else:
        shape = list(op.attr("shape", []))
    ctx.set_output(op, "Out", x.reshape(
        _infer_reshape_shape(list(x.shape), shape)))
    if op.output("XShape"):
        ctx.set_output(op, "XShape", x.new_zeros((0,)))


register_op("reshape2", infer=_reshape_infer, lower=_reshape_lower)


def _transpose_infer(op, block):
    x = in_var(op, block, "X")
    axis = op.attr("axis", [])
    set_out(op, block, "Out", [x.shape[a] for a in axis], x.dtype)
    if op.output("XShape"):
        set_out(op, block, "XShape", [0] + list(x.shape), x.dtype)


def _transpose_lower(ctx, op):
    x = ctx.get_input(op, "X")
    ctx.set_output(op, "Out", x.permute(*op.attr("axis", [])))
    if op.output("XShape"):
        ctx.set_output(op, "XShape", x.new_zeros((0,)))


register_op("transpose2", infer=_transpose_infer, lower=_transpose_lower)


def _slice_infer(op, block):
    x = in_var(op, block, "Input")
    axes = op.attr("axes", [])
    starts, ends = op.attr("starts", []), op.attr("ends", [])
    out = list(x.shape)
    for a, s, e in zip(axes, starts, ends):
        dim = x.shape[a]
        if dim == -1:
            continue
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        out[a] = max(e - s, 0)
    for a in sorted(op.attr("decrease_axis", []), reverse=True):
        out.pop(a)
    set_out(op, block, "Out", out, x.dtype)


@register_op("slice", infer=_slice_infer)
def _slice(ctx, op):
    x = ctx.get_input(op, "Input")
    idx = [slice(None)] * x.dim()
    for a, s, e in zip(op.attr("axes", []), op.attr("starts", []),
                       op.attr("ends", [])):
        idx[a] = slice(s, e if e < np.iinfo(np.int32).max else None)
    out = x[tuple(idx)]
    for a in sorted(op.attr("decrease_axis", []), reverse=True):
        if out.shape[a] != 1:
            raise ValueError(f"slice: decrease_axis {a} has size "
                             f"{out.shape[a]}, not 1")
        out = out.squeeze(a)
    ctx.set_output(op, "Out", out)


def _tile_infer(op, block):
    x = in_var(op, block, "X")
    times = op.attr("repeat_times", [])
    xs = [1] * (len(times) - len(x.shape)) + list(x.shape)
    set_out(op, block, "Out",
            [s * t for s, t in zip(xs, times)] or x.shape, x.dtype)


@register_op("tile", infer=_tile_infer)
def _tile(ctx, op):
    ctx.set_output(op, "Out", torch.tile(ctx.get_input(op, "X"),
                                         tuple(op.attr("repeat_times", []))))


# ---------------------------------------------------------------------------
# squeeze / unsqueeze
# ---------------------------------------------------------------------------

def _sq_axes(op, shape):
    axes = op.attr("axes", [])
    if not axes:
        return [i for i, s in enumerate(shape) if s == 1]
    return [a % len(shape) for a in axes]


def _squeeze_infer(op, block):
    x = in_var(op, block, "X")
    axes = _sq_axes(op, x.shape)
    out = [s for i, s in enumerate(x.shape) if i not in axes]
    set_out(op, block, "Out", out, x.dtype)
    if op.output("XShape"):
        set_out(op, block, "XShape", [0] + list(x.shape), x.dtype)


def _squeeze_lower(ctx, op):
    x = ctx.get_input(op, "X")
    axes = _sq_axes(op, tuple(x.shape))
    # jnp.squeeze semantics: every named axis must have size 1
    for a in axes:
        if x.shape[a] != 1:
            raise ValueError(f"cannot squeeze axis {a} of shape "
                             f"{tuple(x.shape)}")
    shape = [s for i, s in enumerate(x.shape) if i not in axes]
    ctx.set_output(op, "Out", x.reshape(shape))
    if op.output("XShape"):
        ctx.set_output(op, "XShape", x.new_zeros((0,)))


def _unsqueeze_infer(op, block):
    x = in_var(op, block, "X")
    out = list(x.shape)
    for a in op.attr("axes", []):
        out.insert(a if a >= 0 else a + len(out) + 1, 1)
    set_out(op, block, "Out", out, x.dtype)
    if op.output("XShape"):
        set_out(op, block, "XShape", [0] + list(x.shape), x.dtype)


def _unsqueeze_lower(ctx, op):
    x = ctx.get_input(op, "X")
    out = x
    for a in op.attr("axes", []):
        out = out.unsqueeze(a)
    ctx.set_output(op, "Out", out)
    if op.output("XShape"):
        ctx.set_output(op, "XShape", x.new_zeros((0,)))


register_op("squeeze2", infer=_squeeze_infer, lower=_squeeze_lower)
register_op("unsqueeze2", infer=_unsqueeze_infer, lower=_unsqueeze_lower)


# ---------------------------------------------------------------------------
# stack / expand (the masked-gather MLM head's coordinates)
# ---------------------------------------------------------------------------

def _stack_infer(op, block):
    xs = [block.var(n) for n in op.input("X")]
    axis = op.attr("axis", 0)
    out = list(xs[0].shape)
    out.insert(axis if axis >= 0 else axis + len(out) + 1, len(xs))
    set_out(op, block, "Y", out, xs[0].dtype)


@register_op("stack", infer=_stack_infer)
def _stack(ctx, op):
    xs = ctx.get_inputs(op, "X")
    ctx.set_output(op, "Y", torch.stack(xs, dim=op.attr("axis", 0)))


def _expand_infer(op, block):
    x = in_var(op, block, "X")
    times = op.attr("expand_times", [])
    set_out(op, block, "Out", [s * t for s, t in zip(x.shape, times)],
            x.dtype)


@register_op("expand", infer=_expand_infer)
def _expand(ctx, op):
    x = ctx.get_input(op, "X")
    ctx.set_output(op, "Out", torch.tile(x, tuple(op.attr("expand_times",
                                                          []))))


# ---------------------------------------------------------------------------
# indexing: gather_nd / embedding
# ---------------------------------------------------------------------------

def _gather_nd_infer(op, block):
    x, idx = in_var(op, block, "X"), in_var(op, block, "Index")
    out = list(idx.shape[:-1]) + list(x.shape[idx.shape[-1]:])
    set_out(op, block, "Out", out, x.dtype)


@register_op("gather_nd", infer=_gather_nd_infer)
def _gather_nd(ctx, op):
    x, idx = ctx.get_input(op, "X"), ctx.get_input(op, "Index")
    ctx.set_output(op, "Out", x[tuple(idx.long().movedim(-1, 0))])


def _lookup_infer(op, block):
    w, ids = in_var(op, block, "W"), in_var(op, block, "Ids")
    set_out(op, block, "Out", list(ids.shape) + [w.shape[-1]], w.dtype)


# PyTorch's CUDA embedding backward sums each weight row's gradient in its
# per-feature kernel up to this many ids; above it, a sort-based path whose
# sums of a row looked up thousands of times came out 1 bf16 ulp apart
# between identical runs on the card (BERT's token-type row, 4096 ids)
EMBEDDING_GRAD_CHUNK = 3072


def _lookup_grad_maker(fwd_op: Operator, block: Block, helper):
    """``is_sparse`` routes the table's gradient to
    ``lookup_table_sparse_grad``, whose ``W@GRAD`` is a SELECTED_ROWS var
    (the reference's LookupTableGradOp); a dense lookup keeps the auto
    grad (and, on the card, EMBEDDING_GRAD_CHUNK)."""
    if not fwd_op.attr("is_sparse", False):
        return build_auto_grad_specs(fwd_op, block, helper.no_grad_set)
    w_name = fwd_op.single_input("W")
    v = block._find_var_recursive(w_name)
    if v is None or v.stop_gradient or w_name in helper.no_grad_set:
        return []
    return [dict(
        type="lookup_table_sparse_grad",
        inputs={"W": [w_name], "Ids": list(fwd_op.input("Ids")),
                "Out@GRAD": [grad_var_name(fwd_op.single_output("Out"))]},
        outputs={"W@GRAD": [grad_var_name(w_name)]},
        attrs={"padding_idx": fwd_op.attr("padding_idx", -1),
               "__lookup_type__": fwd_op.type})]


@register_op("lookup_table_v2", infer=_lookup_infer, grad=_lookup_grad_maker)
def _lookup_table_v2(ctx: LowerContext, op: Operator):
    """On the card a lookup whose grad op differentiates it looks its ids
    up in chunks of EMBEDDING_GRAD_CHUNK, so every weight gradient comes
    from PyTorch's per-feature kernel, whose sums do not vary from run to
    run (the chunks' gradients add in order)."""
    w, ids = ctx.get_input(op, "W"), ctx.get_input(op, "Ids")
    ids = ids.long()
    if w.is_cuda and ctx.op_index in ctx.keep and \
            ids.numel() > EMBEDDING_GRAD_CHUNK:
        flat = ids.reshape(-1)
        out = torch.cat([torch.nn.functional.embedding(c, w) for c in
                         flat.split(EMBEDDING_GRAD_CHUNK)]).reshape(
            tuple(ids.shape) + (w.shape[-1],))
    else:
        out = torch.nn.functional.embedding(ids, w)
    padding_idx = op.attr("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        out = out * (ids != padding_idx).unsqueeze(-1).to(out.dtype)
    ctx.set_output(op, "Out", out)


def _lookup_sparse_grad_infer(op: Operator, block: Block):
    w = in_var(op, block, "W")
    set_out(op, block, "W@GRAD", w.shape, w.dtype,
            type=VarType.SELECTED_ROWS)


@register_op("lookup_table_sparse_grad", infer=_lookup_sparse_grad_infer,
             grad=None)
def _lookup_sparse_grad(ctx: LowerContext, op: Operator):
    """W@GRAD as SelectedRows {rows: the flat ids, values: the flat
    out-grad rows in W's dtype}: no [height, cols] tensor is made.  A
    padding id's rows carry zeros (its lookup was masked).  A second
    lookup of the same table adds its SelectedRows to the first's (the
    grad op's ``__accumulate__``): the two concatenate.  A dead W@GRAD is
    not computed."""
    name = op.single_output("W@GRAD")
    if name in ctx.dead:
        return
    w, ids = ctx.get_input(op, "W"), ctx.get_input(op, "Ids")
    og = ctx.get_input(op, "Out@GRAD")
    rows = ids.reshape(-1).long()
    vals = og.reshape(rows.shape[0], w.shape[-1]).to(w.dtype)
    pad = op.attr("padding_idx", -1)
    if pad is not None and pad >= 0:
        vals = vals * (rows != pad).unsqueeze(-1).to(vals.dtype)
    value = SelectedRowsValue(rows, vals, w.shape[0])
    if op.attr("__accumulate__", False) and name in ctx.env:
        value = ctx.env[name] + value
    ctx.env[name] = value


# ---------------------------------------------------------------------------
# concat / flatten2 (Wide&Deep's deep tower input)
# ---------------------------------------------------------------------------

def _concat_infer(op, block):
    xs = [block.var(n) for n in op.input("X")]
    axis = op.attr("axis", 0) % len(xs[0].shape)
    out = list(xs[0].shape)
    out[axis] = sum(v.shape[axis] for v in xs)
    set_out(op, block, "Out", out, xs[0].dtype)


@register_op("concat", infer=_concat_infer)
def _concat(ctx, op):
    axis = op.attr("axis", 0)
    if op.single_input("AxisTensor"):
        axis = int(ctx.get_input(op, "AxisTensor").reshape(()).item())
    ctx.set_output(op, "Out", torch.cat(ctx.get_inputs(op, "X"), dim=axis))


def _flatten2_infer(op, block):
    """``layers.flatten``'s form: 2-D at ``axis`` (a -1 batch dim stays
    -1)."""
    x = in_var(op, block, "X")
    axis = op.attr("axis", 1)
    set_out(op, block, "Out",
            [int(np.prod(x.shape[:axis])) if axis else 1,
             int(np.prod(x.shape[axis:]))], x.dtype)
    if op.output("XShape"):
        set_out(op, block, "XShape", [0] + list(x.shape), x.dtype)


@register_op("flatten2", infer=_flatten2_infer)
def _flatten2(ctx, op):
    x = ctx.get_input(op, "X")
    axis = op.attr("axis", 1)
    ctx.set_output(op, "Out", x.reshape(
        math.prod(x.shape[:axis]) if axis else 1, -1))
    if op.output("XShape"):
        ctx.set_output(op, "XShape", x.new_zeros((0,)))


# ---------------------------------------------------------------------------
# selection
# ---------------------------------------------------------------------------

def _where_infer(op, block):
    x = in_var(op, block, "X")
    set_out(op, block, "Out", x.shape, x.dtype)


@register_op("where", infer=_where_infer)
def _where(ctx, op):
    cond = ctx.get_input(op, "Condition")
    x, y = ctx.get_input(op, "X"), ctx.get_input(op, "Y")
    ctx.set_output(op, "Out", torch.where(cond, x, y))


def _argminmax_infer(op, block):
    x = in_var(op, block, "X")
    axis = op.attr("axis", -1)
    keep = op.attr("keepdims", False)
    if op.attr("flatten", False):
        shape = []
    else:
        axis = axis % len(x.shape)
        shape = [(1 if i == axis else s) for i, s in enumerate(x.shape)
                 if keep or i != axis]
    set_out(op, block, "Out", shape, op.attr("dtype", "int64"))


def _make_argminmax(op_type, fn):
    """``arg_max`` / ``arg_min``: the first index of the extreme value on
    ties, as jnp.argmax / argmin give it (torch does the same)."""
    def lower(ctx, op):
        x = ctx.get_input(op, "X")
        if op.attr("flatten", False):
            out = fn(x.reshape(-1), 0, False)
        else:
            out = fn(x, op.attr("axis", -1), op.attr("keepdims", False))
        ctx.set_output(op, "Out",
                       out.to(dtype_to_torch(op.attr("dtype", "int64"))))
    register_op(op_type, infer=_argminmax_infer, lower=lower, grad=None)


_make_argminmax("arg_max", lambda x, a, k: torch.argmax(x, dim=a, keepdim=k))
_make_argminmax("arg_min", lambda x, a, k: torch.argmin(x, dim=a, keepdim=k))


def _topk_infer(op, block):
    x = in_var(op, block, "X")
    axis = op.attr("axis", -1) % len(x.shape)
    shape = list(x.shape)
    shape[axis] = op.attr("k", 1)
    set_out(op, block, "Out", shape, x.dtype)
    set_out(op, block, "Indices", shape, "int64")


def _topk_lower(ctx, op):
    """The k largest (``largest`` False: smallest) along ``axis``, ties
    lower index first as ``lax.top_k`` puts them: a stable sort keeps
    equal values in index order (``torch.topk`` promises no order on the
    card)."""
    if op.single_input("K"):
        raise NotImplementedError(
            "top_k's K input (a k read from the device) is not ported; "
            "the attr k is (ROADMAP.md queue 1, item 7)")
    x = ctx.get_input(op, "X")
    k = op.attr("k", 1)
    axis = op.attr("axis", -1) % x.dim()
    vals, idx = torch.sort(x.movedim(axis, -1), dim=-1,
                           descending=op.attr("largest", True), stable=True)
    ctx.set_output(op, "Out", vals[..., :k].movedim(-1, axis))
    ctx.set_output(op, "Indices", idx[..., :k].movedim(-1, axis))


register_op("top_k", infer=_topk_infer, lower=_topk_lower, grad=None)
register_op("top_k_v2", infer=_topk_infer, lower=_topk_lower, grad=None)
