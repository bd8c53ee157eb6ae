"""Math / elementwise / reduction / matmul op lowerings in PyTorch.

Counterpart of ``paddle_tpu/ops/math_ops.py`` for the ops on the BERT
and Llama paths: ``elementwise_add/sub/mul/div/max/min/pow`` with Paddle
``axis`` broadcasting, ``less_than``, ``equal``, ``scale``, ``mul``,
``gelu``, ``relu``, ``silu``, ``sigmoid``, ``square``, ``sqrt``, ``exp``,
``cos``, ``floor``, ``ceil``, ``sign``, ``pow``, ``cast``, ``reduce_sum``,
``reduce_mean``, ``mean`` and ``sum``; ``matmul`` / ``matmul_v2`` (BERT's
unfused attention); and for the training recipe (LR decays, clips, L1
decay) ``clip``, ``clip_by_norm`` and ``global_norm_sq``.  The
SelectedRows cases of the JAX package's (``math_ops.py:53-63``,
``:198-235``, ``:480-493``, ``:544-560``, ``:579-592``): elementwise
operands and ``global_norm_sq``'s inputs densify, ``scale`` without a bias
keeps the rows, ``clip`` and ``clip_by_norm`` merge and stay sparse,
``sum`` of SelectedRows alone concatenates.  ``mul``'s and ``matmul``'s
row results must not depend on how many rows they have (generation's
cached decode against the uncached forward, a served batch against its
rows alone: tolerance 0).  On the card a float32 product that no grad op
differentiates runs the hand-written product kernel whose rows do not
depend on M (ops/cuda/gemm.py); a differentiated (training) or bfloat16
product keeps ``torch.matmul``.
On the CPU a one-row product is computed as two rows: MKL's one-row GEMV
sums in another order than the rows of a longer product.

Binary ops promote their operands as jax.numpy does: a bfloat16 and a
float32 operand give float32 whatever their ranks (torch alone would
keep a dimensioned bfloat16 tensor's type against a 0-d float32 one).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..errors import InvalidArgumentError
from ..framework.core import Block, Operator, dtype_to_torch
from ..framework.selected_rows import (SelectedRowsValue,
                                       concat_selected_rows, densify,
                                       is_selected_rows)
from .cuda import gemm
from .registry import (LowerContext, broadcast_shapes, in_var, register_op,
                       same_as_input, set_out)


# ---------------------------------------------------------------------------
# elementwise binary ops (broadcast with paddle `axis` semantics)
# ---------------------------------------------------------------------------

def _ew_infer(op: Operator, block: Block):
    x = in_var(op, block, "X")
    y = in_var(op, block, "Y")
    shape = broadcast_shapes(list(x.shape), list(y.shape),
                             op.attr("axis", -1))
    set_out(op, block, "Out", shape, x.dtype)


def _align_y(x, y, axis):
    """Reshape the lower-rank operand so its dims start at `axis` of the
    other (Paddle's rule; -1 aligns trailing dims)."""
    xr, yr = x.dim(), y.dim()
    if yr < xr:
        if axis == -1:
            axis = xr - yr
        y = y.reshape((1,) * axis + tuple(y.shape) + (1,) * (xr - axis - yr))
    elif xr < yr:
        if axis == -1:
            axis = yr - xr
        x = x.reshape((1,) * axis + tuple(x.shape) + (1,) * (yr - axis - xr))
    return x, y


def _promote(x, y):
    if x.dtype == y.dtype:
        return x, y
    dt = torch.promote_types(x.dtype, y.dtype)
    return x.to(dt), y.to(dt)


def _make_ew(op_type, fn):
    def lower(ctx: LowerContext, op: Operator):
        # a SelectedRows operand densifies, once where it is both (the
        # global-norm clip squares and scales gradients elementwise)
        x, y = ctx.get_input(op, "X"), ctx.get_input(op, "Y")
        x, y = (densify(x), densify(y)) if x is not y else (densify(x),) * 2
        x, y = _align_y(*_promote(x, y), op.attr("axis", -1))
        ctx.set_output(op, "Out", fn(x, y))
    register_op(op_type, infer=_ew_infer, lower=lower, selected_rows=True)


_make_ew("elementwise_add", lambda x, y: x + y)
_make_ew("elementwise_sub", lambda x, y: x - y)
_make_ew("elementwise_mul", lambda x, y: x * y)
_make_ew("elementwise_div", lambda x, y: x / y)
_make_ew("elementwise_max", torch.maximum)
_make_ew("elementwise_min", torch.minimum)
_make_ew("elementwise_pow", torch.pow)


# ---------------------------------------------------------------------------
# comparison (non-differentiable)
# ---------------------------------------------------------------------------

def _cmp_infer(op: Operator, block: Block):
    x = in_var(op, block, "X")
    y = in_var(op, block, "Y")
    shape = broadcast_shapes(list(x.shape), list(y.shape),
                             op.attr("axis", -1))
    set_out(op, block, "Out", shape, "bool")


def _make_cmp(op_type, fn):
    def lower(ctx: LowerContext, op: Operator):
        x, y = _promote(ctx.get_input(op, "X"), ctx.get_input(op, "Y"))
        ctx.set_output(op, "Out", fn(x, y))
    register_op(op_type, infer=_cmp_infer, lower=lower, grad=None)


_make_cmp("less_than", lambda x, y: x < y)
_make_cmp("equal", lambda x, y: x == y)


# ---------------------------------------------------------------------------
# activations / scale
# ---------------------------------------------------------------------------

@register_op("gelu", infer=same_as_input())
def _gelu(ctx: LowerContext, op: Operator):
    # the op's own default is the exact erf form (jax.nn.gelu's default
    # is tanh, but the JAX lowering passes approximate=False)
    approx = "tanh" if op.attr("approximate", False) else "none"
    ctx.set_output(op, "Out", F.gelu(ctx.get_input(op, "X"),
                                     approximate=approx))


@register_op("relu", infer=same_as_input())
def _relu(ctx: LowerContext, op: Operator):
    ctx.set_output(op, "Out", torch.relu(ctx.get_input(op, "X")))


@register_op("silu", infer=same_as_input())
def _silu(ctx: LowerContext, op: Operator):
    ctx.set_output(op, "Out", F.silu(ctx.get_input(op, "X")))


@register_op("sigmoid", infer=same_as_input())
def _sigmoid(ctx: LowerContext, op: Operator):
    ctx.set_output(op, "Out", torch.sigmoid(ctx.get_input(op, "X")))


def _make_unary(op_type, fn, grad="auto"):
    def lower(ctx: LowerContext, op: Operator):
        ctx.set_output(op, "Out", fn(ctx.get_input(op, "X"), op))
    register_op(op_type, infer=same_as_input(), lower=lower, grad=grad)


_make_unary("sqrt", lambda x, op: torch.sqrt(x))
_make_unary("exp", lambda x, op: torch.exp(x))
_make_unary("cos", lambda x, op: torch.cos(x))
_make_unary("floor", lambda x, op: torch.floor(x))
_make_unary("ceil", lambda x, op: torch.ceil(x))
_make_unary("square", lambda x, op: x * x)
_make_unary("sign", lambda x, op: torch.sign(x), grad=None)


def _clip_value(x, op):
    """Clamp into [min, max]; a SelectedRows gradient is merged first and
    its values clamped (the reference's clip_op SelectedRows branch: rows
    it does not hold are 0 and stay so)."""
    lo = op.attr("min", float("-inf"))
    hi = op.attr("max", float("inf"))
    if is_selected_rows(x):
        m = x.merge()
        return SelectedRowsValue(m.rows, torch.clamp(m.values, lo, hi),
                                 m.height)
    return torch.clamp(x, lo, hi)


register_op("clip", infer=same_as_input(), selected_rows=True,
            lower=lambda ctx, op: ctx.set_output(
                op, "Out", _clip_value(ctx.get_input(op, "X"), op)))


@register_op("pow", infer=same_as_input())
def _pow(ctx: LowerContext, op: Operator):
    x = ctx.get_input(op, "X")
    factor = op.attr("factor", 1.0)
    if op.single_input("FactorTensor"):
        factor = ctx.get_input(op, "FactorTensor")
    ctx.set_output(op, "Out", torch.pow(x, factor))


@register_op("clip_by_norm", infer=same_as_input(), selected_rows=True)
def _clip_by_norm(ctx: LowerContext, op: Operator):
    """X scaled by max_norm / ||X|| where its L2 norm exceeds max_norm.  A
    SelectedRows gradient is merged and its values scaled, and stays
    sparse (the reference's clip_by_norm_op SelectedRows branch)."""
    x = ctx.get_input(op, "X")
    max_norm = op.attr("max_norm", 1.0)
    if is_selected_rows(x):
        m = x.merge()
        norm = torch.sqrt(torch.sum(m.values * m.values))
        ctx.set_output(op, "Out", SelectedRowsValue(
            m.rows, torch.where(norm > max_norm,
                                m.values * (max_norm / norm), m.values),
            m.height))
        return
    norm = torch.sqrt(torch.sum(x * x))
    ctx.set_output(op, "Out",
                   torch.where(norm > max_norm, x * (max_norm / norm), x))


@register_op("global_norm_sq", infer=lambda op, block: set_out(
    op, block, "Out", (), "float32"), selected_rows=True)
def _global_norm_sq(ctx: LowerContext, op: Operator):
    """sum_i ||X_i||^2 over every input, as one float32 dot product of
    their concatenation (the JAX package's formulation; the clip's
    ``PT_FUSED_GLOBAL_CLIP=1`` opt-in); a SelectedRows input densifies."""
    flat = torch.cat([densify(x).float().reshape(-1)
                      for x in ctx.get_inputs(op, "X")])
    ctx.set_output(op, "Out", torch.dot(flat, flat))


def _cast_infer(op: Operator, block: Block):
    x = in_var(op, block, "X")
    set_out(op, block, "Out", x.shape, op.attr("out_dtype", "float32"))


@register_op("cast", infer=_cast_infer)
def _cast(ctx: LowerContext, op: Operator):
    ctx.set_output(op, "Out", ctx.get_input(op, "X").to(
        dtype_to_torch(op.attr("out_dtype", "float32"))))


@register_op("scale", infer=same_as_input(), selected_rows=True)
def _scale(ctx: LowerContext, op: Operator):
    """X * scale + bias (or (X + bias) * scale).  A SelectedRows X with
    no bias keeps its rows and scales its values; with a bias it
    densifies."""
    x = ctx.get_input(op, "X")
    scale = op.attr("scale", 1.0)
    if op.single_input("ScaleTensor"):
        scale = ctx.get_input(op, "ScaleTensor")
    bias = op.attr("bias", 0.0)
    if is_selected_rows(x):
        if bias == 0.0:
            ctx.set_output(op, "Out", x.scale(scale))
            return
        x = x.to_dense()
    if op.attr("bias_after_scale", True):
        out = x * scale + bias
    else:
        out = (x + bias) * scale
    ctx.set_output(op, "Out", out)


# ---------------------------------------------------------------------------
# mul: flatten x at x_num_col_dims and y at y_num_col_dims, then matmul
# ---------------------------------------------------------------------------

def _mul_infer(op: Operator, block: Block):
    x, y = in_var(op, block, "X"), in_var(op, block, "Y")
    xd = op.attr("x_num_col_dims", 1)
    yd = op.attr("y_num_col_dims", 1)
    set_out(op, block, "Out", list(x.shape[:xd]) + list(y.shape[yd:]),
            x.dtype)


def _cpu_product(x2: torch.Tensor, y2: torch.Tensor,
                 differentiated: bool) -> torch.Tensor:
    """A product the kernel does not take.  On the CPU a float32 one that
    no grad op differentiates and whose K spans more than one of the
    kernel's chunks is summed as the kernel sums it, chunk partials
    folded in order (``gemm.matmul_reference``): MKL splits a long K
    across threads by the whole problem's size (BERT-base's K = 3072
    product at M = 512 rows gives other bits than at M = 128), so a
    serving batch's rows would depend on its batchmates."""
    if (x2.device.type == "cpu" and x2.dtype == torch.float32
            and y2.dtype == torch.float32 and x2.shape[-1] > gemm.K_CHUNK
            and not differentiated):
        return gemm.matmul(x2, y2)
    return torch.matmul(x2, y2)


@register_op("mul", infer=_mul_infer)
def _mul(ctx: LowerContext, op: Operator):
    x, y = ctx.get_input(op, "X"), ctx.get_input(op, "Y")
    xd = op.attr("x_num_col_dims", 1)
    yd = op.attr("y_num_col_dims", 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape(math.prod(xs[:xd]), -1)
    y2 = y.reshape(math.prod(ys[:yd]), -1)
    # an original forward that recompute re-emits is differentiated
    # through its copy: both take the training product
    differentiated = ctx.differentiates()
    if gemm.routes(x2, y2) and not differentiated:
        out = gemm.matmul(x2, y2)
    elif x2.shape[0] == 1:
        # one row takes a GEMV path that sums in another order than the
        # rows of a longer product (the uncached forward's); a decode
        # step over one slot computes it as the first of two rows
        out = _cpu_product(torch.cat([x2, x2]), y2, differentiated)[:1]
    else:
        out = _cpu_product(x2, y2, differentiated)
    ctx.set_output(op, "Out", out.reshape(xs[:xd] + ys[yd:]))


# ---------------------------------------------------------------------------
# matmul: batched products with transposes, alpha and broadcast batch dims
# ---------------------------------------------------------------------------

def _matmul_shape(xs, ys, tx, ty):
    """Out's shape, as the JAX package infers it: a 1-D operand is a row
    (X) or a column (Y) whose transpose flag is ignored; batch dims are
    the longer operand's."""
    xs, ys = list(xs), list(ys)
    x1, y1 = len(xs) == 1, len(ys) == 1
    if x1:
        xs = [1, xs[0]]
    if y1:
        ys = [ys[0], 1]
    if tx and not x1:
        xs = xs[:-2] + [xs[-1], xs[-2]]
    if ty and not y1:
        ys = ys[:-2] + [ys[-1], ys[-2]]
    if not (int(xs[-1]) == int(ys[-2]) or -1 in (int(xs[-1]),
                                                 int(ys[-2]))):
        raise InvalidArgumentError(
            f"matmul contraction mismatch: X{tuple(xs)} @ Y{tuple(ys)} "
            f"(K={xs[-1]} vs {ys[-2]})")
    batch = xs[:-2] if len(xs) >= len(ys) else ys[:-2]
    out = list(batch) + [xs[-2], ys[-1]]
    if x1:
        out.pop(-2)
    if y1:
        out.pop(-1)
    return tuple(out or [1])


def _matmul_infer(op: Operator, block: Block):
    x, y = in_var(op, block, "X"), in_var(op, block, "Y")
    tx = op.attr("trans_x", op.attr("transpose_X", False))
    ty = op.attr("trans_y", op.attr("transpose_Y", False))
    set_out(op, block, "Out", _matmul_shape(x.shape, y.shape, tx, ty),
            x.dtype)


def _matmul(ctx: LowerContext, op: Operator):
    """Out = alpha * op(X) @ op(Y), op a transpose of the last two dims
    where ``trans_x`` / ``transpose_X`` (``trans_y`` / ``transpose_Y``)
    asks for it; batch dims broadcast, a 1-D operand is a row or a column.
    16-bit operands are summed in float32 and rounded once, as the JAX
    package's ``preferred_element_type`` does; alpha scales the result in
    its dtype.  The product is chosen as ``mul``'s: the kernel on the card
    where no grad op differentiates it, on the CPU the kernel's chunked
    sums for a long K (``_cpu_product``) and one row as the first of two,
    else ``torch.matmul``."""
    x, y = _promote(ctx.get_input(op, "X"), ctx.get_input(op, "Y"))
    if op.attr("trans_x", op.attr("transpose_X", False)) and x.dim() >= 2:
        x = x.transpose(-1, -2)
    if op.attr("trans_y", op.attr("transpose_Y", False)) and y.dim() >= 2:
        y = y.transpose(-1, -2)
    x1, y1 = x.dim() == 1, y.dim() == 1
    if x1:
        x = x[None]
    if y1:
        y = y[:, None]
    lead = torch.broadcast_shapes(x.shape[:-2], y.shape[:-2])
    x = x.expand(*lead, *x.shape[-2:])
    y = y.expand(*lead, *y.shape[-2:])
    differentiated = ctx.differentiates()
    if gemm.routes(x, y) and not differentiated:
        out = gemm.matmul(x, y)
    elif x.shape[-2] == 1:
        # one row as the first of two, as ``mul`` computes it
        out = _cpu_product(torch.cat([x, x], dim=-2), y,
                           differentiated)[..., :1, :]
    else:
        out = _cpu_product(x, y, differentiated)
    if x1:
        out = out.squeeze(-2)
    if y1:
        out = out.squeeze(-1)
    alpha = op.attr("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    ctx.set_output(op, "Out", out)


register_op("matmul_v2", infer=_matmul_infer, lower=_matmul)
register_op("matmul", infer=_matmul_infer, lower=_matmul)


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

def _reduce_infer(op: Operator, block: Block):
    x = in_var(op, block, "X")
    dims = op.attr("dim", [0])
    keep = op.attr("keep_dim", False)
    if op.attr("reduce_all", False) or dims is None or dims == []:
        shape = [1] * len(x.shape) if keep else []
    else:
        dims = [d % len(x.shape) for d in
                (dims if isinstance(dims, (list, tuple)) else [dims])]
        shape = [(1 if i in dims else s) if keep else s
                 for i, s in enumerate(x.shape) if keep or i not in dims]
    set_out(op, block, "Out", shape, op.attr("out_dtype") or x.dtype)


@register_op("reduce_sum", infer=_reduce_infer)
def _reduce_sum(ctx: LowerContext, op: Operator):
    x = ctx.get_input(op, "X")
    keep = op.attr("keep_dim", False)
    if op.attr("reduce_all", False) or not op.attr("dim", [0]):
        out = x.sum()
        if keep:
            out = out.reshape((1,) * x.dim())
    else:
        dims = op.attr("dim", [0])
        dims = dims if isinstance(dims, (list, tuple)) else [dims]
        out = x.sum(dim=tuple(d % x.dim() for d in dims), keepdim=keep)
    if op.attr("out_dtype"):
        out = out.to(dtype_to_torch(op.attr("out_dtype")))
    ctx.set_output(op, "Out", out)


def _mean_infer(op: Operator, block: Block):
    set_out(op, block, "Out", [], in_var(op, block, "X").dtype)


@register_op("reduce_mean", infer=_reduce_infer)
def _reduce_mean(ctx: LowerContext, op: Operator):
    x = ctx.get_input(op, "X")
    keep = op.attr("keep_dim", False)
    if op.attr("reduce_all", False) or not op.attr("dim", [0]):
        out = x.mean()
        if keep:
            out = out.reshape((1,) * x.dim())
    else:
        dims = op.attr("dim", [0])
        dims = dims if isinstance(dims, (list, tuple)) else [dims]
        out = x.mean(dim=tuple(d % x.dim() for d in dims), keepdim=keep)
    if op.attr("out_dtype"):
        out = out.to(dtype_to_torch(op.attr("out_dtype")))
    ctx.set_output(op, "Out", out)


@register_op("mean", infer=_mean_infer)
def _mean(ctx: LowerContext, op: Operator):
    """The mean of every element: Out has shape []."""
    ctx.set_output(op, "Out", ctx.get_input(op, "X").mean())


def _sum_infer(op: Operator, block: Block):
    x = in_var(op, block, "X")
    set_out(op, block, "Out", x.shape, x.dtype)


@register_op("sum", infer=_sum_infer, selected_rows=True)
def _sum(ctx: LowerContext, op: Operator):
    """Add N tensors (the clip's sum of squared grad norms).  SelectedRows
    inputs alone concatenate (the reference's sum_op SelectedRows branch;
    the consumer merges); mixed with dense ones they densify."""
    xs = ctx.get_inputs(op, "X")
    if xs and all(is_selected_rows(x) for x in xs):
        ctx.set_output(op, "Out", xs[0] if len(xs) == 1
                       else concat_selected_rows(xs))
        return
    xs = [densify(x) for x in xs]
    out = xs[0]
    for x in xs[1:]:
        out = torch.add(*_promote(out, x))
    ctx.set_output(op, "Out", out)
