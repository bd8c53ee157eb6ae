"""Math / elementwise / reduction / matmul op lowerings in PyTorch.

Counterpart of ``paddle_tpu/ops/math_ops.py`` for the ops on the BERT
and Llama paths: ``elementwise_add/mul/div/max`` with Paddle ``axis``
broadcasting, ``less_than``, ``scale``, ``mul``, ``gelu``, ``silu``,
``sqrt``, ``cast``, ``reduce_sum``, ``mean`` and ``sum``.  ``mul``'s
row results must not depend on how many rows it has (generation's cached
decode against the uncached forward, tolerance 0).  On the card a
float32 product that no grad op differentiates runs the hand-written
product kernel whose rows do not depend on M (ops/cuda/gemm.py); a
differentiated (training) or bfloat16 product keeps ``torch.matmul``.
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

from ..framework.core import Block, Operator, dtype_to_torch
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
        x, y = _align_y(*_promote(ctx.get_input(op, "X"),
                                  ctx.get_input(op, "Y")),
                        op.attr("axis", -1))
        ctx.set_output(op, "Out", fn(x, y))
    register_op(op_type, infer=_ew_infer, lower=lower)


_make_ew("elementwise_add", lambda x, y: x + y)
_make_ew("elementwise_mul", lambda x, y: x * y)
_make_ew("elementwise_div", lambda x, y: x / y)
_make_ew("elementwise_max", torch.maximum)


# ---------------------------------------------------------------------------
# comparison (non-differentiable)
# ---------------------------------------------------------------------------

def _cmp_infer(op: Operator, block: Block):
    x = in_var(op, block, "X")
    y = in_var(op, block, "Y")
    shape = broadcast_shapes(list(x.shape), list(y.shape),
                             op.attr("axis", -1))
    set_out(op, block, "Out", shape, "bool")


@register_op("less_than", infer=_cmp_infer, grad=None)
def _less_than(ctx: LowerContext, op: Operator):
    x, y = _promote(ctx.get_input(op, "X"), ctx.get_input(op, "Y"))
    ctx.set_output(op, "Out", x < y)


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


@register_op("silu", infer=same_as_input())
def _silu(ctx: LowerContext, op: Operator):
    ctx.set_output(op, "Out", F.silu(ctx.get_input(op, "X")))


@register_op("sqrt", infer=same_as_input())
def _sqrt(ctx: LowerContext, op: Operator):
    ctx.set_output(op, "Out", torch.sqrt(ctx.get_input(op, "X")))


def _cast_infer(op: Operator, block: Block):
    x = in_var(op, block, "X")
    set_out(op, block, "Out", x.shape, op.attr("out_dtype", "float32"))


@register_op("cast", infer=_cast_infer)
def _cast(ctx: LowerContext, op: Operator):
    ctx.set_output(op, "Out", ctx.get_input(op, "X").to(
        dtype_to_torch(op.attr("out_dtype", "float32"))))


@register_op("scale", infer=same_as_input())
def _scale(ctx: LowerContext, op: Operator):
    x = ctx.get_input(op, "X")
    scale = op.attr("scale", 1.0)
    if op.single_input("ScaleTensor"):
        scale = ctx.get_input(op, "ScaleTensor")
    bias = op.attr("bias", 0.0)
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


def _cpu_product(x2: torch.Tensor, y2: torch.Tensor) -> torch.Tensor:
    """A product the kernel does not take.  On the CPU a float32 one that
    no grad op differentiates and whose K spans more than one of the
    kernel's chunks is summed as the kernel sums it, chunk partials
    folded in order (``gemm.matmul_reference``): MKL splits a long K
    across threads by the whole problem's size (BERT-base's K = 3072
    product at M = 512 rows gives other bits than at M = 128), so a
    serving batch's rows would depend on its batchmates."""
    if (x2.device.type == "cpu" and x2.dtype == torch.float32
            and y2.dtype == torch.float32 and x2.shape[-1] > gemm.K_CHUNK
            and not (x2.requires_grad or y2.requires_grad)):
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
    if gemm.routes(x2, y2):
        out = gemm.matmul(x2, y2)
    elif x2.shape[0] == 1:
        # one row takes a GEMV path that sums in another order than the
        # rows of a longer product (the uncached forward's); a decode
        # step over one slot computes it as the first of two rows
        out = _cpu_product(torch.cat([x2, x2]), y2)[:1]
    else:
        out = _cpu_product(x2, y2)
    ctx.set_output(op, "Out", out.reshape(xs[:xd] + ys[yd:]))


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


@register_op("mean", infer=_mean_infer)
def _mean(ctx: LowerContext, op: Operator):
    """The mean of every element: Out has shape []."""
    ctx.set_output(op, "Out", ctx.get_input(op, "X").mean())


def _sum_infer(op: Operator, block: Block):
    x = in_var(op, block, "X")
    set_out(op, block, "Out", x.shape, x.dtype)


@register_op("sum", infer=_sum_infer)
def _sum(ctx: LowerContext, op: Operator):
    """Add N tensors (the clip's sum of squared grad norms)."""
    xs = ctx.get_inputs(op, "X")
    out = xs[0]
    for x in xs[1:]:
        out = torch.add(*_promote(out, x))
    ctx.set_output(op, "Out", out)
