"""Neural-network op lowerings in PyTorch: ``softmax``, ``layer_norm``,
``rms_norm``, ``softmax_with_cross_entropy``, ``mse_loss`` and
``dropout``.

Counterpart of the same ops in ``paddle_tpu/ops/nn_ops.py``, with the
same formulas: normalisation statistics in float32, the loss as
``logsumexp(logits) - logits[label]`` (the numerically stable form), and
dropout's keep test on uint8 random bits.  On the card a float32
``rms_norm`` that no grad op differentiates runs a hand-written kernel
whose rows do not depend on the number of rows (ops/cuda/rms_norm.py).
"""
from __future__ import annotations

import numpy as np
import torch

from .cuda import rms_norm
from .registry import in_var, register_op, same_as_input, set_out


@register_op("softmax", infer=same_as_input())
def _softmax(ctx, op):
    """Softmax over ``axis`` (default the last), in X's dtype."""
    ctx.set_output(op, "Out", torch.softmax(ctx.get_input(op, "X"),
                                            dim=op.attr("axis", -1)))


def _ln_infer(op, block):
    x = in_var(op, block, "X")
    axis = op.attr("begin_norm_axis", 1)
    rows = int(np.prod([s for s in x.shape[:axis]])) \
        if -1 not in x.shape[:axis] else -1
    set_out(op, block, "Y", x.shape, x.dtype)
    if op.output("Mean"):
        set_out(op, block, "Mean", [rows], "float32")
    if op.output("Variance"):
        set_out(op, block, "Variance", [rows], "float32")


@register_op("layer_norm", infer=_ln_infer)
def _layer_norm(ctx, op):
    x = ctx.get_input(op, "X")
    scale = ctx.get_input(op, "Scale")
    bias = ctx.get_input(op, "Bias")
    eps = op.attr("epsilon", 1e-5)
    axis = op.attr("begin_norm_axis", 1)
    shape = tuple(x.shape)
    red = tuple(range(axis, len(shape)))
    xf = x.float()
    mean = xf.mean(dim=red, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=red, keepdim=True)
    y = (xf - mean) / torch.sqrt(var + eps)
    norm_shape = (1,) * axis + shape[axis:]
    if scale is not None:
        y = y * scale.reshape(norm_shape)
    if bias is not None:
        y = y + bias.reshape(norm_shape)
    ctx.set_output(op, "Y", y.to(x.dtype))
    ctx.set_output(op, "Mean", mean.reshape(-1))
    ctx.set_output(op, "Variance", var.reshape(-1))


@register_op("rms_norm", infer=lambda op, block: set_out(
    op, block, "Y", in_var(op, block, "X").shape,
    in_var(op, block, "X").dtype))
def _rms_norm(ctx, op):
    """RMSNorm over the last dim: statistics in float32, output in X's
    dtype.  On the card a float32 norm no grad op differentiates runs the
    kernel whose rows do not depend on the number of rows
    (ops/cuda/rms_norm.py), as generation's contract needs."""
    x = ctx.get_input(op, "X")
    scale = ctx.get_input(op, "Scale")
    eps = op.attr("epsilon", 1e-6)
    if rms_norm.routes(x, scale) and not ctx.differentiates():
        ctx.set_output(op, "Y", rms_norm.rms_norm_rows(x, scale, eps))
        return
    xf = x.float()
    y = xf / torch.sqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    if scale is not None:
        y = y * scale
    ctx.set_output(op, "Y", y.to(x.dtype))


def _swce_infer(op, block):
    x = in_var(op, block, "Logits")
    axis = op.attr("axis", -1) % len(x.shape)
    loss = list(x.shape)
    loss[axis] = 1
    set_out(op, block, "Softmax", x.shape, x.dtype)
    set_out(op, block, "Loss", loss, x.dtype)


@register_op("softmax_with_cross_entropy", infer=_swce_infer)
def _softmax_with_cross_entropy(ctx, op):
    """loss = lse(logits) - logits[label], with hard int labels
    ``[..., 1]`` or soft labels; ``ignore_index`` rows give 0."""
    logits = ctx.get_input(op, "Logits")
    label = ctx.get_input(op, "Label")
    axis = op.attr("axis", -1) % logits.dim()
    m = logits.amax(dim=axis, keepdim=True)
    lse = m + torch.log(torch.exp(logits - m).sum(dim=axis, keepdim=True))
    softmax = torch.exp(logits - lse)
    if op.attr("soft_label", False):
        loss = (label * (lse - logits)).sum(dim=axis, keepdim=True)
    else:
        lab = label
        if lab.dim() == logits.dim():
            lab = lab.squeeze(axis)
        lab = lab.long().unsqueeze(axis)
        picked = torch.take_along_dim(logits, lab, dim=axis)
        loss = lse - picked
        ignore = op.attr("ignore_index", -100)
        if ignore >= 0:
            loss = torch.where(lab == ignore, torch.zeros_like(loss), loss)
    ctx.set_output(op, "Softmax", softmax)
    ctx.set_output(op, "Loss", loss)


def _dropout_infer(op, block):
    x = in_var(op, block, "X")
    set_out(op, block, "Out", x.shape, x.dtype)
    if op.output("Mask"):
        set_out(op, block, "Mask", x.shape, "uint8")


@register_op("dropout", infer=_dropout_infer)
def _dropout(ctx, op):
    """Keeps an element where a uniform uint8 draw is >= round(p * 256),
    as the JAX package does (keep probability 1 - round(256 p) / 256);
    ``upscale_in_train`` scales the kept ones by 1 / (1 - p).  The bits
    come from ``ctx.rng(op)``, anew each run; the auto-derived
    ``dropout_grad`` differentiates the graph this op kept, mask and
    all."""
    x = ctx.get_input(op, "X")
    p = op.attr("dropout_prob", 0.5)
    impl = op.attr("dropout_implementation", "downgrade_in_infer")
    if op.attr("is_test", False) or ctx.is_test:
        ctx.set_output(op, "Out",
                       x if impl == "upscale_in_train" else x * (1.0 - p))
        if op.output("Mask"):
            ctx.set_output(op, "Mask", torch.ones(
                x.shape, dtype=torch.uint8, device=x.device))
        return
    scale = (0.0 if p >= 1.0 else 1.0 / (1.0 - p)) \
        if impl == "upscale_in_train" else 1.0
    if p >= 255.5 / 256.0:  # below uint8 granularity: drop everything
        keep = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    else:
        bits = torch.randint(0, 256, tuple(x.shape), generator=ctx.rng(op),
                             dtype=torch.uint8, device=x.device)
        keep = bits >= round(max(p, 0.0) * 256.0)
    out = torch.where(keep, x * scale if scale != 1.0 else x,
                      torch.zeros((), dtype=x.dtype, device=x.device))
    ctx.set_output(op, "Out", out)
    if op.output("Mask"):
        ctx.set_output(op, "Mask", keep.to(torch.uint8))


@register_op("mse_loss", infer=same_as_input())
def _mse(ctx, op):
    x, y = ctx.get_input(op, "X"), ctx.get_input(op, "Y")
    ctx.set_output(op, "Out", (x - y) ** 2)
