"""Neural-network op lowerings in PyTorch: ``softmax``, ``log_softmax``,
``layer_norm``, ``rms_norm``, ``softmax_with_cross_entropy``,
``mse_loss``, ``dropout``,
``sigmoid_cross_entropy_with_logits`` (Wide&Deep's loss), and for the
vision models ``conv2d`` / ``depthwise_conv2d``, ``pool2d``,
``batch_norm``, ``cross_entropy`` and ``accuracy``.

Counterpart of the same ops in ``paddle_tpu/ops/nn_ops.py``, with the
same formulas: normalisation statistics in float32, the loss as
``logsumexp(logits) - logits[label]`` (the numerically stable form), and
dropout's keep test on uint8 random bits.  On the card a float32
``rms_norm`` that no grad op differentiates runs a hand-written kernel
whose rows do not depend on the number of rows (ops/cuda/rms_norm.py).

Convolutions take one of two routes, picked as the products are, by
whether a grad op differentiates the op.  A float32 convolution that none
does (serving, ``is_test`` programs) is an im2col copy (``F.unfold``: a
gather, no sums) and then the product kernel (ops/cuda/gemm.py; on the
CPU the same route through ``math_ops.forward_product``), so every output
pixel has the bits it has alone, whatever its batch (``conv2d_rows``).
A differentiated or 16-bit one is cuDNN's (``conv2d_library``), run
with TF32 off and deterministic algorithms set around the port's own
forward and backward calls, whatever the caller has set: the JAX package
computes fp32 convolutions at full precision and deterministically.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch
import torch.nn.functional as F

from .cuda import rms_norm
from .math_ops import forward_product
from .registry import in_var, register_op, same_as_input, set_out


@register_op("softmax", infer=same_as_input())
def _softmax(ctx, op):
    """Softmax over ``axis`` (default the last), in X's dtype."""
    ctx.set_output(op, "Out", torch.softmax(ctx.get_input(op, "X"),
                                            dim=op.attr("axis", -1)))


@register_op("log_softmax", infer=same_as_input())
def _log_softmax(ctx, op):
    """log(softmax) over ``axis`` (default the last), in X's dtype: the
    beam decoder's step scores."""
    ctx.set_output(op, "Out", torch.log_softmax(ctx.get_input(op, "X"),
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


@register_op("sigmoid_cross_entropy_with_logits", infer=same_as_input())
def _sigmoid_ce(ctx, op):
    """max(x, 0) - x * label + log(1 + exp(-|x|)), elementwise (the stable
    form); 0 where the label is ``ignore_index`` (when >= 0); with
    ``normalize`` divided by the count of labels that are not."""
    x = ctx.get_input(op, "X")
    label = ctx.get_input(op, "Label")
    loss = torch.clamp(x, min=0) - x * label + \
        torch.log1p(torch.exp(-x.abs()))
    ignore = op.attr("ignore_index", -100)
    if ignore >= 0:
        loss = torch.where(label == ignore, torch.zeros_like(loss), loss)
    if op.attr("normalize", False):
        n = torch.clamp((label != ignore).to(x.dtype).sum(), min=1.0)
        loss = loss / n
    ctx.set_output(op, "Out", loss)


# ---------------------------------------------------------------------------
# convolution
# ---------------------------------------------------------------------------

def _conv_out_dim(i, k, pad0, pad1, stride, dil):
    if i == -1:
        return -1
    ke = (k - 1) * dil + 1
    return (i + pad0 + pad1 - ke) // stride + 1


def _resolve_padding(op, spatial, ksize, strides, dils):
    """(before, after) pads a spatial dim, as the JAX package resolves
    ``paddings`` and ``padding_algorithm``: SAME pads the deficit, the odd
    cell after; EXPLICIT takes one pad a dim or a pair a dim."""
    pad = op.attr("paddings", [0] * len(spatial))
    algo = op.attr("padding_algorithm", "EXPLICIT")
    n = len(spatial)
    if algo == "VALID":
        return [(0, 0)] * n
    if algo == "SAME":
        pairs = []
        for i in range(n):
            out = -(-spatial[i] // strides[i]) if spatial[i] != -1 else 1
            ke = (ksize[i] - 1) * dils[i] + 1
            total = max((out - 1) * strides[i] + ke - spatial[i], 0)
            pairs.append((total // 2, total - total // 2))
        return pairs
    if len(pad) == n:
        return [(p, p) for p in pad]
    if len(pad) == 2 * n:
        return [(pad[2 * i], pad[2 * i + 1]) for i in range(n)]
    return [(0, 0)] * n


def _conv2d_infer(op, block):
    x = in_var(op, block, "Input")
    w = in_var(op, block, "Filter")
    fmt = op.attr("data_format", "NCHW")
    strides = op.attr("strides", [1, 1])
    dils = op.attr("dilations", [1, 1])
    if fmt in ("NCHW", "AnyLayout"):
        n, c, h, wd = x.shape
    else:
        n, h, wd, c = x.shape
    kh, kw = w.shape[2], w.shape[3]
    pads = _resolve_padding(op, [h, wd], [kh, kw], strides, dils)
    oh = _conv_out_dim(h, kh, pads[0][0], pads[0][1], strides[0], dils[0])
    ow = _conv_out_dim(wd, kw, pads[1][0], pads[1][1], strides[1], dils[1])
    oc = w.shape[0]
    out = [n, oc, oh, ow] if fmt in ("NCHW", "AnyLayout") else [n, oh, ow, oc]
    set_out(op, block, "Output", out, x.dtype)


def _pad_nchw(x, pads, value=0.0):
    """x [N, C, H, W] with `pads` ((top, bottom), (left, right)) added."""
    (t, b), (l, r) = pads
    if not (t or b or l or r):
        return x
    return F.pad(x, (l, r, t, b), value=value)


def conv2d_rows(x, w, strides, pads, dils, groups=1, channels_last=False):
    """The forward-only float32 convolution: x [N, C, H, W] (NCHW) with
    the filter w [OC, C / groups, kh, kw] (OIHW), `pads` a (before,
    after) pair a spatial dim.  An im2col copy of the padded input (one
    row an output pixel, K = C / groups x kh x kw) times the filter
    reshaped and transposed in place (a view on the card, a copy on the
    CPU: nothing is kept across calls, so a swapped filter is read as it
    is now): one product of all groups, by the product kernel on the card
    (``gemm.matmul``, which raises on anything it does not take; each
    launch counted in its ``.launches`` and in this route's own) and by
    ``math_ops.forward_product`` on the CPU.  Each pixel's sums depend on
    its own K-vector alone, so a batch gives every image the bits it has
    alone.  Returns [N, OC, OH, OW], or [N, OH, OW, OC] with
    `channels_last`."""
    from .cuda import gemm

    n, c = x.shape[:2]
    oc, cg, kh, kw = w.shape
    x = _pad_nchw(x, pads)
    oh = _conv_out_dim(x.shape[2], kh, 0, 0, strides[0], dils[0])
    ow = _conv_out_dim(x.shape[3], kw, 0, 0, strides[1], dils[1])
    k = cg * kh * kw
    cols = F.unfold(x, (kh, kw), dilation=tuple(dils), stride=tuple(strides))
    a = cols.view(n, groups, k, oh * ow).permute(1, 0, 3, 2).reshape(
        groups, n * oh * ow, k)
    b = w.reshape(groups, oc // groups, k).transpose(1, 2)
    if x.is_cuda:
        out = gemm.matmul(a, b)
        conv2d_rows.launches += bool(out.numel())  # an empty one launches none
    else:
        # MKL sums a transposed filter below ~16 rows in another order than
        # in longer products: a contiguous copy
        out = forward_product(a, b.contiguous(), False)
    out = out.view(groups, n, oh, ow, oc // groups)
    if channels_last:
        return out.permute(1, 2, 3, 0, 4).reshape(n, oh, ow, oc)
    return out.permute(1, 0, 4, 2, 3).reshape(n, oc, oh, ow)


conv2d_rows.launches = 0


def counters():
    """(owner, attribute) of the count kept here: the forward-only
    convolution route's launches of the product kernel."""
    return ((conv2d_rows, "launches"),)


# cuDNN's settings are process-wide: the port sets its own around each of
# its calls and puts the caller's back, one call at a time
_CUDNN_LOCK = threading.RLock()


@contextlib.contextmanager
def _cudnn_settings():
    """TF32 off (the reference's fp32 convolutions run at full precision)
    and deterministic algorithms picked without benchmarking (the
    reference's are deterministic; training's captured and eager runs
    must give the same bits) for the calls inside."""
    with _CUDNN_LOCK, torch.backends.cudnn.flags(
            enabled=True, benchmark=False, deterministic=True,
            allow_tf32=False):
        yield


class _LibraryConv(torch.autograd.Function):
    """cuDNN's convolution, forward and backward each under
    ``_cudnn_settings`` (autograd runs the backward later, outside the
    forward's settings)."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation, groups):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, dilation, groups)
        with _cudnn_settings():
            return F.conv2d(x, w, None, stride, padding, dilation, groups)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        stride, padding, dilation, groups = ctx.conf
        with _cudnn_settings():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                grad, x, w, None, list(stride), list(padding),
                list(dilation), False, [0, 0], groups,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw, None, None, None, None


def conv2d_library(x, w, strides, pads, dils, groups=1):
    """The differentiated or 16-bit convolution: ``F.conv2d`` on x [N, C,
    H, W] (NCHW), OIHW w; uneven pads go through ``F.pad`` first
    (``F.conv2d`` pads both sides alike).  On the card cuDNN runs under
    ``_cudnn_settings`` in both directions."""
    if any(a != b for a, b in pads):
        x, padding = _pad_nchw(x, pads), (0, 0)
    else:
        padding = tuple(a for a, _ in pads)
    if x.is_cuda:
        return _LibraryConv.apply(x, w, tuple(strides), padding, tuple(dils),
                                  groups)
    return F.conv2d(x, w, None, tuple(strides), padding, tuple(dils), groups)


def _conv2d_lower(ctx, op):
    x = ctx.get_input(op, "Input")
    w = ctx.get_input(op, "Filter")  # OIHW, as in the JAX package
    fmt = op.attr("data_format", "NCHW")
    nhwc = fmt not in ("NCHW", "AnyLayout")
    strides = list(op.attr("strides", [1, 1]))
    dils = list(op.attr("dilations", [1, 1]))
    groups = op.attr("groups", 1)
    xc = x.permute(0, 3, 1, 2) if nhwc else x
    pads = _resolve_padding(op, list(xc.shape[2:]), list(w.shape[2:]),
                            strides, dils)
    if x.dtype == torch.float32 and w.dtype == torch.float32 and \
            not ctx.differentiates():
        out = conv2d_rows(xc, w, strides, pads, dils, groups,
                          channels_last=nhwc)
    else:
        out = conv2d_library(xc, w.to(x.dtype), strides, pads, dils, groups)
        if nhwc:
            out = out.permute(0, 2, 3, 1)
    ctx.set_output(op, "Output", out.to(x.dtype))


register_op("conv2d", infer=_conv2d_infer, lower=_conv2d_lower)
register_op("depthwise_conv2d", infer=_conv2d_infer, lower=_conv2d_lower)


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------

def _pool2d_infer(op, block):
    x = in_var(op, block, "X")
    fmt = op.attr("data_format", "NCHW")
    n, c, h, w = x.shape if fmt == "NCHW" else (
        x.shape[0], x.shape[3], x.shape[1], x.shape[2])
    if op.attr("global_pooling", False):
        oh = ow = 1
    elif op.attr("adaptive", False):
        oh, ow = op.attr("ksize", [1, 1])
    else:
        ks = op.attr("ksize", [1, 1])
        strides = op.attr("strides", [1, 1])
        pads = _resolve_padding(op, [h, w], ks, strides, [1, 1])
        ceil = op.attr("ceil_mode", False)

        def _od(i, k, p0, p1, s):
            if i == -1:
                return -1
            num = i + p0 + p1 - k
            return (num + s - 1) // s + 1 if ceil else num // s + 1
        oh = _od(h, ks[0], pads[0][0], pads[0][1], strides[0])
        ow = _od(w, ks[1], pads[1][0], pads[1][1], strides[1])
    out = [n, c, oh, ow] if fmt == "NCHW" else [n, oh, ow, c]
    set_out(op, block, "Out", out, x.dtype)


@register_op("pool2d", infer=_pool2d_infer)
def _pool2d(ctx, op):
    """Max or average pooling as the JAX package's ``reduce_window``
    computes it: pads are -inf (max) or 0 (avg) cells, before and after
    apart; an ``exclusive`` average over padded windows divides by the
    count of real cells, any other by the window's size; ``adaptive``
    pools divisible sizes only; global pooling is one window over the
    whole map.  ``ceil_mode`` changes the declared shape only: the
    lowering's windows are the floor's, as in the JAX package.  Every
    window is summed by one thread in a fixed order (``F.avg_pool2d``),
    so a served image's pooled values do not depend on its batch (a
    library reduction over the spatial dims picks its order by the
    tensor's size)."""
    x = ctx.get_input(op, "X")
    nhwc = op.attr("data_format", "NCHW") != "NCHW"
    avg = op.attr("pooling_type", "max") != "max"
    xc = x.permute(0, 3, 1, 2) if nhwc else x
    h, w = xc.shape[2:]
    adaptive = op.attr("adaptive", False)
    if op.attr("global_pooling", False):
        ks = strides = [h, w]
        pads = [(0, 0), (0, 0)]
    elif adaptive:
        oh, ow = op.attr("ksize")
        if h % oh or w % ow:
            raise AssertionError(
                "adaptive pool needs divisible sizes under static shapes")
        ks = strides = [h // oh, w // ow]
        pads = [(0, 0), (0, 0)]
    else:
        ks = list(op.attr("ksize", [1, 1]))
        strides = list(op.attr("strides", [1, 1]))
        pads = _resolve_padding(op, [h, w], ks, strides, [1, 1])
    if avg:
        summed = F.avg_pool2d(_pad_nchw(xc, pads), ks, strides,
                              divisor_override=1)
        if op.attr("exclusive", True) and any(p != (0, 0) for p in pads):
            ones = torch.ones((1, 1, h, w), dtype=xc.dtype, device=xc.device)
            out = summed / F.avg_pool2d(_pad_nchw(ones, pads), ks, strides,
                                        divisor_override=1)
        else:
            out = summed / float(np.prod(ks))
    else:
        low = float("-inf") if xc.is_floating_point() else \
            torch.iinfo(xc.dtype).min
        out = F.max_pool2d(_pad_nchw(xc, pads, low), ks, strides)
    if nhwc:
        out = out.permute(0, 2, 3, 1)
    ctx.set_output(op, "Out", out.to(x.dtype))


# ---------------------------------------------------------------------------
# batch norm
# ---------------------------------------------------------------------------

def _bn_infer(op, block):
    x = in_var(op, block, "X")
    c_axis = 1 if op.attr("data_layout", "NCHW") == "NCHW" else \
        len(x.shape) - 1
    c = x.shape[c_axis]
    set_out(op, block, "Y", x.shape, x.dtype)
    for slot in ("MeanOut", "VarianceOut", "SavedMean", "SavedVariance"):
        if op.output(slot):
            set_out(op, block, slot, [c], "float32")


def _bn_lower(ctx, op):
    """Fluid's batch norm, as the JAX package computes it.  Training:
    the batch's mean and biased variance in float32 normalise X, and the
    running statistics become ``momentum * old + (1 - momentum) * batch``
    (not ``F.batch_norm``'s update, which weighs the other way and takes
    the unbiased variance), written into the scope's own tensors
    (``set_state``), so a captured replay updates them.  ``is_test`` or
    ``use_global_stats``: the running statistics normalise X, and the
    outputs bind the inputs themselves, so nothing is written (concurrent
    serving workers share them).  Y is cast back to X's dtype;
    ``SavedVariance`` is 1 / sqrt(var + eps)."""
    x = ctx.get_input(op, "X")
    scale = ctx.get_input(op, "Scale")
    bias = ctx.get_input(op, "Bias")
    mean = ctx.get_input(op, "Mean")
    var = ctx.get_input(op, "Variance")
    eps = op.attr("epsilon", 1e-5)
    momentum = op.attr("momentum", 0.9)
    use_global = op.attr("use_global_stats", False) or \
        op.attr("is_test", False) or ctx.is_test
    nd = x.dim()
    c_axis = 1 if op.attr("data_layout", "NCHW") == "NCHW" else nd - 1
    red = tuple(i for i in range(nd) if i != c_axis)
    bshape = [1] * nd
    bshape[c_axis] = x.shape[c_axis]
    xf = x.float()
    if use_global:
        use_mean, use_var = mean, var
        new_mean, new_var = mean, var
    else:
        use_mean = xf.mean(dim=red)
        use_var = ((xf - use_mean.reshape(bshape)) ** 2).mean(dim=red)
        new_mean = momentum * mean + (1 - momentum) * use_mean
        new_var = momentum * var + (1 - momentum) * use_var
    inv = 1.0 / torch.sqrt(use_var + eps)
    y = (xf - use_mean.reshape(bshape)) * inv.reshape(bshape)
    y = y * scale.reshape(bshape) + bias.reshape(bshape)
    ctx.set_output(op, "Y", y.to(x.dtype))
    ctx.set_state(op, "MeanOut", "Mean", new_mean)
    ctx.set_state(op, "VarianceOut", "Variance", new_var)
    ctx.set_output(op, "SavedMean", use_mean)
    ctx.set_output(op, "SavedVariance", inv)


def _bn_grad_maker(fwd_op, block, helper):
    """The auto-derived grad, without grads for Mean and Variance: the
    running statistics are state, never differentiated."""
    from .registry import build_auto_grad_specs
    specs = build_auto_grad_specs(fwd_op, block, helper.no_grad_set)
    for s in specs:
        s["outputs"].pop("Mean@GRAD", None)
        s["outputs"].pop("Variance@GRAD", None)
    return specs


register_op("batch_norm", infer=_bn_infer, lower=_bn_lower,
            grad=_bn_grad_maker, stateful_outputs=("MeanOut", "VarianceOut"))


# ---------------------------------------------------------------------------
# cross entropy over probabilities, accuracy
# ---------------------------------------------------------------------------

def _ce_infer(op, block):
    x = in_var(op, block, "X")
    label = in_var(op, block, "Label")
    soft = op.attr("soft_label", False)
    out = list(label.shape if not soft else x.shape[:-1] + (1,))
    if not soft and (not out or out[-1] != 1):
        out = list(x.shape[:-1]) + [1]
    set_out(op, block, "Y", out, x.dtype)


@register_op("cross_entropy", infer=_ce_infer)
def _cross_entropy(ctx, op):
    """-log(p[label] + 1e-12) of probabilities X (not logits); soft labels
    sum -label log(p + 1e-12) over the last dim; a hard label equal to
    ``ignore_index`` (when >= 0) gives 0."""
    x = ctx.get_input(op, "X")
    label = ctx.get_input(op, "Label")
    eps = 1e-12
    if op.attr("soft_label", False):
        y = -(label * torch.log(x + eps)).sum(dim=-1, keepdim=True)
    else:
        if label.dim() == x.dim():
            label = label.squeeze(-1)
        lab = label.long().unsqueeze(-1)
        p = torch.take_along_dim(x, lab.clamp(0, x.shape[-1] - 1), dim=-1)
        y = -torch.log(p + eps)
        ignore = op.attr("ignore_index", -100)
        if ignore >= 0:
            y = torch.where(lab == ignore, torch.zeros_like(y), y)
    ctx.set_output(op, "Y", y)


def _acc_infer(op, block):
    set_out(op, block, "Accuracy", [], "float32")
    if op.output("Correct"):
        set_out(op, block, "Correct", [], "int32")
    if op.output("Total"):
        set_out(op, block, "Total", [], "int32")


@register_op("accuracy", infer=_acc_infer, grad=None)
def _accuracy(ctx, op):
    """The share of rows whose label is among their top-k ``Indices``;
    ``Correct`` and ``Total`` are int32 scalars."""
    idx = ctx.get_input(op, "Indices")
    label = ctx.get_input(op, "Label")
    if label.dim() == 2:
        label = label.squeeze(-1)
    correct = (idx == label[:, None]).any(dim=1).sum(dtype=torch.int32)
    n = idx.shape[0]
    ctx.set_output(op, "Accuracy", correct.float() / float(n))
    ctx.set_output(op, "Correct", correct)
    ctx.set_output(op, "Total", torch.full((), n, dtype=torch.int32,
                                           device=idx.device))
