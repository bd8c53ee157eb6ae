"""Fused attention ops: ``flash_attention`` (q, k, v [B, H, S, D]) and
``flash_attention_qkv`` (packed QKV projection).

Counterpart of ``paddle_tpu/ops/attention_ops.py``.  Each op goes through
a ``torch.autograd.Function`` whose backward is what its auto-derived
``<op>_grad`` runs.  Dispatch:

  * a CUDA tensor launches the Hopper kernels (ops/cuda/flash_attention.py):
    the forward kernel, and the dK/dV and dQ kernels in the backward;
    ``flash_attention_qkv`` only for H % 128 == 0 and head_dim in (64, 128),
    as the JAX package dispatches it, ``flash_attention`` for head_dim 64
    or 128;
  * a CPU tensor takes the plain PyTorch versions;
  * a CUDA tensor of any other shape or dtype raises: nothing falls back.
"""
from __future__ import annotations

from .cuda.flash_attention import (flash_attention_autograd,
                                   flash_attention_packed_autograd)
from .registry import in_var, register_op, set_out


def _row_bias(ctx, op):
    """The optional additive Bias as rows [B, Sk]; a [B, 1, 1, Sk]-style
    mask is flattened, as the JAX package does."""
    bias = ctx.get_input(op, "Bias") if op.single_input("Bias") else None
    if bias is not None and bias.dim() != 2:
        bias = bias.reshape(bias.shape[0], bias.shape[-1])
    return bias


def _attn_infer(op, block):
    q = in_var(op, block, "Q")
    set_out(op, block, "Out", q.shape, q.dtype)


@register_op("flash_attention", infer=_attn_infer, grad="auto")
def _flash_attention(ctx, op):
    """Q [B, H, Sq, D], K and V [B, H, Sk, D] -> Out [B, H, Sq, D], with an
    optional additive Bias [B, Sk] broadcast over heads and queries and an
    optional causal mask.  ``impl="xla"`` (the einsum formulation with
    in-op probability dropout and the bshd layout) and the sequence-
    parallel ring / Ulysses branch are not ported: both raise."""
    if op.attr("impl", "auto") == "xla":
        raise NotImplementedError(
            "flash_attention impl='xla' (the einsum formulation: in-op "
            "probability dropout, layout 'bshd') is not ported; use "
            "impl='auto'")
    if "sp" in (getattr(ctx, "axis_names", ()) or ()):
        raise NotImplementedError(
            "flash_attention under sequence parallelism (ring / Ulysses "
            "attention over the 'sp' mesh axis) is not ported")
    ctx.set_output(op, "Out", flash_attention_autograd(
        ctx.get_input(op, "Q"), ctx.get_input(op, "K"),
        ctx.get_input(op, "V"), _row_bias(ctx, op),
        op.attr("causal", False), op.attr("scale", None)))


def _attn_qkv_infer(op, block):
    qkv = in_var(op, block, "QKV")
    shape = list(qkv.shape)
    shape[-1] = shape[-1] // 3
    set_out(op, block, "Out", tuple(shape), qkv.dtype)


@register_op("flash_attention_qkv", infer=_attn_qkv_infer, grad="auto")
def _flash_attention_qkv(ctx, op):
    """QKV [B, S, 3H] -> Out [B, S, H], optional additive Bias [B, S]
    (or [B, 1, 1, S]) broadcast over heads and queries."""
    qkv = ctx.get_input(op, "QKV")
    nh = op.attr("num_heads")
    H = qkv.shape[-1] // 3
    D = H // nh
    if qkv.is_cuda and not (H % 128 == 0 and D in (64, 128)):
        raise NotImplementedError(
            f"flash_attention_qkv on CUDA needs hidden % 128 == 0 and "
            f"head_dim in (64, 128) (got hidden {H}, head_dim {D}), as the "
            f"JAX package's kernel dispatch does; its unpacked fallback for "
            f"other widths (split heads, then blockwise attention) is not "
            f"ported")
    ctx.set_output(op, "Out", flash_attention_packed_autograd(
        qkv, _row_bias(ctx, op), nh, op.attr("causal", False),
        op.attr("scale", None)))
