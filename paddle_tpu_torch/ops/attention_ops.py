"""Fused attention op ``flash_attention_qkv`` (packed QKV projection).

Counterpart of ``paddle_tpu/ops/attention_ops.py:108-166``.  The op goes
through ``flash_attention_packed_autograd``, whose backward is what the
auto-derived ``flash_attention_qkv_grad`` runs.  Dispatch:

  * a CUDA tensor with H % 128 == 0 and head_dim in (64, 128) launches
    the Hopper kernels (ops/cuda/flash_attention.py): the forward kernel,
    and the dK/dV and dQ kernels in the backward;
  * a CPU tensor takes the plain PyTorch versions;
  * a CUDA tensor of any other shape raises: the unpacked
    ``flash_attention`` op, which models/bert.py uses for other widths,
    is a later slice.
"""
from __future__ import annotations

from .cuda.flash_attention import flash_attention_packed_autograd
from .registry import in_var, register_op, set_out


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
    bias = ctx.get_input(op, "Bias") if op.single_input("Bias") else None
    if bias is not None and bias.dim() != 2:
        bias = bias.reshape(bias.shape[0], bias.shape[-1])
    nh = op.attr("num_heads")
    H = qkv.shape[-1] // 3
    D = H // nh
    if qkv.is_cuda and not (H % 128 == 0 and D in (64, 128)):
        raise NotImplementedError(
            f"flash_attention_qkv on CUDA needs hidden % 128 == 0 and "
            f"head_dim in (64, 128) (got hidden {H}, head_dim {D}); the "
            f"unpacked flash_attention path is not ported yet")
    ctx.set_output(op, "Out", flash_attention_packed_autograd(
        qkv, bias, nh, op.attr("causal", False), op.attr("scale", None)))
