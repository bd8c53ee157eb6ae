"""Fused attention ops: ``flash_attention`` (q, k, v [B, H, S, D]) and
``flash_attention_qkv`` (packed QKV projection).

Counterpart of ``paddle_tpu/ops/attention_ops.py``.  Each op goes through
a ``torch.autograd.Function`` whose backward is what its auto-derived
``<op>_grad`` runs.  Dispatch:

  * a CUDA tensor launches the Hopper kernels (ops/cuda/flash_attention.py):
    the forward kernel, and the dK/dV and dQ kernels in the backward;
    ``flash_attention_qkv`` for H % 128 == 0 and head_dim in (64, 128), as
    the JAX package dispatches it, ``flash_attention`` for head_dim 32, 64
    or 128;
  * a CPU tensor takes the plain PyTorch versions;
  * ``flash_attention_qkv`` at other widths takes the JAX package's own
    formulation there on any device, heads split then
    ``blockwise_attention`` (``split_heads_attention``, no kernel);
  * a CUDA tensor of any other shape or dtype raises: nothing falls back.

``flash_attention`` with ``impl="xla"`` is the JAX package's einsum
formulation in plain PyTorch on any device (no attention kernel): the
uncached side of the generation contract, which ``cached_attention``
(ops/decode_ops.py) mirrors product for product.  Its two products run
the product kernel on the card where nothing differentiates them
(ops/cuda/gemm.py), as cached_attention's do.
"""
from __future__ import annotations

import torch

from .cuda import gemm
from .cuda.flash_attention import (PACKED_HEAD_DIMS, flash_attention_autograd,
                                   flash_attention_packed_autograd,
                                   split_heads_attention)
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
    optional causal mask.  ``impl="xla"`` takes the einsum formulation
    (``_xla_attention``); the sequence-parallel ring / Ulysses branch is
    not ported and raises."""
    if "sp" in (getattr(ctx, "axis_names", ()) or ()):
        raise NotImplementedError(
            "flash_attention under sequence parallelism (ring / Ulysses "
            "attention over the 'sp' mesh axis) is not ported")
    if op.attr("impl", "auto") == "xla":
        ctx.set_output(op, "Out", _xla_attention(ctx, op))
        return
    ctx.set_output(op, "Out", flash_attention_autograd(
        ctx.get_input(op, "Q"), ctx.get_input(op, "K"),
        ctx.get_input(op, "V"), _row_bias(ctx, op),
        op.attr("causal", False), op.attr("scale", None)))


# A softmax row or a P V sum over fewer keys than this takes another code
# path on the CPU than a longer one (a row shorter than a vector register
# is reduced lane by lane), so shorter key axes are padded up to it with
# masked columns: a row's result then does not depend on how many keys
# follow its last live one (a prefill bucket against the uncached forward
# at max_seq_len, tolerance 0).
MIN_KEYS = 64


def pad_keys(k: torch.Tensor, v: torch.Tensor):
    """K and V [..., Sk, D] padded with zero rows to MIN_KEYS keys (as
    they are where Sk is at least that)."""
    pad = MIN_KEYS - k.shape[-2]
    if pad <= 0:
        return k, v
    return (torch.nn.functional.pad(k, (0, 0, 0, pad)),
            torch.nn.functional.pad(v, (0, 0, 0, pad)))


def _xla_attention(ctx, op):
    """The JAX package's ``impl="xla"`` formulation: scores Q K^T * scale,
    plus the row bias, the causal mask as -1e30, softmax, then in-op
    probability dropout (``dropout_prob``, drawn from ``ctx.rng(op)``,
    not in a test run) and P V.  Layout ``bhsd`` ([B, H, S, D]) or
    ``bshd`` ([B, S, H, D], the output too).  Keys past Sk (``pad_keys``)
    are masked like causal ones."""
    q, k, v = (ctx.get_input(op, n) for n in ("Q", "K", "V"))
    bias = _row_bias(ctx, op)
    bshd = op.attr("layout", "bhsd") == "bshd"
    if bshd:
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    scale = op.attr("scale", None)
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    Sq, Sk = q.shape[-2], k.shape[-2]
    k, v = pad_keys(k, v)
    product = torch.matmul if ctx.differentiates() else gemm.product
    s = product(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        bias = torch.nn.functional.pad(bias, (0, s.shape[-1] - Sk))
        s = s + bias[:, None, None, :].to(s.dtype)
    j = torch.arange(s.shape[-1], device=s.device)
    masked = j >= Sk
    if op.attr("causal", False):
        if Sq != Sk:
            raise ValueError(f"flash_attention impl='xla' causal needs as "
                             f"many queries as keys (got {Sq} and {Sk})")
        masked = masked | (j[None, :] >
                           torch.arange(Sq, device=s.device)[:, None])
    s = s.masked_fill(masked, -1e30)
    p = torch.softmax(s, dim=-1)
    prob = op.attr("dropout_prob", 0.0)
    if prob and not (ctx.is_test or op.attr("is_test", False)):
        keep = torch.rand(p.shape, generator=ctx.rng(op),
                          device=p.device) < 1.0 - prob
        p = torch.where(keep, p / (1.0 - prob), torch.zeros_like(p))
    out = product(p, v)
    return out.transpose(1, 2) if bshd else out


def _attn_qkv_infer(op, block):
    qkv = in_var(op, block, "QKV")
    shape = list(qkv.shape)
    shape[-1] = shape[-1] // 3
    set_out(op, block, "Out", tuple(shape), qkv.dtype)


@register_op("flash_attention_qkv", infer=_attn_qkv_infer, grad="auto")
def _flash_attention_qkv(ctx, op):
    """QKV [B, S, 3H] -> Out [B, S, H], optional additive Bias [B, S]
    (or [B, 1, 1, S]) broadcast over heads and queries.  The packed
    kernels where the JAX package runs its own (hidden % 128 == 0 and
    head_dim 64 or 128), else that package's formulation for the other
    widths: heads split, then ``blockwise_attention``."""
    qkv = ctx.get_input(op, "QKV")
    nh = op.attr("num_heads")
    H = qkv.shape[-1] // 3
    D = H // nh
    attend = (flash_attention_packed_autograd
              if H % 128 == 0 and D in PACKED_HEAD_DIMS
              else split_heads_attention)
    ctx.set_output(op, "Out", attend(
        qkv, _row_bias(ctx, op), nh, op.attr("causal", False),
        op.attr("scale", None)))
