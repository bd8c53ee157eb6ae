"""Autoregressive-decode ops: per-slot KV-cache writes and cached attention.

Counterpart of ``paddle_tpu/ops/decode_ops.py`` (dense cache only; the
paged ``kv_pool_write`` / ``kv_pool_gather`` are not ported yet):

* ``kv_cache_write`` — the step's fresh K/V rows go into a persistent
  per-slot cache [B, Hkv, S_max, D] at per-row offsets ``Positions``;
* ``kv_cache_insert`` — a prefill's K/V [1, Hkv, S_b, D] go into slot
  ``Slot`` of the cache, from sequence offset 0;
* ``cached_attention`` — the new token(s) attend over the whole cache
  with the per-row validity mask ``j <= positions[b] + t``.

The JAX package returns a new cache and lets XLA update the donated
buffer in place.  Here a write goes straight into the cache's own
storage when the executor lets this run update that state in place
(``LowerContext.in_place``: the scope's tensor keeps its ``data_ptr``,
and nothing of cache size is copied); otherwise, as under the
non-finite guard or for a fed cache, the op writes into a copy.  The
indices are computed on the device from ``Positions`` / ``Slot`` (no
host read), so a step with these ops can be captured as a CUDA graph.
A write starts at ``min(position, S_max - T)``, the clamp of
``jax.lax.dynamic_update_slice``; the generation engine finishes a
sequence ``cache_full`` before a write would clamp.

``cached_attention`` keeps the reference's math (the ``-1e30`` mask, the
softmax over the full cache width, repeat-interleave GQA) and its
contract: cached decode logits equal the uncached
``flash_attention impl="xla"`` forward's bit for bit on the CPU.  A
product with one row (M = 1) takes a GEMV path whose sums differ from
the GEMM rows the uncached forward computes, so the queries of a kv
head are stacked into one [rep * T, D] operand, and a lone row is
duplicated (the JAX package duplicates its Q = 1 row for XLA's sake).
GQA heads read the cache through that stacking instead of expanding it.
A cache narrower than ``attention_ops.MIN_KEYS`` is padded with masked
columns as the uncached forward pads its keys.

All three are inference-only (``grad=None``).
"""
from __future__ import annotations

import torch

from .attention_ops import pad_keys
from .registry import in_var, register_op, set_out


def _kv_write_infer(op, block):
    c = in_var(op, block, "Cache")
    set_out(op, block, "Out", c.shape, c.dtype)


def _write_target(ctx, op) -> torch.Tensor:
    """The tensor the op writes into: the cache itself where this run
    may update it in place, else a copy of it."""
    cache = ctx.get_input(op, "Cache")
    name = op.single_output("Out")
    if name in ctx.in_place and name == op.single_input("Cache"):
        return cache
    return cache.clone()


@register_op("kv_cache_write", infer=_kv_write_infer, grad=None,
             stateful_outputs=("Out",))
def _kv_cache_write(ctx, op):
    """Cache [B, Hkv, S_max, D], New [B, Hkv, T, D], Positions [B] int:
    row b's T fresh rows land at sequence offset positions[b]
    (clamped to S_max - T)."""
    out = _write_target(ctx, op)
    new = ctx.get_input(op, "New")
    pos = ctx.get_input(op, "Positions")
    B, S, T = out.shape[0], out.shape[2], new.shape[2]
    start = pos.to(torch.long).clamp(0, S - T)
    rows = torch.arange(B, device=out.device)[:, None]
    cols = start[:, None] + torch.arange(T, device=out.device)[None, :]
    # indices [B, 1] and [B, T] around a slice: the indexed view is
    # [B, T, Hkv, D]
    out[rows, :, cols] = new.to(out.dtype).permute(0, 2, 1, 3)
    ctx.set_output(op, "Out", out)


@register_op("kv_cache_insert", infer=_kv_write_infer, grad=None,
             stateful_outputs=("Out",))
def _kv_cache_insert(ctx, op):
    """Prefill insert: Cache [slots, Hkv, S_max, D] gets New
    [1, Hkv, S_b, D] at slot Slot[0] (clamped to the slots), sequence
    offset 0."""
    out = _write_target(ctx, op)
    new = ctx.get_input(op, "New")
    slot = ctx.get_input(op, "Slot").to(torch.long).reshape(1).clamp(
        0, out.shape[0] - 1)
    out[slot, :, :new.shape[2]] = new.to(out.dtype)
    ctx.set_output(op, "Out", out)


def _cached_attn_infer(op, block):
    q = in_var(op, block, "Q")
    set_out(op, block, "Out", q.shape, q.dtype)


def _grouped_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., M, K] @ b [..., K, N], with a lone row (M = 1) computed as
    the first row of a two-row product: the GEMM path every row of a
    longer product takes."""
    if a.shape[-2] == 1:
        return torch.matmul(torch.cat([a, a], dim=-2), b)[..., :1, :]
    return torch.matmul(a, b)


@register_op("cached_attention", infer=_cached_attn_infer, grad=None)
def _cached_attention(ctx, op):
    """Q [B, H, T, D] over caches K/V [B, Hkv, S_max, D]; Positions [B]
    is the pre-step sequence length (row b's query t sits at position
    positions[b] + t and attends columns j <= positions[b] + t).  Query
    head h reads kv head h // (H / Hkv), as the uncached block's
    repeat-interleave expansion pairs them."""
    q = ctx.get_input(op, "Q")
    k = ctx.get_input(op, "K")
    v = ctx.get_input(op, "V")
    pos = ctx.get_input(op, "Positions").to(torch.long)
    B, H, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    rep = H // Hkv
    scale = op.attr("scale", None)
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    k, v = pad_keys(k, v)  # as the uncached forward pads a short S
    Sp = k.shape[2]
    qg = q.reshape(B, Hkv, rep * T, D)  # head g * rep + r -> row r * T + t
    s = _grouped_matmul(qg, k.transpose(-1, -2)).reshape(B, H, T, Sp)
    s = s * scale
    j = torch.arange(Sp, device=q.device)
    t = torch.arange(T, device=q.device)
    limit = pos[:, None, None, None] + t[None, None, :, None]
    # in place on the fresh scores: masked_fill would copy them first
    s.masked_fill_((j > limit) | (j >= S), -1e30)
    p = torch.softmax(s, dim=-1)
    out = _grouped_matmul(p.reshape(B, Hkv, rep * T, Sp), v)
    ctx.set_output(op, "Out", out.reshape(B, H, T, D).to(q.dtype))
