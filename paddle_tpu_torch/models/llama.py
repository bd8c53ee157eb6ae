"""Llama-style decoder LM (BASELINE config "Llama-2-7B"): training and the
uncached full forward.

Counterpart of ``paddle_tpu/models/llama.py:39-200``, built with the same
layers, op types, attrs and parameter names.  Architecture: pre-RMSNorm,
fused QKV with GQA (K/V expanded by ``tile``), RoPE, causal
``flash_attention`` (the Hopper kernels on the card), SwiGLU MLP, untied
LM head.  Weights stay float32 in the scope; bf16 AMP lowers the matmuls
and the attention to bfloat16.

The KV-cache modes of ``llama_block`` (``kv_cache``, ``collect_kv``,
``block_table``) and the generation builders (prefill, decode, chunked
prefill, verify) are not ported: the cache arguments raise
NotImplementedError.
"""
from __future__ import annotations

from .. import layers

__all__ = ["llama_block", "llama", "build_llama_train",
           "build_llama_forward"]


def _linear(x, size, pname=None, name=None):
    return layers.fc(x, size, num_flatten_dims=2, bias_attr=False,
                     param_attr=pname, name=name)


def llama_block(x, hidden, num_heads, num_kv_heads, seq_len, head_dim,
                intermediate, name=None, attn_impl="auto",
                kv_cache=None, positions=None, collect_kv=False,
                block_table=None, kv_lengths=None):
    """One decoder layer. x: [B, S, H].

    ``name`` prefixes every parameter deterministically.  ``attn_impl``
    feeds the flash_attention op's impl switch.  The cache modes
    (``kv_cache`` with ``positions``, ``block_table`` / ``kv_lengths``,
    ``collect_kv``) belong to generation, which is not ported: they
    raise NotImplementedError."""
    if kv_cache is not None or positions is not None or collect_kv or \
            block_table is not None or kv_lengths is not None:
        raise NotImplementedError(
            "llama_block's KV-cache modes (kv_cache / positions, "
            "block_table / kv_lengths, collect_kv) serve generation, which "
            "the port does not have yet")
    q_size = num_heads * head_dim
    kv_size = num_kv_heads * head_dim
    p = (lambda s: f"{name}.{s}") if name else (lambda s: None)
    h = layers.rms_norm(x, param_attr=p("ln1"))
    qkv = _linear(h, q_size + 2 * kv_size, pname=p("qkv.w"))
    q = layers.slice(qkv, axes=[2], starts=[0], ends=[q_size])
    k = layers.slice(qkv, axes=[2], starts=[q_size],
                     ends=[q_size + kv_size])
    v = layers.slice(qkv, axes=[2], starts=[q_size + kv_size],
                     ends=[q_size + 2 * kv_size])

    def heads(t, n):
        t = layers.reshape(t, [0, seq_len, n, head_dim])
        return layers.transpose(t, [0, 2, 1, 3])  # [B,n,S,D]

    q, k, v = heads(q, num_heads), heads(k, num_kv_heads), \
        heads(v, num_kv_heads)
    q = layers.rope(q)
    k = layers.rope(k)
    if num_kv_heads != num_heads:
        # repeat_interleave-style expansion [k1,k1,..,k2,k2,..]: query-head
        # group g maps to kv head g // rep, as canonical Llama GQA does
        rep = num_heads // num_kv_heads

        def expand_kv(t):
            t = layers.reshape(t, [0, num_kv_heads, 1, seq_len, head_dim])
            t = layers.tile(t, [1, 1, rep, 1, 1])
            return layers.reshape(t, [0, num_heads, seq_len, head_dim])

        k, v = expand_kv(k), expand_kv(v)
    attn = layers.flash_attention(q, k, v, causal=True, impl=attn_impl)
    attn = layers.transpose(attn, [0, 2, 1, 3])
    attn = layers.reshape(attn, [0, seq_len, q_size])
    x = layers.elementwise_add(x, _linear(attn, hidden,
                                          pname=p("attn_out.w")))

    h = layers.rms_norm(x, param_attr=p("ln2"))
    gate_up = _linear(h, 2 * intermediate, pname=p("gate_up.w"))
    gate = layers.slice(gate_up, axes=[2], starts=[0], ends=[intermediate])
    up = layers.slice(gate_up, axes=[2], starts=[intermediate],
                      ends=[2 * intermediate])
    ffn = layers.elementwise_mul(layers.silu(gate), up)
    return layers.elementwise_add(x, _linear(ffn, hidden,
                                             pname=p("ffn_out.w")))


def llama(input_ids, vocab_size=32000, hidden=4096, num_layers=32,
          num_heads=32, num_kv_heads=None, intermediate=11008,
          seq_len=2048, name=None, attn_impl="auto"):
    """Returns logits [B, S, V]. input_ids: [B, S] int64."""
    num_kv_heads = num_kv_heads or num_heads
    head_dim = hidden // num_heads
    p = (lambda s: f"{name}.{s}") if name else (lambda s: None)
    x = layers.embedding(input_ids, size=[vocab_size, hidden],
                         param_attr=p("embed"))
    for i in range(num_layers):
        x = llama_block(x, hidden, num_heads, num_kv_heads, seq_len,
                        head_dim, intermediate,
                        name=f"{name}.blk{i}" if name else None,
                        attn_impl=attn_impl)
    x = layers.rms_norm(x, param_attr=p("ln_f"))
    return _linear(x, vocab_size, pname=p("head.w"))


def build_llama_train(batch_size=None, seq_len=2048, vocab_size=32000,
                      hidden=4096, num_layers=32, num_heads=32,
                      num_kv_heads=None, intermediate=11008):
    """Causal-LM training graph: feeds input_ids + labels [B, S]."""
    b = -1 if batch_size is None else batch_size
    input_ids = layers.data("input_ids", [b, seq_len], dtype="int64",
                            append_batch_size=False)
    labels = layers.data("labels", [b, seq_len], dtype="int64",
                         append_batch_size=False)
    logits = llama(input_ids, vocab_size, hidden, num_layers, num_heads,
                   num_kv_heads, intermediate, seq_len)
    loss = layers.softmax_with_cross_entropy(
        logits, layers.unsqueeze(labels, [2]))
    mean_loss = layers.mean(layers.squeeze(loss, [2]))
    return ["input_ids", "labels"], {"loss": mean_loss, "logits": logits}


def build_llama_forward(batch_size, seq_len, vocab_size=32000,
                        hidden=4096, num_layers=32, num_heads=32,
                        num_kv_heads=None, intermediate=11008,
                        name="llama", attn_impl="auto"):
    """Uncached full forward: feeds input_ids [B, S], fetches logits
    [B, S, V] (causal: row i depends only on tokens <= i)."""
    input_ids = layers.data("input_ids", [batch_size, seq_len],
                            dtype="int64", append_batch_size=False)
    logits = llama(input_ids, vocab_size, hidden, num_layers, num_heads,
                   num_kv_heads, intermediate, seq_len, name=name,
                   attn_impl=attn_impl)
    return ["input_ids"], {"logits": logits}
