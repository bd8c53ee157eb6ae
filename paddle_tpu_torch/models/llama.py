"""Llama-style decoder LM (BASELINE config "Llama-2-7B"): training, the
uncached full forward, and generation's prefill and cached decode with a
dense per-slot KV cache.

Counterpart of ``paddle_tpu/models/llama.py:39-392``, built with the same
layers, op types, attrs and parameter names.  Architecture: pre-RMSNorm,
fused QKV with GQA (K/V expanded by ``tile``), RoPE, causal
``flash_attention`` (the Hopper kernels on the card), SwiGLU MLP, untied
LM head.  Weights stay float32 in the scope; bf16 AMP lowers the matmuls
and the attention to bfloat16.

``llama_block`` also runs in the dense cache modes: ``collect_kv=True``
(prefill: the post-RoPE, pre-expansion K/V come back as outputs) and
``kv_cache=(cache_k, cache_v)`` with ``positions`` (cached decode:
``kv_cache_write`` then ``cached_attention``).  With a ``name`` prefix
every parameter gets a deterministic name, so the forward, prefill and
decode programs built in one process bind the same scope weights.  The
block-paged cache (``block_table`` / ``kv_lengths``, ``paged=True``),
chunked prefill and speculative verify are not ported: they raise
NotImplementedError.
"""
from __future__ import annotations

from .. import layers
from ..framework.core import default_main_program

__all__ = ["llama_block", "llama", "build_llama_train",
           "build_llama_forward", "build_llama_prefill",
           "build_llama_decode"]

_PAGED = ("the block-paged KV cache (kv_pool_write / kv_pool_gather, "
          "block tables) is not ported yet; use the dense cache "
          "(ROADMAP.md queue 1 item 2)")


def _linear(x, size, pname=None, name=None):
    return layers.fc(x, size, num_flatten_dims=2, bias_attr=False,
                     param_attr=pname, name=name)


def llama_block(x, hidden, num_heads, num_kv_heads, seq_len, head_dim,
                intermediate, name=None, attn_impl="auto",
                kv_cache=None, positions=None, collect_kv=False,
                block_table=None, kv_lengths=None):
    """One decoder layer. x: [B, S, H].

    ``name`` prefixes every parameter deterministically (required when
    several programs share one scope).  ``attn_impl`` feeds the
    flash_attention op's impl switch ("auto" | "xla").

    Cache modes (mutually exclusive):
      * ``kv_cache=(cache_k, cache_v)`` with ``positions`` [B] int32 —
        cached decode: writes the step's K/V into the caches
        (``kv_cache_write``, in place) and attends over them
        (``cached_attention``); returns x.  ``block_table`` /
        ``kv_lengths`` (the paged pools) raise NotImplementedError.
      * ``collect_kv=True`` — prefill: returns ``(x, k, v)`` where k/v
        are the post-RoPE [B, n_kv, S, D] cache rows.
    """
    if block_table is not None or kv_lengths is not None:
        raise NotImplementedError(f"llama_block: {_PAGED}")
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
    offset = positions if kv_cache is not None else None
    q = layers.rope(q, offset=offset)
    k = layers.rope(k, offset=offset)
    if kv_cache is not None:
        # cached decode: write this step's K/V at each slot's position,
        # then attend the new token(s) over the whole (updated) cache;
        # GQA pairs heads inside cached_attention
        cache_k = layers.kv_cache_write(kv_cache[0], k, positions)
        cache_v = layers.kv_cache_write(kv_cache[1], v, positions)
        attn = layers.cached_attention(q, cache_k, cache_v, positions)
    else:
        new_k, new_v = k, v  # pre-expansion rows are what a cache stores
        if num_kv_heads != num_heads:
            # repeat_interleave-style expansion [k1,k1,..,k2,k2,..]:
            # query-head group g maps to kv head g // rep, as canonical
            # Llama GQA does
            rep = num_heads // num_kv_heads

            def expand_kv(t):
                t = layers.reshape(t, [0, num_kv_heads, 1, seq_len,
                                       head_dim])
                t = layers.tile(t, [1, 1, rep, 1, 1])
                return layers.reshape(t, [0, num_heads, seq_len,
                                          head_dim])

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
    out = layers.elementwise_add(x, _linear(ffn, hidden,
                                            pname=p("ffn_out.w")))
    if collect_kv:
        return out, new_k, new_v
    return out


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
    [B, S, V] (causal: row i depends only on tokens <= i, so one run
    yields every decode step's reference logits)."""
    input_ids = layers.data("input_ids", [batch_size, seq_len],
                            dtype="int64", append_batch_size=False)
    logits = llama(input_ids, vocab_size, hidden, num_layers, num_heads,
                   num_kv_heads, intermediate, seq_len, name=name,
                   attn_impl=attn_impl)
    return ["input_ids"], {"logits": logits}


def _cache_var(block, name, shape):
    return block.create_var(name=name, persistable=True, shape=shape,
                            dtype="float32", stop_gradient=True)


def build_llama_prefill(batch_size, seq_len, vocab_size=32000,
                        hidden=4096, num_layers=32, num_heads=32,
                        num_kv_heads=None, intermediate=11008,
                        name="llama", attn_impl="auto",
                        cache_slots=None, max_seq_len=None,
                        paged=False, num_pages=None, page_tokens=None):
    """Prefill: one causal forward over the (right-padded) prompt that
    fills a decode cache in one shot.

    Feeds: ``input_ids`` [B, S] int64 and ``last_pos`` [B] int64 (index
    of the last real token).  Fetches: ``logits`` [B, V] (next-token
    logits at last_pos) and greedy ``next_token`` [B] int64.

    * ``cache_slots`` / ``max_seq_len`` given (the serving engine's path;
      ``batch_size`` 1): the per-layer post-RoPE K/V go in-graph into
      the shared decode caches ``<name>.cache_{k,v}_<i>`` at slot
      ``slot`` [1] int32 (``kv_cache_insert``, in place).
    * omitted: per-layer ``k_i`` / ``v_i`` [B, n_kv, S, D] come back as
      extra fetches.
    ``paged=True`` (the block-paged pools) raises NotImplementedError.

    Causal attention keeps pad-tail rows from touching the real ones;
    the engine masks them out of the cache through per-slot positions.
    """
    if paged:
        raise NotImplementedError(f"build_llama_prefill: {_PAGED}")
    num_kv_heads = num_kv_heads or num_heads
    head_dim = hidden // num_heads
    input_ids = layers.data("input_ids", [batch_size, seq_len],
                            dtype="int64", append_batch_size=False)
    last_pos = layers.data("last_pos", [batch_size], dtype="int64",
                           append_batch_size=False)
    feeds = ["input_ids", "last_pos"]
    slot = None
    if cache_slots is not None:
        if batch_size != 1:
            raise ValueError("in-graph cache insert prefills one "
                             "request at a time (batch_size must be 1)")
        if max_seq_len is None or seq_len > max_seq_len:
            raise ValueError(f"prefill bucket {seq_len} exceeds cache "
                             f"max_seq_len {max_seq_len}")
        slot = layers.data("slot", [1], dtype="int32",
                           append_batch_size=False)
        feeds.append("slot")
    x = layers.embedding(input_ids, size=[vocab_size, hidden],
                         param_attr=f"{name}.embed")
    kvs = []
    block = default_main_program().global_block()
    for i in range(num_layers):
        x, k, v = llama_block(x, hidden, num_heads, num_kv_heads,
                              seq_len, head_dim, intermediate,
                              name=f"{name}.blk{i}", attn_impl=attn_impl,
                              collect_kv=True)
        if slot is not None:
            for kind, t in (("k", k), ("v", v)):
                cache = _cache_var(block, f"{name}.cache_{kind}_{i}",
                                   [cache_slots, num_kv_heads, max_seq_len,
                                    head_dim])
                layers.kv_cache_insert(cache, t, slot)
        else:
            kvs.append((k, v))
    x = layers.rms_norm(x, param_attr=f"{name}.ln_f")
    # the LM head over every row, then each row's last real position: the
    # head's product has the uncached forward's rows (a one-row product
    # would sum in another order, see ops/decode_ops.py)
    all_logits = _linear(x, vocab_size, pname=f"{name}.head.w")
    rows = layers.range(0, batch_size, 1, dtype="int64")     # [B]
    coords = layers.stack([rows, last_pos], axis=1)          # [B, 2]
    logits = layers.gather_nd(all_logits, coords)            # [B, V]
    next_token = layers.argmax(logits, axis=-1)              # [B] int64
    fetches = {"logits": logits, "next_token": next_token}
    for i, (k, v) in enumerate(kvs):
        fetches[f"k_{i}"] = k
        fetches[f"v_{i}"] = v
    return feeds, fetches


def build_llama_decode(num_slots, max_seq_len, vocab_size=32000,
                       hidden=4096, num_layers=32, num_heads=32,
                       num_kv_heads=None, intermediate=11008,
                       name="llama", paged=False, num_pages=None,
                       page_tokens=None):
    """Cached decode step over a fixed slot grid.

    Feeds: ``tokens`` [slots, 1] int64 (each slot's current token) and
    ``positions`` [slots] int32 (each slot's pre-step sequence length,
    the cache offset this step writes at).  The per-layer caches
    ``<name>.cache_k_<i>`` / ``.cache_v_<i>`` [slots, n_kv, S_max, D] are
    persistable state the step reads and updates in place.  Fetches:
    ``logits`` [slots, V] and greedy ``next_token`` [slots] int64.
    ``paged=True`` raises NotImplementedError.

    Returns ``(feed_names, fetches, cache_names)``."""
    if paged:
        raise NotImplementedError(f"build_llama_decode: {_PAGED}")
    num_kv_heads = num_kv_heads or num_heads
    head_dim = hidden // num_heads
    tokens = layers.data("tokens", [num_slots, 1], dtype="int64",
                         append_batch_size=False)
    positions = layers.data("positions", [num_slots], dtype="int32",
                            append_batch_size=False)
    block = default_main_program().global_block()
    shape = [num_slots, num_kv_heads, max_seq_len, head_dim]
    caches, cache_names = [], []
    for i in range(num_layers):
        ck = _cache_var(block, f"{name}.cache_k_{i}", shape)
        cv = _cache_var(block, f"{name}.cache_v_{i}", shape)
        caches.append((ck, cv))
        cache_names += [ck.name, cv.name]
    x = layers.embedding(tokens, size=[vocab_size, hidden],
                         param_attr=f"{name}.embed")
    for i, (ck, cv) in enumerate(caches):
        x = llama_block(x, hidden, num_heads, num_kv_heads, 1, head_dim,
                        intermediate, name=f"{name}.blk{i}",
                        kv_cache=(ck, cv), positions=positions)
    x = layers.rms_norm(x, param_attr=f"{name}.ln_f")
    logits = _linear(x, vocab_size, pname=f"{name}.head.w")  # [slots,1,V]
    logits = layers.squeeze(logits, [1])                     # [slots, V]
    next_token = layers.argmax(logits, axis=-1)              # [slots]
    return ["tokens", "positions"], \
        {"logits": logits, "next_token": next_token}, cache_names
