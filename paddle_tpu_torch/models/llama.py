"""Llama-style decoder LM (BASELINE config "Llama-2-7B"): training, the
uncached full forward, and generation's prefill, cached decode and
prefill chunk over a dense per-slot KV cache or block-paged pools.

Counterpart of ``paddle_tpu/models/llama.py:39-464``, built with the same
layers, op types, attrs and parameter names.  Architecture: pre-RMSNorm,
fused QKV with GQA (K/V expanded by ``tile``), RoPE, causal
``flash_attention`` (the Hopper kernels on the card), SwiGLU MLP, untied
LM head.  Weights stay float32 in the scope; bf16 AMP lowers the matmuls
and the attention to bfloat16.

``llama_block`` also runs in the cache modes: ``collect_kv=True``
(prefill: the post-RoPE, pre-expansion K/V come back as outputs) and
``kv_cache=(cache_k, cache_v)`` with ``positions`` (cached decode:
``kv_cache_write`` then ``cached_attention``; with ``block_table`` /
``kv_lengths`` the caches are paged pools: ``kv_pool_write``, then
``kv_pool_gather`` into the dense layout, then ``cached_attention``).
With a ``name`` prefix every parameter gets a deterministic name, so the
forward, prefill, decode and chunk programs built in one process bind
the same scope weights.  ``build_llama_verify`` is the chunk's forward
fetching every row's argmax and logits: speculative decoding scores a
draft with it.
"""
from __future__ import annotations

from .. import layers
from ..framework.core import default_main_program

__all__ = ["llama_block", "llama", "build_llama_train",
           "build_llama_forward", "build_llama_prefill",
           "build_llama_decode", "build_llama_prefill_chunk",
           "build_llama_verify"]


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
        (``cached_attention``); returns x.  With ``block_table`` [B, NP]
        and ``kv_lengths`` [B] the caches are block-paged pools [P, n_kv,
        page_tokens, D]: the K/V scatter into the slots' pages
        (``kv_pool_write``) and attention runs over the gathered logical
        view (``kv_pool_gather`` -> ``cached_attention``, the products
        the dense path runs).  ``seq_len`` > 1 there is a prefill chunk:
        S new tokens from ``positions[b]`` attend the cache and
        themselves causally.
      * ``collect_kv=True`` — prefill: returns ``(x, k, v)`` where k/v
        are the post-RoPE [B, n_kv, S, D] cache rows.
    """
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
        if block_table is not None:
            # paged: write first, then gather, so the fresh rows are in
            # the view (the mask admits j <= positions[b] + t)
            pool_k = layers.kv_pool_write(kv_cache[0], k, positions,
                                          block_table, kv_lengths)
            pool_v = layers.kv_pool_write(kv_cache[1], v, positions,
                                          block_table, kv_lengths)
            cache_k = layers.kv_pool_gather(pool_k, block_table)
            cache_v = layers.kv_pool_gather(pool_v, block_table)
        else:
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


def _pool_var(block, name, num_pages, num_kv_heads, page_tokens,
              head_dim):
    return _cache_var(block, name, [num_pages, num_kv_heads, page_tokens,
                                    head_dim])


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
      ``slot`` [1] int32 (``kv_cache_insert``, in place).  With
      ``paged=True`` they go into the pools ``<name>.pool_{k,v}_<i>``
      [num_pages, n_kv, page_tokens, D] instead, from logical position 0
      through ``block_table`` [1, NP] int32, with ``prompt_len`` [1]
      int32 in place of ``slot``: rows at or past it go to the trash
      page.  The forward is the same graph either way, so paged prefill
      logits equal dense ones bit for bit.
    * omitted: per-layer ``k_i`` / ``v_i`` [B, n_kv, S, D] come back as
      extra fetches.

    Causal attention keeps pad-tail rows from touching the real ones;
    the engine masks them out of the cache through per-slot positions.
    """
    num_kv_heads = num_kv_heads or num_heads
    head_dim = hidden // num_heads
    input_ids = layers.data("input_ids", [batch_size, seq_len],
                            dtype="int64", append_batch_size=False)
    last_pos = layers.data("last_pos", [batch_size], dtype="int64",
                           append_batch_size=False)
    feeds = ["input_ids", "last_pos"]
    slot = block_table = prompt_len = zero_pos = None
    if cache_slots is not None:
        if batch_size != 1:
            raise ValueError("in-graph cache insert prefills one "
                             "request at a time (batch_size must be 1)")
        if max_seq_len is None or seq_len > max_seq_len:
            raise ValueError(f"prefill bucket {seq_len} exceeds cache "
                             f"max_seq_len {max_seq_len}")
        if paged:
            if not num_pages or not page_tokens:
                raise ValueError("paged prefill needs num_pages and "
                                 "page_tokens")
            block_table = layers.data(
                "block_table", [1, max_seq_len // page_tokens],
                dtype="int32", append_batch_size=False)
            prompt_len = layers.data("prompt_len", [1], dtype="int32",
                                     append_batch_size=False)
            feeds += ["block_table", "prompt_len"]
            zero_pos = layers.fill_constant([1], "int32", 0)
        else:
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
        if block_table is not None:
            for kind, t in (("k", k), ("v", v)):
                pool = _pool_var(block, f"{name}.pool_{kind}_{i}",
                                 num_pages, num_kv_heads, page_tokens,
                                 head_dim)
                layers.kv_pool_write(pool, t, zero_pos, block_table,
                                     prompt_len)
        elif slot is not None:
            for kind, t in (("k", k), ("v", v)):
                cache = _cache_var(block, f"{name}.cache_{kind}_{i}",
                                   [cache_slots, num_kv_heads, max_seq_len,
                                    head_dim])
                layers.kv_cache_insert(cache, t, slot)
        else:
            kvs.append((k, v))
    fetches = _head(x, vocab_size, name, batch_size, last_pos)
    for i, (k, v) in enumerate(kvs):
        fetches[f"k_{i}"] = k
        fetches[f"v_{i}"] = v
    return feeds, fetches


def _all_logits(x, vocab_size, name):
    """Final norm and the LM head over every row: [B, S, V]."""
    x = layers.rms_norm(x, param_attr=f"{name}.ln_f")
    return _linear(x, vocab_size, pname=f"{name}.head.w")


def _head(x, vocab_size, name, batch_size, last_pos):
    """Final norm, the LM head over every row, then each row's last real
    position: the head's product has the uncached forward's rows.
    {"logits": [B, V], "next_token": [B] int64}."""
    all_logits = _all_logits(x, vocab_size, name)
    rows = layers.range(0, batch_size, 1, dtype="int64")     # [B]
    coords = layers.stack([rows, last_pos], axis=1)          # [B, 2]
    logits = layers.gather_nd(all_logits, coords)            # [B, V]
    next_token = layers.argmax(logits, axis=-1)              # [B] int64
    return {"logits": logits, "next_token": next_token}


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

    ``paged=True`` reads and writes the pools ``<name>.pool_{k,v}_<i>``
    [num_pages, n_kv, page_tokens, D] instead, with two more feeds:
    ``block_tables`` [slots, NP] int32 (NP = max_seq_len // page_tokens)
    and ``live`` [slots] int32 (1: the slot decodes this step; 0: idle,
    its write goes to the trash page).

    Returns ``(feed_names, fetches, cache_names)``."""
    num_kv_heads = num_kv_heads or num_heads
    head_dim = hidden // num_heads
    tokens = layers.data("tokens", [num_slots, 1], dtype="int64",
                         append_batch_size=False)
    positions = layers.data("positions", [num_slots], dtype="int32",
                            append_batch_size=False)
    feeds = ["tokens", "positions"]
    block_tables = live = None
    if paged:
        if not num_pages or not page_tokens:
            raise ValueError("paged decode needs num_pages and page_tokens")
        block_tables = layers.data(
            "block_tables", [num_slots, max_seq_len // page_tokens],
            dtype="int32", append_batch_size=False)
        live = layers.data("live", [num_slots], dtype="int32",
                           append_batch_size=False)
        feeds += ["block_tables", "live"]
    block = default_main_program().global_block()
    caches, cache_names = [], []
    for i in range(num_layers):
        if paged:
            ck, cv = (_pool_var(block, f"{name}.pool_{kind}_{i}", num_pages,
                                num_kv_heads, page_tokens, head_dim)
                      for kind in ("k", "v"))
        else:
            shape = [num_slots, num_kv_heads, max_seq_len, head_dim]
            ck = _cache_var(block, f"{name}.cache_k_{i}", shape)
            cv = _cache_var(block, f"{name}.cache_v_{i}", shape)
        caches.append((ck, cv))
        cache_names += [ck.name, cv.name]
    x = layers.embedding(tokens, size=[vocab_size, hidden],
                         param_attr=f"{name}.embed")
    for i, (ck, cv) in enumerate(caches):
        x = llama_block(x, hidden, num_heads, num_kv_heads, 1, head_dim,
                        intermediate, name=f"{name}.blk{i}",
                        kv_cache=(ck, cv), positions=positions,
                        block_table=block_tables, kv_lengths=live)
    x = layers.rms_norm(x, param_attr=f"{name}.ln_f")
    logits = _linear(x, vocab_size, pname=f"{name}.head.w")  # [slots,1,V]
    logits = layers.squeeze(logits, [1])                     # [slots, V]
    next_token = layers.argmax(logits, axis=-1)              # [slots]
    return feeds, {"logits": logits, "next_token": next_token}, cache_names


def _chunk_forward(chunk_len, max_seq_len, num_pages, page_tokens,
                   vocab_size, hidden, num_layers, num_heads, num_kv_heads,
                   intermediate, name):
    """The chunk's feeds (``chunk_ids``, ``base``, ``block_table``,
    ``chunk_len``), pools and blocks: (feed names, hidden rows [1, C, H]
    before the final norm, cache names)."""
    num_kv_heads = num_kv_heads or num_heads
    head_dim = hidden // num_heads
    chunk_ids = layers.data("chunk_ids", [1, chunk_len], dtype="int64",
                            append_batch_size=False)
    base = layers.data("base", [1], dtype="int32", append_batch_size=False)
    block_table = layers.data("block_table",
                              [1, max_seq_len // page_tokens],
                              dtype="int32", append_batch_size=False)
    ck_len = layers.data("chunk_len", [1], dtype="int32",
                         append_batch_size=False)
    block = default_main_program().global_block()
    caches, cache_names = [], []
    for i in range(num_layers):
        ck, cv = (_pool_var(block, f"{name}.pool_{kind}_{i}", num_pages,
                            num_kv_heads, page_tokens, head_dim)
                  for kind in ("k", "v"))
        caches.append((ck, cv))
        cache_names += [ck.name, cv.name]
    x = layers.embedding(chunk_ids, size=[vocab_size, hidden],
                         param_attr=f"{name}.embed")
    for i, (ck, cv) in enumerate(caches):
        # rope offset = base; cached_attention's mask (j <= base + t) is
        # causal over the pages so far and the chunk
        x = llama_block(x, hidden, num_heads, num_kv_heads, chunk_len,
                        head_dim, intermediate, name=f"{name}.blk{i}",
                        kv_cache=(ck, cv), positions=base,
                        block_table=block_table, kv_lengths=ck_len)
    return ["chunk_ids", "base", "block_table", "chunk_len"], x, cache_names


def build_llama_prefill_chunk(chunk_len, max_seq_len, num_pages,
                              page_tokens, vocab_size=32000,
                              hidden=4096, num_layers=32, num_heads=32,
                              num_kv_heads=None, intermediate=11008,
                              name="llama"):
    """Paged prefill continuation: one slice of a prompt attends the
    slot's pages so far plus itself causally.  The program behind both
    chunked prefill (a long prompt fed in slices, decode steps between
    them) and prefix reuse (a prefix hit maps the shared pages and only
    the prompt's tail runs here).

    Feeds: ``chunk_ids`` [1, C] int64 (right-padded slice), ``base`` [1]
    int32 (tokens already in the slot's pages: the chunk's first logical
    position), ``block_table`` [1, NP] int32, ``chunk_len`` [1] int32
    (real rows; the pad tail writes to the trash page) and ``last_off``
    [1] int64 (the last real row).  Fetches: ``logits`` [1, V] at
    ``last_off`` and greedy ``next_token`` [1], which mean something
    only for a prompt's last chunk.

    Returns ``(feed_names, fetches, cache_names)``."""
    feeds, x, cache_names = _chunk_forward(
        chunk_len, max_seq_len, num_pages, page_tokens, vocab_size, hidden,
        num_layers, num_heads, num_kv_heads, intermediate, name)
    last_off = layers.data("last_off", [1], dtype="int64",
                           append_batch_size=False)
    return (feeds + ["last_off"], _head(x, vocab_size, name, 1, last_off),
            cache_names)


def build_llama_verify(chunk_len, max_seq_len, num_pages, page_tokens,
                       vocab_size=32000, hidden=4096, num_layers=32,
                       num_heads=32, num_kv_heads=None, intermediate=11008,
                       name="llama"):
    """Speculative decoding's verifier: the chunk forward of
    :func:`build_llama_prefill_chunk` fetching every row's greedy argmax
    and logits instead of one gathered row.

    The chunk holds ``[pending token, draft_1 .. draft_K]`` at ``base`` =
    the slot's committed position; row t's argmax is the token a decode
    step would emit after the chunk's first t + 1 tokens, so the longest
    prefix with ``draft_{t+1} == argmax(row t)``, plus the token the row
    after it gives, is the plain greedy stream.  Rows write their K/V to
    the slot's pages as a chunk does (``chunk_len`` sends the pad tail to
    the trash page); a rejected row's K/V lies past the committed
    position, outside every later step's validity mask (``j <= base +
    t``), until the next real write there replaces it.

    Feeds: ``chunk_ids`` [1, C] int64, ``base`` [1] int32,
    ``block_table`` [1, NP] int32, ``chunk_len`` [1] int32.  Fetches:
    ``tokens`` [1, C] int64 and ``logits`` [1, C, V].  The head projects
    every row before the argmax, as the decode step's head does.

    Returns ``(feed_names, fetches, cache_names)``."""
    feeds, x, cache_names = _chunk_forward(
        chunk_len, max_seq_len, num_pages, page_tokens, vocab_size, hidden,
        num_layers, num_heads, num_kv_heads, intermediate, name)
    all_logits = _all_logits(x, vocab_size, name)
    tokens = layers.argmax(all_logits, axis=-1)              # [1, C]
    return feeds, {"logits": all_logits, "tokens": tokens}, cache_names
