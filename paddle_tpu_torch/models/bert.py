"""BERT/ERNIE-base encoder + pretraining heads.

Counterpart of ``paddle_tpu/models/bert.py``: the same layers in the same
order, so the program matches the JAX package's op for op, name for
name, for serving (``is_test=True``) and for training (``dropout`` on the
embeddings, the attention output and the FFN output).  Attention takes
the JAX package's four branches:

* ``use_flash=True`` at hidden % 128 == 0 and head_dim 64 or 128: the
  packed ``flash_attention_qkv`` op (its kernels read the fused
  projection in place);
* ``use_flash=True`` at other widths (MiniLM's head_dim 32): heads split
  by reshape / transpose / slice, then the unpacked ``flash_attention``
  op;
* ``use_flash="xla"``: the einsum formulation (``flash_attention
  impl="xla"``, layout ``bshd``), with in-op probability dropout unless
  ``PT_BERT_NO_PROB_DROPOUT`` is set;
* ``use_flash=False``: the unfused one, ``matmul`` with alpha, the
  ``[B, 1, 1, S]`` bias, ``softmax``, probability ``dropout``, ``matmul``.

The flash branches fold out attention-probability dropout, as the JAX
package does (output dropout kept).
"""
from __future__ import annotations

import math
import os
import warnings

from .. import layers


def _attention(x, hidden, num_heads, seq_len, attn_bias=None, dropout=0.0,
               is_test=False, use_flash=True):
    """Multi-head self-attention. x: [-1, S, H]."""
    head_dim = hidden // num_heads
    qkv = layers.fc(x, size=3 * hidden, num_flatten_dims=2)  # [B,S,3H]
    if use_flash is True and dropout and not is_test:
        warnings.warn(
            "bert: flash attention folds out attention-probability "
            "dropout (output dropout kept); use use_flash=False for "
            "exact reference regularization", stacklevel=3)
    if use_flash is True and hidden % 128 == 0 and head_dim in (64, 128):
        # packed path: the kernels read the fused projection in place
        ctx = layers.flash_attention_qkv(qkv, num_heads, bias=attn_bias)
        return layers.fc(ctx, size=hidden, num_flatten_dims=2)
    if use_flash == "xla":
        # [B,S,h,d] throughout: the einsum formulation takes layout bshd
        qkv = layers.reshape(qkv, [0, seq_len, 3, num_heads, head_dim])
        q = layers.squeeze(
            layers.slice(qkv, axes=[2], starts=[0], ends=[1]), [2])
        k = layers.squeeze(
            layers.slice(qkv, axes=[2], starts=[1], ends=[2]), [2])
        v = layers.squeeze(
            layers.slice(qkv, axes=[2], starts=[2], ends=[3]), [2])
        prob_drop = (0.0 if os.environ.get("PT_BERT_NO_PROB_DROPOUT")
                     else dropout)
        ctx = layers.flash_attention(
            q, k, v, bias=attn_bias, impl="xla", layout="bshd",
            dropout_prob=prob_drop, is_test=is_test)   # [B,S,h,d]
        ctx = layers.reshape(ctx, [0, seq_len, hidden])
        return layers.fc(ctx, size=hidden, num_flatten_dims=2)
    qkv = layers.reshape(qkv, [0, seq_len, 3, num_heads, head_dim])
    qkv = layers.transpose(qkv, [2, 0, 3, 1, 4])  # [3,B,h,S,D]
    q = layers.squeeze(layers.slice(qkv, axes=[0], starts=[0], ends=[1]), [0])
    k = layers.squeeze(layers.slice(qkv, axes=[0], starts=[1], ends=[2]), [0])
    v = layers.squeeze(layers.slice(qkv, axes=[0], starts=[2], ends=[3]), [0])
    if use_flash:
        ctx = layers.flash_attention(q, k, v, bias=attn_bias)
    else:
        scores = layers.matmul(q, k, transpose_y=True,
                               alpha=1.0 / math.sqrt(head_dim))  # [B,h,S,S]
        if attn_bias is not None:
            bias4d = layers.unsqueeze(layers.unsqueeze(attn_bias, [1]), [1])
            scores = layers.elementwise_add(scores, bias4d)
        probs = layers.softmax(scores)
        if dropout and not is_test:
            probs = layers.dropout(probs, dropout, is_test=is_test,
                                   dropout_implementation="upscale_in_train")
        ctx = layers.matmul(probs, v)  # [B,h,S,D]
    ctx = layers.transpose(ctx, [0, 2, 1, 3])
    ctx = layers.reshape(ctx, [0, seq_len, hidden])
    return layers.fc(ctx, size=hidden, num_flatten_dims=2)


def _ffn(x, hidden, intermediate):
    h = layers.fc(x, size=intermediate, num_flatten_dims=2, act="gelu")
    return layers.fc(h, size=hidden, num_flatten_dims=2)


def bert_encoder(input_ids, token_type_ids=None, attn_mask=None,
                 vocab_size=30522, hidden=768, num_layers=12, num_heads=12,
                 seq_len=128, intermediate=3072, max_position=512,
                 type_vocab=2, dropout=0.1, is_test=False, use_flash=True):
    """Returns final hidden states [-1, S, H].

    input_ids/token_type_ids: [-1, S] int64; attn_mask: [-1, S] float32
    (1 = attend, 0 = pad) or None.
    """
    word_emb = layers.embedding(input_ids, size=[vocab_size, hidden])
    pos_ids = layers.range(0, seq_len, 1, dtype="int64")
    pos_emb = layers.embedding(pos_ids, size=[max_position, hidden])
    emb = layers.elementwise_add(word_emb, pos_emb, axis=-1)
    if token_type_ids is not None:
        type_emb = layers.embedding(token_type_ids, size=[type_vocab, hidden])
        emb = layers.elementwise_add(emb, type_emb)
    x = layers.layer_norm(emb, begin_norm_axis=2)
    if dropout and not is_test:
        x = layers.dropout(x, dropout, is_test=is_test,
                           dropout_implementation="upscale_in_train")

    attn_bias = None
    if attn_mask is not None:
        # [B,S] additive bias rows (the flash branches broadcast them over
        # heads and queries; the unfused one unsqueezes to [B,1,1,S])
        attn_bias = layers.scale(attn_mask, scale=10000.0, bias=-10000.0)

    for _ in range(num_layers):
        attn = _attention(x, hidden, num_heads, seq_len, attn_bias,
                          dropout, is_test, use_flash=use_flash)
        if dropout and not is_test:
            attn = layers.dropout(attn, dropout, is_test=is_test,
                                  dropout_implementation="upscale_in_train")
        x = layers.layer_norm(layers.elementwise_add(x, attn),
                              begin_norm_axis=2)
        ffn = _ffn(x, hidden, intermediate)
        if dropout and not is_test:
            ffn = layers.dropout(ffn, dropout, is_test=is_test,
                                 dropout_implementation="upscale_in_train")
        x = layers.layer_norm(layers.elementwise_add(x, ffn),
                              begin_norm_axis=2)
    return x


def build_bert_pretrain(batch_size=None, seq_len=128, vocab_size=30522,
                        hidden=768, num_layers=12, num_heads=12,
                        intermediate=3072, dropout=0.1, is_test=False,
                        use_flash=True, max_predictions=None):
    """MLM pretraining graph.

    * ``max_predictions=None``: score every position over the full vocab
      ([B,S,V] logits), mask the loss.  Feeds: input_ids, token_type_ids,
      attn_mask, mlm_mask, mlm_labels — all [B,S].
    * ``max_predictions=P``: gather the P masked positions per sample and
      run the vocab projection only on them.  Extra feeds: mlm_positions
      [B,P] int64, mlm_labels [B,P], mlm_weights [B,P].  Requires a fixed
      batch_size.

    Returns (feed_names, {'loss': ...}).
    """
    b = -1 if batch_size is None else batch_size
    input_ids = layers.data("input_ids", [b, seq_len], dtype="int64",
                            append_batch_size=False)
    token_type_ids = layers.data("token_type_ids", [b, seq_len],
                                 dtype="int64", append_batch_size=False)
    attn_mask = layers.data("attn_mask", [b, seq_len], dtype="float32",
                            append_batch_size=False)

    enc = bert_encoder(input_ids, token_type_ids, attn_mask,
                       vocab_size=vocab_size, hidden=hidden,
                       num_layers=num_layers, num_heads=num_heads,
                       seq_len=seq_len, intermediate=intermediate,
                       max_position=max(512, seq_len),
                       dropout=dropout, is_test=is_test,
                       use_flash=use_flash)

    if max_predictions is not None:
        if batch_size is None:
            raise ValueError("masked-gather head needs a fixed batch_size")
        P = int(max_predictions)
        positions = layers.data("mlm_positions", [b, P], dtype="int64",
                                append_batch_size=False)
        mlm_labels = layers.data("mlm_labels", [b, P], dtype="int64",
                                 append_batch_size=False)
        weights = layers.data("mlm_weights", [b, P], dtype="float32",
                              append_batch_size=False)
        # [B,P,2] coordinates (batch row, seq position) for gather_nd
        rows = layers.range(0, b, 1, dtype="int64")          # [B]
        rows = layers.expand(layers.unsqueeze(rows, [1]), [1, P])
        coords = layers.stack([rows, positions], axis=2)     # [B,P,2]
        picked = layers.gather_nd(enc, coords)               # [B,P,H]
        h = layers.fc(picked, size=hidden, num_flatten_dims=2, act="gelu")
        h = layers.layer_norm(h, begin_norm_axis=2)
        logits = layers.fc(h, size=vocab_size, num_flatten_dims=2)
        loss = layers.softmax_with_cross_entropy(
            logits, layers.unsqueeze(mlm_labels, [2]))       # [B,P,1]
        loss = layers.elementwise_mul(layers.squeeze(loss, [2]), weights)
        denom = layers.elementwise_add(
            layers.reduce_sum(weights),
            layers.fill_constant([1], "float32", 1e-5))
        mean_loss = layers.elementwise_div(layers.reduce_sum(loss), denom)
        feeds = ["input_ids", "token_type_ids", "attn_mask",
                 "mlm_positions", "mlm_labels", "mlm_weights"]
        return feeds, {"loss": mean_loss}

    mlm_mask = layers.data("mlm_mask", [b, seq_len], dtype="float32",
                           append_batch_size=False)
    mlm_labels = layers.data("mlm_labels", [b, seq_len], dtype="int64",
                             append_batch_size=False)
    # MLM head: transform + layernorm + vocab projection
    h = layers.fc(enc, size=hidden, num_flatten_dims=2, act="gelu")
    h = layers.layer_norm(h, begin_norm_axis=2)
    logits = layers.fc(h, size=vocab_size, num_flatten_dims=2)  # [B,S,V]
    labels = layers.unsqueeze(mlm_labels, [2])
    loss = layers.softmax_with_cross_entropy(logits, labels)  # [B,S,1]
    loss = layers.squeeze(loss, [2])
    masked = layers.elementwise_mul(loss, mlm_mask)
    denom = layers.elementwise_add(
        layers.reduce_sum(mlm_mask),
        layers.fill_constant([1], "float32", 1e-5))
    mean_loss = layers.elementwise_div(layers.reduce_sum(masked), denom)
    feeds = ["input_ids", "token_type_ids", "attn_mask", "mlm_mask",
             "mlm_labels"]
    return feeds, {"loss": mean_loss}


def build_bert_serving(seq_len=128, vocab_size=30522, hidden=768,
                       num_layers=12, num_heads=12, intermediate=3072,
                       use_flash=True):
    """BERT's MLM forward for serving, with fetches that split by row.

    ``build_bert_pretrain``'s loss is a batch mean and its [B, S, V]
    logits are 15.6 MB a row at BERT-base's widths, so a serving model
    fetches per-row outputs instead: the last encoder layer's output
    ``encoder_out`` [B, S, H] float32 and ``mlm_argmax`` [B, S] int64,
    the MLM head's most likely token at each position (the head's vocab
    projection still runs).  Feeds: input_ids, token_type_ids [B, S]
    int64 and attn_mask [B, S] float32; B is free.  No dropout.

    Returns (feed_names, {"encoder_out": ..., "mlm_argmax": ...}).
    """
    input_ids = layers.data("input_ids", [-1, seq_len], dtype="int64",
                            append_batch_size=False)
    token_type_ids = layers.data("token_type_ids", [-1, seq_len],
                                 dtype="int64", append_batch_size=False)
    attn_mask = layers.data("attn_mask", [-1, seq_len], dtype="float32",
                            append_batch_size=False)
    enc = bert_encoder(input_ids, token_type_ids, attn_mask,
                       vocab_size=vocab_size, hidden=hidden,
                       num_layers=num_layers, num_heads=num_heads,
                       seq_len=seq_len, intermediate=intermediate,
                       max_position=max(512, seq_len), dropout=0.0,
                       is_test=True, use_flash=use_flash)
    h = layers.fc(enc, size=hidden, num_flatten_dims=2, act="gelu")
    h = layers.layer_norm(h, begin_norm_axis=2)
    logits = layers.fc(h, size=vocab_size, num_flatten_dims=2)
    return (["input_ids", "token_type_ids", "attn_mask"],
            {"encoder_out": enc, "mlm_argmax": layers.argmax(logits,
                                                             axis=2)})
