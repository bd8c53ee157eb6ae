"""BERT/ERNIE-base encoder + pretraining heads, on the packed
flash-attention path.

Counterpart of ``paddle_tpu/models/bert.py``: the same layers in the same
order, so the program matches the JAX package's op for op, name for
name, for serving (``is_test=True``) and for training (``dropout`` on the
embeddings, the attention output and the FFN output; the flash path folds
out attention-probability dropout, as the JAX package does).  What waits
for later slices raises NotImplementedError: the unfused
(``use_flash=False``) and einsum (``use_flash="xla"``) attention paths,
and widths the packed path cannot take (hidden % 128 != 0 or head_dim
not in (64, 128)).
"""
from __future__ import annotations

import warnings

from .. import layers


def _attention(x, hidden, num_heads, seq_len, attn_bias=None, dropout=0.0,
               is_test=False, use_flash=True):
    """Multi-head self-attention on the packed path. x: [-1, S, H]."""
    head_dim = hidden // num_heads
    if use_flash is not True:
        raise NotImplementedError(
            f"bert use_flash={use_flash!r}: only the packed flash path "
            f"(use_flash=True) is ported")
    if not (hidden % 128 == 0 and head_dim in (64, 128)):
        raise NotImplementedError(
            f"bert hidden {hidden} / head_dim {head_dim}: the packed path "
            f"needs hidden % 128 == 0 and head_dim in (64, 128); the "
            f"unpacked flash_attention path is not ported")
    qkv = layers.fc(x, size=3 * hidden, num_flatten_dims=2)  # [B,S,3H]
    if dropout and not is_test:
        warnings.warn(
            "bert: flash attention folds out attention-probability "
            "dropout (output dropout kept)", stacklevel=3)
    ctx = layers.flash_attention_qkv(qkv, num_heads, bias=attn_bias)
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
        # [B,S] additive bias rows, broadcast over heads and queries
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
