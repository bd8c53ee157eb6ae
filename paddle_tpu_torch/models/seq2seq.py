"""Attention seq2seq for machine translation (the reference book model).

Counterpart of ``paddle_tpu/models/seq2seq.py`` (reference
python/paddle/fluid/tests/book/test_machine_translation.py and the
PaddleNLP seq2seq example), building the same two programs:

  * fixed [batch, src_len] / [batch, trg_len] padded shapes with length
    masks, no LoD;
  * encoder: a bi-GRU of two fused single-layer recurrences
    (``layers.gru``, op ``gru_rnn``), the backward one over
    ``sequence_reverse``d inputs;
  * decoder: GRUCell + Luong dot attention, a teacher-forced unroll for
    training; the fixed-shape BeamSearchDecoder + dynamic_decode for
    inference (layers/rnn.py), sharing the weights by parameter name.

Train / infer weight sharing is by parameter NAME through the scope (the
reference contract): build_seq2seq_train and build_seq2seq_infer make
identically named parameters in separate programs.
"""
from __future__ import annotations

from .. import layers
from ..framework.layer_helper import ParamAttr


def _attr(name):
    return ParamAttr(name=name)


class _AttentionDecoderCell(layers.RNNCell):
    """GRU cell + Luong dot attention over fixed encoder states.

    inputs: [N, E] (target embedding);
    states: (h [N, H], enc [N, S, 2H], enc_mask [N, S]).
    The encoder tensors ride in the state tuple so the
    BeamSearchDecoder's parent-reordering applies to them uniformly.
    """

    # (h, enc, mask): enc/mask are identical across beams — the decoder
    # skips their per-step parent reorder (layers/rnn.py
    # _reorder_states)
    beam_static_state = (False, True, True)

    def __init__(self, hidden, name="s2s_dec"):
        self.hidden_size = hidden
        self._cell = layers.GRUCell(hidden, name=f"{name}.gru")
        self._name = name

    def __call__(self, inputs, states):
        h, enc, mask = states
        new_h, _ = self._cell(inputs, h)
        # dot attention: scores [N, S] = enc · (W new_h)
        query = layers.fc(new_h, size=int(enc.shape[-1]),
                          param_attr=_attr(f"{self._name}.attn_w"),
                          bias_attr=False)                     # [N, 2H]
        scores = layers.squeeze(
            layers.matmul(enc, layers.unsqueeze(query, [2])), [2])
        scores = layers.elementwise_add(
            scores, layers.scale(mask, scale=10000.0, bias=-10000.0))
        w = layers.softmax(scores)                             # [N, S]
        ctxv = layers.squeeze(
            layers.matmul(layers.unsqueeze(w, [1]), enc), [1])  # [N, 2H]
        out = layers.concat([new_h, ctxv], axis=1)             # [N, H+2H]
        return out, (new_h, enc, mask)


def _encode(src_ids, src_mask, src_vocab, emb_dim, hidden):
    emb = layers.embedding(src_ids, size=[src_vocab, emb_dim],
                           param_attr=_attr("s2s.src_emb"))
    lengths = layers.cast(layers.reduce_sum(src_mask, dim=1), "int64")
    fwd, _ = layers.gru(emb, hidden, lengths=lengths,
                        param_attr=_attr("s2s.enc_fw.w"),
                        bias_attr=_attr("s2s.enc_fw.b"))
    bwd, _ = layers.gru(layers.sequence_reverse(emb, lengths=lengths),
                        hidden, lengths=lengths,
                        param_attr=_attr("s2s.enc_bw.w"),
                        bias_attr=_attr("s2s.enc_bw.b"))
    bwd = layers.sequence_reverse(bwd, lengths=lengths)
    enc = layers.concat([fwd, bwd], axis=2)                    # [B,S,2H]
    # initial decoder state from the mean of encoder states
    denom = layers.elementwise_add(
        layers.reduce_sum(src_mask, dim=1, keep_dim=True),
        layers.fill_constant([1], "float32", 1e-6))
    pooled = layers.elementwise_div(
        layers.reduce_sum(
            layers.elementwise_mul(enc, layers.unsqueeze(src_mask, [2])),
            dim=1), denom)
    h0 = layers.fc(pooled, size=hidden, act="tanh",
                   param_attr=_attr("s2s.h0_w"),
                   bias_attr=_attr("s2s.h0_b"))
    return enc, h0


def _trg_embed(ids, trg_vocab, emb_dim):
    return layers.embedding(ids, size=[trg_vocab, emb_dim],
                            param_attr=_attr("s2s.trg_emb"))


def _out_proj(x, trg_vocab, flatten=1):
    return layers.fc(x, size=trg_vocab, num_flatten_dims=flatten,
                     param_attr=_attr("s2s.out_w"),
                     bias_attr=_attr("s2s.out_b"))


def build_seq2seq_train(batch, src_len, trg_len, src_vocab, trg_vocab,
                        emb_dim=64, hidden=64):
    """Teacher-forced training graph.

    Feeds: src_ids [B,S], src_mask [B,S] f32, trg_in [B,T] (bos-shifted),
    trg_out [B,T] labels, trg_mask [B,T] f32.
    Returns (feed_names, {'loss': ...}).
    """
    src_ids = layers.data("src_ids", [batch, src_len], dtype="int64",
                          append_batch_size=False)
    src_mask = layers.data("src_mask", [batch, src_len],
                           append_batch_size=False)
    trg_in = layers.data("trg_in", [batch, trg_len], dtype="int64",
                         append_batch_size=False)
    trg_out = layers.data("trg_out", [batch, trg_len], dtype="int64",
                          append_batch_size=False)
    trg_mask = layers.data("trg_mask", [batch, trg_len],
                           append_batch_size=False)

    enc, h0 = _encode(src_ids, src_mask, src_vocab, emb_dim, hidden)
    cell = _AttentionDecoderCell(hidden)
    emb = _trg_embed(trg_in, trg_vocab, emb_dim)       # [B,T,E]
    # teacher-forced unroll (no input feeding — matches the decode path)
    states = (h0, enc, src_mask)
    outs = []
    for t in range(trg_len):
        x_t = layers.squeeze(
            layers.slice(emb, axes=[1], starts=[t], ends=[t + 1]), [1])
        out_t, states = cell(x_t, states)
        outs.append(out_t)
    dec = layers.stack(outs, axis=1)                   # [B,T,H+2H]
    logits = _out_proj(dec, trg_vocab, flatten=2)      # [B,T,V]
    loss = layers.softmax_with_cross_entropy(
        logits, layers.unsqueeze(trg_out, [2]))        # [B,T,1]
    loss = layers.elementwise_mul(layers.squeeze(loss, [2]), trg_mask)
    denom = layers.elementwise_add(layers.reduce_sum(trg_mask),
                                   layers.fill_constant([1], "float32",
                                                        1e-6))
    mean_loss = layers.elementwise_div(layers.reduce_sum(loss), denom)
    feeds = ["src_ids", "src_mask", "trg_in", "trg_out", "trg_mask"]
    return feeds, {"loss": mean_loss}


def build_seq2seq_infer(batch, src_len, src_vocab, trg_vocab, emb_dim=64,
                        hidden=64, beam_size=4, max_len=16, bos_id=0,
                        eos_id=1):
    """Beam-search inference graph (weights shared with the train graph
    by parameter name). Returns (feed_names, {'ids', 'scores',
    'lengths'}) with ids [B, beam, max_len]."""
    src_ids = layers.data("src_ids", [batch, src_len], dtype="int64",
                          append_batch_size=False)
    src_mask = layers.data("src_mask", [batch, src_len],
                           append_batch_size=False)
    enc, h0 = _encode(src_ids, src_mask, src_vocab, emb_dim, hidden)
    cell = _AttentionDecoderCell(hidden)

    decoder = layers.BeamSearchDecoder(
        cell, start_token=bos_id, end_token=eos_id,
        beam_size=beam_size,
        embedding_fn=lambda ids: _trg_embed(ids, trg_vocab, emb_dim),
        output_fn=lambda o: _out_proj(o, trg_vocab, flatten=1))
    ids, scores, lengths = layers.dynamic_decode(
        decoder, inits=(h0, enc, src_mask), max_step_num=max_len)
    return ["src_ids", "src_mask"], {"ids": ids, "scores": scores,
                                     "lengths": lengths}
