"""RNN cells, the generic rnn() unroll, BeamSearchDecoder and
dynamic_decode.

Counterpart of ``paddle_tpu/layers/rnn.py`` (reference
python/paddle/fluid/layers/rnn.py: RNNCell / GRUCell / LSTMCell, rnn,
BeamSearchDecoder:865, dynamic_decode:1568), emitting the same ops, vars
and parameters:

  * every decode step is fixed [batch, beam]: finished hypotheses persist
    as end-token self-continuations with frozen scores (ops/beam_ops.py),
    and ``dynamic_decode`` unrolls its required ``max_step_num`` steps;
  * cells are parameter-caching Python objects; the same cell instance
    reused across time steps and across the training and decoding
    programs shares weights by name (``_cell_params``);
  * ``rnn()`` unrolls over the static time dim; ``layers.lstm`` /
    ``layers.gru`` are the fused single-op recurrences.
"""
from __future__ import annotations

import numpy as np

from ..framework.layer_helper import LayerHelper
from ..framework.core import unique_name
from . import tensor as T
from .nn import fc  # noqa: F401  (re-export convenience)


def _L():
    """The full layers namespace (lazy to avoid a circular import)."""
    from .. import layers
    return layers

__all__ = ["RNNCell", "GRUCell", "LSTMCell", "rnn", "birnn",
           "BeamSearchDecoder", "dynamic_decode", "beam_search",
           "beam_search_decode", "gather_tree"]


# ---------------------------------------------------------------------------
# thin layer fronts for the beam ops
# ---------------------------------------------------------------------------

def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                name=None):
    """One fixed-shape beam step (reference layers.beam_search /
    operators/beam_search_op.cc). pre_ids/pre_scores: [B, K]; ids/scores:
    [B, K, W] candidates with ACCUMULATED scores; returns
    (selected_ids [B,K], selected_scores [B,K], parent_idx [B,K])."""
    helper = LayerHelper("beam_search", name=name)
    sel_ids = helper.create_variable_for_type_inference("int64")
    sel_scores = helper.create_variable_for_type_inference(scores.dtype)
    parent = helper.create_variable_for_type_inference("int64")
    inputs = {"PreIds": [pre_ids], "PreScores": [pre_scores],
              "Scores": [scores]}
    if ids is not None:
        inputs["Ids"] = [ids]
    helper.append_op("beam_search", inputs=inputs,
                     outputs={"SelectedIds": [sel_ids],
                              "SelectedScores": [sel_scores],
                              "ParentIdx": [parent]},
                     attrs={"beam_size": beam_size, "end_id": end_id})
    return sel_ids, sel_scores, parent


def gather_tree(ids, parents, name=None):
    """Backtrack beam parents to full sequences (reference
    layers.gather_tree / operators/gather_tree_op.cc). ids/parents:
    [T, B, K] -> [T, B, K]."""
    helper = LayerHelper("gather_tree", name=name)
    out = helper.create_variable_for_type_inference(ids.dtype)
    helper.append_op("gather_tree",
                     inputs={"Ids": [ids], "Parents": [parents]},
                     outputs={"Out": [out]})
    return out


def beam_search_decode(ids, parents, scores, end_id, name=None):
    """Assemble final hypotheses (reference layers.beam_search_decode /
    operators/beam_search_decode_op.cc). ids/parents: [T, B, K], scores:
    [B, K] final accumulated log-probs. Returns (sentence_ids [B,K,T]
    end-padded, sentence_scores [B,K], sentence_lengths [B,K])."""
    helper = LayerHelper("beam_search_decode", name=name)
    sent = helper.create_variable_for_type_inference("int64")
    sc = helper.create_variable_for_type_inference(scores.dtype)
    ln = helper.create_variable_for_type_inference("int64")
    helper.append_op("beam_search_decode",
                     inputs={"Ids": [ids], "Parents": [parents],
                             "Scores": [scores]},
                     outputs={"SentenceIds": [sent],
                              "SentenceScores": [sc],
                              "SentenceLengths": [ln]},
                     attrs={"end_id": end_id})
    return sent, sc, ln


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------


def _named_attr(base_attr, fallback_name):
    """Per-weight attr: a user attr's name gets a distinct suffix per
    weight (one shared name would silently alias wx/wh to a single
    parameter via the create_parameter name-collision path)."""
    from ..framework.layer_helper import ParamAttr
    if base_attr is None:
        return ParamAttr(name=fallback_name)
    attr = ParamAttr._to_attr(base_attr)
    if attr.name:
        import copy
        attr = copy.copy(attr)
        attr.name = f"{attr.name}.{fallback_name.rsplit('.', 1)[-1]}"
    return attr


def _cell_params(cell, input_size, gate_width):
    """Create (or fetch) a cell's (wx, wh, b).

    The cache lives ON the current Program (not keyed by id() — a
    recycled address after GC must not resurrect another program's
    parameters), so the same cell instance builds identically-named
    params in a separate inference program: cross-program weight
    sharing through the scope, the reference's name-based contract.
    """
    from ..framework.core import default_main_program
    prog = default_main_program()
    cache = prog.__dict__.setdefault("_cell_param_cache", {})
    if cell._name in cache:
        return cache[cell._name]
    helper = LayerHelper(cell._name)
    wx = helper.create_parameter(
        _named_attr(cell._param_attr, f"{cell._name}.wx"),
        [input_size, gate_width])
    wh = helper.create_parameter(
        _named_attr(cell._param_attr, f"{cell._name}.wh"),
        [cell.hidden_size, gate_width])
    b = helper.create_parameter(
        _named_attr(cell._bias_attr, f"{cell._name}.b"),
        [gate_width], is_bias=True)
    cache[cell._name] = (wx, wh, b)
    return cache[cell._name]


class RNNCell:
    """Base cell: __call__(inputs, states) -> (outputs, new_states).
    Parameters are created on first call and cached on the current
    Program (_cell_params), so reuse across time steps shares weights
    and the same instance rebuilds identically-named params in a
    separate inference program."""

    def get_initial_states(self, batch_size, dtype="float32"):
        raise NotImplementedError

    def __call__(self, inputs, states):
        raise NotImplementedError


class GRUCell(RNNCell):
    """GRU cell (reference fluid.layers.GRUCell / dygraph GRUUnit):

        r = sigmoid(x W_xr + h W_hr + b_r)
        z = sigmoid(x W_xz + h W_hz + b_z)
        c = tanh(x W_xc + r * (h W_hc) + b_c)
        h' = z * h + (1 - z) * c
    """

    def __init__(self, hidden_size, param_attr=None, bias_attr=None,
                 name=None):
        self.hidden_size = hidden_size
        self._param_attr = param_attr
        self._bias_attr = bias_attr
        self._name = name or unique_name("gru_cell")

    def _build(self, input_size):
        H = self.hidden_size
        return _cell_params(self, input_size, 3 * H)

    def get_initial_states(self, batch_size, dtype="float32"):
        return T.fill_constant([batch_size, self.hidden_size], dtype, 0.0)

    def __call__(self, inputs, states):
        nn = _L()
        h = states
        wx, wh, b = self._build(int(inputs.shape[-1]))
        H = self.hidden_size
        gx = nn.matmul(inputs, wx)                       # [B, 3H]
        gh = nn.matmul(h, wh)
        gx = nn.elementwise_add(gx, b)
        xr = nn.slice(gx, axes=[1], starts=[0], ends=[H])
        xz = nn.slice(gx, axes=[1], starts=[H], ends=[2 * H])
        xc = nn.slice(gx, axes=[1], starts=[2 * H], ends=[3 * H])
        hr = nn.slice(gh, axes=[1], starts=[0], ends=[H])
        hz = nn.slice(gh, axes=[1], starts=[H], ends=[2 * H])
        hc = nn.slice(gh, axes=[1], starts=[2 * H], ends=[3 * H])
        r = nn.sigmoid(nn.elementwise_add(xr, hr))
        z = nn.sigmoid(nn.elementwise_add(xz, hz))
        c = nn.tanh(nn.elementwise_add(xc, nn.elementwise_mul(r, hc)))
        one_minus_z = nn.scale(z, scale=-1.0, bias=1.0)
        new_h = nn.elementwise_add(nn.elementwise_mul(z, h),
                                   nn.elementwise_mul(one_minus_z, c))
        return new_h, new_h


class LSTMCell(RNNCell):
    """LSTM cell (reference fluid.layers.LSTMCell): standard i/f/c/o
    gates, forget bias 1.0 folded into init."""

    def __init__(self, hidden_size, param_attr=None, bias_attr=None,
                 forget_bias=1.0, name=None):
        self.hidden_size = hidden_size
        self._param_attr = param_attr
        self._bias_attr = bias_attr
        self._forget_bias = forget_bias
        self._name = name or unique_name("lstm_cell")

    def _build(self, input_size):
        H = self.hidden_size
        return _cell_params(self, input_size, 4 * H)

    def get_initial_states(self, batch_size, dtype="float32"):
        return (T.fill_constant([batch_size, self.hidden_size], dtype, 0.0),
                T.fill_constant([batch_size, self.hidden_size], dtype, 0.0))

    def __call__(self, inputs, states):
        nn = _L()
        h, c = states
        wx, wh, b = self._build(int(inputs.shape[-1]))
        H = self.hidden_size
        g = nn.elementwise_add(
            nn.elementwise_add(nn.matmul(inputs, wx), nn.matmul(h, wh)), b)
        gi = nn.slice(g, axes=[1], starts=[0], ends=[H])
        gf = nn.slice(g, axes=[1], starts=[H], ends=[2 * H])
        gc = nn.slice(g, axes=[1], starts=[2 * H], ends=[3 * H])
        go = nn.slice(g, axes=[1], starts=[3 * H], ends=[4 * H])
        i = nn.sigmoid(gi)
        f = nn.sigmoid(nn.scale(gf, bias=self._forget_bias))
        o = nn.sigmoid(go)
        new_c = nn.elementwise_add(nn.elementwise_mul(f, c),
                                   nn.elementwise_mul(i, nn.tanh(gc)))
        new_h = nn.elementwise_mul(o, nn.tanh(new_c))
        return new_h, (new_h, new_c)


def rnn(cell, inputs, initial_states=None, sequence_length=None,
        time_major=False, is_reverse=False, name=None):
    """Run `cell` over the (static) time dim of `inputs` [B, T, I]
    (or [T, B, I] when time_major). Returns (outputs [B, T, H...],
    final_states). A Python unroll, an op set a step; use layers.lstm /
    layers.gru scans for the fused fast path.

    sequence_length [B] masks state updates past each row's length
    (reference rnn() mask semantics)."""
    nn = _L()

    if time_major:
        inputs = nn.transpose(inputs, [1, 0, 2])
    Tn = int(inputs.shape[1])
    B = int(inputs.shape[0])
    if initial_states is None:
        initial_states = cell.get_initial_states(B, inputs.dtype)
    states = initial_states
    outs = []
    steps = range(Tn - 1, -1, -1) if is_reverse else range(Tn)
    for t in steps:
        x_t = nn.squeeze(
            nn.slice(inputs, axes=[1], starts=[t], ends=[t + 1]), [1])
        out_t, new_states = cell(x_t, states)
        if sequence_length is not None:
            keep = nn.cast(
                nn.less_than(
                    T.fill_constant([B], "int64", t), sequence_length),
                out_t.dtype)
            keep2 = nn.unsqueeze(keep, [1])

            def _mask(new, old):
                return nn.elementwise_add(
                    nn.elementwise_mul(new, keep2),
                    nn.elementwise_mul(
                        old, nn.scale(keep2, scale=-1.0, bias=1.0)))
            out_t = nn.elementwise_mul(out_t, keep2)
            if isinstance(new_states, (tuple, list)):
                new_states = type(new_states)(
                    _mask(n, o) for n, o in zip(new_states, states))
            else:
                new_states = _mask(new_states, states)
        outs.append(out_t)
        states = new_states
    if is_reverse:
        outs = outs[::-1]
    outputs = nn.stack(outs, axis=1)
    if time_major:
        outputs = nn.transpose(outputs, [1, 0, 2])
    return outputs, states


def birnn(cell_fw, cell_bw, inputs, sequence_length=None, name=None):
    """Bidirectional rnn(); concatenates fw/bw outputs on the feature
    dim (reference layers.birnn)."""
    nn = _L()
    out_fw, st_fw = rnn(cell_fw, inputs, sequence_length=sequence_length)
    out_bw, st_bw = rnn(cell_bw, inputs, sequence_length=sequence_length,
                        is_reverse=True)
    return nn.concat([out_fw, out_bw], axis=-1), (st_fw, st_bw)


# ---------------------------------------------------------------------------
# beam-search decoder
# ---------------------------------------------------------------------------

class BeamSearchDecoder:
    """Fixed-shape beam-search decoder (reference rnn.py:865).

    Wraps a cell; each step scores `cell` outputs over the vocab,
    extends every live hypothesis with the top beam_size continuations
    (finished hypotheses persist at frozen score — ops/beam_ops.py), and
    reorders cell states by parent. All shapes are [batch, beam, ...];
    states ride merged as [batch*beam, ...] through the cell.
    """

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        """[B, ...] -> [B*K, ...] by repeating each row K times
        (reference rnn.py:934)."""
        nn = _L()
        shape = list(x.shape)
        x = nn.unsqueeze(x, [1])
        x = nn.expand(x, [1, beam_size] + [1] * (len(shape) - 1))
        return nn.reshape(x, [-1] + shape[1:])

    def _merge(self, x):
        nn = _L()
        return nn.reshape(x, [-1] + list(x.shape[2:]))

    def _split(self, x):
        nn = _L()
        return nn.reshape(x, [-1, self.beam_size] + list(x.shape[1:]))

    def _map_states(self, states, fn):
        if isinstance(states, (tuple, list)):
            return type(states)(self._map_states(s, fn) for s in states)
        return fn(states)

    def _reorder_states(self, states, fn):
        """Like _map_states, but skips beam-invariant slots: a cell may
        declare `beam_static_state` (same structure as its states, True
        = identical across beams) — reordering those by parent provably
        returns the input, so the gather is dropped (the encoder tensor
        is the largest state in an attention decode loop)."""
        static = getattr(self.cell, "beam_static_state", None)

        def walk(s, st):
            if isinstance(s, (tuple, list)):
                sts = st if isinstance(st, (tuple, list)) \
                    else [st] * len(s)
                return type(s)(walk(x, m) for x, m in zip(s, sts))
            return s if st else fn(s)

        return walk(states, static if static is not None else False)

    def initialize(self, initial_cell_states):
        """Returns (initial_inputs, initial_states dict). Batch size is
        static (from the cell state shape)."""
        nn = _L()
        flat = initial_cell_states
        while isinstance(flat, (tuple, list)):
            flat = flat[0]
        B = int(flat.shape[0])
        K = self.beam_size
        cell_states = self._map_states(
            initial_cell_states,
            lambda s: self.tile_beam_merge_with_batch(s, K))
        pre_ids = T.fill_constant([B, K], "int64", self.start_token)
        # beam 0 live at 0.0, the rest at -1e9 so step 1 expands one beam
        row = T.assign(np.array(
            [[0.0] + [-1e9] * (K - 1)], dtype="float32"))
        pre_scores = nn.expand(row, [B, 1])
        ids_in = T.fill_constant([B, K], "int64", self.start_token)
        inputs = self.embedding_fn(ids_in) if self.embedding_fn else ids_in
        inputs = self._merge(inputs)
        return inputs, {"cell": cell_states, "pre_ids": pre_ids,
                        "pre_scores": pre_scores}

    def step(self, time, inputs, states):
        """One decode step. Returns (outputs, next_states, next_inputs)
        with outputs = (selected_ids [B,K], selected_scores [B,K],
        parent_idx [B,K])."""
        nn = _L()
        K = self.beam_size
        cell_out, next_cell = self.cell(inputs, states["cell"])
        if self.output_fn is not None:
            cell_out = self.output_fn(cell_out)
        logits = self._split(cell_out)                    # [B, K, V]
        B = int(logits.shape[0])
        logp = nn.log_softmax(logits)
        accu = nn.elementwise_add(nn.unsqueeze(states["pre_scores"], [2]),
                                  logp)                   # [B, K, V]
        sel_ids, sel_scores, parent = beam_search(
            states["pre_ids"], states["pre_scores"], None, accu,
            beam_size=K, end_id=self.end_token)

        # reorder states by parent: coords [B, K, 2]
        rows = nn.expand(nn.unsqueeze(T.range(0, B, 1, "int64"), [1]),
                         [1, K])
        coords = nn.stack([rows, parent], axis=2)

        def reorder(s):
            sk = self._split(s)
            return self._merge(nn.gather_nd(sk, coords))

        next_cell = self._reorder_states(next_cell, reorder)
        next_inputs = (self.embedding_fn(sel_ids) if self.embedding_fn
                       else sel_ids)
        next_inputs = self._merge(next_inputs)
        next_states = {"cell": next_cell, "pre_ids": sel_ids,
                       "pre_scores": sel_scores}
        return (sel_ids, sel_scores, parent), next_states, next_inputs


def dynamic_decode(decoder, inits=None, max_step_num=None, name=None,
                   **kwargs):
    """Run `decoder` for max_step_num steps (reference rnn.py:1568).

    Contract: `max_step_num` is REQUIRED and static — the loop
    always runs the full budget with finished hypotheses frozen in
    place (fixed shapes; no LoD shrinking / early host exit).  Any other
    option raises TypeError.

    Returns (sentence_ids [B, K, T] int64, end-padded,
             sentence_scores [B, K] final accumulated log-probs,
             sentence_lengths [B, K] int64).
    """
    if kwargs:
        raise TypeError(
            f"dynamic_decode: unsupported options {sorted(kwargs)} — "
            "the decoder returns batch-major [B, beam, T] sentences "
            "(no output_time_major/is_test/return_length switches)")
    nn = _L()
    if max_step_num is None:
        raise ValueError("dynamic_decode: max_step_num is required "
                         "(the static decode budget)")
    Tn = int(max_step_num)
    inputs, states = decoder.initialize(inits)
    step_ids, step_parents = [], []
    for t in range(Tn):
        (sel_ids, sel_scores, parent), states, inputs = decoder.step(
            T.fill_constant([1], "int64", t), inputs, states)
        step_ids.append(sel_ids)
        step_parents.append(parent)
    ids_tbk = nn.stack(step_ids, axis=0)        # [T, B, K]
    parents_tbk = nn.stack(step_parents, axis=0)
    return beam_search_decode(ids_tbk, parents_tbk, states["pre_scores"],
                              end_id=decoder.end_token)
