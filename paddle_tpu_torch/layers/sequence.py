"""Sequence layers over the dense [B, T, ...] + lengths representation.

Counterpart of ``paddle_tpu/layers/sequence.py``: the ``sequence_*``
layers, ``pad_sequences`` (ragged host data padded once at the feed),
the fixed-capacity TensorArray handles (``create_array``,
``array_write``, ``array_read``, ``array_length``) and the masked
single-layer ``lstm`` / ``gru`` (ops ``lstm_rnn`` / ``gru_rnn``).  They
emit the same ops, vars and parameters as the JAX package's.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..framework.layer_helper import LayerHelper

__all__ = ["sequence_mask", "sequence_pool", "sequence_softmax",
           "sequence_reverse", "sequence_expand_as", "sequence_last_step",
           "sequence_first_step", "pad_sequences", "create_array",
           "array_write", "array_read", "array_length", "lstm", "gru"]


def sequence_mask(x, maxlen, dtype="float32", name=None):
    """lengths [B] -> mask [B, maxlen] (reference layers.sequence_mask)."""
    helper = LayerHelper("sequence_mask", name=name)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("sequence_mask", inputs={"X": [x]},
                     outputs={"Y": [out]},
                     attrs={"maxlen": int(maxlen), "out_dtype": dtype})
    return out


def _seq_op(op_type, x, lengths, name=None, **attrs):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(op_type, inputs={"X": [x], "Lengths": [lengths]},
                     outputs={"Out": [out]}, attrs=attrs)
    return out


def sequence_pool(input, pool_type, lengths=None, name=None):
    """Masked pool over time (reference sequence_pool, LoD -> lengths)."""
    assert lengths is not None, \
        "sequence ops take explicit lengths (no LoD)"
    return _seq_op("sequence_pool", input, lengths, name=name,
                   pool_type=pool_type)


def sequence_last_step(input, lengths=None, name=None):
    return sequence_pool(input, "last", lengths, name)


def sequence_first_step(input, lengths=None, name=None):
    return sequence_pool(input, "first", lengths, name)


def sequence_softmax(input, lengths=None, name=None):
    assert lengths is not None
    return _seq_op("sequence_softmax", input, lengths, name=name)


def sequence_reverse(x, lengths=None, name=None):
    assert lengths is not None
    return _seq_op("sequence_reverse", x, lengths, name=name)


def sequence_expand_as(x, y_lengths, maxlen, name=None):
    return _seq_op("sequence_expand_as", x, y_lengths, name=name,
                   maxlen=int(maxlen))


def pad_sequences(seqs: Sequence, maxlen: Optional[int] = None,
                  dtype="float32", pad_value=0.0):
    """Host-side: ragged python sequences -> (dense [B, T, ...], lengths
    [B]).  The once-per-batch LoD -> dense conversion."""
    lengths = np.asarray([len(s) for s in seqs], "int64")
    T = int(maxlen or lengths.max())
    first = np.asarray(seqs[0])
    out = np.full((len(seqs), T) + first.shape[1:], pad_value, dtype)
    for i, s in enumerate(seqs):
        n = min(len(s), T)
        out[i, :n] = np.asarray(s)[:n]
    return out, np.minimum(lengths, T)


# ---------------------------------------------------------------------------
# TensorArray (reference layers/control_flow array_write/read/length)
# ---------------------------------------------------------------------------
def create_array(dtype, item_shape, capacity: int = 128, name=None):
    """Fixed-capacity TensorArray: a [capacity, *item_shape] buffer +
    a tracked length var (reference create_array; capacity is the static
    bound for the LoDTensorArray's dynamic growth)."""
    from . import tensor as T

    arr = T.fill_constant([capacity] + list(item_shape), dtype, 0.0)
    arr._ta_len = T.fill_constant([1], "int64", 0)
    arr._ta_capacity = capacity
    return arr


def _static_index_value(i):
    """Best-effort: the literal value of a fill_constant-produced index."""
    block = i.block
    for op in reversed(block.ops):
        if i.name in op.output_arg_names():
            if op.type == "fill_constant":
                return op.attrs.get("value")
            return None
    return None


def array_write(x, i, array=None, capacity: int = 128):
    """array[i] = x; returns the updated array handle (reference
    layers.array_write).

    NOTE: the buffer is fixed-capacity; indices beyond capacity are
    clamped to the last slot at run time (``write_to_array``).  Literal
    indices are checked at build time."""
    from . import tensor as T

    helper = LayerHelper("array_write")
    if array is None:
        shape = list(x.shape or ())
        if any(d < 0 for d in shape):
            raise ValueError(
                f"array_write: cannot infer a TensorArray buffer from "
                f"x shape {tuple(shape)} (unknown dims); pass "
                "array=create_array(dtype, item_shape, capacity) with "
                "concrete item dimensions")
        array = create_array(x.dtype, shape, capacity=capacity)
    cap = getattr(array, "_ta_capacity", capacity)
    lit = _static_index_value(i)
    if lit is not None and int(lit) >= cap:
        raise IndexError(
            f"array_write: index {int(lit)} >= TensorArray capacity "
            f"{cap}; raise create_array(capacity=...)")
    out = helper.create_variable_for_type_inference(array.dtype)
    helper.append_op("write_to_array",
                     inputs={"X": [x], "I": [i], "Array": [array]},
                     outputs={"Out": [out]})
    # track length = max(len, i+1)
    one = T.fill_constant([1], "int64", 1)
    from .math_op_patch import binary
    new_len = binary(binary(i, one, "elementwise_add"),
                     array._ta_len, "elementwise_max")
    out._ta_len = new_len
    out._ta_capacity = getattr(array, "_ta_capacity", capacity)
    return out


def array_read(array, i):
    helper = LayerHelper("array_read")
    out = helper.create_variable_for_type_inference(array.dtype)
    helper.append_op("read_from_array",
                     inputs={"Array": [array], "I": [i]},
                     outputs={"Out": [out]})
    return out


def array_length(array):
    ln = getattr(array, "_ta_len", None)
    if ln is None:
        raise ValueError("array_length: not a TensorArray handle")
    return ln


# ---------------------------------------------------------------------------
# recurrent layers
# ---------------------------------------------------------------------------
def _rnn(kind, input, hidden_size, lengths, n_gates, param_attr=None,
         bias_attr=None, name=None):
    helper = LayerHelper(kind, name=name)
    d = int(input.shape[-1])
    w = helper.create_parameter(param_attr,
                                [d + hidden_size, n_gates * hidden_size],
                                input.dtype)
    b = helper.create_parameter(bias_attr, [n_gates * hidden_size],
                                input.dtype, is_bias=True)
    out = helper.create_variable_for_type_inference(input.dtype)
    last_h = helper.create_variable_for_type_inference(input.dtype)
    outputs = {"Out": [out], "LastH": [last_h]}
    rets = [out, last_h]
    if kind == "lstm_rnn":
        last_c = helper.create_variable_for_type_inference(input.dtype)
        outputs["LastC"] = [last_c]
        rets.append(last_c)
    helper.append_op(kind,
                     inputs={"X": [input], "W": [w], "B": [b],
                             "Lengths": [lengths]},
                     outputs=outputs,
                     attrs={"hidden_size": int(hidden_size)})
    return tuple(rets)


def lstm(input, hidden_size, lengths=None, param_attr=None,
         bias_attr=None, name=None):
    """Masked single-layer LSTM: (outputs [B,T,H], last_h, last_c).
    Reference: fluid.layers.lstm / cudnn_lstm_op — a loop over time of
    one fused gate product a step."""
    assert lengths is not None, "lstm takes explicit lengths"
    return _rnn("lstm_rnn", input, hidden_size, lengths, 4, param_attr,
                bias_attr, name)


def gru(input, hidden_size, lengths=None, param_attr=None,
        bias_attr=None, name=None):
    """Masked single-layer GRU: (outputs [B,T,H], last_h)."""
    assert lengths is not None, "gru takes explicit lengths"
    return _rnn("gru_rnn", input, hidden_size, lengths, 3, param_attr,
                bias_attr, name)
