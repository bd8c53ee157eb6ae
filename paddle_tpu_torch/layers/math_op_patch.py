"""Operator overloading of static Variables (``x + y``, ``x * 2``,
``x @ w``, ``x < y``): the static branch of
``paddle_tpu/layers/math_op_patch.py``, with the same ops and attrs.  A
Python number becomes a ``fill_constant`` of shape [1] that takes no
gradient."""
from __future__ import annotations

import numpy as np

_COMPARISONS = ("less_than", "less_equal", "greater_than", "greater_equal",
                "equal", "not_equal")


def binary(x, other, op_type, reverse=False):
    from ..framework.core import Variable
    from ..framework.layer_helper import LayerHelper

    if not isinstance(x, Variable):
        raise NotImplementedError(
            "operator overloading of dygraph tensors (the JAX package's "
            "dygraph varbase_patch) waits for the port's dygraph/ package "
            "(ROADMAP.md queue 1, item 8)")
    helper = LayerHelper(op_type)
    if isinstance(other, (int, float, np.number)):
        const = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op("fill_constant", outputs={"Out": [const]},
                         attrs={"shape": [1], "dtype": x.dtype,
                                "value": float(other)})
        const.stop_gradient = True
        other = const
    a, b = (other, x) if reverse else (x, other)
    out_dtype = "bool" if op_type in _COMPARISONS else a.dtype
    out = helper.create_variable_for_type_inference(out_dtype)
    helper.append_op(op_type, inputs={"X": [a], "Y": [b]},
                     outputs={"Out": [out]}, attrs={"axis": -1})
    return out
