"""Graph-building NN layers: the subset of ``paddle_tpu/layers/nn.py`` on
the BERT path, with the same arguments, ops and attrs (static graph
only)."""
from __future__ import annotations

import numpy as np

from ..framework.initializer import ConstantInitializer
from ..framework.layer_helper import LayerHelper

__all__ = ["fc", "layer_norm", "embedding", "flash_attention_qkv",
           "dropout", "sqrt"]


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """Fully-connected layer: flattens input to 2-D at num_flatten_dims,
    matmuls against a [in, size] weight."""
    helper = LayerHelper("fc", name=name)
    inputs = input if isinstance(input, (list, tuple)) else [input]
    if len(inputs) != 1:
        raise NotImplementedError("fc over several inputs needs the `sum` "
                                  "op, which the port does not lower yet")
    x = inputs[0]
    in_features = int(np.prod(x.shape[num_flatten_dims:]))
    w = helper.create_parameter(param_attr, [in_features, size], x.dtype)
    pre_bias = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("mul", inputs={"X": [x], "Y": [w]},
                     outputs={"Out": [pre_bias]},
                     attrs={"x_num_col_dims": num_flatten_dims,
                            "y_num_col_dims": 1})
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [size], pre_bias.dtype,
                                    is_bias=True)
        pre_act = helper.create_variable_for_type_inference(pre_bias.dtype)
        helper.append_op("elementwise_add",
                         inputs={"X": [pre_bias], "Y": [b]},
                         outputs={"Out": [pre_act]},
                         attrs={"axis": num_flatten_dims})
    else:
        pre_act = pre_bias
    return helper.append_activation(pre_act, act)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper("layer_norm", name=name)
    n = int(np.prod(input.shape[begin_norm_axis:]))
    inputs = {"X": [input]}
    if scale:
        s = helper.create_parameter(
            param_attr, [n], "float32",
            default_initializer=ConstantInitializer(1.0))
        inputs["Scale"] = [s]
    if shift:
        b = helper.create_parameter(bias_attr, [n], "float32", is_bias=True)
        inputs["Bias"] = [b]
    out = helper.create_variable_for_type_inference(input.dtype)
    mean = helper.create_variable_for_type_inference("float32")
    var = helper.create_variable_for_type_inference("float32")
    helper.append_op("layer_norm", inputs=inputs,
                     outputs={"Y": [out], "Mean": [mean], "Variance": [var]},
                     attrs={"epsilon": epsilon,
                            "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(out, act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32",
              name=None):
    """-> lookup_table_v2."""
    helper = LayerHelper("embedding", name=name)
    w = helper.create_parameter(param_attr, list(size), dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("lookup_table_v2",
                     inputs={"W": [w], "Ids": [input]},
                     outputs={"Out": [out]},
                     attrs={"padding_idx": -1 if padding_idx is None
                            else padding_idx,
                            "is_sparse": is_sparse,
                            "is_distributed": is_distributed})
    return out


def flash_attention_qkv(qkv, num_heads, bias=None, causal=False,
                        scale=None, name=None):
    """Transpose-free fused attention on a packed QKV projection.

    qkv: [B, S, 3H], returns [B, S, H]; bias: optional [B, S] additive
    score rows (padding mask).  On the card it runs the Hopper kernel
    (ops/attention_ops.py).
    """
    helper = LayerHelper("flash_attention_qkv", name=name)
    out = helper.create_variable_for_type_inference(qkv.dtype)
    attrs = {"num_heads": int(num_heads), "causal": causal}
    if scale is not None:
        attrs["scale"] = float(scale)
    inputs = {"QKV": [qkv]}
    if bias is not None:
        inputs["Bias"] = [bias]
    helper.append_op("flash_attention_qkv", inputs=inputs,
                     outputs={"Out": [out]}, attrs=attrs)
    return out


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    """No Mask output: the grad replays the mask from the per-op
    generator, so nothing consumes one."""
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("dropout", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"dropout_prob": dropout_prob, "is_test": is_test,
                            "seed": seed or 0,
                            "dropout_implementation": dropout_implementation})
    return out


def sqrt(x, name=None):
    helper = LayerHelper("sqrt", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("sqrt", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={})
    return out
