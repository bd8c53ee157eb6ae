"""Graph-building NN layers: the subset of ``paddle_tpu/layers/nn.py`` on
the BERT, Llama, Wide&Deep, LeNet and ResNet paths (Llama generation's
dense and paged KV-cache ops, the LR decays' and clips' pointwise ops,
convolution, pooling and batch norm included), with the same arguments,
ops and attrs (static graph only)."""
from __future__ import annotations

import numpy as np

from ..framework.initializer import ConstantInitializer, NormalInitializer
from ..framework.layer_helper import LayerHelper

__all__ = ["fc", "layer_norm", "embedding", "softmax", "log_softmax",
           "matmul",
           "flash_attention",
           "flash_attention_qkv", "dropout", "sqrt", "silu", "exp", "cos",
           "floor", "ceil", "sigmoid", "square", "relu", "tanh", "flatten",
           "clip", "clip_by_norm", "mean",
           "rms_norm", "rope", "kv_cache_write", "kv_cache_insert",
           "kv_pool_write", "kv_pool_gather", "cached_attention",
           "conv2d", "conv2d_transpose", "pool2d", "adaptive_pool2d",
           "batch_norm"]


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """Fully-connected layer: flattens each input to 2-D at
    num_flatten_dims and matmuls it against its own [in, size] weight;
    several inputs' products are added by one ``sum`` op."""
    helper = LayerHelper("fc", name=name)
    inputs = input if isinstance(input, (list, tuple)) else [input]
    mul_results = []
    for x in inputs:
        in_features = int(np.prod(x.shape[num_flatten_dims:]))
        w = helper.create_parameter(param_attr, [in_features, size], x.dtype)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op("mul", inputs={"X": [x], "Y": [w]},
                         outputs={"Out": [out]},
                         attrs={"x_num_col_dims": num_flatten_dims,
                                "y_num_col_dims": 1})
        mul_results.append(out)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(inputs[0].dtype)
        helper.append_op("sum", inputs={"X": mul_results},
                         outputs={"Out": [pre_bias]})
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


def softmax(input, axis=-1, name=None, use_cudnn=False):
    helper = LayerHelper("softmax", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("softmax", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def log_softmax(input, axis=-1, name=None):
    helper = LayerHelper("log_softmax", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("log_softmax", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("matmul", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"transpose_X": transpose_x,
                            "transpose_Y": transpose_y, "alpha": alpha})
    return out


def flash_attention(q, k, v, bias=None, causal=False, scale=None,
                    seq_parallel_mode="ring", impl="auto", layout="bhsd",
                    dropout_prob=0.0, is_test=False, name=None):
    """Fused multi-head attention; q: [B, H, Sq, D], k/v: [B, H, Sk, D].

    bias: optional additive score bias [B, Sk] (or [B, 1, 1, Sk]), the
    padding mask.  On the card it runs the Hopper kernels
    (ops/attention_ops.py); ``impl="xla"`` runs the einsum formulation
    (layouts ``bhsd`` / ``bshd``, in-op probability dropout).
    """
    helper = LayerHelper("flash_attention", name=name)
    out = helper.create_variable_for_type_inference(q.dtype)
    attrs = {"causal": causal, "seq_parallel_mode": seq_parallel_mode,
             "impl": impl, "layout": layout,
             "dropout_prob": float(dropout_prob), "is_test": is_test}
    if scale is not None:
        attrs["scale"] = float(scale)
    inputs = {"Q": [q], "K": [k], "V": [v]}
    if bias is not None:
        inputs["Bias"] = [bias]
    helper.append_op("flash_attention", inputs=inputs,
                     outputs={"Out": [out]}, attrs=attrs)
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


def _unary(op_type):
    def f(x, name=None, **attrs):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(op_type, inputs={"X": [x]},
                         outputs={"Out": [out]}, attrs=attrs)
        return out
    f.__name__ = op_type
    return f


sqrt = _unary("sqrt")
silu = _unary("silu")
exp = _unary("exp")
cos = _unary("cos")
floor = _unary("floor")
ceil = _unary("ceil")
sigmoid = _unary("sigmoid")
square = _unary("square")
relu = _unary("relu")
tanh = _unary("tanh")


def flatten(x, axis=1, name=None):
    """-> flatten2: x as 2-D, the dims before `axis` into rows."""
    helper = LayerHelper("flatten", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("flatten2", inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axis": axis})
    return out


def clip(x, min, max, name=None):
    helper = LayerHelper("clip", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("clip", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"min": min, "max": max})
    return out


def clip_by_norm(x, max_norm, name=None):
    helper = LayerHelper("clip_by_norm", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("clip_by_norm", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"max_norm": max_norm})
    return out


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("mean", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def rms_norm(x, epsilon=1e-6, param_attr=None, name=None):
    """RMSNorm over the last dim, with a [H] scale initialised to 1."""
    helper = LayerHelper("rms_norm", name=name)
    scale = helper.create_parameter(
        param_attr, [x.shape[-1]], "float32",
        default_initializer=ConstantInitializer(1.0))
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("rms_norm", inputs={"X": [x], "Scale": [scale]},
                     outputs={"Y": [out]}, attrs={"epsilon": epsilon})
    return out


def rope(x, base=10000.0, position_offset=0, offset=None, name=None):
    """Rotary position embedding; x: [B, H, S, D].

    ``offset``: optional [B] int Variable of per-row position offsets
    (row b's S positions start at ``offset[b]``); the static
    ``position_offset`` attr applies when it is absent."""
    helper = LayerHelper("rope", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    inputs = {"X": [x]}
    if offset is not None:
        inputs["Offset"] = [offset]
    helper.append_op("rope", inputs=inputs, outputs={"Out": [out]},
                     attrs={"base": base,
                            "position_offset": position_offset})
    return out


def kv_cache_write(cache, new, positions, name=None):
    """Write the step's fresh K/V rows into a persistent decode cache in
    place: ``cache`` [B, Hkv, S_max, D] gets ``new`` [B, Hkv, T, D] at
    per-row sequence offset ``positions`` [B].  The op's output is the
    cache variable itself, so the executor treats the cache as state the
    step updates (in its own storage).  Returns the cache Variable."""
    helper = LayerHelper("kv_cache_write", name=name)
    helper.append_op("kv_cache_write",
                     inputs={"Cache": [cache], "New": [new],
                             "Positions": [positions]},
                     outputs={"Out": [cache]})
    return cache


def kv_cache_insert(cache, new, slot, name=None):
    """Prefill-time cache population, in place: ``cache`` [slots, Hkv,
    S_max, D] gets ``new`` [1, Hkv, S_b, D] at slot index ``slot`` ([1]
    int32 Variable), sequence offset 0.  Returns the cache Variable."""
    helper = LayerHelper("kv_cache_insert", name=name)
    helper.append_op("kv_cache_insert",
                     inputs={"Cache": [cache], "New": [new],
                             "Slot": [slot]},
                     outputs={"Out": [cache]})
    return cache


def kv_pool_write(pool, new, positions, block_table, lengths, name=None):
    """Paged-cache write, in place: ``pool`` [P, Hkv, pt, D] gets row
    (b, t) of ``new`` [B, Hkv, T, D] at logical position
    ``positions[b] + t`` of slot b, routed through ``block_table``
    [B, NP] to a physical page; rows with ``t >= lengths[b]`` go to the
    reserved trash page 0.  The output is the pool variable itself, as
    :func:`kv_cache_write`'s is the cache.  Returns the pool Variable."""
    helper = LayerHelper("kv_pool_write", name=name)
    helper.append_op("kv_pool_write",
                     inputs={"Pool": [pool], "New": [new],
                             "Positions": [positions],
                             "BlockTable": [block_table],
                             "Lengths": [lengths]},
                     outputs={"Out": [pool]})
    return pool


def kv_pool_gather(pool, block_table, name=None):
    """A slot's pages back in the dense logical cache layout: ``pool``
    [P, Hkv, pt, D] through ``block_table`` [B, NP] -> [B, Hkv, NP*pt, D]
    (column j = logical position j, what :func:`cached_attention` reads
    from a dense cache)."""
    helper = LayerHelper("kv_pool_gather", name=name)
    out = helper.create_variable_for_type_inference(pool.dtype)
    helper.append_op("kv_pool_gather",
                     inputs={"Pool": [pool], "BlockTable": [block_table]},
                     outputs={"Out": [out]})
    return out


def cached_attention(q, cache_k, cache_v, positions, scale=None,
                     name=None):
    """Decode-step attention over a KV cache: ``q`` [B, H, T, D] attends
    ``cache_k`` / ``cache_v`` [B, Hkv, S_max, D] with per-row validity
    ``j <= positions[b] + t`` (``positions`` [B] = pre-step sequence
    length).  GQA caches pair query head h with kv head h // (H / Hkv).
    Returns [B, H, T, D]."""
    helper = LayerHelper("cached_attention", name=name)
    out = helper.create_variable_for_type_inference(q.dtype)
    attrs = {}
    if scale is not None:
        attrs["scale"] = float(scale)
    helper.append_op("cached_attention",
                     inputs={"Q": [q], "K": [cache_k], "V": [cache_v],
                             "Positions": [positions]},
                     outputs={"Out": [out]}, attrs=attrs)
    return out


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None, data_format="NCHW"):
    """A 2-D convolution: an OIHW filter drawn from Normal(0, sqrt(2 /
    fan_in)), the bias added on the channel axis by elementwise_add."""
    helper = LayerHelper("conv2d", name=name)
    if isinstance(filter_size, int):
        filter_size = [filter_size, filter_size]
    if isinstance(stride, int):
        stride = [stride, stride]
    if isinstance(dilation, int):
        dilation = [dilation, dilation]
    if isinstance(padding, int):
        padding = [padding, padding]
    c_in = input.shape[1] if data_format == "NCHW" else input.shape[-1]
    w_shape = [num_filters, c_in // groups] + list(filter_size)
    fan_in = (c_in // groups) * filter_size[0] * filter_size[1]
    std = (2.0 / fan_in) ** 0.5
    w = helper.create_parameter(
        param_attr, w_shape, input.dtype,
        default_initializer=NormalInitializer(0.0, std))
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("conv2d",
                     inputs={"Input": [input], "Filter": [w]},
                     outputs={"Output": [out]},
                     attrs={"strides": stride, "paddings": padding,
                            "dilations": dilation, "groups": groups,
                            "data_format": data_format})
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [num_filters], input.dtype,
                                    is_bias=True)
        pre_act = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op("elementwise_add", inputs={"X": [out], "Y": [b]},
                         outputs={"Out": [pre_act]},
                         attrs={"axis": 1 if data_format == "NCHW" else 3})
    else:
        pre_act = out
    return helper.append_activation(pre_act, act)


def conv2d_transpose(*args, **kwargs):
    raise NotImplementedError(
        "conv2d_transpose is not ported yet (ROADMAP.md queue 1, item 7: "
        "the rest of nn_ops)")


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, name=None, exclusive=True,
           data_format="NCHW"):
    helper = LayerHelper("pool2d", name=name)
    if isinstance(pool_size, int):
        pool_size = [pool_size, pool_size]
    if isinstance(pool_stride, int):
        pool_stride = [pool_stride, pool_stride]
    if isinstance(pool_padding, int):
        pool_padding = [pool_padding, pool_padding]
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("pool2d", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"pooling_type": pool_type, "ksize": pool_size,
                            "strides": pool_stride,
                            "paddings": pool_padding,
                            "global_pooling": global_pooling,
                            "ceil_mode": ceil_mode, "exclusive": exclusive,
                            "data_format": data_format})
    return out


def adaptive_pool2d(input, pool_size, pool_type="max", name=None):
    helper = LayerHelper("adaptive_pool2d", name=name)
    if isinstance(pool_size, int):
        pool_size = [pool_size, pool_size]
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("pool2d", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"pooling_type": pool_type, "ksize": pool_size,
                            "adaptive": True})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               name=None, moving_mean_name=None, moving_variance_name=None,
               do_model_average_for_mean_and_var=True,
               use_global_stats=False):
    """Batch norm: float32 scale (1) and bias (0) parameters, and the
    moving mean and variance as persistable state, set to 0 and 1 by the
    startup program and rewritten by each training step."""
    from ..framework.core import unique_name

    helper = LayerHelper("batch_norm", name=name)
    c = (input.shape[1] if data_layout == "NCHW" else input.shape[-1])
    dtype = "float32"
    scale = helper.create_parameter(
        param_attr, [c], dtype,
        default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(bias_attr, [c], dtype, is_bias=True)
    gb = helper.main_program.global_block()
    mean_name = moving_mean_name or unique_name(f"{helper.name}.mean")
    var_name = moving_variance_name or unique_name(f"{helper.name}.var")
    mean = gb.create_var(name=mean_name, shape=[c], dtype=dtype,
                         persistable=True, stop_gradient=True)
    variance = gb.create_var(name=var_name, shape=[c], dtype=dtype,
                             persistable=True, stop_gradient=True)
    ConstantInitializer(0.0)(mean, helper.startup_program.global_block())
    ConstantInitializer(1.0)(variance, helper.startup_program.global_block())
    saved_mean = helper.create_variable_for_type_inference(dtype)
    saved_var = helper.create_variable_for_type_inference(dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "batch_norm",
        inputs={"X": [input], "Scale": [scale], "Bias": [bias],
                "Mean": [mean], "Variance": [variance]},
        outputs={"Y": [out], "MeanOut": [mean], "VarianceOut": [variance],
                 "SavedMean": [saved_mean], "SavedVariance": [saved_var]},
        attrs={"momentum": momentum, "epsilon": epsilon,
               "is_test": is_test, "data_layout": data_layout,
               "use_global_stats": use_global_stats})
    return helper.append_activation(out, act)
