"""Graph-building tensor layers: the subset of
``paddle_tpu/layers/tensor.py`` on the BERT and Llama paths (training
and its LR decays included), with the same arguments, ops and attrs."""
from __future__ import annotations

from ..framework.core import (default_main_program, default_startup_program,
                              unique_name)
from ..framework.layer_helper import LayerHelper

__all__ = [
    "data", "fill_constant", "create_global_var", "cast", "concat", "sums",
    "reshape", "transpose", "squeeze", "unsqueeze", "stack", "slice",
    "gather_nd", "expand", "tile", "range", "argmax", "argmin",
    "reduce_sum", "reduce_mean", "elementwise_add", "elementwise_sub",
    "elementwise_mul", "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow", "less_than", "equal", "scale", "pow", "increment",
    "where", "clip",
]


def data(name, shape, dtype="float32", append_batch_size=True,
         lod_level=0, type=None, stop_gradient=True):
    """Declares a feed var; append_batch_size=True prepends a -1 batch
    dim."""
    shape = list(shape)
    if append_batch_size and (not shape or shape[0] != -1):
        shape = [-1] + shape
    block = default_main_program().global_block()
    return block.create_var(name=name, shape=shape, dtype=dtype,
                            is_data=True, stop_gradient=stop_gradient,
                            need_check_feed=True)


def fill_constant(shape, dtype, value, force_cpu=False, out=None, name=None):
    helper = LayerHelper("fill_constant", name=name)
    if out is None:
        out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("fill_constant", outputs={"Out": [out]},
                     attrs={"shape": list(shape), "dtype": dtype,
                            "value": float(value)})
    out.stop_gradient = True
    return out


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """Persistable var in the main program, filled by the startup
    program."""
    main_block = default_main_program().global_block()
    name = name or unique_name("global_var")
    var = main_block.create_var(name=name, shape=list(shape), dtype=dtype,
                                persistable=persistable, stop_gradient=True)
    sb = default_startup_program().global_block()
    sb.create_var(name=name, shape=list(shape), dtype=dtype,
                  persistable=persistable)
    sb.append_op("fill_constant", outputs={"Out": [name]},
                 attrs={"shape": list(shape), "dtype": dtype,
                        "value": float(value)})
    return var


def cast(x, dtype):
    helper = LayerHelper("cast")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("cast", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"out_dtype": dtype, "in_dtype": x.dtype})
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op("concat", inputs={"X": list(input)},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def sums(input, out=None):
    helper = LayerHelper("sum")
    if out is None:
        out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op("sum", inputs={"X": list(input)},
                     outputs={"Out": [out]})
    return out


def _reduce(op_type):
    def f(input, dim=None, keep_dim=False, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(input.dtype)
        if dim is None:
            attrs = {"dim": [0], "reduce_all": True, "keep_dim": keep_dim}
        else:
            dims = dim if isinstance(dim, (list, tuple)) else [dim]
            attrs = {"dim": list(dims), "reduce_all": False,
                     "keep_dim": keep_dim}
        helper.append_op(op_type, inputs={"X": [input]},
                         outputs={"Out": [out]}, attrs=attrs)
        return out
    f.__name__ = op_type
    return f


reduce_sum = _reduce("reduce_sum")
reduce_mean = _reduce("reduce_mean")


def _binary(op_type):
    def f(x, y, axis=-1, act=None, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(op_type, inputs={"X": [x], "Y": [y]},
                         outputs={"Out": [out]}, attrs={"axis": axis})
        return helper.append_activation(out, act)
    f.__name__ = op_type
    return f


elementwise_add = _binary("elementwise_add")
elementwise_sub = _binary("elementwise_sub")
elementwise_mul = _binary("elementwise_mul")
elementwise_div = _binary("elementwise_div")
elementwise_max = _binary("elementwise_max")
elementwise_min = _binary("elementwise_min")
elementwise_pow = _binary("elementwise_pow")


def _cmp(op_type):
    def f(x, y, cond=None, name=None):
        helper = LayerHelper(op_type, name=name)
        out = cond or helper.create_variable_for_type_inference("bool")
        helper.append_op(op_type, inputs={"X": [x], "Y": [y]},
                         outputs={"Out": [out]})
        return out
    f.__name__ = op_type
    return f


less_than = _cmp("less_than")
equal = _cmp("equal")


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    helper = LayerHelper("scale", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("scale", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"scale": float(scale), "bias": float(bias),
                            "bias_after_scale": bias_after_scale})
    return helper.append_activation(out, act)


def pow(x, factor=1.0, name=None):
    helper = LayerHelper("pow", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("pow", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"factor": factor})
    return out


def clip(x, min, max, name=None):
    from .nn import clip as _clip
    return _clip(x, min, max, name)


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_variable_for_type_inference(
        x.dtype)
    helper.append_op("increment", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"step": float(value)})
    return out


def where(condition, x, y, name=None):
    helper = LayerHelper("where", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("where",
                     inputs={"Condition": [condition], "X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out


def reshape(x, shape, actual_shape=None, act=None, inplace=False,
            name=None):
    helper = LayerHelper("reshape", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("reshape2", inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"shape": list(shape)})
    return helper.append_activation(out, act)


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("transpose2", inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axis": list(perm)})
    return out


def squeeze(input, axes, name=None):
    helper = LayerHelper("squeeze", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    xshape = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("squeeze2", inputs={"X": [input]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axes": list(axes)})
    return out


def unsqueeze(input, axes, name=None):
    helper = LayerHelper("unsqueeze", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    xshape = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("unsqueeze2", inputs={"X": [input]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axes": list(axes)})
    return out


def stack(x, axis=0, name=None):
    helper = LayerHelper("stack", name=name)
    out = helper.create_variable_for_type_inference(x[0].dtype)
    helper.append_op("stack", inputs={"X": list(x)}, outputs={"Y": [out]},
                     attrs={"axis": axis})
    return out


def slice(input, axes, starts, ends, name=None):
    helper = LayerHelper("slice", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("slice", inputs={"Input": [input]},
                     outputs={"Out": [out]},
                     attrs={"axes": list(axes), "starts": list(starts),
                            "ends": list(ends)})
    return out


def gather_nd(input, index, name=None):
    helper = LayerHelper("gather_nd", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("gather_nd", inputs={"X": [input], "Index": [index]},
                     outputs={"Out": [out]})
    return out


def expand(x, expand_times, name=None):
    helper = LayerHelper("expand", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("expand", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"expand_times": list(expand_times)})
    return out


def tile(x, repeat_times, name=None):
    helper = LayerHelper("tile", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("tile", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"repeat_times": list(repeat_times)})
    return out


def range(start, end, step, dtype, name=None):
    helper = LayerHelper("range", name=name)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("range", outputs={"Out": [out]},
                     attrs={"start": start, "end": end, "step": step,
                            "dtype": dtype})
    return out


def argmax(x, axis=0, name=None):
    helper = LayerHelper("arg_max", name=name)
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op("arg_max", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"axis": axis})
    return out


def argmin(x, axis=0, name=None):
    helper = LayerHelper("arg_min", name=name)
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op("arg_min", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"axis": axis})
    return out
