"""Every op the port lowers, against the JAX package's lowering.

Each case builds the same one-op program in both packages (the two share
the Program / append_op / Executor API), feeds the same numpy inputs, and
compares the fetches.  fp32; atol 1e-5 plus rtol 1e-5 for the ops that
reduce or take a product (different summation order), exact for the rest.
``uniform_random`` draws from a different generator than jax.random, so it
is checked for range, moments and determinism instead.

The grad cases append ``loss = reduce_sum(out * cot)`` (cot a fed random
cotangent) and ``append_backward`` in both packages, and compare the
inputs' ``@GRAD`` vars (jax.vjp against torch.autograd.grad of the same
forward lowering): atol 1e-5, rtol 1e-5.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt

R = np.random.RandomState(1234)


def _f(*shape):
    return R.randn(*shape).astype("float32")


def _run(pkg, op_type, inputs, outputs, attrs, fetch):
    """Build {op_type} over data vars holding `inputs` ({slot: {name:
    array}}), run it, return the `fetch` values as numpy."""
    main = pkg.Program()
    block = main.global_block()
    feed = {}
    for slot, named in inputs.items():
        for name, arr in named.items():
            block.create_var(name=name, shape=list(arr.shape),
                             dtype=str(arr.dtype), is_data=True)
            feed[name] = arr
    block.append_op(op_type,
                    inputs={s: list(n) for s, n in inputs.items()},
                    outputs={s: list(n) for s, n in outputs.items()},
                    attrs=dict(attrs))
    exe = pkg.Executor(pkg.CPUPlace())
    return exe.run(main, feed=feed, fetch_list=fetch, scope=pkg.Scope())


# (id, op, inputs, outputs, attrs, fetch, exact)
CASES = [
    ("fill_constant_f32", "fill_constant", {}, {"Out": ["o"]},
     {"shape": [2, 3], "dtype": "float32", "value": 1.5}, ["o"], True),
    ("fill_constant_i64", "fill_constant", {}, {"Out": ["o"]},
     {"shape": [4], "dtype": "int64", "value": 7.0}, ["o"], True),
    ("fill_constant_str_value", "fill_constant", {}, {"Out": ["o"]},
     {"shape": [3], "dtype": "float32", "value": 0.0, "str_value": "2.25"},
     ["o"], True),
    ("fill_constant_value_tensor", "fill_constant",
     {"ValueTensor": {"vt": np.array([3.5], "float32")}}, {"Out": ["o"]},
     {"shape": [2, 2], "dtype": "float32", "value": 0.0}, ["o"], True),
    ("range_i64", "range", {}, {"Out": ["o"]},
     {"start": 0, "end": 10, "step": 2, "dtype": "int64"}, ["o"], True),
    ("range_f32", "range", {}, {"Out": ["o"]},
     {"start": 0.5, "end": 3.0, "step": 0.5, "dtype": "float32"}, ["o"],
     True),
    ("squeeze2", "squeeze2", {"X": {"x": _f(2, 1, 3, 1)}},
     {"Out": ["o"], "XShape": ["xs"]}, {"axes": [1, -1]}, ["o"], True),
    ("unsqueeze2", "unsqueeze2", {"X": {"x": _f(2, 3)}},
     {"Out": ["o"], "XShape": ["xs"]}, {"axes": [0, 2]}, ["o"], True),
    ("lookup_table_v2", "lookup_table_v2",
     {"W": {"w": _f(10, 4)},
      "Ids": {"ids": R.randint(0, 10, (2, 3)).astype("int64")}},
     {"Out": ["o"]}, {"padding_idx": -1}, ["o"], True),
    ("lookup_table_v2_padding_idx", "lookup_table_v2",
     {"W": {"w": _f(10, 4)},
      "Ids": {"ids": np.array([[2, 5, 2], [0, 2, 9]], "int64")}},
     {"Out": ["o"]}, {"padding_idx": 2}, ["o"], True),
    ("elementwise_add_axis1", "elementwise_add",
     {"X": {"x": _f(2, 3, 4)}, "Y": {"y": _f(3)}}, {"Out": ["o"]},
     {"axis": 1}, ["o"], True),
    ("elementwise_add_axis0", "elementwise_add",
     {"X": {"x": _f(2, 3, 4)}, "Y": {"y": _f(2, 3)}}, {"Out": ["o"]},
     {"axis": 0}, ["o"], True),
    ("elementwise_add_trailing", "elementwise_add",
     {"X": {"x": _f(2, 3, 4)}, "Y": {"y": _f(3, 4)}}, {"Out": ["o"]},
     {"axis": -1}, ["o"], True),
    ("elementwise_add_scalar_plus_1", "elementwise_add",
     {"X": {"x": np.float32(2.5).reshape(())}, "Y": {"y": _f(1)}},
     {"Out": ["o"]}, {"axis": -1}, ["o"], True),
    ("elementwise_mul", "elementwise_mul",
     {"X": {"x": _f(2, 3)}, "Y": {"y": _f(2, 3)}}, {"Out": ["o"]},
     {"axis": -1}, ["o"], True),
    ("elementwise_mul_axis2", "elementwise_mul",
     {"X": {"x": _f(2, 3, 4)}, "Y": {"y": _f(4)}}, {"Out": ["o"]},
     {"axis": 2}, ["o"], True),
    ("elementwise_div", "elementwise_div",
     {"X": {"x": _f(2, 3)}, "Y": {"y": _f(3) + 3.0}}, {"Out": ["o"]},
     {"axis": -1}, ["o"], True),
    ("scale_after", "scale", {"X": {"x": _f(2, 3)}}, {"Out": ["o"]},
     {"scale": 2.0, "bias": 1.0, "bias_after_scale": True}, ["o"], True),
    ("scale_before", "scale", {"X": {"x": _f(2, 3)}}, {"Out": ["o"]},
     {"scale": 2.0, "bias": 1.0, "bias_after_scale": False}, ["o"], True),
    ("scale_tensor", "scale",
     {"X": {"x": _f(2, 3)}, "ScaleTensor": {"st": np.array([0.5], "float32")}},
     {"Out": ["o"]}, {"scale": 2.0, "bias": 1.0, "bias_after_scale": True},
     ["o"], True),
    ("mul_flatten_2", "mul", {"X": {"x": _f(2, 3, 4)}, "Y": {"y": _f(4, 5)}},
     {"Out": ["o"]}, {"x_num_col_dims": 2, "y_num_col_dims": 1}, ["o"],
     False),
    ("mul_flatten_1", "mul", {"X": {"x": _f(2, 3, 4)}, "Y": {"y": _f(12, 5)}},
     {"Out": ["o"]}, {"x_num_col_dims": 1, "y_num_col_dims": 1}, ["o"],
     False),
    ("mul_y_flatten_2", "mul",
     {"X": {"x": _f(3, 6)}, "Y": {"y": _f(2, 3, 5)}},
     {"Out": ["o"]}, {"x_num_col_dims": 1, "y_num_col_dims": 2}, ["o"],
     False),
    ("gelu_erf", "gelu", {"X": {"x": _f(4, 5) * 3}}, {"Out": ["o"]}, {},
     ["o"], False),
    ("gelu_tanh", "gelu", {"X": {"x": _f(4, 5) * 3}}, {"Out": ["o"]},
     {"approximate": True}, ["o"], False),
    ("reduce_sum_dim1", "reduce_sum", {"X": {"x": _f(2, 3, 4)}},
     {"Out": ["o"]}, {"dim": [1], "keep_dim": False, "reduce_all": False},
     ["o"], False),
    ("reduce_sum_keep", "reduce_sum", {"X": {"x": _f(2, 3, 4)}},
     {"Out": ["o"]}, {"dim": [0, -1], "keep_dim": True, "reduce_all": False},
     ["o"], False),
    ("reduce_sum_all", "reduce_sum", {"X": {"x": _f(2, 3, 4)}},
     {"Out": ["o"]}, {"dim": [0], "keep_dim": False, "reduce_all": True},
     ["o"], False),
    ("reduce_sum_out_dtype", "reduce_sum",
     {"X": {"x": R.randint(0, 5, (3, 4)).astype("int32")}},
     {"Out": ["o"]}, {"dim": [1], "keep_dim": False, "reduce_all": False,
                      "out_dtype": "float32"}, ["o"], True),
    ("layer_norm_axis2", "layer_norm",
     {"X": {"x": _f(2, 3, 8) * 2 + 1}, "Scale": {"s": _f(8)},
      "Bias": {"b": _f(8)}},
     {"Y": ["y"], "Mean": ["m"], "Variance": ["v"]},
     {"epsilon": 1e-5, "begin_norm_axis": 2}, ["y", "m", "v"], False),
    ("layer_norm_axis1", "layer_norm",
     {"X": {"x": _f(2, 3, 8)}, "Scale": {"s": _f(24)},
      "Bias": {"b": _f(24)}},
     {"Y": ["y"], "Mean": ["m"], "Variance": ["v"]},
     {"epsilon": 1e-3, "begin_norm_axis": 1}, ["y", "m", "v"], False),
    ("softmax_with_cross_entropy", "softmax_with_cross_entropy",
     {"Logits": {"lg": _f(2, 3, 7) * 4},
      "Label": {"lab": R.randint(0, 7, (2, 3, 1)).astype("int64")}},
     {"Softmax": ["sm"], "Loss": ["loss"]},
     {"soft_label": False, "ignore_index": -100, "axis": -1},
     ["loss", "sm"], False),
    ("softmax_with_cross_entropy_ignore", "softmax_with_cross_entropy",
     {"Logits": {"lg": _f(4, 7)},
      "Label": {"lab": np.array([[1], [3], [3], [6]], "int64")}},
     {"Softmax": ["sm"], "Loss": ["loss"]},
     {"soft_label": False, "ignore_index": 3, "axis": -1},
     ["loss"], False),
    ("softmax_with_cross_entropy_soft", "softmax_with_cross_entropy",
     {"Logits": {"lg": _f(3, 6)},
      "Label": {"lab": np.full((3, 6), 1.0 / 6, "float32")}},
     {"Softmax": ["sm"], "Loss": ["loss"]},
     {"soft_label": True, "ignore_index": -100, "axis": -1},
     ["loss"], False),
    ("flash_attention_qkv_bias", "flash_attention_qkv",
     {"QKV": {"qkv": _f(2, 16, 3 * 128)},
      "Bias": {"bias": np.where(R.rand(2, 16) > 0.3, 0.0, -1e4)
               .astype("float32")}},
     {"Out": ["o"]}, {"num_heads": 2, "causal": False}, ["o"], False),
    ("flash_attention_qkv_causal_d128", "flash_attention_qkv",
     {"QKV": {"qkv": _f(2, 16, 3 * 256)}},
     {"Out": ["o"]}, {"num_heads": 2, "causal": True, "scale": 0.1}, ["o"],
     False),
    ("flash_attention_qkv_unpacked_width", "flash_attention_qkv",
     {"QKV": {"qkv": _f(2, 8, 3 * 48)}},
     {"Out": ["o"]}, {"num_heads": 3, "causal": False}, ["o"], False),
    ("dropout_is_test_upscale", "dropout", {"X": {"x": _f(3, 4)}},
     {"Out": ["o"], "Mask": ["m"]},
     {"dropout_prob": 0.3, "is_test": True,
      "dropout_implementation": "upscale_in_train"}, ["o", "m"], True),
    ("dropout_is_test_downgrade", "dropout", {"X": {"x": _f(3, 4)}},
     {"Out": ["o"]},
     {"dropout_prob": 0.3, "is_test": True,
      "dropout_implementation": "downgrade_in_infer"}, ["o"], True),
    ("dropout_train_p0", "dropout", {"X": {"x": _f(3, 4)}},
     {"Out": ["o"], "Mask": ["m"]},
     {"dropout_prob": 0.0, "is_test": False,
      "dropout_implementation": "upscale_in_train"}, ["o", "m"], True),
    ("dropout_train_p1", "dropout", {"X": {"x": _f(3, 4)}},
     {"Out": ["o"], "Mask": ["m"]},
     {"dropout_prob": 1.0, "is_test": False,
      "dropout_implementation": "upscale_in_train"}, ["o", "m"], True),
    ("sqrt", "sqrt", {"X": {"x": np.abs(_f(3, 4)) + 0.1}}, {"Out": ["o"]},
     {}, ["o"], False),
    ("elementwise_max", "elementwise_max",
     {"X": {"x": _f(3, 4)}, "Y": {"y": _f(4)}}, {"Out": ["o"]},
     {"axis": -1}, ["o"], True),
    ("elementwise_max_0d_1d", "elementwise_max",
     {"X": {"x": np.float32(0.5).reshape(())},
      "Y": {"y": np.array([1.0], "float32")}}, {"Out": ["o"]},
     {"axis": -1}, ["o"], True),
    ("less_than", "less_than",
     {"X": {"x": _f(6)}, "Y": {"y": np.array([0.0], "float32")}},
     {"Out": ["o"]}, {}, ["o"], True),
    ("cast_f32_i64", "cast",
     {"X": {"x": np.array([2.7, -1.5, 0.2, 9.0], "float32")}},
     {"Out": ["o"]}, {"out_dtype": "int64", "in_dtype": "float32"}, ["o"],
     True),
    ("cast_i64_f32", "cast",
     {"X": {"x": np.array([-1, 0, 7], "int64")}},
     {"Out": ["o"]}, {"out_dtype": "float32", "in_dtype": "int64"}, ["o"],
     True),
    ("sum", "sum", {"X": {"a": _f(2, 3), "b": _f(2, 3), "c": _f(2, 3)}},
     {"Out": ["o"]}, {}, ["o"], False),
    # in place, as layers.increment appends it (its infer adds no var)
    ("increment_i64", "increment",
     {"X": {"x": np.array([-1], "int64")}}, {"Out": ["x"]}, {"step": 1.0},
     ["x"], True),
    ("increment_f32", "increment", {"X": {"x": _f(3)}}, {"Out": ["x"]},
     {"step": 2.5}, ["x"], True),
    ("fill_any_like", "fill_any_like", {"X": {"x": _f(2, 3)}},
     {"Out": ["o"]}, {"value": 1.0, "dtype": "float32"}, ["o"], True),
    ("fill_any_like_keep_dtype", "fill_any_like",
     {"X": {"x": np.zeros((4,), "int64")}}, {"Out": ["o"]},
     {"value": 3.0, "dtype": -1}, ["o"], True),
    ("where", "where",
     {"Condition": {"c": R.rand(3, 4) > 0.5}, "X": {"x": _f(3, 4)},
      "Y": {"y": _f(3, 4)}}, {"Out": ["o"]}, {}, ["o"], True),
    ("adam", "adam",
     {"Param": {"p": _f(4, 3)}, "Grad": {"g": _f(4, 3) * 0.1},
      "Moment1": {"m1": _f(4, 3) * 0.01},
      "Moment2": {"m2": np.abs(_f(4, 3)) * 0.01},
      "Beta1Pow": {"b1p": np.array([0.9 ** 3], "float32")},
      "Beta2Pow": {"b2p": np.array([0.999 ** 3], "float32")},
      "LearningRate": {"lr": np.array([1e-3], "float32")}},
     {"ParamOut": ["po"], "Moment1Out": ["m1o"], "Moment2Out": ["m2o"],
      "Beta1PowOut": ["b1o"], "Beta2PowOut": ["b2o"]},
     {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8},
     ["po", "m1o", "m2o", "b1o", "b2o"], False),
    ("adamw_decay", "adamw",
     {"Param": {"p": _f(4, 3)}, "Grad": {"g": _f(4, 3) * 0.1},
      "Moment1": {"m1": _f(4, 3) * 0.01},
      "Moment2": {"m2": np.abs(_f(4, 3)) * 0.01},
      "Beta1Pow": {"b1p": np.array([0.9 ** 3], "float32")},
      "Beta2Pow": {"b2p": np.array([0.999 ** 3], "float32")},
      "LearningRate": {"lr": np.array([1e-1], "float32")}},
     {"ParamOut": ["po"], "Moment1Out": ["m1o"], "Moment2Out": ["m2o"],
      "Beta1PowOut": ["b1o"], "Beta2PowOut": ["b2o"]},
     {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8, "coeff": 0.05},
     ["po", "m1o", "m2o", "b1o", "b2o"], False),
    ("adamw_without_decay", "adamw",
     {"Param": {"p": _f(4, 3)}, "Grad": {"g": _f(4, 3) * 0.1},
      "Moment1": {"m1": _f(4, 3) * 0.01},
      "Moment2": {"m2": np.abs(_f(4, 3)) * 0.01},
      "Beta1Pow": {"b1p": np.array([0.9], "float32")},
      "Beta2Pow": {"b2p": np.array([0.999], "float32")},
      "LearningRate": {"lr": np.array([1e-1], "float32")}},
     {"ParamOut": ["po"], "Moment1Out": ["m1o"], "Moment2Out": ["m2o"],
      "Beta1PowOut": ["b1o"], "Beta2PowOut": ["b2o"]},
     {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8, "coeff": 0.05,
      "with_decay": False}, ["po", "m1o", "m2o"], False),
    ("rms_norm", "rms_norm",
     {"X": {"x": _f(2, 3, 8) * 2 + 0.5}, "Scale": {"s": _f(8)}},
     {"Y": ["y"]}, {"epsilon": 1e-6}, ["y"], False),
    ("rope_static_offset", "rope", {"X": {"x": _f(2, 3, 5, 8)}},
     {"Out": ["o"]}, {"base": 10000.0, "position_offset": 7}, ["o"],
     False),
    ("rope_offset_input", "rope",
     {"X": {"x": _f(2, 3, 5, 8)},
      "Offset": {"off": np.array([0, 41], "int32")}},
     {"Out": ["o"]}, {"base": 500.0, "position_offset": 0}, ["o"], False),
    ("silu", "silu", {"X": {"x": _f(4, 5) * 3}}, {"Out": ["o"]}, {},
     ["o"], False),
    ("mean", "mean", {"X": {"x": _f(3, 4, 5)}}, {"Out": ["o"]}, {},
     ["o"], False),
    ("reshape2", "reshape2", {"X": {"x": _f(2, 3, 4)}},
     {"Out": ["o"], "XShape": ["xs"]}, {"shape": [0, -1, 2]}, ["o"], True),
    ("transpose2", "transpose2", {"X": {"x": _f(2, 3, 4, 5)}},
     {"Out": ["o"], "XShape": ["xs"]}, {"axis": [0, 2, 1, 3]}, ["o"], True),
    ("slice", "slice", {"Input": {"x": _f(2, 3, 10)}}, {"Out": ["o"]},
     {"axes": [2, 1], "starts": [2, -2], "ends": [7, 2147483647]}, ["o"],
     True),
    ("slice_decrease_axis", "slice", {"Input": {"x": _f(4, 3, 5)}},
     {"Out": ["o"]},
     {"axes": [0, 2], "starts": [1, 0], "ends": [2, 3],
      "decrease_axis": [0]}, ["o"], True),
    ("tile", "tile", {"X": {"x": _f(2, 1, 3)}}, {"Out": ["o"]},
     {"repeat_times": [1, 4, 2]}, ["o"], True),
    ("tile_more_dims", "tile", {"X": {"x": _f(2, 3)}}, {"Out": ["o"]},
     {"repeat_times": [2, 1, 2]}, ["o"], True),
    ("flash_attention_causal", "flash_attention",
     {"Q": {"q": _f(2, 2, 24, 16)}, "K": {"k": _f(2, 2, 24, 16)},
      "V": {"v": _f(2, 2, 24, 16)}},
     {"Out": ["o"]}, {"causal": True, "impl": "auto"}, ["o"], False),
    ("flash_attention_bias_sq_ne_sk", "flash_attention",
     {"Q": {"q": _f(2, 2, 8, 16)}, "K": {"k": _f(2, 2, 24, 16)},
      "V": {"v": _f(2, 2, 24, 16)},
      "Bias": {"bias": np.where(R.rand(2, 1, 1, 24) > 0.3, 0.0, -1e4)
               .astype("float32")}},
     {"Out": ["o"]}, {"causal": False, "scale": 0.3}, ["o"], False),
    ("expand", "expand", {"X": {"x": _f(3, 1)}}, {"Out": ["o"]},
     {"expand_times": [2, 4]}, ["o"], True),
    ("stack", "stack", {"X": {"a": _f(2, 3), "b": _f(2, 3)}},
     {"Y": ["o"]}, {"axis": 2}, ["o"], True),
    ("gather_nd", "gather_nd",
     {"X": {"x": _f(3, 5, 4)},
      "Index": {"idx": np.array([[[0, 1], [2, 4]], [[1, 0], [1, 3]]],
                                "int64")}},
     {"Out": ["o"]}, {}, ["o"], True),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_matches_jax_lowering(case):
    _id, op_type, inputs, outputs, attrs, fetch, exact = case
    want = _run(jpt, op_type, inputs, outputs, attrs, fetch)
    got = _run(tpt, op_type, inputs, outputs, attrs, fetch)
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert g.shape == w.shape, (g.shape, w.shape)
        # jax without x64 hands int64 back as int32; the port keeps the
        # program's int64
        want_dtype = np.int64 if w.dtype == np.int32 else w.dtype
        assert g.dtype == want_dtype, (g.dtype, w.dtype)
        if exact:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)


def test_ported_op_set_is_the_bert_path():
    from paddle_tpu_torch.ops.registry import all_registered_ops

    main_block = {"lookup_table_v2", "range", "elementwise_add", "layer_norm",
                  "scale", "mul", "flash_attention_qkv", "gelu",
                  "unsqueeze2", "softmax_with_cross_entropy", "squeeze2",
                  "elementwise_mul", "reduce_sum", "fill_constant",
                  "elementwise_div"}
    startup = {"uniform_random", "fill_constant"}
    gather_head = {"expand", "stack", "gather_nd"}
    ported = set(all_registered_ops())
    assert main_block | startup | gather_head <= ported
    tested = {c[1] for c in CASES} | {"uniform_random"}
    assert main_block | startup | gather_head <= tested


def _uniform(pkg, seed_attr=0, random_seed=0):
    main = pkg.Program()
    main.random_seed = random_seed
    main.global_block().append_op(
        "uniform_random", outputs={"Out": ["u"]},
        attrs={"shape": [20000], "dtype": "float32", "min": -2.0,
               "max": 3.0, "seed": seed_attr})
    return np.asarray(pkg.Executor(pkg.CPUPlace()).run(
        main, fetch_list=["u"], scope=pkg.Scope())[0])


def test_uniform_random_range_moments_and_determinism():
    from paddle_tpu_torch.ops.registry import reset_op_seed

    reset_op_seed()
    a = _uniform(tpt)
    reset_op_seed()
    b = _uniform(tpt)
    c = _uniform(tpt)                     # next __op_seed__: other draw
    d = _uniform(tpt, random_seed=5)      # other program seed
    j = _uniform(jpt)
    assert a.shape == j.shape == (20000,) and a.dtype == j.dtype
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c) and not np.array_equal(c, d)
    for x in (a, j):
        assert x.min() >= -2.0 and x.max() < 3.0
        # mean 0.5, std 5/sqrt(12): 20000 draws put 5 sigma at ~0.051
        assert abs(x.mean() - 0.5) < 0.051
        assert abs(x.std() - 5 / np.sqrt(12)) < 0.03


def test_executor_without_cuda_and_without_cpu_place_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpt.Executor()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpt.Executor(tpt.CUDAPlace(0))
    assert tpt.Executor(tpt.CPUPlace()).device.type == "cpu"


def test_ported_op_set_covers_the_training_step():
    """Every op of the BERT training program (backward, clip, Adam, LR
    warmup, startup) is lowered and has a case here."""
    from paddle_tpu_torch.ops.registry import all_registered_ops

    training = {"dropout", "cast", "increment", "less_than", "where",
                "sqrt", "elementwise_max", "sum", "fill_any_like", "adam"}
    assert training <= set(all_registered_ops())
    assert training <= {c[1] for c in CASES}


def _run_grad(pkg, op_type, inputs, outputs, attrs, out_name, wrt, cot):
    """One-op program + loss = reduce_sum(out * cot) + append_backward;
    returns the `wrt` vars' grads as numpy."""
    if pkg is jpt:
        from paddle_tpu.framework.backward import append_backward
    else:
        from paddle_tpu_torch.framework.backward import append_backward
    main = pkg.Program()
    block = main.global_block()
    feed = {"cot": cot}
    for slot, named in inputs.items():
        for name, arr in named.items():
            block.create_var(name=name, shape=list(arr.shape),
                             dtype=str(arr.dtype), is_data=True,
                             stop_gradient=name not in wrt)
            feed[name] = arr
    block.create_var(name="cot", shape=list(cot.shape), dtype="float32",
                     is_data=True, stop_gradient=True)
    with pkg.program_guard(main, pkg.Program()):
        block.append_op(op_type,
                        inputs={s: list(n) for s, n in inputs.items()},
                        outputs={s: list(n) for s, n in outputs.items()},
                        attrs=dict(attrs))
        block.append_op("elementwise_mul", inputs={"X": [out_name],
                                                   "Y": ["cot"]},
                        outputs={"Out": ["prod"]}, attrs={"axis": -1})
        block.append_op("reduce_sum", inputs={"X": ["prod"]},
                        outputs={"Out": ["loss"]},
                        attrs={"dim": [0], "reduce_all": True,
                               "keep_dim": False})
        append_backward(block.var("loss"))
    exe = pkg.Executor(pkg.CPUPlace())
    return exe.run(main, feed=feed, fetch_list=[w + "@GRAD" for w in wrt],
                   scope=pkg.Scope())


def _ids(*shape, high):
    return R.randint(0, high, shape).astype("int64")


# (id, op, inputs, outputs, attrs, differentiated output, wrt, out shape)
GRAD_CASES = [
    ("elementwise_add_axis1", "elementwise_add",
     {"X": {"x": _f(2, 3, 4)}, "Y": {"y": _f(3)}}, {"Out": ["o"]},
     {"axis": 1}, "o", ["x", "y"], (2, 3, 4)),
    ("elementwise_mul_same_var", "elementwise_mul",
     {"X": {"x": _f(3, 4)}, "Y": {"x": _f(3, 4)}}, {"Out": ["o"]},
     {"axis": -1}, "o", ["x"], (3, 4)),
    ("elementwise_mul_bcast", "elementwise_mul",
     {"X": {"x": _f(3, 4)}, "Y": {"y": _f(1)}}, {"Out": ["o"]},
     {"axis": -1}, "o", ["x", "y"], (3, 4)),
    ("elementwise_div", "elementwise_div",
     {"X": {"x": _f(3, 4)}, "Y": {"y": _f(1) + 3.0}}, {"Out": ["o"]},
     {"axis": -1}, "o", ["x", "y"], (3, 4)),
    ("elementwise_max", "elementwise_max",
     {"X": {"x": _f(3, 4)}, "Y": {"y": _f(3, 4)}}, {"Out": ["o"]},
     {"axis": -1}, "o", ["x", "y"], (3, 4)),
    ("mul", "mul", {"X": {"x": _f(2, 3, 4)}, "Y": {"y": _f(4, 5)}},
     {"Out": ["o"]}, {"x_num_col_dims": 2, "y_num_col_dims": 1}, "o",
     ["x", "y"], (2, 3, 5)),
    ("gelu", "gelu", {"X": {"x": _f(4, 5) * 2}}, {"Out": ["o"]}, {}, "o",
     ["x"], (4, 5)),
    ("scale", "scale", {"X": {"x": _f(3, 4)}}, {"Out": ["o"]},
     {"scale": 3.0, "bias": 1.0, "bias_after_scale": True}, "o", ["x"],
     (3, 4)),
    ("sqrt", "sqrt", {"X": {"x": np.abs(_f(3, 4)) + 0.5}}, {"Out": ["o"]},
     {}, "o", ["x"], (3, 4)),
    ("layer_norm", "layer_norm",
     {"X": {"x": _f(2, 3, 8) * 2 + 1}, "Scale": {"s": _f(8)},
      "Bias": {"b": _f(8)}},
     {"Y": ["o"], "Mean": ["m"], "Variance": ["v"]},
     {"epsilon": 1e-5, "begin_norm_axis": 2}, "o", ["x", "s", "b"],
     (2, 3, 8)),
    ("softmax_with_cross_entropy", "softmax_with_cross_entropy",
     {"Logits": {"lg": _f(2, 3, 7) * 2},
      "Label": {"lab": _ids(2, 3, 1, high=7)}},
     {"Softmax": ["sm"], "Loss": ["o"]},
     {"soft_label": False, "ignore_index": -100, "axis": -1}, "o", ["lg"],
     (2, 3, 1)),
    ("squeeze2", "squeeze2", {"X": {"x": _f(2, 1, 3)}},
     {"Out": ["o"], "XShape": ["xs"]}, {"axes": [1]}, "o", ["x"], (2, 3)),
    ("unsqueeze2", "unsqueeze2", {"X": {"x": _f(2, 3)}},
     {"Out": ["o"], "XShape": ["xs"]}, {"axes": [2]}, "o", ["x"],
     (2, 3, 1)),
    ("reduce_sum", "reduce_sum", {"X": {"x": _f(2, 3, 4)}}, {"Out": ["o"]},
     {"dim": [1], "keep_dim": False, "reduce_all": False}, "o", ["x"],
     (2, 4)),
    ("where", "where",
     {"Condition": {"c": R.rand(3, 4) > 0.5}, "X": {"x": _f(3, 4)},
      "Y": {"y": _f(3, 4)}}, {"Out": ["o"]}, {}, "o", ["x", "y"], (3, 4)),
    ("sum", "sum", {"X": {"a": _f(2, 3), "b": _f(2, 3)}}, {"Out": ["o"]},
     {}, "o", ["a", "b"], (2, 3)),
    ("lookup_table_v2", "lookup_table_v2",
     {"W": {"w": _f(10, 4)}, "Ids": {"ids": _ids(2, 5, high=10)}},
     {"Out": ["o"]}, {"padding_idx": -1}, "o", ["w"], (2, 5, 4)),
    ("gather_nd", "gather_nd",
     {"X": {"x": _f(3, 5, 4)},
      "Index": {"idx": np.array([[[0, 1], [2, 4]], [[0, 1], [1, 3]]],
                                "int64")}},
     {"Out": ["o"]}, {}, "o", ["x"], (2, 2, 4)),
    ("expand", "expand", {"X": {"x": _f(3, 1)}}, {"Out": ["o"]},
     {"expand_times": [2, 4]}, "o", ["x"], (6, 4)),
    ("stack", "stack", {"X": {"a": _f(2, 3), "b": _f(2, 3)}},
     {"Y": ["o"]}, {"axis": 1}, "o", ["a", "b"], (2, 2, 3)),
    ("dropout_p0", "dropout", {"X": {"x": _f(3, 4)}}, {"Out": ["o"]},
     {"dropout_prob": 0.0, "is_test": False,
      "dropout_implementation": "upscale_in_train"}, "o", ["x"], (3, 4)),
    ("rms_norm", "rms_norm",
     {"X": {"x": _f(2, 3, 8) * 2 + 0.5}, "Scale": {"s": _f(8)}},
     {"Y": ["o"]}, {"epsilon": 1e-6}, "o", ["x", "s"], (2, 3, 8)),
    ("rope", "rope", {"X": {"x": _f(2, 3, 5, 8)}}, {"Out": ["o"]},
     {"base": 10000.0, "position_offset": 3}, "o", ["x"], (2, 3, 5, 8)),
    ("silu", "silu", {"X": {"x": _f(4, 5) * 2}}, {"Out": ["o"]}, {}, "o",
     ["x"], (4, 5)),
    ("mean", "mean", {"X": {"x": _f(3, 4)}}, {"Out": ["o"]}, {}, "o",
     ["x"], ()),
    ("reshape2", "reshape2", {"X": {"x": _f(2, 3, 4)}},
     {"Out": ["o"], "XShape": ["xs"]}, {"shape": [0, 12]}, "o", ["x"],
     (2, 12)),
    ("transpose2", "transpose2", {"X": {"x": _f(2, 3, 4)}},
     {"Out": ["o"], "XShape": ["xs"]}, {"axis": [1, 0, 2]}, "o", ["x"],
     (3, 2, 4)),
    ("slice", "slice", {"Input": {"x": _f(2, 3, 10)}}, {"Out": ["o"]},
     {"axes": [2], "starts": [3], "ends": [8]}, "o", ["x"], (2, 3, 5)),
    ("tile", "tile", {"X": {"x": _f(2, 1, 3)}}, {"Out": ["o"]},
     {"repeat_times": [1, 2, 1]}, "o", ["x"], (2, 2, 3)),
    ("flash_attention_causal", "flash_attention",
     {"Q": {"q": _f(2, 2, 24, 16)}, "K": {"k": _f(2, 2, 24, 16)},
      "V": {"v": _f(2, 2, 24, 16)}},
     {"Out": ["o"]}, {"causal": True}, "o", ["q", "k", "v"], (2, 2, 24, 16)),
    ("flash_attention_bias", "flash_attention",
     {"Q": {"q": _f(2, 2, 8, 16)}, "K": {"k": _f(2, 2, 24, 16)},
      "V": {"v": _f(2, 2, 24, 16)},
      "Bias": {"bias": np.where(R.rand(2, 24) > 0.3, 0.0, -1e4)
               .astype("float32")}},
     {"Out": ["o"]}, {"causal": False}, "o", ["q", "k", "v", "bias"],
     (2, 2, 8, 16)),
    ("flash_attention_qkv", "flash_attention_qkv",
     {"QKV": {"qkv": _f(2, 16, 3 * 128)},
      "Bias": {"bias": np.where(R.rand(2, 16) > 0.3, 0.0, -1e4)
               .astype("float32")}},
     {"Out": ["o"]}, {"num_heads": 2, "causal": False}, "o",
     ["qkv", "bias"], (2, 16, 128)),
    ("flash_attention_qkv_causal_d128", "flash_attention_qkv",
     {"QKV": {"qkv": _f(2, 16, 3 * 256)}},
     {"Out": ["o"]}, {"num_heads": 2, "causal": True}, "o", ["qkv"],
     (2, 16, 256)),
]


@pytest.mark.parametrize("case", GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_auto_grad_matches_jax_vjp(case):
    _id, op_type, inputs, outputs, attrs, out_name, wrt, shape = case
    cot = np.asarray(R.randn(*shape), "float32")  # shape () too
    want = _run_grad(jpt, op_type, inputs, outputs, attrs, out_name, wrt,
                     cot)
    got = _run_grad(tpt, op_type, inputs, outputs, attrs, out_name, wrt, cot)
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape)
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)


def test_grad_accumulates_across_consumers():
    """x feeds two ops (x * y, then + x): the two grad ops sum into one
    x@GRAD, as in the JAX package."""
    x, y = _f(3, 4), _f(3, 4)
    got = []
    for pkg in (jpt, tpt):
        if pkg is jpt:
            from paddle_tpu.framework.backward import append_backward
        else:
            from paddle_tpu_torch.framework.backward import append_backward
        main = pkg.Program()
        block = main.global_block()
        for n in ("x", "y"):
            block.create_var(name=n, shape=[3, 4], dtype="float32",
                             is_data=True, stop_gradient=False)
        with pkg.program_guard(main, pkg.Program()):
            block.append_op("elementwise_mul", inputs={"X": ["x"],
                                                       "Y": ["y"]},
                            outputs={"Out": ["a"]}, attrs={"axis": -1})
            block.append_op("elementwise_add", inputs={"X": ["a"],
                                                       "Y": ["x"]},
                            outputs={"Out": ["b"]}, attrs={"axis": -1})
            block.append_op("reduce_sum", inputs={"X": ["b"]},
                            outputs={"Out": ["loss"]},
                            attrs={"dim": [0], "reduce_all": True,
                                   "keep_dim": False})
            pg = append_backward(block.var("loss"))
        assert pg == []  # no parameters in this program
        got.append(pkg.Executor(pkg.CPUPlace()).run(
            main, feed={"x": x, "y": y}, fetch_list=["x@GRAD", "y@GRAD"],
            scope=pkg.Scope()))
    np.testing.assert_allclose(got[1][0], y + 1.0, rtol=1e-6)
    for w, g in zip(*got):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-6, rtol=1e-6)


def test_ported_op_set_covers_the_llama_training_step():
    """Every op of the Llama training program (and its startup) is
    lowered and has a forward case here; the differentiable ones a grad
    case too."""
    from paddle_tpu_torch.ops.registry import all_registered_ops

    llama = {"rms_norm", "mul", "slice", "reshape2", "transpose2", "rope",
             "tile", "flash_attention", "elementwise_add", "silu",
             "elementwise_mul", "lookup_table_v2", "unsqueeze2",
             "softmax_with_cross_entropy", "squeeze2", "mean", "adamw",
             "fill_constant", "uniform_random"}
    assert llama <= set(all_registered_ops())
    assert llama <= {c[1] for c in CASES} | {"uniform_random"}
    assert llama - {"adamw", "fill_constant", "uniform_random"} <= {
        c[1] for c in GRAD_CASES}


def test_flash_attention_xla_impl_raises():
    """impl='xla' (the einsum formulation) is ported; under the 'sp' mesh
    axis it would attend over the local shard only, so there it raises
    instead of running another formulation."""
    from paddle_tpu_torch.ops.registry import LowerContext, lower_op

    q = torch.from_numpy(_f(1, 2, 8, 16))
    main = tpt.Program()
    block = main.global_block()
    for n in "qkv":
        block.create_var(name=n, shape=[1, 2, 8, 16], dtype="float32")
    op = block.append_op("flash_attention",
                         inputs={"Q": ["q"], "K": ["k"], "V": ["v"]},
                         outputs={"Out": ["o"]}, attrs={"impl": "xla"})
    ctx = LowerContext(block, {"q": q, "k": q, "v": q}, torch.device("cpu"))
    lower_op(ctx, op, 0)
    assert ctx.env["o"].shape == (1, 2, 8, 16)
    ctx.axis_names = ("sp",)
    with pytest.raises(NotImplementedError, match="sequence parallel"):
        lower_op(ctx, op, 0)
