"""The vision ops of the port (``conv2d``, ``depthwise_conv2d``,
``pool2d``, ``batch_norm``, ``cross_entropy``, ``top_k`` / ``top_k_v2``,
``accuracy``) against the JAX package, through tests/torch_op_util.py.

Each case is built by the JAX package's ``op_test._build`` (its weighted
scalar loss and ``append_backward`` where the case checks grads),
serialised to JSON, run by both packages on the CPU on the same seeded
numpy feeds, and every output and grad compared:

* convolutions within rtol / atol 1e-5 (the products' K is at most 36:
  a few ulps of reordering), forward and the grads of Input and Filter;
  a case with grads runs the training route (``F.conv2d``), a case
  without the forward-only route (im2col and the product,
  ``nn_ops.conv2d_rows``), so both routes are held to the reference at
  every padding kind (EXPLICIT pairs, SAME with an uneven pair, VALID),
  stride 2, dilation 2, groups 2, depthwise and NHWC;
* pooling within 1e-6 (max is exact, an average divides one sum): max and
  average, ``exclusive`` both ways over padded windows, uneven SAME pads,
  ``ceil_mode`` (whose lowering keeps the floor's windows, as the
  reference's does), global, adaptive 1 x 1 and 2 x 2, NHWC; an adaptive
  pool over sizes that do not divide raises in both packages;
* batch norm within 1e-5: training and test, NCHW and NHWC,
  ``use_global_stats``, all five outputs and the grads of X, Scale and
  Bias;
* cross_entropy within 1e-6 (hard, soft, ``ignore_index``); top_k with
  ties (the lower index first) and accuracy exactly.

The forward-only route's rows are also held bit for bit on the CPU: a
batch of 8 images gives each image the bits it has alone, at a K below
one product chunk (144) and above it (576), at 9 x 9 and 2 x 2 maps.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from op_test import OpCase
from paddle_tpu_torch.ops import nn_ops
from torch_op_util import check_case

R = np.random.RandomState
CONV_TOL = dict(rtol=1e-5, atol=1e-5)
POOL_TOL = dict(rtol=1e-6, atol=1e-6)
BN_TOL = dict(rtol=1e-5, atol=1e-5)


def _f32(seed, shape, lo=-1.0, hi=1.0):
    return R(seed).uniform(lo, hi, shape).astype("float32")


_X = _f32(1, (2, 3, 7, 7))
_W = _f32(2, (4, 3, 3, 3))
_X6 = _f32(3, (2, 3, 6, 6))
_XG = _f32(4, (2, 4, 6, 6))
_WG = _f32(5, (4, 2, 3, 3))
_WD = _f32(6, (3, 1, 3, 3))
_NHWC = np.ascontiguousarray(_X.transpose(0, 2, 3, 1))


def _conv(name, x, w, attrs, grad, op="conv2d"):
    return OpCase(op, {"Input": x, "Filter": w}, outputs={"Output": 1},
                  attrs=attrs, grad=["Input", "Filter"] if grad else [],
                  name=name, **CONV_TOL)


CONV_CASES = []
for _grad in (True, False):
    _sfx = "grad" if _grad else "forward_only"
    CONV_CASES += [
        _conv(f"explicit_{_sfx}", _X, _W, {"paddings": [1, 1]}, _grad),
        _conv(f"explicit_pairs_{_sfx}", _X, _W,
              {"paddings": [1, 0, 2, 1]}, _grad),
        _conv(f"same_uneven_stride2_{_sfx}", _X6, _W,
              {"padding_algorithm": "SAME", "strides": [2, 2]}, _grad),
        _conv(f"valid_{_sfx}", _X, _W, {"padding_algorithm": "VALID",
                                        "paddings": [1, 1]}, _grad),
        _conv(f"stride2_{_sfx}", _X, _W, {"paddings": [1, 1],
                                          "strides": [2, 2]}, _grad),
        _conv(f"dilation2_{_sfx}", _X, _W, {"paddings": [2, 2],
                                            "dilations": [2, 2]}, _grad),
        _conv(f"groups2_{_sfx}", _XG, _WG, {"paddings": [1, 1],
                                            "groups": 2}, _grad),
        _conv(f"nhwc_{_sfx}", _NHWC, _W, {"paddings": [1, 1],
                                          "data_format": "NHWC"}, _grad),
        _conv(f"depthwise_{_sfx}", _X, _WD, {"paddings": [1, 1],
                                             "groups": 3}, _grad,
              op="depthwise_conv2d"),
    ]


@pytest.mark.parametrize("case", CONV_CASES, ids=[c.name for c in CONV_CASES])
def test_conv2d_case_follows_jax(case):
    check_case(case)


def _pool(name, x, attrs, grad=True):
    return OpCase("pool2d", {"X": x}, attrs=attrs,
                  grad=["X"] if grad else [], name=name, **POOL_TOL)


POOL_CASES = [
    _pool("max_2x2", _X, {"pooling_type": "max", "ksize": [2, 2],
                          "strides": [2, 2]}),
    _pool("max_3x3_s2_p1", _X, {"pooling_type": "max", "ksize": [3, 3],
                                "strides": [2, 2], "paddings": [1, 1]}),
    _pool("max_same_uneven", _X, {"pooling_type": "max", "ksize": [2, 2],
                                  "strides": [2, 2],
                                  "padding_algorithm": "SAME"}),
    _pool("avg_exclusive_padded", _X, {"pooling_type": "avg",
                                       "ksize": [3, 3], "strides": [2, 2],
                                       "paddings": [1, 1],
                                       "exclusive": True}),
    _pool("avg_inclusive_padded", _X, {"pooling_type": "avg",
                                       "ksize": [3, 3], "strides": [2, 2],
                                       "paddings": [1, 1],
                                       "exclusive": False}),
    _pool("avg_exclusive_uneven_pairs", _X, {"pooling_type": "avg",
                                             "ksize": [2, 3],
                                             "strides": [2, 1],
                                             "paddings": [0, 1, 2, 1],
                                             "exclusive": True}),
    _pool("avg_2x2", _X6, {"pooling_type": "avg", "ksize": [2, 2],
                           "strides": [2, 2]}),
    _pool("max_ceil_mode", _X, {"pooling_type": "max", "ksize": [2, 2],
                                "strides": [2, 2], "ceil_mode": True},
          grad=False),
    _pool("global_max", _X, {"pooling_type": "max", "global_pooling": True}),
    _pool("global_avg", _X, {"pooling_type": "avg", "global_pooling": True}),
    _pool("adaptive_avg_1x1", _X, {"pooling_type": "avg", "ksize": [1, 1],
                                   "adaptive": True}),
    _pool("adaptive_max_2x2", _X6, {"pooling_type": "max", "ksize": [2, 2],
                                    "adaptive": True}),
    _pool("adaptive_avg_2x2", _X6, {"pooling_type": "avg", "ksize": [2, 2],
                                    "adaptive": True}),
    _pool("nhwc_max", _NHWC, {"pooling_type": "max", "ksize": [3, 3],
                              "strides": [2, 2], "paddings": [1, 1],
                              "data_format": "NHWC"}),
    _pool("nhwc_avg", _NHWC, {"pooling_type": "avg", "ksize": [3, 3],
                              "strides": [2, 2], "paddings": [1, 1],
                              "data_format": "NHWC"}),
]


@pytest.mark.parametrize("case", POOL_CASES, ids=[c.name for c in POOL_CASES])
def test_pool2d_case_follows_jax(case):
    check_case(case)


@pytest.mark.parametrize("pkg", [jpt, tpt], ids=["jax", "port"])
def test_adaptive_pool_over_sizes_that_do_not_divide_raises(pkg):
    """The reference asserts divisible sizes; the port raises the same
    AssertionError."""
    case = _pool("adaptive_indivisible", _X, {"pooling_type": "avg",
                                              "ksize": [2, 2],
                                              "adaptive": True}, grad=False)
    from op_test import _build
    from paddle_tpu.framework.serde import program_to_json
    from paddle_tpu_torch.framework.serde import program_from_json

    main, startup, feed, outs, _ = _build(case, with_loss=False)
    if pkg is tpt:
        main = program_from_json(program_to_json(main))
        exe = tpt.Executor(tpt.CPUPlace())
    else:
        exe = jpt.Executor()
    with pytest.raises(Exception, match="divisible"):
        exe.run(main, feed=feed, fetch_list=outs, scope=pkg.Scope())


_BX = _f32(7, (4, 3, 5, 5), -2.0, 2.0)
_BX_NHWC = np.ascontiguousarray(_BX.transpose(0, 2, 3, 1))
_SCALE = _f32(8, (3,), 0.5, 1.5)
_BIAS = _f32(9, (3,))
_MEAN = _f32(10, (3,), -0.2, 0.2)
_VAR = _f32(11, (3,), 0.5, 1.5)
_BN_OUTS = {"Y": 1, "MeanOut": 1, "VarianceOut": 1, "SavedMean": 1,
            "SavedVariance": 1}


def _bn(name, x, attrs):
    return OpCase("batch_norm", {"X": x, "Scale": _SCALE, "Bias": _BIAS,
                                 "Mean": _MEAN, "Variance": _VAR},
                  outputs=_BN_OUTS, attrs=dict(momentum=0.9, epsilon=1e-5,
                                               **attrs),
                  grad=["X", "Scale", "Bias"], name=name, **BN_TOL)


BN_CASES = [
    _bn("train_nchw", _BX, {}),
    _bn("test_nchw", _BX, {"is_test": True}),
    _bn("train_nhwc", _BX_NHWC, {"data_layout": "NHWC"}),
    _bn("test_nhwc", _BX_NHWC, {"data_layout": "NHWC", "is_test": True}),
    _bn("use_global_stats", _BX, {"use_global_stats": True}),
]


@pytest.mark.parametrize("case", BN_CASES, ids=[c.name for c in BN_CASES])
def test_batch_norm_case_follows_jax(case):
    check_case(case)


def _probs(seed, shape):
    e = np.exp(R(seed).uniform(-2, 2, shape))
    return (e / e.sum(-1, keepdims=True)).astype("float32")


_P = _probs(12, (6, 5))
_HARD = np.array([[0], [3], [2], [4], [2], [1]], "int64")
_SOFT = _probs(13, (6, 5))
_TIES = np.array([[1.0, 3.0, 3.0, 0.5, 3.0, 2.0],
                  [2.0, 2.0, 2.0, 2.0, 1.0, 0.0],
                  [0.0, 1.0, 0.0, 1.0, 0.0, 1.0],
                  [5.0, 4.0, 3.0, 2.0, 1.0, 0.0]], "float32")

LOSS_CASES = [
    OpCase("cross_entropy", {"X": _P, "Label": _HARD}, outputs={"Y": 1},
           grad=["X"], name="cross_entropy_hard", rtol=1e-6, atol=1e-6),
    OpCase("cross_entropy", {"X": _P, "Label": _SOFT}, outputs={"Y": 1},
           attrs={"soft_label": True}, grad=["X"],
           name="cross_entropy_soft", rtol=1e-6, atol=1e-6),
    OpCase("cross_entropy", {"X": _P, "Label": _HARD}, outputs={"Y": 1},
           attrs={"ignore_index": 2}, grad=["X"],
           name="cross_entropy_ignore_index", rtol=1e-6, atol=1e-6),
    OpCase("top_k", {"X": _TIES}, outputs={"Out": 1, "Indices": 1},
           attrs={"k": 3}, name="top_k_ties"),
    OpCase("top_k_v2", {"X": _TIES}, outputs={"Out": 1, "Indices": 1},
           attrs={"k": 2, "largest": False}, name="top_k_v2_smallest_ties"),
    OpCase("top_k_v2", {"X": _TIES}, outputs={"Out": 1, "Indices": 1},
           attrs={"k": 2, "axis": 0}, name="top_k_v2_axis0_ties"),
    OpCase("accuracy", {"Out": _TIES[:, :3],
                        "Indices": np.array([[1, 2, 4], [0, 1, 2],
                                             [1, 3, 5], [0, 1, 2]], "int64"),
                        "Label": np.array([[2], [3], [5], [4]], "int64")},
           outputs={"Accuracy": 1, "Correct": 1, "Total": 1},
           name="accuracy_top3"),
]


@pytest.mark.parametrize("case", LOSS_CASES, ids=[c.name for c in LOSS_CASES])
def test_loss_and_metric_case_follows_jax(case):
    got = check_case(case)
    if case.name == "top_k_ties":
        # ties: the lower index first, as lax.top_k orders them
        np.testing.assert_array_equal(np.asarray(got[1])[:2],
                                      [[1, 2, 4], [0, 1, 2]])
    if case.name == "accuracy_top3":
        assert np.asarray(got[1]).dtype == np.int32
        assert (int(np.asarray(got[1])), int(np.asarray(got[2]))) == (2, 4)


@pytest.mark.parametrize("c,k,hw", [(16, 3, 9), (64, 3, 9), (64, 3, 2)],
                         ids=["K144", "K576", "K576_2x2"])
def test_forward_only_conv_rows_do_not_depend_on_the_batch(c, k, hw):
    """conv2d_rows on the CPU: each of 8 images alone gives the bits it
    has in the batch, and a permuted batch its rows permuted (tolerance
    0; K = c x k x k below and above one product chunk; at 2 x 2 an image
    alone is a product of 4 rows, where MKL picks another kernel for a
    transposed filter)."""
    x = torch.from_numpy(_f32(14, (8, c, hw, hw)))
    w = torch.from_numpy(_f32(15, (32, c, k, k)))
    args = ([1, 1], [(1, 1), (1, 1)], [1, 1])
    batch = nn_ops.conv2d_rows(x, w, *args)
    perm = torch.from_numpy(R(16).permutation(8))
    permuted = nn_ops.conv2d_rows(x[perm], w, *args)
    assert torch.equal(permuted, batch[perm])
    for i in range(8):
        assert torch.equal(nn_ops.conv2d_rows(x[i:i + 1], w, *args),
                           batch[i:i + 1]), i
