"""``matmul`` / ``matmul_v2`` and ``softmax`` in the port against the JAX
lowerings: each ``OpCase`` (tests/op_test.py) is built in the JAX
package, serialised and run in the port (tests/torch_op_util.py), outputs
and the grads of the checked inputs held to the case's tolerance (rtol
1e-5, atol 1e-6: float32 sums of at most 40 terms in other orders).

* matmul: both transposes (under either attribute name), alpha, batch
  dims broadcast from a rank-2 or a size-1 operand, 1-D operands, and the
  4-D shapes of BERT's unfused attention (scores Q K^T with alpha, then
  P V);
* a K longer than the product kernel's chunk (``gemm.K_CHUNK``) summed
  as the kernel sums it when no grad op differentiates the product, so a
  batch's rows equal its rows alone bit for bit;
* softmax over the last axis, a middle axis and the first, with grads.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as tpt
from op_test import OpCase
from paddle_tpu_torch.ops.cuda import gemm
from torch_op_util import check_case

R = np.random.RandomState


def _u(seed, shape, scale=1.0):
    return (R(seed).uniform(-1.0, 1.0, shape) * scale).astype("float32")


MATMUL_CASES = [
    OpCase("matmul", {"X": _u(0, (3, 4)), "Y": _u(1, (4, 5))},
           grad=["X", "Y"], name="matmul_2d"),
    OpCase("matmul", {"X": _u(2, (4, 3)), "Y": _u(3, (5, 4))},
           attrs={"transpose_X": True, "transpose_Y": True, "alpha": 0.5},
           grad=["X", "Y"], name="matmul_both_transposed_alpha"),
    OpCase("matmul_v2", {"X": _u(4, (2, 3, 4)), "Y": _u(5, (2, 5, 4))},
           attrs={"trans_y": True}, grad=["X", "Y"],
           name="matmul_v2_trans_y"),
    OpCase("matmul_v2", {"X": _u(6, (2, 4, 3)), "Y": _u(7, (4, 5))},
           attrs={"trans_x": True}, grad=["X", "Y"],
           name="matmul_v2_trans_x_broadcast_rank2"),
    OpCase("matmul", {"X": _u(8, (2, 1, 3, 4)), "Y": _u(9, (1, 3, 4, 2))},
           grad=["X", "Y"], name="matmul_broadcast_size1_batch"),
    OpCase("matmul", {"X": _u(10, (4,)), "Y": _u(11, (2, 4, 3))},
           grad=["X", "Y"], name="matmul_vector_x"),
    OpCase("matmul", {"X": _u(12, (2, 3, 4)), "Y": _u(13, (4,))},
           grad=["X", "Y"], name="matmul_vector_y"),
    # BERT's unfused attention at 2 heads of 8: Q K^T / sqrt(8), then P V
    OpCase("matmul", {"X": _u(14, (2, 2, 5, 8)), "Y": _u(15, (2, 2, 5, 8))},
           attrs={"transpose_Y": True, "alpha": 1.0 / np.sqrt(8.0)},
           grad=["X", "Y"], name="matmul_bert_scores"),
    OpCase("matmul", {"X": _u(16, (2, 2, 5, 5)), "Y": _u(17, (2, 2, 5, 8))},
           grad=["X", "Y"], name="matmul_bert_context"),
    OpCase("matmul", {"X": _u(18, (3, 300)), "Y": _u(19, (300, 4))},
           rtol=1e-5, atol=1e-5, name="matmul_long_k"),
]

SOFTMAX_CASES = [
    OpCase("softmax", {"X": _u(20, (3, 7), 3.0)}, grad=["X"],
           name="softmax_last"),
    OpCase("softmax", {"X": _u(21, (2, 5, 3), 3.0)}, attrs={"axis": 1},
           grad=["X"], name="softmax_axis1"),
    OpCase("softmax", {"X": _u(22, (4, 3), 3.0)}, attrs={"axis": 0},
           grad=["X"], name="softmax_axis0"),
    OpCase("softmax", {"X": _u(23, (2, 2, 4, 6), 5.0)}, grad=["X"],
           name="softmax_bert_probs"),
]


@pytest.mark.parametrize("case", MATMUL_CASES,
                         ids=[c.name for c in MATMUL_CASES])
def test_matmul_case_follows_jax(case):
    check_case(case)


@pytest.mark.parametrize("case", SOFTMAX_CASES,
                         ids=[c.name for c in SOFTMAX_CASES])
def test_softmax_case_follows_jax(case):
    check_case(case)


def _matmul_program(x_shape, y_shape, **attrs):
    main = tpt.Program()
    block = main.global_block()
    block.create_var(name="x", shape=list(x_shape), dtype="float32",
                     is_data=True)
    block.create_var(name="y", shape=list(y_shape), dtype="float32",
                     is_data=True)
    block.append_op("matmul", inputs={"X": ["x"], "Y": ["y"]},
                    outputs={"Out": ["o"]}, attrs=attrs)
    return main


def test_long_k_rows_equal_their_rows_alone():
    """A forward-only float32 matmul with K past one chunk sums the
    chunks in order on the CPU (as the card's kernel does), so each row of
    a 6-row batch equals the same row computed alone, bit for bit, and the
    product equals ``gemm.matmul_reference``."""
    K = 3 * gemm.K_CHUNK + 40
    x = _u(30, (2, 6, K))
    y = _u(31, (2, 5, K))
    main = _matmul_program(x.shape, y.shape, transpose_Y=True, alpha=0.25)
    exe = tpt.Executor(tpt.CPUPlace())
    whole = exe.run(main, feed={"x": x, "y": y}, fetch_list=["o"],
                    scope=tpt.Scope())[0]
    want = gemm.matmul_reference(torch.from_numpy(x),
                                 torch.from_numpy(y).transpose(-1, -2))
    np.testing.assert_array_equal(whole, want.numpy() * np.float32(0.25))
    for r in range(6):
        alone = exe.run(_matmul_program((2, 1, K), y.shape,
                                        transpose_Y=True, alpha=0.25),
                        feed={"x": x[:, r:r + 1], "y": y},
                        fetch_list=["o"], scope=tpt.Scope())[0]
        np.testing.assert_array_equal(alone, whole[:, r:r + 1])


def test_matmul_infers_the_jax_shapes():
    """Out's inferred shape for transposes, broadcast and 1-D operands,
    as the JAX package infers it."""
    from paddle_tpu.ops.math_ops import _matmul_shape as j_shape
    from paddle_tpu_torch.ops.math_ops import _matmul_shape as t_shape

    for xs, ys, tx, ty in [((3, 4), (4, 5), False, False),
                           ((4, 3), (5, 4), True, True),
                           ((2, 1, 3, 4), (3, 4, 2), False, False),
                           ((4,), (2, 4, 3), False, False),
                           ((2, 3, 4), (4,), False, True),
                           ((4,), (4,), False, False),
                           ((-1, 2, 8, 16), (-1, 2, 8, 16), False, True)]:
        assert t_shape(xs, ys, tx, ty) == j_shape(xs, ys, tx, ty)
    with pytest.raises(ValueError, match="contraction mismatch"):
        t_shape((3, 4), (5, 6), False, False)
