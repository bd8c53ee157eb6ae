"""The ops of the training recipe (LR decays, clips, L1 decay,
initializers) in the port: each op's ``OpCase`` (tests/op_test.py) is
built in the JAX package, serialised and run in the port
(tests/torch_op_util.py), and its outputs and its inputs' grads follow
the JAX package's within the tolerance the case states (rtol 1e-5, atol
1e-6 unless the case says more: pow and elementwise_pow 1e-5 / 1e-5, the
float32 power of two libraries).  ``gaussian_random`` and
``truncated_gaussian_random`` draw from other generators than
jax.random, so their cases are held to shape, dtype and moments (mean and
std within 5 sigma of the asked ones over 20000 draws; no truncated draw
beyond 2 std).
"""
import numpy as np
import pytest

from op_test import OpCase
from torch_op_util import check_case, run_both

R = np.random.RandomState
_SYM = R(1).uniform(-2.0, 2.0, (3, 4)).astype("float32")
_POS = R(0).uniform(0.3, 2.0, (3, 4)).astype("float32")
# away from integers for floor / ceil, away from 0 for sign
_OFF = (_SYM + np.where(np.abs(_SYM - np.round(_SYM)) < 0.15, 0.3,
                        0.0)).astype("float32")
_Y = R(2).uniform(-2.0, 2.0, (4,)).astype("float32")

CASES = [
    OpCase("elementwise_sub", {"X": _SYM, "Y": _Y}, grad=["X", "Y"]),
    OpCase("elementwise_min", {"X": _SYM, "Y": _Y}, grad=["X", "Y"]),
    OpCase("elementwise_pow", {"X": _POS, "Y": R(3).uniform(
        -1.5, 2.5, (4,)).astype("float32")}, grad=["X", "Y"], rtol=1e-5,
        atol=1e-5),
    OpCase("pow", {"X": _POS}, attrs={"factor": 2.5}, grad=["X"],
           rtol=1e-5, atol=1e-5),
    OpCase("exp", {"X": _SYM}, grad=["X"]),
    OpCase("cos", {"X": _SYM}, grad=["X"]),
    OpCase("floor", {"X": _OFF}, grad=["X"]),
    OpCase("ceil", {"X": _OFF}, grad=["X"]),
    OpCase("sign", {"X": _OFF}),
    OpCase("equal", {"X": np.array([1.0, 2.0, 3.0, 4.0], "float32"),
                     "Y": np.array([1.0, 0.0, 3.0, 5.0], "float32")}),
    OpCase("clip", {"X": _SYM}, attrs={"min": -1.0, "max": 1.0},
           grad=["X"]),
    OpCase("clip_by_norm", {"X": _SYM}, attrs={"max_norm": 1.0},
           grad=["X"], name="clip_by_norm_clipped"),
    OpCase("clip_by_norm", {"X": _SYM * 0.01}, attrs={"max_norm": 1.0},
           grad=["X"], name="clip_by_norm_under"),
    OpCase("global_norm_sq", {"X": [_SYM, _Y]}, grad=["X"]),
    OpCase("assign_value", {}, attrs={
        "shape": [2, 3], "dtype": "float32",
        "fp32_values": [0.5, -1.0, 2.0, 3.25, 0.0, 7.0]},
        name="assign_value_fp32"),
    OpCase("assign_value", {}, attrs={
        "shape": [4], "dtype": "int64", "int64_values": [3, -1, 7, 0]},
        name="assign_value_int64"),
    OpCase("assign_value", {}, attrs={
        "shape": [2, 2], "dtype": "float32",
        "values": np.arange(4, dtype="float32")}, name="assign_value_array"),
]


@pytest.mark.parametrize("case", CASES, ids=[c.name for c in CASES])
def test_op_case_follows_jax(case):
    check_case(case)


@pytest.mark.parametrize("op,truncated", [
    ("gaussian_random", False), ("truncated_gaussian_random", True)])
def test_random_op_case_moments(op, truncated):
    n, mean, std = 20000, 1.0, 2.0
    case = OpCase(op, {}, attrs={"shape": [n], "mean": mean, "std": std,
                                 "dtype": "float32"})
    want, got, _ = run_both(case)
    a, j = np.asarray(got[0]), np.asarray(want[0])
    assert a.shape == j.shape == (n,) and a.dtype == j.dtype
    # a normal truncated at 2 sigma has std 0.8796 sigma
    s = std * (0.8796 if truncated else 1.0)
    assert abs(a.mean() - mean) < 5 * s / np.sqrt(n)
    # the std of a sample std is ~ s / sqrt(2 n) (normal; less truncated)
    assert abs(a.std() - s) < 5 * s / np.sqrt(2 * n)
    if truncated:
        assert np.abs(a - mean).max() <= 2 * std * (1 + 1e-6)
    assert not np.array_equal(a, j)  # other generators, other draws
