"""The eleven optimizer ops the port gained with the optimizer tier, each
against the JAX package on the same feeds: an ``OpCase``
(tests/op_test.py) built in the JAX package, serialised and run in the
port (tests/torch_op_util.py), every output within rtol 1e-5, atol 1e-6
(float32 square roots, powers and norms of two libraries), the integer
counters of ``average_accumulates`` exactly.

The edge cases the ops name: LAMB's and LARS's trust ratio where the
parameter (or the gradient) is all zeros; RMSProp centered and not, with
and without momentum; FTRL at three ``lr_power`` values and an L1 that
zeroes some weights; DP-SGD at sigma 0 (exact: the noise is the op's own
generator's, and sigma 0 removes it) and at sigma 1 (the noise's moments,
5 sigma over 20000 draws); ``average_accumulates`` accumulating, rotating
its window and spilling sum_1 into sum_2 at 16384 updates.  The ops are
not differentiated (grad None), so no case checks grads.
"""
import numpy as np
import pytest

from op_test import OpCase
from torch_op_util import check_case, run_both

R = np.random.RandomState
SHAPE = (3, 4)


def _f(seed, lo=-1.0, hi=1.0, shape=SHAPE):
    return R(seed).uniform(lo, hi, shape).astype("float32")


P, G = _f(1), _f(2)
POS = _f(3, 0.1, 1.0)  # squared-gradient accumulators
LR = np.array([0.05], "float32")


def _pow(value):
    return np.array([value], "float32")


def _outs(*slots):
    return {s: 1 for s in slots}


CASES = [
    OpCase("adamax", {"Param": P, "Grad": G, "Moment": _f(4),
                      "InfNorm": POS, "Beta1Pow": _pow(0.9 ** 3),
                      "LearningRate": LR},
           _outs("ParamOut", "MomentOut", "InfNormOut"),
           attrs={"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    OpCase("adadelta", {"Param": P, "Grad": G, "AvgSquaredGrad": POS,
                        "AvgSquaredUpdate": _f(5, 0.1, 1.0)},
           _outs("ParamOut", "AvgSquaredGradOut", "AvgSquaredUpdateOut"),
           attrs={"rho": 0.95, "epsilon": 1e-6}),
    OpCase("rmsprop", {"Param": P, "Grad": G, "MeanSquare": POS,
                       "Moment": _f(6), "MeanGrad": _f(7, -0.1, 0.1),
                       "LearningRate": LR},
           _outs("ParamOut", "MeanSquareOut", "MomentOut", "MeanGradOut"),
           attrs={"decay": 0.9, "epsilon": 1e-6, "momentum": 0.9,
                  "centered": True}, name="rmsprop_centered_momentum"),
    OpCase("rmsprop", {"Param": P, "Grad": G, "MeanSquare": POS,
                       "Moment": _f(6), "MeanGrad": _f(7, -0.1, 0.1),
                       "LearningRate": LR},
           _outs("ParamOut", "MeanSquareOut", "MomentOut"),
           attrs={"decay": 0.95, "epsilon": 1e-6, "momentum": 0.0,
                  "centered": False}, name="rmsprop_plain"),
    OpCase("lamb", {"Param": P, "Grad": G, "Moment1": _f(8),
                    "Moment2": POS, "Beta1Pow": _pow(0.9 ** 2),
                    "Beta2Pow": _pow(0.999 ** 2), "LearningRate": LR},
           _outs("ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
                 "Beta2PowOut"),
           attrs={"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6,
                  "weight_decay": 0.01}),
    OpCase("lamb", {"Param": np.zeros(SHAPE, "float32"), "Grad": G,
                    "Moment1": np.zeros(SHAPE, "float32"),
                    "Moment2": np.zeros(SHAPE, "float32"),
                    "Beta1Pow": _pow(0.9), "Beta2Pow": _pow(0.999),
                    "LearningRate": LR},
           _outs("ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
                 "Beta2PowOut"),
           attrs={"weight_decay": 0.0}, name="lamb_zero_param_trust_1"),
    OpCase("lamb", {"Param": P, "Grad": np.zeros(SHAPE, "float32"),
                    "Moment1": np.zeros(SHAPE, "float32"),
                    "Moment2": np.zeros(SHAPE, "float32"),
                    "Beta1Pow": _pow(0.9), "Beta2Pow": _pow(0.999),
                    "LearningRate": LR},
           _outs("ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
                 "Beta2PowOut"),
           attrs={"weight_decay": 0.0}, name="lamb_zero_update_trust_1"),
    OpCase("lars_momentum", {"Param": P, "Grad": G, "Velocity": _f(9),
                             "LearningRate": LR},
           _outs("ParamOut", "VelocityOut"),
           attrs={"mu": 0.9, "lars_coeff": 0.001,
                  "lars_weight_decay": 0.0005, "epsilon": 0.0}),
    OpCase("lars_momentum", {"Param": np.zeros(SHAPE, "float32"),
                             "Grad": G, "Velocity": _f(9),
                             "LearningRate": LR},
           _outs("ParamOut", "VelocityOut"),
           attrs={"mu": 0.9, "lars_coeff": 0.001,
                  "lars_weight_decay": 0.0005},
           name="lars_momentum_zero_param_plain_lr"),
    OpCase("dpsgd", {"Param": P, "Grad": G * 30.0, "LearningRate": LR},
           _outs("ParamOut"),
           attrs={"clip": 10.0, "batch_size": 16.0, "sigma": 0.0},
           name="dpsgd_sigma0_clipped"),
    OpCase("dpsgd", {"Param": P, "Grad": G, "LearningRate": LR},
           _outs("ParamOut"),
           attrs={"clip": 10.0, "batch_size": 4.0, "sigma": 0.0},
           name="dpsgd_sigma0_under_clip"),
    OpCase("proximal_gd", {"Param": P, "Grad": G, "LearningRate": LR},
           _outs("ParamOut"), attrs={"l1": 2.0, "l2": 0.5}),
    OpCase("decayed_adagrad", {"Param": P, "Grad": G, "Moment": POS,
                               "LearningRate": LR},
           _outs("ParamOut", "MomentOut"),
           attrs={"decay": 0.95, "epsilon": 1e-6}),
    OpCase("proximal_adagrad", {"Param": P, "Grad": G, "Moment": POS,
                                "LearningRate": LR},
           _outs("ParamOut", "MomentOut"), attrs={"l1": 0.1, "l2": 0.2}),
] + [
    OpCase("ftrl", {"Param": P, "Grad": G, "SquaredAccumulator": POS,
                    "LinearAccumulator": _f(10), "LearningRate": LR},
           _outs("ParamOut", "SquaredAccumOut", "LinearAccumOut"),
           attrs={"l1": l1, "l2": 0.1, "lr_power": power},
           name=f"ftrl_power{power}_l1_{l1}")
    for power, l1 in ((-0.5, 0.0), (-0.5, 0.3), (-0.25, 0.3), (-1.0, 0.1))
]

_AVG_OUTS = _outs("OutSum1", "OutSum2", "OutSum3", "OutNumAccumulates",
                  "OutOldNumAccumulates", "OutNumUpdates")


def _avg_case(n_acc, old_n, n_upd, attrs, name):
    i64 = lambda v: np.array([v], "int64")  # noqa: E731
    return OpCase("average_accumulates", {
        "Param": P, "InSum1": _f(11), "InSum2": _f(12), "InSum3": _f(13),
        "InNumAccumulates": i64(n_acc), "InOldNumAccumulates": i64(old_n),
        "InNumUpdates": i64(n_upd)}, _AVG_OUTS, attrs=attrs, name=name)


AVG_CASES = [
    # 3 accumulated of a window of max(min(5 * 0.5, 100), 4) = 4: no
    # rotation
    _avg_case(2, 0, 4, {"average_window": 0.5, "min_average_window": 4,
                        "max_average_window": 100}, "accumulate"),
    # the 4th accumulation reaches the window max(8 * 0.5, 4) = 4: sum_3
    # takes sum_1 + sum_2
    _avg_case(3, 7, 7, {"average_window": 0.5, "min_average_window": 4,
                        "max_average_window": 100}, "rotate"),
    # the max_average_window bound rotates at 3 of a rate window of 50
    _avg_case(2, 0, 99, {"average_window": 0.5, "min_average_window": 1,
                         "max_average_window": 3}, "rotate_at_max"),
    # update 16384: sum_1 spills into sum_2, no rotation
    _avg_case(5, 0, 16383, {"average_window": 1.0,
                            "min_average_window": 100000,
                            "max_average_window": 200000}, "spill"),
    # the spill and a rotation (at max(16384e-4, 10) = 10) in one update
    _avg_case(9, 0, 16383, {"average_window": 1e-4,
                            "min_average_window": 10,
                            "max_average_window": 200000},
              "spill_and_rotate"),
]


@pytest.mark.parametrize("case", CASES + AVG_CASES,
                         ids=[c.name for c in CASES + AVG_CASES])
def test_optimizer_op_follows_jax(case):
    got = check_case(case)
    assert all(np.all(np.isfinite(np.asarray(g, "float64"))) for g in got)


def test_average_accumulates_branches_hold():
    """The cases above reach the branches they are named for: the port's
    outputs themselves (sums, counters) show each rotation and spill."""
    by_name = {c.name: c for c in AVG_CASES}
    outs = {n: [np.asarray(x) for x in check_case(c)]
            for n, c in by_name.items()}
    s1_in, s2_in = _f(11), _f(12)
    s1, s2, s3, n_acc, old_n, n_upd = outs["accumulate"]
    np.testing.assert_allclose(s1, s1_in + P, rtol=1e-6)
    assert (int(n_acc[0]), int(old_n[0]), int(n_upd[0])) == (3, 0, 5)
    s1, s2, s3, n_acc, old_n, _ = outs["rotate"]
    assert not s1.any() and not s2.any()
    np.testing.assert_allclose(s3, s1_in + P + s2_in, rtol=1e-6)
    assert (int(n_acc[0]), int(old_n[0])) == (0, 4)
    assert int(outs["rotate_at_max"][4][0]) == 3
    s1, s2, _, n_acc, _, n_upd = outs["spill"]
    assert not s1.any() and int(n_upd[0]) == 16384 and int(n_acc[0]) == 6
    np.testing.assert_allclose(s2, s2_in + s1_in + P, rtol=1e-6)
    s1, s2, s3, n_acc, old_n, _ = outs["spill_and_rotate"]
    assert not s1.any() and not s2.any() and int(old_n[0]) == 10
    np.testing.assert_allclose(s3, s2_in + s1_in + P, rtol=1e-6)


def test_lamb_and_lars_trust_edges():
    """Where the parameter or the update is all zeros the trust ratio is
    1 (LAMB) and LARS takes the plain rate: the step is the update
    itself."""
    got = check_case(CASES[5])  # zero param, weight decay 0
    m1 = 0.1 * G
    m2 = 0.001 * G * G
    r = (m1 / 0.1) / (np.sqrt(m2 / 0.001) + 1e-6)
    np.testing.assert_allclose(np.asarray(got[0]), -0.05 * r, rtol=1e-5)
    got = check_case(CASES[8])  # LARS, zero param
    v = 0.9 * _f(9) + 0.05 * G
    np.testing.assert_allclose(np.asarray(got[1]), v, rtol=1e-6)


def test_dpsgd_noise_moments():
    """sigma 1: (p - p') / lr = (g clip_scale + noise) / batch_size, the
    noise normal with std sigma * clip, from the op's own generator."""
    n = 20000
    p = np.zeros((n,), "float32")
    g = np.zeros((n,), "float32")
    case = OpCase("dpsgd", {"Param": p, "Grad": g,
                            "LearningRate": np.array([1.0], "float32")},
                  _outs("ParamOut"),
                  attrs={"clip": 2.0, "batch_size": 4.0, "sigma": 1.0})
    want, got, _ = run_both(case)
    noise = -np.asarray(got[0], "float64") * 4.0
    assert noise.shape == (n,)
    assert abs(noise.mean()) < 5 * 2.0 / np.sqrt(n)
    assert abs(noise.std() - 2.0) < 5 * 2.0 / np.sqrt(2 * n)
    # another generator than the JAX package's: other numbers, same law
    assert not np.allclose(noise, -np.asarray(want[0], "float64") * 4.0)
