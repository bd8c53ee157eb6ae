"""The port's initializers against the JAX package's: Normal,
TruncatedNormal, MSRA (uniform and normal, fan-in from ``_fan_in_out``
or given), Xavier's normal form and NumpyArray, with their aliases.

* Each emits the JAX package's startup op with the same attrs: the
  startup programs serialise JSON-equal.
* NumpyArray is exact (tolerance 0), and equal to the JAX package's.
* The random ones draw from the port's generators (other numbers than
  jax.random's), so their draws are held to statistics over at least
  20000 values: mean and std within 5 sigma of the asked ones (the mean
  of n normal draws spreads std / sqrt(n), their sample std std /
  sqrt(2 n)), no truncated draw beyond 2 std, MSRA's and Xavier's
  uniform draws inside their limits.
"""
import json
import math

import numpy as np
import pytest

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu.framework.core import reset_unique_name as j_reset_names
from paddle_tpu.framework.serde import program_to_json as j_to_json
from paddle_tpu.ops.registry import reset_op_seed as j_reset_seed
from paddle_tpu_torch.framework.serde import program_to_json as t_to_json
from paddle_tpu_torch.ops.registry import reset_op_seed as t_reset_seed

SHAPE = [200, 100]  # fan_in 200, fan_out 100: 20000 draws
CONV = [32, 16, 3, 3]  # OIHW: fan_in 144, fan_out 288


def _inits(I):
    """name -> (initializer, shape): every form under test, built from
    the package's ``initializer`` module `I`."""
    return {
        "normal": (I.Normal(0.5, 2.0), SHAPE),
        "normal_alias": (I.NormalInitializer(loc=-1.0, scale=0.1), SHAPE),
        "truncated_normal": (I.TruncatedNormal(0.5, 2.0), SHAPE),
        "truncated_alias": (I.TruncatedNormalInitializer(0.0, 0.02), SHAPE),
        "msra_uniform": (I.MSRA(), SHAPE),
        "msra_normal": (I.MSRAInitializer(uniform=False), SHAPE),
        "msra_conv_normal": (I.MSRA(uniform=False), CONV),
        "msra_fan_in": (I.MSRA(uniform=False, fan_in=50), SHAPE),
        "xavier_normal": (I.Xavier(uniform=False), SHAPE),
        "numpy": (I.NumpyArrayInitializer(
            np.arange(12, dtype="float32").reshape(3, 4) / 7.0), [3, 4]),
    }


def _startup(pkg, name):
    if pkg is jpt:
        j_reset_names()
        j_reset_seed()
    else:
        tpt.reset_unique_name()
        t_reset_seed()
    init, shape = _inits(pkg.initializer)[name]
    main, startup = pkg.Program(), pkg.Program()
    startup._is_startup = True
    with pkg.program_guard(main, startup):
        p = main.global_block().create_parameter("q", shape, "float32")
        init(p, startup.global_block())
    return startup


def _draw(name):
    startup = _startup(tpt, name)
    scope = tpt.Scope()
    tpt.Executor(tpt.CPUPlace()).run(startup, scope=scope)
    return np.asarray(scope.find_var("q"))


@pytest.mark.parametrize("name", sorted(_inits(tpt.initializer)))
def test_initializer_emits_the_reference_op(name):
    t, j = _startup(tpt, name), _startup(jpt, name)
    assert json.loads(t_to_json(t)) == json.loads(j_to_json(j))
    op, = t.global_block().ops
    assert op.type == {"numpy": "assign_value"}.get(
        name, "uniform_random" if "uniform" in name else
        "truncated_gaussian_random" if "trunc" in name else
        "gaussian_random")


def test_numpy_array_initializer_is_exact():
    got = _draw("numpy")
    want = np.arange(12, dtype="float32").reshape(3, 4) / 7.0
    np.testing.assert_array_equal(got, want)
    scope = jpt.Scope()
    jpt.Executor().run(_startup(jpt, "numpy"), scope=scope)
    np.testing.assert_array_equal(got, np.asarray(scope.find_var("q")))


def _moments(a, mean, std):
    n = a.size
    assert abs(a.mean() - mean) < 5 * std / math.sqrt(n), a.mean()
    assert abs(a.std() - std) < 5 * std / math.sqrt(2 * n), a.std()


@pytest.mark.parametrize("name,mean,std", [
    ("normal", 0.5, 2.0), ("normal_alias", -1.0, 0.1),
    ("msra_normal", 0.0, math.sqrt(2.0 / 200)),
    ("msra_conv_normal", 0.0, math.sqrt(2.0 / 144)),
    ("msra_fan_in", 0.0, math.sqrt(2.0 / 50)),
    ("xavier_normal", 0.0, math.sqrt(2.0 / 300))])
def test_normal_draws(name, mean, std):
    _moments(_draw(name), mean, std)


@pytest.mark.parametrize("name,mean,std", [
    ("truncated_normal", 0.5, 2.0), ("truncated_alias", 0.0, 0.02)])
def test_truncated_normal_draws(name, mean, std):
    a = _draw(name)
    assert np.abs(a - mean).max() <= 2 * std * (1 + 1e-6)
    # a normal truncated at 2 std keeps 0.8796 of its std
    _moments(a, mean, 0.8796 * std)


def test_msra_uniform_draws():
    a = _draw("msra_uniform")
    limit = math.sqrt(6.0 / 200)
    assert -limit <= a.min() and a.max() < limit
    _moments(a, 0.0, limit / math.sqrt(3))


def test_draws_repeat_by_seed_and_differ_by_op():
    assert np.array_equal(_draw("normal"), _draw("normal"))
    assert not np.array_equal(_draw("normal"), _draw("normal_alias"))
