"""Higher-order ``gradients`` in the port, against the JAX package: the
twins of tests/test_higher_order.py's three gradient tests.

Each case builds the same program in both packages (``Variable``'s
operator overloading for ``x * x * x``; ``gradients`` passed over the
result of an earlier pass, each pass under its own grad suffix,
``@GRAD``, ``@GRAD2``, ``@GRAD3``), and holds:

* the programs JSON-equal (the grad-of-grad ops and their
  ``__fwd_desc__`` included);
* the port's fetches against the analytic values at the reference test's
  tolerances (rtol 1e-5; through ``tanh`` rtol 1e-4 / atol 1e-6) and
  against the JAX package's fetches within rtol 1e-6 / atol 1e-7 (the
  same float32 formulas);
* a second run of the cached step (the card's captured replay; on the
  CPU the entry's steady path) bit-equal to the first, eager one.

Also: the suffixes pass through the port's names (``grad_var_name``
under ``grad_suffix_guard``, ``original_name``), the operator overloads
emit the reference's ops, and the dygraph branch of the overloading
raises, naming its queue item.
"""
import json

import numpy as np
import pytest

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu.framework.core import reset_unique_name as j_reset_names
from paddle_tpu.framework.serde import program_to_json as j_to_json
from paddle_tpu.ops.registry import reset_op_seed as j_reset_seed
from paddle_tpu_torch.framework.core import grad_suffix_guard, grad_var_name
from paddle_tpu_torch.framework.serde import program_to_json as t_to_json
from paddle_tpu_torch.ops.registry import original_name
from paddle_tpu_torch.ops.registry import reset_op_seed as t_reset_seed

XV = np.array([1.0, 2.0, 3.0, 4.0], "float32")
XT = np.array([-1.0, 0.3, 0.9], "float32")


def _cube(pkg):
    x = pkg.layers.data("x", [4], append_batch_size=False)
    x.stop_gradient = False
    y = pkg.layers.reduce_sum(x * x * x)
    g1 = pkg.gradients(y, x)[0]
    g2 = pkg.gradients(pkg.layers.reduce_sum(g1), x)[0]
    g3 = pkg.gradients(pkg.layers.reduce_sum(g2), x)[0]
    return {"x": XV}, [g1, g2, g3]


def _tanh(pkg):
    x = pkg.layers.data("x", [3], append_batch_size=False)
    x.stop_gradient = False
    y = pkg.layers.reduce_sum(pkg.layers.tanh(x))
    g1 = pkg.gradients(y, x)[0]
    g2 = pkg.gradients(pkg.layers.reduce_sum(g1), x)[0]
    return {"x": XT}, [g1, g2]


def _target_gradients(pkg):
    x = pkg.layers.data("x", [3], append_batch_size=False)
    x.stop_gradient = False
    y = x * x
    tg = pkg.layers.fill_constant([3], "float32", 2.0)
    g = pkg.gradients(y, x, target_gradients=[tg])[0]
    return {"x": XV[:3]}, [g]


def _want(name):
    t = np.tanh(XT)
    return {"cube": [3 * XV ** 2, 6 * XV, np.full(4, 6.0, "float32")],
            "tanh": [1 - t ** 2, -2 * t * (1 - t ** 2)],
            "target_gradients": [2 * 2 * XV[:3]]}[name]


BUILDS = {"cube": _cube, "tanh": _tanh, "target_gradients": _target_gradients}
ANALYTIC_TOL = {"cube": dict(rtol=1e-5), "tanh": dict(rtol=1e-4, atol=1e-6),
                "target_gradients": dict(rtol=1e-5)}


def _build(pkg, name):
    if pkg is jpt:
        j_reset_names()
        j_reset_seed()
    else:
        tpt.reset_unique_name()
        t_reset_seed()
    main, startup = pkg.Program(), pkg.Program()
    startup._is_startup = True
    with pkg.program_guard(main, startup):
        feed, fetch = BUILDS[name](pkg)
    return main, startup, feed, fetch


@pytest.mark.parametrize("name", list(BUILDS))
def test_higher_order_gradients_follow_the_jax_package(name):
    jm, js, feed, jf = _build(jpt, name)
    tm, ts, _, tf = _build(tpt, name)
    assert json.loads(j_to_json(jm)) == json.loads(t_to_json(tm))
    assert json.loads(j_to_json(js)) == json.loads(t_to_json(ts))
    names = [v.name for v in tf]
    assert len(set(names)) == len(names)  # a suffix a pass
    j_exe = jpt.Executor()
    j_exe.run(js, scope=jpt.Scope())
    want = j_exe.run(jm, feed=feed, fetch_list=[v.name for v in jf],
                     scope=jpt.Scope())
    exe, scope = tpt.Executor(tpt.CPUPlace()), tpt.Scope()
    exe.run(ts, scope=scope)
    eager = exe.run(tm, feed=feed, fetch_list=names, scope=scope)
    again = exe.run(tm, feed=feed, fetch_list=names, scope=scope)
    for got, cached, w, analytic in zip(eager, again, want, _want(name)):
        np.testing.assert_allclose(got, analytic, **ANALYTIC_TOL[name])
        np.testing.assert_allclose(got, np.asarray(w), rtol=1e-6, atol=1e-7)
        assert got.tobytes() == cached.tobytes()


def test_grad_op_of_a_grad_op_is_emitted_with_the_pass_suffixes():
    tm, _, _, (g1, g2, g3) = _build(tpt, "cube")
    assert (g1.name, g2.name, g3.name) == ("x@GRAD", "x@GRAD2", "x@GRAD3")
    types = [op.type for op in tm.global_block().ops]
    assert "elementwise_mul_grad_grad" in types
    assert "elementwise_mul_grad_grad_grad" in types
    with grad_suffix_guard("@GRAD2"):
        assert grad_var_name("x") == "x@GRAD2"
    assert grad_var_name("x") == "x@GRAD"
    assert original_name("fc_0.tmp_1@GRAD2") == "fc_0.tmp_1@GRAD2"


@pytest.mark.parametrize("op,expr", [
    ("elementwise_add", lambda x, y: x + y),
    ("elementwise_sub", lambda x, y: 1.0 - x),
    ("elementwise_mul", lambda x, y: -x),
    ("elementwise_div", lambda x, y: x / y),
    ("elementwise_pow", lambda x, y: x ** 2),
    ("matmul_v2", lambda x, y: x @ y),
    ("less_equal", lambda x, y: x <= y),
    ("greater_than", lambda x, y: x > y),
])
def test_operator_overloads_emit_the_reference_ops(op, expr):
    progs = []
    for pkg in (jpt, tpt):
        if pkg is jpt:
            j_reset_names()
            j_reset_seed()
        else:
            tpt.reset_unique_name()
            t_reset_seed()
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            x = pkg.layers.data("x", [3, 3], append_batch_size=False)
            y = pkg.layers.data("y", [3, 3], append_batch_size=False)
            out = expr(x, y)
        progs.append(main)
        assert main.global_block().ops[-1].type == op
    assert json.loads(j_to_json(progs[0])) == json.loads(t_to_json(progs[1]))
    if op in ("less_equal", "greater_than"):
        assert out.dtype == "bool"


def test_dygraph_overloading_raises_naming_its_queue_item():
    from paddle_tpu_torch.layers import math_op_patch

    with pytest.raises(NotImplementedError, match="item 8"):
        math_op_patch.binary(np.ones(3, "float32"), 1.0, "elementwise_add")
