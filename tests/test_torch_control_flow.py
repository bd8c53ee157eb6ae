"""Static control flow in the port, against the JAX package: the ops
``conditional_block`` / ``cond2`` / ``while`` through the layers ``cond``,
``Switch``, ``While`` and ``while_loop``, and the logical and modulo ops
they need.

* Each program is JSON-equal to the JAX package's and gives its fetches
  on feeds that take every branch (float32 within rtol 1e-6, atol 1e-7,
  integers and booleans exactly).
* State a branch writes stays bit-identical (and in its own storage) on a
  run whose condition is false, and takes the branch's value on a true
  one.
* A ``while_loop`` whose trip count depends on its feed (halve x until
  its squared norm falls under a tolerance) gives the JAX package's
  answer at three trip counts through one executor entry, which runs
  eagerly (``cache_info``'s ``eager`` and ``eager_runs``) and reads its
  condition on the host once an iteration plus once at the exit
  (``control_flow_ops.LOOP_COUNTS``).
* ``increment``'s shape inference: the JAX package's infers nothing, so a
  ``while_loop`` that counts with ``increment(i, in_place=False)`` fails
  there at build time (``less_than``'s inference meets an unshaped
  input); the port's gives Out X's shape and the same loop builds and
  runs.  A program the JAX package can build (the in-place counter) stays
  JSON-equal.
* ``elementwise_mod`` is a floor modulo (the divisor's sign, as jnp.mod
  and torch.remainder; torch.fmod would differ on the negative operands
  used here), and the four logical ops, as ``OpCase`` s run in both
  packages (tests/torch_op_util.py).
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from op_test import OpCase
from paddle_tpu.framework.core import reset_unique_name as j_reset_names
from paddle_tpu.framework.serde import program_to_json as j_to_json
from paddle_tpu.ops.registry import reset_op_seed as j_reset_seed
from paddle_tpu_torch.framework.serde import program_to_json as t_to_json
from paddle_tpu_torch.ops import control_flow_ops
from paddle_tpu_torch.ops.registry import reset_op_seed as t_reset_seed
from torch_op_util import check_case

RTOL, ATOL = 1e-6, 1e-7


def _fresh(pkg):
    if pkg is jpt:
        j_reset_names()
        j_reset_seed()
    else:
        tpt.reset_unique_name()
        t_reset_seed()
    main, startup = pkg.Program(), pkg.Program()
    startup._is_startup = True
    return main, startup


def _exe(pkg):
    return pkg.Executor(pkg.CPUPlace()) if pkg is tpt else pkg.Executor()


def _build(pkg, make):
    main, startup = _fresh(pkg)
    with pkg.program_guard(main, startup):
        fetch = make(pkg)
    return main, startup, [v.name for v in fetch]


def _both(make, feeds):
    """Build `make` in both packages (JSON-equal programs), run each feed
    in one executor and scope a package, and compare the fetches."""
    progs = {pkg: _build(pkg, make) for pkg in (jpt, tpt)}
    assert json.loads(t_to_json(progs[tpt][0])) == \
        json.loads(j_to_json(progs[jpt][0]))
    assert json.loads(t_to_json(progs[tpt][1])) == \
        json.loads(j_to_json(progs[jpt][1]))
    runs = {}
    for pkg, (main, startup, fetch) in progs.items():
        exe, scope = _exe(pkg), pkg.Scope()
        exe.run(startup, scope=scope)
        runs[pkg] = [exe.run(main, feed=f, fetch_list=fetch, scope=scope)
                     for f in feeds]
        runs[pkg, "exe"] = exe
    for i, (want, got) in enumerate(zip(runs[jpt], runs[tpt])):
        for w, g in zip(want, got):
            w, g = np.asarray(w), np.asarray(g)
            assert g.shape == w.shape, (i, g.shape, w.shape)
            if w.dtype.kind in "biu":
                np.testing.assert_array_equal(g.astype(w.dtype), w)
            else:
                np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    return runs[tpt], runs[tpt, "exe"], progs[tpt][0]


def _x(value):
    return {"x": np.array([value], "float32")}


def _cond_net(pkg):
    L = pkg.layers
    x = L.data("x", [1], append_batch_size=False)
    zero = L.fill_constant([1], "float32", 0.0)
    out = L.cond(L.less_than(x, zero),
                 lambda: [L.scale(x, -2.0), L.elementwise_mul(x, x)],
                 lambda: [L.scale(x, 3.0, bias=1.0), L.exp(x)])
    return out


def test_cond_selects_each_branch():
    got, _, _ = _both(_cond_net, [_x(-1.5), _x(0.75), _x(0.0)])
    np.testing.assert_allclose(got[0][0], [3.0])
    np.testing.assert_allclose(got[1][0], [3.25])


def _switch_net(pkg):
    L = pkg.layers
    x = L.data("x", [1], append_batch_size=False)
    out = L.fill_constant([1], "float32", -1.0)
    with L.Switch() as switch:
        with switch.case(L.less_than(x, L.fill_constant([1], "float32",
                                                         0.0))):
            L.assign(L.scale(x, -1.0), out)
        with switch.case(L.less_than(x, L.fill_constant([1], "float32",
                                                         1.0))):
            L.assign(L.fill_constant([1], "float32", 10.0), out)
        with switch.default():
            L.assign(L.elementwise_mul(x, x), out)
    return [out]


def test_switch_takes_the_first_case_that_holds():
    got, _, main = _both(_switch_net, [_x(-2.0), _x(0.5), _x(3.0),
                                       _x(0.0)])
    assert [float(g[0][0]) for g in got] == [2.0, 10.0, 9.0, 10.0]
    types = [op.type for op in main.global_block().ops]
    assert types.count("conditional_block") == 3
    assert {"logical_and", "logical_not"} <= set(types)


def _halving(pkg, tol=0.01):
    """Halve x until sum(x * x) < tol; count the halvings in i."""
    L = pkg.layers
    x = L.data("x", [4], append_batch_size=False)
    i = L.fill_constant([1], "int64", 0)
    one = L.fill_constant([1], "int64", 1)
    tol_v = L.fill_constant([1], "float32", tol)

    def cond(i, x):
        return L.less_than(tol_v, L.reduce_sum(L.elementwise_mul(x, x)))

    def body(i, x):
        return [L.elementwise_add(i, one), L.scale(x, 0.5)]

    i, x = L.while_loop(cond, body, [i, x])
    return [i, x]


def _vec(*v):
    return {"x": np.array(v, "float32")}


def test_while_loop_trip_count_follows_the_feed():
    control_flow_ops.LOOP_COUNTS.host_reads = 0
    control_flow_ops.LOOP_COUNTS.iterations = 0
    feeds = [_vec(1.0, 2.0, 0.5, -1.0), _vec(0.01, 0.0, 0.0, 0.02),
             _vec(30.0, -40.0, 5.0, 0.0)]
    got, exe, _ = _both(_halving, feeds)
    trips = [int(g[0][0]) for g in got]
    assert len(set(trips)) == 3 and trips[1] == 0, trips
    # the startup's entry and the loop's one, which ran all three feeds
    entries = exe.cache_info()["entries"]
    assert len(entries) == 2 and "eager" not in entries[0]
    assert entries[1]["eager"] is True and entries[1]["eager_runs"] == 3
    assert control_flow_ops.LOOP_COUNTS.iterations == sum(trips)
    assert control_flow_ops.LOOP_COUNTS.host_reads == sum(trips) + 3


def _while_class(pkg):
    """The While layer with an in-place counter (the reference's
    docstring example), summing i into acc."""
    L = pkg.layers
    n = L.data("n", [1], dtype="int64", append_batch_size=False)
    i = L.fill_constant([1], "int64", 0)
    acc = L.fill_constant([1], "int64", 0)
    c = L.less_than(i, n)
    w = L.While(c)
    with w.block():
        L.assign(L.elementwise_add(acc, i), acc)
        L.increment(i)
        L.assign(L.less_than(i, n), c)
    return [i, acc]


def test_while_class_with_an_in_place_counter():
    feeds = [{"n": np.array([k], "int64")} for k in (0, 1, 5)]
    got, _, _ = _both(_while_class, feeds)
    assert [(int(g[0][0]), int(g[1][0])) for g in got] == \
        [(0, 0), (1, 0), (5, 10)]


def _counting_loop(pkg):
    L = pkg.layers
    n = L.data("n", [1], dtype="int64", append_batch_size=False)
    i = L.fill_constant([1], "int64", 0)
    i = L.while_loop(lambda i: L.less_than(i, n),
                     lambda i: L.increment(i, 1.0, in_place=False), [i])
    return [i]


def test_out_of_place_increment_shape_inference():
    """The JAX package cannot build a loop counting with an out-of-place
    increment; the port builds it and runs it."""
    with pytest.raises(Exception):
        _build(jpt, _counting_loop)
    main, startup, fetch = _build(tpt, _counting_loop)
    out = [op for op in main.global_block().ops if op.type == "while"][0]
    inc = [op for op in main.block(out.attr("sub_block")).ops
           if op.type == "increment"][0]
    v = main.block(out.attr("sub_block")).var(inc.output("Out")[0])
    assert tuple(v.shape) == (1,) and v.dtype == "int64"
    exe, scope = _exe(tpt), tpt.Scope()
    exe.run(startup, scope=scope)
    for k in (0, 3, 7):
        got = exe.run(main, feed={"n": np.array([k], "int64")},
                      fetch_list=fetch, scope=scope)
        assert int(np.asarray(got[0])[0]) == k


def _branch_state(pkg):
    """A persistable s that a conditional_block scales by 2 on even runs
    (a step counter mod 2), the gradient merge's shape of program."""
    L = pkg.layers
    from_block = pkg.default_main_program().global_block()
    step = L.create_global_var([1], 0.0, "float32", persistable=True,
                               name="step")
    s = L.create_global_var([3], 1.5, "float32", persistable=True,
                            name="s")
    L.increment(step, 1.0)
    pred = L.equal(L.elementwise_mod(step, L.fill_constant(
        [1], "float32", 2.0)), L.fill_constant([1], "float32", 0.0))
    main = pkg.default_main_program()
    sub = main._create_block()
    L.assign(L.scale(s, 2.0), s)
    main._rollback()
    from_block.append_op("conditional_block", inputs={"Cond": [pred]},
                         outputs={"Out": [s]},
                         attrs={"sub_block": sub.idx}, infer_shape=False)
    return [pred]


def test_a_false_step_leaves_branch_state_bit_identical():
    runs, _, main = _both(_branch_state, [{}] * 4)
    assert [bool(np.asarray(r[0])[0]) for r in runs] == \
        [False, True, False, True]
    main, startup, fetch = _build(tpt, _branch_state)
    exe, scope = _exe(tpt), tpt.Scope()
    exe.run(startup, scope=scope)
    s = scope.find_var("s")
    ptr = s.data_ptr()
    s.copy_(torch.tensor([float("nan"), -0.0, 3.0]))  # bits a copy keeps
    before = s.clone()
    exe.run(main, feed={}, fetch_list=fetch, scope=scope)  # step 1: false
    assert scope.find_var("s") is s and s.data_ptr() == ptr
    assert bool((s.view(torch.int32) == before.view(torch.int32)).all())
    exe.run(main, feed={}, fetch_list=fetch, scope=scope)  # step 2: true
    assert s.data_ptr() == ptr
    np.testing.assert_array_equal(s.numpy()[1:], [-0.0, 6.0])
    assert np.isnan(s.numpy()[0])


def test_print_waits_for_debug_ops():
    main, startup = _fresh(tpt)
    with tpt.program_guard(main, startup):
        x = tpt.layers.data("x", [1], append_batch_size=False)
        with pytest.raises(NotImplementedError, match="item 7"):
            tpt.layers.Print(x)


R = np.random.RandomState
_A = np.array([7.0, -7.0, 7.5, -7.5, 0.0, 3.0], "float32")
_B = np.array([3.0, 3.0, -2.0, -2.0, 5.0, -4.0], "float32")
_BOOL = R(4).rand(6) > 0.5, R(5).rand(6) > 0.5

OP_CASES = [
    OpCase("elementwise_mod", {"X": _A, "Y": _B}, name="mod_float"),
    OpCase("elementwise_mod", {"X": _A.astype("int64"),
                               "Y": _B.astype("int64")}, name="mod_int"),
    OpCase("logical_and", {"X": _BOOL[0], "Y": _BOOL[1]}),
    OpCase("logical_or", {"X": _BOOL[0], "Y": _BOOL[1]}),
    OpCase("logical_xor", {"X": _BOOL[0], "Y": _BOOL[1]}),
    OpCase("logical_not", {"X": _BOOL[0]}),
]


@pytest.mark.parametrize("case", OP_CASES, ids=[c.name for c in OP_CASES])
def test_logical_and_modulo_ops_follow_jax(case):
    got = np.asarray(check_case(case)[0])
    if case.op_type == "elementwise_mod":
        x, y = (case.inputs["X"].astype("float64"),
                case.inputs["Y"].astype("float64"))
        np.testing.assert_array_equal(got, np.mod(x, y).astype(got.dtype))
        assert not np.array_equal(got, np.fmod(x, y).astype(got.dtype))


def _mod_layers(pkg):
    L = pkg.layers
    x = L.data("x", [6], append_batch_size=False)
    y = L.data("y", [6], append_batch_size=False)
    a = L.data("a", [6], dtype="bool", append_batch_size=False)
    b = L.data("b", [6], dtype="bool", append_batch_size=False)
    return [L.elementwise_mod(x, y), L.logical_and(a, b),
            L.logical_or(a, b), L.logical_xor(a, b), L.logical_not(a)]


def test_logical_and_modulo_layers_build_the_reference_program():
    _both(_mod_layers, [{"x": _A, "y": _B, "a": _BOOL[0], "b": _BOOL[1]}])
