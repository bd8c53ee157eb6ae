"""The AMP ops ``check_finite_and_unscale`` and ``update_loss_scaling``
in the port against the JAX package's lowerings, at tolerance 0.

A program holding the two ops over seeded float16 and float32 gradients
(inf, -inf and NaN planted where a case says so) is built in the JAX
package, serialised, loaded by the port's serde and run by both on the
CPU from the same state (the loss scale and the good / bad counters).
Every output is compared bit for bit (NaN against NaN): the unscaled
gradients (a division in float32, cast back, in both), the flag, the
new scale and counters, and the gradients ``update_loss_scaling``
zeroes or keeps.  The cases walk every branch of the state machine:
count a good step, grow, count a bad step, shrink, the 1e-8 floor, the
counter resets, and ``stop_update``.  Then the port's twin of
tests/test_meta_optimizers.py::test_fp16_loss_scaling_recovers_from_inf.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu.framework.serde import program_to_json
from paddle_tpu_torch.framework.serde import program_from_json

SHAPES = ((3, 5), (7,), (2, 2, 4))
DTYPES = ("float16", "float32", "float16")
STATE = ("loss_scaling_0", "loss_scaling_good_0", "loss_scaling_bad_0")


def _grads(seed, plant):
    """Seeded gradients, already multiplied by a scale of 2**15 (float16
    ones within its range); `plant` puts (grad index, flat index, value)
    into them."""
    rng = np.random.RandomState(seed)
    gs = [(rng.randn(*s) * 2.0 ** 12).astype(d)
          for s, d in zip(SHAPES, DTYPES)]
    for i, j, v in plant:
        gs[i].reshape(-1)[j] = v
    return {f"g{i}": g for i, g in enumerate(gs)}


def _program(with_update, attrs):
    """The JAX-built program: check_finite_and_unscale over g0..g2 in
    place, then (with_update) update_loss_scaling over them."""
    main = jpt.Program()
    block = main.global_block()
    names = [f"g{i}" for i in range(len(SHAPES))]
    for n, s, d in zip(names, SHAPES, DTYPES):
        block.create_var(name=n, shape=list(s), dtype=d, is_data=True)
    for n, d in zip(STATE, ("float32", "int32", "int32")):
        block.create_var(name=n, shape=[1], dtype=d, persistable=True)
    block.create_var(name="found", shape=[1], dtype="bool")
    with jpt.program_guard(main, jpt.Program()):
        block.append_op("check_finite_and_unscale",
                        inputs={"X": names, "Scale": [STATE[0]]},
                        outputs={"Out": names, "FoundInfinite": ["found"]})
        if with_update:
            block.append_op(
                "update_loss_scaling",
                inputs={"X": names, "FoundInfinite": ["found"],
                        "PrevLossScaling": [STATE[0]],
                        "InGoodSteps": [STATE[1]], "InBadSteps": [STATE[2]]},
                outputs={"Out": names, "LossScaling": [STATE[0]],
                         "OutGoodSteps": [STATE[1]],
                         "OutBadSteps": [STATE[2]]},
                attrs=attrs)
    return main, names


def _run_both(feed, state, with_update=True, attrs=None):
    """(JAX package's fetches, the port's, fetch names)."""
    main, names = _program(with_update, attrs or {})
    fetch = names + ["found"] + (list(STATE) if with_update else [])
    j_scope = jpt.Scope()
    t_scope = tpt.Scope()
    for n, v in zip(STATE, state):
        arr = np.array([v], "float32" if n == STATE[0] else "int32")
        j_scope.set_var(n, arr)
        t_scope.set_var(n, arr)
    want = jpt.Executor().run(main, feed=feed, fetch_list=fetch,
                              scope=j_scope)
    t_main = program_from_json(program_to_json(main))
    assert json.loads(program_to_json(main))["blocks"][0]["ops"] == \
        [op.to_dict() for op in t_main.global_block().ops]
    got = tpt.Executor(tpt.CPUPlace()).run(t_main, feed=feed,
                                           fetch_list=fetch, scope=t_scope)
    return [np.asarray(w) for w in want], [np.asarray(g) for g in got], fetch


def _assert_bit_equal(want, got, fetch):
    for name, w, g in zip(fetch, want, got):
        assert g.dtype == w.dtype and g.shape == w.shape, (name, g.dtype,
                                                           w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=name)


INF, NAN = np.inf, np.nan
PLANTS = {
    "finite": (),
    "fp16_inf": ((0, 4, INF),),
    "fp16_neg_inf": ((2, 9, -INF),),
    "fp32_nan": ((1, 3, NAN),),
    "all_three": ((0, 0, NAN), (1, 6, -INF), (2, 15, INF)),
}


@pytest.mark.parametrize("scale", [2.0 ** 15, 3.0, 1e-3],
                         ids=["pow2", "odd", "small"])
@pytest.mark.parametrize("plant", sorted(PLANTS))
def test_check_finite_and_unscale_bit_equal(plant, scale):
    """The unscaled gradients and the flag, with nothing after the op:
    non-finite values pass through as the division leaves them, and a
    small scale pushes float16 gradients past 65504 after the division
    (finite in float32, so not flagged; inf once cast back, as in the
    reference)."""
    feed = _grads(0, PLANTS[plant])
    want, got, fetch = _run_both(feed, (scale, 0, 0), with_update=False)
    _assert_bit_equal(want, got, fetch)
    assert bool(got[-1][0]) == bool(PLANTS[plant])
    if scale == 1e-3:
        assert np.isinf(got[0]).any()


# (name, plant, (scale, good, bad) before, attrs, (scale, good, bad) after)
MACHINE = [
    ("count_good", (), (2.0 ** 15, 3, 1), dict(incr_every_n_steps=5),
     (2.0 ** 15, 4, 0)),
    ("grow", (), (2.0 ** 15, 4, 0), dict(incr_every_n_steps=5),
     (2.0 ** 16, 0, 0)),
    ("grow_ratio", (), (1000.0, 0, 0), dict(incr_every_n_steps=1,
                                            incr_ratio=3.0),
     (3000.0, 0, 0)),
    ("count_bad", PLANTS["fp16_inf"], (2.0 ** 15, 7, 0),
     dict(decr_every_n_nan_or_inf=2), (2.0 ** 15, 0, 1)),
    ("shrink", PLANTS["fp32_nan"], (2.0 ** 15, 0, 1),
     dict(decr_every_n_nan_or_inf=2), (2.0 ** 14, 0, 0)),
    ("shrink_ratio", PLANTS["all_three"], (2.0 ** 15, 3, 0),
     dict(decr_every_n_nan_or_inf=1, decr_ratio=0.25), (2.0 ** 13, 0, 0)),
    ("floor", PLANTS["fp16_neg_inf"], (1.5e-8, 0, 0),
     dict(decr_every_n_nan_or_inf=1), (1e-8, 0, 0)),
    ("defaults_bad", PLANTS["fp16_inf"], (2.0 ** 15, 999, 0), {},
     (2.0 ** 15, 0, 1)),
    ("defaults_grow", (), (2.0 ** 15, 999, 1), {}, (2.0 ** 16, 0, 0)),
]


@pytest.mark.parametrize("stop_update", [False, True],
                         ids=["update", "stop_update"])
@pytest.mark.parametrize("case", MACHINE, ids=[c[0] for c in MACHINE])
def test_update_loss_scaling_bit_equal(case, stop_update):
    """Each branch of the state machine: the new scale and counters as
    the case says, every output bit-equal to the JAX lowering's, and the
    gradients zeroed on a non-finite step unless ``stop_update``."""
    _, plant, before, attrs, after = case
    attrs = dict(attrs, stop_update=stop_update)
    feed = _grads(1, plant)
    want, got, fetch = _run_both(feed, before, attrs=attrs)
    _assert_bit_equal(want, got, fetch)
    scale, good, bad = (g[0] for g in got[-3:])
    assert (good, bad) == after[1:]
    np.testing.assert_allclose(scale, after[0], rtol=1e-7)
    found = bool(got[3][0])
    assert found == bool(plant)
    for g in got[:3]:
        if found and not stop_update:
            assert not g.any()
        elif not found:
            assert np.isfinite(g).all() and g.any()


def test_update_loss_scaling_state_in_place():
    """The scale and the counters are written into the scope's own
    tensors (their storage survives the step), as every stateful op of
    the port writes its state where the run may update it in place."""
    main, names = _program(True, dict(incr_every_n_steps=1))
    t_main = program_from_json(program_to_json(main))
    scope = tpt.Scope()
    for n, v in zip(STATE, (2.0 ** 15, 0, 0)):
        scope.set_var(n, np.array([v], "float32" if n == STATE[0]
                                  else "int32"))
    exe = tpt.Executor(tpt.CPUPlace())
    exe.run(t_main, feed=_grads(2, ()), fetch_list=[], scope=scope)
    ptrs = [scope.find_var(n).data_ptr() for n in STATE]
    for _ in range(2):
        exe.run(t_main, feed=_grads(2, ()), fetch_list=[], scope=scope)
    assert [scope.find_var(n).data_ptr() for n in STATE] == ptrs
    assert scope.find_var(STATE[0]).item() == 2.0 ** 18


def test_fp16_loss_scaling_recovers_from_inf():
    """Twin of the JAX package's test: a huge loss scale forces an inf
    gradient, the step leaves the weight as it was and the scale drops
    below 1e38 (decr_every_n_nan_or_inf=1)."""
    from paddle_tpu_torch.contrib.mixed_precision import decorate
    main, startup = tpt.Program(), tpt.Program()
    startup._is_startup = True
    with tpt.program_guard(main, startup):
        x = tpt.layers.data("x", [4, 4], append_batch_size=False)
        pred = tpt.layers.fc(x, 1, bias_attr=False)
        loss = tpt.layers.mean(pred)
        opt = decorate(tpt.optimizer.SGDOptimizer(0.1), dtype="float16",
                       init_loss_scaling=1e38, decr_every_n_nan_or_inf=1,
                       use_dynamic_loss_scaling=True)
        opt.minimize(loss)
    exe = tpt.Executor(tpt.CPUPlace())
    scope = tpt.Scope()
    exe.run(startup, scope=scope)
    wname = main.global_block().all_parameters()[0].name
    w0 = scope.find_var(wname).clone()
    exe.run(main, feed={"x": np.ones((4, 4), "float32")},
            fetch_list=[loss], scope=scope)
    torch.testing.assert_close(scope.find_var(wname), w0, rtol=0, atol=0)
    assert scope.find_var("loss_scaling_0").item() < 1e38
    types = [op.type for op in main.global_block().ops]
    assert types.index("check_finite_and_unscale") < \
        types.index("update_loss_scaling") < types.index("sgd")
