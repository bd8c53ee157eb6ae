"""The optimizer classes and wrappers of the optimizer tier in the port,
against the JAX package.

* Every class and wrapper (LARS, Adamax, Adadelta, RMSProp centered with
  momentum and plain, FTRL at two ``lr_power``, LAMB with its weight-decay
  exclusion, DecayedAdagrad, DP-SGD at sigma 0, gradient merge over SGD
  and over LAMB, Lookahead over Adam, EMA with its ramped decay,
  ModelAverage with a window that rotates): the main and startup
  programs JSON-equal to the JAX package's, then 5 steps on a small MLP
  (two ``fc`` layers, tanh) from the JAX startup scope copied across
  (``interop.scope_from_arrays``, which carries every new state: moments,
  the merge's accumulators and counter, the EMA's and ModelAverage's sums
  and counters, Lookahead's slow copies): every loss and every
  persistable after every step within rtol 1e-5, atol 1e-6 (float32
  norms, square roots and powers of two libraries; integer counters
  exactly).
* Twins of tests/test_lr_clip_ema.py's ``test_ema``,
  ``test_model_average`` and ``test_lookahead`` and of
  tests/test_meta_optimizers.py's ``test_gradient_merge_numeric``, with
  their closed forms and tolerances; the reference's ``create_parameter``
  (the port has no such layer) is an ``fc`` without bias over a [1, 2]
  input of ones, which gives the same gradient.
* Gradient merge at k 4 over batches of 8 against a plain step at batch
  32 on the same rows, LAMB inside both, over two windows: the merged
  mean gradient is the batch-32 gradient, within float32 limits
  (rtol 1e-5, atol 1e-6).
* EMA's and ModelAverage's swap exchange contents: every parameter keeps
  its tensor and ``data_ptr``, the executor's entry is reused, and
  ``restore`` gives back the bits.
"""
import json

import numpy as np
import pytest

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu.framework.core import reset_unique_name as j_reset_names
from paddle_tpu.framework.serde import program_to_json as j_to_json
from paddle_tpu.ops.registry import reset_op_seed as j_reset_seed
from paddle_tpu_torch.framework.serde import program_to_json as t_to_json
from paddle_tpu_torch.interop import scope_from_arrays
from paddle_tpu_torch.ops.registry import reset_op_seed as t_reset_seed

RTOL, ATOL = 1e-5, 1e-6
STEPS = 5
BATCH, FEAT = 8, 4


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


def _to_json(pkg, program):
    return (j_to_json if pkg is jpt else t_to_json)(program)


def _mlp(pkg, batch=BATCH):
    x = pkg.layers.data("x", [batch, FEAT], append_batch_size=False)
    h = pkg.layers.fc(x, 3, act="tanh")
    pred = pkg.layers.fc(h, 1)
    return pkg.layers.mean(pred * pred)


def _one_d(param):
    return len(param.shape) == 1


# name -> builder(pkg, loss): the optimizer (and wrapper) minimizing loss
CLASSES = {
    "lars_momentum": lambda pkg, loss: pkg.optimizer.LarsMomentumOptimizer(
        0.5, lars_coeff=0.01).minimize(loss),
    "adamax": lambda pkg, loss: pkg.optimizer.AdamaxOptimizer(
        0.05).minimize(loss),
    "adadelta": lambda pkg, loss: pkg.optimizer.AdadeltaOptimizer(
        1.0, rho=0.9).minimize(loss),
    "rmsprop_centered": lambda pkg, loss: pkg.optimizer.RMSPropOptimizer(
        0.01, rho=0.9, momentum=0.9, centered=True).minimize(loss),
    "rmsprop": lambda pkg, loss: pkg.optimizer.RMSProp(0.01).minimize(loss),
    "ftrl": lambda pkg, loss: pkg.optimizer.FtrlOptimizer(
        0.1, l1=0.01, l2=0.01).minimize(loss),
    "ftrl_power": lambda pkg, loss: pkg.optimizer.Ftrl(
        0.1, l1=0.001, lr_power=-0.3).minimize(loss),
    "lamb": lambda pkg, loss: pkg.optimizer.LambOptimizer(
        0.05, lamb_weight_decay=0.01,
        exclude_from_weight_decay_fn=_one_d).minimize(loss),
    "decayed_adagrad": lambda pkg, loss: pkg.optimizer.
    DecayedAdagradOptimizer(0.05).minimize(loss),
    "dpsgd_sigma0": lambda pkg, loss: pkg.optimizer.DpsgdOptimizer(
        0.1, clip=0.05, batch_size=1.0, sigma=0.0).minimize(loss),
    "gradient_merge_sgd": lambda pkg, loss: pkg.optimizer.
    GradientMergeOptimizer(pkg.optimizer.SGD(0.5), k_steps=2).minimize(
        loss),
    "gradient_merge_lamb_sum": lambda pkg, loss: pkg.optimizer.
    GradientMergeOptimizer(pkg.optimizer.Lamb(
        0.05, exclude_from_weight_decay_fn=_one_d), k_steps=2,
        avg=False).minimize(loss),
    "lookahead_adam": lambda pkg, loss: pkg.optimizer.LookaheadOptimizer(
        pkg.optimizer.Adam(0.05), alpha=0.5, k=2).minimize(loss),
    "ema": lambda pkg, loss: _ema(pkg, loss),
    "model_average": lambda pkg, loss: (
        pkg.optimizer.SGD(0.5).minimize(loss),
        pkg.optimizer.ModelAverage(0.5, min_average_window=2,
                                   max_average_window=3))[1],
}


def _ema(pkg, loss):
    pkg.optimizer.SGD(0.5).minimize(loss)
    ema = pkg.optimizer.ExponentialMovingAverage(0.9, thres_steps=True)
    ema.update()
    return ema


def _build(pkg, make, batch=BATCH):
    main, startup = _fresh(pkg)
    with pkg.program_guard(main, startup):
        loss = _mlp(pkg, batch)
        out = make(pkg, loss)
    return main, startup, loss.name, out


def _persistables(main):
    return sorted(v.name for v in main.list_vars() if v.persistable)


def _feeds(steps=STEPS, batch=BATCH, seed=0):
    rng = np.random.RandomState(seed)
    return [{"x": rng.uniform(-1, 1, (batch, FEAT)).astype("float32")}
            for _ in range(steps)]


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind in "iu":
        np.testing.assert_array_equal(got.astype("int64"),
                                      want.astype("int64"), err_msg=what)
    else:
        np.testing.assert_allclose(got.astype("float64"),
                                   want.astype("float64"), rtol=RTOL,
                                   atol=ATOL, err_msg=what)


def _jax_startup(j_main, j_startup):
    exe, scope = _exe(jpt), jpt.Scope()
    exe.run(j_startup, scope=scope)
    arrays = {n: np.asarray(scope.find_var(n)) for n in _persistables(j_main)}
    return exe, scope, arrays


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_class_program_and_trajectory_follow_jax(name):
    make = CLASSES[name]
    j_main, j_startup, j_loss, _ = _build(jpt, make)
    t_main, t_startup, t_loss, _ = _build(tpt, make)
    assert json.loads(_to_json(tpt, t_main)) == \
        json.loads(_to_json(jpt, j_main))
    assert json.loads(_to_json(tpt, t_startup)) == \
        json.loads(_to_json(jpt, j_startup))
    j_exe, j_scope, arrays = _jax_startup(j_main, j_startup)
    t_exe = _exe(tpt)
    t_scope = scope_from_arrays(arrays, tpt.CPUPlace(), t_main)
    names = _persistables(t_main)
    for i, feed in enumerate(_feeds()):
        want = j_exe.run(j_main, feed=feed, fetch_list=[j_loss],
                         scope=j_scope)[0]
        got = t_exe.run(t_main, feed=feed, fetch_list=[t_loss],
                        scope=t_scope)[0]
        _close(got, want, f"{name} step {i} loss")
        for n in names:
            _close(t_scope.find_var(n).numpy(), j_scope.find_var(n),
                   f"{name} step {i} {n}")


def test_lamb_exempts_the_one_d_parameters():
    main, _, _, _ = _build(tpt, CLASSES["lamb"])
    decay = {op.input("Param")[0]: op.attr("weight_decay")
             for op in main.global_block().ops if op.type == "lamb"}
    assert decay == {"fc_0.w_0": 0.01, "fc_0.w_1": 0.0, "fc_1.w_0": 0.01,
                     "fc_1.w_1": 0.0}


def test_aliases_and_names_match_the_reference():
    for alias in ("SGD", "Momentum", "Adam", "Adagrad", "Adamax",
                  "Adadelta", "RMSProp", "Ftrl", "Lamb", "LarsMomentum",
                  "DecayedAdagrad", "Dpsgd"):
        assert getattr(tpt.optimizer, alias).__name__ == \
            getattr(jpt.optimizer, alias).__name__
    assert sorted(tpt.optimizer.__all__) == sorted(jpt.optimizer.__all__)


@pytest.mark.parametrize("cls", ["DGCMomentumOptimizer",
                                 "PipelineOptimizer"])
def test_multi_device_optimizers_raise_naming_item_9(cls):
    with pytest.raises(NotImplementedError, match="item 9"):
        getattr(tpt.optimizer, cls)(0.1, 0.9)


# -- twins of the reference's closed-form tests ----------------------------

def _w_net(pkg, value=1.0):
    """loss = sum(x @ w) with x ones [1, 2] and w [2, 1] from `value`:
    the gradient of w is 1, as the reference's create_parameter net
    gives it."""
    x = pkg.layers.data("x", [1, 2], append_batch_size=False)
    out = pkg.layers.fc(x, 1, bias_attr=False, param_attr=pkg.ParamAttr(
        name="w", initializer=pkg.initializer.Constant(value)))
    return pkg.layers.reduce_sum(out)


def _w(scope):
    return scope.find_var("w").numpy().reshape(-1)


XV = {"x": np.ones((1, 2), "float32")}


def test_ema_twin():
    decay = 0.5
    main, startup = _fresh(tpt)
    with tpt.program_guard(main, startup):
        loss = _w_net(tpt)
        tpt.optimizer.SGD(learning_rate=0.5).minimize(loss)
        ema = tpt.optimizer.ExponentialMovingAverage(decay)
        ema.update()
    exe, scope = _exe(tpt), tpt.Scope()
    exe.run(startup, scope=scope)
    w_host, ema_host = 1.0, 0.0
    for _ in range(3):
        exe.run(main, feed=XV, fetch_list=[loss], scope=scope)
        w_host -= 0.5
        ema_host = decay * ema_host + (1 - decay) * w_host
    np.testing.assert_allclose(_w(scope), np.full(2, w_host), rtol=1e-5)
    corrected = ema_host / (1 - decay ** 3)
    with ema.apply(exe, scope=scope):
        np.testing.assert_allclose(_w(scope), np.full(2, corrected),
                                   rtol=1e-5)
    np.testing.assert_allclose(_w(scope), np.full(2, w_host), rtol=1e-5)


def test_model_average_twin():
    main, startup = _fresh(tpt)
    with tpt.program_guard(main, startup):
        loss = _w_net(tpt)
        tpt.optimizer.SGD(learning_rate=1.0).minimize(loss)
        avg = tpt.optimizer.ModelAverage(0.5, min_average_window=2,
                                         max_average_window=100)
    exe, scope = _exe(tpt), tpt.Scope()
    exe.run(startup, scope=scope)
    seen, w_host = [], 1.0
    for _ in range(4):
        exe.run(main, feed=XV, fetch_list=[loss], scope=scope)
        w_host -= 1.0
        seen.append(w_host)
    with avg.apply(exe, scope=scope):
        got = _w(scope).copy()
    assert seen[-1] - 1e-6 <= got[0] <= seen[0] + 1e-6
    np.testing.assert_allclose(_w(scope), np.full(2, w_host), rtol=1e-5)


def test_lookahead_twin():
    alpha, k = 0.5, 2
    main, startup = _fresh(tpt)
    with tpt.program_guard(main, startup):
        loss = _w_net(tpt)
        tpt.optimizer.LookaheadOptimizer(
            tpt.optimizer.SGD(learning_rate=1.0), alpha=alpha,
            k=k).minimize(loss)
    exe, scope = _exe(tpt), tpt.Scope()
    exe.run(startup, scope=scope)
    fast, slow = 1.0, 1.0
    for step in range(1, 5):
        exe.run(main, feed=XV, fetch_list=[loss], scope=scope)
        fast -= 1.0
        if step % k == 0:
            slow = slow + alpha * (fast - slow)
            fast = slow
    np.testing.assert_allclose(_w(scope), np.full(2, fast), rtol=1e-5)


def test_gradient_merge_numeric_twin():
    """k=4 merge: no update for 3 steps, the averaged update at step 4."""
    rng = np.random.RandomState(0)
    xv = rng.rand(8, 4).astype("float32")
    w0 = rng.rand(4, 1).astype("float32")
    main, startup = _fresh(tpt)
    with tpt.program_guard(main, startup):
        x = tpt.layers.data("x", [8, 4], append_batch_size=False)
        pred = tpt.layers.fc(x, 1, param_attr=tpt.ParamAttr(
            initializer=tpt.initializer.NumpyArrayInitializer(w0)),
            bias_attr=False)
        loss = tpt.layers.mean(pred)
        tpt.optimizer.GradientMergeOptimizer(
            tpt.optimizer.SGDOptimizer(0.1), k_steps=4,
            avg=True).minimize(loss)
    exe, scope = _exe(tpt), tpt.Scope()
    exe.run(startup, scope=scope)
    wname = main.global_block().all_parameters()[0].name
    w_before = scope.find_var(wname).numpy().copy()
    for _ in range(3):
        exe.run(main, feed={"x": xv}, fetch_list=[loss], scope=scope)
    np.testing.assert_allclose(scope.find_var(wname).numpy(), w_before)
    exe.run(main, feed={"x": xv}, fetch_list=[loss], scope=scope)
    expected = w_before - 0.1 * xv.mean(0, keepdims=True).T
    np.testing.assert_allclose(scope.find_var(wname).numpy(), expected,
                               atol=1e-6)


def test_merged_batches_equal_one_large_batch():
    """LAMB under a k-4 merge over four batches of 8 takes the step LAMB
    takes on the 32 rows at once, window after window."""
    def lamb(pkg, loss):
        return pkg.optimizer.Lamb(0.05, exclude_from_weight_decay_fn=_one_d)

    m_main, m_startup, m_loss, _ = _build(
        tpt, lambda pkg, loss: tpt.optimizer.GradientMergeOptimizer(
            lamb(pkg, loss), k_steps=4, avg=True).minimize(loss))
    p_main, p_startup, p_loss, _ = _build(
        tpt, lambda pkg, loss: lamb(pkg, loss).minimize(loss), batch=32)
    exe = _exe(tpt)
    m_scope, p_scope = tpt.Scope(), tpt.Scope()
    exe.run(m_startup, scope=m_scope)
    exe.run(p_startup, scope=p_scope)
    for n in _persistables(p_main):  # one start for both
        m_scope.find_var(n).copy_(p_scope.find_var(n))
    params = [p.name for p in p_main.all_parameters()]
    for window in range(2):
        rows = _feeds(steps=1, batch=32, seed=10 + window)[0]["x"]
        for i in range(4):
            exe.run(m_main, feed={"x": rows[8 * i:8 * i + 8]},
                    fetch_list=[m_loss], scope=m_scope)
        exe.run(p_main, feed={"x": rows}, fetch_list=[p_loss],
                scope=p_scope)
        for n in params:
            _close(m_scope.find_var(n).numpy(), p_scope.find_var(n).numpy(),
                   f"window {window} {n}")


@pytest.mark.parametrize("kind", ["ema", "model_average"])
def test_swap_exchanges_contents_in_place(kind):
    main, startup, loss, swap = _build(tpt, CLASSES[kind])
    exe, scope = _exe(tpt), tpt.Scope()
    exe.run(startup, scope=scope)
    for feed in _feeds():
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    params = [p.name for p in main.all_parameters()]
    tensors = {n: scope.find_var(n) for n in params}
    ptrs = {n: t.data_ptr() for n, t in tensors.items()}
    before = {n: t.clone() for n, t in tensors.items()}
    entries = len(exe._cache)
    with swap.apply(exe, scope=scope):
        for n in params:
            assert scope.find_var(n) is tensors[n]
            assert tensors[n].data_ptr() == ptrs[n]
        assert any(not bool((tensors[n] == before[n]).all())
                   for n in params)
        # a step under the swap reuses the entry (and moves the swapped
        # values, which restore then overwrites)
        exe.run(main, feed=_feeds()[0], fetch_list=[loss], scope=scope)
        assert len(exe._cache) == entries
    for n in params:
        assert tensors[n].data_ptr() == ptrs[n]
        # restore writes back the values saved at apply, bit for bit
        assert bool((tensors[n] == before[n]).all()), n
