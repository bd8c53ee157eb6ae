"""The static training recipe in the port: LR decays, gradient clips,
weight decay and multi-input ``fc``, each against its closed form and
against the JAX package.

* LR decays (twins of tests/test_lr_clip_ema.py's schedule tests): every
  decay, ``polynomial_decay`` with ``cycle``, and ``linear_lr_warmup``
  around a decay (Llama-2's warmup then cosine among them), 8 or 9 runs:
  the closed form within the reference tests' rtol 1e-5, the JAX
  package's values within rtol 1e-6 (float32 pow / exp / cos of two
  libraries).
* Clips (twins of the clip tests and of the fused-clip test): ByGlobalNorm,
  ByNorm, ByValue, under the norm, ``set_gradient_clip`` as the
  program's default (and over a parameter list), and
  ``PT_FUSED_GLOBAL_CLIP=1``'s ``global_norm_sq`` equal to the per-grad
  chain (rtol 1e-6, atol 1e-7) and to the JAX package's fused clip.  A
  [1, 4] x through ``fc`` with a [4, 1] weight stands for the reference's
  ``create_parameter`` (the port has no such layer): the same gradient.
* L2Decay / L1Decay with SGD and Adam, as the optimizer's regularization
  and per parameter (a parameter's own regularizer replaces the
  optimizer's): 3 steps from the JAX startup scope, every persistable
  within 1e-6 of the JAX package's (fp32).
* ``fc`` over two inputs: one ``mul`` an input, then ``sum``; the same
  program as the JAX package's (JSON), and its output and its inputs'
  and weights' gradients within 1e-6 of the JAX package's.
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
from paddle_tpu_torch.interop import scope_from_arrays
from paddle_tpu_torch.ops.registry import reset_op_seed as t_reset_seed


def _fresh(pkg):
    """New (main, startup) with names and op seeds restarted."""
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


def _run_schedule(pkg, build, steps=8):
    main, startup = _fresh(pkg)
    with pkg.program_guard(main, startup):
        lr = build(pkg.layers)
    exe, scope = _exe(pkg), pkg.Scope()
    exe.run(startup, scope=scope)
    return [float(np.asarray(exe.run(main, feed={}, fetch_list=[lr],
                                     scope=scope)[0]).reshape(-1)[0])
            for _ in range(steps)]


# (build, closed form of step s, runs, rtol against the closed form)
SCHEDULES = {
    "exponential": (lambda L: L.exponential_decay(0.1, 4, 0.5),
                     lambda s: 0.1 * 0.5 ** (s / 4), 8),
    "exponential_staircase": (
        lambda L: L.exponential_decay(0.1, 4, 0.5, staircase=True),
        lambda s: 0.1 * 0.5 ** (s // 4), 8),
    "natural_exp": (lambda L: L.natural_exp_decay(0.1, 4, 0.5),
                    lambda s: 0.1 * math.exp(-0.5 * s / 4), 8),
    "inverse_time": (lambda L: L.inverse_time_decay(0.1, 4, 0.5),
                     lambda s: 0.1 / (1 + 0.5 * s / 4), 8),
    "noam": (lambda L: L.noam_decay(64, 4),
             lambda s: 64 ** -0.5 * min((s + 1) ** -0.5,
                                        (s + 1) * 4 ** -1.5), 8),
    "polynomial": (
        lambda L: L.polynomial_decay(0.1, 4, end_learning_rate=0.01,
                                     power=2.0),
        lambda s: (0.1 - 0.01) * (1 - min(s, 4) / 4) ** 2 + 0.01, 8),
    "polynomial_cycle": (
        lambda L: L.polynomial_decay(0.1, 4, end_learning_rate=0.01,
                                     power=2.0, cycle=True),
        lambda s: (0.1 - 0.01) * (1 - s / (4 * max(1, math.ceil(s / 4))))
        ** 2 + 0.01, 9),
    "piecewise": (lambda L: L.piecewise_decay([3, 6], [0.1, 0.01, 0.001]),
                  lambda s: [0.1, 0.01, 0.001][(s >= 3) + (s >= 6)], 9),
    "cosine": (lambda L: L.cosine_decay(0.1, step_each_epoch=2, epochs=4),
               lambda s: 0.05 * (math.cos((s // 2) * math.pi / 4) + 1), 8),
    "warmup_exponential": (
        lambda L: L.linear_lr_warmup(L.exponential_decay(0.1, 4, 0.5), 4,
                                     0.0, 0.1),
        lambda s: 0.1 * s / 4 if s < 4 else 0.1 * 0.5 ** (s / 4), 8),
    "warmup_cosine": (
        lambda L: L.linear_lr_warmup(L.cosine_decay(3e-4, 1, 6), 2, 0.0,
                                     3e-4),
        lambda s: 3e-4 * s / 2 if s < 2 else
        1.5e-4 * (math.cos(s * math.pi / 6) + 1), 8),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_schedule(name):
    build, closed, steps = SCHEDULES[name]
    got = _run_schedule(tpt, build, steps)
    np.testing.assert_allclose(got, [closed(s) for s in range(steps)],
                               rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(got, _run_schedule(jpt, build, steps),
                               rtol=1e-6, atol=1e-12)


def test_scheduler_drives_sgd():
    """Two steps at lr 0.1 (grad 1), then lr 0: w = 1 - 0.2."""
    main, startup = _fresh(tpt)
    with tpt.program_guard(main, startup):
        x = tpt.layers.data("x", [1, 4], append_batch_size=False)
        y = tpt.layers.fc(x, 1, bias_attr=False, param_attr=tpt.ParamAttr(
            name="w", initializer=tpt.initializer.Constant(1.0)))
        loss = tpt.layers.reduce_sum(y)
        lr = tpt.layers.piecewise_decay([2], [0.1, 0.0])
        tpt.optimizer.SGD(learning_rate=lr).minimize(loss)
    exe, scope = _exe(tpt), tpt.Scope()
    exe.run(startup, scope=scope)
    for _ in range(4):
        exe.run(main, feed={"x": np.ones((1, 4), "float32")},
                fetch_list=[loss], scope=scope)
    np.testing.assert_allclose(np.asarray(scope.find_var("w")).ravel(),
                               np.full(4, 0.8), rtol=1e-5)


def _clip_step(grad_clip, xv, program_clip=None, params=None):
    """One SGD(lr 1) step of loss = sum(x @ w) from w = 0, x [1, 4]: w
    becomes minus the clipped gradient x^T."""
    main, startup = _fresh(tpt)
    with tpt.program_guard(main, startup):
        x = tpt.layers.data("x", [1, 4], append_batch_size=False)
        y = tpt.layers.fc(x, 1, bias_attr=False, param_attr=tpt.ParamAttr(
            name="w", initializer=tpt.initializer.Constant(0.0)))
        loss = tpt.layers.reduce_sum(y)
        if program_clip is not None:
            tpt.clip.set_gradient_clip(program_clip, param_list=params)
        tpt.optimizer.SGD(learning_rate=1.0,
                          grad_clip=grad_clip).minimize(loss)
    exe, scope = _exe(tpt), tpt.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed={"x": xv[None]}, fetch_list=[loss], scope=scope)
    return np.asarray(scope.find_var("w")).ravel()


@pytest.mark.parametrize("case", [
    "global_norm", "by_norm", "by_value", "under_norm", "program_default",
    "program_default_param_list", "program_default_other_params"])
def test_grad_clip(case):
    big = np.array([3.0, 4.0, 0.0, 0.0], "float32")     # ||g|| = 5
    mixed = np.array([3.0, -4.0, 0.5, 0.0], "float32")
    small = np.array([0.3, 0.4, 0.0, 0.0], "float32")   # ||g|| = 0.5
    C = tpt.clip
    got, want = {
        "global_norm": (lambda: _clip_step(
            C.GradientClipByGlobalNorm(1.0), big), -big / 5.0),
        "by_norm": (lambda: _clip_step(C.GradientClipByNorm(2.5), big),
                    -big / 2.0),
        "by_value": (lambda: _clip_step(C.GradientClipByValue(1.0), mixed),
                     -np.clip(mixed, -1, 1)),
        "under_norm": (lambda: _clip_step(
            C.GradientClipByGlobalNorm(1.0), small), -small),
        "program_default": (lambda: _clip_step(
            None, big, C.GradientClipByGlobalNorm(1.0)), -big / 5.0),
        "program_default_param_list": (lambda: _clip_step(
            None, big, C.GradientClipByGlobalNorm(1.0), ["w"]), -big / 5.0),
        "program_default_other_params": (lambda: _clip_step(
            None, big, C.GradientClipByGlobalNorm(1.0), ["v"]), -big),
    }[case]
    np.testing.assert_allclose(got(), want, rtol=1e-5)


def test_set_gradient_clip_refuses_a_non_clip():
    with pytest.raises(TypeError, match="GradientClipBase"):
        tpt.clip.set_gradient_clip(1.0)


def _fused_clip_run(pkg, fused, monkeypatch):
    monkeypatch.setenv("PT_FUSED_GLOBAL_CLIP", "1" if fused else "0")
    main, startup = _fresh(pkg)
    with pkg.program_guard(main, startup):
        x = pkg.layers.data("gx", [6])
        y = pkg.layers.fc(x, 4, param_attr="gw")
        loss = pkg.layers.mean(pkg.layers.elementwise_mul(y, y))
        loss = pkg.layers.scale(loss, scale=100.0)  # force clipping
        pkg.optimizer.SGDOptimizer(
            0.1, grad_clip=pkg.clip.GradientClipByGlobalNorm(0.5)
        ).minimize(loss)
    assert fused == any(op.type == "global_norm_sq"
                        for op in main.global_block().ops)
    return main, startup, loss


def test_fused_global_norm_clip_matches_default(monkeypatch):
    xv = np.random.RandomState(0).randn(8, 6).astype("float32")
    j_main, j_startup, _ = _fused_clip_run(jpt, True, monkeypatch)
    j_scope = jpt.Scope()
    jpt.Executor().run(j_startup, scope=j_scope)
    arrays = {n: np.asarray(j_scope.find_var(n))
              for n in j_scope.local_var_names()}
    out = {}
    for pkg, fused in ((tpt, True), (tpt, False), (jpt, True)):
        main, _, loss = _fused_clip_run(pkg, fused, monkeypatch)
        if pkg is tpt:
            scope, exe = scope_from_arrays(arrays, "cpu", main), _exe(tpt)
        else:
            scope, exe = j_scope, jpt.Executor()
        for _ in range(3):
            exe.run(main, feed={"gx": xv}, fetch_list=[loss], scope=scope)
        out[(pkg.__name__, fused)] = np.asarray(scope.find_var("gw"))
    np.testing.assert_allclose(out[("paddle_tpu_torch", True)],
                               out[("paddle_tpu_torch", False)],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(out[("paddle_tpu_torch", True)],
                               out[("paddle_tpu", True)], rtol=1e-6,
                               atol=1e-7)


def _reg_net(pkg, opt_name, decay, where):
    """x [8, 6] -> fc(4) -> mean squared error against y [8, 4]; the
    decay (L2 or L1, coefficient 0.05) as the optimizer's, on the weight
    alone, or both (the weight's own L1 over the optimizer's L2)."""
    main, startup = _fresh(pkg)
    R = pkg.regularizer
    reg = (R.L2Decay if decay == "l2" else R.L1Decay)(0.05)
    with pkg.program_guard(main, startup):
        x = pkg.layers.data("x", [6])
        y = pkg.layers.data("y", [4])
        w_reg = reg if where == "param" else (
            R.L1Decay(0.03) if where == "both" else None)
        pred = pkg.layers.fc(x, 4, param_attr=pkg.ParamAttr(
            name="rw", regularizer=w_reg))
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        opt_reg = None if where == "param" else (
            R.L2Decay(0.05) if where == "both" else reg)
        if opt_name == "sgd":
            opt = pkg.optimizer.SGDOptimizer(0.1, regularization=opt_reg)
        else:
            opt = pkg.optimizer.AdamOptimizer(0.01, regularization=opt_reg)
        opt.minimize(loss)
    return main, startup, loss.name


@pytest.mark.parametrize("opt_name", ["sgd", "adam"])
@pytest.mark.parametrize("decay,where", [
    ("l2", "optimizer"), ("l1", "optimizer"), ("l2", "param"),
    ("l1", "param"), ("l2", "both")])
def test_weight_decay_matches_jax(opt_name, decay, where):
    j_main, j_startup, loss = _reg_net(jpt, opt_name, decay, where)
    t_main, _, _ = _reg_net(tpt, opt_name, decay, where)
    assert json.loads(t_to_json(t_main)) == json.loads(j_to_json(j_main))
    ops = [op.type for op in t_main.global_block().ops]
    assert ("sign" in ops) == (decay == "l1" or where == "both")
    j_scope = jpt.Scope()
    jpt.Executor().run(j_startup, scope=j_scope)
    arrays = {n: np.asarray(j_scope.find_var(n))
              for n in j_scope.local_var_names()}
    t_scope = scope_from_arrays(arrays, "cpu", program=t_main)
    rng = np.random.RandomState(3)
    t_exe, j_exe = _exe(tpt), jpt.Executor()
    for _ in range(3):
        feed = {"x": rng.randn(8, 6).astype("float32"),
                "y": rng.randn(8, 4).astype("float32")}
        a = j_exe.run(j_main, feed=feed, fetch_list=[loss], scope=j_scope)
        b = t_exe.run(t_main, feed=feed, fetch_list=[loss], scope=t_scope)
        np.testing.assert_allclose(b[0], a[0], rtol=1e-6, atol=1e-6)
    for n in arrays:
        np.testing.assert_allclose(np.asarray(t_scope.find_var(n)),
                                   np.asarray(j_scope.find_var(n)),
                                   rtol=0, atol=1e-6, err_msg=n)
    # the decay moved the weight: against the same run without it
    assert not np.allclose(np.asarray(t_scope.find_var("rw")), arrays["rw"])


def _fc2(pkg):
    main, startup = _fresh(pkg)
    with pkg.program_guard(main, startup):
        a = pkg.layers.data("a", [5])
        b = pkg.layers.data("b", [2, 3])
        a.stop_gradient = b.stop_gradient = False
        out = pkg.layers.fc([a, b], 4, act="gelu")
        loss = pkg.layers.mean(out)
        pkg.framework.backward.append_backward(loss)
    return main, startup, out.name


def test_multi_input_fc_matches_jax():
    j_main, j_startup, out = _fc2(jpt)
    t_main, _, _ = _fc2(tpt)
    assert json.loads(t_to_json(t_main)) == json.loads(j_to_json(j_main))
    types = [op.type for op in t_main.global_block().ops]
    assert types[:4] == ["mul", "mul", "sum", "elementwise_add"]
    j_scope = jpt.Scope()
    jpt.Executor().run(j_startup, scope=j_scope)
    arrays = {n: np.asarray(j_scope.find_var(n))
              for n in j_scope.local_var_names()}
    t_scope = scope_from_arrays(arrays, "cpu", program=t_main)
    rng = np.random.RandomState(4)
    feed = {"a": rng.randn(3, 5).astype("float32"),
            "b": rng.randn(3, 2, 3).astype("float32")}
    fetch = [out, "a@GRAD", "b@GRAD"] + [f"{p}@GRAD" for p in sorted(arrays)]
    want = jpt.Executor().run(j_main, feed=feed, fetch_list=fetch,
                              scope=j_scope)
    got = _exe(tpt).run(t_main, feed=feed, fetch_list=fetch, scope=t_scope)
    for n, g, w in zip(fetch, got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=n)
