"""Running the reference's per-op cases in the port: an ``OpCase``
(tests/op_test.py) is built by ``op_test._build`` in the JAX package
(with its weighted scalar loss and ``append_backward`` when the case
checks grads), serialised to JSON, loaded by the port's serde and run on
the CPU beside the JAX package on the same feed.  Used by
tests/test_torch_op_recipe.py; tests/op_test.py stays as it is.
"""
import json

import numpy as np

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from op_test import _as_list, _build
from paddle_tpu.framework.backward import append_backward
from paddle_tpu.framework.core import grad_var_name
from paddle_tpu.framework.serde import program_to_json
from paddle_tpu_torch.framework.serde import program_from_json


def grad_names(case):
    """The @GRAD names of the case's grad-checked inputs."""
    return [grad_var_name(f"in_{slot}_{j}") for slot in case.grad
            for j in range(len(_as_list(case.inputs[slot])))]


def run_both(case):
    """(JAX package's fetches, the port's fetches, fetch names): every
    output of the case's op, then the grads of its grad-checked inputs.
    The port runs the JAX-built program, serialised to JSON and loaded
    back, from an empty scope (the cases feed every input)."""
    main, startup, feed, outs, loss = _build(case, with_loss=bool(case.grad))
    if case.grad:
        with jpt.program_guard(main, startup):
            append_backward(main.global_block().var(loss))
    fetch = outs + grad_names(case)
    j_scope = jpt.Scope()
    j_exe = jpt.Executor()
    j_exe.run(startup, scope=j_scope)
    want = j_exe.run(main, feed=feed, fetch_list=fetch, scope=j_scope)
    t_main = program_from_json(program_to_json(main))
    assert json.loads(program_to_json(main))["blocks"][0]["ops"] == \
        [op.to_dict() for op in t_main.global_block().ops]
    t_exe = tpt.Executor(tpt.CPUPlace())
    t_scope = tpt.Scope()
    t_exe.run(program_from_json(program_to_json(startup)), scope=t_scope)
    got = t_exe.run(t_main, feed=feed, fetch_list=fetch, scope=t_scope)
    return want, got, fetch


def check_case(case):
    """The port's outputs and grads against the JAX package's, within the
    case's own rtol / atol (both sides analytic); a bool or integer
    output exactly.  Returns the port's fetches."""
    want, got, fetch = run_both(case)
    for name, g, w in zip(fetch, got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (case.name, name, g.shape, w.shape)
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g.astype(w.dtype), w,
                                          err_msg=f"{case.name}: {name}")
        else:
            np.testing.assert_allclose(
                g.astype("float64"), w.astype("float64"), rtol=case.rtol,
                atol=case.atol, err_msg=f"{case.name}: {name}")
    return got
