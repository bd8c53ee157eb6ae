"""The port's IR pass framework (``framework/ir.py``): twins of
tests/test_ir_pass.py, run in both packages where the reference test
runs its own.

* ``Graph``'s def-use view and chain matcher find the same producer,
  the two ``mul`` ops and the one mul -> elementwise_add -> relu chain;
  ``prune_by_fetch`` refuses an empty fetch set.
* A custom pass registers, a second registration is refused, an unknown
  name raises, and the pass runs on a program.
* ``apply_passes(["test_mode", "prune_by_fetch"])`` returns a pruned test
  clone, leaves the training program as it was, and the clone serves
  without the label: the port's output equals the JAX package's on the
  same weights within 1e-6, and the two clones are JSON-equal.
* ``graph_viz`` writes the DOT dump the JAX package writes, byte for
  byte, and passes the program through.
* ``quantization_transform`` and ``ps_transpile`` raise, naming their
  queue items (7 and 9).
"""
import json

import numpy as np
import pytest

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu.framework import ir as j_ir
from paddle_tpu.framework.core import reset_unique_name as j_reset_names
from paddle_tpu.framework.serde import program_to_json as j_to_json
from paddle_tpu.ops.registry import reset_op_seed as j_reset_seed
from paddle_tpu_torch.framework import ir as t_ir
from paddle_tpu_torch.framework.serde import program_to_json as t_to_json
from paddle_tpu_torch.interop import scope_from_arrays
from paddle_tpu_torch.ops.registry import reset_op_seed as t_reset_seed


def _net(pkg, train=False):
    """The reference test's two-fc regression net, in fresh programs."""
    if pkg is jpt:
        j_reset_names()
        j_reset_seed()
    else:
        tpt.reset_unique_name()
        t_reset_seed()
    main, startup = pkg.Program(), pkg.Program()
    startup._is_startup = True
    with pkg.program_guard(main, startup):
        x = pkg.layers.data("px", [4])
        y = pkg.layers.data("py", [1])
        h = pkg.layers.fc(x, 8, act="relu", name="pfc1")
        pred = pkg.layers.fc(h, 1, name="pfc2")
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        if train:
            pkg.optimizer.SGDOptimizer(0.1).minimize(loss)
    return main, startup, pred, loss


def test_graph_def_use_and_chain_matching():
    main, _, pred, _ = _net(tpt)
    g = t_ir.Graph(main)
    p = g.producer(pred.name)
    assert p is not None and p.type == "elementwise_add"
    assert len(list(g.ops("mul"))) == 2
    chains = list(g.match_chain("mul", "elementwise_add", "relu"))
    assert len(chains) == 1
    assert [op.type for op in chains[0]] == ["mul", "elementwise_add",
                                             "relu"]
    assert [c.type for c in g.consumers(chains[0][0].output("Out")[0])] == \
        ["elementwise_add"]
    with pytest.raises(ValueError, match="fetches"):
        t_ir.get_pass("prune_by_fetch").apply(main)


def test_custom_pass_and_registry():
    class CountOps(t_ir.Pass):
        def apply_impl(self, program, **attrs):
            program._op_count = len(program.global_block().ops)
            return program

    if "count_ops_test" not in t_ir.PassRegistry.registered():
        t_ir.register_pass("count_ops_test")(CountOps)
    with pytest.raises(ValueError, match="already registered"):
        t_ir.register_pass("count_ops_test")(CountOps)
    assert "count_ops_test" in t_ir.PassRegistry.registered()
    main, _, _, _ = _net(tpt)
    out = t_ir.get_pass("count_ops_test").apply(main)
    assert out is main and main._op_count > 0
    with pytest.raises(KeyError, match="unknown pass"):
        t_ir.get_pass("nope")


def test_builtin_pass_pipeline_prune_and_testmode():
    jm, js, jpred, _ = _net(jpt, train=True)
    tm, ts, tpred, _ = _net(tpt, train=True)
    n_before = len(tm.global_block().ops)
    j_inf = j_ir.apply_passes(jm, ["test_mode", "prune_by_fetch"],
                              feeds=["px"], fetches=[jpred.name])
    t_inf = t_ir.apply_passes(tm, ["test_mode", "prune_by_fetch"],
                              feeds=["px"], fetches=[tpred.name])
    assert t_inf is not tm
    assert len(tm.global_block().ops) == n_before
    types = [op.type for op in t_inf.global_block().ops]
    assert "sgd" not in types and "mse_loss" not in types
    assert json.loads(j_to_json(j_inf)) == json.loads(t_to_json(t_inf))
    j_scope, j_exe = jpt.Scope(), jpt.Executor()
    j_exe.run(js, scope=j_scope)
    names = [v.name for v in tm.list_vars() if v.persistable]
    t_scope = scope_from_arrays(
        {n: np.asarray(j_scope.find_var(n)) for n in names}, "cpu", tm)
    feed = {"px": np.random.RandomState(3).rand(2, 4).astype("float32")}
    want = j_exe.run(j_inf, feed=feed, fetch_list=[jpred.name],
                     scope=j_scope)
    got = tpt.Executor(tpt.CPUPlace()).run(
        t_inf, feed=feed, fetch_list=[tpred.name], scope=t_scope)
    assert got[0].shape == (2, 1)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-6,
                               atol=1e-6)


def test_graph_viz_pass_writes_the_reference_dot(tmp_path):
    jm, _, _, _ = _net(jpt, train=True)
    tm, _, _, _ = _net(tpt, train=True)
    j_path, t_path = tmp_path / "j.dot", tmp_path / "t.dot"
    j_ir.get_pass("graph_viz", graph_viz_path=str(j_path)).apply(jm)
    out = t_ir.get_pass("graph_viz", graph_viz_path=str(t_path)).apply(tm)
    assert out is tm
    assert t_path.read_text() == j_path.read_text()
    assert t_path.read_text().startswith("digraph G {")


@pytest.mark.parametrize("name,item", [("quantization_transform", "item 7"),
                                       ("ps_transpile", "item 9")])
def test_unported_passes_raise_naming_their_queue_items(name, item):
    main, startup, _, _ = _net(tpt, train=True)
    with pytest.raises(NotImplementedError, match=item):
        t_ir.get_pass(name, startup_program=startup).apply(main)
