"""Card-only half of the recompute tests (``-m cuda``; they skip without a
card).  This file imports no jax, so it runs on the card's machine.

Recompute is plain bit for bit after a capture: a small net with a
dropout (0.5) inside a recomputed segment, trained plain and with
recompute from one startup state (each its own executor and scope), 5
runs each: the eager first run, the capture and its replay, then
replays.  The re-emitted dropout draws from its own generator, seeded
as the original's and registered with the graph, so every replay's
recomputed mask is the forward's: every loss and every persistable are
bit-equal, and the masks differ from run to run.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as tpt
from paddle_tpu_torch.ops.registry import reset_op_seed

RUNS = 5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _net(recompute):
    """x -> fc(256, gelu) -> dropout 0.5 -> fc(256, gelu) -> fc(1) ->
    mean squared error, Adam 1e-3; recompute checkpoints the second fc's
    output, so the first segment holds the dropout."""
    tpt.reset_unique_name()
    reset_op_seed()
    main, startup = tpt.Program(), tpt.Program()
    startup._is_startup = True
    with tpt.program_guard(main, startup):
        x = tpt.layers.data("x", [128])
        y = tpt.layers.data("y", [1])
        h = tpt.layers.fc(x, 256, act="gelu")
        h = tpt.layers.dropout(h, dropout_prob=0.5)
        h = tpt.layers.fc(h, 256, act="gelu")
        pred = tpt.layers.fc(h, 1)
        loss = tpt.layers.mean(tpt.layers.square_error_cost(pred, y))
        opt = tpt.optimizer.AdamOptimizer(1e-3)
        if recompute:
            opt = tpt.optimizer.RecomputeOptimizer(opt)
            opt._set_checkpoints([h])
        opt.minimize(loss)
    return main, startup, loss


def _feed(seed):
    rng = np.random.RandomState(seed)
    x = rng.rand(64, 128).astype("float32")
    return {"x": x, "y": x.mean(1, keepdims=True).astype("float32")}


@pytest.mark.cuda
def test_recompute_equals_plain_after_a_capture(card):
    runs = []
    for recompute in (False, True):
        main, startup, loss = _net(recompute)
        exe, scope = tpt.Executor(), tpt.Scope()
        exe.run(startup, scope=scope)
        losses = [exe.run(main, feed=_feed(i), fetch_list=[loss],
                          scope=scope)[0].tobytes() for i in range(RUNS)]
        assert exe.cache_info()["entries"][-1]["aot"]
        state = {v.name: scope.find_var(v.name).clone()
                 for v in main.list_vars() if v.persistable}
        runs.append((losses, state))
        exe.close()
    (l0, s0), (l1, s1) = runs
    assert l0 == l1
    assert sorted(s0) == sorted(s1)
    assert [n for n in s0 if not torch.equal(s0[n], s1[n])] == []
    assert len(set(l0)) == RUNS
