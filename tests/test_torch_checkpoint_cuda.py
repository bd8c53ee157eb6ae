"""Card-only halves of the checkpoint and resume tests (``-m cuda``; they
skip without a card).  This file imports no jax, so it runs on the
card's machine.

* A checkpoint loaded into an executor that has captured its step is
  written into the scope's own tensors: no new capture, every data_ptr
  kept, and the next replay computes a fresh executor's first step on
  the loaded weights, bit for bit.
* A replay at run r draws the dropout mask an eager run at r draws (the
  generators registered with the graph are seeded from the run count
  before each replay), so a fresh executor resumed at r reproduces the
  replayed run's output bit for bit.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as tpt
from paddle_tpu_torch import checkpoint as ckpt


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _net(dropout=0.0):
    tpt.reset_unique_name()
    main, startup = tpt.Program(), tpt.Program()
    startup._is_startup = True
    with tpt.program_guard(main, startup):
        x = tpt.layers.data("x", [64])
        y = tpt.layers.data("y", [1])
        if dropout:
            x = tpt.layers.dropout(x, dropout_prob=dropout)
        pred = tpt.layers.fc(x, 1)
        loss = tpt.layers.mean(tpt.layers.square_error_cost(pred, y))
        tpt.optimizer.SGDOptimizer(0.1).minimize(loss)
    return main, startup, loss


def _feed(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(16, 64).astype("float32")
    return {"x": x, "y": x.sum(1, keepdims=True).astype("float32")}


def _copy(scope, main):
    out = tpt.Scope()
    for v in main.list_vars():
        if v.persistable:
            out.set_var(v.name, scope.find_var(v.name).clone())
    return out


@pytest.mark.cuda
def test_load_into_a_captured_executor_then_replay_reads_it(tmp_path, card):
    d = str(tmp_path)
    main, startup, loss = _net()
    scope = tpt.Scope()
    tpt.Executor().run(startup, scope=scope)
    start = _copy(scope, main)
    exe = tpt.Executor()
    ckpt.save_checkpoint(d, 1, program=main, scope=start)
    for _ in range(3):  # eager, capture + replay, replay
        exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
    assert exe.captures() == [1]
    names = [v.name for v in main.list_vars() if v.persistable]
    ptrs = {n: scope.find_var(n).data_ptr() for n in names}
    ckpt.load_checkpoint(d, 1, program=main, scope=scope)
    got = exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
    assert exe.captures() == [1]  # no new capture: the graph read them
    assert {n: scope.find_var(n).data_ptr() for n in names} == ptrs
    want = tpt.Executor().run(main, feed=_feed(), fetch_list=[loss],
                              scope=start)
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.cuda
def test_a_replay_draws_the_mask_of_an_eager_run_at_its_count(card):
    tpt.reset_unique_name()
    main, startup = tpt.Program(), tpt.Program()
    startup._is_startup = True
    with tpt.program_guard(main, startup):
        x = tpt.layers.data("x", [4096])
        out = tpt.layers.dropout(x, dropout_prob=0.5)
    ones = {"x": np.ones((8, 4096), "float32")}
    exe = tpt.Executor()
    exe._step = 1  # its first run of the program is run 2
    masks = [exe.run(main, feed=ones, fetch_list=[out])[0]
             for _ in range(6)]   # runs 2..7: eager, capture, replays
    assert exe.captures() == [1]
    for r in range(2, 8):
        fresh = tpt.Executor()
        fresh._step = r - 1       # its first run, eager, is run r
        got = fresh.run(main, feed=ones, fetch_list=[out])[0]
        np.testing.assert_array_equal(got, masks[r - 2])
        fresh.close()
    assert not any(np.array_equal(a, b) for a, b in zip(masks, masks[1:]))


@pytest.mark.cuda
def test_dropout_training_resumed_on_the_card_is_bit_equal(tmp_path, card):
    """A dropout-0.5 program: 8 replayed steps against 4, a checkpoint
    and a fresh executor and scope resumed from it for the other 4."""
    d = str(tmp_path)
    main, startup, loss = _net(dropout=0.5)
    scope0 = tpt.Scope()
    tpt.Executor().run(startup, scope=scope0)
    a, b = _copy(scope0, main), _copy(scope0, main)
    exe_a = tpt.Executor()
    exe_a._step = 1
    la = [exe_a.run(main, feed=_feed(i), fetch_list=[loss], scope=a)[0]
          for i in range(8)]
    exe_b = tpt.Executor()
    exe_b._step = 1
    for i in range(4):
        exe_b.run(main, feed=_feed(i), fetch_list=[loss], scope=b)
    ckpt.save_checkpoint(d, exe_b._step, program=main, scope=b)
    c = _copy(scope0, main)
    exe_c = tpt.Executor()
    with tpt.scope_guard(c):
        assert exe_c.enable_auto_checkpoint(d, 100, program=main) == 5
    lc = [exe_c.run(main, feed=_feed(i), fetch_list=[loss], scope=c)[0]
          for i in range(4, 8)]
    np.testing.assert_array_equal(np.stack(lc), np.stack(la[4:]))
    for v in main.list_vars():
        if v.persistable:
            assert torch.equal(c.find_var(v.name), a.find_var(v.name)), \
                v.name
