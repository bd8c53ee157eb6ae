"""The optimizer tier's control flow on the card.

Marked ``cuda`` (they skip without a card; no jax import, so they run on
the card's machine with ``--noconftest``):

* a gradient merge of 2 over SGD is captured: its conditional block is
  computed and selected on the card, so the replays that do not update
  leave the parameter bit-identical and in its own storage, the ones
  that do move it, and the losses and the parameter equal an eager
  life's bit for bit;
* a program holding a ``while`` is never captured: every run of its
  entry is eager on the card (``cache_info``'s ``eager_runs``), at trip
  counts that follow the feed, through one entry;
* ``cond`` replays give each feed's eager bits.

On the card: ``python -m pytest --noconftest -m cuda
tests/test_torch_control_flow_cuda.py``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as tpt


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graph capture)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _program(make):
    tpt.reset_unique_name()
    main, startup = tpt.Program(), tpt.Program()
    startup._is_startup = True
    with tpt.program_guard(main, startup):
        fetch = make(tpt.layers)
    return main, startup, fetch


def _merge_net(L):
    x = L.data("x", [4, 3], append_batch_size=False)
    loss = L.mean(L.fc(x, 1, bias_attr=False))
    tpt.optimizer.GradientMergeOptimizer(tpt.optimizer.SGD(0.1),
                                         k_steps=2).minimize(loss)
    return [loss]


def _life(main, startup, fetch, feeds, eager):
    exe, scope = tpt.Executor(), tpt.Scope()
    exe.run(startup, scope=scope)
    w = scope.find_var("fc_0.w_0")
    ptr, states, losses = w.data_ptr(), [], []
    for f in feeds:
        losses.append(exe.run(main, feed=f, fetch_list=fetch, scope=scope,
                              use_program_cache=not eager)[0])
        assert scope.find_var("fc_0.w_0") is w and w.data_ptr() == ptr
        states.append(w.clone())
    return exe, losses, states


@pytest.mark.cuda
def test_gradient_merge_is_captured_and_holds_its_state():
    _card()
    main, startup, fetch = _program(_merge_net)
    rng = np.random.RandomState(0)
    feeds = [{"x": rng.rand(4, 3).astype("float32")} for _ in range(6)]
    exe, losses, states = _life(main, startup, fetch, feeds, eager=False)
    assert exe.cache_info()["entries"][-1]["aot"]
    for i in range(1, 6):
        same = torch.equal(states[i].view(torch.int32),
                           states[i - 1].view(torch.int32))
        assert same == ((i + 1) % 2 == 1), i
    _, e_losses, e_states = _life(main, startup, fetch, feeds, eager=True)
    assert all(a.tobytes() == b.tobytes() for a, b in zip(losses, e_losses))
    assert all(torch.equal(a, b) for a, b in zip(states, e_states))


def _loop_net(L):
    x = L.data("x", [8], append_batch_size=False)
    i = L.fill_constant([1], "int64", 0)
    one = L.fill_constant([1], "int64", 1)
    tol = L.fill_constant([1], "float32", 1e-3)
    i, x = L.while_loop(
        lambda i, x: L.less_than(tol, L.reduce_sum(L.elementwise_mul(x, x))),
        lambda i, x: [L.elementwise_add(i, one), L.scale(x, 0.5)], [i, x])
    return [i, x]


@pytest.mark.cuda
def test_a_loop_runs_eagerly_on_the_card_through_one_entry():
    _card()
    main, startup, fetch = _program(_loop_net)
    exe, scope = tpt.Executor(), tpt.Scope()
    exe.run(startup, scope=scope)
    trips = []
    for s in (1.0, 1e-3, 100.0, 1.0):
        x = np.full(8, s, "float32")
        i, y = exe.run(main, feed={"x": x}, fetch_list=fetch, scope=scope)
        trips.append(int(np.ravel(i)[0]))
        np.testing.assert_array_equal(y, x * np.float32(0.5) ** trips[-1])
    entry = exe.cache_info()["entries"][-1]
    assert entry["eager"] and entry["eager_runs"] == 4 and not entry["aot"]
    assert trips[0] == trips[3] and len(set(trips)) == 3


def _cond_net(L):
    x = L.data("x", [1], append_batch_size=False)
    zero = L.fill_constant([1], "float32", 0.0)
    return [L.cond(L.less_than(x, zero), lambda: L.scale(x, -2.0),
                   lambda: L.exp(x))]


@pytest.mark.cuda
def test_cond_replays_give_the_eager_bits():
    _card()
    main, startup, fetch = _program(_cond_net)
    exe, scope = tpt.Executor(), tpt.Scope()
    exe.run(startup, scope=scope)
    feeds = [{"x": np.array([v], "float32")} for v in (-1.5, 0.75, 2.0)]
    first = [exe.run(main, feed=f, fetch_list=fetch, scope=scope)[0]
             for f in feeds]
    again = [exe.run(main, feed=f, fetch_list=fetch, scope=scope)[0]
             for f in feeds]
    assert exe.captures()[-1] == 1
    assert all(a.tobytes() == b.tobytes() for a, b in zip(first, again))
    np.testing.assert_allclose(first[0], [3.0])
