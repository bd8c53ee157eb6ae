"""The sequence tier in the port (``ops/sequence_ops.py``,
``layers/sequence.py``) against the JAX package, on the CPU.

* Each of the 17 ops: its ``OpCase`` is built in the JAX package and run
  in the port (tests/torch_op_util.py), outputs and the grads of its
  float inputs within rtol 1e-5 / atol 1e-6 (the recurrences rtol 1e-4 /
  atol 1e-5: fifty products and squashings a row, summed in another order
  by XLA and by PyTorch), integer outputs exactly.  The TensorArray pair
  takes indices out of range as ``lax``'s dynamic indexing does: a
  negative one counts from the end once, then it is clamped.
* Twins of tests/test_sequence.py: the same layers built in both
  packages, run from the JAX startup scope (``interop.scope_from_arrays``)
  on the same feeds; forward values within 1e-5, training trajectories'
  losses within rtol 1e-4 over 3 steps, and the reference's own
  assertions on the port (the LSTM classifier and the GRU train, padding
  does not move the LSTM's last state).
* The book's understand_sentiment (tests/test_book.py: two stacked
  ``layers.lstm``) follows the JAX package step by step and trains.
* Forward-only sums over time are row-independent: a served batch's
  ``sequence_pool`` and ``reduce_sum`` rows equal the rows served alone,
  bit for bit.
"""
import numpy as np
import pytest

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from op_test import OpCase
from paddle_tpu.framework.core import reset_unique_name as j_reset_names
from paddle_tpu.ops.registry import reset_op_seed as j_reset_seed
from paddle_tpu_torch.interop import scope_from_arrays
from paddle_tpu_torch.ops.registry import reset_op_seed as t_reset_seed
from torch_op_util import check_case, run_both

R = np.random.RandomState
B, T, D = 4, 6, 3
LENGTHS = np.array([6, 3, 1, 4], "int64")
RNN_TOL = dict(rtol=1e-4, atol=1e-5)


def _x(seed=0, shape=(B, T, D)):
    return R(seed).rand(*shape).astype("float32")


CASES = [
    OpCase("sequence_mask", {"X": LENGTHS}, outputs={"Y": 1},
           attrs={"maxlen": T, "out_dtype": "float32"}),
    OpCase("sequence_mask", {"X": LENGTHS}, outputs={"Y": 1},
           attrs={"maxlen": 8, "out_dtype": "int64"},
           name="sequence_mask_int64"),
] + [
    OpCase("sequence_pool", {"X": _x(1), "Lengths": LENGTHS},
           attrs={"pool_type": p}, grad=["X"], name=f"sequence_pool_{p}")
    for p in ("average", "sum", "sqrt", "max", "last", "first")
] + [
    OpCase("sequence_softmax", {"X": _x(2, (B, T)), "Lengths": LENGTHS},
           grad=["X"]),
    OpCase("sequence_reverse", {"X": _x(3), "Lengths": LENGTHS},
           grad=["X"]),
    OpCase("sequence_expand_as", {"X": _x(4, (B, D)), "Lengths": LENGTHS},
           attrs={"maxlen": T}, grad=["X"]),
] + [
    OpCase("write_to_array", {"Array": _x(5, (4, 2, 3)),
                              "X": _x(6, (2, 3)),
                              "I": np.array([i], "int64")},
           grad=["Array", "X"], name=f"write_to_array_at_{i}")
    for i in (1, 3, 9, -1, -6)
] + [
    OpCase("read_from_array", {"Array": _x(7, (4, 2, 3)),
                               "I": np.array([i], "int64")},
           grad=["Array"], name=f"read_from_array_at_{i}")
    for i in (0, 2, 9, -1, -6)
] + [
    OpCase("lstm_rnn", {"X": _x(8, (3, 5, 4)) - 0.5,
                        "W": (R(9).randn(4 + 6, 24) * 0.3).astype(
                            "float32"),
                        "B": (R(10).randn(24) * 0.1).astype("float32"),
                        "Lengths": np.array([5, 2, 4], "int64")},
           outputs={"Out": 1, "LastH": 1, "LastC": 1},
           attrs={"hidden_size": 6}, grad=["X", "W", "B"], **RNN_TOL),
    OpCase("gru_rnn", {"X": _x(11, (3, 5, 4)) - 0.5,
                       "W": (R(12).randn(4 + 6, 18) * 0.3).astype(
                           "float32"),
                       "B": (R(13).randn(18) * 0.1).astype("float32"),
                       "Lengths": np.array([5, 2, 4], "int64")},
           outputs={"Out": 1, "LastH": 1}, attrs={"hidden_size": 6},
           grad=["X", "W", "B"], **RNN_TOL),
    OpCase("sequence_conv", {"X": _x(14, (3, 5, 4)),
                             "Filter": _x(15, (12, 5)) - 0.5,
                             "Lengths": np.array([5, 2, 4], "int64")},
           attrs={"context_start": -1, "context_length": 3},
           grad=["X", "Filter"]),
    OpCase("sequence_expand", {"X": _x(16, (3, 2, 4)),
                               "Y": _x(17, (3, 5, 4)),
                               "YLengths": np.array([5, 2, 4], "int64")},
           grad=["X"]),
    OpCase("sequence_pad", {"X": _x(18, (3, 5, 4)),
                            "Lengths": np.array([5, 2, 4], "int64"),
                            "PadValue": np.array([-2.5], "float32")},
           outputs={"Out": 1, "Length": 1}, grad=["X"]),
    OpCase("sequence_unpad", {"X": _x(19, (3, 5, 4)),
                              "Lengths": np.array([5, 2, 4], "int64")},
           grad=["X"]),
    OpCase("sequence_concat", {"X": [_x(20, (3, 4, 2)), _x(21, (3, 3, 2))],
                               "Lengths": [np.array([4, 1, 2], "int64"),
                                           np.array([2, 3, 0], "int64")]},
           grad=["X"]),
    OpCase("sequence_slice", {"X": _x(22, (3, 6, 2)),
                              "Offset": np.array([[0], [2], [5]], "int64"),
                              "Length": np.array([[3], [4], [1]], "int64")},
           grad=["X"]),
    OpCase("sequence_erase", {"X": R(23).randint(0, 7, (3, 6)).astype(
        "int64"), "Lengths": np.array([6, 4, 2], "int64")},
        outputs={"Out": 1, "OutLengths": 1}, attrs={"tokens": [2, 5]}),
    OpCase("sequence_enumerate", {"X": R(24).randint(1, 9, (3, 5)).astype(
        "int64"), "Lengths": np.array([5, 3, 1], "int64")},
        attrs={"win_size": 3, "pad_value": 0}),
]


def test_every_sequence_op_has_a_case():
    ops = {c.op_type for c in CASES}
    assert len(ops) == 17, sorted(ops)
    from paddle_tpu_torch.ops import registry
    assert all(registry.has_op(o) for o in ops)


@pytest.mark.parametrize("case", CASES, ids=[c.name for c in CASES])
def test_op_case_follows_jax(case):
    check_case(case)


@pytest.mark.parametrize("i,slot", [(9, 3), (-1, 3), (-6, 0), (2, 2)])
def test_tensor_array_index_is_clamped_as_lax_does(i, slot):
    arr = _x(25, (4, 2, 3))
    case = OpCase("read_from_array", {"Array": arr,
                                      "I": np.array([i], "int64")})
    _, got, _ = run_both(case)
    np.testing.assert_array_equal(got[0], arr[slot])
    x = _x(26, (2, 3))
    case = OpCase("write_to_array", {"Array": arr, "X": x,
                                     "I": np.array([i], "int64")})
    _, got, _ = run_both(case)
    want = arr.copy()
    want[slot] = x
    np.testing.assert_array_equal(got[0], want)


def test_recurrences_past_a_rows_end_repeat_the_frozen_state():
    """lstm_rnn / gru_rnn emit the frozen carry past a row's length (the
    fused lstm / gru / rnn ops emit zeros there)."""
    for case in CASES:
        if case.op_type not in ("lstm_rnn", "gru_rnn"):
            continue
        _, got, names = run_both(case)
        out, last_h = got[0], got[1]
        for b, n in enumerate(case.inputs["Lengths"]):
            np.testing.assert_array_equal(out[b, n - 1:],
                                          np.broadcast_to(
                                              last_h[b], out[b, n - 1:].shape))


# ---------------------------------------------------------------------------
# twins of tests/test_sequence.py
# ---------------------------------------------------------------------------

def _build(pkg, fn):
    """(main, startup, outputs) of `fn(pkg.layers)` in `pkg`, names and
    op seeds from 0."""
    if pkg is jpt:
        j_reset_names()
        j_reset_seed()
    else:
        tpt.reset_unique_name()
        t_reset_seed()
    main, startup = pkg.Program(), pkg.Program()
    startup._is_startup = True
    main.random_seed = startup.random_seed = 3
    with pkg.program_guard(main, startup):
        outs = fn(pkg)
    return main, startup, outs


def _both(fn, feeds, fetch_key="out"):
    """Run the program `fn` builds in both packages: the JAX one from its
    startup, the port's from the JAX startup values; each feed's fetches
    of outs[fetch_key] (a list of vars) from both.  Returns (JAX fetches,
    port fetches, the port's program, executor, scope, outputs)."""
    jm, js, jo = _build(jpt, fn)
    tm, ts, to = _build(tpt, fn)
    j_scope, j_exe = jpt.Scope(), jpt.Executor()
    j_exe.run(js, scope=j_scope)
    names = [v.name for v in jm.list_vars() if v.persistable]
    t_scope = scope_from_arrays(
        {n: np.asarray(j_scope.find_var(n)) for n in names}, "cpu", tm)
    t_exe = tpt.Executor(tpt.CPUPlace())
    want, got = [], []
    for feed in feeds:
        want.append([np.asarray(v) for v in j_exe.run(
            jm, feed=feed, fetch_list=jo[fetch_key], scope=j_scope)])
        got.append([np.asarray(v) for v in t_exe.run(
            tm, feed=feed, fetch_list=to[fetch_key], scope=t_scope)])
    return want, got, tm, t_exe, t_scope, to


def _mask():
    return np.arange(T)[None, :] < LENGTHS[:, None]


def test_pad_sequences():
    ragged = [np.ones((2, 3)), np.ones((5, 3)) * 2]
    dense, lengths = tpt.layers.pad_sequences(ragged, dtype="float32")
    j_dense, j_lengths = jpt.layers.pad_sequences(ragged, dtype="float32")
    np.testing.assert_array_equal(dense, j_dense)
    np.testing.assert_array_equal(lengths, j_lengths)
    assert dense.shape == (2, 5, 3) and dense.dtype == np.float32
    assert dense[0, 2:].sum() == 0 and dense[1].min() == 2


def test_sequence_mask_layer():
    def fn(pkg):
        ln = pkg.layers.data("ln", [B], dtype="int64",
                             append_batch_size=False)
        return {"out": [pkg.layers.sequence_mask(ln, maxlen=T)]}

    want, got, *_ = _both(fn, [{"ln": LENGTHS}])
    np.testing.assert_array_equal(got[0][0], want[0][0])
    np.testing.assert_array_equal(got[0][0], _mask().astype("float32"))


@pytest.mark.parametrize("pool", ["average", "sum", "max", "last",
                                  "first", "sqrt"])
def test_sequence_pool_layer(pool):
    xv = _x()

    def fn(pkg):
        x = pkg.layers.data("x", [B, T, D], append_batch_size=False)
        ln = pkg.layers.data("ln", [B], dtype="int64",
                             append_batch_size=False)
        return {"out": [pkg.layers.sequence_pool(x, pool, lengths=ln)]}

    want, got, *_ = _both(fn, [{"x": xv, "ln": LENGTHS}])
    m = _mask()[..., None]
    ref = {"average": lambda: (xv * m).sum(1) / LENGTHS[:, None],
           "sum": lambda: (xv * m).sum(1),
           "sqrt": lambda: (xv * m).sum(1) / np.sqrt(LENGTHS[:, None]),
           "max": lambda: np.where(m, xv, -np.inf).max(1),
           "last": lambda: xv[np.arange(B), LENGTHS - 1],
           "first": lambda: xv[:, 0]}[pool]()
    np.testing.assert_allclose(got[0][0], want[0][0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[0][0], ref, rtol=1e-5, atol=1e-6)


def test_sequence_softmax_masks_padding():
    xv = R(1).rand(B, T).astype("float32")

    def fn(pkg):
        x = pkg.layers.data("x", [B, T], append_batch_size=False)
        ln = pkg.layers.data("ln", [B], dtype="int64",
                             append_batch_size=False)
        return {"out": [pkg.layers.sequence_softmax(x, lengths=ln)]}

    want, got, *_ = _both(fn, [{"x": xv, "ln": LENGTHS}])
    out = got[0][0]
    np.testing.assert_allclose(out, want[0][0], rtol=1e-5, atol=1e-6)
    assert np.all(out[~_mask()] == 0)
    np.testing.assert_allclose(out.sum(1), np.ones(B), rtol=1e-5)
    np.testing.assert_allclose(out[2, 0], 1.0, rtol=1e-5)


def test_sequence_reverse_layer():
    xv = _x(2)

    def fn(pkg):
        x = pkg.layers.data("x", [B, T, D], append_batch_size=False)
        ln = pkg.layers.data("ln", [B], dtype="int64",
                             append_batch_size=False)
        return {"out": [pkg.layers.sequence_reverse(x, lengths=ln)]}

    want, got, *_ = _both(fn, [{"x": xv, "ln": LENGTHS}])
    out = got[0][0]
    np.testing.assert_array_equal(out, want[0][0])
    for b in range(B):
        n = LENGTHS[b]
        np.testing.assert_array_equal(out[b, :n], xv[b, :n][::-1])
        np.testing.assert_array_equal(out[b, n:], xv[b, n:])


def test_tensor_array_write_read_length_and_grad():
    def fn(pkg):
        L = pkg.layers
        x = L.data("x", [D])
        arr = L.create_array("float32", [2, D], capacity=4)
        i0 = L.fill_constant([1], "int64", 0)
        i1 = L.fill_constant([1], "int64", 1)
        w = L.create_parameter([D], "float32", name="ta_w",
                               default_initializer=None) \
            if pkg is jpt else pkg.framework.layer_helper.LayerHelper(
                "create_parameter").create_parameter(
                    pkg.ParamAttr(name="ta_w"), [D], "float32")
        arr = L.array_write(L.elementwise_mul(x, w), i0, array=arr)
        arr = L.array_write(L.scale(x, 2.0), i1, array=arr)
        ln = L.array_length(arr)
        r0 = L.array_read(arr, i0)
        r1 = L.array_read(arr, i1)
        loss = L.mean(L.elementwise_add(r0, r1))
        pkg.optimizer.SGDOptimizer(0.1).minimize(loss)
        return {"out": [loss, ln]}

    xv = np.ones((2, D), "float32")
    want, got, *_ = _both(fn, [{"x": xv}] * 3)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g[0], w[0], rtol=1e-5)
        assert int(np.ravel(g[1])[0]) == int(np.ravel(w[1])[0]) == 2
    losses = [float(np.ravel(g[0])[0]) for g in got]
    assert losses[1] < losses[0]  # grads flowed through the write


def _classifier(kind):
    def fn(pkg):
        L = pkg.layers
        x = L.data("x", [8, T, D], append_batch_size=False)
        ln = L.data("ln", [8], dtype="int64", append_batch_size=False)
        y = L.data("y", [8, 1], dtype="int64", append_batch_size=False)
        if kind == "lstm":
            _, last_h, _ = L.lstm(x, hidden_size=16, lengths=ln)
        else:
            _, last_h = L.gru(x, hidden_size=12, lengths=ln)
        loss = L.mean(L.softmax_with_cross_entropy(L.fc(last_h, 2), y))
        pkg.optimizer.AdamOptimizer(1e-2).minimize(loss)
        return {"out": [loss], "last_h": [last_h]}
    return fn


def _classifier_feed(kind):
    rng = R(0 if kind == "lstm" else 1)
    xv = rng.rand(8, T, D).astype("float32")
    if kind == "lstm":
        lens = rng.randint(1, T + 1, (8,)).astype("int64")
        m = np.arange(T)[None, :] < lens[:, None]
        s = (xv * m[..., None]).sum((1, 2)) / lens
    else:
        lens = np.full((8,), T, "int64")
        s = xv.sum((1, 2))
    yv = (s > np.median(s)).astype("int64")[:, None]
    return {"x": xv, "ln": lens, "y": yv}


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_recurrent_classifier_trains_as_the_jax_package(kind):
    """3 steps against the JAX package (loss rtol 1e-4), then the
    reference's own bar: the loss falls below 0.3 (LSTM) / 0.5 (GRU) of
    its first in 40 steps; the LSTM's last state ignores padding."""
    feed = _classifier_feed(kind)
    want, got, tm, exe, scope, to = _both(_classifier(kind), [feed] * 3)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g[0], w[0], rtol=1e-4)
    losses = [float(np.ravel(g[0])[0]) for g in got]
    for _ in range(37):
        losses.append(float(np.ravel(exe.run(
            tm, feed=feed, fetch_list=to["out"], scope=scope)[0])[0]))
    assert losses[-1] < (0.3 if kind == "lstm" else 0.5) * losses[0], \
        (losses[0], losses[-1])
    if kind != "lstm":
        return
    test_prog = tm.clone(for_test=True)
    h_ref = exe.run(test_prog, feed=feed, fetch_list=to["last_h"],
                    scope=scope)[0]
    m = np.arange(T)[None, :] < feed["ln"][:, None]
    x2 = feed["x"].copy()
    x2[~m] = 99.0
    h_got = exe.run(test_prog, feed=dict(feed, x=x2),
                    fetch_list=to["last_h"], scope=scope)[0]
    np.testing.assert_allclose(h_got, h_ref, rtol=1e-5, atol=1e-6)


def test_book_understand_sentiment_lstm():
    """tests/test_book.py's stacked-LSTM sentiment model: 3 steps within
    rtol 1e-4 of the JAX package, then its bar (the loss below 0.3 of its
    first after 50 steps)."""
    rng = R(0)
    V, Bn, Tn = 50, 16, 12
    GOOD, BAD = 7, 13
    xv = rng.randint(0, V, (Bn, Tn)).astype("int64")
    half = Bn // 2
    xv[:half, rng.randint(0, Tn)] = GOOD
    xv[half:, rng.randint(0, Tn)] = BAD
    xv[:half][xv[:half] == BAD] = 0
    xv[half:][xv[half:] == GOOD] = 0
    yv = np.array([[1]] * half + [[0]] * half, "int64")
    feed = {"words": xv, "ln": np.full((Bn,), Tn, "int64"), "label": yv}

    def fn(pkg):
        L = pkg.layers
        words = L.data("words", [Bn, Tn], dtype="int64",
                       append_batch_size=False)
        ln = L.data("ln", [Bn], dtype="int64", append_batch_size=False)
        label = L.data("label", [Bn, 1], dtype="int64",
                       append_batch_size=False)
        emb = L.embedding(words, size=[V, 32])
        out1, h1, _ = L.lstm(emb, 32, lengths=ln)
        out2, h2, _ = L.lstm(out1, 32, lengths=ln)
        logits = L.fc(L.concat([h1, h2], axis=1), size=2)
        loss = L.mean(L.softmax_with_cross_entropy(logits, label))
        pkg.optimizer.AdamOptimizer(5e-3).minimize(loss)
        return {"out": [loss]}

    want, got, tm, exe, scope, to = _both(fn, [feed] * 3)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g[0], w[0], rtol=1e-4)
    losses = [float(np.ravel(g[0])[0]) for g in got]
    for _ in range(47):
        losses.append(float(np.ravel(exe.run(
            tm, feed=feed, fetch_list=to["out"], scope=scope)[0])[0]))
    assert losses[-1] < 0.3 * losses[0], (losses[0], losses[-1])


# ---------------------------------------------------------------------------
# forward-only sums over time keep a row's bits whatever its batch
# ---------------------------------------------------------------------------

def test_served_time_sums_are_row_independent():
    """sequence_pool (sum, average) and reduce_sum over the time axis of
    [B, S, H] in an is_test program: each row of a batch of 5 equals that
    row served alone, bit for bit (ops/math_ops.py ordered_sum)."""
    S, H = 50, 1024
    rng = R(27)
    xv = rng.randn(5, S, H).astype("float32")
    lens = np.array([50, 17, 1, 33, 49], "int64")

    def build(batch):
        tpt.reset_unique_name()
        main, startup = tpt.Program(), tpt.Program()
        with tpt.program_guard(main, startup):
            L = tpt.layers
            x = L.data("x", [batch, S, H], append_batch_size=False)
            ln = L.data("ln", [batch], dtype="int64",
                        append_batch_size=False)
            outs = [L.sequence_pool(x, "sum", lengths=ln),
                    L.sequence_pool(x, "average", lengths=ln),
                    L.reduce_sum(x, dim=1)]
        return main, outs

    exe = tpt.Executor(tpt.CPUPlace())
    main, outs = build(5)
    whole = exe.run(main, feed={"x": xv, "ln": lens}, fetch_list=outs)
    one, one_outs = build(1)
    for r in range(5):
        alone = exe.run(one, feed={"x": xv[r:r + 1], "ln": lens[r:r + 1]},
                        fetch_list=one_outs)
        for w, a in zip(whole, alone):
            assert np.array_equal(np.asarray(w)[r:r + 1], np.asarray(a)), r
    np.testing.assert_allclose(whole[2], xv.sum(1), rtol=1e-5, atol=1e-4)
