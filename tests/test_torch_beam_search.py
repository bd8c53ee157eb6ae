"""The beam-search stack in the port (``ops/beam_ops.py``,
``layers/rnn.py``, ``models/seq2seq.py``) against the JAX package, on
the CPU.

* Twins of tests/test_beam_search.py: ``gather_tree`` against the
  reference's scalar backtrack, the finished-hypothesis semantics of one
  ``beam_search`` step, ``beam_search_decode``'s end padding and
  lengths, cell-based ``rnn()`` training (GRUCell and LSTMCell: 3 steps
  within rtol 1e-4 of the JAX package, then the reference's bar), and the
  book's machine-translation model trained 150 steps and beam-decoded in
  both packages.
* ``beam_search`` breaks ties as ``lax.top_k`` does (lower index first):
  a beam wider than the vocabulary (K > V), dead beams at -1e9 whose
  candidates all round back to -1e9, finished hypotheses; ids and
  parents exactly equal to the JAX package's, scores within 1e-6.
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
from torch_op_util import check_case

BOS, EOS = 0, 1
R = np.random.RandomState


def _reset(pkg):
    if pkg is jpt:
        j_reset_names()
        j_reset_seed()
    else:
        tpt.reset_unique_name()
        t_reset_seed()


def _run_one(pkg, fn, feed):
    """Build `fn(pkg.layers)` (it returns its fetch list) in `pkg` and run
    it once on the CPU."""
    _reset(pkg)
    main, startup = pkg.Program(), pkg.Program()
    startup._is_startup = True
    with pkg.program_guard(main, startup):
        fetch = fn(pkg.layers)
    exe = pkg.Executor(pkg.CPUPlace()) if pkg is tpt else pkg.Executor()
    exe.run(startup)
    return [np.asarray(v) for v in exe.run(main, feed=feed,
                                           fetch_list=fetch)]


def _both(fn, feed):
    return _run_one(jpt, fn, feed), _run_one(tpt, fn, feed)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

def test_gather_tree_matches_reference_loop():
    T, B, K = 5, 2, 3
    rng = R(0)
    ids = rng.randint(0, 9, (T, B, K)).astype("int64")
    parents = rng.randint(0, K, (T, B, K)).astype("int64")
    want = np.zeros_like(ids)
    for b in range(B):
        for k in range(K):
            want[T - 1, b, k] = ids[T - 1, b, k]
            parent = parents[T - 1, b, k]
            for t in range(T - 2, -1, -1):
                want[t, b, k] = ids[t, b, parent]
                parent = parents[t, b, parent]

    def fn(L):
        i = L.data("ids", [T, B, K], dtype="int64", append_batch_size=False)
        p = L.data("par", [T, B, K], dtype="int64", append_batch_size=False)
        return [L.gather_tree(i, p)]

    j, t = _both(fn, {"ids": ids, "par": parents})
    np.testing.assert_array_equal(t[0], want)
    np.testing.assert_array_equal(t[0], j[0])


def test_beam_search_step_finished_semantics():
    B, K, W = 1, 2, 3
    end_id = 7
    feed = {"pi": np.array([[4, end_id]], "int64"),
            "ps": np.array([[-1.0, -0.5]], "float32"),
            "ci": np.tile(np.array([1, 2, 3], "int64"), (B, K, 1)),
            "cs": np.array([[[-1.2, -1.5, -3.0], [-0.9, -2.0, -2.5]]],
                           "float32")}

    def fn(L):
        pi = L.data("pi", [B, K], dtype="int64", append_batch_size=False)
        ps = L.data("ps", [B, K], append_batch_size=False)
        ci = L.data("ci", [B, K, W], dtype="int64", append_batch_size=False)
        cs = L.data("cs", [B, K, W], append_batch_size=False)
        return list(L.beam_search(pi, ps, ci, cs, beam_size=K,
                                  end_id=end_id))

    j, (si, sc, pr) = _both(fn, feed)
    assert si.tolist() == [[end_id, 1]]
    assert pr.tolist() == [[1, 0]]
    np.testing.assert_allclose(sc, [[-0.5, -1.2]], atol=1e-6)
    for a, b in zip(j, (si, sc, pr)):
        np.testing.assert_array_equal(a.astype(b.dtype), b)


def test_beam_search_decode_padding_and_lengths():
    T, B, K = 4, 1, 2
    end_id = 9
    ids = np.array([[[3, 4]], [[end_id, 5]], [[6, 6]], [[7, 7]]], "int64")
    parents = np.zeros((T, B, K), "int64")
    parents[:, :, 1] = 1
    feed = {"ids": ids, "par": parents,
            "sc": np.array([[-0.3, -0.9]], "float32")}

    def fn(L):
        i = L.data("ids", [T, B, K], dtype="int64", append_batch_size=False)
        p = L.data("par", [T, B, K], dtype="int64", append_batch_size=False)
        s = L.data("sc", [B, K], append_batch_size=False)
        return list(L.beam_search_decode(i, p, s, end_id=end_id))

    j, (sv, scv, lnv) = _both(fn, feed)
    assert sv.shape == (B, K, T)
    assert lnv[0, 0] == 2 and lnv[0, 1] == T
    assert (sv[0, 0, 2:] == end_id).all()
    assert sv[0, 0, 0] == 3 and sv[0, 0, 1] == end_id
    for a, b in zip(j, (sv, scv, lnv)):
        np.testing.assert_array_equal(a.astype(b.dtype), b)


def _tie_case(with_ids, name):
    """Beam 4 over 3 candidates a hypothesis (K > V): the first step's
    dead beams at -1e9 (their candidates round back to -1e9 exactly),
    equal live scores, and a finished hypothesis in the second row."""
    B, K, W = 2, 4, 3
    pre_ids = np.array([[BOS] * K, [5, EOS, 6, EOS]], "int64")
    pre_scores = np.array([[0.0, -1e9, -1e9, -1e9],
                           [-1.0, -0.5, -2.0, -0.5]], "float32")
    step = np.array([[-2.0, -2.0, -3.5], [-2.0, -1.0, -1.0],
                     [-0.25, -2.0, -2.0], [-9.0, -9.0, -1.0]], "float32")
    scores = (pre_scores[:, :, None] + step[None]).astype("float32")
    inputs = {"PreIds": pre_ids, "PreScores": pre_scores, "Scores": scores}
    if with_ids:
        inputs["Ids"] = np.tile(np.array([4, 2, 3], "int64"), (B, K, 1))
    return OpCase("beam_search", inputs,
                  outputs={"SelectedIds": 1, "SelectedScores": 1,
                           "ParentIdx": 1},
                  attrs={"beam_size": K, "end_id": EOS}, name=name)


@pytest.mark.parametrize("with_ids", [False, True])
def test_beam_search_ties_follow_lax_top_k(with_ids):
    case = _tie_case(with_ids, f"beam_search_ties_ids_{with_ids}")
    got = check_case(case)
    # first row: beam 0's three candidates, then the dead beams' tie at
    # -1e9 broken by the lower flat index (beam 1, slot 0)
    assert np.asarray(got[2])[0].tolist() == [0, 0, 0, 1]
    assert np.asarray(got[1])[0, 3] == np.float32(-1e9)


# ---------------------------------------------------------------------------
# cells + rnn()
# ---------------------------------------------------------------------------

def _cells_program(pkg, Bn, Tn, Dn, Hn):
    _reset(pkg)
    main, startup = pkg.Program(), pkg.Program()
    startup._is_startup = True
    L = pkg.layers
    with pkg.program_guard(main, startup):
        x = L.data("x", [Bn, Tn, Dn], append_batch_size=False)
        y = L.data("y", [Bn, 1], dtype="int64", append_batch_size=False)
        out_g, _ = L.rnn(L.GRUCell(Hn), x)
        out_l, (h, c) = L.rnn(L.LSTMCell(Hn), x)
        feat = L.concat(
            [L.squeeze(L.slice(out_g, axes=[1], starts=[Tn - 1],
                               ends=[Tn]), [1]), h], axis=1)
        loss = L.mean(L.softmax_with_cross_entropy(L.fc(feat, 2), y))
        pkg.optimizer.AdamOptimizer(1e-2).minimize(loss)
    return main, startup, loss


def test_gru_lstm_cells_train():
    Bn, Tn, Dn, Hn = 8, 5, 6, 12
    rng = R(0)
    xv = rng.rand(Bn, Tn, Dn).astype("float32")
    yv = (xv.sum((1, 2)) > np.median(xv.sum((1, 2)))).astype(
        "int64")[:, None]
    feed = {"x": xv, "y": yv}
    jm, js, jl = _cells_program(jpt, Bn, Tn, Dn, Hn)
    tm, ts, tl = _cells_program(tpt, Bn, Tn, Dn, Hn)
    j_scope, j_exe = jpt.Scope(), jpt.Executor()
    j_exe.run(js, scope=j_scope)
    names = [v.name for v in jm.list_vars() if v.persistable]
    t_scope = scope_from_arrays(
        {n: np.asarray(j_scope.find_var(n)) for n in names}, "cpu", tm)
    t_exe = tpt.Executor(tpt.CPUPlace())
    losses = []
    for step in range(40):
        got = float(np.ravel(t_exe.run(tm, feed=feed, fetch_list=[tl],
                                       scope=t_scope)[0])[0])
        if step < 3:
            want = float(np.ravel(j_exe.run(jm, feed=feed, fetch_list=[jl],
                                            scope=j_scope)[0])[0])
            np.testing.assert_allclose(got, want, rtol=1e-4)
        losses.append(got)
    assert losses[-1] < 0.5 * losses[0], (losses[0], losses[-1])


# ---------------------------------------------------------------------------
# the book's machine-translation model through both packages
# ---------------------------------------------------------------------------

V, BB, S = 12, 16, 5
TRG = S + 1


def _mt_programs(pkg):
    m = __import__(f"{pkg.__name__}.models.seq2seq",
                   fromlist=["build_seq2seq_train"])
    _reset(pkg)
    train, startup = pkg.Program(), pkg.Program()
    startup._is_startup = True
    with pkg.program_guard(train, startup):
        _, outs = m.build_seq2seq_train(BB, S, TRG, V, V, emb_dim=32,
                                        hidden=32)
        pkg.optimizer.AdamOptimizer(5e-3).minimize(outs["loss"])
    infer, infer_startup = pkg.Program(), pkg.Program()
    infer_startup._is_startup = True
    with pkg.program_guard(infer, infer_startup):
        _, iouts = m.build_seq2seq_infer(BB, S, V, V, emb_dim=32, hidden=32,
                                         beam_size=4, max_len=TRG + 2,
                                         bos_id=BOS, eos_id=EOS)
    return train, startup, outs, infer, iouts


def _mt_batches(n):
    rng = R(0)
    out = []
    for _ in range(n):
        content = rng.randint(2, V, (BB, S)).astype("int64")
        out.append({"src_ids": content,
                    "src_mask": np.ones((BB, S), "float32"),
                    "trg_in": np.concatenate(
                        [np.full((BB, 1), BOS, "int64"), content], 1),
                    "trg_out": np.concatenate(
                        [content, np.full((BB, 1), EOS, "int64")], 1),
                    "trg_mask": np.ones((BB, TRG), "float32")})
    return out


def _well_formed(ids, scores, lengths):
    K, Tmax = ids.shape[1], ids.shape[2]
    assert ids.shape == (BB, K, Tmax)
    assert (np.diff(scores, axis=1) <= 1e-5).all()
    for b in range(BB):
        for k in range(K):
            if lengths[b, k] < Tmax:
                assert (ids[b, k, lengths[b, k]:] == EOS).all()


def _exact_copies(ids, lengths, content):
    exact = 0
    for b in range(BB):
        hyp = ids[b, 0, :lengths[b, 0]]
        hyp = hyp[hyp != EOS]
        exact += int(len(hyp) == S and (hyp == content[b]).all())
    return exact


def test_machine_translation_book_model():
    """150 teacher-forced steps in each package from the JAX startup
    scope on the same batches (the first 3 losses within rtol 1e-4), each
    meets the reference's bars (the loss below 0.35 of its first, beam
    hypotheses well-formed, the top beam copies at least 70% of the
    sources); and the port's decode on the JAX package's trained weights
    gives the JAX decode's ids and lengths exactly, its scores within
    1e-4."""
    batches = _mt_batches(151)
    jt, js, jo, ji, jio = _mt_programs(jpt)
    tt, ts, to, ti, tio = _mt_programs(tpt)
    j_scope, j_exe = jpt.Scope(), jpt.Executor()
    j_exe.run(js, scope=j_scope)
    names = [v.name for v in jt.list_vars() if v.persistable]
    t_scope = scope_from_arrays(
        {n: np.asarray(j_scope.find_var(n)) for n in names}, "cpu",
        [tt, ti])
    t_exe = tpt.Executor(tpt.CPUPlace())
    jl, tl = [], []
    for i in range(150):
        jl.append(float(np.ravel(j_exe.run(
            jt, feed=batches[i], fetch_list=[jo["loss"]],
            scope=j_scope)[0])[0]))
        tl.append(float(np.ravel(t_exe.run(
            tt, feed=batches[i], fetch_list=[to["loss"]],
            scope=t_scope)[0])[0]))
        if i < 3:
            np.testing.assert_allclose(tl[i], jl[i], rtol=1e-4)
    for losses in (jl, tl):
        assert losses[-1] < 0.35 * losses[0], (losses[0], losses[-1])
    last = batches[150]
    feed = {"src_ids": last["src_ids"], "src_mask": last["src_mask"]}
    fetch = ["ids", "scores", "lengths"]
    want = [np.asarray(v) for v in j_exe.run(
        ji, feed=feed, fetch_list=[jio[k] for k in fetch], scope=j_scope)]
    got = [np.asarray(v) for v in t_exe.run(
        ti, feed=feed, fetch_list=[tio[k] for k in fetch], scope=t_scope)]
    for ids, scores, lengths in (want, got):
        _well_formed(ids, scores, lengths)
        assert _exact_copies(ids, lengths, last["src_ids"]) >= int(0.7 * BB)
    # the port's decode on the JAX package's trained weights
    carried = scope_from_arrays(
        {n: np.asarray(j_scope.find_var(n)) for n in names}, "cpu",
        [tt, ti])
    on_jax = [np.asarray(v) for v in t_exe.run(
        ti, feed=feed, fetch_list=[tio[k] for k in fetch], scope=carried)]
    np.testing.assert_array_equal(on_jax[0], want[0])
    np.testing.assert_allclose(on_jax[1], want[1], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(on_jax[2], want[2])


def test_assign_value_copies_its_constant_once_a_device():
    """The beam decoder's first scores come from ``assign_value``: its
    constant is copied from the host once a device (a captured step
    cannot copy from pageable host memory; tests/test_torch_seq2seq_cuda.py
    captures it on the card), each run gets a copy of its own, and the
    values are the JAX package's."""
    from paddle_tpu_torch.ops import tensor_ops

    row = np.array([[0.0, -1e9, -1e9]], "float32")

    def fn(L):
        x = L.data("x", [2, 3], append_batch_size=False)
        return [L.elementwise_add(x, L.assign(row))]

    tensor_ops._CONSTANTS.clear()
    feed = {"x": np.ones((2, 3), "float32")}
    j, t = _both(fn, feed)
    np.testing.assert_array_equal(t[0], j[0])
    assert len(tensor_ops._CONSTANTS) == 1
    again = _run_one(tpt, fn, feed)
    np.testing.assert_array_equal(again[0], t[0])
    assert len(tensor_ops._CONSTANTS) == 1
    (cached,) = tensor_ops._CONSTANTS.values()
    np.testing.assert_array_equal(cached.numpy(), row)
