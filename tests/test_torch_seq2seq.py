"""The attention seq2seq (``models/seq2seq.py``) in the port against the
JAX package, on the CPU, at small widths (embedding and hidden 16,
vocabularies 30 and 25, batch 4, source 7 and target 8 steps, ragged
lengths, Adam 1e-3 with a global-norm clip of 5.0 as the card's phase
trains it).

* Both programs, main and startup, serialise JSON-equal to the JAX
  package's.
* ``interop.scope_from_arrays`` carries one JAX scope into a port scope
  for both programs (they share parameters by name), and refuses a name
  the programs declare two ways.
* 3 fp32 steps from the copied scope: every loss within rtol 1e-5, the
  step-1 grads within rtol 1e-4 / atol 1e-6, every persistable within
  rtol 1e-4 / atol 1e-5 after the last step (fifty products a step,
  summed in other orders by XLA and by PyTorch).
* Beam decode (beam 3, 9 steps) on weights the JAX package trained 30
  steps: the port's ids and lengths equal the JAX package's, its scores
  within 1e-5.
* Batched = single at tolerance 0: each sentence of a batch of 4
  decoded alone (a batch-1 program on the same scope) gives the same
  ids, scores and lengths, bit for bit.
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

CFG = dict(emb_dim=16, hidden=16)
SRC_V, TRG_V, B, S, T = 30, 25, 4, 7, 8
BEAM, MAX_LEN, BOS, EOS = 3, 9, 0, 1
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
STATE_RTOL, STATE_ATOL = 1e-4, 1e-5
SCORE_ATOL = 1e-5


def _models(pkg):
    return __import__(f"{pkg.__name__}.models.seq2seq",
                      fromlist=["build_seq2seq_train"])


def _reset(pkg):
    if pkg is jpt:
        j_reset_names()
        j_reset_seed()
    else:
        tpt.reset_unique_name()
        t_reset_seed()


def _programs(pkg, batch=B):
    """(train, startup, loss, infer, infer startup, decode outputs)."""
    m = _models(pkg)
    _reset(pkg)
    train, startup = pkg.Program(), pkg.Program()
    startup._is_startup = True
    main_seed = 11
    train.random_seed = startup.random_seed = main_seed
    with pkg.program_guard(train, startup):
        _, outs = m.build_seq2seq_train(B, S, T, SRC_V, TRG_V, **CFG)
        pkg.optimizer.AdamOptimizer(
            1e-3, grad_clip=pkg.clip.GradientClipByGlobalNorm(5.0)
        ).minimize(outs["loss"])
    infer, infer_startup = pkg.Program(), pkg.Program()
    infer_startup._is_startup = True
    with pkg.program_guard(infer, infer_startup):
        _, iouts = m.build_seq2seq_infer(batch, S, SRC_V, TRG_V, **CFG,
                                         beam_size=BEAM, max_len=MAX_LEN,
                                         bos_id=BOS, eos_id=EOS)
    return train, startup, outs["loss"], infer, infer_startup, iouts


def _feeds(n, seed=3, batch=B):
    """Copy-and-reverse pairs of ragged lengths: the target is the source
    reversed, then EOS."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        src_len = rng.randint(2, S + 1, batch)
        src = rng.randint(2, SRC_V, (batch, S)).astype("int64")
        src_mask = (np.arange(S)[None] < src_len[:, None]).astype("float32")
        src = np.where(src_mask > 0, src, 0).astype("int64")
        trg_out = np.full((batch, T), EOS, "int64")
        trg_mask = np.zeros((batch, T), "float32")
        for b, n_b in enumerate(src_len):
            seq = src[b, :n_b][::-1] % TRG_V
            trg_out[b, :n_b] = np.maximum(seq, 2)
            trg_mask[b, :n_b + 1] = 1.0
        trg_in = np.concatenate([np.full((batch, 1), BOS, "int64"),
                                 trg_out[:, :-1]], 1)
        out.append({"src_ids": src, "src_mask": src_mask, "trg_in": trg_in,
                    "trg_out": trg_out, "trg_mask": trg_mask})
    return out


def test_programs_are_json_equal_to_the_jax_packages():
    j = _programs(jpt)
    t = _programs(tpt)
    for a, b in zip((j[0], j[1], j[3], j[4]), (t[0], t[1], t[3], t[4])):
        assert json.loads(j_to_json(a)) == json.loads(t_to_json(b))
    types = [op.type for op in t[3].global_block().ops]
    assert types.count("beam_search") == MAX_LEN
    assert types.count("gru_rnn") == 2 and types.count("log_softmax") == \
        MAX_LEN


def _jax_scope(train, startup):
    scope, exe = jpt.Scope(), jpt.Executor()
    exe.run(startup, scope=scope)
    return scope, exe


def _arrays(scope, program):
    return {v.name: np.asarray(scope.find_var(v.name))
            for v in program.list_vars() if v.persistable}


def test_scope_from_arrays_carries_both_programs():
    jt, js, _, ji, _, _ = _programs(jpt)
    tt, _, _, ti, _, _ = _programs(tpt)
    j_scope, _ = _jax_scope(jt, js)
    arrays = _arrays(j_scope, jt)
    scope = scope_from_arrays(arrays, "cpu", [tt, ti])
    infer_params = {v.name for v in ti.list_vars() if v.persistable}
    assert infer_params and infer_params <= set(arrays)
    assert set(scope.local_var_names()) == set(arrays)
    with pytest.raises(ValueError, match="missing"):
        scope_from_arrays(arrays, "cpu", ti)
    bad = tpt.Program()
    with tpt.program_guard(bad, tpt.Program()):
        tpt.layers.create_global_var([3], 0.0, "float32", persistable=True,
                                     name="s2s.out_b")
    with pytest.raises(ValueError, match="s2s.out_b"):
        scope_from_arrays(arrays, "cpu", [tt, bad])


def test_training_follows_the_jax_package():
    jt, js, jl, _, _, _ = _programs(jpt)
    tt, _, tl, ti, _, _ = _programs(tpt)
    j_scope, j_exe = _jax_scope(jt, js)
    t_scope = scope_from_arrays(_arrays(j_scope, jt), "cpu", [tt, ti])
    t_exe = tpt.Executor(tpt.CPUPlace())
    params = [p.name for p in tt.all_parameters()]
    grads = [p + "@GRAD" for p in params]
    for step, feed in enumerate(_feeds(3)):
        fetch = [jl.name] + (grads if step == 0 else [])
        want = j_exe.run(jt, feed=feed, fetch_list=fetch, scope=j_scope)
        got = t_exe.run(tt, feed=feed, fetch_list=fetch, scope=t_scope)
        np.testing.assert_allclose(got[0], np.asarray(want[0]),
                                   rtol=LOSS_RTOL)
        for name, g, w in zip(fetch[1:], got[1:], want[1:]):
            np.testing.assert_allclose(g, np.asarray(w), rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL, err_msg=name)
    for name, w in _arrays(j_scope, jt).items():
        np.testing.assert_allclose(t_scope.find_var(name).numpy(), w,
                                   rtol=STATE_RTOL, atol=STATE_ATOL,
                                   err_msg=name)


@pytest.fixture(scope="module")
def trained():
    """The JAX package's seq2seq after 30 steps, its scope's arrays."""
    jt, js, jl, _, _, _ = _programs(jpt)
    j_scope, j_exe = _jax_scope(jt, js)
    for feed in _feeds(30, seed=4):
        j_exe.run(jt, feed=feed, fetch_list=[jl], scope=j_scope)
    return j_scope, _arrays(j_scope, jt)


def _decode(exe, infer, outs, scope, feed):
    return [np.asarray(v) for v in exe.run(
        infer, feed=feed, fetch_list=[outs[k] for k in
                                      ("ids", "scores", "lengths")],
        scope=scope)]


def test_beam_decode_follows_the_jax_package(trained):
    j_scope, arrays = trained
    _, _, _, ji, _, jio = _programs(jpt)
    tt, _, _, ti, _, tio = _programs(tpt)
    feed = {k: _feeds(1, seed=5)[0][k] for k in ("src_ids", "src_mask")}
    want = _decode(jpt.Executor(), ji, jio, j_scope, feed)
    got = _decode(tpt.Executor(tpt.CPUPlace()), ti, tio,
                  scope_from_arrays(arrays, "cpu", [tt, ti]), feed)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=SCORE_ATOL)
    np.testing.assert_array_equal(got[2], want[2])
    ids, scores, lengths = got
    assert ids.shape == (B, BEAM, MAX_LEN)
    for b in range(B):
        for k in range(BEAM):
            assert (ids[b, k, lengths[b, k]:] == EOS).all()


def test_batched_decode_equals_each_sentence_alone(trained):
    _, arrays = trained
    tt, _, _, ti, _, tio = _programs(tpt)
    _, _, _, one, _, one_outs = _programs(tpt, batch=1)
    scope = scope_from_arrays(arrays, "cpu", [tt, ti, one])
    exe = tpt.Executor(tpt.CPUPlace())
    feed = {k: _feeds(1, seed=6)[0][k] for k in ("src_ids", "src_mask")}
    whole = _decode(exe, ti, tio, scope, feed)
    for r in range(B):
        alone = _decode(exe, one, one_outs, scope,
                        {k: v[r:r + 1] for k, v in feed.items()})
        for w, a in zip(whole, alone):
            assert w[r:r + 1].tobytes() == a.tobytes(), r
