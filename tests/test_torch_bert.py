"""BERT through both packages at a small size (2 layers, hidden 128,
2 heads so head_dim 64 takes the packed path, intermediate 256, vocab 97,
seq 32).

* The port builds the same program as paddle_tpu: same ops, attrs, var
  names and shapes, as JSON; its serde round-trips that JSON unchanged.
* The JAX startup scope, carried across with interop.scope_from_arrays,
  gives the same loss (rel 1e-5) and logits (atol 1e-4; fp32, 2 layers of
  differently ordered sums) through both Predictors.
* A model directory saved by paddle_tpu loads and answers in the port.
* With no CUDA, Predictor() without an explicit device raises.
* The other attention branches are in tests/test_torch_bert_branches.py.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu.framework.core import reset_unique_name as j_reset_names
from paddle_tpu.framework.serde import program_to_json as j_to_json
from paddle_tpu.models import build_bert_pretrain as j_build
from paddle_tpu.ops.registry import reset_op_seed as j_reset_seed
from paddle_tpu_torch.framework.serde import (program_from_json,
                                              program_to_json)
from paddle_tpu_torch.interop import scope_from_arrays
from paddle_tpu_torch.models import build_bert_pretrain as t_build
from paddle_tpu_torch.ops.registry import reset_op_seed as t_reset_seed

CFG = dict(seq_len=32, vocab_size=97, hidden=128, num_layers=2,
           num_heads=2, intermediate=256)
B = 4
LOSS_RTOL = 1e-5
LOGITS_ATOL = 1e-4


def _build(pkg, max_predictions=None):
    if pkg is jpt:
        j_reset_names()
        j_reset_seed()
        build = j_build
    else:
        tpt.reset_unique_name()
        t_reset_seed()
        build = t_build
    main, startup = pkg.Program(), pkg.Program()
    startup._is_startup = True
    kw = dict(CFG)
    if max_predictions is not None:
        kw.update(batch_size=B, max_predictions=max_predictions)
    with pkg.program_guard(main, startup):
        feeds, outs = build(is_test=True, **kw)
    logits = [op for op in main.global_block().ops
              if op.type == "softmax_with_cross_entropy"][0].input("Logits")[0]
    return main, startup, feeds, outs["loss"].name, logits


def _feed(max_predictions=None, seed=0):
    rng = np.random.RandomState(seed)
    S, V = CFG["seq_len"], CFG["vocab_size"]
    mask = np.ones((B, S), "float32")
    mask[1, 20:] = 0.0
    mask[3, 5:] = 0.0
    feed = {"input_ids": rng.randint(0, V, (B, S)).astype("int64"),
            "token_type_ids": (rng.rand(B, S) > 0.5).astype("int64"),
            "attn_mask": mask}
    if max_predictions is None:
        feed["mlm_mask"] = (rng.rand(B, S) < 0.3).astype("float32")
        feed["mlm_labels"] = rng.randint(0, V, (B, S)).astype("int64")
    else:
        P = max_predictions
        feed["mlm_positions"] = rng.randint(0, S, (B, P)).astype("int64")
        feed["mlm_labels"] = rng.randint(0, V, (B, P)).astype("int64")
        feed["mlm_weights"] = (rng.rand(B, P) > 0.2).astype("float32")
    return feed


HEADS = [None, 5]


@pytest.mark.parametrize("max_predictions", HEADS)
def test_port_builds_the_same_program(max_predictions):
    j_main, j_startup, j_feeds, j_loss, j_logits = _build(jpt,
                                                          max_predictions)
    t_main, t_startup, t_feeds, t_loss, t_logits = _build(tpt,
                                                          max_predictions)
    assert (t_feeds, t_loss, t_logits) == (j_feeds, j_loss, j_logits)
    for jp, tp in ((j_main, t_main), (j_startup, t_startup)):
        want = json.loads(j_to_json(jp))
        assert json.loads(program_to_json(tp)) == want
        # the port's serde reads the JAX package's JSON and writes it back
        # unchanged
        again = program_to_json(program_from_json(j_to_json(jp)))
        assert json.loads(again) == want


def _jax_scope(startup):
    scope = jpt.Scope()
    jpt.Executor().run(startup, scope=scope)
    return scope


@pytest.mark.parametrize("max_predictions", HEADS)
def test_carried_weights_give_the_same_loss_and_logits(max_predictions):
    j_main, j_startup, feeds, loss, logits = _build(jpt, max_predictions)
    t_main, _t_startup, *_ = _build(tpt, max_predictions)
    j_scope = _jax_scope(j_startup)
    arrays = {n: np.asarray(j_scope.find_var(n))
              for n in j_scope.local_var_names()}
    t_scope = scope_from_arrays(arrays, "cpu", program=t_main)
    feed = _feed(max_predictions)

    want = jpt.inference.Predictor(j_main, feeds, [loss, logits],
                                   scope=j_scope).run(feed)
    pred = tpt.inference.Predictor(t_main, feeds, [loss, logits],
                                   scope=t_scope, device="cpu")
    got = pred.run(feed)
    assert got[1].shape == want[1].shape and np.isfinite(got[1]).all()
    np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL, atol=0)
    np.testing.assert_allclose(got[1], want[1], atol=LOGITS_ATOL, rtol=0)


def test_model_dir_saved_by_paddle_tpu_answers_in_the_port(tmp_path):
    j_main, j_startup, feeds, loss, logits = _build(jpt)
    jpt.Executor().run(j_startup)  # the global scope, as io saves from it
    jpt.io.save_inference_model(str(tmp_path), feeds, [logits, loss],
                                jpt.Executor(), main_program=j_main)
    feed = _feed(seed=3)
    want = jpt.inference.Predictor(str(tmp_path)).run(feed)
    pred = tpt.inference.Predictor(str(tmp_path), device="cpu")
    assert pred.get_input_names() == feeds
    assert pred.get_output_names() == [logits, loss]
    assert pred.warmup({n: feed[n].shape for n in feeds}) == 1
    assert pred.warmup({n: feed[n].shape for n in feeds}) == 0
    got = pred.run([feed[n] for n in feeds])
    np.testing.assert_allclose(got[0], want[0], atol=LOGITS_ATOL, rtol=0)
    np.testing.assert_allclose(got[1], want[1], rtol=LOSS_RTOL, atol=0)


def test_port_save_load_round_trip(tmp_path):
    t_main, t_startup, feeds, loss, logits = _build(tpt)
    exe = tpt.Executor(tpt.CPUPlace())
    scope = tpt.Scope()
    with tpt.scope_guard(scope):
        exe.run(t_startup)
        tpt.io.save_inference_model(str(tmp_path), feeds, [logits, loss],
                                    exe, main_program=t_main)
    feed = _feed(seed=4)
    direct = exe.run(t_main, feed=feed, fetch_list=[logits, loss],
                     scope=scope)
    # the JAX package's Predictor serves the port's model directory too
    want = jpt.inference.Predictor(str(tmp_path)).run(feed)
    got = tpt.inference.Predictor(str(tmp_path), device="cpu").run(feed)
    np.testing.assert_array_equal(got[0], direct[0])
    np.testing.assert_array_equal(got[1], direct[1])
    np.testing.assert_allclose(got[0], want[0], atol=LOGITS_ATOL, rtol=0)
    np.testing.assert_allclose(got[1], want[1], rtol=LOSS_RTOL, atol=0)


def test_port_params_pickle_with_protocol_5_and_load_in_the_reference(
        tmp_path):
    """The port writes ``__params__`` with pickle protocol 5 (the
    reference writes 2); the reference's reader returns every array
    bit-equal, dtype and shape included."""
    rng = np.random.RandomState(5)
    arrays = {"w": rng.randn(3, 4).astype("float32"),
              "ids": rng.randint(0, 9, (5,)).astype("int64"),
              "empty": np.zeros((0, 2), "float32")}
    path = str(tmp_path / "__params__")
    tpt.io._write(path, arrays)
    with open(path, "rb") as f:
        assert f.read(2) == b"\x80\x05"
    for got in (jpt.io._read(path), tpt.io._read(path)):
        assert sorted(got) == sorted(arrays)
        for n, a in arrays.items():
            assert got[n].dtype == a.dtype and got[n].shape == a.shape
            np.testing.assert_array_equal(got[n], a)


def test_scope_from_arrays_checks_names_and_shapes():
    t_main, t_startup, *_ = _build(tpt)
    j_main, j_startup, *_ = _build(jpt)
    j_scope = _jax_scope(j_startup)
    arrays = {n: np.asarray(j_scope.find_var(n))
              for n in j_scope.local_var_names()}
    scope = scope_from_arrays(arrays, "cpu", program=t_main)
    name = sorted(arrays)[0]
    assert torch.equal(scope.find_var(name), torch.from_numpy(arrays[name]))
    with pytest.raises(ValueError, match="missing"):
        scope_from_arrays({k: v for k, v in arrays.items() if k != name},
                          "cpu", program=t_main)
    with pytest.raises(ValueError, match="unknown"):
        scope_from_arrays(dict(arrays, stray=np.zeros(3)), "cpu",
                          program=t_main)
    bad = dict(arrays)
    bad[name] = np.zeros((1,) + arrays[name].shape, "float32")
    with pytest.raises(ValueError, match="shape"):
        scope_from_arrays(bad, "cpu", program=t_main)


def test_predictor_without_cuda_and_without_device_raises(tmp_path,
                                                          monkeypatch):
    t_main, t_startup, feeds, loss, logits = _build(tpt)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpt.inference.Predictor(t_main, feeds, [loss], scope=tpt.Scope())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpt.inference.Predictor(t_main, feeds, [loss], scope=tpt.Scope(),
                                device="cuda")
