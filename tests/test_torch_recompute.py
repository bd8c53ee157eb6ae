"""Recompute (``append_backward(checkpoints=...)``, ``RecomputeOptimizer``)
in the port, against the JAX package and against the port without it.

* The port's recompute programs serialise JSON-equal to the JAX
  package's (same segments, re-emitted forwards with role Backward and
  the original's ``__op_seed__``, the same ``@RC<k>`` / ``@RC_DISCARD<n>``
  names, renamed ``__fwd_inputs__``), for a small BERT (2 layers, hidden
  128, seq 32, dropout 0.1, bench.py's Adam, clip and warmup, bf16 AMP)
  checkpointed at each encoder layer's output, and a small GQA Llama
  (hidden 64, 2 layers, 4 heads, 2 kv heads) at each block's input and
  the final norm's, with the checkpoint finders of chip_smoke.py's
  phase 15; and they round-trip through the port's serde.
* The port runs the JAX-built recompute program (the reference's
  ``test_recompute_matches_plain_training`` net: fc relu, fc, softmax
  cross-entropy, checkpoint at the hidden layer, Adam 1e-2) from the
  JAX startup scope: its 5 losses follow the JAX package's within rtol
  1e-5, that test's tolerance (fp32; the two packages sum in other
  orders).
* Inside the port recompute is plain bit for bit (tolerance 0): every
  loss and every persistable after 3 steps, at dropout 0 and 0.5 (a
  re-emitted dropout draws the original's mask) and for the GQA Llama.
* The original forwards of recomputed segments keep no autograd graph:
  the executor's count of graphs kept at once (``peak_kept``) stays
  within the largest segment's forward ops, against every
  differentiated forward op without recompute.
"""
import importlib.util
import json
import os
import re
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu import layers as j_layers
from paddle_tpu import optimizer as j_opt
from paddle_tpu.framework.core import reset_unique_name as j_reset_names
from paddle_tpu.framework.serde import program_to_json as j_to_json
from paddle_tpu.ops.registry import reset_op_seed as j_reset_seed
from paddle_tpu_torch.framework.core import OpRole
from paddle_tpu_torch.framework.serde import (program_from_json,
                                              program_to_json as t_to_json)
from paddle_tpu_torch.interop import scope_from_arrays
from paddle_tpu_torch.ops.registry import reset_op_seed as t_reset_seed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

B, S, V, P = 4, 32, 97, 5
BERT = dict(batch_size=B, seq_len=S, vocab_size=V, hidden=128, num_layers=2,
            num_heads=2, intermediate=256, max_predictions=P)
LLAMA = dict(batch_size=2, seq_len=S, vocab_size=V, hidden=64, num_layers=2,
             num_heads=4, num_kv_heads=2, intermediate=128)
STEPS = 3


def _pkg_reset(pkg):
    if pkg is jpt:
        j_reset_names()
        j_reset_seed()
    else:
        tpt.reset_unique_name()
        t_reset_seed()


def _bert(pkg, recompute, dropout=0.0, amp=False):
    """bench.py's step at BERT's small size (Adam, global-norm clip 1.0,
    linear warmup, optionally bf16 AMP with the bench's white list), with
    recompute at each encoder layer's output.  Returns (main, startup,
    loss name)."""
    import importlib as il
    models = il.import_module(f"{pkg.__name__}.models")
    mp = il.import_module(f"{pkg.__name__}.contrib.mixed_precision")
    _pkg_reset(pkg)
    main, startup = pkg.Program(), pkg.Program()
    startup._is_startup = True
    with pkg.program_guard(main, startup), warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the flash path's dropout note
        _, outs = models.build_bert_pretrain(dropout=dropout, **BERT)
        lr = pkg.layers.linear_lr_warmup(1e-3, 2, 0.0, 1e-3)
        opt = pkg.optimizer.AdamOptimizer(
            learning_rate=lr,
            grad_clip=pkg.clip.GradientClipByGlobalNorm(1.0))
        if recompute:
            opt = pkg.optimizer.RecomputeOptimizer(opt)
            opt._set_checkpoints(smoke.bert_checkpoints(main))
        if amp:
            opt = mp.decorate(opt, dtype="bfloat16",
                              amp_lists=mp.AutoMixedPrecisionLists(
                                  custom_white_list=smoke.EXTRA_WHITE))
        opt.minimize(outs["loss"])
    return main, startup, outs["loss"].name


def _llama(pkg, recompute):
    """The small GQA Llama under AdamW(1e-3, weight_decay 0.01), with
    recompute at each block's input and the final norm's."""
    import importlib as il
    llama = il.import_module(f"{pkg.__name__}.models.llama")
    _pkg_reset(pkg)
    main, startup = pkg.Program(), pkg.Program()
    startup._is_startup = True
    with pkg.program_guard(main, startup):
        _, outs = llama.build_llama_train(**LLAMA)
        opt = pkg.optimizer.AdamW(1e-3, weight_decay=0.01)
        if recompute:
            opt = pkg.optimizer.RecomputeOptimizer(opt)
            opt._set_checkpoints(smoke.llama_checkpoints(main))
        opt.minimize(outs["loss"])
    return main, startup, outs["loss"].name


def _bert_feed(seed):
    rng = np.random.RandomState(seed)
    mask = np.ones((B, S), "float32")
    mask[1, 20:] = 0.0
    return {"input_ids": rng.randint(0, V, (B, S)).astype("int64"),
            "token_type_ids": (rng.rand(B, S) > 0.5).astype("int64"),
            "attn_mask": mask,
            "mlm_positions": rng.randint(0, S, (B, P)).astype("int64"),
            "mlm_labels": rng.randint(0, V, (B, P)).astype("int64"),
            "mlm_weights": (rng.rand(B, P) > 0.2).astype("float32")}


def _llama_feed(seed):
    rng = np.random.RandomState(seed)
    return {"input_ids": rng.randint(0, V, (2, S)).astype("int64"),
            "labels": rng.randint(0, V, (2, S)).astype("int64")}


def _train(main, startup, loss, feed):
    """STEPS runs on the CPU from the startup program's state; returns
    (losses, persistables, the compiled step)."""
    exe, scope = tpt.Executor(tpt.CPUPlace()), tpt.Scope()
    exe.run(startup, scope=scope)
    losses = [exe.run(main, feed=feed(i), fetch_list=[loss],
                      scope=scope)[0] for i in range(STEPS)]
    state = {v.name: scope.find_var(v.name) for v in main.list_vars()
             if v.persistable}
    entry = [e for e in exe._cache.values() if e.block.program is main][0]
    return losses, state, entry


def _segments(main, checkpoints):
    """The forward ops of each segment between checkpoints."""
    fwd = [op for op in main.global_block().ops
           if op.attr("op_role", OpRole.Forward) in
           (OpRole.Forward, OpRole.Forward | OpRole.Loss)]
    ends = sorted({i for i, op in enumerate(fwd)
                   if set(op.output_arg_names()) & set(checkpoints)})
    bounds = [-1] + ends + [len(fwd) - 1]
    return [b - a for a, b in zip(bounds, bounds[1:]) if b > a]


@pytest.mark.parametrize("model", ["bert", "llama_gqa"])
def test_recompute_program_serialises_as_the_reference(model):
    if model == "bert":
        j = _bert(jpt, True, dropout=0.1, amp=True)[0]
        t = _bert(tpt, True, dropout=0.1, amp=True)[0]
    else:
        j, t = _llama(jpt, True)[0], _llama(tpt, True)[0]
    text = t_to_json(t)
    assert json.loads(text) == json.loads(j_to_json(j))
    assert json.loads(t_to_json(program_from_json(text))) == json.loads(text)
    ops = t.global_block().ops
    names = [n for op in ops for n in op.output_arg_names()]
    assert any(re.search(r"@RC\d+$", n) for n in names)
    assert any("@RC_DISCARD" in n for n in names)
    re_emitted = [op for op in ops if not op.type.endswith("_grad")
                  and op.attr("op_role") == OpRole.Backward
                  and any("@RC" in n for n in op.output_arg_names())]
    assert re_emitted and all("__op_seed__" in op.attrs for op in re_emitted)


def _ref_net(recompute):
    """The reference test's net, built in the JAX package."""
    j_reset_names()
    j_reset_seed()
    main, startup = jpt.Program(), jpt.Program()
    startup._is_startup = True
    with jpt.program_guard(main, startup):
        x = j_layers.data("x", [16, 8], append_batch_size=False)
        y = j_layers.data("y", [16, 1], dtype="int64",
                          append_batch_size=False)
        h = j_layers.fc(x, 16, act="relu")
        logits = j_layers.fc(h, 4)
        loss = j_layers.mean(j_layers.softmax_with_cross_entropy(logits, y))
        opt = j_opt.AdamOptimizer(1e-2)
        if recompute:
            opt = j_opt.RecomputeOptimizer(opt)
            opt._set_checkpoints([h])
        opt.minimize(loss)
    return main, startup, loss.name


def test_port_runs_the_reference_recompute_program():
    rng = np.random.RandomState(0)
    feed = {"x": rng.rand(16, 8).astype("float32"),
            "y": rng.randint(0, 4, (16, 1)).astype("int64")}
    j_main, j_startup, loss = _ref_net(True)
    assert any("@RC" in n for op in j_main.global_block().ops
               for n in op.output_arg_names())
    j_exe, j_scope = jpt.Executor(), jpt.Scope()
    j_exe.run(j_startup, scope=j_scope)
    arrays = {n: np.asarray(j_scope.find_var(n))
              for n in j_scope.local_var_names()}
    want = [float(np.ravel(j_exe.run(j_main, feed=feed, fetch_list=[loss],
                                     scope=j_scope)[0])[0])
            for _ in range(5)]
    t_main = program_from_json(j_to_json(j_main))
    t_scope = scope_from_arrays(arrays, "cpu", program=t_main)
    t_exe = tpt.Executor(tpt.CPUPlace())
    got = [float(np.ravel(t_exe.run(t_main, feed=feed, fetch_list=[loss],
                                    scope=t_scope)[0])[0])
           for _ in range(5)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]


@pytest.mark.parametrize("model,dropout", [
    ("bert", 0.0), ("bert", 0.5), ("llama_gqa", 0.0)],
    ids=["bert_dropout0", "bert_dropout0.5", "llama_gqa"])
def test_recompute_is_bit_equal_to_plain(model, dropout):
    runs = []
    for recompute in (False, True):
        if model == "bert":
            main, startup, loss = _bert(tpt, recompute, dropout)
            runs.append(_train(main, startup, loss, _bert_feed))
        else:
            main, startup, loss = _llama(tpt, recompute)
            runs.append(_train(main, startup, loss, _llama_feed))
    (l0, s0, _), (l1, s1, _) = runs
    assert [np.asarray(x).tobytes() for x in l0] == \
        [np.asarray(x).tobytes() for x in l1]
    assert sorted(s0) == sorted(s1)
    assert [n for n in s0 if not torch.equal(s0[n], s1[n])] == []
    if dropout:
        # the masks differ from run to run (the run count keys them)
        assert len({float(np.ravel(x)[0]) for x in l0}) == STEPS


@pytest.mark.parametrize("model", ["bert", "llama_gqa"])
def test_recomputed_segments_keep_no_graph(model):
    build = _bert if model == "bert" else _llama
    feed = _bert_feed if model == "bert" else _llama_feed
    finder = smoke.bert_checkpoints if model == "bert" else \
        smoke.llama_checkpoints
    peaks = []
    for recompute in (False, True):
        main, startup, loss = build(tpt, recompute)
        peaks.append(_train(main, startup, loss, feed)[2].peak_kept)
    main = build(tpt, False)[0]
    segments = _segments(main, finder(main))
    assert len(segments) == len(finder(main)) + 1
    plain, rc = peaks
    assert 0 < rc <= max(segments) < plain


def test_recompute_optimizer_needs_checkpoints_and_forwards():
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        x = tpt.layers.data("x", [4])
        loss = tpt.layers.mean(tpt.layers.fc(x, 2))
        inner = tpt.optimizer.AdamOptimizer(1e-2, beta1=0.8)
        opt = tpt.optimizer.RecomputeOptimizer(inner)
        assert opt._beta1 == 0.8 and opt.inner_optimizer is inner
        with pytest.raises(ValueError, match="_set_checkpoints"):
            opt.minimize(loss)


def test_loaded_training_program_registers_its_grad_ops(monkeypatch):
    """A JAX-built program whose auto-derived grad op type the port has
    not emitted in this process yet (``cos_grad``) loads and runs: the
    serde registers it, as append_backward would have."""
    from paddle_tpu.framework.backward import append_backward
    from paddle_tpu_torch.ops import registry

    monkeypatch.delitem(registry._REGISTRY, "cos_grad", raising=False)
    j_reset_names()
    main, startup = jpt.Program(), jpt.Program()
    with jpt.program_guard(main, startup):
        x = j_layers.data("x", [3], append_batch_size=False)
        x.stop_gradient = False
        loss = j_layers.mean(j_layers.cos(x))
        append_backward(loss)
    t_main = program_from_json(j_to_json(main))
    assert registry.has_op("cos_grad")
    xv = np.array([0.5, -1.0, 2.0], "float32")
    g, = tpt.Executor(tpt.CPUPlace()).run(
        t_main, feed={"x": xv}, fetch_list=["x@GRAD"], scope=tpt.Scope())
    np.testing.assert_allclose(g, -np.sin(xv) / 3, rtol=1e-6)
