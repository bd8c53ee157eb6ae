"""BERT's three other attention branches through both packages at a small
size: 2 layers, hidden 64 / 2 heads (head_dim 32, as MiniLM-L12-H384's),
intermediate 128, vocab 97, seq 32, batch 4, max_predictions 5.

* ``use_flash=False`` (unfused: ``matmul`` with alpha, the [B,1,1,S]
  bias, ``softmax``, probability ``dropout``, ``matmul``), ``"xla"``
  (``flash_attention impl="xla"``, layout bshd) and ``True`` at a width
  the packed kernels do not take (the unpacked ``flash_attention`` op).
* Each builds the JAX package's program, main and startup, as JSON:
  serving, and training with bench.py's recipe (Adam, global-norm clip
  1.0, linear warmup) at dropout 0.1.
* The JAX startup scope carried across (``interop.scope_from_arrays``)
  gives the same loss (rel 1e-5) and logits (atol 1e-4: fp32, two layers
  of sums in other orders) through both Predictors, and at dropout 0 the
  same 3-step fp32 trajectory through both Executors: the loss at every
  step rel 1e-5, the step-1 gradients atol 1e-6, the parameters within
  2 * (sum of the LRs) everywhere and 1e-5 on 99.9% of the elements (Adam
  moves an element by ~lr while its moments are young; see
  tests/test_torch_train.py).
* The twin of the reference's ``test_bert_flash_matches_unfused``
  (tests/test_attention.py): the unfused and the flash program's losses
  on the same weights agree within rel 1e-4, in each package.
* The widths and branches whose build raised before this slice: unfused
  and einsum at hidden 128 / 2 heads, the unpacked branch at hidden 96 /
  2 heads (head_dim 48: the plain version on the CPU) and hidden 256 / 8
  heads in training: JSON-equal programs and the loss of a served batch
  (rel 1e-5) or of a training step at dropout 0 (rel 1e-5).
"""
import json
import os
import warnings

import numpy as np
import pytest

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu import clip as j_clip
from paddle_tpu import optimizer as j_opt
from paddle_tpu.framework.core import reset_unique_name as j_reset_names
from paddle_tpu.framework.serde import program_to_json as j_to_json
from paddle_tpu.models import build_bert_pretrain as j_build
from paddle_tpu.ops.registry import reset_op_seed as j_reset_seed
from paddle_tpu_torch import clip as t_clip
from paddle_tpu_torch import optimizer as t_opt
from paddle_tpu_torch.framework.serde import program_to_json as t_to_json
from paddle_tpu_torch.interop import scope_from_arrays
from paddle_tpu_torch.models import build_bert_pretrain as t_build
from paddle_tpu_torch.ops.registry import reset_op_seed as t_reset_seed

B, S, V, P = 4, 32, 97, 5
CFG = dict(seq_len=S, vocab_size=V, hidden=64, num_layers=2, num_heads=2,
           intermediate=128)
BRANCHES = {"unfused": False, "einsum": "xla", "unpacked_flash": True}
WARMUP = dict(warmup_steps=2, start_lr=0.0, end_lr=1e-3)
LRS = (0.0, 5e-4, 1e-3)
LOSS_RTOL, LOGITS_ATOL, GRAD_ATOL = 1e-5, 1e-4, 1e-6
# each branch's attention-side gradient fetched at step 1, beside the
# first layer's weights
GRADS = ["fc_0.w_0@GRAD", "layer_norm_0.w_0@GRAD", "embedding_0.w_0@GRAD",
         "fc_4.tmp_1@GRAD"]


def _build(pkg, use_flash, train, dropout=0.0, cfg=CFG, heads=True):
    if pkg is jpt:
        j_reset_names()
        j_reset_seed()
        build, clip, opt = j_build, j_clip, j_opt
    else:
        tpt.reset_unique_name()
        t_reset_seed()
        build, clip, opt = t_build, t_clip, t_opt
    main, startup = pkg.Program(), pkg.Program()
    startup._is_startup = True
    kw = dict(cfg, use_flash=use_flash, dropout=dropout, is_test=not train)
    if heads:
        kw.update(batch_size=B, max_predictions=P)
    with pkg.program_guard(main, startup), warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the flash path's dropout note
        feeds, outs = build(**kw)
        if train:
            lr = pkg.layers.linear_lr_warmup(1e-3, **WARMUP)
            opt.AdamOptimizer(
                learning_rate=lr,
                grad_clip=clip.GradientClipByGlobalNorm(1.0)).minimize(
                    outs["loss"])
    logits = [op for op in main.global_block().ops
              if op.type == "softmax_with_cross_entropy"][0].input("Logits")[0]
    return main, startup, feeds, outs["loss"].name, logits


def _feed(seed=0, heads=True):
    rng = np.random.RandomState(seed)
    mask = np.ones((B, S), "float32")
    mask[1, 20:] = 0.0
    mask[3, 5:] = 0.0
    feed = {"input_ids": rng.randint(0, V, (B, S)).astype("int64"),
            "token_type_ids": (rng.rand(B, S) > 0.5).astype("int64"),
            "attn_mask": mask}
    if heads:
        feed.update(
            mlm_positions=rng.randint(0, S, (B, P)).astype("int64"),
            mlm_labels=rng.randint(0, V, (B, P)).astype("int64"),
            mlm_weights=(rng.rand(B, P) > 0.2).astype("float32"))
    else:
        feed.update(mlm_mask=(rng.rand(B, S) < 0.3).astype("float32"),
                    mlm_labels=rng.randint(0, V, (B, S)).astype("int64"))
    return feed


def _carried(use_flash, train, cfg=CFG, heads=True):
    """Both programs, the JAX startup scope and the port's copy of it."""
    j_main, j_startup, feeds, loss, logits = _build(jpt, use_flash, train,
                                                    cfg=cfg, heads=heads)
    t_main, *_ = _build(tpt, use_flash, train, cfg=cfg, heads=heads)
    j_scope = jpt.Scope()
    jpt.Executor().run(j_startup, scope=j_scope)
    arrays = {n: np.asarray(j_scope.find_var(n))
              for n in j_scope.local_var_names()}
    t_scope = scope_from_arrays(arrays, "cpu", program=t_main)
    return j_main, j_scope, t_main, t_scope, feeds, loss, logits, arrays


def _same_programs(use_flash, train, cfg=CFG, dropout=0.1):
    j = _build(jpt, use_flash, train, dropout, cfg)
    t = _build(tpt, use_flash, train, dropout, cfg)
    assert t[2:] == j[2:]
    for jp, tp in ((j[0], t[0]), (j[1], t[1])):
        assert json.loads(t_to_json(tp)) == json.loads(j_to_json(jp))
    return t[0]


@pytest.mark.parametrize("train", [False, True], ids=["serving", "training"])
@pytest.mark.parametrize("branch", list(BRANCHES))
def test_port_builds_the_same_program(branch, train):
    main = _same_programs(BRANCHES[branch], train)
    types = [op.type for op in main.global_block().ops]
    want = {"unfused": "matmul", "einsum": "flash_attention",
            "unpacked_flash": "flash_attention"}[branch]
    assert types.count(want) == (4 if branch == "unfused" else 2)
    assert "flash_attention_qkv" not in types
    if branch == "unfused":
        assert types.count("softmax") == 2
        # probability dropout on the unfused branch only
        assert types.count("dropout") == (7 if train else 0)
    if train:
        assert types.count(want + "_grad") == types.count(want)


def test_einsum_branch_reads_the_no_prob_dropout_switch(monkeypatch):
    """``PT_BERT_NO_PROB_DROPOUT`` zeroes the einsum op's dropout_prob in
    both packages, and the programs stay JSON-equal."""
    monkeypatch.setenv("PT_BERT_NO_PROB_DROPOUT", "1")
    main = _same_programs("xla", True)
    probs = [op.attr("dropout_prob") for op in main.global_block().ops
             if op.type == "flash_attention"]
    assert probs == [0.0, 0.0]
    monkeypatch.delenv("PT_BERT_NO_PROB_DROPOUT")
    assert "PT_BERT_NO_PROB_DROPOUT" not in os.environ
    main = _same_programs("xla", True)
    probs = [op.attr("dropout_prob") for op in main.global_block().ops
             if op.type == "flash_attention"]
    assert probs == [0.1, 0.1]


@pytest.mark.parametrize("heads", [True, False], ids=["gather", "dense"])
@pytest.mark.parametrize("branch", list(BRANCHES))
def test_carried_weights_give_the_same_loss_and_logits(branch, heads):
    j_main, j_scope, t_main, t_scope, feeds, loss, logits, _ = _carried(
        BRANCHES[branch], False, heads=heads)
    feed = _feed(heads=heads)
    want = jpt.inference.Predictor(j_main, feeds, [loss, logits],
                                   scope=j_scope).run(feed)
    got = tpt.inference.Predictor(t_main, feeds, [loss, logits],
                                  scope=t_scope, device="cpu").run(feed)
    assert got[1].shape == want[1].shape and np.isfinite(got[1]).all()
    np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL, atol=0)
    np.testing.assert_allclose(got[1], want[1], atol=LOGITS_ATOL, rtol=0)


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_fp32_trajectory_matches_jax(branch):
    j_main, j_scope, t_main, t_scope, _, loss, _, start = _carried(
        BRANCHES[branch], True)
    j_exe, t_exe = jpt.Executor(), tpt.Executor(tpt.CPUPlace())
    for step in range(3):
        feed = _feed(step)
        fetch = [loss] + (GRADS if step == 0 else [])
        want = j_exe.run(j_main, feed=feed, fetch_list=fetch, scope=j_scope)
        got = t_exe.run(t_main, feed=feed, fetch_list=fetch, scope=t_scope)
        np.testing.assert_allclose(got[0], np.asarray(want[0]),
                                   rtol=LOSS_RTOL, atol=0)
        for name, w, g in zip(fetch[1:], want[1:], got[1:]):
            w = np.asarray(w)
            assert g.shape == w.shape and np.abs(w).max() > 0, name
            np.testing.assert_allclose(g, w, atol=GRAD_ATOL, rtol=0,
                                       err_msg=name)
    bound = 2 * sum(LRS)
    diffs = []
    for p in t_main.all_parameters():
        want = np.asarray(j_scope.find_var(p.name))
        diff = np.abs(t_scope.find_var(p.name).numpy() - want)
        assert diff.max() <= bound, (p.name, diff.max())
        diffs.append(diff.ravel())
    assert (np.concatenate(diffs) <= 1e-5).mean() >= 0.999
    moved = t_scope.find_var("fc_0.w_0").numpy() - start["fc_0.w_0"]
    assert np.abs(moved).max() > 1e-4


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_bert_flash_matches_unfused(pkg):
    """The reference test's configuration (hidden 32, 2 heads of 16: the
    unpacked flash op), dropout 0: the unfused and the flash program give
    one loss on the JAX startup weights (rel 1e-4), in each package, and
    the port's equals the JAX package's (rel 1e-5)."""
    cfg = dict(seq_len=32, vocab_size=128, hidden=32, num_layers=2,
               num_heads=2, intermediate=64)
    rng = np.random.RandomState(0)
    feed = {"input_ids": rng.randint(0, 128, (B, 32)).astype("int64"),
            "token_type_ids": np.zeros((B, 32), "int64"),
            "attn_mask": (rng.rand(B, 32) < 0.9).astype("float32"),
            "mlm_mask": (rng.rand(B, 32) < 0.15).astype("float32"),
            "mlm_labels": rng.randint(0, 128, (B, 32)).astype("int64")}
    losses, start = {}, None
    for use_flash in (False, True):
        j_main, j_scope, t_main, t_scope, feeds, loss, _, arrays = _carried(
            use_flash, False, cfg=cfg, heads=False)
        if start is None:
            start = arrays
        else:  # the unfused program's weights in both (same names)
            assert sorted(arrays) == sorted(start)
            for n, a in start.items():
                j_scope.set_var(n, a)
            t_scope = scope_from_arrays(start, "cpu", program=t_main)
        want = jpt.inference.Predictor(j_main, feeds, [loss],
                                       scope=j_scope).run(feed)[0]
        got = tpt.inference.Predictor(t_main, feeds, [loss], scope=t_scope,
                                      device="cpu").run(feed)[0]
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=0)
        losses[use_flash] = np.asarray(want if pkg == "jax" else got).item()
    np.testing.assert_allclose(losses[False], losses[True], rtol=1e-4)


# the four build-time raises of the parent's test_paths_not_ported_yet_raise,
# each now a parity case of the branch it named
OTHER_WIDTHS = {
    "unfused_h128": (dict(CFG, hidden=128, intermediate=256), False, False),
    "einsum_h128": (dict(CFG, hidden=128, intermediate=256), "xla", False),
    "unpacked_d48": (dict(CFG, hidden=96, intermediate=192), True, False),
    "unpacked_d32_training": (dict(CFG, hidden=256, num_heads=8,
                                   intermediate=512), True, True),
}


@pytest.mark.parametrize("case", list(OTHER_WIDTHS))
def test_branch_parity_at_other_widths(case):
    cfg, use_flash, train = OTHER_WIDTHS[case]
    _same_programs(use_flash, train, cfg=cfg)
    j_main, j_scope, t_main, t_scope, feeds, loss, _, _ = _carried(
        use_flash, train, cfg=cfg)
    feed = _feed(7)
    if train:
        want = jpt.Executor().run(j_main, feed=feed, fetch_list=[loss],
                                  scope=j_scope)[0]
        got = tpt.Executor(tpt.CPUPlace()).run(
            t_main, feed=feed, fetch_list=[loss], scope=t_scope)[0]
    else:
        want = jpt.inference.Predictor(j_main, feeds, [loss],
                                       scope=j_scope).run(feed)[0]
        got = tpt.inference.Predictor(t_main, feeds, [loss], scope=t_scope,
                                      device="cpu").run(feed)[0]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), rtol=LOSS_RTOL, atol=0)


@pytest.mark.parametrize("attention", ["unfused", "xla"])
def test_probe_serving_rows_equal_on_the_other_branches(attention):
    """``probe_decode_rows.py --program serving --attention <branch>`` at
    2 layers on the CPU: no op's row of a batch-1 request (matmul and
    softmax among them on the unfused branch) differs from the same
    request's row in a batch of 8, tolerance 0."""
    import importlib.util

    import torch

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "probe_decode_rows", os.path.join(repo, "probe_decode_rows.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    report = probe.serving_rows(
        dict(probe.BERT_TINY, num_layers=2,
             use_flash=probe.ATTENTION[attention]),
        torch.device("cpu"), seq_len=32)
    ops = {r["op"] for r in report}
    want = {"matmul", "softmax"} if attention == "unfused" else \
        {"flash_attention"}
    assert want <= ops and "flash_attention_qkv" not in ops
    assert all(r["max_abs_diff"] == 0.0 for r in report), \
        [r for r in report if r["max_abs_diff"]][:3]
