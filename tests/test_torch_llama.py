"""Llama training through both packages at a small GQA size (hidden 64,
2 layers, 4 heads, 2 kv heads so ``tile`` expands K/V, intermediate 128,
vocab 128, seq 32, batch 2, as tests/test_models.py trains it), with the
step built as the flagship builds it: ``build_llama_train`` and
``AdamW(weight_decay=0.01)``, optionally bf16 AMP.

* The port builds the same main and startup programs as paddle_tpu, as
  JSON, and they round-trip through the port's serde unchanged.
* fp32, from the JAX startup scope carried across with
  interop.scope_from_arrays, 3 steps of Executor.run: the loss at every
  step (rel 1e-5), the step-1 gradients (atol 1e-6: the two packages sum
  in other orders, the largest values are O(1e-1)), and the parameters
  after step 3: Adam moves an element by about lr * sign(g) while its
  moments are young, so a rounding-level difference in a gradient near 0
  can move a weight by up to 2 * lr a step; they are held to 2 * (sum of
  the LRs) everywhere and to 1e-5 on 99.9% of all elements.
* bf16 AMP: the loss follows the JAX package's within 1% at each of 3
  steps (bf16 keeps 8 mantissa bits, 0.4% per rounding; the two packages
  round at the same ops but sum in other orders).
* The block-paged KV-cache modes (paged generation) raise.
"""
import importlib
import json

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu import optimizer as j_opt
from paddle_tpu.contrib import mixed_precision as j_mp
from paddle_tpu.framework.core import reset_unique_name as j_reset_names
from paddle_tpu.framework.serde import program_to_json as j_to_json
from paddle_tpu.ops.registry import reset_op_seed as j_reset_seed
from paddle_tpu_torch import optimizer as t_opt
from paddle_tpu_torch.contrib import mixed_precision as t_mp
from paddle_tpu_torch.framework.serde import (program_from_json,
                                              program_to_json as t_to_json)
from paddle_tpu_torch.interop import scope_from_arrays
from paddle_tpu_torch.models import llama as t_llama
from paddle_tpu_torch.ops.registry import reset_op_seed as t_reset_seed

# the module (paddle_tpu.models re-exports a function of the same name)
j_llama = importlib.import_module("paddle_tpu.models.llama")

B, S, V = 2, 32, 128
CFG = dict(batch_size=B, seq_len=S, vocab_size=V, hidden=64, num_layers=2,
           num_heads=4, num_kv_heads=2, intermediate=128)
LR = 1e-3
GRADS = ["fc_0.w_0@GRAD", "rms_norm_0.w_0@GRAD", "embedding_0.w_0@GRAD",
         "fc_8.w_0@GRAD",        # the LM head
         "rope_0.tmp_0@GRAD"]    # the first flash_attention's Q input


def _build(pkg, amp=False, builder="build_llama_train"):
    if pkg is jpt:
        j_reset_names()
        j_reset_seed()
        model, opt, mp = j_llama, j_opt, j_mp
    else:
        tpt.reset_unique_name()
        t_reset_seed()
        model, opt, mp = t_llama, t_opt, t_mp
    main, startup = pkg.Program(), pkg.Program()
    startup._is_startup = True
    with pkg.program_guard(main, startup):
        if builder == "build_llama_forward":
            feeds, outs = model.build_llama_forward(**CFG)
            return main, startup, feeds, outs["logits"].name
        feeds, outs = model.build_llama_train(**CFG)
        o = opt.AdamW(LR, weight_decay=0.01,
                      apply_decay_param_fun=lambda n: "rms_norm" not in n)
        if amp:
            o = mp.decorate(o, dtype="bfloat16")
        o.minimize(outs["loss"])
    return main, startup, feeds, outs["loss"].name


def _feed(seed):
    rng = np.random.RandomState(seed)
    return {"input_ids": rng.randint(0, V, (B, S)).astype("int64"),
            "labels": rng.randint(0, V, (B, S)).astype("int64")}


def _carried(amp, builder="build_llama_train"):
    """Both programs, the JAX startup scope, and the port's copy of it."""
    j_main, j_startup, _, fetch = _build(jpt, amp, builder)
    t_main, _, _, _ = _build(tpt, amp, builder)
    j_scope = jpt.Scope()
    jpt.Executor().run(j_startup, scope=j_scope)
    arrays = {n: np.asarray(j_scope.find_var(n))
              for n in j_scope.local_var_names()}
    t_scope = scope_from_arrays(arrays, "cpu", program=t_main)
    return j_main, j_scope, t_main, t_scope, fetch, arrays


@pytest.mark.parametrize("amp,builder", [
    (False, "build_llama_train"), (True, "build_llama_train"),
    (False, "build_llama_forward")],
    ids=["train_fp32", "train_bf16_amp", "forward"])
def test_port_builds_the_same_llama_programs(amp, builder):
    j_main, j_startup, j_feeds, j_fetch = _build(jpt, amp, builder)
    t_main, t_startup, t_feeds, t_fetch = _build(tpt, amp, builder)
    assert (t_feeds, t_fetch) == (j_feeds, j_fetch)
    for jp, tp in ((j_main, t_main), (j_startup, t_startup)):
        text = t_to_json(tp)
        assert json.loads(text) == json.loads(j_to_json(jp))
        assert json.loads(t_to_json(program_from_json(text))) == \
            json.loads(text)
    types = [op.type for op in t_main.global_block().ops]
    if builder == "build_llama_forward":
        assert types.count("flash_attention") == 2 and "tile" in types
        return
    assert types.count("flash_attention_grad") == 2
    assert types.count("tile") == 4  # GQA: K and V of each layer
    assert types.count("adamw") == len(t_main.all_parameters())
    no_decay = [op for op in t_main.global_block().ops if op.type == "adamw"
                and op.attr("with_decay", True) is False]
    assert len(no_decay) == 5  # the rms_norm scales
    assert (getattr(t_main, "_amp_lowering", None) is not None) == amp


def test_fp32_trajectory_matches_jax():
    j_main, j_scope, t_main, t_scope, loss, start = _carried(amp=False)
    j_exe, t_exe = jpt.Executor(), tpt.Executor(tpt.CPUPlace())
    for step in range(3):
        feed = _feed(step)
        fetch = [loss] + (GRADS if step == 0 else [])
        want = j_exe.run(j_main, feed=feed, fetch_list=fetch, scope=j_scope)
        got = t_exe.run(t_main, feed=feed, fetch_list=fetch, scope=t_scope)
        np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-5,
                                   atol=0)
        for name, w, g in zip(fetch[1:], want[1:], got[1:]):
            w = np.asarray(w)
            assert g.shape == w.shape and np.abs(w).max() > 0, name
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=0,
                                       err_msg=name)
    bound = 2 * 3 * LR
    diffs = []
    for p in t_main.all_parameters():
        want = np.asarray(j_scope.find_var(p.name))
        diff = np.abs(t_scope.find_var(p.name).numpy() - want)
        assert diff.max() <= bound, (p.name, diff.max())
        diffs.append(diff.ravel())
    assert (np.concatenate(diffs) <= 1e-5).mean() >= 0.999
    # the weights moved: AdamW ran
    moved = t_scope.find_var("fc_0.w_0").numpy() - start["fc_0.w_0"]
    assert np.abs(moved).max() > 1e-4


def test_forward_logits_match_jax():
    """build_llama_forward (named parameters) from the carried scope:
    logits atol 1e-5."""
    j_main, j_scope, t_main, t_scope, logits, _ = _carried(
        amp=False, builder="build_llama_forward")
    feed = {"input_ids": _feed(7)["input_ids"]}
    want = jpt.Executor().run(j_main, feed=feed, fetch_list=[logits],
                              scope=j_scope)[0]
    got = tpt.Executor(tpt.CPUPlace()).run(t_main, feed=feed,
                                           fetch_list=[logits],
                                           scope=t_scope)[0]
    assert got.shape == (B, S, V)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)


def test_bf16_amp_loss_follows_jax():
    j_main, j_scope, t_main, t_scope, loss, _ = _carried(amp=True)
    j_exe, t_exe = jpt.Executor(), tpt.Executor(tpt.CPUPlace())
    for step in range(3):
        feed = _feed(step)
        want = np.asarray(j_exe.run(j_main, feed=feed, fetch_list=[loss],
                                    scope=j_scope)[0])
        got = t_exe.run(t_main, feed=feed, fetch_list=[loss],
                        scope=t_scope)[0]
        assert got.dtype == np.float32 and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-2, atol=0)
    # master weights stay float32; the attention runs in bf16, so the
    # grads of its inputs are bf16, as in the JAX package
    assert t_scope.find_var("fc_0.w_0").dtype == torch.float32
    g = t_exe.run(t_main, feed=_feed(3), fetch_list=["rope_0.tmp_0@GRAD"],
                  scope=t_scope, return_numpy=False)[0]
    assert g.dtype == torch.bfloat16


@pytest.mark.parametrize("kw", [
    dict(kv_cache=("ck", "cv"), positions="pos", block_table="bt",
         kv_lengths="len"),
    dict(collect_kv=True, paged=True),
    dict(block_table="bt", kv_lengths="len", paged=True)],
    ids=["kv_cache", "collect_kv", "block_table"])
def test_cache_modes_raise(kw):
    """The dense cache modes are ported (tests/test_torch_generation.py);
    the block-paged ones still raise: paged decode in llama_block, and
    the paged prefill and decode builders."""
    kw = dict(kw)
    with pytest.raises(NotImplementedError, match="paged"):
        if kw.pop("paged", False):
            if "collect_kv" in kw:
                t_llama.build_llama_prefill(1, S, cache_slots=2,
                                            max_seq_len=S, paged=True,
                                            num_pages=9, page_tokens=8)
            else:
                t_llama.build_llama_decode(2, S, paged=True, num_pages=9,
                                           page_tokens=8)
        else:
            x = tpt.layers.data("x", [B, S, 64], append_batch_size=False)
            t_llama.llama_block(x, 64, 4, 2, S, 16, 128, **kw)
