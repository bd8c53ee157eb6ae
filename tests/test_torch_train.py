"""BERT training through both packages at a small size (2 layers, hidden
128, 2 heads, seq 32, vocab 97, max_predictions 5, batch 4), built the
way bench.py builds the flagship step: Adam, global-norm clip 1.0, linear
LR warmup, and optionally bf16 AMP with the bench's extra white list.

* The port builds the same training program as paddle_tpu, as JSON,
  main and startup, `_amp_lowering` included.
* fp32 at dropout 0, from the JAX startup scope carried across with
  interop.scope_from_arrays, 3 steps of Executor.run: the loss at every
  step (rel 1e-5), the step-1 gradients (atol 1e-6: the two packages sum
  in other orders, values are O(1e-2)) and the parameters after step 3.
  Adam moves an element by about lr * sign(g) while its moments are
  young, so a 1-ulp difference in a gradient near 0 can move a weight by
  up to 2 * lr per step (the QKV bias's key part has an analytically
  zero gradient, pure rounding noise): the parameters are held to
  2 * (sum of the LRs) everywhere and to 1e-5 on 99.9% of all elements.
* bf16 AMP: the loss follows the JAX package's within 2% at each of 3
  steps (bf16 keeps 8 mantissa bits, 0.4% per rounding; the two packages
  round at the same ops but sum in other orders).
* Dropout: the keep rate and scale match the JAX package's statistics,
  each Executor.run draws a fresh mask, and dropout_grad replays its
  forward's mask within a run.
"""
import json
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu import clip as j_clip
from paddle_tpu import optimizer as j_opt
from paddle_tpu.contrib import mixed_precision as j_mp
from paddle_tpu.framework.backward import append_backward as j_backward
from paddle_tpu.framework.core import reset_unique_name as j_reset_names
from paddle_tpu.framework.serde import program_to_json as j_to_json
from paddle_tpu.models import build_bert_pretrain as j_build
from paddle_tpu.ops.registry import reset_op_seed as j_reset_seed
from paddle_tpu_torch import clip as t_clip
from paddle_tpu_torch import optimizer as t_opt
from paddle_tpu_torch.contrib import mixed_precision as t_mp
from paddle_tpu_torch.framework.backward import append_backward as t_backward
from paddle_tpu_torch.framework.serde import program_to_json as t_to_json
from paddle_tpu_torch.interop import scope_from_arrays
from paddle_tpu_torch.models import build_bert_pretrain as t_build
from paddle_tpu_torch.ops.registry import reset_op_seed as t_reset_seed

B, S, V, P = 4, 32, 97, 5
CFG = dict(batch_size=B, seq_len=S, vocab_size=V, hidden=128, num_layers=2,
           num_heads=2, intermediate=256, max_predictions=P)
# bench.py's BENCH_BF16_STREAM white list
EXTRA_WHITE = ["lookup_table", "lookup_table_v2", "layer_norm",
               "elementwise_add", "elementwise_mul", "dropout", "gelu",
               "relu", "scale", "transpose2", "reshape2", "gather_nd",
               "squeeze2", "unsqueeze2", "flash_attention",
               "flash_attention_qkv", "softmax"]
# the short warmup that makes Adam move the weights: lr 0, 5e-4, 1e-3
WARMUP = dict(warmup_steps=2, start_lr=0.0, end_lr=1e-3)
LRS = (0.0, 5e-4, 1e-3)
GRADS = ["fc_0.w_0@GRAD", "layer_norm_0.w_0@GRAD", "embedding_0.w_0@GRAD",
         "fc_4.tmp_1@GRAD"]  # the last: flash_attention_qkv's QKV input


def _build(pkg, amp=False, dropout=0.0):
    if pkg is jpt:
        j_reset_names()
        j_reset_seed()
        build, clip, opt, mp = j_build, j_clip, j_opt, j_mp
    else:
        tpt.reset_unique_name()
        t_reset_seed()
        build, clip, opt, mp = t_build, t_clip, t_opt, t_mp
    main, startup = pkg.Program(), pkg.Program()
    startup._is_startup = True
    with pkg.program_guard(main, startup), warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the flash path's dropout note
        feeds, outs = build(dropout=dropout, **CFG)
        lr = pkg.layers.linear_lr_warmup(1e-3, **WARMUP)
        o = opt.AdamOptimizer(learning_rate=lr,
                              grad_clip=clip.GradientClipByGlobalNorm(1.0))
        if amp:
            o = mp.decorate(o, dtype="bfloat16",
                            amp_lists=mp.AutoMixedPrecisionLists(
                                custom_white_list=EXTRA_WHITE))
        o.minimize(outs["loss"])
    return main, startup, feeds, outs["loss"].name


def _feed(seed):
    rng = np.random.RandomState(seed)
    mask = np.ones((B, S), "float32")
    mask[1, 20:] = 0.0
    mask[3, 5:] = 0.0
    return {"input_ids": rng.randint(0, V, (B, S)).astype("int64"),
            "token_type_ids": (rng.rand(B, S) > 0.5).astype("int64"),
            "attn_mask": mask,
            "mlm_positions": rng.randint(0, S, (B, P)).astype("int64"),
            "mlm_labels": rng.randint(0, V, (B, P)).astype("int64"),
            "mlm_weights": (rng.rand(B, P) > 0.2).astype("float32")}


def _carried(amp):
    """Both programs, the JAX startup scope, and the port's copy of it."""
    j_main, j_startup, feeds, loss = _build(jpt, amp)
    t_main, _, _, _ = _build(tpt, amp)
    j_scope = jpt.Scope()
    jpt.Executor().run(j_startup, scope=j_scope)
    arrays = {n: np.asarray(j_scope.find_var(n))
              for n in j_scope.local_var_names()}
    t_scope = scope_from_arrays(arrays, "cpu", program=t_main)
    return j_main, j_scope, t_main, t_scope, loss, arrays


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "bf16_amp"])
def test_port_builds_the_same_training_program(amp):
    j_main, j_startup, j_feeds, j_loss = _build(jpt, amp, dropout=0.1)
    t_main, t_startup, t_feeds, t_loss = _build(tpt, amp, dropout=0.1)
    assert (t_feeds, t_loss) == (j_feeds, j_loss)
    for jp, tp in ((j_main, t_main), (j_startup, t_startup)):
        assert json.loads(t_to_json(tp)) == json.loads(j_to_json(jp))
    types = [op.type for op in t_main.global_block().ops]
    assert types.count("flash_attention_qkv_grad") == 2
    assert types.count("dropout_grad") == types.count("dropout") == 5
    assert types.count("adam") == len(t_main.all_parameters())
    assert (getattr(t_main, "_amp_lowering", None) is not None) == amp


def test_carried_scope_keeps_declared_dtypes():
    """The JAX startup scope holds the int64 LR counter as int32 (no x64):
    the port's copy has the program's int64, and Adam's state, the LR
    counter and loss_scaling_0 all cross."""
    _, _, t_main, t_scope, _, arrays = _carried(amp=True)
    counter = [n for n in arrays if n.startswith("@LR_DECAY_COUNTER@")]
    assert len(counter) == 1 and arrays[counter[0]].dtype == np.int32
    t = t_scope.find_var(counter[0])
    assert t.dtype == torch.int64 and t.tolist() == [-1]
    assert t_scope.find_var("loss_scaling_0").tolist() == [1.0]
    moments = [n for n in arrays if n.endswith(".moment1_0")]
    assert len(moments) == len(t_main.all_parameters())
    for name, arr in arrays.items():
        got = t_scope.find_var(name)
        assert tuple(got.shape) == arr.shape
        np.testing.assert_array_equal(got.numpy(), arr)


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
    bound = 2 * sum(LRS)
    diffs = []
    for p in t_main.all_parameters():
        want = np.asarray(j_scope.find_var(p.name))
        diff = np.abs(t_scope.find_var(p.name).numpy() - want)
        assert diff.max() <= bound, (p.name, diff.max())
        diffs.append(diff.ravel())
    assert (np.concatenate(diffs) <= 1e-5).mean() >= 0.999
    # the weights moved: Adam ran with a non-zero LR
    moved = t_scope.find_var("fc_0.w_0").numpy() - start["fc_0.w_0"]
    assert np.abs(moved).max() > 1e-4


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
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=0)
    # master weights stay float32; the grads of white-list ops are bf16,
    # as in the JAX package
    assert t_scope.find_var("fc_0.w_0").dtype == torch.float32
    g = t_exe.run(t_main, feed=_feed(3), fetch_list=["fc_0.w_0@GRAD"],
                  scope=t_scope, return_numpy=False)[0]
    assert g.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------

def _dropout_program(pkg, p, shape):
    backward = j_backward if pkg is jpt else t_backward
    main = pkg.Program()
    block = main.global_block()
    block.create_var(name="x", shape=list(shape), dtype="float32",
                     is_data=True, stop_gradient=False)
    with pkg.program_guard(main, pkg.Program()):
        block.append_op("dropout", inputs={"X": ["x"]},
                        outputs={"Out": ["o"]},
                        attrs={"dropout_prob": p, "is_test": False,
                               "seed": 0,
                               "dropout_implementation": "upscale_in_train"})
        block.append_op("reduce_sum", inputs={"X": ["o"]},
                        outputs={"Out": ["loss"]},
                        attrs={"dim": [0], "reduce_all": True,
                               "keep_dim": False})
        backward(block.var("loss"))
    return main


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_statistics_match_jax(p):
    """Keep probability 1 - round(256 p) / 256 in both packages (uint8
    bits against a threshold), kept values scaled by 1 / (1 - p).  200000
    draws put 5 sigma of the keep rate at <= 0.0056."""
    shape = (200, 1000)
    x = np.ones(shape, "float32")
    keep = 1.0 - round(256 * p) / 256.0
    tol = 5 * np.sqrt(keep * (1 - keep) / x.size)
    for pkg in (jpt, tpt):
        main = _dropout_program(pkg, p, shape)
        place = pkg.CPUPlace()
        out = np.asarray(pkg.Executor(place).run(
            main, feed={"x": x}, fetch_list=["o"], scope=pkg.Scope())[0])
        kept = out != 0
        assert abs(kept.mean() - keep) <= tol, (pkg.__name__, kept.mean())
        np.testing.assert_allclose(out[kept], 1.0 / (1.0 - p), rtol=1e-6)


def test_dropout_fresh_mask_per_run_and_replayed_by_its_grad():
    """Each Executor.run draws a new mask; within a run dropout_grad sees
    its forward's mask (x@GRAD is the scale exactly where Out kept x);
    a new Executor replays the same sequence of masks."""
    x = np.random.RandomState(3).rand(64, 64).astype("float32") + 1.0
    main = _dropout_program(tpt, 0.5, x.shape)

    def runs(exe, n):
        out = []
        for _ in range(n):
            o, g = exe.run(main, feed={"x": x}, fetch_list=["o", "x@GRAD"],
                           scope=tpt.Scope())
            np.testing.assert_array_equal(g, np.where(o != 0, 2.0, 0.0))
            out.append(o != 0)
        return out

    first = runs(tpt.Executor(tpt.CPUPlace()), 3)
    assert not np.array_equal(first[0], first[1])
    assert not np.array_equal(first[1], first[2])
    again = runs(tpt.Executor(tpt.CPUPlace()), 3)
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)


def test_bert_dropout_trains_and_differs_per_step():
    """Small BERT at dropout 0.1 trains through the port: finite losses,
    and the same batch twice gives two losses (fresh masks)."""
    t_main, t_startup, _, loss = _build(tpt, dropout=0.1)
    scope = tpt.Scope()
    exe = tpt.Executor(tpt.CPUPlace())
    exe.run(t_startup, scope=scope)
    feed = _feed(0)
    losses = [exe.run(t_main, feed=feed, fetch_list=[loss], scope=scope)[0]
              for _ in range(2)]
    assert all(np.isfinite(v).all() for v in losses)
    assert losses[0][0] != losses[1][0]
