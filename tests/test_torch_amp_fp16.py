"""float16 AMP with dynamic loss scaling through both packages on the
CPU: ``decorate(dtype="float16")`` at a small size.

* BERT (2 layers, hidden 128, 2 heads, intermediate 512, seq 32, batch
  2, vocab 128, max_predictions 5) built as bench.py builds its step:
  Adam, global-norm clip 1.0, a linear LR warmup (to 1e-3 in 2 steps, so
  Adam moves the weights), bench.py's extra white list, and
  ``decorate(dtype="float16", init_loss_scaling=2**15,
  incr_every_n_steps=2, decr_every_n_nan_or_inf=1)``.  The port builds
  the same main and startup programs as the JAX package, as JSON.
* Six steps on ``bench._make_host_batches(2, 32, 128, 5)`` from the JAX
  startup scope, port against JAX: the scale, the good / bad counters
  and the overflow flag equal step for step.  The trajectory overflows
  twice: ``elementwise_mul`` is on the white list, so the scaled loss's
  gradient is the scale in float16, and a scale of 65536 is past
  float16's 65504 (inf) whatever the data; 32768 never overflows here.
  The losses follow the JAX package's within rel 2e-3 (4 float16
  roundings' worth, 2**-11 each: the two packages round at the same ops
  but sum in other orders; readings ~1.2e-4); the parameters after step 6
  within 2 * (sum of the LRs) everywhere (Adam moves an element by about
  lr * sign(g) while its moments are young, so a rounding-level
  difference in a gradient near 0 can move it by up to 2 * lr a step)
  and within 1e-4 (a tenth of the LR) on 99.5% of all elements
  (readings: 99.94%; float16 gradients differ at 2**-11 where float32
  ones differed at 2**-24, so 1e-5 held 98% and 95%).
* A small GQA Llama (tests/test_torch_llama.py's size) trained in
  float16 the same way, ``build_llama_train`` + AdamW with the default
  lists: scale state equal step for step (no overflow: the scale
  doubles every second step), losses within rel 2e-3 (readings ~5e-5),
  parameters as above.
* The master weights stay float32; white-list grads are float16, as in
  the JAX package.
* Each white-list op on the BERT and Llama paths that upcasts inside,
  fed float16 (what ``_lower_with_amp`` hands it), against the JAX
  lowering (the JAX package builds the op, tests/torch_op_util.py runs
  both): outputs and input grads bit-equal, except where the two round
  at other places, each held to a stated number of float16 ulps of the
  largest value: gelu (the port's F.gelu computes in float32 and rounds
  once, the JAX lowering rounds inside its erf form: forward 1 ulp, the
  grad 1 ulp of O(1)) and the grad of a broadcast operand of
  elementwise_add / _mul (a sum over the broadcast rows of float16
  products: up to 1 and 6 ulps, 8 allowed).  ``softmax`` is not an op of
  the port (the flash paths do not run it).
"""
import importlib
import json
import warnings

import numpy as np
import pytest
import torch

import bench
import paddle_tpu as jpt
from op_test import OpCase
from torch_op_util import run_both
import paddle_tpu_torch as tpt
from paddle_tpu import clip as j_clip
from paddle_tpu import optimizer as j_opt
from paddle_tpu.contrib import mixed_precision as j_mp
from paddle_tpu.framework.core import reset_unique_name as j_reset_names
from paddle_tpu.framework.serde import program_to_json as j_to_json
from paddle_tpu.models import build_bert_pretrain as j_build
from paddle_tpu.ops.registry import reset_op_seed as j_reset_seed
from paddle_tpu_torch import clip as t_clip
from paddle_tpu_torch import optimizer as t_opt
from paddle_tpu_torch.contrib import mixed_precision as t_mp
from paddle_tpu_torch.framework.serde import program_to_json as t_to_json
from paddle_tpu_torch.interop import scope_from_arrays
from paddle_tpu_torch.models import build_bert_pretrain as t_build
from paddle_tpu_torch.models import llama as t_llama
from paddle_tpu_torch.ops.registry import reset_op_seed as t_reset_seed

j_llama = importlib.import_module("paddle_tpu.models.llama")

B, S, V, P = 2, 32, 128, 5
BERT = dict(batch_size=B, seq_len=S, vocab_size=V, hidden=128,
            num_layers=2, num_heads=2, intermediate=512, max_predictions=P)
LLAMA = dict(batch_size=B, seq_len=S, vocab_size=V, hidden=64,
             num_layers=2, num_heads=4, num_kv_heads=2, intermediate=128)
# bench.py's BENCH_BF16_STREAM white list
EXTRA_WHITE = ["lookup_table", "lookup_table_v2", "layer_norm",
               "elementwise_add", "elementwise_mul", "dropout", "gelu",
               "relu", "scale", "transpose2", "reshape2", "gather_nd",
               "squeeze2", "unsqueeze2", "flash_attention",
               "flash_attention_qkv", "softmax"]
SCALING = dict(dtype="float16", init_loss_scaling=2.0 ** 15,
               incr_every_n_steps=2, decr_every_n_nan_or_inf=1)
STEPS = 6
LRS = (0.0, 5e-4) + (1e-3,) * (STEPS - 2)
LLAMA_LR = 1e-3
STATE = ["loss_scaling_0", "loss_scaling_good_0", "loss_scaling_bad_0"]
FP16_MAX = 65504.0
LOSS_RTOL = 2e-3


def _build(pkg, model):
    if pkg is jpt:
        j_reset_names()
        j_reset_seed()
        clip, opt, mp = j_clip, j_opt, j_mp
        build, llama = j_build, j_llama
    else:
        tpt.reset_unique_name()
        t_reset_seed()
        clip, opt, mp = t_clip, t_opt, t_mp
        build, llama = t_build, t_llama
    main, startup = pkg.Program(), pkg.Program()
    startup._is_startup = True
    with pkg.program_guard(main, startup), warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the flash path's dropout note
        if model == "bert":
            _, outs = build(dropout=0.0, **BERT)
            lr = pkg.layers.linear_lr_warmup(1e-3, warmup_steps=2,
                                             start_lr=0.0, end_lr=1e-3)
            o = opt.AdamOptimizer(
                learning_rate=lr,
                grad_clip=clip.GradientClipByGlobalNorm(1.0))
            lists = mp.AutoMixedPrecisionLists(custom_white_list=EXTRA_WHITE)
        else:
            _, outs = llama.build_llama_train(**LLAMA)
            o = opt.AdamW(LLAMA_LR, weight_decay=0.01,
                          apply_decay_param_fun=lambda n: "rms_norm" not in n)
            lists = None
        o = mp.decorate(o, amp_lists=lists, **SCALING)
        o.minimize(outs["loss"])
    found = [op.output("FoundInfinite")[0] for op in main.global_block().ops
             if op.type == "check_finite_and_unscale"]
    return main, startup, outs["loss"].name, found


def _feeds(model):
    if model == "bert":
        host = bench._make_host_batches(B, S, V, P)
        return [host[i % len(host)] for i in range(STEPS)]
    rngs = [np.random.RandomState(i) for i in range(STEPS)]
    return [{"input_ids": r.randint(0, V, (B, S)).astype("int64"),
             "labels": r.randint(0, V, (B, S)).astype("int64")}
            for r in rngs]


@pytest.mark.parametrize("model", ["bert", "llama"])
def test_port_builds_the_same_fp16_program(model):
    j_main, j_startup, j_loss, j_found = _build(jpt, model)
    t_main, t_startup, t_loss, t_found = _build(tpt, model)
    assert (t_loss, t_found) == (j_loss, j_found) and len(t_found) == 1
    for jp, tp in ((j_main, t_main), (j_startup, t_startup)):
        assert json.loads(t_to_json(tp)) == json.loads(j_to_json(jp))
    types = [op.type for op in t_main.global_block().ops]
    assert types.count("update_loss_scaling") == 1
    assert t_main._amp_lowering["dtype"] == "float16"
    opt = "adam" if model == "bert" else "adamw"
    assert types.index("update_loss_scaling") < types.index(opt)


def _trajectory(model):
    """Both packages' fetches over STEPS steps from the JAX startup
    scope, and the two scopes after them."""
    j_main, j_startup, loss, found = _build(jpt, model)
    t_main, _, _, _ = _build(tpt, model)
    j_scope = jpt.Scope()
    jpt.Executor().run(j_startup, scope=j_scope)
    arrays = {n: np.asarray(j_scope.find_var(n))
              for n in j_scope.local_var_names()}
    t_scope = scope_from_arrays(arrays, "cpu", program=t_main)
    j_exe, t_exe = jpt.Executor(), tpt.Executor(tpt.CPUPlace())
    fetch = [loss] + STATE + found
    want, got = [], []
    for feed in _feeds(model):
        want.append([np.asarray(w) for w in j_exe.run(
            j_main, feed=feed, fetch_list=fetch, scope=j_scope)])
        got.append(t_exe.run(t_main, feed=feed, fetch_list=fetch,
                             scope=t_scope))
    return t_main, j_scope, t_scope, want, got


def _check_params(t_main, j_scope, t_scope, bound):
    diffs = []
    for p in t_main.all_parameters():
        got = t_scope.find_var(p.name)
        assert got.dtype == torch.float32, p.name  # the master weights
        diff = np.abs(got.numpy() - np.asarray(j_scope.find_var(p.name)))
        assert diff.max() <= bound, (p.name, diff.max())
        diffs.append(diff.ravel())
    assert (np.concatenate(diffs) <= 1e-4).mean() >= 0.995


@pytest.mark.parametrize("model", ["bert", "llama"])
def test_fp16_trajectory_follows_jax(model):
    t_main, j_scope, t_scope, want, got = _trajectory(model)
    for step, (w, g) in enumerate(zip(want, got)):
        # scale, good, bad and the flag: equal, step for step
        for name, a, b in zip(STATE + ["found"], w[1:], g[1:]):
            assert a.dtype == b.dtype, (step, name)
            np.testing.assert_array_equal(b, a, err_msg=f"step {step} {name}")
        assert np.isfinite(g[0]).all()
        np.testing.assert_allclose(g[0], w[0], rtol=LOSS_RTOL, atol=0,
                                   err_msg=f"step {step} loss")
    scales = [float(g[1][0]) for g in got]
    flags = [bool(g[4][0]) for g in got]
    if model == "bert":
        # good, grow to 65536 (past float16's max: the next step's scaled
        # gradient is inf), overflow back to 32768, twice
        assert scales == [2.0 ** 15, 2.0 ** 16, 2.0 ** 15] * 2
        assert flags == [False, False, True] * 2
        assert all(s > FP16_MAX for s, f in zip([0.0] + scales, flags) if f)
        _check_params(t_main, j_scope, t_scope, 2 * sum(LRS))
    else:
        # the default lists keep elementwise_mul in float32: no overflow,
        # the scale doubles every second step
        assert scales == [2.0 ** 15, 2.0 ** 16, 2.0 ** 16, 2.0 ** 17,
                          2.0 ** 17, 2.0 ** 18]
        assert not any(flags)
        _check_params(t_main, j_scope, t_scope, 2 * LLAMA_LR * STEPS)


def test_fp16_white_list_grads_are_float16():
    """Master weights stay float32 in the scope; the grads of white-list
    ops are float16, as in the JAX package."""
    main, startup, loss, _ = _build(tpt, "bert")
    scope = tpt.Scope()
    exe = tpt.Executor(tpt.CPUPlace())
    exe.run(startup, scope=scope)
    g, ls = exe.run(main, feed=_feeds("bert")[0],
                    fetch_list=["fc_0.w_0@GRAD", loss], scope=scope,
                    return_numpy=False)
    assert g.dtype == torch.float16 and ls.dtype == torch.float32
    assert scope.find_var("fc_0.w_0").dtype == torch.float32


def _h(a):
    return np.asarray(a, "float16")


_X = np.random.RandomState(3).uniform(-2.0, 2.0, (6, 8))
_S = np.random.RandomState(4).uniform(0.5, 1.5, (8,))
# (case, float16 ulps of the largest value allowed in its outputs / grads)
WHITE_LIST_CASES = [
    (OpCase("layer_norm", {"X": _h(_X), "Scale": _h(_S),
                           "Bias": _h(_S - 1.0)},
            outputs={"Y": 1, "Mean": 1, "Variance": 1},
            attrs={"epsilon": 1e-5, "begin_norm_axis": 1},
            grad=["X", "Scale", "Bias"]), 1),
    (OpCase("gelu", {"X": _h(_X)}, grad=["X"]), 1),
    (OpCase("scale", {"X": _h(_X)}, attrs={"scale": 0.125, "bias": 0.0},
            grad=["X"]), 0),
    (OpCase("scale", {"X": _h(_X)}, attrs={"scale": 2.0, "bias": 1.0},
            grad=["X"], name="scale_bias"), 0),
    (OpCase("elementwise_add", {"X": _h(_X), "Y": _h(_X[0])},
            grad=["X", "Y"]), 8),
    (OpCase("elementwise_add", {"X": _h(_X), "Y": _X[0].astype("float32")},
            grad=["X", "Y"], name="elementwise_add_promote"), 8),
    (OpCase("elementwise_mul", {"X": _h(_X), "Y": _h(_X[0])},
            grad=["X", "Y"]), 8),
    (OpCase("lookup_table_v2", {"W": _h(_X), "Ids": np.array(
        [[1, 4], [0, 1]], "int64")}, grad=["W"]), 0),
    (OpCase("gather_nd", {"X": _h(_X), "Index": np.array(
        [[0, 1], [3, 2]], "int64")}, grad=["X"]), 0),
    (OpCase("dropout", {"X": _h(_X)}, outputs={"Out": 1, "Mask": 1},
            attrs={"dropout_prob": 0.0, "is_test": False,
                   "dropout_implementation": "upscale_in_train"},
            grad=["X"]), 0),
    (OpCase("rms_norm", {"X": _h(_X), "Scale": _h(_S)}, outputs={"Y": 1},
            attrs={"epsilon": 1e-6}, grad=["X", "Scale"]), 0),
    (OpCase("rope", {"X": _h(np.random.RandomState(6).uniform(
        -2.0, 2.0, (1, 4, 2, 8)))}, attrs={"base": 10000.0,
                                           "position_offset": 0},
            grad=["X"]), 0),
    (OpCase("tile", {"X": _h(_X)}, attrs={"repeat_times": [2, 1]},
            grad=["X"]), 0),
]


@pytest.mark.parametrize("case,ulps", WHITE_LIST_CASES,
                         ids=[c.name for c, _ in WHITE_LIST_CASES])
def test_white_list_lowering_in_float16_follows_jax(case, ulps):
    want, got, fetch = run_both(case)
    for name, w, g in zip(fetch, want, got):
        w, g = np.asarray(w), np.asarray(g)
        assert g.dtype == w.dtype and g.shape == w.shape, (name, g.dtype,
                                                           w.dtype)
        if w.dtype.kind != "f" or ulps == 0:
            np.testing.assert_array_equal(g, w, err_msg=name)
            continue
        limit = ulps * float(np.spacing(np.abs(w).max().astype(w.dtype)))
        np.testing.assert_allclose(g.astype("float64"), w.astype("float64"),
                                   rtol=0, atol=limit, err_msg=name)


def test_fp16_state_checkpoints_and_fetches_as_numpy(tmp_path):
    """After a float16 step the loss-scale state is in the checkpoint and
    comes back in place; a float16 tensor goes out as numpy's float16 (no
    ml_dtypes needed, unlike bfloat16) and fetches as one."""
    from paddle_tpu_torch import checkpoint as ckpt

    main, startup, loss, _ = _build(tpt, "bert")
    scope = tpt.Scope()
    exe = tpt.Executor(tpt.CPUPlace())
    exe.run(startup, scope=scope)
    exe.run(main, feed=_feeds("bert")[0], fetch_list=[loss], scope=scope)
    g = exe.run(main, feed=_feeds("bert")[1], fetch_list=["fc_0.w_0@GRAD"],
                scope=scope)[0]
    assert g.dtype == np.float16
    w = "fc_0.w_0"
    scope.set_var(w, scope.find_var(w).to(torch.float16))
    ckpt.save_checkpoint(str(tmp_path), 1, program=main, scope=scope)
    state = ckpt._load_state(str(tmp_path), 1)
    assert state[w].dtype == np.float16
    assert state["loss_scaling_good_0"].tolist() == [0]
    assert state["loss_scaling_0"].tolist() == [2.0 ** 16]
    held = {n: scope.find_var(n) for n in (w, "loss_scaling_0")}
    want = {n: t.clone() for n, t in held.items()}
    for t in held.values():
        t.zero_()
    ckpt.load_checkpoint(str(tmp_path), 1, program=main, scope=scope)
    for n, t in held.items():
        assert scope.find_var(n) is t and torch.equal(t, want[n])
