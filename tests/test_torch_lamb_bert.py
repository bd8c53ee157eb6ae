"""bench.py's BERT step with LAMB under gradient merge, in the port against
the JAX package, at a CPU size (2 layers, hidden 64, seq 32, batch 4, 5
predictions a row, dropout 0).

* ``GradientMergeOptimizer(LambOptimizer(...), k_steps=4, avg=True)``
  with bench.py's linear warmup and global-norm clip 1.0, LAMB at beta1
  0.9, beta2 0.999, eps 1e-6, weight decay 0.01 with the 1-D parameters
  (biases, LayerNorm scales and shifts) exempt: the program (main and
  startup, the conditional block included) JSON-equal to the JAX
  package's; 8 runs (two windows) from the JAX startup scope carried
  across: every loss within rtol 1e-5, and every persistable after each
  window's update within rtol 1e-4, atol 1e-6 of the JAX package's
  (float32: the two libraries' attention, products and norms differ by a
  few ulps; the largest gap here is 2.3e-9 on moments of ~1e-2, under the
  absolute limit).  On the three runs of a window that do not
  update, every persistable but the accumulators, the merge's step and
  the LR schedule's step counter (which counts runs, in the global block,
  as in the reference) is bit-identical to the run before.
* Wrapped as the card phase wraps it, ``GradientMergeOptimizer(
  decorate(LambOptimizer(...)), ...)`` with bench.py's bf16 white list:
  the program is JSON-equal to the JAX package's.  That list puts the
  accumulators' ``elementwise_add`` and the reset's ``scale`` in bf16,
  and the JAX package's AMP wrapper restores every cast input after the
  op, an in-place output too: there the accumulators never change and
  every update is LAMB's on a zero gradient.  The port runs the merge's
  ops, the clip and LAMB at float32 (``ops/registry.py``
  ``_amp_target``, as Fluid's AMP rewrites only the forward and its
  gradients): its accumulators hold the float32 sums of the runs'
  gradients and the update is LAMB's on their clipped mean (ROADMAP
  queue 3, reference faults).
"""
import json

import numpy as np
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu.framework.core import reset_unique_name as j_reset_names
from paddle_tpu.framework.serde import program_to_json as j_to_json
from paddle_tpu.models import build_bert_pretrain as j_build
from paddle_tpu.ops.registry import reset_op_seed as j_reset_seed
from paddle_tpu_torch.framework.serde import program_to_json as t_to_json
from paddle_tpu_torch.interop import scope_from_arrays
from paddle_tpu_torch.models import build_bert_pretrain as t_build
from paddle_tpu_torch.ops.registry import reset_op_seed as t_reset_seed

CFG = dict(batch_size=4, seq_len=32, vocab_size=97, hidden=64,
           num_layers=2, num_heads=2, intermediate=128, max_predictions=5)
K = 4
LR = dict(learning_rate=1e-3, warmup_steps=4, start_lr=0.0, end_lr=1e-3)
WHITE = ["lookup_table", "lookup_table_v2", "layer_norm", "elementwise_add",
         "elementwise_mul", "dropout", "gelu", "relu", "scale", "transpose2",
         "reshape2", "gather_nd", "squeeze2", "unsqueeze2",
         "flash_attention", "flash_attention_qkv", "softmax"]
LOSS_RTOL = 1e-5
STATE_RTOL, STATE_ATOL = 1e-4, 1e-6


def _one_d(param):
    return len(param.shape) == 1


def _build(pkg, amp):
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
    with pkg.program_guard(main, startup):
        _, outs = build(dropout=0.0, **CFG)
        lr = pkg.layers.linear_lr_warmup(**LR)
        opt = pkg.optimizer.LambOptimizer(
            learning_rate=lr, lamb_weight_decay=0.01, beta1=0.9,
            beta2=0.999, epsilon=1e-6, exclude_from_weight_decay_fn=_one_d,
            grad_clip=pkg.clip.GradientClipByGlobalNorm(1.0))
        if amp:
            mp = pkg.contrib.mixed_precision
            opt = mp.decorate(opt, amp_lists=mp.AutoMixedPrecisionLists(
                custom_white_list=WHITE), dtype="bfloat16")
        pkg.optimizer.GradientMergeOptimizer(opt, k_steps=K,
                                             avg=True).minimize(
            outs["loss"])
    return main, startup, outs["loss"].name


def _feeds(n, seed=0):
    rng = np.random.RandomState(seed)
    B, S, V, P = (CFG["batch_size"], CFG["seq_len"], CFG["vocab_size"],
                  CFG["max_predictions"])
    out = []
    for _ in range(n):
        mask = np.ones((B, S), "float32")
        mask[1, 20:] = 0.0
        out.append({
            "input_ids": rng.randint(0, V, (B, S)).astype("int64"),
            "token_type_ids": np.zeros((B, S), "int64"),
            "attn_mask": mask,
            "mlm_positions": np.sort(np.stack(
                [rng.choice(S, P, replace=False) for _ in range(B)]),
                axis=1).astype("int64"),
            "mlm_labels": rng.randint(0, V, (B, P)).astype("int64"),
            "mlm_weights": np.ones((B, P), "float32")})
    return out


def _both(amp):
    j_main, j_startup, loss = _build(jpt, amp)
    t_main, t_startup, t_loss = _build(tpt, amp)
    assert t_loss == loss
    for jp, tp in ((j_main, t_main), (j_startup, t_startup)):
        assert json.loads(t_to_json(tp)) == json.loads(j_to_json(jp))
    j_exe, j_scope = jpt.Executor(), jpt.Scope()
    j_exe.run(j_startup, scope=j_scope)
    names = sorted(v.name for v in t_main.list_vars() if v.persistable)
    arrays = {n: np.asarray(j_scope.find_var(n)) for n in names}
    t_scope = scope_from_arrays(arrays, "cpu", program=t_main)
    return (j_main, j_exe, j_scope), (t_main, tpt.Executor(tpt.CPUPlace()),
                                      t_scope), loss, names


def _window_state(names):
    """(accumulators, the merge's step, the LR counter)."""
    return [n for n in names if ".gm_acc" in n or n.startswith("gm_step")
            or n.startswith("@LR_DECAY_COUNTER@")]


def test_program_shape():
    main, _, _ = _build(tpt, amp=False)
    cond = [op for op in main.global_block().ops
            if op.type == "conditional_block"]
    assert len(cond) == 1
    sub = main.block(cond[0].attr("sub_block"))
    lamb = [op for op in sub.ops if op.type == "lamb"]
    decay = {op.input("Param")[0]: op.attr("weight_decay") for op in lamb}
    assert len(lamb) == len(main.all_parameters())
    assert {n for n, wd in decay.items() if wd == 0.0} == \
        {p.name for p in main.all_parameters() if len(p.shape) == 1}
    assert {wd for wd in decay.values()} == {0.0, 0.01}


def test_lamb_under_gradient_merge_follows_jax():
    (j_main, j_exe, j_scope), (t_main, t_exe, t_scope), loss, names = \
        _both(amp=False)
    moving = set(_window_state(names))
    prev = None
    for i, feed in enumerate(_feeds(2 * K)):
        want = j_exe.run(j_main, feed=feed, fetch_list=[loss],
                         scope=j_scope)[0]
        got = t_exe.run(t_main, feed=feed, fetch_list=[loss],
                        scope=t_scope)[0]
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL,
                                   err_msg=f"run {i}")
        now = {n: t_scope.find_var(n).numpy().copy() for n in names}
        if (i + 1) % K:  # a run that does not update
            if prev is not None:
                for n in names:
                    if n not in moving:
                        assert now[n].tobytes() == prev[n].tobytes(), \
                            (i, n)
        else:
            changed = [n for n in names if n not in moving
                       and now[n].tobytes() != prev[n].tobytes()]
            assert len(changed) > len(names) // 2, i
            for n in names:
                np.testing.assert_allclose(
                    now[n].astype("float64"),
                    np.asarray(j_scope.find_var(n)).astype("float64"),
                    rtol=STATE_RTOL, atol=STATE_ATOL,
                    err_msg=f"run {i} {n}")
        prev = now


def test_bf16_merge_accumulates_where_the_reference_drops_the_sums():
    (j_main, j_exe, j_scope), (t_main, t_exe, t_scope), loss, names = \
        _both(amp=True)
    accs = [n for n in names if ".gm_acc" in n]
    for i, feed in enumerate(_feeds(K - 1)):
        j_exe.run(j_main, feed=feed, fetch_list=[loss], scope=j_scope)
        t_exe.run(t_main, feed=feed, fetch_list=[loss], scope=t_scope)
    # the reference's accumulators stay zero; the port's hold the sums
    assert all(not np.asarray(j_scope.find_var(n)).any() for n in accs)
    assert all(t_scope.find_var(n).numpy().any() for n in accs)
    assert all(t_scope.find_var(n).dtype == torch.float32 for n in accs)


def test_bf16_merge_sums_and_applies_at_float32():
    """Under bench.py's bf16 white list the merge's accumulate, average
    and reset, the clip and LAMB run at float32, as Fluid's AMP leaves
    every op after the forward and its gradients: on the three merging
    runs each accumulator is the float32 sum of the gradients fetched on
    those runs, within 2 float32 epsilons of their absolute sum (three
    additions, each rounded to half an epsilon); on the updating run the
    moments and parameters are LAMB's on the clipped mean of the four
    runs' gradients, computed here in float64, within 1e-5 of the scale
    of each term (the float32 norms, divisions and square roots).  An
    accumulate rounded to bf16 misses the first bound by a factor of
    ~2^14."""
    tpt.reset_unique_name()
    t_main, t_startup, loss = _build(tpt, amp=True)
    block = t_main.global_block()
    acc_of = {op.input("Y")[0]: op.input("X")[0] for op in block.ops
              if op.type == "elementwise_add"
              and ".gm_acc" in op.input("X")[0]}
    cond = [op for op in block.ops if op.type == "conditional_block"][0]
    lamb = [op for op in t_main.block(cond.attr("sub_block")).ops
            if op.type == "lamb"]
    assert len(lamb) == len(acc_of) == len(t_main.all_parameters())
    grad_of = {p: g for g, p in
               ((g, g[:-len("@GRAD")]) for g in acc_of)}
    grads = sorted(acc_of)
    lr_name = lamb[0].input("LearningRate")[0]
    exe, scope = tpt.Executor(tpt.CPUPlace()), tpt.Scope()
    exe.run(t_startup, scope=scope)

    def f64(name):
        return scope.find_var(name).double().numpy().copy()

    seen = {g: [] for g in grads}
    eps = float(np.finfo(np.float32).eps)
    for i, feed in enumerate(_feeds(K)):
        if i == K - 1:
            before = {n: f64(n) for op in lamb for s in
                      ("Param", "Moment1", "Moment2", "Beta1Pow",
                       "Beta2Pow") for n in op.input(s)}
        outs = exe.run(t_main, feed=feed, fetch_list=[loss, lr_name] + grads,
                       scope=scope, return_numpy=False)
        outs = [h.value for h in outs]
        lr = float(outs[1].double().reshape(-1)[0])
        for g, v in zip(grads, outs[2:]):
            seen[g].append(v.double().numpy())
        if i < K - 1:
            assert any(v.dtype == torch.bfloat16 for v in outs[2:])
            for g in grads:
                want = np.sum(seen[g], axis=0)
                bound = 2 * eps * np.sum(np.abs(seen[g]), axis=0)
                assert (np.abs(f64(acc_of[g]) - want) <= bound).all(), (i, g)
    # the update: clip by the global norm, then LAMB's first step
    mean = {g: np.sum(seen[g], axis=0) / K for g in grads}
    mag = {g: np.sum(np.abs(seen[g]), axis=0) / K for g in grads}
    norm = np.sqrt(sum(float((m * m).sum()) for m in mean.values()))
    scale = 1.0 / max(norm, 1.0)
    for op in lamb:
        p = op.input("Param")[0]
        g, gm = scale * mean[grad_of[p]], scale * mag[grad_of[p]]
        b1, b2 = op.attr("beta1"), op.attr("beta2")
        m1 = b1 * before[op.input("Moment1")[0]] + (1 - b1) * g
        m2 = b2 * before[op.input("Moment2")[0]] + (1 - b2) * g * g
        for name, want, tol in ((op.input("Moment1")[0], m1, (1 - b1) * gm),
                                (op.input("Moment2")[0], m2,
                                 (1 - b2) * gm * gm)):
            assert (np.abs(f64(name) - want) <= 1e-5 * tol).all(), name
        b1p = before[op.input("Beta1Pow")[0]]
        b2p = before[op.input("Beta2Pow")[0]]
        p0 = before[p]
        r = (m1 / (1 - b1p)) / (np.sqrt(m2 / (1 - b2p))
                                + op.attr("epsilon")) \
            + op.attr("weight_decay") * p0
        p_norm, r_norm = np.linalg.norm(p0), np.linalg.norm(r)
        trust = p_norm / r_norm if p_norm > 0 and r_norm > 0 else 1.0
        step = lr * trust * r
        bound = 1e-5 * lr * trust * (np.abs(r) + 1.0) + \
            2 * np.spacing(np.abs(p0).astype("float32")).astype("float64")
        assert (np.abs(f64(p) - (p0 - step)) <= bound).all(), p
        assert np.abs(step).max() > 0, p
    for g in grads:
        assert not f64(acc_of[g]).any(), g


def test_amp_casts_by_the_lists_up_to_the_gradients():
    """``_amp_target`` under a bf16 white list holding ``elementwise_add``:
    a forward op, a grad op and a Backward-role op writing a temporary
    cast by the list; an Optimize-role op sees float32; a Backward-role
    op writing a persistable (the merge's accumulate) sees its inputs as
    they are."""
    from paddle_tpu_torch.framework.core import OpRole
    from paddle_tpu_torch.ops.registry import LowerContext, _amp_target

    main = tpt.Program()
    block = main.global_block()
    for n in ("x", "y", "out"):
        block.create_var(name=n, shape=[2], dtype="float32")
    block.create_var(name="acc", shape=[2], dtype="float32",
                     persistable=True)
    ctx = LowerContext(block, {}, "cpu", amp={
        "dtype": "bfloat16", "white": {"elementwise_add"}, "black": set()})

    def target(type, out, role, **attrs):
        op = block.append_op(type, inputs={"X": ["x"], "Y": ["y"]},
                             outputs={"Out": [out]},
                             attrs=dict(attrs, op_role=role),
                             infer_shape=False)
        return _amp_target(ctx, op)

    assert target("elementwise_add", "out", OpRole.Forward) == torch.bfloat16
    assert target("elementwise_add_grad", "out", OpRole.Backward,
                  __accumulate__=True) == torch.bfloat16
    assert target("elementwise_add", "out", OpRole.Backward) == \
        torch.bfloat16
    assert target("elementwise_add", "out", OpRole.Optimize) == \
        torch.float32
    assert target("elementwise_mul", "out", OpRole.Optimize) == \
        torch.float32
    assert target("elementwise_add", "acc", OpRole.Backward) is None
    assert target("elementwise_add", "acc", OpRole.Forward) == \
        torch.bfloat16
