"""The port's compiled step (framework/executor.py ``CompiledStep``), on
the CPU where every run takes the eager path of the same entry, with
the JAX package alongside where it has the same behaviour.

* Twins of tests/test_async_executor.py: lazy FetchHandles, run_async /
  sync, and the deferred non-finite guard (set_nonfinite_guard +
  run_async in place of TrainGuard); host syncs counted by the port's
  monitor.  A guarded run of 50 steps pays no host sync until its one
  fence.
* A guarded step on a NaN feed leaves every parameter bit-unchanged, in
  the port and in the JAX executor.
* FLAGS_check_nan_inf's debug run: shape-inference drift and a NaN both
  raise, naming the op.
* The cache: one build per key (executor_jit_builds), a new entry for a
  new feed shape or a _mod_count bump, cache_info's keys.
* State is updated in place (same tensor, same data_ptr), and a fetch of
  state is not changed by the next run.
* No forward recompute: the plain attention forward runs once per
  attention op a step; BERT's bias gradient is dead and not computed,
  which changes no loss or parameter; one AMP cast per (tensor, dtype)
  per run.
* Card-only (``-m cuda``, skipped here): capture then replay equals the
  eager debug run bit for bit on a small fp32 BERT; a replayed step's
  kernel counts equal the eager step's; a capture that meets a host sync
  raises, naming the op.
"""
import collections
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu_torch import monitor as t_monitor
from paddle_tpu_torch import optimizer as t_opt
from paddle_tpu_torch.contrib import mixed_precision as t_mp
from paddle_tpu_torch.models import build_bert_pretrain, build_llama_train
from paddle_tpu_torch.ops import registry as t_registry
from paddle_tpu_torch.ops.cuda import flash_attention as fa


def stat(name):
    return t_monitor.stat_get(name)


@pytest.fixture(autouse=True)
def _default_flags():
    yield
    tpt.set_flags({"FLAGS_guard_resolve_interval": 64,
                   "FLAGS_check_nan_inf": False})


def _net(pkg, lr=0.1):
    """x [N, 4] -> fc(1) -> mean((pred - y)^2), Adam; both packages have
    every op of it.  Returns (main, startup, loss name)."""
    main, startup = pkg.Program(), pkg.Program()
    startup._is_startup = True
    with pkg.program_guard(main, startup):
        x = pkg.layers.data("x", [4])
        y = pkg.layers.data("y", [1])
        pred = pkg.layers.fc(x, 1)
        d = pkg.layers.elementwise_add(pred, pkg.layers.scale(y, -1.0))
        loss = pkg.layers.mean(pkg.layers.elementwise_mul(d, d))
        pkg.optimizer.AdamOptimizer(lr).minimize(loss)
    return main, startup, loss.name


def _feed(seed=0, nan=False):
    rng = np.random.RandomState(seed)
    x = rng.rand(8, 4).astype("float32")
    if nan:
        x = np.full_like(x, np.nan)
    return {"x": x, "y": (x.sum(1, keepdims=True) * 0.5).astype("float32")}


def _started(pkg=tpt):
    main, startup, loss = _net(pkg)
    exe = pkg.Executor(pkg.CPUPlace())
    scope = pkg.Scope()
    exe.run(startup, scope=scope)
    return exe, main, scope, loss


# ---------------------------------------------------------------------------
# twins of tests/test_async_executor.py
# ---------------------------------------------------------------------------

def test_run_async_guarded_50_steps_o1_host_syncs():
    exe, main, scope, loss = _started()
    exe.set_nonfinite_guard(loss, program=main)
    feed = _feed()
    exe.run_async(main, feed, [loss], scope)  # the entry's first run
    exe.sync()
    h0 = stat("host_syncs")
    res = None
    for _ in range(50):
        res = exe.run_async(main, feed, [loss], scope)
    dispatched = stat("host_syncs") - h0
    assert dispatched == 0, \
        f"async dispatch paid {dispatched} host syncs over 50 steps"
    out = res.sync()  # one fence + one guard resolution + one fetch read
    total = stat("host_syncs") - h0
    assert total <= 4, f"O(1) expected after sync, got {total}"
    assert np.isfinite(out[0]).all()
    exe.close()


def test_sync_run_unchanged_semantics():
    """return_numpy=True keeps blocking numpy semantics and resolves the
    guard at the fetch read."""
    exe, main, scope, loss = _started()
    exe.set_nonfinite_guard(loss, program=main)
    out = exe.run(main, _feed(), [loss], scope)
    assert isinstance(out[0], np.ndarray)
    assert not exe._pending_guard  # resolved by the fetch read
    exe.close()


def test_deferred_guard_callback_gets_original_step():
    exe, main, scope, loss = _started()
    seen = []
    exe.set_nonfinite_guard(loss, seen.append, program=main)
    tpt.set_flags({"FLAGS_guard_resolve_interval": 0})  # defer to close
    sk0 = stat("skipped_nonfinite_steps")
    for i in range(6):
        exe.run_async(main, _feed(nan=(i == 2)), scope=scope)  # steps 2-7
    assert seen == []                       # nothing resolved yet
    assert len(exe._pending_guard) == 6
    exe.close()                             # close() resolves + fires
    assert seen == [4]
    assert stat("skipped_nonfinite_steps") == sk0 + 1


def test_guard_resolve_interval_batches():
    exe, main, scope, loss = _started()
    exe.set_nonfinite_guard(loss, program=main)
    tpt.set_flags({"FLAGS_guard_resolve_interval": 4})
    r0 = stat("guard_resolutions")
    for _ in range(8):                      # no fetches -> interval rules
        exe.run_async(main, _feed(), scope=scope)
    assert stat("guard_resolutions") == r0 + 2
    assert len(exe._pending_guard) == 0
    exe.close()


def test_fetch_read_resolves_guard_up_to_its_step():
    exe, main, scope, loss = _started()
    exe.set_nonfinite_guard(loss, program=main)
    tpt.set_flags({"FLAGS_guard_resolve_interval": 0})
    r1 = exe.run_async(main, _feed(), [loss], scope)
    r2 = exe.run_async(main, _feed(), [loss], scope)
    exe.run_async(main, _feed(), [loss], scope)
    assert len(exe._pending_guard) == 3
    r2[0].numpy()                           # reading step N resolves <= N
    assert len(exe._pending_guard) == 1
    r1[0].numpy()                           # older handle: nothing left
    assert len(exe._pending_guard) == 1
    exe.close()
    assert not exe._pending_guard


def test_fetch_handle_lazy_and_correct():
    main = tpt.Program()
    with tpt.program_guard(main, tpt.Program()):
        x = tpt.layers.data("x", [4], append_batch_size=False)
        out = tpt.layers.scale(x, scale=2.0)
    exe = tpt.Executor(tpt.CPUPlace())
    a = np.arange(4, dtype="float32")
    h0 = stat("host_syncs")
    (h,) = exe.run(main, feed={"x": a}, fetch_list=[out], scope=tpt.Scope(),
                   return_numpy=False)
    assert isinstance(h, tpt.FetchHandle)
    # metadata reads must not fence
    assert h.shape == (4,) and h.ndim == 1 and h.dtype == torch.float32
    assert stat("host_syncs") == h0
    np.testing.assert_allclose(np.asarray(h), a * 2)
    assert stat("host_syncs") == h0 + 1
    np.asarray(h)  # cached: second read is free
    assert stat("host_syncs") == h0 + 1


def test_run_async_result_protocol():
    exe, main, scope, loss = _started()
    res = exe.run_async(main, _feed(), [loss], scope)
    assert len(res) == 1
    assert isinstance(res[0], tpt.FetchHandle)
    vals = res.sync()
    assert isinstance(vals[0], np.ndarray)
    assert list(res)[0] is res[0]


# ---------------------------------------------------------------------------
# the guarded NaN step, in both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", [jpt, tpt], ids=["jax", "torch"])
def test_guarded_nan_step_leaves_the_state_bit_unchanged(pkg):
    exe, main, scope, loss = (_started(pkg) if pkg is tpt else
                              _started_jax())
    seen = []
    exe.set_nonfinite_guard(loss, seen.append, program=main)
    exe.run(main, _feed(0), [loss], scope)  # a finite step first
    persist = [v.name for v in main.list_vars() if v.persistable]
    before = {n: np.array(np.asarray(scope.find_var(n))) for n in persist}
    out = exe.run(main, _feed(1, nan=True), [loss], scope)
    assert not np.isfinite(out[0]).all()
    assert seen == [3]  # startup 1, the finite step 2
    for n in persist:
        np.testing.assert_array_equal(np.asarray(scope.find_var(n)),
                                      before[n], err_msg=n)
    out = exe.run(main, _feed(2), [loss], scope)  # and it trains on
    assert np.isfinite(out[0]).all()
    assert any(not np.array_equal(np.asarray(scope.find_var(n)), before[n])
               for n in persist)


def _started_jax():
    main, startup, loss = _net(jpt)
    exe = jpt.Executor()
    scope = jpt.Scope()
    exe.run(startup, scope=scope)
    return exe, main, scope, loss


# ---------------------------------------------------------------------------
# FLAGS_check_nan_inf's debug run
# ---------------------------------------------------------------------------

def test_debug_mode_catches_shape_inference_drift():
    """Twin of tests/test_executor_basic.py's drift test."""
    from paddle_tpu_torch.ops.registry import _REGISTRY, register_op, set_out

    @register_op("__drifty_op__", infer=lambda op, block: set_out(
        op, block, "Out", (3, 3), "float32"))
    def _drifty(ctx, op):
        ctx.set_output(op, "Out", torch.zeros((2, 2))
                       + ctx.get_input(op, "X").sum())

    try:
        main = tpt.Program()
        block = main.global_block()
        block.create_var(name="dx", shape=[2, 2], dtype="float32",
                         is_data=True)
        block.create_var(name="dout", shape=[3, 3], dtype="float32")
        block.append_op("__drifty_op__", inputs={"X": ["dx"]},
                        outputs={"Out": ["dout"]}, attrs={})
        exe = tpt.Executor(tpt.CPUPlace())
        tpt.set_flags({"FLAGS_check_nan_inf": True})
        with pytest.raises(RuntimeError, match="shape-inference drift"):
            exe.run(main, feed={"dx": np.ones((2, 2), "float32")},
                    fetch_list=["dout"], scope=tpt.Scope())
    finally:
        _REGISTRY.pop("__drifty_op__", None)


def test_debug_mode_names_the_op_of_the_first_nan():
    exe, main, scope, loss = _started()
    cached = exe.cache_info()["compiled"]  # the startup program's entry
    tpt.set_flags({"FLAGS_check_nan_inf": True})
    with pytest.raises(FloatingPointError, match="op 'mul'"):
        exe.run(main, _feed(nan=True), [loss], scope)
    out = exe.run(main, _feed(), [loss], scope)  # finite: runs as usual
    assert np.isfinite(out[0]).all()
    assert exe.cache_info()["compiled"] == cached  # never cached


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------

def test_one_build_per_key_and_a_new_entry_per_shape_or_mod_count():
    exe, main, scope, loss = _started()
    b0 = stat("executor_jit_builds")
    for _ in range(3):
        exe.run(main, _feed(), [loss], scope)
    assert stat("executor_jit_builds") == b0 + 1
    small = {k: v[:4] for k, v in _feed().items()}
    exe.run(main, small, [loss], scope)     # a new feed shape
    assert stat("executor_jit_builds") == b0 + 2
    exe.run(main, _feed(), [loss], scope)   # the first key again
    assert stat("executor_jit_builds") == b0 + 2
    main.bump()                             # the program changed
    exe.run(main, _feed(), [loss], scope)
    assert stat("executor_jit_builds") == b0 + 3
    info = exe.cache_info()
    assert info["compiled"] == 4  # startup and three of main
    assert set(info["entries"][0]) == {"signature", "aot", "manifest"}
    # the CPU runs every entry uncaptured
    assert not any(e["aot"] for e in info["entries"])
    exe.run(main, _feed(), [loss], scope, use_program_cache=False)
    assert stat("executor_jit_builds") == b0 + 4
    assert exe.cache_info()["compiled"] == 4  # built, not kept
    exe.close()
    assert exe.cache_info() == {"compiled": 0, "entries": []}


def test_appending_an_op_makes_a_new_entry():
    main = tpt.Program()
    with tpt.program_guard(main, tpt.Program()):
        x = tpt.layers.data("x", [4], append_batch_size=False)
        y = tpt.layers.scale(x, scale=2.0)
    exe, scope = tpt.Executor(tpt.CPUPlace()), tpt.Scope()
    a = np.ones(4, "float32")
    exe.run(main, {"x": a}, [y], scope)
    with tpt.program_guard(main, tpt.Program()):
        z = tpt.layers.scale(y, scale=5.0)
    got, = exe.run(main, {"x": a}, [z], scope)
    np.testing.assert_array_equal(got, a * 10)


def _fed_rows(n):
    return {k: v[:n] for k, v in _feed().items()}


def _sigs(exe):
    return [e["signature"] for e in exe.cache_info()["entries"]]


def _net_sig(n):
    return str((("x", (n, 4), "torch.float32"),
                ("y", (n, 1), "torch.float32")))


def test_executor_keeps_max_cached_steps_least_recently_used_first():
    from paddle_tpu_torch.framework.executor import MAX_CACHED_STEPS

    assert MAX_CACHED_STEPS == 4
    exe, main, scope, loss = _started()
    b0 = stat("executor_jit_builds")
    for n in (8, 7, 6, 5, 8):  # the startup entry goes out
        exe.run(main, _fed_rows(n), [loss], scope)
    assert stat("executor_jit_builds") == b0 + 4
    assert _sigs(exe) == [_net_sig(n) for n in (7, 6, 5, 8)]
    exe.run(main, _fed_rows(4), [loss], scope)  # 7 rows go out
    assert _sigs(exe) == [_net_sig(n) for n in (6, 5, 8, 4)]
    exe.run(main, _fed_rows(7), [loss], scope)  # built anew
    assert stat("executor_jit_builds") == b0 + 6
    assert exe.cache_info()["compiled"] == 4


def test_predictor_keeps_max_cached_signatures():
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        x = tpt.layers.data("x", [16])
        y = tpt.layers.fc(x, 4)
    scope = tpt.Scope()
    tpt.Executor(tpt.CPUPlace()).run(startup, scope=scope)
    pred = tpt.inference.Predictor(main, ["x"], [y], scope=scope,
                                   device="cpu")
    feeds = {b: np.random.RandomState(b).rand(b, 16).astype("float32")
             for b in range(1, 6)}
    want = {b: pred.run({"x": f})[0] for b, f in feeds.items()}
    info = pred.cache_info()
    assert info["compiled"] == 4
    assert info["signatures"] == sorted(str((((b, 16), "torch.float32"),))
                                        for b in range(2, 6))
    for b, f in feeds.items():  # batch 1 is built anew, and gives the same
        np.testing.assert_array_equal(pred.run({"x": f})[0], want[b])
    pred.close()


def test_set_flags_rejects_a_flag_the_port_does_not_read():
    """The port registers only the flags it reads: one the reference has
    but the port would ignore raises instead of being taken silently."""
    assert "FLAGS_feed_double_buffer" in jpt.get_flags(
        ["FLAGS_feed_double_buffer"])
    with pytest.raises(ValueError, match="unknown flag"):
        tpt.set_flags({"FLAGS_feed_double_buffer": False})
    with pytest.raises(ValueError, match="unknown flag"):
        tpt.get_flags("FLAGS_compile_cache_dir")
    assert tpt.get_flags(["FLAGS_check_nan_inf", "FLAGS_benchmark",
                          "FLAGS_guard_resolve_interval"]) == {
        "FLAGS_check_nan_inf": False, "FLAGS_benchmark": False,
        "FLAGS_guard_resolve_interval": 64}


def test_flags_benchmark_prints_each_step(capsys):
    exe, main, scope, loss = _started()
    h0 = stat("host_syncs")
    tpt.set_flags({"FLAGS_benchmark": True})
    try:
        exe.run(main, _feed(), [loss], scope)
    finally:
        tpt.set_flags({"FLAGS_benchmark": False})
    assert "[FLAGS_benchmark] step 2:" in capsys.readouterr().out
    assert stat("host_syncs") == h0 + 3  # two fences and the numpy fetch


def test_predictor_one_entry_per_signature_thread_safe():
    """Predictor.run from 8 threads at once, over three batch sizes, gives
    each request what a lone run gives; one entry per signature."""
    import sys
    import threading

    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        x = tpt.layers.data("x", [16])
        y = tpt.layers.fc(tpt.layers.fc(x, 32, act="gelu"), 4)
    scope = tpt.Scope()
    tpt.Executor(tpt.CPUPlace()).run(startup, scope=scope)
    pred = tpt.inference.Predictor(main, ["x"], [y], scope=scope,
                                   device="cpu")
    assert pred.warmup([{"x": (b, 16)} for b in (1, 4)]) == 2
    feeds = [np.random.RandomState(i).rand(b, 16).astype("float32")
             for i, b in enumerate((1, 4, 8) * 4)]
    want = [pred.run({"x": f})[0] for f in feeds]
    got, errors = {}, []

    def worker(k):
        try:
            for i in range(k, len(feeds), 8):
                got[i] = pred.run({"x": feeds[i]})[0]
        except Exception as e:  # reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    for i, w in enumerate(want):
        np.testing.assert_array_equal(got[i], w)
    info = pred.cache_info()
    assert info["compiled"] == 3 and len(info["signatures"]) == 3
    assert set(info["manifests"].values()) == {None}  # nothing captured


# ---------------------------------------------------------------------------
# state in place
# ---------------------------------------------------------------------------

def test_state_is_updated_in_place():
    exe, main, scope, loss = _started()
    names = [v.name for v in main.list_vars() if v.persistable]
    before = {n: scope.find_var(n) for n in names}
    ptrs = {n: t.data_ptr() for n, t in before.items()}
    w = main.all_parameters()[0].name
    w0 = before[w].clone()
    fetched_w = exe.run(main, _feed(), [loss, w], scope)[1]
    for n in names:
        assert scope.find_var(n) is before[n], n
        assert scope.find_var(n).data_ptr() == ptrs[n], n
    assert not torch.equal(scope.find_var(w), w0)  # it did train
    kept = fetched_w.copy()
    exe.run(main, _feed(1), [loss], scope)
    np.testing.assert_array_equal(fetched_w, kept)  # a copy, not the state


@pytest.mark.parametrize("model", ["bert_adam", "llama_adamw"])
def test_in_place_adam_is_the_functional_update_bit_for_bit(model):
    """A guarded run binds Adam's results as new tensors and selects them
    (where(ok, new, old) is exact on a finite step); an unguarded run
    computes them in the state's own storage.  Both give the same bits."""
    main, startup, loss = _bert() if model == "bert_adam" else _llama()
    feeds = ([_bert_feed(s) for s in range(3)] if model == "bert_adam" else
             [{k: np.random.RandomState(s).randint(0, 128, (2, 32)).astype(
                 "int64") for k in ("input_ids", "labels")}
              for s in range(3)])
    params = {}
    for guarded in (False, True):
        exe, scope = tpt.Executor(tpt.CPUPlace()), tpt.Scope()
        t_registry.reset_op_seed()
        exe.run(startup, scope=scope)
        if guarded:
            exe.set_nonfinite_guard(loss, program=main)
        for feed in feeds:
            exe.run(main, feed, [loss], scope)
        params[guarded] = {v.name: scope.find_var(v.name).clone()
                           for v in main.list_vars() if v.persistable}
    assert params[False].keys() == params[True].keys()
    for n, t in params[False].items():
        assert torch.equal(t, params[True][n]), n


@pytest.mark.parametrize("pkg", [jpt, tpt], ids=["jax", "torch"])
def test_a_fed_persistable_that_an_op_rebinds_is_not_written(pkg):
    """Only the scope's own state is updated in place: a persistable fed
    by the caller, which `increment` rebinds, comes back incremented
    while the caller's array is left as it was."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        c = pkg.layers.create_global_var([1], 0.0, "float32",
                                         persistable=True, name="counter")
        pkg.layers.increment(c, 1.0)
    exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
    exe.run(startup, scope=scope)
    fed = np.array([5.0], "float32")
    for _ in range(2):
        got, = exe.run(main, {"counter": fed}, ["counter"], scope)
        np.testing.assert_array_equal(got, [6.0])
        np.testing.assert_array_equal(fed, [5.0])


def test_numpy_scope_values_are_copied_not_written():
    """A scope built from numpy arrays (interop) does not write into them."""
    exe, main, scope, loss = _started()
    arrays = {n: scope.find_var(n).numpy().copy()
              for n in scope.local_var_names()}
    saved = {n: a.copy() for n, a in arrays.items()}
    from paddle_tpu_torch.interop import scope_from_arrays
    carried = scope_from_arrays(arrays, "cpu", program=main)
    exe.run(main, _feed(), [loss], carried)
    for n, a in arrays.items():
        np.testing.assert_array_equal(a, saved[n], err_msg=n)


# ---------------------------------------------------------------------------
# no recompute, dead outputs, one AMP cast
# ---------------------------------------------------------------------------

BERT = dict(batch_size=4, seq_len=32, vocab_size=97, hidden=128,
            num_layers=2, num_heads=2, intermediate=256, max_predictions=5)
EXTRA_WHITE = ["lookup_table", "lookup_table_v2", "layer_norm",
               "elementwise_add", "elementwise_mul", "dropout", "gelu",
               "relu", "scale", "transpose2", "reshape2", "gather_nd",
               "squeeze2", "unsqueeze2", "flash_attention",
               "flash_attention_qkv", "softmax"]


def _bert(amp=False, dropout=0.0):
    tpt.reset_unique_name()
    t_registry.reset_op_seed()
    main, startup = tpt.Program(), tpt.Program()
    startup._is_startup = True
    with tpt.program_guard(main, startup), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        feeds, outs = build_bert_pretrain(dropout=dropout, **BERT)
        o = t_opt.AdamOptimizer(learning_rate=1e-3,
                                grad_clip=tpt.clip.GradientClipByGlobalNorm(
                                    1.0))
        if amp:
            o = t_mp.decorate(o, dtype="bfloat16",
                              amp_lists=t_mp.AutoMixedPrecisionLists(
                                  custom_white_list=EXTRA_WHITE))
        o.minimize(outs["loss"])
    return main, startup, outs["loss"].name


def _bert_feed(seed):
    B, S, V, P = (BERT[k] for k in ("batch_size", "seq_len", "vocab_size",
                                    "max_predictions"))
    rng = np.random.RandomState(seed)
    mask = np.ones((B, S), "float32")
    mask[1, 20:] = 0.0
    return {"input_ids": rng.randint(0, V, (B, S)).astype("int64"),
            "token_type_ids": (rng.rand(B, S) > 0.5).astype("int64"),
            "attn_mask": mask,
            "mlm_positions": rng.randint(0, S, (B, P)).astype("int64"),
            "mlm_labels": rng.randint(0, V, (B, P)).astype("int64"),
            "mlm_weights": np.ones((B, P), "float32")}


def _llama():
    tpt.reset_unique_name()
    t_registry.reset_op_seed()
    main, startup = tpt.Program(), tpt.Program()
    startup._is_startup = True
    with tpt.program_guard(main, startup):
        _, outs = build_llama_train(batch_size=2, seq_len=32, vocab_size=128,
                                    hidden=64, num_layers=2, num_heads=4,
                                    num_kv_heads=2, intermediate=128)
        t_opt.AdamW(learning_rate=1e-3, weight_decay=0.01).minimize(
            outs["loss"])
    return main, startup, outs["loss"].name


@pytest.mark.parametrize("model", ["bert", "llama"])
def test_each_attention_forward_runs_once_a_step(model):
    if model == "bert":
        main, startup, loss = _bert()
        feed, attn, plain = _bert_feed(0), "flash_attention_qkv", \
            fa.flash_attention_packed_reference
    else:
        main, startup, loss = _llama()
        rng = np.random.RandomState(0)
        feed = {"input_ids": rng.randint(0, 128, (2, 32)).astype("int64"),
                "labels": rng.randint(0, 128, (2, 32)).astype("int64")}
        attn, plain = "flash_attention", fa.flash_attention_reference
    n_attn = sum(op.type == attn for op in main.global_block().ops)
    assert n_attn == 2
    exe, scope = tpt.Executor(tpt.CPUPlace()), tpt.Scope()
    exe.run(startup, scope=scope)
    for _ in range(2):  # the entry's first run, then a later one
        c0 = plain.calls
        out = exe.run(main, feed, [loss], scope)
        assert plain.calls - c0 == n_attn
        assert np.isfinite(out[0]).all()


def test_bert_bias_gradient_is_dead_and_changes_nothing(monkeypatch):
    main, startup, loss = _bert()
    bias_grads = {n for op in main.global_block().ops
                  if op.type == "flash_attention_qkv_grad"
                  for n in op.output("Bias@GRAD") if n}
    assert len(bias_grads) == 1  # one bias, shared by both layers
    asked = []
    real = fa.flash_attention_packed_backward

    def spy(*args, need_dbias=True, **kw):
        asked.append(need_dbias)
        return real(*args, need_dbias=need_dbias, **kw)

    monkeypatch.setattr(fa, "flash_attention_packed_backward", spy)
    runs = {}
    for fetch_bias in (False, True):
        exe, scope = tpt.Executor(tpt.CPUPlace()), tpt.Scope()
        t_registry.reset_op_seed()
        exe.run(startup, scope=scope)
        del asked[:]
        losses = [exe.run(main, _bert_feed(s),
                          [loss] + (sorted(bias_grads) if fetch_bias else []),
                          scope)[0] for s in range(3)]
        assert asked == [fetch_bias] * (2 * 3), asked
        entry = next(e for e in exe._cache.values()
                     if loss in e.fetch_names)
        assert bool(bias_grads & entry.dead) is not fetch_bias
        runs[fetch_bias] = (losses, {p.name: scope.find_var(p.name).clone()
                                     for p in main.all_parameters()})
    (l0, p0), (l1, p1) = runs[False], runs[True]
    for a, b in zip(l0, l1):
        np.testing.assert_array_equal(a, b)
    for n in p0:
        assert torch.equal(p0[n], p1[n]), n


def test_one_amp_cast_per_tensor_per_run(monkeypatch):
    main, startup, loss = _bert(amp=True)
    exe, scope = tpt.Executor(tpt.CPUPlace()), tpt.Scope()
    exe.run(startup, scope=scope)
    made, asked = collections.Counter(), collections.Counter()
    real = t_registry._cast

    def cast(ctx, name, v, target):
        hit = ctx.casts.get((name, target))
        out = real(ctx, name, v, target)
        if out is not v:
            asked[(name, target)] += 1
            if hit is None or hit[1] is not out:
                made[(name, target)] += 1
        return out

    monkeypatch.setattr(t_registry, "_cast", cast)
    out = exe.run(main, _bert_feed(0), [loss], scope)
    assert np.isfinite(out[0]).all()
    assert made and max(made.values()) == 1, made.most_common(3)
    # several ops read the same casts: the cache is what keeps it at one
    assert sum(asked.values()) > sum(made.values())


# ---------------------------------------------------------------------------
# card-only: capture and replay
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graph capture)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_capture_then_replay_equals_the_eager_debug_run():
    _card()
    main, startup, loss = _bert()
    exe = tpt.Executor()
    scope = tpt.Scope()
    exe.run(startup, scope=scope)
    dbg_scope = tpt.Scope()
    for n in scope.local_var_names():
        dbg_scope.set_var(n, scope.find_var(n).clone())
    dbg = tpt.Executor()
    got, want = [], []
    for s in range(3):
        got.append(exe.run(main, _bert_feed(s), [loss], scope)[0])
        tpt.set_flags({"FLAGS_check_nan_inf": True})
        want.append(dbg.run(main, _bert_feed(s), [loss], dbg_scope)[0])
        tpt.set_flags({"FLAGS_check_nan_inf": False})
    assert exe.cache_info()["entries"][-1]["aot"]  # steps 2-3 replayed
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for p in main.all_parameters():
        assert torch.equal(scope.find_var(p.name),
                           dbg_scope.find_var(p.name)), p.name
    exe.close()


@pytest.mark.cuda
def test_replayed_step_counts_the_eager_steps_kernels():
    _card()
    main, startup, loss = _bert()
    exe = tpt.Executor()
    scope = tpt.Scope()
    exe.run(startup, scope=scope)
    counts = []
    for s in range(3):  # eager, capture + replay, replay
        before = [getattr(o, a) for o, a in fa.counters()]
        exe.run(main, _bert_feed(s), [loss], scope)
        counts.append([getattr(o, a) - b for (o, a), b in
                       zip(fa.counters(), before)])
    assert counts[0] == counts[1] == counts[2]
    assert counts[0][0] == 2  # the packed forward, once per attention op
    exe.close()


@pytest.mark.cuda
def test_replay_after_the_state_moved_captures_again():
    """A captured step reads the scope's tensors at their addresses: when
    the scope gets a new tensor for a state var, the next run captures
    the step again over it."""
    _card()
    main, startup, loss = _net(tpt)
    exe, scope = tpt.Executor(), tpt.Scope()
    exe.run(startup, scope=scope)
    for _ in range(3):  # eager, capture + replay, replay
        exe.run(main, _feed(), [loss], scope)
    w = main.all_parameters()[0].name
    fresh = torch.zeros_like(scope.find_var(w))
    scope.set_var(w, fresh)
    pred = [op for op in main.global_block().ops if op.type == "mul"][0]
    got, = exe.run(main, _feed(), [pred.output("Out")[0]], scope)
    np.testing.assert_array_equal(got, np.zeros_like(got))
    assert scope.find_var(w) is fresh  # updated in place from here on
    exe.close()


@pytest.mark.cuda
def test_predictor_threads_capture_two_new_signatures_at_once():
    """Two threads send two signatures that were never warmed, so their
    eager first runs and captures meet; every output equals the CPU's
    (fp32, TF32 off: rtol 1e-5, atol 1e-6) and both end captured."""
    import threading

    _card()
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        x = tpt.layers.data("x", [64])
        y = tpt.layers.fc(tpt.layers.fc(x, 256, act="gelu"), 8)
    scope = tpt.Scope()
    tpt.Executor(tpt.CPUPlace()).run(startup, scope=scope)
    cpu = tpt.inference.Predictor(main, ["x"], [y], scope=scope,
                                  device="cpu")
    card = tpt.inference.Predictor(main, ["x"], [y], scope=scope)
    feeds = {b: [np.random.RandomState(10 * b + i).rand(b, 64).astype(
        "float32") for i in range(6)] for b in (3, 5)}
    got, errors = {}, []
    start = threading.Barrier(2)

    def worker(b):
        try:
            start.wait()
            got[b] = [card.run({"x": f})[0] for f in feeds[b]]
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(b,)) for b in feeds]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    for b, fs in feeds.items():
        for f, g in zip(fs, got[b]):
            np.testing.assert_allclose(g, cpu.run({"x": f})[0], rtol=1e-5,
                                       atol=1e-6)
    assert all(m is not None for m in card.cache_info()["manifests"].values())
    card.close()


@pytest.mark.cuda
def test_capture_that_meets_a_host_sync_raises():
    _card()
    from paddle_tpu_torch.ops.registry import _REGISTRY, register_op, set_out

    @register_op("__host_sync_op__", infer=lambda op, block: set_out(
        op, block, "Out", (2,), "float32"))
    def _sync(ctx, op):
        x = ctx.get_input(op, "X")
        ctx.set_output(op, "Out", x * float(x.sum().item()))

    try:
        main = tpt.Program()
        block = main.global_block()
        block.create_var(name="sx", shape=[2], dtype="float32", is_data=True)
        block.create_var(name="sout", shape=[2], dtype="float32")
        block.append_op("__host_sync_op__", inputs={"X": ["sx"]},
                        outputs={"Out": ["sout"]}, attrs={})
        exe = tpt.Executor()
        feed = {"sx": np.ones(2, "float32")}
        got, = exe.run(main, feed, ["sout"], tpt.Scope())  # eager: fine
        np.testing.assert_array_equal(got, [2.0, 2.0])
        with pytest.raises(RuntimeError, match="__host_sync_op__"):
            exe.run(main, feed, ["sout"], tpt.Scope())  # the capture
        exe.close()
    finally:
        _REGISTRY.pop("__host_sync_op__", None)
