"""The port's TrainGuard (paddle_tpu_torch/train_guard.py) on the CPU,
with the JAX package alongside.

* Twins of tests/test_fault_tolerance.py's guard tests (NaN skip and the
  scaler backoff, an eval program's NaN, close, the guard without a
  fetch, SIGTERM -> final checkpoint -> bit-exact resume, the deferred
  guard's interval and backoff), of tests/test_async_executor.py:50-130
  (a guarded async run of 50 steps pays O(1) host syncs; verdicts land
  late with their original step ids) and of tests/test_observatory.py's
  guard tests (the trace artifact with its HBM counter track, SIGUSR2's
  capture).  The scaler is the JAX package's GradScaler: TrainGuard
  needs only its ``backoff_on_nonfinite`` (the port's own waits for the
  dygraph slice).  Weights are compared bit for bit (tolerance 0).
* Parity: a guarded 7-step run of the reference test's ``_net`` with
  ``loss:nan@3`` through both packages from one copied startup scope:
  the same skipped step, weights within 1e-6 absolute (fp32).
* Randomness keyed by the run count: a dropout-0.5 program trained 8
  steps uninterrupted equals, bit for bit, one stopped by a SIGTERM at
  its 4th step and resumed in a fresh executor and scope; and a fresh
  executor whose first run is run r draws run r's mask.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu import fault as j_fault
from paddle_tpu.train_guard import TrainGuard as JTrainGuard
from paddle_tpu_torch import checkpoint as ckpt
from paddle_tpu_torch import fault, observatory, telemetry
from paddle_tpu_torch.monitor import stat_get
from paddle_tpu_torch.train_guard import TrainGuard, TrainingInterrupted

from torch_train_util import arrays, copied, feed, net, started

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _reset():
    fault.reset()
    yield
    fault.reset()
    tpt.set_flags({"FLAGS_fault_inject": "",
                   "FLAGS_guard_resolve_interval": 64,
                   "FLAGS_metrics_dir": "", "FLAGS_metrics_interval": 10.0,
                   "FLAGS_hbm_sample_interval": 0.25,
                   "FLAGS_profilez_sec": 2.0})


def _scaler():
    return jpt.amp.GradScaler(enable=True, init_loss_scaling=8.0,
                              decr_every_n_nan_or_inf=1)


def _clean_params(main, startup, loss, n_steps, name):
    """Uninterrupted guarded run of n_steps; returns the trained weight."""
    exe, scope = started(main, startup)
    g = TrainGuard(exe, loss, program=main, handle_sigterm=False)
    for _ in range(n_steps):
        g.step(feed(), scope=scope)
    g.close()
    return np.asarray(scope.find_var(name))


# ---------------------------------------------------------------------------
# twins of tests/test_fault_tolerance.py
# ---------------------------------------------------------------------------

def test_nan_loss_skips_step_and_backs_off_scaler():
    main, startup, loss, w_name = net()
    fault.configure("loss:nan@3")
    scaler = _scaler()
    seen = []
    exe, scope = started(main, startup)
    sk0 = stat_get("skipped_nonfinite_steps")
    g = TrainGuard(exe, loss, program=main, scaler=scaler,
                   on_nonfinite=seen.append, handle_sigterm=False)
    outs = [g.step(feed(), fetch_list=[loss], scope=scope)[0]
            for _ in range(5)]
    g.close()
    assert stat_get("skipped_nonfinite_steps") == sk0 + 1
    assert stat_get("fault_loss_nan") >= 1
    assert g.skipped_steps == 1 and seen == [4]  # counter: startup was 1
    assert not np.isfinite(outs[2]).all()        # the poisoned fetch
    assert all(np.isfinite(o).all() for i, o in enumerate(outs) if i != 2)
    assert scaler.get_scale() == 4.0             # 8.0 * decr_ratio 0.5
    # params match a clean run with the skipped update left out entirely
    w_clean = _clean_params(main, startup, loss, 4, w_name)
    np.testing.assert_array_equal(np.asarray(scope.find_var(w_name)),
                                  w_clean)


def test_eval_program_nan_does_not_trigger_skip():
    """An interleaved eval run (program clone carrying the same loss var)
    must not count as a skipped step or back off the loss scale."""
    main, startup, loss, _ = net()
    test_prog = main.clone(for_test=True)
    scaler = _scaler()
    exe, scope = started(main, startup)
    g = TrainGuard(exe, loss, program=main, scaler=scaler,
                   handle_sigterm=False)
    g.step(feed(), fetch_list=[loss], scope=scope)
    sk0 = stat_get("skipped_nonfinite_steps")
    out = exe.run(test_prog, feed=feed(nan=True), fetch_list=[loss.name],
                  scope=scope)
    assert not np.isfinite(out[0]).all()
    assert stat_get("skipped_nonfinite_steps") == sk0
    assert g.skipped_steps == 0 and scaler.get_scale() == 8.0
    g.close()


def test_close_uninstalls_auto_checkpoint(tmp_path):
    d = str(tmp_path / "ck")
    main, startup, loss, _ = net()
    exe, scope = started(main, startup)
    g = TrainGuard(exe, loss, program=main, checkpoint_dir=d,
                   interval_steps=1, handle_sigterm=False)
    g.step(feed(), scope=scope)
    assert ckpt.latest_step(d) is not None
    g.close()
    n = len(ckpt.valid_steps(d))
    exe.run(main, feed=feed(), fetch_list=[loss], scope=scope)
    assert len(ckpt.valid_steps(d)) == n  # post-close run: no more writes
    assert exe._auto_ckpt is None


def test_guard_active_without_fetching_loss():
    """The skip-step guard keys on the program producing the loss, not on
    the caller fetching it: a bare step(feed) is still protected."""
    main, startup, loss, w_name = net()
    fault.configure("loss:nan@2")
    exe, scope = started(main, startup)
    g = TrainGuard(exe, loss, program=main, handle_sigterm=False)
    for _ in range(3):
        out = g.step(feed(), scope=scope)  # no fetch_list at all
        assert out == []                   # caller's (empty) list honored
    g.close()
    assert g.skipped_steps == 1
    w_clean = _clean_params(main, startup, loss, 2, w_name)
    np.testing.assert_array_equal(np.asarray(scope.find_var(w_name)),
                                  w_clean)


def test_sigterm_writes_final_checkpoint_and_resumes_bitexact(tmp_path):
    d = str(tmp_path / "ck")
    main, startup, loss, w_name = net()
    fault.configure("step:sigterm@4")
    sig0 = stat_get("sigterm_received")
    fin0 = stat_get("checkpoint_final")

    exe, scope = started(main, startup)
    g = TrainGuard(exe, loss, program=main, checkpoint_dir=d,
                   interval_steps=100)
    with pytest.raises(TrainingInterrupted) as ei:
        for _ in range(7):
            g.step(feed(), scope=scope)
    g.close()
    fault.reset()
    assert ei.value.code == 0                       # clean exit contract
    assert stat_get("sigterm_received") == sig0 + 1
    assert stat_get("checkpoint_final") == fin0 + 1
    assert stat_get("fault_step_sigterm") >= 1
    # 4 training runs happened (counter 2..5); final checkpoint at 5
    assert ckpt.latest_step(d) == 5
    assert ckpt.validate_checkpoint(d, 5)
    assert telemetry.metrics.gauge("sigterm_to_exit_ms").get() >= 0

    # preempted worker restarts: resume and finish the remaining steps
    exe2, s2 = started(main, startup)
    with tpt.scope_guard(s2):
        g2 = TrainGuard(exe2, loss, program=main, checkpoint_dir=d,
                        interval_steps=100, handle_sigterm=False)
        assert g2.resumed_step == 5
        while exe2._step < 8:
            g2.step(feed(), scope=s2)
        g2.close()
    w_clean = _clean_params(main, startup, loss, 7, w_name)
    np.testing.assert_array_equal(np.asarray(s2.find_var(w_name)), w_clean)


def test_deferred_guard_interval_bitexact_resume(tmp_path):
    """``loss:nan@3`` with FLAGS_guard_resolve_interval=8 and fetch-free
    async steps: the verdict resolves in deferred batches (at checkpoints
    / close), yet the skip count is exact, the callback gets the ORIGINAL
    step id, and crash + resume stays bit-exact."""
    d = str(tmp_path / "ck")
    main, startup, loss, w_name = net()
    tpt.set_flags({"FLAGS_guard_resolve_interval": 8})
    fault.configure("loss:nan@3")
    sk0 = stat_get("skipped_nonfinite_steps")
    seen = []
    exe, scope = started(main, startup)
    g = TrainGuard(exe, loss, program=main, checkpoint_dir=d,
                   interval_steps=3, keep_last_n=5, handle_sigterm=False,
                   on_nonfinite=seen.append)
    for _ in range(7):          # counter steps 2..8, nan at 4
        g.step_async(feed(), scope=scope)
    g.close()
    fault.reset()
    assert stat_get("skipped_nonfinite_steps") == sk0 + 1
    assert g.skipped_steps == 1 and seen == [4]
    assert ckpt.latest_step(d) == 6

    # life 2 (after the crash): resume at 6, finish steps 7..8
    exe2, s2 = started(main, startup)
    with tpt.scope_guard(s2):
        g2 = TrainGuard(exe2, loss, program=main, checkpoint_dir=d,
                        interval_steps=3, keep_last_n=5,
                        handle_sigterm=False)
        assert g2.resumed_step == 6
        while exe2._step < 8:
            g2.step_async(feed(), scope=s2)
        g2.close()
    # identical feed every step, so 7 guarded steps with one skip == 6
    # clean steps, bit-exact
    w_clean = _clean_params(main, startup, loss, 6, w_name)
    np.testing.assert_array_equal(np.asarray(s2.find_var(w_name)), w_clean)


def test_deferred_guard_scaler_backoff_on_resolution():
    """The scaler's backoff fires at RESOLUTION time (not dispatch) and
    records the original non-finite step id."""
    main, startup, loss, _ = net()
    fault.configure("loss:nan@2")
    scaler = _scaler()
    exe, scope = started(main, startup)
    g = TrainGuard(exe, loss, program=main, scaler=scaler,
                   handle_sigterm=False)
    tpt.set_flags({"FLAGS_guard_resolve_interval": 0})
    for _ in range(4):          # counter steps 2..5, nan at 3
        g.step_async(feed(), scope=scope)
    assert scaler.get_scale() == 8.0       # verdict still pending
    exe.resolve_nonfinite_guard()
    assert scaler.get_scale() == 4.0       # backoff landed
    assert scaler.last_nonfinite_step == 3
    g.close()


def test_sigterm_handler_needs_the_main_thread():
    """Off the main thread no handler can be installed: the guard counts
    train_guard_no_sigterm and still guards."""
    main, startup, loss, _ = net()
    exe, scope = started(main, startup)
    n0 = stat_get("train_guard_no_sigterm")
    box = {}

    def make():
        box["g"] = TrainGuard(exe, loss, program=main)

    t = threading.Thread(target=make)
    t.start()
    t.join(30)
    assert not t.is_alive()
    g = box["g"]
    assert stat_get("train_guard_no_sigterm") == n0 + 1
    assert not g._sigterm_installed and not g._sigusr2_installed
    fault.configure("loss:nan@1")
    g.step(feed(), fetch_list=[loss], scope=scope)
    g.close()
    assert g.skipped_steps == 1


# ---------------------------------------------------------------------------
# twins of tests/test_async_executor.py:50-130 (TrainGuard's async path)
# ---------------------------------------------------------------------------

def test_run_async_guarded_50_steps_o1_host_syncs():
    main, startup, loss, _ = net()
    exe, scope = started(main, startup)
    g = TrainGuard(exe, loss, program=main, handle_sigterm=False)
    g.step_async(feed(), fetch_list=[loss], scope=scope)
    exe.sync()

    h0 = stat_get("host_syncs")
    res = None
    for _ in range(50):
        res = g.step_async(feed(), fetch_list=[loss], scope=scope)
    dispatched = stat_get("host_syncs") - h0
    assert dispatched == 0, \
        f"async dispatch paid {dispatched} host syncs over 50 steps"
    out = res.sync()  # one fence + one guard resolution + one fetch read
    total = stat_get("host_syncs") - h0
    assert total <= 4, f"O(1) expected after sync, got {total}"
    assert np.isfinite(out[0]).all()
    g.close()


def test_sync_run_unchanged_semantics():
    """return_numpy=True keeps blocking-numpy semantics and resolves the
    guard at the fetch read."""
    main, startup, loss, _ = net()
    exe, scope = started(main, startup)
    g = TrainGuard(exe, loss, program=main, handle_sigterm=False)
    out = g.step(feed(), fetch_list=[loss], scope=scope)
    assert isinstance(out[0], np.ndarray)
    assert not exe._pending_guard  # resolved by the fetch read
    g.close()


def test_deferred_guard_callback_gets_original_step():
    main, startup, loss, _ = net()
    exe, scope = started(main, startup)
    seen = []
    g = TrainGuard(exe, loss, program=main, on_nonfinite=seen.append,
                   handle_sigterm=False)
    tpt.set_flags({"FLAGS_guard_resolve_interval": 0})  # defer to close
    sk0 = stat_get("skipped_nonfinite_steps")
    for i in range(6):
        g.step_async(feed(nan=(i == 2)), scope=scope)  # step 4 is NaN
    assert seen == []                       # nothing resolved yet
    assert len(exe._pending_guard) == 6
    g.close()                               # close() resolves + fires
    assert seen == [4]
    assert stat_get("skipped_nonfinite_steps") == sk0 + 1
    assert g.skipped_steps == 1


def test_guard_resolve_interval_batches():
    main, startup, loss, _ = net()
    exe, scope = started(main, startup)
    g = TrainGuard(exe, loss, program=main, handle_sigterm=False)
    tpt.set_flags({"FLAGS_guard_resolve_interval": 4})
    r0 = stat_get("guard_resolutions")
    for _ in range(8):                      # no fetches -> interval rules
        g.step_async(feed(), scope=scope)
    assert stat_get("guard_resolutions") == r0 + 2
    assert len(exe._pending_guard) == 0
    g.close()


def test_fetch_read_resolves_guard_up_to_its_step():
    main, startup, loss, _ = net()
    exe, scope = started(main, startup)
    g = TrainGuard(exe, loss, program=main, handle_sigterm=False)
    tpt.set_flags({"FLAGS_guard_resolve_interval": 0})
    r1 = g.step_async(feed(), fetch_list=[loss], scope=scope)
    r2 = g.step_async(feed(), fetch_list=[loss], scope=scope)
    g.step_async(feed(), fetch_list=[loss], scope=scope)
    assert len(exe._pending_guard) == 3
    r2[0].numpy()                           # reading step N resolves <= N
    assert len(exe._pending_guard) == 1
    r1[0].numpy()                           # older handle: nothing left
    assert len(exe._pending_guard) == 1
    g.close()


# ---------------------------------------------------------------------------
# twins of tests/test_observatory.py:206, 346
# ---------------------------------------------------------------------------

def test_trace_artifact_carries_hbm_track_alongside_spans(tmp_path,
                                                          monkeypatch):
    """A 20-step guarded run whose trace shows the HBM counter track next
    to the executor's spans.  The CPU has no card: the sampler reads a
    stand-in of the cards' allocated bytes."""
    mdir = str(tmp_path / "metrics")
    tpt.set_flags({"FLAGS_metrics_dir": mdir,
                   "FLAGS_metrics_interval": 0.0,
                   "FLAGS_hbm_sample_interval": 0.01})
    monkeypatch.setattr(observatory, "device_live_bytes",
                        lambda: {"total": 1 << 20, "per_device": {0: 1 << 20}})
    main, startup, loss, _ = net()
    exe, scope = started(main, startup)
    g = TrainGuard(exe, loss, program=main,
                   checkpoint_dir=str(tmp_path / "ckpts"),
                   interval_steps=10, handle_sigterm=False)
    try:
        for i in range(20):
            g.step(feed(i), fetch_list=[loss], scope=scope)
    finally:
        g.close()
    telemetry.flush()
    with open(os.path.join(mdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events}
    assert "executor/step" in names and "executor/dispatch" in names
    counters = [e for e in events
                if e["ph"] == "C" and e["name"] == "hbm_live_bytes"]
    assert counters, "no HBM counter track in the trace export"
    assert all(e["args"]["total"] > 0 for e in counters)
    out = str(tmp_path / "merged.json")
    r = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.trace_export",
         mdir, out], capture_output=True, text=True, timeout=120, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    with open(out) as f:
        merged = json.load(f)["traceEvents"]
    assert any(e["ph"] == "C" and e["name"] == "hbm_live_bytes"
               for e in merged)


def test_trainguard_sigusr2_capture(tmp_path):
    mdir = str(tmp_path / "metrics")
    tpt.set_flags({"FLAGS_metrics_dir": mdir, "FLAGS_profilez_sec": 0.1})
    main, startup, loss, _ = net()
    exe, scope = started(main, startup)
    g = TrainGuard(exe, loss, program=main, handle_sigterm=True)
    try:
        assert signal.getsignal(signal.SIGUSR2) == g._on_sigusr2
        os.kill(os.getpid(), signal.SIGUSR2)  # delivered synchronously
        g.step(feed(0), fetch_list=[loss], scope=scope)  # training goes on
        deadline = time.monotonic() + 15.0
        prof_root = os.path.join(mdir, "profiles")
        done = False
        while time.monotonic() < deadline and not done:
            done = not observatory._capture_active[0] and \
                os.path.isdir(prof_root) and any(
                    files for _, _, files in os.walk(prof_root))
            time.sleep(0.05)
        assert done, "SIGUSR2 capture artifact never appeared"
    finally:
        g.close()
    assert signal.getsignal(signal.SIGUSR2) in (signal.SIG_DFL,
                                                signal.Handlers.SIG_DFL)


# ---------------------------------------------------------------------------
# parity with the reference TrainGuard
# ---------------------------------------------------------------------------

def test_guarded_run_matches_the_reference_within_1e6():
    """7 guarded steps of the reference test's _net with loss:nan@3 in
    each package from one startup scope (the reference's, copied): the
    same skipped step, every weight within 1e-6 absolute (fp32)."""
    j_main, j_startup, j_loss, _ = net(jpt)
    t_main, _, t_loss, _ = net()
    j_scope = jpt.Scope()
    jpt.Executor().run(j_startup, scope=j_scope)
    start = arrays(j_scope, j_main)
    t_scope = tpt.Scope()
    for n, a in start.items():
        t_scope.set_var(n, torch.from_numpy(a.copy()))

    j_fault.configure("loss:nan@3")
    try:
        j_exe = jpt.Executor()
        j_seen = []
        jg = JTrainGuard(j_exe, j_loss, program=j_main,
                         on_nonfinite=j_seen.append, handle_sigterm=False)
        for i in range(7):
            jg.step(feed(i), fetch_list=[j_loss], scope=j_scope)
        jg.close()
    finally:
        j_fault.reset()

    fault.configure("loss:nan@3")
    t_exe = tpt.Executor(tpt.CPUPlace())
    t_seen = []
    tg = TrainGuard(t_exe, t_loss, program=t_main,
                    on_nonfinite=t_seen.append, handle_sigterm=False)
    for i in range(7):
        tg.step(feed(i), fetch_list=[t_loss], scope=t_scope)
    tg.close()
    assert t_seen == j_seen == [3]
    got, want = arrays(t_scope, t_main), arrays(j_scope, j_main)
    assert sorted(got) == sorted(want)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=0, atol=1e-6,
                                   err_msg=n)


# ---------------------------------------------------------------------------
# randomness keyed by the run count
# ---------------------------------------------------------------------------

def test_dropout_training_resumed_after_sigterm_is_bit_equal(tmp_path):
    """Dropout 0.5: 8 steps uninterrupted against a SIGTERM at the 4th
    step, its final checkpoint and a resume in a fresh executor and
    scope that runs to the same count.  The resumed run draws the masks
    the uninterrupted one drew at the same runs, so every persistable is
    bit-equal."""
    d = str(tmp_path / "ck")
    main, startup, loss, _ = net(dropout=0.5)
    exe0, scope0 = started(main, startup)
    names = [v.name for v in main.list_vars() if v.persistable]
    start = copied(scope0, names)

    exe_a, scope_a = tpt.Executor(tpt.CPUPlace()), copied(start, names)
    exe_a._step = 1  # startup was run 1
    ga = TrainGuard(exe_a, loss, program=main, handle_sigterm=False)
    losses_a = [ga.step(feed(i), fetch_list=[loss], scope=scope_a)[0]
                for i in range(8)]
    ga.close()

    fault.configure("step:sigterm@4")
    exe_b, scope_b = tpt.Executor(tpt.CPUPlace()), copied(start, names)
    exe_b._step = 1
    gb = TrainGuard(exe_b, loss, program=main, checkpoint_dir=d)
    with pytest.raises(TrainingInterrupted):
        for i in range(8):
            gb.step(feed(i), fetch_list=[loss], scope=scope_b)
    gb.close()
    fault.reset()
    assert ckpt.latest_step(d) == 5

    exe_c, scope_c = tpt.Executor(tpt.CPUPlace()), copied(start, names)
    with tpt.scope_guard(scope_c):
        gc = TrainGuard(exe_c, loss, program=main, checkpoint_dir=d,
                        handle_sigterm=False)
    assert gc.resumed_step == 5
    losses_c = []
    while exe_c._step < 9:
        i = exe_c._step - 1
        losses_c.append(gc.step(feed(i), fetch_list=[loss],
                                scope=scope_c)[0])
    gc.close()
    np.testing.assert_array_equal(np.stack(losses_c),
                                  np.stack(losses_a[4:]))
    got, want = arrays(scope_c, main), arrays(scope_a, main)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)


def test_a_fresh_executor_draws_the_masks_of_its_run_count():
    """An executor whose first run is run r draws run r's dropout mask,
    whatever run its entry first ran at elsewhere."""
    tpt.reset_unique_name()
    main, startup = tpt.Program(), tpt.Program()
    startup._is_startup = True
    with tpt.program_guard(main, startup):
        x = tpt.layers.data("x", [256])
        out = tpt.layers.dropout(x, dropout_prob=0.5)
    ones = {"x": np.ones((4, 256), "float32")}
    exe = tpt.Executor(tpt.CPUPlace())
    exe.run(startup, scope=tpt.Scope())
    masks = [exe.run(main, feed=ones, fetch_list=[out])[0]
             for _ in range(5)]   # runs 2..6
    for r in (2, 4, 6):
        fresh = tpt.Executor(tpt.CPUPlace())
        fresh._step = r - 1
        got = fresh.run(main, feed=ones, fetch_list=[out])[0]
        np.testing.assert_array_equal(got, masks[r - 2])
    assert not np.array_equal(masks[0], masks[1])
