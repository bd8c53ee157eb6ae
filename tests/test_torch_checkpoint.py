"""The port's crash-safe checkpoints (paddle_tpu_torch/checkpoint.py) and
its fault injector, on the CPU, with the JAX package alongside.

* Twins of tests/test_fault_tolerance.py's injector, write, retention,
  fault-matrix and corrupt-step tests, run against the port (the
  reference test's ``_net``: fc + square_error_cost + SGD).  The fault
  matrix's resume is bit-equal (tolerance 0) to an uninterrupted run.
* The orbax format: the reference's legacy-orbax test is replaced by
  one that the port names the format and refuses it (never skipped as
  corrupt).
* Parity: a "pkl" checkpoint written by the reference restores in the
  port bit for bit, and the port's restores in the reference bit for
  bit, its MANIFEST.json the reference's own (keys, per-file bytes and
  sha256 that the reference's verify accepts).
* Loading into a live executor writes each scope tensor's own storage
  (same tensor, same data_ptr) after checking every shape and dtype; a
  mismatch raises before anything is written.

The card's half (a checkpoint loaded into an executor that has captured
its step) is in tests/test_torch_checkpoint_cuda.py, which imports no
jax.
"""
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu import checkpoint as j_ckpt
from paddle_tpu_torch import checkpoint as ckpt
from paddle_tpu_torch import fault
from paddle_tpu_torch.monitor import stat_get
from paddle_tpu_torch.train_guard import TrainGuard

from torch_train_util import arrays, copied, feed, net, started


@pytest.fixture(autouse=True)
def _reset_faults():
    fault.reset()
    yield
    fault.reset()
    tpt.set_flags({"FLAGS_fault_inject": ""})


def _trained_once():
    """A program, its loss and weight name, and a CPU executor that ran
    startup and one step into a fresh scope."""
    main, startup, loss, w = net()
    exe, scope = started(main, startup)
    exe.run(main, feed=feed(), fetch_list=[loss], scope=scope)
    return main, startup, loss, w, exe, scope


def _clean_params(main, startup, loss, n_steps, name):
    """Uninterrupted guarded run of n_steps; returns the trained weight."""
    exe, scope = started(main, startup)
    g = TrainGuard(exe, loss, program=main, handle_sigterm=False)
    for _ in range(n_steps):
        g.step(feed(), scope=scope)
    g.close()
    return np.asarray(scope.find_var(name))


# ---------------------------------------------------------------------------
# injector unit behavior
# ---------------------------------------------------------------------------

def test_injector_occurrence_and_sticky_triggers():
    inj = fault.FaultInjector("s:raise@2,t:torn@3+", seed=0)
    assert [inj.fire("s") for _ in range(4)] == \
        [None, "raise", None, None]
    assert [inj.fire("t") for _ in range(5)] == \
        [None, None, "torn", "torn", "torn"]


def test_injector_probabilistic_is_seeded():
    inj1 = fault.FaultInjector("s:raise~0.5", seed=7)
    inj2 = fault.FaultInjector("s:raise~0.5", seed=7)
    s1 = [inj1.fire("s") for _ in range(64)]
    s2 = [inj2.fire("s") for _ in range(64)]
    assert s1 == s2 and 0 < s1.count("raise") < 64


def test_injector_bad_spec_rejected():
    with pytest.raises(ValueError):
        fault.FaultInjector("ckpt_write-raise")


def test_injector_reads_flags():
    tpt.set_flags({"FLAGS_fault_inject": "ckpt_write:raise@1"})
    inj = fault.configure()
    assert inj.fire("ckpt_write") == "raise"
    assert stat_get("fault_ckpt_write_raise") >= 1


# ---------------------------------------------------------------------------
# crash-safe checkpoint writes
# ---------------------------------------------------------------------------

def test_atomic_write_manifest_and_validation(tmp_path):
    d = str(tmp_path)
    main, _, _, _, _, scope = _trained_once()
    before = stat_get("checkpoint_writes")
    path = ckpt.save_checkpoint(d, 5, program=main, scope=scope)
    assert stat_get("checkpoint_writes") == before + 1
    mpath = os.path.join(path, ckpt.MANIFEST)
    assert os.path.isfile(mpath)
    manifest = json.load(open(mpath))
    assert manifest["step"] == 5 and manifest["files"]
    assert manifest["format"] == "pkl"
    for meta in manifest["files"].values():
        assert set(meta) == {"bytes", "sha256"}
    assert ckpt.validate_checkpoint(d, 5)
    assert ckpt.latest_step(d) == 5
    assert not any(n.startswith(".tmp-") for n in os.listdir(d))

    # truncate a payload file: validation must reject, latest must hide it
    files = sorted(manifest["files"])
    victim = os.path.join(path, files[0])
    with open(victim, "r+b") as f:
        f.truncate(max(0, os.path.getsize(victim) // 2))
    assert not ckpt.validate_checkpoint(d, 5)
    assert ckpt.latest_step(d) is None
    assert ckpt.latest_step(d, validate=False) == 5


def test_write_retries_transient_error(tmp_path):
    d = str(tmp_path)
    main, _, _, _, _, scope = _trained_once()
    fault.configure("ckpt_write:raise@1")
    r0, f0 = stat_get("checkpoint_retries"), stat_get("faults_injected")
    ckpt.save_checkpoint(d, 3, program=main, scope=scope)
    assert stat_get("checkpoint_retries") == r0 + 1
    assert stat_get("faults_injected") == f0 + 1
    assert ckpt.validate_checkpoint(d, 3)


def test_write_gives_up_past_retry_budget(tmp_path):
    d = str(tmp_path)
    main, _, _, _, _, scope = _trained_once()
    fault.configure("ckpt_write:raise@1+")
    with pytest.raises(OSError):
        ckpt.save_checkpoint(d, 3, program=main, scope=scope)
    assert os.listdir(d) == []  # failed attempts leave no debris
    assert ckpt.latest_step(d) is None


def test_retention_gc_keeps_newest_valid(tmp_path):
    d = str(tmp_path)
    main, _, _, _, _, scope = _trained_once()
    for s in (1, 2, 3, 4):
        ckpt.save_checkpoint(d, s, program=main, scope=scope)
    g0 = stat_get("checkpoints_gc")
    ckpt.save_checkpoint(d, 5, program=main, scope=scope, keep_last_n=2)
    assert ckpt.valid_steps(d) == [4, 5]
    assert stat_get("checkpoints_gc") == g0 + 3


# ---------------------------------------------------------------------------
# the fault matrix: resume is bit-exact from the last VALID checkpoint
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec,expected_resume", [
    ("ckpt_write:torn@2", 3),       # 2nd write torn -> fall back to step 3
    ("ckpt_write:partial@2", 3),    # manifest-less -> fall back to step 3
    ("ckpt_write:raise@2+", 3),     # storage down from 2nd write on
])
def test_fault_matrix_resume_bitexact(tmp_path, spec, expected_resume):
    d = str(tmp_path / "ck")
    main, startup, loss, w_name = net()

    # life 1: train 7 steps with periodic checkpoints at counter steps 3, 6
    fault.configure(spec)
    skipped0 = stat_get("checkpoint_corrupt_skipped")
    exe, scope = started(main, startup)
    g = TrainGuard(exe, loss, program=main, checkpoint_dir=d,
                   interval_steps=3, keep_last_n=5, handle_sigterm=False)
    assert g.resumed_step is None
    for _ in range(7):
        g.step(feed(), scope=scope)
    g.close()
    fault.reset()
    assert stat_get("faults_injected") > 0
    assert ckpt.latest_step(d) == expected_resume

    # life 2 ("after the crash"): fresh scope + executor, auto-resume
    exe2, s2 = started(main, startup)
    with tpt.scope_guard(s2):
        g2 = TrainGuard(exe2, loss, program=main, checkpoint_dir=d,
                        interval_steps=3, keep_last_n=5,
                        handle_sigterm=False)
        assert g2.resumed_step == expected_resume
        assert exe2._step == expected_resume
        while exe2._step < 8:
            g2.step(feed(), scope=s2)
        g2.close()
    if spec != "ckpt_write:raise@2+":
        # the newer corrupt checkpoint was skipped on the way down
        assert stat_get("checkpoint_corrupt_skipped") > skipped0
    w_resumed = s2.find_var(w_name)
    assert w_resumed is not None

    # uninterrupted comparator: same 7 training steps, no faults
    w_clean = _clean_params(main, startup, loss, 7, w_name)
    np.testing.assert_array_equal(np.asarray(w_resumed), w_clean)


def test_explicit_corrupt_step_raises_before_scope_mutation(tmp_path):
    d = str(tmp_path)
    main, _, _, w_name, _, scope = _trained_once()
    ckpt.save_checkpoint(d, 2, program=main, scope=scope)
    w_before = np.asarray(scope.find_var(w_name)).copy()
    os.remove(os.path.join(d, "2", ckpt.MANIFEST))
    scope.set_var(w_name, torch.from_numpy(w_before + 1.0))
    with pytest.raises(ckpt.CheckpointCorrupt):
        ckpt.load_checkpoint(d, 2, program=main, scope=scope)
    # the half-restore guard: scope untouched by the failed load
    np.testing.assert_array_equal(np.asarray(scope.find_var(w_name)),
                                  w_before + 1.0)


# ---------------------------------------------------------------------------
# the orbax format: named and refused, never skipped as corrupt
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["manifest", "legacy"])
def test_orbax_checkpoint_is_refused_by_name(tmp_path, layout):
    """The reference writes orbax by default (and wrote it without a
    manifest before PR 1's layout).  The port cannot read it without jax:
    loading raises UnsupportedCheckpointFormat naming 'orbax', and a
    resume stops there instead of falling back to the older pkl step."""
    d = str(tmp_path)
    main, startup, loss, w_name = net(jpt)
    j_scope = jpt.Scope()
    jpt.Executor().run(startup, scope=j_scope)
    j_ckpt.save_checkpoint(d, 1, program=main, scope=j_scope,
                           use_orbax=False)
    if layout == "manifest":
        j_ckpt.save_checkpoint(d, 2, program=main, scope=j_scope)
        assert json.load(open(os.path.join(d, "2", ckpt.MANIFEST)))[
            "format"] == "orbax"
    else:
        import orbax.checkpoint as ocp
        ocp.PyTreeCheckpointer().save(
            os.path.abspath(os.path.join(d, "2")),
            {w_name: np.asarray(j_scope.find_var(w_name))}, force=True)
    t_main, t_startup, _, _ = net()
    exe, scope = started(t_main, t_startup)
    w0 = scope.find_var(w_name).clone()
    skipped0 = stat_get("checkpoint_corrupt_skipped")
    with pytest.raises(ckpt.UnsupportedCheckpointFormat, match="orbax"):
        ckpt.load_checkpoint(d, 2, program=t_main, scope=scope)
    with pytest.raises(ckpt.UnsupportedCheckpointFormat, match="orbax"):
        ckpt.restore_latest(d, program=t_main, scope=scope)
    assert stat_get("checkpoint_corrupt_skipped") == skipped0
    assert torch.equal(scope.find_var(w_name), w0)
    # the pkl step beside it still loads
    ckpt.load_checkpoint(d, 1, program=t_main, scope=scope)


# ---------------------------------------------------------------------------
# parity: each package restores the other's checkpoints, bit for bit
# ---------------------------------------------------------------------------

def _trained_reference(steps=3):
    main, startup, loss, _ = net(jpt)
    scope = jpt.Scope()
    exe = jpt.Executor()
    exe.run(startup, scope=scope)
    for i in range(steps):
        exe.run(main, feed=feed(i), fetch_list=[loss], scope=scope)
    return main, scope


def test_reference_checkpoint_restores_bit_equal_in_the_port(tmp_path):
    d = str(tmp_path)
    j_main, j_scope = _trained_reference()
    j_ckpt.save_checkpoint(d, 4, program=j_main, scope=j_scope,
                           use_orbax=False)
    want = arrays(j_scope, j_main)
    assert ckpt.valid_steps(d) == [4]
    ckpt.verify_checkpoint(d, 4)  # the port reads the reference manifest
    t_main, t_startup, _, _ = net()
    exe, scope = started(t_main, t_startup)
    held = {n: scope.find_var(n) for n in want}
    step, _ = ckpt.restore_latest(d, program=t_main, scope=scope)
    assert step == 4
    for n, a in want.items():
        got = scope.find_var(n)
        assert got is held[n]  # written in place
        np.testing.assert_array_equal(got.numpy(), a)


def test_port_checkpoint_restores_bit_equal_in_the_reference(tmp_path):
    d = str(tmp_path)
    main, startup, loss, _ = net()
    exe, scope = started(main, startup)
    for i in range(3):
        exe.run(main, feed=feed(i), fetch_list=[loss], scope=scope)
    ckpt.save_checkpoint(d, 4, program=main, scope=scope,
                         extra_state={"epoch": 2})
    want = arrays(scope, main)
    # the manifest is the reference's own: its verify accepts it
    manifest = j_ckpt.verify_checkpoint(d, 4)
    assert set(manifest) == {"step", "format", "files", "time"}
    assert manifest["format"] == "pkl" and list(manifest["files"]) == \
        ["state.pkl"]
    j_main, j_startup, _, _ = net(jpt)
    j_scope = jpt.Scope()
    jpt.Executor().run(j_startup, scope=j_scope)
    extra = j_ckpt.load_checkpoint(d, 4, program=j_main, scope=j_scope)
    assert int(extra["epoch"]) == 2
    for n, a in want.items():
        np.testing.assert_array_equal(np.asarray(j_scope.find_var(n)), a)


def test_bf16_state_goes_out_as_ml_dtypes_and_comes_back(tmp_path):
    import ml_dtypes

    d = str(tmp_path)
    main, startup, _, w_name = net()
    exe, scope = started(main, startup)
    w = scope.find_var(w_name)
    scope.set_var(w_name, w.to(torch.bfloat16))
    ckpt.save_checkpoint(d, 1, program=main, scope=scope)
    state = ckpt._load_state(d, 1)
    assert state[w_name].dtype == ml_dtypes.bfloat16
    held = scope.find_var(w_name)
    want = held.clone()
    held.zero_()
    ckpt.load_checkpoint(d, 1, program=main, scope=scope)
    assert scope.find_var(w_name) is held and torch.equal(held, want)


# ---------------------------------------------------------------------------
# loading into a live executor
# ---------------------------------------------------------------------------

def test_load_writes_each_tensor_in_place_and_the_next_run_reads_it(
        tmp_path):
    d = str(tmp_path)
    main, startup, loss, w_name = net()
    exe, scope = started(main, startup)
    names = [v.name for v in main.list_vars() if v.persistable]
    start = copied(scope, names)
    exe.run(main, feed=feed(), fetch_list=[loss], scope=scope)
    ckpt.save_checkpoint(d, 2, program=main, scope=start)
    ptrs = {n: scope.find_var(n).data_ptr() for n in names}
    ckpt.load_checkpoint(d, 2, program=main, scope=scope)
    assert {n: scope.find_var(n).data_ptr() for n in names} == ptrs
    # the next run starts from the loaded (startup) weights
    got = exe.run(main, feed=feed(), fetch_list=[loss], scope=scope)
    want = started(main, startup)[0].run(main, feed=feed(),
                                         fetch_list=[loss], scope=start)
    np.testing.assert_array_equal(got[0], want[0])


def test_a_misshapen_value_raises_before_any_write(tmp_path):
    """Every value is checked against the scope before any is written: a
    scope whose weight has another shape keeps every other variable as
    it was, whatever order the checkpoint lists them in."""
    d = str(tmp_path)
    main, startup, loss, w_name = net()
    exe, scope = started(main, startup)
    ckpt.save_checkpoint(d, 1, program=main, scope=scope)
    names = sorted(arrays(scope, main))
    other = tpt.Scope()
    for n in names:
        other.set_var(n, torch.zeros_like(scope.find_var(n)))
    other.set_var(w_name, torch.zeros(4, 2))
    with pytest.raises(ValueError, match="no variable was restored"):
        ckpt.load_checkpoint(d, 1, program=main, scope=other)
    for n in names:
        assert not other.find_var(n).any(), n
