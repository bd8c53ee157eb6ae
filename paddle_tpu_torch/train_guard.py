"""Robust training run-loop wrapper: non-finite skip-step, SIGTERM →
final checkpoint + clean exit, auto-resume from the newest valid
checkpoint.

The port's copy of ``paddle_tpu/train_guard.py``: the same contract,
fault sites, stats, gauges, spans and events.  The executor's
non-finite guard selects the *old* state on the device when the loss is
not finite (inside the captured step on the card), so a poisoned batch
skips its update instead of corrupting the parameters; its verdicts
resolve on the host lazily and fire the skip bookkeeping with the
original step id.  The resume restores into the scope's own tensors and
sets the run count, so a resumed run draws the randomness of the run it
resumes (``framework/executor.py``) and ends bit-equal to a run that was
never interrupted.

Typical use::

    guard = TrainGuard(exe, loss, checkpoint_dir="ckpts",
                       interval_steps=500, keep_last_n=3)
    try:
        for batch in data:
            guard.step(batch, fetch_list=[loss])
    except TrainingInterrupted:
        pass   # SIGTERM: final checkpoint already written, exit 0

Telemetry (telemetry.py): a ``train_guard/resume`` span plus
``train_guard_resume_ms`` gauge time the construction-time restore,
``train_guard_restart_count`` gauge republishes
``PADDLE_TPU_RESTART_COUNT``, ``sigterm_to_exit_ms`` gauge records
SIGTERM-to-TrainingInterrupted latency, every step drives the periodic
exporter flush, and resume / guard-skip / SIGTERM / final-checkpoint
transitions land in the JSONL event log (events ``resume``,
``guard_skip``, ``sigterm``, ``final_checkpoint``).  SIGUSR2 starts a
``torch.profiler`` capture (observatory.py) without pausing the loop.
"""
from __future__ import annotations

import inspect
import logging
import os
import signal
import time
from typing import Callable, Optional

import numpy as np

from . import fault
from . import observatory
from . import telemetry
from .monitor import stat_add

__all__ = ["TrainGuard", "TrainingInterrupted"]

logger = logging.getLogger("paddle_tpu_torch.train_guard")


class TrainingInterrupted(SystemExit):
    """Raised by TrainGuard.step after a SIGTERM once the final checkpoint
    is written.  Subclasses SystemExit with code 0, so an unhandled
    interrupt still exits the worker cleanly (no launcher restart)."""

    def __init__(self, step: int):
        super().__init__(0)
        self.step = step


def _poison_nonfinite(feed):
    """Injected 'loss: nan' fault: NaN out every float feed so the lowered
    loss goes non-finite in the step (exercises the real skip-step
    path)."""
    out = {}
    for k, v in feed.items():
        arr = np.asarray(v)
        if np.issubdtype(arr.dtype, np.floating):
            arr = np.full_like(arr, np.nan)
        out[k] = arr
    return out


class TrainGuard:
    """Wraps an Executor's run loop with the fault-tolerance contract.

    * auto-resume: on construction, restore the newest *valid* checkpoint
      from `checkpoint_dir` (``resumed_step`` records it)
    * skip-step: runs the step with the executor's non-finite guard on
      `loss`; skipped steps bump ``skipped_nonfinite_steps``, back off the
      AMP loss scale (``scaler.backoff_on_nonfinite``) and invoke
      `on_nonfinite(step)`
    * preemption: SIGTERM finishes the in-flight step, writes a final
      checkpoint, and raises :class:`TrainingInterrupted` (exit code 0)
    """

    def __init__(self, executor, loss, checkpoint_dir: Optional[str] = None,
                 program=None, interval_steps: int = 100,
                 keep_last_n: int = 3, scaler=None,
                 on_nonfinite: Optional[Callable[[int], None]] = None,
                 handle_sigterm: bool = True):
        from .framework.core import default_main_program

        self.exe = executor
        self.program = program or default_main_program()
        self.loss_name = loss if isinstance(loss, str) else loss.name
        self.scaler = scaler
        self.on_nonfinite = on_nonfinite
        self.skipped_steps = 0
        # dispatch-time watermark of the last scaler backoff: a skipped
        # step only compounds the backoff if it was DISPATCHED after the
        # previous backoff landed (i.e. it overflowed at the reduced
        # scale).  With the deferred guard, a whole batch of verdicts
        # from one overflow episode resolves at once — steps in flight
        # never saw the backoff, so they must not multiply it
        # (decr_ratio^interval would collapse the scale to ~0).
        self._backoff_watermark = -1
        self.resumed_step: Optional[int] = None
        self.stop_requested = False
        self._finalized = False
        self._ckpt_dir = checkpoint_dir
        self._keep_last_n = keep_last_n
        self._sigterm_at: Optional[float] = None
        restarts = int(os.environ.get("PADDLE_TPU_RESTART_COUNT", "0") or 0)
        telemetry.gauge_set("train_guard_restart_count", restarts)
        if checkpoint_dir:
            t0 = time.monotonic()
            with telemetry.trace_span("train_guard/resume",
                                      dir=checkpoint_dir):
                self.resumed_step = executor.enable_auto_checkpoint(
                    checkpoint_dir, interval_steps, program=self.program,
                    max_keep=keep_last_n)
            resume_ms = (time.monotonic() - t0) * 1e3
            telemetry.gauge_set("train_guard_resume_ms", resume_ms)
            telemetry.log_event("resume", step=self.resumed_step,
                                resume_ms=round(resume_ms, 3),
                                restart_count=restarts)
        executor.set_nonfinite_guard(self.loss_name,
                                     callback=self._skipped,
                                     program=self.program)
        self._sigterm_installed = False
        self._prev_handler = None
        if handle_sigterm:
            try:
                self._prev_handler = signal.signal(signal.SIGTERM,
                                                   self._on_sigterm)
                self._sigterm_installed = True
            except ValueError:
                # non-main thread can't install handlers; preemption then
                # falls back to the launcher's restart + auto-resume path
                stat_add("train_guard_no_sigterm")
        # device observatory: HBM timeline sampler for the run's
        # lifetime, and SIGUSR2 -> on-demand profiler capture
        # (FLAGS_profilez_sec seconds into FLAGS_metrics_dir/profiles,
        # without pausing the step loop)
        self._hbm_sampling = observatory.start_hbm_sampler()
        self._sigusr2_installed = False
        self._prev_usr2 = None
        if handle_sigterm and hasattr(signal, "SIGUSR2"):
            try:
                self._prev_usr2 = signal.signal(signal.SIGUSR2,
                                                self._on_sigusr2)
                self._sigusr2_installed = True
            except ValueError:
                # non-main thread: the SIGTERM try above already booked
                # train_guard_no_sigterm for this condition — captures
                # remain available via capture_profile()
                logger.debug("SIGUSR2 handler not installed "
                             "(non-main thread)")

    # -- run loop -----------------------------------------------------------
    def step(self, feed, fetch_list=None, scope=None):
        return self._step(feed, fetch_list, scope, run_async=False)

    def step_async(self, feed, fetch_list=None, scope=None):
        """Asynchronous flavor of :meth:`step`: returns the executor's
        :class:`AsyncRunResult` (lazy fetches + ``sync()`` fence) instead
        of blocking numpy arrays.  Skip-step protection is identical —
        the non-finite verdict stays on device and resolves lazily (fetch
        read / ``FLAGS_guard_resolve_interval`` / checkpoint / close),
        firing the scaler backoff with the original step id."""
        return self._step(feed, fetch_list, scope, run_async=True)

    def _step(self, feed, fetch_list, scope, run_async):
        if fault.fire("step") == "sigterm":
            os.kill(os.getpid(), signal.SIGTERM)
        if fault.fire("loss") == "nan":
            feed = _poison_nonfinite(feed)
        # the guard keys on the block producing the loss, not on it being
        # fetched — the caller's fetch_list passes through untouched
        runner = self.exe.run_async if run_async else self.exe.run
        out = runner(self.program, feed=feed,
                     fetch_list=list(fetch_list or []) or None,
                     scope=scope)
        # periodic exporter flush rides the guarded loop even when the
        # caller bypasses Executor.run's epilogue (e.g. future runners)
        telemetry.maybe_flush()
        if self.stop_requested:
            self.finalize(scope=scope)
            exit_ms = None
            if self._sigterm_at is not None:
                exit_ms = (time.monotonic() - self._sigterm_at) * 1e3
                telemetry.gauge_set("sigterm_to_exit_ms", exit_ms)
            telemetry.log_event(
                "sigterm", step=self.exe._step,
                to_exit_ms=None if exit_ms is None else round(exit_ms, 3))
            telemetry.flush()
            raise TrainingInterrupted(self.exe._step)
        return out

    # -- callbacks ----------------------------------------------------------
    def _on_sigterm(self, signum, frame):
        self.stop_requested = True
        self._sigterm_at = time.monotonic()
        stat_add("sigterm_received")

    def _on_sigusr2(self, signum, frame):
        # a signal handler must not sleep for the capture window: the
        # capture runs on its own daemon thread while training continues
        self.capture_profile()

    def capture_profile(self, sec: Optional[float] = None):
        """Trigger an on-demand ``torch.profiler`` capture (default
        ``FLAGS_profilez_sec`` seconds) of the running training loop —
        the training analog of the serving ``GET /profilez``.  Returns
        the capture thread; the artifact lands under
        ``FLAGS_metrics_dir/profiles`` and is announced in the event
        log (``profile_capture``)."""
        telemetry.log_event("profile_capture_requested",
                            step=self.exe._step)
        return observatory.capture_profile_async(sec)

    def _skipped(self, step: int):
        # `step` is the ORIGINAL step id the verdict belongs to — with the
        # deferred guard, resolution may run many steps later
        self.skipped_steps += 1
        logger.warning("non-finite %r at step %d: update skipped",
                       self.loss_name, step)
        telemetry.log_event("guard_skip", step=step,
                            loss=self.loss_name,
                            resolved_at=self.exe._step)
        if self.scaler is not None and \
                hasattr(self.scaler, "backoff_on_nonfinite") and \
                step > self._backoff_watermark:
            # mark every step currently in flight as pre-backoff: their
            # verdicts belong to this same overflow episode
            self._backoff_watermark = self.exe._step
            self._backoff(step)
        if self.on_nonfinite is not None:
            self.on_nonfinite(step)

    def _backoff(self, step: int):
        try:
            params = inspect.signature(
                self.scaler.backoff_on_nonfinite).parameters
            takes_step = "step" in params
        except (TypeError, ValueError):
            takes_step = False  # builtins/C callables: play safe
        if takes_step:
            self.scaler.backoff_on_nonfinite(step=step)
        else:
            self.scaler.backoff_on_nonfinite()

    # -- shutdown -----------------------------------------------------------
    def finalize(self, scope=None):
        """Write the final checkpoint (best-effort: a dead store must not
        turn a clean preemption into a crash)."""
        if self._finalized:
            return
        self._finalized = True
        # end-of-run is a guard-resolution point: in-flight verdicts must
        # land (skip counters, scaler backoff) before the final snapshot
        self.exe.resolve_nonfinite_guard()
        if not self._ckpt_dir:
            return
        from . import checkpoint as ckpt
        try:
            ckpt.save_checkpoint(self._ckpt_dir, self.exe._step,
                                 program=self.program, scope=scope,
                                 keep_last_n=self._keep_last_n)
            stat_add("checkpoint_final")
            telemetry.log_event("final_checkpoint", step=self.exe._step,
                                dir=self._ckpt_dir)
        except OSError as e:
            stat_add("checkpoint_write_failures")
            logger.error("final checkpoint at step %d failed: %s",
                         self.exe._step, e)

    def close(self):
        """Undo everything the constructor installed on the executor."""
        if self._sigterm_installed:
            signal.signal(signal.SIGTERM,
                          self._prev_handler or signal.SIG_DFL)
            self._sigterm_installed = False
        if self._sigusr2_installed:
            signal.signal(signal.SIGUSR2,
                          self._prev_usr2 or signal.SIG_DFL)
            self._sigusr2_installed = False
        if self._hbm_sampling:
            self._hbm_sampling = False
            observatory.stop_hbm_sampler()
        self.exe.clear_nonfinite_guard()
        if self._ckpt_dir:
            self.exe.disable_auto_checkpoint()
        telemetry.flush()  # end-of-run exporter write (no-op without dir)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False
