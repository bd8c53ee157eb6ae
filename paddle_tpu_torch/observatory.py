"""Device-side observatory: HBM timeline sampler + on-demand profiler.

The port's counterpart of ``paddle_tpu/observatory.py``: the same
sampler, gauges, snapshot and capture contract, read from ``torch.cuda``
(the caching allocator's allocated bytes of each card) where the
reference reads ``jax.live_arrays()``, and traced with
``torch.profiler`` where the reference starts ``jax.profiler``.

The host-side telemetry plane (spans, metrics, traces) sees dispatches;
this module watches the **device**:

* **HBM timeline** — :class:`HbmSampler`, a daemon thread sampling
  the cards' allocated bytes every ``FLAGS_hbm_sample_interval`` seconds:
  feeds the ``hbm_live_bytes`` gauge, the ``hbm_peak_bytes`` high
  watermark (``Gauge.set_max`` — the spike a poll misses), per-device
  ``hbm_live_bytes_dev<i>`` gauges on multichip meshes, and a Perfetto
  **counter track** (``telemetry.counter_sample``) so the memory curve
  renders alongside the host spans in ``trace.json`` / the merged
  ``tools/trace_export.py`` timeline.  Start/stop are idempotent and
  refcounted (TrainGuard and ServingEngine both hold it open).
* **On-demand profiler capture** — :func:`capture_profile` wraps
  ``torch.profiler`` (CPU and, on the card, CUDA activities) to write a
  Chrome trace under ``FLAGS_metrics_dir``/profiles without pausing
  serving or training: the capture is passive (the work keeps running),
  bounded (``MAX_CAPTURE_SEC``), single-flight (a second request gets
  :class:`CaptureBusy`), and requires telemetry on
  (:class:`CaptureDisabled` otherwise — the ``/profilez`` 503).
  ``GET /profilez?sec=N`` on the serving server and ``SIGUSR2`` /
  :meth:`TrainGuard.capture_profile` in training both land here.
  ``torch.profiler``'s stop and trace export hold the GIL, so the
  process's other threads (its ``/healthz`` among them) stall for a
  time that grows with the events recorded: while it runs, a capture
  leaves ``CAPTURE_MARK`` in ``FLAGS_metrics_dir``, and a fleet
  supervisor's liveness watchdog reads it (:func:`capture_waiver_until`)
  rather than SIGKILL a replica that is busy exporting its trace.

Stats: ``profile_captures`` counter; gauges ``hbm_live_bytes``,
``hbm_peak_bytes`` (+ dynamic ``hbm_live_bytes_dev<i>``).
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Dict, Optional

from . import telemetry
from .flags import flag_value
from .monitor import stat_add

__all__ = ["device_live_bytes", "HbmSampler", "start_hbm_sampler",
           "stop_hbm_sampler", "hbm_snapshot", "capture_profile",
           "capture_profile_async", "CaptureBusy", "CaptureDisabled",
           "MAX_CAPTURE_SEC"]

logger = logging.getLogger("paddle_tpu_torch.observatory")

MAX_CAPTURE_SEC = 60.0
# the file a capture in flight leaves in FLAGS_metrics_dir: its pid, its
# wall-clock start and its length
CAPTURE_MARK = "profile_capture.json"
# a marked capture excuses a silent /healthz for this many times its
# length from its start: the recording, then the stop and the export,
# which silenced /healthz for 0.61-1.02 s a second recorded under
# traffic on an H100 (probe_profilez.py)
CAPTURE_WAIVER_FACTOR = 3.0


# ---------------------------------------------------------------------------
# live-buffer accounting
# ---------------------------------------------------------------------------

def device_live_bytes() -> Optional[Dict[str, int]]:
    """Bytes the caching allocator has handed out on each card, total and
    per device index: ``{"total": N, "per_device": {0: n0, ...}}``.
    None on a process with no card (the CPU) or when the probe fails."""
    import torch

    if not torch.cuda.is_available():
        return None
    try:
        per = {i: int(torch.cuda.memory_allocated(i))
               for i in range(torch.cuda.device_count())}
    except RuntimeError as e:
        logger.debug("device memory probe failed: %s", e)
        return None
    return {"total": sum(per.values()), "per_device": per}


class HbmSampler:
    """Daemon thread emitting the HBM timeline.

    Each tick: read :func:`device_live_bytes`, set ``hbm_live_bytes``
    (+ per-device ``hbm_live_bytes_dev<i>`` when more than one device
    holds buffers), advance the ``hbm_peak_bytes`` watermark, and drop
    one counter-track sample into the trace ring.  The tick never
    raises (a probe failure skips the sample)."""

    def __init__(self, interval_s: Optional[float] = None):
        self._interval = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _tick(self):
        snap = device_live_bytes()
        if snap is None or not telemetry.enabled():
            return
        total = snap["total"]
        telemetry.gauge_set("hbm_live_bytes", total)
        telemetry.metrics.gauge("hbm_peak_bytes").set_max(total)
        series = {"total": float(total)}
        per = snap["per_device"]
        if len(per) > 1:
            for di, b in sorted(per.items()):
                series[f"dev{di}"] = float(b)
                telemetry.gauge_set(f"hbm_live_bytes_dev{di}", b)
        telemetry.counter_sample("hbm_live_bytes", series)

    def _loop(self):
        while not self._stop.is_set():
            self._tick()
            interval = self._interval
            if interval is None:
                interval = float(
                    flag_value("FLAGS_hbm_sample_interval") or 0.25)
            self._stop.wait(max(interval, 0.01))
        self._tick()  # final sample so short runs still get a curve

    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="hbm-sampler", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 2.0):
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout)
        self._thread = None


_sampler_lock = threading.Lock()
_sampler: Optional[HbmSampler] = None
_sampler_refs = 0


def start_hbm_sampler() -> bool:
    """Refcounted start of the process-wide sampler.  Returns False
    (and does nothing) when disabled: telemetry off or
    ``FLAGS_hbm_sample_interval`` = 0."""
    global _sampler, _sampler_refs
    if not telemetry.enabled() or \
            not float(flag_value("FLAGS_hbm_sample_interval") or 0):
        return False
    with _sampler_lock:
        _sampler_refs += 1
        if _sampler is None:
            _sampler = HbmSampler().start()
    return True


def stop_hbm_sampler():
    """Refcounted stop: the thread exits when the last holder lets go."""
    global _sampler, _sampler_refs
    with _sampler_lock:
        if _sampler_refs > 0:
            _sampler_refs -= 1
        if _sampler_refs == 0 and _sampler is not None:
            s, _sampler = _sampler, None
        else:
            return
    s.stop()


def hbm_snapshot() -> dict:
    """The ``/statusz`` device-memory block: live bytes now + the
    watermark gauge's current peak."""
    snap = device_live_bytes()
    return {
        "live_bytes": None if snap is None else snap["total"],
        "per_device": None if snap is None
        else {str(k): v for k, v in sorted(snap["per_device"].items())},
        "peak_bytes": telemetry.metrics.gauge("hbm_peak_bytes").get()
        if telemetry.enabled() else None,
    }


# ---------------------------------------------------------------------------
# on-demand profiler capture
# ---------------------------------------------------------------------------

class CaptureBusy(RuntimeError):
    """A profiler capture is already in flight (single-flight: one
    profiler session at a time in the process)."""


class CaptureDisabled(RuntimeError):
    """Telemetry is off (``FLAGS_telemetry=0``): no capture surface."""


_capture_lock = threading.Lock()
_capture_active = [False]


def _capture_dir() -> str:
    base = flag_value("FLAGS_metrics_dir") or os.getcwd()
    return os.path.join(str(base), "profiles",
                        f"capture-{int(time.time() * 1e3)}-{os.getpid()}")


def _profile_for(sec: float, target: str):
    """Trace `sec` seconds of whatever the process runs with
    ``torch.profiler`` and write ``trace.json`` (Chrome format) into
    `target`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(target, exist_ok=True)
    with profile(activities=activities) as prof:
        time.sleep(sec)
    prof.export_chrome_trace(os.path.join(target, "trace.json"))


def _mark_capture(sec: float) -> Optional[str]:
    """Write CAPTURE_MARK into FLAGS_metrics_dir (none where the flag is
    unset: no supervisor reads one then); its path."""
    base = flag_value("FLAGS_metrics_dir")
    if not base:
        return None
    path = os.path.join(str(base), CAPTURE_MARK)
    os.makedirs(str(base), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump({"pid": os.getpid(), "started": time.time(),
                   "sec": sec}, f)
    os.replace(tmp, path)
    return path


def capture_waiver_until(metrics_dir: str, pid: int) -> Optional[float]:
    """The wall-clock time until which a capture in flight in process
    `pid` (its CAPTURE_MARK in `metrics_dir`) excuses a silent /healthz;
    None where that process marks no capture."""
    try:
        with open(os.path.join(metrics_dir, CAPTURE_MARK)) as f:
            doc = json.load(f)
        if doc.get("pid") != pid:
            return None
        return float(doc["started"]) + \
            CAPTURE_WAIVER_FACTOR * float(doc["sec"])
    except (OSError, ValueError, KeyError, TypeError, AttributeError):
        return None


def capture_profile(sec: Optional[float] = None,
                    out_dir: Optional[str] = None) -> dict:
    """Capture ``sec`` seconds of ``torch.profiler`` device+host trace
    into ``out_dir`` (default ``FLAGS_metrics_dir/profiles/capture-*``)
    WITHOUT pausing the workload: the capture thread only sleeps while
    the profiler records whatever is executing.

    Returns ``{"dir", "sec", "files", "bytes"}``.  Raises
    :class:`CaptureDisabled` with telemetry off, :class:`CaptureBusy`
    when a capture (from any trigger) is already running."""
    if not telemetry.enabled():
        raise CaptureDisabled("FLAGS_telemetry=0")
    if sec is None:
        sec = float(flag_value("FLAGS_profilez_sec") or 2.0)
    sec = min(max(float(sec), 0.05), MAX_CAPTURE_SEC)
    with _capture_lock:
        if _capture_active[0]:
            raise CaptureBusy("profiler capture already running")
        _capture_active[0] = True
    target = out_dir or _capture_dir()
    mark = None
    try:
        mark = _mark_capture(sec)
        _profile_for(sec, target)
    finally:
        if mark is not None:
            try:
                os.remove(mark)
            except OSError:
                pass
        with _capture_lock:
            _capture_active[0] = False
    files, total = [], 0
    for dirpath, _dirs, names in os.walk(target):
        for n in names:
            p = os.path.join(dirpath, n)
            files.append(os.path.relpath(p, target))
            total += os.path.getsize(p)
    stat_add("profile_captures")
    telemetry.log_event("profile_capture", dir=target,
                        sec=round(sec, 3), bytes=total,
                        files=len(files))
    return {"dir": target, "sec": sec, "files": sorted(files),
            "bytes": total}


def capture_profile_async(sec: Optional[float] = None,
                          out_dir: Optional[str] = None
                          ) -> threading.Thread:
    """Fire-and-forget capture (the SIGUSR2 path: a signal handler must
    not sleep).  Failures log instead of raising — there is no caller
    to catch them."""
    def _run():
        try:
            capture_profile(sec, out_dir)
        except (CaptureBusy, CaptureDisabled) as e:
            logger.warning("profiler capture skipped: %s", e)
        except Exception as e:
            logger.warning("profiler capture failed: %s", e)

    t = threading.Thread(target=_run, name="profile-capture",
                         daemon=True)
    t.start()
    return t
