"""Black-box flight recorder: crash forensics for serving processes.

The port's copy of ``paddle_tpu/blackbox.py``, which is free of jax (the
port imports nothing of the JAX package); it imports the port's
``fault``, ``telemetry``, ``flags`` and ``monitor``. The dump's schema
and environment names stay the reference's, so one postmortem reader
reads both.

The observability stack (spans, the device observatory, the fleet
observatory's TSDB) explains *live* processes; this module is the
artifact a **dead** one leaves behind.  It keeps small, bounded,
lock-disciplined rings in memory — the flight recorder — and dumps
them as one JSON postmortem the moment the process (or its
supervisor) knows it is dying:

* **last-K events** — every ``telemetry.log_event`` record is
  mirrored into a ``FLAGS_blackbox_events``-deep ring (the event may
  also land in ``events.jsonl``; the ring works without a metrics
  dir and survives in the dump when the final appends are torn);
* **metric snapshots** — counters + gauges captured on the
  ``FLAGS_metrics_interval`` flush cadence (a short history, so the
  dump shows the *trend* into the crash, not one point);
* **request last words** — per in-flight request: trace id,
  endpoint, slot/bucket, and the admission→now phase, recorded at
  admission and retired at respond (``FLAGS_blackbox_requests`` cap;
  what was the process serving when it stopped?);
* **span ring + counter samples** — read from telemetry at dump
  time (zero extra hot-path cost) and stored as chrome-trace events
  so ``tools/trace_export.py`` merges a dead replica's last seconds
  into the fleet Perfetto timeline.

Dump triggers:

* fatal signals — ``install()`` wires :mod:`faulthandler` (native
  tracebacks to ``postmortem/<pid>-faulthandler.txt``) plus Python
  handlers for SIGABRT/SIGSEGV/SIGBUS/SIGFPE where installable (the
  handler dumps, restores ``SIG_DFL``, and re-raises so the exit
  code still names the signal);
* uncaught scheduler-thread exceptions — the serving dispatch
  workers, the generation scheduler, and the router poll loop call
  :func:`dump_exception` before re-raising (plus a
  ``threading.excepthook`` chain installed by ``install()``);
* watchdog kills — the fleet supervisor calls
  :func:`write_kill_mark` into the victim's metrics dir *before* it
  SIGKILLs a hung replica (a SIGSTOP'd process cannot dump itself);
* the flush cadence — a rolling ``<pid>-rolling.json`` dump, so
  even a SIGKILL'd process (which gets no signal handler) leaves
  its ring as of the last cadence tick;
* explicit request — ``GET /debugz?dump=1`` or a direct
  :func:`dump` call.

Every write is atomic (tmp + ``os.replace``), routed through the
``blackbox_dump`` fault site, and **never raises**: a failed dump
bumps ``blackbox_dump_failures`` and the process dies exactly as it
would have anyway.  ``FLAGS_blackbox=0`` (or ``FLAGS_telemetry=0``)
means zero per-request work — one dict lookup at admission, nothing
recorded, no files (the PR-13 contract).

The supervisor half lives in :func:`harvest` /
:func:`attribute_death`: scan ``postmortem/`` for a dead pid's
artifacts and classify the death — ``clean_exit`` / ``hung_kill``
(the kill mark) / ``signal:<NAME>`` (decoded from the negative
waitpid rc) / ``crash:<reason>`` (a self-dump) / ``unexplained``
(died rc>0 with no self-dump — the count chaos hard-zeroes).

Stats (README catalog): counters ``blackbox_dumps``,
``blackbox_dump_failures``.
"""
from __future__ import annotations

import faulthandler
import json
import logging
import os
import signal
import threading
import time
import traceback
from collections import deque
from typing import Any, Dict, List, Optional

from . import fault, telemetry
from .flags import all_flags, flag_value
from .monitor import process_uptime_s, stat_add

__all__ = ["enabled", "record_event", "request_begin", "request_phase",
           "request_end", "snapshot", "dump", "dump_exception",
           "install", "postmortem_dir", "write_kill_mark", "harvest",
           "attribute_death", "signal_name", "reset"]

logger = logging.getLogger("paddle_tpu_torch.blackbox")

# metric-snapshot ring depth: the flush cadence feeds it, so 8 points
# at the default 10s interval is the last ~80s of counter/gauge trend
# — enough to see "queue depth climbing into the crash" without
# bloating every dump
_SNAPSHOT_KEEP = 8

# fatal signals a Python handler can meaningfully intercept; SIGKILL
# and SIGSTOP are uncatchable by definition (the rolling dump and the
# supervisor's kill mark cover those deaths)
_FATAL_SIGNALS = ("SIGABRT", "SIGSEGV", "SIGBUS", "SIGFPE", "SIGILL")


def enabled() -> bool:
    """One-dict-lookup gate (two, counting telemetry's): the recorder
    does per-request work only when both the master telemetry switch
    and ``FLAGS_blackbox`` are on."""
    return bool(flag_value("FLAGS_blackbox")) and telemetry.enabled()


class _Recorder:
    """The process-wide flight recorder: three bounded rings under one
    lock.  Ring appends are O(1) deque ops; nothing here does I/O —
    the only writes happen at dump time."""

    def __init__(self):
        self._lock = threading.Lock()
        ev_cap = int(flag_value("FLAGS_blackbox_events") or 256)
        req_cap = int(flag_value("FLAGS_blackbox_requests") or 64)
        self._events: deque = deque(maxlen=max(1, ev_cap))
        self._snapshots: deque = deque(maxlen=_SNAPSHOT_KEEP)
        self._requests: Dict[int, dict] = {}
        self._req_cap = max(1, req_cap)
        self._req_seq = 0
        self._req_dropped = 0

    # -- feeds --------------------------------------------------------------
    def event(self, kind: str, fields: dict):
        rec = {"ts": round(time.time(), 6), "event": kind}
        if fields:
            rec.update(fields)
        with self._lock:
            self._events.append(rec)

    def metrics_snapshot(self):
        snap = telemetry.metrics.snapshot()
        rec = {"ts": round(time.time(), 3),
               "counters": snap.get("counters", {}),
               "gauges": snap.get("gauges", {})}
        with self._lock:
            self._snapshots.append(rec)

    def req_begin(self, trace_id, endpoint, attrs) -> Optional[int]:
        now = time.monotonic()
        with self._lock:
            if len(self._requests) >= self._req_cap:
                self._req_dropped += 1
                return None
            self._req_seq += 1
            tok = self._req_seq
            rec = {"trace_id": trace_id, "endpoint": endpoint,
                   "t_admit": now, "phase": "admitted"}
            if attrs:
                rec.update(attrs)
            self._requests[tok] = rec
        return tok

    def req_phase(self, tok: int, phase: str, attrs):
        with self._lock:
            rec = self._requests.get(tok)
            if rec is None:
                return
            rec["phase"] = phase
            if attrs:
                rec.update(attrs)

    def req_end(self, tok: int):
        with self._lock:
            self._requests.pop(tok, None)

    # -- reads --------------------------------------------------------------
    def ring(self) -> dict:
        now = time.monotonic()
        with self._lock:
            events = list(self._events)
            snaps = list(self._snapshots)
            reqs = [dict(r) for r in self._requests.values()]
            dropped = self._req_dropped
        for r in reqs:
            # admission→now age replaces the raw monotonic stamp
            # (meaningless outside this process)
            r["age_ms"] = round((now - r.pop("t_admit")) * 1e3, 3)
        return {"events": events, "metric_snapshots": snaps,
                "live_requests": reqs, "requests_dropped": dropped,
                "capacity": {"events": self._events.maxlen,
                             "requests": self._req_cap}}


_recorder: Optional[_Recorder] = None
_recorder_lock = threading.Lock()


def _get() -> _Recorder:
    global _recorder
    if _recorder is None:
        with _recorder_lock:
            if _recorder is None:
                _recorder = _Recorder()
    return _recorder


def reset():
    """Drop the recorder (ring capacities re-read the FLAGS on next
    use) and re-arm the install guard.  Test hook."""
    global _recorder, _installed
    with _recorder_lock:
        _recorder = None
        _installed = False


# ---------------------------------------------------------------------------
# feeds (called from telemetry taps and the serving engines)
# ---------------------------------------------------------------------------

def record_event(kind: str, **fields):
    """Mirror one event record into the ring (telemetry's
    ``log_event`` tap calls this; anything else may too).  No-op when
    disabled."""
    if not enabled():
        return
    _get().event(kind, fields)


def request_begin(trace_id: Optional[str], endpoint: str,
                  **attrs) -> Optional[int]:
    """Record a request's last words at admission; returns an opaque
    token for :func:`request_phase` / :func:`request_end`, or None
    (disabled, or the in-flight cap is reached — the request is
    simply not recorded)."""
    if not enabled():
        return None
    return _get().req_begin(trace_id, endpoint, attrs)


def request_phase(token: Optional[int], phase: str, **attrs):
    """Advance a recorded request's phase (``admitted`` →
    ``executing`` / ``decoding`` ...).  No-op on a None token."""
    if token is None:
        return
    _get().req_phase(token, phase, attrs)


def request_end(token: Optional[int]):
    """Retire a recorded request (it responded — its last words are
    no longer interesting).  No-op on a None token."""
    if token is None:
        return
    _get().req_end(token)


def on_flush():
    """Flush-cadence tap (wired from ``telemetry.flush``): capture a
    counter/gauge snapshot into the ring and refresh the rolling dump
    — the artifact a SIGKILL'd process leaves behind."""
    if not enabled():
        return
    _get().metrics_snapshot()
    if telemetry._metrics_dir() is not None:
        dump("rolling", quiet=True)


# ---------------------------------------------------------------------------
# snapshot + dump
# ---------------------------------------------------------------------------

def snapshot() -> dict:
    """The live ring as one JSON-able doc (the ``/debugz`` payload's
    ``blackbox`` block).  Works disabled too — reports the state, not
    an error."""
    if not enabled():
        return {"enabled": False}
    doc = {"enabled": True, "dump_dir": postmortem_dir()}
    doc.update(_get().ring())
    return doc


def postmortem_dir(metrics_dir: Optional[str] = None) -> Optional[str]:
    """``<metrics_dir>/postmortem`` (None without a metrics dir)."""
    d = metrics_dir if metrics_dir is not None \
        else telemetry._metrics_dir()
    return os.path.join(str(d), "postmortem") if d else None


def _sanitize(reason: str) -> str:
    out = "".join(c if c.isalnum() or c in "_-" else "_"
                  for c in str(reason))
    return out[:64] or "unknown"


def _atomic_dump(path: str, doc: dict) -> bool:
    """tmp + os.replace through the ``blackbox_dump`` fault site;
    never raises (the dump path runs while the process is dying — an
    I/O error must not mask the original failure)."""
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        if fault.fire("blackbox_dump") == "raise":
            raise fault.InjectedFault(
                f"injected blackbox dump failure "
                f"({os.path.basename(path)})")
        text = json.dumps(doc, default=str)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, path)
        return True
    except (OSError, TypeError, ValueError) as e:
        stat_add("blackbox_dump_failures")
        logger.warning("blackbox dump %s failed: %s", path, e)
        try:
            os.remove(tmp)
        except OSError:
            pass  # ok: tmp may never have been created
        return False


def _exc_block(exc: Optional[BaseException]) -> Optional[dict]:
    if exc is None:
        return None
    return {"type": type(exc).__name__, "message": str(exc),
            "traceback": traceback.format_exception(
                type(exc), exc, exc.__traceback__)}


def dump(reason: str, exc: Optional[BaseException] = None,
         thread: Optional[str] = None,
         quiet: bool = False) -> Optional[str]:
    """Write the full postmortem document to
    ``<metrics_dir>/postmortem/<pid>-<reason>.json`` (atomic; never
    raises).  Returns the path, or None (disabled / no metrics dir /
    write failed).  The doc carries the three rings, the live metric
    registry, every flag's current value, and the span ring + counter
    samples as chrome-trace events (``trace_events``) so
    ``tools/trace_export.py`` can merge the dead process's last
    seconds into a fleet timeline."""
    if not enabled():
        return None
    d = postmortem_dir()
    if d is None:
        return None
    reason = _sanitize(reason)
    trace_events = telemetry.spans_to_chrome_events() \
        + telemetry.counters_to_chrome_events()
    doc = {
        "schema": "paddle_tpu.postmortem.v1",
        "pid": os.getpid(),
        "reason": reason,
        "time": round(time.time(), 6),
        "uptime_s": process_uptime_s(),
        "replica_id": os.environ.get("PADDLE_TPU_REPLICA_ID"),
        "restart_count": os.environ.get("PADDLE_TPU_RESTART_COUNT"),
        "thread": thread or threading.current_thread().name,
        "exception": _exc_block(exc),
        "blackbox": _get().ring(),
        "metrics": telemetry.metrics.snapshot(),
        "flags": all_flags(),
        "trace_events": trace_events,
    }
    path = os.path.join(d, f"{os.getpid()}-{reason}.json")
    if not _atomic_dump(path, doc):
        return None
    stat_add("blackbox_dumps")
    if not quiet:
        logger.warning("blackbox postmortem dumped: %s (reason=%s)",
                       path, reason)
    return path


def dump_exception(where: str, exc: BaseException) -> Optional[str]:
    """Dump for an uncaught scheduler/dispatch-thread exception
    (reason ``uncaught_<where>``).  Callers re-raise afterwards — the
    recorder observes the death, it never absorbs it."""
    return dump(f"uncaught_{where}", exc=exc)


# ---------------------------------------------------------------------------
# fatal-signal + thread-excepthook installation
# ---------------------------------------------------------------------------

_installed = False
_fh_file = None  # keeps the faulthandler fd alive for process lifetime


def _fatal_handler(signum, frame):
    try:
        name = signal.Signals(signum).name
    except ValueError:
        name = str(signum)
    dump(f"signal_{name}", thread=threading.current_thread().name)
    # die by the same signal so the supervisor's waitpid rc still
    # names it (rc = -signum) — the dump must not launder the death
    # into a clean exit
    try:
        signal.signal(signum, signal.SIG_DFL)
        signal.raise_signal(signum)
    except (OSError, ValueError):
        os._exit(128 + int(signum))


def install() -> bool:
    """Wire the process-death triggers (idempotent; replica startup
    calls this).  Returns True when the recorder is active.  Each
    piece is independently best-effort: faulthandler needs a metrics
    dir, Python signal handlers need the main thread, and neither
    failing disables the rings or the explicit/rolling dumps."""
    global _installed, _fh_file
    if not enabled():
        return False
    if _installed:
        return True
    _installed = True
    d = postmortem_dir()
    if d is not None:
        try:
            os.makedirs(d, exist_ok=True)
            _fh_file = open(os.path.join(
                d, f"{os.getpid()}-faulthandler.txt"), "w")
            faulthandler.enable(file=_fh_file)
        except OSError as e:
            logger.warning("faulthandler install failed: %s", e)
    for name in _FATAL_SIGNALS:
        sig = getattr(signal, name, None)
        if sig is None:
            continue
        try:
            signal.signal(sig, _fatal_handler)
        except (ValueError, OSError) as e:
            # non-main thread / platform refusal: faulthandler (native
            # traceback) and the rolling dump still cover this signal
            logger.debug("handler for %s not installable: %s", name, e)
    prev_hook = threading.excepthook

    def _bb_excepthook(args):
        tname = args.thread.name if args.thread is not None else "?"
        if args.exc_value is not None:
            dump(f"uncaught_thread_{_sanitize(tname)}",
                 exc=args.exc_value, thread=tname)
        prev_hook(args)

    threading.excepthook = _bb_excepthook
    if d is not None:
        # seed the rolling dump NOW: a life SIGKILLed before its first
        # flush cadence still leaves a flight-recorder artifact (empty
        # rings beat an unexplained death)
        dump("rolling", quiet=True)
    return True


# ---------------------------------------------------------------------------
# supervisor half: kill marks, harvest, attribution
# ---------------------------------------------------------------------------

def write_kill_mark(metrics_dir: str, pid: int,
                    reason: str = "hung_kill", **fields) -> Optional[str]:
    """Written by the SUPERVISOR into the victim's metrics dir before
    it shoots: a SIGSTOP'd/wedged replica cannot dump itself, so the
    mark is the fault-window evidence its death leaves behind.  Same
    atomic/never-raise discipline (and the same ``blackbox_dump``
    fault site) as a self-dump."""
    if not flag_value("FLAGS_blackbox"):
        return None
    reason = _sanitize(reason)
    d = postmortem_dir(metrics_dir)
    doc = {"schema": "paddle_tpu.postmortem.v1", "pid": int(pid),
           "reason": reason, "time": round(time.time(), 6),
           "written_by": "supervisor", "supervisor_pid": os.getpid()}
    doc.update(fields)
    path = os.path.join(d, f"{int(pid)}-{reason}.json")
    if not _atomic_dump(path, doc):
        return None
    stat_add("blackbox_dumps")
    return path


def harvest(metrics_dir: str, pid: int) -> List[dict]:
    """Collect a dead pid's postmortem artifacts:
    ``{path, reason, written_by}`` per ``<pid>-*.json`` found (the
    faulthandler text rides along as reason ``faulthandler``).
    Read-only and exception-free — harvesting runs inside the crash
    monitor's poll and must never wedge it."""
    d = postmortem_dir(metrics_dir)
    if d is None:
        return []
    prefix = f"{int(pid)}-"
    out = []
    try:
        names = sorted(os.listdir(d))
    except OSError:
        return []
    for name in names:
        if not name.startswith(prefix):
            continue
        stem, ext = os.path.splitext(name)
        reason = stem[len(prefix):]
        art = {"path": os.path.join(d, name), "reason": reason}
        if ext == ".json":
            doc = None
            try:
                with open(art["path"], encoding="utf-8") as f:
                    doc = json.load(f)
            except (OSError, ValueError):
                art["torn"] = True
            if isinstance(doc, dict):
                art["written_by"] = doc.get("written_by", "self")
                if doc.get("exception"):
                    art["exception"] = doc["exception"].get("type")
        elif stem[len(prefix):] == "faulthandler":
            try:
                art["empty"] = os.path.getsize(art["path"]) == 0
            except OSError:
                art["empty"] = True
        out.append(art)
    return out


def signal_name(rc: Optional[int]) -> Optional[str]:
    """Decode a waitpid return code into the signal that killed the
    process (``rc < 0`` on POSIX ⇒ ``-rc`` is the signal number), or
    None for clean/error exits — the one helper every death-reporting
    site shares so logs, events, and ``/fleetz`` agree."""
    if rc is None or rc >= 0:
        return None
    try:
        return signal.Signals(-rc).name
    except ValueError:
        return f"SIG{-rc}"


def attribute_death(rc: Optional[int],
                    artifacts: List[dict]) -> str:
    """Classify one replica death from its exit code + harvested
    artifacts.  Taxonomy (the README 'Crash forensics' contract):

    * ``hung_kill`` — the supervisor's kill mark is present (the
      liveness watchdog shot it; rc is -SIGKILL underneath);
    * ``clean_exit`` — rc 0 (planned drain or normal exit);
    * ``signal:<NAME>`` — died by signal (the OS names the killer);
    * ``crash:<reason>`` — rc > 0 with a self-dump (the process saw
      its own death and said why);
    * ``unexplained`` — rc > 0 (or unknowable) with NO self-dump:
      the death the flight recorder exists to eliminate.  Rolling
      dumps and faulthandler text are context, not an explanation.
    """
    reasons = {a["reason"] for a in artifacts}
    if "hung_kill" in reasons:
        return "hung_kill"
    if rc == 0:
        return "clean_exit"
    sig = signal_name(rc)
    if sig is not None:
        return f"signal:{sig}"
    self_dumps = sorted(
        r for a in artifacts
        for r in [a["reason"]]
        if a.get("written_by", "self") == "self"
        and r not in ("rolling", "faulthandler") and not a.get("torn"))
    if self_dumps:
        return f"crash:{self_dumps[0]}"
    return "unexplained"


# ---------------------------------------------------------------------------
# telemetry taps (import-time wiring; telemetry never imports us back)
# ---------------------------------------------------------------------------

def _event_tap(kind: str, fields: dict):
    if flag_value("FLAGS_blackbox"):  # telemetry.enabled() already held
        _get().event(kind, fields)


telemetry._blackbox_event_tap = _event_tap
telemetry._blackbox_flush_tap = on_flush
