"""Profiler: device traces + host event annotation.

The port's copy of ``paddle_tpu/profiler.py``, on ``torch.profiler``
where the reference starts ``jax.profiler``: the reference's API shape
(``start_profiler`` / ``stop_profiler``, the ``profiler`` context,
``RecordEvent`` on ``torch.profiler.record_function``) and its host-side
summary, so ``stop_profiler('total')`` prints the reference's event
table (host ops, and on the card every kernel by name) without
TensorBoard.  A session traces the CPU and, where there is a card, CUDA;
it writes one gzipped Chrome trace (``*.trace.json.gz``) under its
trace dir.
"""
from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import shutil
import socket
import time
from collections import Counter
from typing import Optional

__all__ = ["profiler", "start_profiler", "stop_profiler", "RecordEvent",
           "load_trace", "summarize_trace"]

_active_dir: Optional[str] = None
_session = None  # the running torch.profiler.profile


def start_profiler(state: str = "All", tracer_option: str = "Default",
                   trace_dir: Optional[str] = None):
    """reference fluid.profiler.start_profiler; `state` is advisory (the
    session always traces the host and, with a card, the device)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    global _active_dir, _session
    if _active_dir is not None:
        raise RuntimeError("profiler already running")
    target = trace_dir or os.path.join(
        os.getcwd(), f"paddle_tpu_profile_{int(time.time())}")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    session = profile(activities=activities)
    session.start()
    _active_dir, _session = target, session  # only after start succeeded
    return _active_dir


def stop_profiler(sorted_key: Optional[str] = None,
                  profile_path: Optional[str] = None) -> Optional[str]:
    """Stop tracing and write the trace; optionally print the
    reference-style op table (sorted_key in {'total', 'calls', 'ave'})
    and return the trace dir."""
    global _active_dir, _session
    if _active_dir is None:
        return None
    trace_dir, session = _active_dir, _session
    try:
        session.stop()
        _export(session, trace_dir)
    finally:
        # even a failed stop tears down the session state: leaving
        # _active_dir set would wedge start_profiler ("profiler already
        # running") for the rest of the process
        _active_dir, _session = None, None
    if sorted_key:
        table = summarize_trace(trace_dir, sorted_key)
        print(table)
        if profile_path:
            with open(profile_path, "w") as f:
                f.write(table)
    return trace_dir


def _export(session, trace_dir: str):
    """The session's Chrome trace as ``<host>.<pid>.trace.json.gz``."""
    os.makedirs(trace_dir, exist_ok=True)
    base = os.path.join(trace_dir,
                        f"{socket.gethostname()}.{os.getpid()}.trace.json")
    session.export_chrome_trace(base)
    with open(base, "rb") as src, gzip.open(base + ".gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    os.remove(base)


@contextlib.contextmanager
def profiler(state: str = "All", sorted_key: Optional[str] = None,
             profile_path: Optional[str] = None,
             trace_dir: Optional[str] = None):
    """reference fluid.profiler.profiler context manager."""
    start_profiler(state, trace_dir=trace_dir)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


class RecordEvent:
    """Annotate a host region; shows on the trace timeline (reference
    platform/profiler.h RecordEvent -> torch.profiler.record_function)."""

    def __init__(self, name: str):
        import torch

        self.name = name
        self._ann = torch.profiler.record_function(name)

    def __enter__(self):
        self._ann.__enter__()
        return self

    def __exit__(self, *exc):
        return self._ann.__exit__(*exc)


def load_trace(trace_dir: str) -> dict:
    """Load the captured trace's event JSON (the newest
    ``*.trace.json.gz`` under `trace_dir`; chrome://tracing and Perfetto
    read it too)."""
    files = sorted(glob.glob(
        os.path.join(trace_dir, "**", "*.trace.json.gz"), recursive=True))
    if not files:
        raise FileNotFoundError(f"no trace found under {trace_dir}")
    with gzip.open(files[-1]) as f:
        return json.load(f)


def summarize_trace(trace_dir: str, sorted_key: str = "total",
                    top: int = 30) -> str:
    """Reference-style event table (profiler.cc PrintProfiler analog)."""
    trace = load_trace(trace_dir)
    dur, calls = Counter(), Counter()
    for e in trace.get("traceEvents", []):
        if e.get("ph") == "X" and "dur" in e and e.get("name"):
            dur[e["name"]] += e["dur"]
            calls[e["name"]] += 1
    rows = [(n, dur[n] / 1e3, calls[n], dur[n] / 1e3 / calls[n])
            for n in dur]
    key = {"total": lambda r: -r[1], "calls": lambda r: -r[2],
           "ave": lambda r: -r[3]}.get(sorted_key, lambda r: -r[1])
    rows.sort(key=key)
    lines = [f"{'Event':60s} {'Total(ms)':>12s} {'Calls':>8s} "
             f"{'Ave(ms)':>10s}"]
    for n, tot, c, ave in rows[:top]:
        lines.append(f"{n[:60]:60s} {tot:12.3f} {c:8d} {ave:10.4f}")
    return "\n".join(lines)
