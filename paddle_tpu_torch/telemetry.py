"""Training telemetry: span tracing, typed metrics, exporters, heartbeat.

The port's copy of ``paddle_tpu/telemetry.py``: the same spans, trace
ids, histograms with exemplars, exporters and Prometheus text (its
family names stay the reference's, so one scraper reads both
packages).  The one change is the heartbeat's device memory, which
reads ``torch.cuda.memory_allocated`` / ``memory_reserved`` of each
card where the reference reads ``jax.live_arrays()``.

The monitor's int counters answer "how many"; this module answers "why
was step N slow" and "is the job alive" without print statements:

* **Span tracer** — :func:`trace_span` ``(name, **attrs)`` context
  manager with a thread-local parent stack, monotonic-clock durations,
  and a bounded ring of completed spans exportable as chrome://tracing /
  Perfetto JSON (:func:`export_chrome_trace`, ``tools/trace_export.py``).
* **Span context** — every span carries a ``trace_id`` (inherited from
  its parent; minted fresh at a root), :func:`current_span` exposes the
  innermost open span as a handoff-able :class:`SpanContext`, and
  ``trace_span(..., parent=ctx)`` re-parents under that context on ANY
  thread — a request keeps one trace_id across queue/thread hops
  (Dapper-style propagation; the serving engine is the main user).
  ``detached=True`` spans skip the thread-local stack entirely (begun
  on one thread, ended on another); ``links=[ctx, ...]`` records
  fan-in/fan-out references to other traces (a serving batch links the
  N request traces it carries).
* **Typed metrics** — :class:`Gauge`, :class:`Timer`, and fixed-bucket
  :class:`Histogram` (p50/p95/p99 summaries) in a
  :class:`MetricsRegistry` alongside the monitor's counters.
* **Exporters** — Prometheus textfile (``metrics.prom``, atomic
  tmp+rename on a ``FLAGS_metrics_interval`` cadence), structured JSONL
  event log (``events.jsonl``: one machine-parseable line per event),
  and a ``heartbeat.json`` health file (pid, step, last-step wall ms,
  examples/sec, the cards' allocated and reserved memory) an external
  watchdog can
  poll.  All land under ``FLAGS_metrics_dir``; empty dir = no files.

``FLAGS_telemetry=0`` reduces every entry point to a constant-time
no-op: :func:`trace_span` returns a shared no-op context manager,
metric writes return immediately, and no file is ever created — the
hot-path cost of disabled telemetry is one dict lookup.

Exporter writes go through the ``metrics_write`` fault-injection site
(``paddle_tpu_torch/fault.py``) and NEVER raise into the training loop: an
I/O failure bumps ``telemetry_write_failures`` and is logged.

Metrics emitted by this module itself: ``telemetry_write_failures``
(counter), ``telemetry_events_dropped`` (counter: JSONL lines lost to
I/O faults).  Instrumented metrics are documented in their home modules
and in the README stat catalog ("Observability" section).
"""
from __future__ import annotations

import json
import logging
import math
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from . import fault
from .flags import flag_value
from .monitor import monitor as _monitor
from .monitor import process_start_time, stat_add

__all__ = ["SpanContext", "new_trace_id", "trace_span", "span_begin",
           "span_end", "current_span", "get_spans", "clear_spans",
           "span_tree", "counter_sample", "get_counter_samples",
           "export_chrome_trace", "spans_to_chrome_events", "Gauge",
           "Timer", "Histogram", "MetricsRegistry", "metrics",
           "gauge_set", "histogram_observe", "timer", "log_event",
           "note_step", "prometheus_text", "write_prometheus",
           "write_heartbeat", "maybe_flush", "flush", "enabled"]

logger = logging.getLogger("paddle_tpu_torch.telemetry")

# maps time.monotonic() to the epoch so chrome-trace timestamps are
# real wall-clock times while durations stay monotonic
_EPOCH_OFFSET = time.time() - time.monotonic()


def enabled() -> bool:
    """Master switch (``FLAGS_telemetry``): one dict lookup."""
    return bool(flag_value("FLAGS_telemetry"))


# ---------------------------------------------------------------------------
# span tracer
# ---------------------------------------------------------------------------

class SpanContext:
    """The handoff-able identity of a span: ``(trace_id, span_id)``.

    Capture it on one thread (:func:`current_span` or
    ``span.context()``), pass it across a queue / thread-pool hop, and
    re-parent with ``trace_span(..., parent=ctx)`` — the child lands in
    the same trace regardless of which thread runs it."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: int):
        self.trace_id = trace_id
        self.span_id = span_id

    def __eq__(self, other):
        return (isinstance(other, SpanContext)
                and other.trace_id == self.trace_id
                and other.span_id == self.span_id)

    def __hash__(self):
        return hash((self.trace_id, self.span_id))

    def to_dict(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    def __repr__(self):
        return f"SpanContext({self.trace_id!r}, {self.span_id})"


_trace_seq = [0]
_trace_seq_lock = threading.Lock()


def new_trace_id() -> str:
    """Process-unique 16-hex-char trace id (pid + sequence: two
    processes writing one metrics dir cannot collide).  Spans mint one
    automatically at trace roots; the serving engine also stamps
    UNsampled requests with one so access-log lines and histogram
    exemplars still name the request."""
    with _trace_seq_lock:
        _trace_seq[0] += 1
        n = _trace_seq[0]
    return f"{os.getpid() & 0xffffffff:08x}{n & 0xffffffff:08x}"


class Span:
    """One completed (or in-flight) traced region.

    Durations come from ``time.monotonic()``; ``ts``/``dur`` export as
    chrome-trace microseconds.  ``parent_id`` is the span id of the
    enclosing :func:`trace_span` on the same thread — or of the
    explicit ``parent=SpanContext`` handed across a thread hop — and
    None at a root, so the tree reconstructs from the flat ring.
    ``trace_id`` is inherited from the parent (fresh at a root): every
    span of one request shares it.  ``links`` are SpanContexts of
    OTHER traces this span fans in from (a serving batch links the
    requests it serves)."""

    __slots__ = ("name", "attrs", "span_id", "parent_id", "trace_id",
                 "links", "tid", "start", "end")
    _next_id = [1]
    _id_lock = threading.Lock()

    def __init__(self, name: str, attrs: Dict[str, Any], parent_id, tid,
                 trace_id: Optional[str] = None, links=None):
        self.name = name
        self.attrs = attrs
        with Span._id_lock:
            self.span_id = Span._next_id[0]
            Span._next_id[0] += 1
        self.parent_id = parent_id
        self.trace_id = trace_id or new_trace_id()
        self.links: Tuple[SpanContext, ...] = tuple(links or ())
        self.tid = tid
        self.start = time.monotonic()
        self.end: Optional[float] = None

    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    @property
    def duration_ms(self) -> Optional[float]:
        return None if self.end is None else (self.end - self.start) * 1e3

    def to_event(self) -> dict:
        """Chrome-trace complete ('X') event."""
        args = dict(self.attrs, span_id=self.span_id,
                    parent_id=self.parent_id, trace_id=self.trace_id)
        if self.links:
            args["links"] = [c.to_dict() for c in self.links]
        return {"ph": "X", "name": self.name, "cat": "paddle_tpu",
                "pid": os.getpid(), "tid": self.tid,
                "ts": (self.start + _EPOCH_OFFSET) * 1e6,
                "dur": ((self.end or time.monotonic()) - self.start) * 1e6,
                "args": args}

    def to_tracez(self, t0: Optional[float] = None) -> dict:
        """Compact JSON shape for the live ``/tracez`` endpoint."""
        return {"name": self.name, "trace_id": self.trace_id,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "tid": self.tid,
                "start_ms": round((self.start - (t0 or 0.0)) * 1e3, 3),
                "duration_ms": None if self.end is None
                else round(self.duration_ms, 3),
                "attrs": dict(self.attrs),
                "links": [c.to_dict() for c in self.links]}

    def __repr__(self):
        d = self.duration_ms
        return (f"Span({self.name!r}, id={self.span_id}, "
                f"parent={self.parent_id}, trace={self.trace_id}, "
                f"{'open' if d is None else f'{d:.3f}ms'})")


_tls = threading.local()
_ring_lock = threading.Lock()
_ring: Optional[deque] = None


def _stack() -> list:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


def _get_ring() -> deque:
    global _ring
    if _ring is None:
        with _ring_lock:
            if _ring is None:
                cap = int(flag_value("FLAGS_trace_buffer_size") or 4096)
                _ring = deque(maxlen=max(1, cap))
    return _ring


class _NoopSpan:
    """Shared do-nothing context manager for FLAGS_telemetry=0."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class _SpanCtx:
    __slots__ = ("_span",)

    def __init__(self, span: Span):
        self._span = span

    def __enter__(self):
        return self._span

    def __exit__(self, *exc):
        span_end(self._span)
        return False


def span_begin(name: str, parent: Optional[SpanContext] = None,
               links=None, detached: bool = False,
               trace_id: Optional[str] = None,
               **attrs) -> Optional[Span]:
    """Open a span without a ``with`` block (executor hot path); pair
    with :func:`span_end`.  Returns None when telemetry is disabled.

    ``parent`` — an explicit :class:`SpanContext` overrides the
    thread-local stack: the span joins that context's trace (same
    trace_id, parented under its span_id) even on a different thread.
    ``detached=True`` keeps the span OFF this thread's parent stack —
    required when the span will be ended on another thread (ending a
    stacked span from elsewhere would strand it), or when it outlives
    the caller (a request root span spanning submit→respond must not
    adopt later same-thread spans as children).
    ``links`` — SpanContexts of other traces to reference.
    ``trace_id`` — adopt an externally-minted trace id at a root span
    (the cross-process propagation half: a router/replica hop carries
    the id in a header and both tiers' spans join one trace).  Ignored
    when a parent supplies the trace."""
    if not enabled():
        return None
    if parent is not None:
        parent_id, trace_id = parent.span_id, parent.trace_id
    else:
        stack = _stack()
        top = stack[-1] if stack else None
        parent_id = top.span_id if top is not None else None
        if top is not None:
            trace_id = top.trace_id
    span = Span(name, attrs, parent_id, threading.get_ident(),
                trace_id=trace_id, links=links)
    if not detached:
        _stack().append(span)
    return span


def span_end(span: Optional[Span]):
    """Close `span`, recording it in the ring.  Safe from any thread:
    a span on the CURRENT thread's stack unwinds it (everything left
    open above it by an exception is closed and recorded too); a
    detached or cross-thread span is closed directly.  Double-ends are
    no-ops (a span is recorded at most once)."""
    if span is None:
        return
    stack = _stack()
    if span not in stack:
        # detached span, or a stack span being ended from another
        # thread (the queue/thread-hop half of trace propagation)
        if span.end is None:
            span.end = time.monotonic()
            ring = _get_ring()  # before the lock: _get_ring takes it
            with _ring_lock:
                ring.append(span)
        return
    now = time.monotonic()
    ring = _get_ring()
    while stack:
        top = stack.pop()
        # a span another thread already ended keeps its recorded
        # duration and must not be appended to the ring twice
        if top.end is None:
            top.end = now
            with _ring_lock:
                ring.append(top)
        if top is span:
            break


def current_span() -> Optional[SpanContext]:
    """The innermost open span on THIS thread as a handoff-able
    :class:`SpanContext` (None when nothing is open or telemetry is
    off).  Capture before a queue/thread hop, re-attach on the far
    side with ``trace_span(..., parent=ctx)``."""
    if not enabled():
        return None
    stack = getattr(_tls, "stack", None)
    return stack[-1].context() if stack else None


def trace_span(name: str, parent: Optional[SpanContext] = None,
               links=None, **attrs):
    """``with trace_span("ckpt/write", step=n): ...`` — times the block
    on the monotonic clock and records a :class:`Span` with the current
    thread's innermost open span as parent — or, with ``parent=ctx``,
    under that explicit :class:`SpanContext`'s trace regardless of
    thread.  A no-op (shared singleton, no allocation beyond the call)
    under ``FLAGS_telemetry=0``."""
    if not enabled():
        return _NOOP
    return _SpanCtx(span_begin(name, parent=parent, links=links, **attrs))


def get_spans() -> List[Span]:
    """Completed spans, oldest first (bounded by
    ``FLAGS_trace_buffer_size``)."""
    with _ring_lock:
        return list(_ring) if _ring is not None else []


def clear_spans():
    global _ring, _counter_ring
    with _ring_lock:
        _ring = None
        _counter_ring = None
    _tls.stack = []


def span_tree(spans: Optional[List[Span]] = None) -> List[dict]:
    """Reconstruct the forest from a flat span list: returns root nodes
    as ``{"span": Span, "children": [...]}``, children in completion
    order."""
    spans = get_spans() if spans is None else spans
    nodes = {s.span_id: {"span": s, "children": []} for s in spans}
    roots = []
    for s in spans:
        node = nodes[s.span_id]
        parent = nodes.get(s.parent_id)
        (parent["children"] if parent else roots).append(node)
    return roots


def spans_to_chrome_events(spans: Optional[List[Span]] = None) -> List[dict]:
    return [s.to_event() for s in (get_spans() if spans is None else spans)]


# ---------------------------------------------------------------------------
# counter samples (Perfetto counter tracks, e.g. the HBM timeline)
# ---------------------------------------------------------------------------

_counter_ring: Optional[deque] = None


def _get_counter_ring() -> deque:
    global _counter_ring
    if _counter_ring is None:
        with _ring_lock:
            if _counter_ring is None:
                cap = int(flag_value("FLAGS_trace_buffer_size") or 4096)
                _counter_ring = deque(maxlen=max(1, cap))
    return _counter_ring


def counter_sample(name: str, series):
    """Record one point of a Perfetto **counter track** (chrome-trace
    'C' phase): ``series`` is a value or a ``{series_name: value}``
    dict (multiple series render stacked on one track — the HBM
    sampler emits ``{"total": ..., "dev0": ..., ...}``).  Bounded ring
    (``FLAGS_trace_buffer_size``), no-op with telemetry off."""
    if not enabled():
        return
    if not isinstance(series, dict):
        series = {"value": float(series)}
    ring = _get_counter_ring()
    sample = (name, time.monotonic(),
              {k: float(v) for k, v in series.items()})
    with _ring_lock:
        ring.append(sample)


def get_counter_samples() -> List[tuple]:
    """``(name, monotonic_ts, {series: value})`` tuples, oldest
    first."""
    with _ring_lock:
        return list(_counter_ring) if _counter_ring is not None else []


def counters_to_chrome_events() -> List[dict]:
    return [{"ph": "C", "name": name, "cat": "paddle_tpu",
             "pid": os.getpid(), "tid": 0,
             "ts": (t + _EPOCH_OFFSET) * 1e6, "args": dict(series)}
            for name, t, series in get_counter_samples()]


def export_chrome_trace(path: str,
                        spans: Optional[List[Span]] = None) -> str:
    """Write the span ring as chrome://tracing / Perfetto JSON
    (atomic tmp+rename; survives injected metrics_write faults).
    Serialization itself honors the never-raise contract too: span
    attrs that aren't JSON-native (np scalars, paths) stringify via
    ``default=str``, and anything still unserializable drops the export
    (``telemetry_write_failures``) instead of killing the step."""
    events = spans_to_chrome_events(spans)
    if spans is None:
        # live export: include counter-track samples (HBM timeline)
        events = events + counters_to_chrome_events()
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    try:
        text = json.dumps(doc, default=str)
    except (TypeError, ValueError) as e:
        stat_add("telemetry_write_failures")
        logger.warning("trace export %s failed to serialize: %s", path, e)
        return path
    _atomic_write(path, text)
    return path


# ---------------------------------------------------------------------------
# typed metrics
# ---------------------------------------------------------------------------

class Gauge:
    """Last-value-wins float metric (feed-ring occupancy, examples/sec,
    resume duration...)."""

    __slots__ = ("name", "_v", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._v = 0.0
        self._lock = threading.Lock()

    def set(self, v: float):
        with self._lock:
            self._v = float(v)

    def add(self, v: float):
        with self._lock:
            self._v += float(v)

    def set_max(self, v: float):
        """High-watermark update: keep the max of the current value and
        ``v`` (queue-depth peaks under bursty load — a sampled gauge
        only shows the depth at publish instants and misses the spikes
        that actually shed requests)."""
        v = float(v)
        with self._lock:
            if v > self._v:
                self._v = v

    def get(self) -> float:
        with self._lock:
            return self._v


# default buckets: milliseconds, 0.1ms .. 60s (fixed so two processes'
# histograms merge bucket-for-bucket)
DEFAULT_BUCKETS_MS: Tuple[float, ...] = (
    0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500,
    1000, 2500, 5000, 10000, 30000, 60000)

# recent-observation window exemplars are drawn from; top EXEMPLARS by
# value of this window = "the trace ids of recent slow samples"
_EXEMPLAR_WINDOW = 64
_EXEMPLAR_KEEP = 5


def _flag_buckets() -> Optional[Tuple[float, ...]]:
    """``FLAGS_histogram_buckets``: comma-separated upper bounds (ms)
    overriding DEFAULT_BUCKETS_MS for histograms created without
    explicit buckets.  Malformed specs fall back to the default (a bad
    flag must not take down the job)."""
    spec = flag_value("FLAGS_histogram_buckets")
    if not spec:
        return None
    try:
        vals = tuple(float(x) for x in str(spec).split(",") if x.strip())
    except ValueError:
        logger.warning("FLAGS_histogram_buckets %r is not a comma-"
                       "separated float list; using defaults", spec)
        return None
    return vals or None


class Histogram:
    """Fixed-bucket histogram with percentile summaries.

    Buckets are upper bounds (a +inf overflow bucket is implicit;
    its population is exposed as :meth:`overflow_count`).  Percentiles
    interpolate linearly inside the chosen bucket; an estimate landing
    in the overflow bucket is *censored* — reported as the top finite
    bucket edge and flagged, never extrapolated (the true value is
    only known to be ``> buckets[-1]``).  O(len(buckets)) memory
    forever.  ``observe(v, trace_id=...)`` additionally retains
    exemplars: the trace ids of recent slow samples, linking a latency
    percentile back to a concrete request trace.
    """

    __slots__ = ("name", "buckets", "_counts", "_sum", "_count", "_min",
                 "_max", "_lock", "_recent_ex")

    def __init__(self, name: str, buckets: Tuple[float, ...] = None):
        self.name = name
        self.buckets = tuple(sorted(buckets or _flag_buckets()
                                    or DEFAULT_BUCKETS_MS))
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0
        self._min = math.inf
        self._max = -math.inf
        self._lock = threading.Lock()
        self._recent_ex: deque = deque(maxlen=_EXEMPLAR_WINDOW)

    def observe(self, v: float, trace_id: Optional[str] = None):
        v = float(v)
        i = 0
        for i, ub in enumerate(self.buckets):
            if v <= ub:
                break
        else:
            i = len(self.buckets)  # overflow bucket
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            if trace_id is not None:
                self._recent_ex.append((v, trace_id, time.time()))

    def overflow_count(self) -> int:
        """Observations above the top finite bucket (the implicit +Inf
        bucket's own population)."""
        with self._lock:
            return self._counts[-1]

    def exemplars(self, k: int = _EXEMPLAR_KEEP) -> List[dict]:
        """The slowest ``k`` of the recent exemplar window, value-desc:
        ``{"value", "trace_id", "ts"}`` — the trace to pull up when the
        p99 looks wrong."""
        with self._lock:
            recent = list(self._recent_ex)
        recent.sort(key=lambda e: e[0], reverse=True)
        return [{"value": round(v, 4), "trace_id": t, "ts": round(ts, 3)}
                for v, t, ts in recent[:k]]

    def percentile(self, p: float, with_censor: bool = False):
        """p in [0, 100]; linear interpolation within the bucket.  An
        estimate in the overflow bucket returns the top bucket edge;
        ``with_censor=True`` returns ``(value, censored)`` so callers
        can mark it +Inf-censored instead of trusting the clamp."""
        with self._lock:
            counts, total = list(self._counts), self._count
            lo, hi = self._min, self._max
        censored = False
        if total == 0:
            return (0.0, censored) if with_censor else 0.0
        rank = p / 100.0 * total
        seen = 0.0
        value = hi
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if seen + c >= rank:
                if i == len(self.buckets):
                    # overflow bucket: the estimate is only a lower
                    # bound — report the censoring edge, not a guess
                    # interpolated toward one extreme max
                    value, censored = float(self.buckets[-1]), True
                    break
                b_lo = self.buckets[i - 1] if i > 0 else min(lo, 0.0)
                b_hi = self.buckets[i]
                b_lo, b_hi = max(b_lo, min(lo, b_hi)), min(b_hi, hi)
                frac = (rank - seen) / c
                value = b_lo + (b_hi - b_lo) * min(max(frac, 0.0), 1.0)
                break
            seen += c
        else:
            censored = counts[-1] > 0 and hi > self.buckets[-1]
        return (value, censored) if with_censor else value

    def summary(self) -> dict:
        with self._lock:
            if self._count == 0:
                return {"count": 0, "sum": 0.0}
            base = {"count": self._count, "sum": round(self._sum, 4),
                    "min": round(self._min, 4), "max": round(self._max, 4),
                    "mean": round(self._sum / self._count, 4),
                    "overflow": self._counts[-1]}
        censored = []
        for p in (50, 95, 99):
            v, cens = self.percentile(p, with_censor=True)
            base[f"p{p}"] = round(v, 4)
            if cens:
                censored.append(f"p{p}")
        if censored:
            # these percentiles sit in the +Inf overflow bucket: the
            # value is the top bucket edge (a floor, not an estimate)
            base["censored"] = censored
        ex = self.exemplars()
        if ex:
            base["exemplars"] = ex
        return base

    def cumulative_buckets(self) -> List[Tuple[float, int]]:
        """(upper_bound, cumulative_count) pairs, +inf last (Prometheus
        histogram exposition)."""
        with self._lock:
            counts = list(self._counts)
        out, cum = [], 0
        for ub, c in zip(self.buckets, counts):
            cum += c
            out.append((ub, cum))
        out.append((math.inf, cum + counts[-1]))
        return out


class Timer:
    """Histogram-backed duration metric::

        with metrics.timer("checkpoint_write_ms").time():
            ...
    """

    __slots__ = ("hist",)

    def __init__(self, hist: Histogram):
        self.hist = hist

    def time(self):
        return _TimerCtx(self.hist)

    def observe_ms(self, ms: float):
        self.hist.observe(ms)


class _TimerCtx:
    __slots__ = ("_hist", "_t0")

    def __init__(self, hist: Histogram):
        self._hist = hist

    def __enter__(self):
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self._hist.observe((time.monotonic() - self._t0) * 1e3)
        return False


class MetricsRegistry:
    """Typed-metric sibling of :class:`monitor.StatRegistry`: named
    gauges, histograms, and timers, with a combined :meth:`snapshot`
    that also embeds the monitor's counters.  Thread-safe (lock-guarded
    construction, per-metric locks on mutation)."""

    _instance = None
    _instance_lock = threading.Lock()

    def __init__(self):
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}
        self._lock = threading.Lock()

    @classmethod
    def instance(cls) -> "MetricsRegistry":
        if cls._instance is None:
            with cls._instance_lock:
                if cls._instance is None:
                    cls._instance = cls()
        return cls._instance

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name)
            return g

    def histogram(self, name: str,
                  buckets: Tuple[float, ...] = None) -> Histogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(name, buckets)
            return h

    def timer(self, name: str) -> Timer:
        return Timer(self.histogram(name))

    def snapshot(self, reset_counters: bool = False) -> dict:
        """{"counters": {...}, "gauges": {...}, "histograms": {...}} —
        counters via the monitor's atomic publish.  Each histogram entry
        carries its summary plus ``buckets`` (cumulative (le, count)
        pairs), so a snapshot fully renders to Prometheus later without
        touching the live registry."""
        with self._lock:
            gauges = list(self._gauges.items())
            hists = list(self._hists.items())
        return {
            "counters": dict(_monitor.publish(reset=reset_counters)),
            "gauges": {n: g.get() for n, g in sorted(gauges)},
            "histograms": {
                n: dict(h.summary(), buckets=h.cumulative_buckets())
                for n, h in sorted(hists)},
        }


metrics = MetricsRegistry.instance()


def gauge_set(name: str, value: float):
    """Module-level shorthand (no-op when telemetry is off)."""
    if enabled():
        metrics.gauge(name).set(value)


def histogram_observe(name: str, value: float,
                      trace_id: Optional[str] = None):
    """Module-level shorthand; ``trace_id`` retains the observation as
    an exemplar (the trace behind a slow sample)."""
    if enabled():
        metrics.histogram(name).observe(value, trace_id=trace_id)


def timer(name: str):
    """``with timer("ckpt_write_ms"): ...`` — no-op context manager
    when telemetry is off."""
    if not enabled():
        return _NOOP
    return metrics.timer(name).time()


# ---------------------------------------------------------------------------
# step bookkeeping (heartbeat inputs)
# ---------------------------------------------------------------------------

_step_state = {"step": 0, "last_step_ms": None, "examples_per_sec": None,
               "host_ms": None, "last_t": None,
               "started": process_start_time()}
_step_lock = threading.Lock()


def note_step(step: int, host_ms: float, examples: int):
    """Executor per-step hook: feeds the step-duration histogram, the
    throughput gauge, and the heartbeat.

    ``host_ms`` is host wall time spent inside ``Executor.run`` (with
    async dispatch this is dispatch cost, not device step time);
    ``last_step_ms``/``examples_per_sec`` derive from the interval
    between consecutive step completions, which IS the steady-state
    step time even when dispatch runs ahead of the device."""
    if not enabled():
        return
    now = time.monotonic()
    metrics.histogram("executor_step_host_ms").observe(host_ms)
    with _step_lock:
        last_t = _step_state["last_t"]
        _step_state["last_t"] = now
        _step_state["step"] = int(step)
        _step_state["host_ms"] = round(host_ms, 4)
        if last_t is not None and now > last_t:
            dt_ms = (now - last_t) * 1e3
            _step_state["last_step_ms"] = round(dt_ms, 4)
            if examples:
                rate = examples * 1e3 / dt_ms
                prev = _step_state["examples_per_sec"]
                # EMA: smooth over dispatch jitter, converge in ~10 steps
                rate = rate if prev is None else 0.8 * prev + 0.2 * rate
                _step_state["examples_per_sec"] = round(rate, 3)
    if _step_state["examples_per_sec"] is not None:
        metrics.gauge("examples_per_sec").set(
            _step_state["examples_per_sec"])


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------

def _metrics_dir() -> Optional[str]:
    d = flag_value("FLAGS_metrics_dir")
    return d or None


def _atomic_write(path: str, text: str):
    """tmp + os.replace publish; never raises into the caller (I/O
    failures bump ``telemetry_write_failures``).  Routed through the
    ``metrics_write`` fault site so CI can prove the never-raises
    contract."""
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        if fault.fire("metrics_write") == "raise":
            raise fault.InjectedFault(f"injected metrics write failure "
                                      f"({os.path.basename(path)})")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except OSError as e:
        stat_add("telemetry_write_failures")
        logger.warning("telemetry write %s failed: %s", path, e)
        try:
            os.remove(tmp)
        except OSError:
            pass  # ok: tmp may never have been created


def _prom_name(name: str) -> str:
    out = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
    return f"paddle_tpu_{out}"


def prometheus_text(snapshot: Optional[dict] = None) -> str:
    """Render a :meth:`MetricsRegistry.snapshot` in the strict
    Prometheus text exposition format: per family one ``# HELP`` and
    one ``# TYPE`` line, then the samples (counters, gauges, and
    cumulative-bucket histograms with ``_sum``/``_count``).  Validated
    by ``tools/check_stat_catalog.py validate_exposition`` in tier-1.
    A passed snapshot renders exactly as captured — nothing is read
    from the live registry."""
    snap = snapshot if snapshot is not None else metrics.snapshot()
    lines = []

    def head(pn: str, kind: str, src: str):
        lines.append(f"# HELP {pn} paddle_tpu {kind} {src} "
                     f"(see README stat catalog)")
        lines.append(f"# TYPE {pn} {kind}")

    for name, v in sorted(snap.get("counters", {}).items()):
        pn = _prom_name(name)
        head(pn, "counter", name)
        lines.append(f"{pn} {v}")
    for name, v in sorted(snap.get("gauges", {}).items()):
        pn = _prom_name(name)
        head(pn, "gauge", name)
        lines.append(f"{pn} {v}")
    for name, h in sorted(snap.get("histograms", {}).items()):
        pn = _prom_name(name)
        head(pn, "histogram", name)
        for ub, cum in h.get("buckets", []):
            le = "+Inf" if math.isinf(ub) else repr(float(ub))
            lines.append(f'{pn}_bucket{{le="{le}"}} {cum}')
        lines.append(f"{pn}_sum {h.get('sum', 0.0)}")
        lines.append(f"{pn}_count {h.get('count', 0)}")
    return "\n".join(lines) + "\n"


def write_prometheus(path: Optional[str] = None) -> Optional[str]:
    if not enabled():
        return None
    d = _metrics_dir()
    if path is None:
        if d is None:
            return None
        path = os.path.join(d, "metrics.prom")
    _atomic_write(path, prometheus_text())
    return path


def _device_memory() -> Optional[dict]:
    """The cards' memory for the heartbeat and ``/healthz``: bytes the
    caching allocator has handed out (``allocated_bytes``) and holds
    (``reserved_bytes``), in all and per device index; None on a
    process with no card (the CPU)."""
    import torch

    if not torch.cuda.is_available():
        return None
    try:
        per = {}
        for i in range(torch.cuda.device_count()):
            per[str(i)] = {
                "allocated_bytes": int(torch.cuda.memory_allocated(i)),
                "reserved_bytes": int(torch.cuda.memory_reserved(i))}
    except RuntimeError as e:
        logger.debug("device memory stats unavailable: %s", e)
        return None
    return {"allocated_bytes": sum(d["allocated_bytes"]
                                   for d in per.values()),
            "reserved_bytes": sum(d["reserved_bytes"]
                                  for d in per.values()),
            "per_device": per}


def write_heartbeat(path: Optional[str] = None) -> Optional[str]:
    """``heartbeat.json``: liveness + progress for an external watchdog
    (atomic write; a reader never sees a torn file)."""
    if not enabled():
        return None
    d = _metrics_dir()
    if path is None:
        if d is None:
            return None
        path = os.path.join(d, "heartbeat.json")
    with _step_lock:
        state = dict(_step_state)
    state.pop("last_t", None)
    hb = {"pid": os.getpid(), "time": time.time(),
          "uptime_s": round(time.time() - state.pop("started"), 3),
          "device_memory": _device_memory()}
    hb.update(state)
    _atomic_write(path, json.dumps(hb, indent=1, sort_keys=True))
    return path


# taps the black-box flight recorder (blackbox.py) hooks at
# import time; telemetry stays import-independent of blackbox (blackbox
# imports telemetry, never the reverse) so the tap is a plain callable
# attribute, None until blackbox is loaded
_blackbox_event_tap = None   # (kind, fields_dict) -> None
_blackbox_flush_tap = None   # () -> None


def log_event(kind: str, **fields):
    """Append one machine-parseable line to ``events.jsonl``
    (step timings, guard resolutions, checkpoint publishes, restarts).
    No-op without telemetry or a metrics dir; an I/O fault drops the
    line (``telemetry_events_dropped``) instead of raising."""
    if not enabled():
        return
    # the flight recorder mirrors every event into its in-memory ring
    # even without a metrics dir (the ring needs no filesystem; the
    # dump path checks for one itself)
    if _blackbox_event_tap is not None:
        _blackbox_event_tap(kind, fields)
    d = _metrics_dir()
    if d is None:
        return
    rec = {"ts": round(time.time(), 6), "event": kind, "pid": os.getpid()}
    rec.update(fields)
    try:
        if fault.fire("metrics_write") == "raise":
            raise fault.InjectedFault("injected event-log write failure")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "events.jsonl"), "a") as f:
            f.write(json.dumps(rec, sort_keys=True, default=str) + "\n")
    except OSError as e:
        stat_add("telemetry_events_dropped")
        logger.warning("event log write failed: %s", e)


# ---------------------------------------------------------------------------
# flush cadence
# ---------------------------------------------------------------------------

_flush_state = {"last": 0.0}
_flush_lock = threading.Lock()


def _tsdb_sample():
    """Record the live registry into the in-process time-series store
    (:mod:`paddle_tpu_torch.tsdb`) — the windowed-history half of the flush
    cadence.  It needs no metrics dir (the store is in-memory) and is
    itself gated on ``FLAGS_tsdb``."""
    from . import tsdb
    tsdb.sample_registry(metrics)


def maybe_flush() -> bool:
    """Hot-path cadence check: sample the time-series store and flush
    the file exporters if at least ``FLAGS_metrics_interval`` seconds
    passed since the last flush.  Costs one monotonic read + a
    comparison when it's not yet time.  Returns True only when the
    file exporters ran (the tsdb sample also fires on the cadence
    WITHOUT a metrics dir — windowed queries must work in-memory-only
    deployments)."""
    if not enabled():
        return False
    now = time.monotonic()
    # explicit 0.0 means flush every step — `or` would eat it
    interval = flag_value("FLAGS_metrics_interval")
    interval = 10.0 if interval is None else float(interval)
    # lock-free fast path: this runs on EVERY executor step, and with
    # the tsdb in the cadence it now runs even without a metrics dir —
    # the not-yet-time check must cost a read and a compare, not a
    # lock acquisition (double-checked under the lock before firing)
    if now - _flush_state["last"] < interval:
        return False
    with _flush_lock:
        if now - _flush_state["last"] < interval:
            return False
        _flush_state["last"] = now
    if _metrics_dir() is None:
        _tsdb_sample()
        return False
    flush(force=False)  # flush() samples the tsdb too
    return True


def flush(force: bool = True):
    """Write every exporter now: the tsdb sample, Prometheus textfile,
    heartbeat, and the span ring as ``trace.json``.  ``force=True``
    also resets the cadence clock (used at run end:
    TrainGuard.close/finalize, Executor.close)."""
    if not enabled():
        return
    _tsdb_sample()
    # flight-recorder cadence: metric-snapshot ring + rolling dump
    if _blackbox_flush_tap is not None:
        _blackbox_flush_tap()
    d = _metrics_dir()
    if d is None:
        return
    if force:
        with _flush_lock:
            _flush_state["last"] = time.monotonic()
    write_prometheus()
    write_heartbeat()
    export_chrome_trace(os.path.join(d, "trace.json"))
