"""In-process time-series store + multi-window SLO burn-rate monitor.

The port's copy of ``paddle_tpu/tsdb.py``, which is free of jax (the
port imports nothing of the JAX package).

The windowed-query layer the fleet observatory stands on.  The metrics
registry (:mod:`paddle_tpu_torch.telemetry`) answers "what is the value
NOW"; this module answers "what happened over the trailing N seconds"
— the question every autoscaling signal, burn-rate alert, and
``/fleetz`` window needs — without any external TSDB dependency.

* :class:`TSDB` — named series of ``(timestamp, value)`` points in
  fixed-size rings (``FLAGS_tsdb_points`` per series, a hard
  ``max_series`` cap per store), so memory is bounded at
  ``max_series × points × ~60 bytes`` no matter how long the process
  runs.  Windowed queries: :meth:`~TSDB.delta` and :meth:`~TSDB.rate`
  (counter semantics — **monotonic-reset aware**: a sample smaller
  than its predecessor is a process restart, the post-reset value
  counts as the increment instead of a huge negative swing),
  :meth:`~TSDB.quantile` / :meth:`~TSDB.avg` / :meth:`~TSDB.minmax`
  (gauge semantics over the raw samples in the window).
* :func:`sample_registry` — records every counter, gauge, and
  histogram summary of the live telemetry registry into the
  process-default store; :func:`paddle_tpu_torch.telemetry.maybe_flush`
  calls it on the existing ``FLAGS_metrics_interval`` cadence, so any
  instrumented process grows local history for free.  Gated by
  ``FLAGS_tsdb`` on top of the master ``FLAGS_telemetry`` switch;
  off = zero work, zero memory.
* :class:`BurnRateMonitor` — SRE-workbook multi-window burn-rate
  alerting over :class:`SloSpec`s: each evaluation computes the error
  budget burn over a **fast** and a **slow** trailing window
  (``FLAGS_slo_fast_window_s`` / ``FLAGS_slo_slow_window_s``); an
  alert FIRES when *both* windows burn at ≥ ``FLAGS_slo_burn_threshold``
  (the slow window proves it is real, the fast window proves it is
  still happening) and CLEARS with hysteresis only when the fast
  window drops below ``threshold × clear_ratio`` — a recovered fleet
  clears in about one fast window, a flapping one cannot chatter.
  Burn rate 1.0 = consuming exactly the whole error budget; the
  monitor also integrates total budget consumption over the store's
  retention (``budget_spent_pct``, ``exhausted``).

Stats (README catalog): dynamic gauges ``slo_burn_rate_<slo>_fast`` /
``slo_burn_rate_<slo>_slow`` per spec and ``slo_alerts_firing``.
"""
from __future__ import annotations

import collections
import math
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from .flags import flag_value

__all__ = ["TSDB", "SloSpec", "BurnRateMonitor", "default",
           "sample_registry"]


def _percentile_of(vals: List[float], q: float) -> float:
    """The repo's shared nearest-rank percentile (q in [0, 100]) over
    raw samples."""
    vals = sorted(vals)
    return vals[min(len(vals) - 1,
                    max(0, int(math.ceil(q / 100.0 * len(vals))) - 1))]


class _Series:
    __slots__ = ("name", "ring")

    def __init__(self, name: str, cap: int):
        self.name = name
        self.ring: collections.deque = collections.deque(
            maxlen=max(2, int(cap)))


class TSDB:
    """Bounded in-memory store of named ``(ts, value)`` series.

    ``points`` — ring capacity per series (default
    ``FLAGS_tsdb_points``); ``max_series`` — hard cap on distinct
    names (a runaway label cardinality must saturate, not OOM: past
    the cap new names are silently dropped and counted in
    :meth:`stats`).  Thread-safe; timestamps are ``time.monotonic()``
    unless the caller supplies its own clock."""

    def __init__(self, points: Optional[int] = None,
                 max_series: int = 4096):
        self._points = int(points if points is not None
                           else flag_value("FLAGS_tsdb_points") or 512)
        self._max_series = int(max_series)
        self._series: Dict[str, _Series] = {}
        self._dropped = 0
        self._lock = threading.Lock()

    # -- recording ----------------------------------------------------------
    def record(self, name: str, value, ts: Optional[float] = None,
               cap: Optional[int] = None) -> bool:
        """Append one point.  ``cap`` overrides the per-series ring
        size at creation only (e.g. a per-request latency series wants
        more points than a 10s-cadence gauge).  Returns False when the
        point was dropped (series cap reached or value non-numeric)."""
        try:
            v = float(value)
        except (TypeError, ValueError):
            return False
        if not math.isfinite(v):
            return False
        t = time.monotonic() if ts is None else float(ts)
        with self._lock:
            s = self._series.get(name)
            if s is None:
                if len(self._series) >= self._max_series:
                    self._dropped += 1
                    return False
                s = self._series[name] = _Series(
                    name, cap if cap is not None else self._points)
            s.ring.append((t, v))
        return True

    # -- raw access ---------------------------------------------------------
    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def points(self, name: str) -> List[Tuple[float, float]]:
        with self._lock:
            s = self._series.get(name)
            return list(s.ring) if s is not None else []

    def last(self, name: str) -> Optional[float]:
        with self._lock:
            s = self._series.get(name)
            return s.ring[-1][1] if s is not None and s.ring else None

    def window(self, name: str, seconds: float,
               now: Optional[float] = None) -> List[Tuple[float, float]]:
        """Points with ``ts >= now - seconds``, oldest first."""
        cutoff = (time.monotonic() if now is None else now) \
            - float(seconds)
        return [(t, v) for t, v in self.points(name) if t >= cutoff]

    # -- counter queries ----------------------------------------------------
    @staticmethod
    def _increase(pts: List[Tuple[float, float]]) -> float:
        """Sum of positive inter-sample increments.  A sample BELOW
        its predecessor is a monotonic-counter reset (replica
        restart): the post-reset value itself is the increment —
        never the raw (negative) difference, which would erase real
        traffic from every fleet rate the window covers."""
        total = 0.0
        prev = pts[0][1]
        for _, v in pts[1:]:
            total += (v - prev) if v >= prev else v
            prev = v
        return total

    def delta(self, name: str, seconds: float,
              now: Optional[float] = None) -> Optional[float]:
        """Counter increase over the trailing window (reset-aware; see
        :meth:`_increase`).  None with < 2 samples (one point proves
        no motion)."""
        pts = self.window(name, seconds, now)
        return self._increase(pts) if len(pts) >= 2 else None

    def rate(self, name: str, seconds: float,
             now: Optional[float] = None) -> Optional[float]:
        """Per-second counter rate over the trailing window (delta over
        the span actually covered by samples, so a sparse window does
        not dilute the rate toward zero).  One window scan — this is
        the federation hot path (one call per family per replica per
        /fleetz render)."""
        pts = self.window(name, seconds, now)
        if len(pts) < 2:
            return None
        span = pts[-1][0] - pts[0][0]
        if span <= 0:
            return None
        return self._increase(pts) / span

    # -- gauge queries ------------------------------------------------------
    def values(self, name: str, seconds: float,
               now: Optional[float] = None) -> List[float]:
        return [v for _, v in self.window(name, seconds, now)]

    def quantile(self, name: str, q: float, seconds: float,
                 now: Optional[float] = None) -> Optional[float]:
        """Nearest-rank quantile (``q`` in [0, 100]) of the raw samples
        in the window — 'what was the p99 of this gauge over the last
        N seconds'."""
        vals = self.values(name, seconds, now)
        return _percentile_of(vals, q) if vals else None

    def avg(self, name: str, seconds: float,
            now: Optional[float] = None) -> Optional[float]:
        vals = self.values(name, seconds, now)
        return sum(vals) / len(vals) if vals else None

    def minmax(self, name: str, seconds: float,
               now: Optional[float] = None
               ) -> Tuple[Optional[float], Optional[float]]:
        vals = self.values(name, seconds, now)
        return (min(vals), max(vals)) if vals else (None, None)

    # -- introspection ------------------------------------------------------
    def stats(self) -> dict:
        """Occupancy + the memory bound (the ``/fleetz``/``/statusz``
        ``tsdb`` block)."""
        with self._lock:
            n_series = len(self._series)
            n_points = sum(len(s.ring) for s in self._series.values())
            dropped = self._dropped
        return {"series": n_series, "points": n_points,
                "points_cap": self._points,
                "max_series": self._max_series,
                "series_dropped": dropped,
                # a (ts, value) float pair in a deque costs ~60 bytes
                "max_bytes": self._max_series * self._points * 60}


# ---------------------------------------------------------------------------
# process-default store + registry sampling (the telemetry cadence hook)
# ---------------------------------------------------------------------------

_default: Optional[TSDB] = None
_default_lock = threading.Lock()


def default() -> TSDB:
    """The process-default store ``sample_registry`` records into."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = TSDB()
    return _default


def reset_default():
    """Testing hook: drop the process-default store."""
    global _default
    with _default_lock:
        _default = None


def enabled() -> bool:
    return bool(flag_value("FLAGS_tsdb"))


def sample_registry(registry=None, db: Optional[TSDB] = None,
                    now: Optional[float] = None) -> int:
    """Record one point per live counter/gauge into ``db`` (the
    process default), plus each histogram's windowed essentials
    (``<name>_count`` as a counter series; ``<name>_p50``/``_p99`` as
    gauge series).  Called by :func:`telemetry.maybe_flush` on the
    ``FLAGS_metrics_interval`` cadence; returns how many points were
    recorded (0 when ``FLAGS_tsdb=0``)."""
    if not enabled():
        return 0
    from . import telemetry  # late: telemetry imports this module

    snap = (registry or telemetry.metrics).snapshot()
    db = db or default()
    t = time.monotonic() if now is None else now
    n = 0
    for name, v in snap.get("counters", {}).items():
        n += db.record(name, v, ts=t)
    for name, v in snap.get("gauges", {}).items():
        n += db.record(name, v, ts=t)
    for name, h in snap.get("histograms", {}).items():
        n += db.record(f"{name}_count", h.get("count", 0), ts=t)
        if h.get("count"):
            n += db.record(f"{name}_p50", h.get("p50", 0.0), ts=t)
            n += db.record(f"{name}_p99", h.get("p99", 0.0), ts=t)
    return n


# ---------------------------------------------------------------------------
# multi-window SLO burn-rate alerting
# ---------------------------------------------------------------------------

class SloSpec:
    """One SLO to watch.

    ``kind="availability"`` — error-rate burn: ``error_series`` /
    ``total_series`` name counter series in the store; the window's
    error fraction is ``delta(error)/delta(total)`` and the budget is
    ``1 - objective_pct/100`` (99% availability → 1% of requests may
    fail).

    ``kind="latency"`` — threshold burn over a raw-sample series
    (per-request or per-scrape latencies recorded as gauge points):
    the window's violation fraction is the share of samples above
    ``threshold_ms``; ``objective_pct`` is the percentile the
    threshold is pinned to (p99 SLO → 1% of requests may exceed it),
    so the budget is again ``1 - objective_pct/100``."""

    __slots__ = ("name", "kind", "error_series", "total_series",
                 "latency_series", "threshold_ms", "objective_pct")

    def __init__(self, name: str, kind: str, *,
                 error_series: Optional[str] = None,
                 total_series: Optional[str] = None,
                 latency_series: Optional[str] = None,
                 threshold_ms: Optional[float] = None,
                 objective_pct: Optional[float] = None):
        if kind not in ("availability", "latency"):
            raise ValueError(f"unknown SLO kind {kind!r}")
        if kind == "availability" and not (error_series and total_series):
            raise ValueError("availability SLO needs error_series and "
                             "total_series")
        if kind == "latency" and not (latency_series
                                      and threshold_ms is not None):
            raise ValueError("latency SLO needs latency_series and "
                             "threshold_ms")
        self.name = name
        self.kind = kind
        self.error_series = error_series
        self.total_series = total_series
        self.latency_series = latency_series
        self.threshold_ms = threshold_ms
        self.objective_pct = float(
            objective_pct if objective_pct is not None
            else flag_value("FLAGS_slo_availability_pct") or 99.0)

    @property
    def budget(self) -> float:
        """Allowed bad fraction (the error budget's rate form)."""
        return max(1e-9, 1.0 - self.objective_pct / 100.0)

    def bad_fraction(self, db: TSDB, seconds: float,
                     now: Optional[float] = None) -> Optional[float]:
        """The window's bad-event fraction, or None when the window
        holds no evidence (no traffic is NOT an SLO violation)."""
        if self.kind == "availability":
            total = db.delta(self.total_series, seconds, now)
            if not total or total <= 0:
                return None
            errors = db.delta(self.error_series, seconds, now) or 0.0
            return min(1.0, max(0.0, errors / total))
        vals = db.values(self.latency_series, seconds, now)
        if not vals:
            return None
        over = sum(1 for v in vals if v > self.threshold_ms)
        return over / len(vals)

    def describe(self) -> dict:
        d = {"name": self.name, "kind": self.kind,
             "objective_pct": self.objective_pct,
             "budget": round(self.budget, 6)}
        if self.kind == "availability":
            d["error_series"] = self.error_series
            d["total_series"] = self.total_series
        else:
            d["latency_series"] = self.latency_series
            d["threshold_ms"] = self.threshold_ms
        return d


class BurnRateMonitor:
    """Multi-window burn-rate alerting over a :class:`TSDB`.

    One :meth:`evaluate` per metrics-poll sweep is the intended
    cadence (the router calls it from the health-poll loop; a replica
    from ``/statusz``).  Stateless inputs, stateful alerts: firing /
    clearing transitions live here so flapping burn rates cannot
    chatter an operator pager."""

    def __init__(self, db: TSDB, specs: Sequence[SloSpec] = (),
                 fast_s: Optional[float] = None,
                 slow_s: Optional[float] = None,
                 threshold: Optional[float] = None,
                 clear_ratio: float = 0.5,
                 budget_window_s: Optional[float] = None,
                 publish: bool = True):
        self.db = db
        self.specs = list(specs)
        self.fast_s = float(fast_s if fast_s is not None
                            else flag_value("FLAGS_slo_fast_window_s")
                            or 60.0)
        self.slow_s = float(slow_s if slow_s is not None
                            else flag_value("FLAGS_slo_slow_window_s")
                            or 300.0)
        if self.fast_s >= self.slow_s:
            raise ValueError(
                f"burn-rate fast window ({self.fast_s}s) must be "
                f"shorter than the slow window ({self.slow_s}s) — the "
                f"pair is the whole point: slow proves it's real, "
                f"fast proves it's still happening")
        self.threshold = float(
            threshold if threshold is not None
            else flag_value("FLAGS_slo_burn_threshold") or 2.0)
        self.clear_ratio = float(clear_ratio)
        # budget exhaustion integrates over a long horizon (default:
        # 12 slow windows, i.e. 1h at the default 5min slow window)
        self.budget_window_s = float(budget_window_s
                                     if budget_window_s is not None
                                     else 12.0 * self.slow_s)
        self._publish = bool(publish)
        self._lock = threading.Lock()
        self._state: Dict[str, dict] = {
            s.name: {"firing": False, "since": None, "transitions": 0}
            for s in self.specs}
        self._last: Optional[dict] = None

    def add_spec(self, spec: SloSpec):
        with self._lock:
            self.specs.append(spec)
            self._state[spec.name] = {"firing": False, "since": None,
                                      "transitions": 0}

    def _burn(self, spec: SloSpec, seconds: float,
              now: Optional[float]) -> Optional[float]:
        frac = spec.bad_fraction(self.db, seconds, now)
        return None if frac is None else frac / spec.budget

    def evaluate(self, now: Optional[float] = None) -> dict:
        """One alerting sweep: compute fast/slow burns per spec, apply
        the fire/clear hysteresis, publish the gauges, and return the
        ``alerts`` block (also cached for :meth:`state`)."""
        from . import telemetry  # late: avoids the import cycle

        t = time.monotonic() if now is None else now
        alerts = []
        events = []  # logged after the lock: log_event does file I/O
        firing = 0
        for spec in self.specs:
            fast = self._burn(spec, self.fast_s, t)
            slow = self._burn(spec, self.slow_s, t)
            spent = spec.bad_fraction(self.db, self.budget_window_s, t)
            with self._lock:
                st = self._state[spec.name]
                if not st["firing"]:
                    if (fast is not None and slow is not None
                            and fast >= self.threshold
                            and slow >= self.threshold):
                        st["firing"] = True
                        st["since"] = t
                        st["transitions"] += 1
                        events.append(("slo_alert_fired", spec.name,
                                       fast, slow))
                else:
                    # hysteresis: clear only when the FAST window burn
                    # drops clearly below threshold (None = the window
                    # aged out every bad sample: recovered and idle)
                    cleared = (fast is None
                               or fast < self.threshold
                               * self.clear_ratio)
                    if cleared:
                        st["firing"] = False
                        st["since"] = None
                        st["transitions"] += 1
                        events.append(("slo_alert_cleared", spec.name,
                                       fast, slow))
                state = "firing" if st["firing"] else "ok"
                since = st["since"]
                transitions = st["transitions"]
            firing += state == "firing"
            alert = dict(spec.describe())
            alert.update({
                "state": state,
                "burn_fast": round(fast, 4) if fast is not None else None,
                "burn_slow": round(slow, 4) if slow is not None else None,
                "fast_window_s": self.fast_s,
                "slow_window_s": self.slow_s,
                "threshold": self.threshold,
                "firing_for_s": round(t - since, 3)
                if since is not None else None,
                "transitions": transitions,
                "budget_spent_pct": round(100.0 * spent / spec.budget, 2)
                if spent is not None else None,
                "exhausted": (spent is not None
                              and spent >= spec.budget),
            })
            alerts.append(alert)
            if self._publish:
                if fast is not None:
                    telemetry.gauge_set(
                        f"slo_burn_rate_{spec.name}_fast", fast)
                if slow is not None:
                    telemetry.gauge_set(
                        f"slo_burn_rate_{spec.name}_slow", slow)
        for kind, name, fast, slow in events:
            telemetry.log_event(
                kind, slo=name,
                burn_fast=round(fast, 3) if fast is not None else None,
                burn_slow=round(slow, 3) if slow is not None else None)
        if self._publish:
            telemetry.gauge_set("slo_alerts_firing", firing)
        out = {"alerts": alerts, "firing": firing,
               "threshold": self.threshold,
               "windows_s": [self.fast_s, self.slow_s]}
        with self._lock:
            self._last = out
        return out

    def state(self) -> dict:
        """The last :meth:`evaluate` result (evaluating now if none
        yet) — what ``/statusz``/``/fleetz`` embed without paying a
        fresh sweep per HTTP GET."""
        with self._lock:
            last = self._last
        return last if last is not None else self.evaluate()

    def firing(self) -> List[str]:
        with self._lock:
            return sorted(n for n, st in self._state.items()
                          if st["firing"])
