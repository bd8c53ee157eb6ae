"""Fleet front end: least-loaded replica router (stdlib-only).

The port's counterpart of ``paddle_tpu/serving/router.py``, with the same
classes, endpoints, headers, bodies, counters and routing decisions, so
it fronts replicas of either package.  Its capability steering (a
``sparse_ids`` body to a replica advertising ``embedding``) is inert in
a port fleet: the recsys tier is not ported (ROADMAP.md queue 1 item
8), so no port replica advertises the capability.

The tier above :mod:`paddle_tpu_torch.serving.server` — one
``ThreadingHTTPServer`` that spreads ``POST /predict`` and
``POST /generate`` across N replica server processes, making the
PR-5/6 metrics plane load-bearing: routing decisions come from each
replica's live ``/healthz`` (queue depth, inflight rows, ``ready``),
not from a static round-robin.

* **Health polling** — a background thread GETs every registered
  replica's ``/healthz`` on a ``FLAGS_router_health_interval_ms``
  cadence.  A replica is *routable* when its last successful poll is
  fresh, it reports ``ready`` (warmup primed — no first-request
  compile spike lands on live traffic), and it is not draining or
  closed.  Snapshots older than ``FLAGS_router_health_stale_ms``
  DEPRIORITIZE the replica (stale numbers must not keep winning the
  least-loaded comparison); ``FLAGS_router_eject_after`` consecutive
  failed polls EJECT it until a successful poll reports it
  serviceable (ready, not draining/closed) again.

* **Least-loaded placement** — among routable replicas the router
  picks the lowest ``queue_depth + inflight_rows + router-side
  in-flight`` (the last term counts requests this router already sent
  that have not returned — burst sensitivity between polls).
  Fresh+healthy replicas always beat stale-or-degraded ones; ejected
  or not-ready replicas are never picked.

* **Retry + explicit empty-fleet error** — a connect-level failure
  (refused / reset / remote-disconnected, or a reply cut short: the
  replica died or is mid-restart) books a health strike against that
  replica and retries
  ONCE on a different replica; served inference is idempotent, so a
  replayed request changes nothing.  In-flight HTTP errors are NOT
  retried.  With no routable replica at all the router answers
  **503** ``{"error": "overloaded", "reason": "no_ready_replicas"}``
  with a ``Retry-After`` header (poll-cadence-derived), so clients
  back off instead of hammering an empty fleet; replica 503s forward
  the replica's own ``Retry-After`` verbatim.

* **Hung-replica containment** — every forward carries a socket
  timeout (``FLAGS_router_forward_timeout_ms``, tightened by the
  request's remaining deadline budget): a *hung* replica (SIGSTOP'd,
  wedged — it still accepts connections, so connect-refused ejection
  never sees it) costs one bounded attempt instead of pinning a
  router thread until the client gives up.  A timeout strikes the
  replica's health (the same consecutive-failure counter the poll
  uses — repeated hangs eject it) and retries ONCE on an alternate
  (inference is idempotent; the replay wastes at most one batch
  slot); with no alternate, or a second timeout, the client gets
  **504** ``{"error": "forward_timeout", "trace_id": ...}``.  The
  listener itself never blocks — only the one handler thread waits.

* **End-to-end deadlines** — an ``X-PaddleTPU-Deadline-Ms`` request
  header (minted from ``FLAGS_router_default_deadline_ms`` when the
  client sent none) is the request's REMAINING latency budget: the
  router decrements its own elapsed time before every forward, the
  forward timeout tightens to the remainder, and a spent budget
  answers 503 ``deadline`` immediately — replica admission sheds on
  the same header, so a hopeless request never burns a batch slot
  anywhere in the fleet.

* **Canary rollouts** — ``canary(checkpoint_dir, fraction)``
  hot-swaps a new checkpoint onto a minority of replicas (``POST
  /swap`` per replica; fleet-atomic admission — one refusal reverts
  the rest and the canary never starts) and splits traffic by weights
  version: an error-feedback accumulator in ``pick()`` routes exactly
  ``fraction`` of requests to the canary subset.  A dedicated
  short-window :class:`~paddle_tpu_torch.tsdb.BurnRateMonitor` judges the
  canary side's availability and p99 from per-version series
  (``router_canary_requests`` / ``router_canary_failures`` /
  ``router_canary_request_ms``): sustained burn — or a canary replica
  crashing mid-soak — auto-reverts every canary replica to the
  retained previous weights (``router_canary_reverts``); a clean
  ``FLAGS_canary_soak_s`` soak promotes the checkpoint to the rest of
  the fleet (``router_canary_promotions``).  See README "Safe
  rollouts".

* **Trace continuity** — the router forwards (or mints) an
  ``X-PaddleTPU-Trace`` id; its own ``router/request`` →
  ``router/forward`` spans and the replica's ``serving/request`` tree
  adopt the same trace id, so one served request is one trace across
  both tiers, findable in both access logs.

* **SLO-derived autoscaling signal** — every poll sweep recomputes
  ``pressure = max(p99_ms / FLAGS_router_slo_p99_ms,
  avg_queue_depth / depth_target)`` over a sliding latency window and
  publishes ``fleet_wanted_replicas`` (gauge + ``/statusz``
  ``autoscale`` block): scale-up is proportional above pressure 1.0
  (capped at 4x live), scale-down only below the 0.4 hysteresis
  low-water mark — the hook a real autoscaler consumes.

* **Metrics federation** (``FLAGS_router_federate``) — the health-poll
  loop also scrapes each replica's ``/metrics`` (one strict-exposition
  parse via :mod:`paddle_tpu_torch.promtext` — the same implementation the
  lint validates with), keeps per-replica windowed series in a
  router-local :class:`paddle_tpu_torch.tsdb.TSDB` and computes fleet
  aggregates: counters SUM across replicas (windowed rates from the
  series), gauges report sum AND max, latency histograms merge
  bucket-vector-wise so the fleet p99 interpolates exactly like one
  replica's.  ``GET /fleetz`` serves the whole view (per-replica +
  aggregate windows, SLO/alert state, tsdb occupancy) and the
  router's own ``/metrics`` grows ``paddle_tpu_fleet_*`` families:
  one ``replica="host:port"``-labeled sample per replica plus the
  unlabeled fleet aggregate.

* **SLO burn-rate alerting** — a
  :class:`paddle_tpu_torch.tsdb.BurnRateMonitor` evaluates on every poll
  sweep over the router's windowed series: request availability
  (errors = no-ready + replica-error + forward-timeout outcomes over
  routed requests), replica availability (failed health polls over
  polls — the crash/hang detector), and the latency SLO (share of
  served requests over ``FLAGS_slo_p99_ms`` /
  ``FLAGS_router_slo_p99_ms``).  Alerts fire when both the fast and
  slow windows burn over ``FLAGS_slo_burn_threshold`` and clear with
  hysteresis; the ``alerts`` block rides ``/statusz`` and ``/fleetz``
  and the chaos harness asserts fire-inside-fault-window /
  clear-after / silent-on-clean.  The ``fleet_wanted_replicas``
  autoscale signal reads its p99 from the same windowed series
  (``router_request_ms`` samples in the tsdb) instead of a private
  ad-hoc deque.

Endpoints: ``POST /predict`` / ``POST /generate`` (forwarded;
replica responses — including overload 503s — pass through
verbatim), ``GET /healthz`` (503 when the fleet has no routable
replica), ``GET /metrics`` (strict Prometheus, live registry +
fleet-labeled federation families), ``GET /fleetz`` (federated
per-replica + aggregate windowed series, SLO state), ``GET /statusz``
(fleet topology, per-replica health/ejection state, routing decision
counters, autoscale signal, alerts).

Stats (README catalog): counters ``router_http_requests``,
``router_requests_routed``, ``router_retries``,
``router_forward_timeouts``, ``requests_shed_deadline``,
``router_no_ready_replicas``, ``router_replica_errors``,
``router_ejections``, ``router_recoveries``, ``router_health_polls``,
``router_health_poll_failures``, ``router_scrapes``,
``router_scrape_failures``; gauges ``router_replicas_ready``,
``fleet_wanted_replicas``, ``fleet_replicas_up``; histogram
``router_request_ms``.

Fault site (``paddle_tpu_torch/fault.py``): ``router_forward`` — ``fail``
simulates a connect-level forward failure (exercises the
strike-and-retry path), ``delay:ms`` / ``hang`` stall the forward
(what the timeout exists to bound) — the chaos harness's "slow"
scenario injects here.
"""
from __future__ import annotations

import concurrent.futures
import http.client
import json
import logging
import math
import os
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Tuple

from .. import blackbox, fault, promtext, telemetry, tsdb
from ..flags import all_flags, flag_value, register_flag
from ..monitor import process_uptime_s, stat_add
from . import usage
from .server import (DEADLINE_HEADER, TENANT_HEADER, TRACE_HEADER,
                     VERSION_HEADER, _AccessLog, _HTTPServer, _JsonHandler,
                     parse_deadline_header, parse_tenant_header,
                     parse_trace_header)

__all__ = ["Router", "RouterServer", "serve_router"]

logger = logging.getLogger("paddle_tpu_torch.serving.router")

# connect-level failures: the replica died before or while it answered
# (refused / reset / disconnected, or a reply cut short: a /predict
# reply is read whole before anything is relayed), so a retry on
# another replica replays idempotent inference and relays one answer
_CONNECT_ERRORS = (ConnectionRefusedError, ConnectionResetError,
                   BrokenPipeError, http.client.RemoteDisconnected,
                   http.client.IncompleteRead)

_LATENCY_WINDOW_S = 10.0    # sliding window feeding the SLO pressure
_SCALE_UP_CAP = 4.0         # wanted <= 4x live per signal recompute
_SCALE_DOWN_BAND = 0.4      # hysteresis: shrink only below this
_PROM_PREFIX = "paddle_tpu_"

register_flag("FLAGS_router_forward_timeout_ms", 0.0,
              "fleet router: socket timeout for one replica forward — a "
              "hung replica costs at most this per attempt (strikes its "
              "health, retries once on an alternate, 504 when none); "
              "a request's remaining deadline budget tightens it "
              "further; 0 falls back to the router's request_timeout_s "
              "(default 30s)")
register_flag("FLAGS_router_default_deadline_ms", 0.0,
              "fleet router: end-to-end deadline budget (ms) MINTED into "
              "X-PaddleTPU-Deadline-Ms for requests that arrive without "
              "one; the budget decrements across hops and replica "
              "admission sheds hopeless requests at the queue; 0 mints "
              "nothing (client-supplied headers still propagate)")
register_flag("FLAGS_router_health_interval_ms", 200.0,
              "fleet router: cadence of the background /healthz poll "
              "against every registered replica (queue depth, inflight "
              "rows, ready flag feed the least-loaded routing score)")
register_flag("FLAGS_router_health_stale_ms", 2000.0,
              "fleet router: a replica whose last successful health "
              "poll is older than this is DEPRIORITIZED (routed to only "
              "when no fresh replica exists) — a silent replica must "
              "not keep winning the least-loaded comparison on frozen "
              "numbers")
register_flag("FLAGS_router_eject_after", 2,
              "fleet router: consecutive failed health polls before a "
              "replica is EJECTED from the routing set entirely (it "
              "rejoins on the first successful poll reporting ready)")
register_flag("FLAGS_router_federate", True,
              "fleet router: scrape every replica's /metrics on the "
              "health-poll cadence, keep per-replica windowed series "
              "in the router tsdb, and serve the fleet aggregate on "
              "GET /fleetz plus replica-labeled fleet_* series on the "
              "router's own /metrics.  0 = health polling only")
register_flag("FLAGS_canary_fraction", 0.25,
              "canary rollout: fraction of the fleet Router.canary "
              "hot-swaps to the new checkpoint and weights the "
              "traffic split by (bounded to [1, N-1] replicas; "
              "paddle_tpu_torch/serving/router.py)")
register_flag("FLAGS_canary_soak_s", 60.0,
              "canary rollout: soak window.  A canary that survives "
              "this long without a per-version burn-rate alert (or a "
              "canary replica crash) promotes to the rest of the "
              "fleet; sustained burn before then auto-reverts")
register_flag("FLAGS_disagg_reprefill", False,
              "disaggregated routing: when the cache-holding decode "
              "replica dies mid-generation the router fails the "
              "request with the explicit 'affinity_lost' taxonomy by "
              "default (never a silent re-prefill); 1 lets the router "
              "restart the whole prefill->adopt pipeline once on "
              "surviving replicas instead")


def _short_family(name: str) -> str:
    """Scraped family name -> catalog name (the exporter prefixes
    every family with ``paddle_tpu_``)."""
    return name[len(_PROM_PREFIX):] if name.startswith(_PROM_PREFIX) \
        else name


def _is_connect_error(exc) -> bool:
    if isinstance(exc, _CONNECT_ERRORS):
        return True
    reason = getattr(exc, "reason", None)
    return isinstance(reason, _CONNECT_ERRORS)


def _is_timeout_error(exc) -> bool:
    """A forward that ran out its socket timeout: the replica accepted
    the connection but never answered — the hung-replica signature
    (connect-refused means DEAD, timeout means WEDGED; they take
    different containment paths)."""
    if isinstance(exc, TimeoutError):  # socket.timeout is an alias
        return True
    reason = getattr(exc, "reason", None)
    return isinstance(reason, TimeoutError)


class _Replica:
    """Router-side state for one replica endpoint."""

    def __init__(self, url: str):
        self.url = url.rstrip("/")
        # stable per-replica label: host:port survives respawns (the
        # supervisor pins ports), so one replica is one series forever
        self.rid = self.url.split("://", 1)[-1]
        self.health: Optional[dict] = None     # last good /healthz body
        self.health_ts: float = 0.0            # monotonic, last success
        self.poll_failures = 0                 # consecutive
        self.ejected = False
        self.last_error: Optional[str] = None
        self.inflight = 0                      # router-side, this proc
        self.routed = 0
        self.retries_to = 0                    # retries that landed here
        self.errors = 0
        # federation: the last good /metrics parse
        self.scrape: Optional[Dict[str, promtext.Family]] = None
        self.scrape_ts: float = 0.0
        self.scrape_failures = 0               # consecutive

    # -- routing view -------------------------------------------------------
    def ready(self) -> bool:
        if self.ejected or self.health is None:
            return False
        h = self.health
        if h.get("status") in ("draining", "closed"):
            return False
        return bool(h.get("ready", True))  # pre-ready replicas: absent=ok

    def stale(self, stale_s: float) -> bool:
        return (time.monotonic() - self.health_ts) > stale_s

    def degraded(self) -> bool:
        return bool(self.health) and self.health.get("status") == "degraded"

    def role(self) -> str:
        """Disagg role learned from /healthz (absent = 'both': every
        pre-disagg replica serves the full pipeline)."""
        return (self.health or {}).get("role") or "both"

    def capabilities(self) -> tuple:
        """Extra serving capabilities learned from /healthz (e.g.
        'embedding' from recsys replicas) — absent = none.  Learned
        like the disagg role: off every health poll, never configured
        router-side."""
        return tuple((self.health or {}).get("capabilities") or ())

    def weights_version(self) -> Optional[int]:
        """The replica's published weights version from its last good
        health poll (None until one lands)."""
        v = (self.health or {}).get("weights_version")
        return int(v) if v is not None else None

    def serves(self, role: Optional[str]) -> bool:
        """Can this replica take a hop of kind ``role``?  'prefill'
        and 'decode' hops accept a specialized replica OR a 'both'
        one; None = any replica (the /predict path is role-blind).
        A 'decode' hop additionally requires the replica to be
        adopt-capable (paged generation engine) — a dense 'both'
        replica would 404 the /adopt, turning a valid request into a
        client-visible error.  Capability steering is symmetric: an
        'embedding' hop (a /predict body carrying sparse_ids) requires
        the capability — a dense replica has no sparse_ids feed and
        would 400 it — and a 'dense' hop excludes embedding replicas,
        whose only model is the recsys net."""
        if role is None:
            return True
        if role == "embedding":
            return "embedding" in self.capabilities()
        if role == "dense":
            return "embedding" not in self.capabilities()
        if self.role() not in (role, "both"):
            return False
        if role == "decode":
            gen = (self.health or {}).get("generation") or {}
            return gen.get("paged") is not None
        return True

    def load(self) -> float:
        """Least-loaded score: replica-reported queue depth + rows in
        flight on its workers, plus requests THIS router already sent
        it that have not come back (the between-polls burst term)."""
        serving = (self.health or {}).get("serving") or {}
        return (float(serving.get("queue_depth") or 0)
                + float(serving.get("inflight_rows") or 0)
                + float(self.inflight))

    def queue_cap(self) -> int:
        serving = (self.health or {}).get("serving") or {}
        return int(serving.get("queue_cap") or 0)

    def snapshot(self, stale_s: float) -> dict:
        serving = (self.health or {}).get("serving") or {}
        age_ms = (time.monotonic() - self.health_ts) * 1e3 \
            if self.health_ts else None
        return {
            "url": self.url,
            "ready": self.ready(),
            "role": self.role(),
            "capabilities": list(self.capabilities()),
            "ejected": self.ejected,
            "stale": self.stale(stale_s) if self.health else True,
            "status": (self.health or {}).get("status"),
            "poll_failures": self.poll_failures,
            "queue_depth": serving.get("queue_depth"),
            "inflight_rows": serving.get("inflight_rows"),
            "router_inflight": self.inflight,
            "load": self.load() if self.health else None,
            "health_age_ms": round(age_ms, 1) if age_ms is not None
            else None,
            "routed": self.routed,
            "retries_to": self.retries_to,
            "errors": self.errors,
            "last_error": self.last_error,
            "rid": self.rid,
            "weights_version": self.weights_version(),
            "scrape_age_ms": round(
                (time.monotonic() - self.scrape_ts) * 1e3, 1)
            if self.scrape_ts else None,
            "scrape_failures": self.scrape_failures,
        }


class Router:
    """Health-polled least-loaded router over N replica server URLs.

    ``replicas`` — iterable of base URLs (``http://host:port``).  The
    poll thread starts with ``autostart``; replicas can be added or
    removed live (``add_replica`` / ``remove_replica`` — a rollout
    that replaces a process at the same URL needs no registry change).
    """

    def __init__(self, replicas=(), slo_p99_ms: Optional[float] = None,
                 poll_interval_ms: Optional[float] = None,
                 stale_ms: Optional[float] = None,
                 eject_after: Optional[int] = None,
                 request_timeout_s: float = 30.0,
                 forward_timeout_ms: Optional[float] = None,
                 federate: Optional[bool] = None,
                 slo_fast_s: Optional[float] = None,
                 slo_slow_s: Optional[float] = None,
                 slo_burn_threshold: Optional[float] = None,
                 slo_availability_pct: Optional[float] = None,
                 autostart: bool = True):
        self._slo_p99_ms = float(
            slo_p99_ms if slo_p99_ms is not None
            else flag_value("FLAGS_router_slo_p99_ms"))
        self._poll_s = float(
            poll_interval_ms if poll_interval_ms is not None
            else flag_value("FLAGS_router_health_interval_ms")) / 1e3
        self._stale_s = float(
            stale_ms if stale_ms is not None
            else flag_value("FLAGS_router_health_stale_ms")) / 1e3
        self.eject_after = max(1, int(
            eject_after if eject_after is not None
            else flag_value("FLAGS_router_eject_after")))
        self.request_timeout_s = float(request_timeout_s)
        # per-forward socket timeout: the most a hung replica can cost
        # one attempt (0/unset falls back to the request timeout)
        fwd = float(forward_timeout_ms if forward_timeout_ms is not None
                    else flag_value("FLAGS_router_forward_timeout_ms")
                    or 0.0)
        self.forward_timeout_s = fwd / 1e3 if fwd > 0 \
            else self.request_timeout_s

        self._lock = threading.Lock()
        self._replicas: Dict[str, _Replica] = {}
        for url in replicas:
            self._replicas[url.rstrip("/")] = _Replica(url)
        self._started = time.time()
        self._n = {"requests": 0, "routed": 0, "retries": 0,
                   "no_ready": 0, "replica_errors": 0, "ejections": 0,
                   "recoveries": 0, "health_polls": 0,
                   "health_poll_failures": 0, "forward_timeouts": 0,
                   "deadline_sheds": 0, "scrapes": 0,
                   "scrape_failures": 0, "disagg_generations": 0,
                   "affinity_lost": 0, "reprefills": 0,
                   "canary_starts": 0, "canary_reverts": 0,
                   "canary_promotions": 0, "canary_requests": 0,
                   "canary_failures": 0, "base_requests": 0,
                   "base_failures": 0}
        self._h_request = telemetry.Histogram("router_request_ms")
        # the windowed-series store behind the autoscale signal, the
        # federated fleet view, and the burn-rate monitor.  Router-
        # local (NOT the process default): in-process tests run router
        # and replicas in one process and the fleet view must not read
        # its own replica-side series
        self._db = tsdb.TSDB()
        self.federate = bool(flag_value("FLAGS_router_federate")
                             if federate is None else federate)
        slo_latency_ms = float(flag_value("FLAGS_slo_p99_ms") or 0.0) \
            or self._slo_p99_ms
        self.burn_monitor = tsdb.BurnRateMonitor(
            self._db,
            [tsdb.SloSpec("availability", "availability",
                          error_series="router_request_failures",
                          total_series="router_requests_total",
                          objective_pct=slo_availability_pct),
             tsdb.SloSpec("replica_availability", "availability",
                          error_series="router_poll_failures_total",
                          total_series="router_polls_total",
                          objective_pct=slo_availability_pct),
             tsdb.SloSpec("p99", "latency",
                          latency_series="router_request_ms",
                          threshold_ms=slo_latency_ms,
                          objective_pct=99.0)],
            fast_s=slo_fast_s, slow_s=slo_slow_s,
            threshold=slo_burn_threshold)
        # canary rollout: None, or the live soak's state dict (see
        # canary()).  _canary_accum is the deterministic traffic-split
        # accumulator — an error-feedback counter hits the requested
        # fraction EXACTLY over any window, where a PRNG would let a
        # short soak over- or under-expose the canary by luck
        self._canary: Optional[dict] = None
        self._canary_monitor: Optional[tsdb.BurnRateMonitor] = None
        self._canary_accum = 0.0
        self._last_canary: Optional[dict] = None
        self._autoscale = {"wanted_replicas": None, "pressure": None,
                           "p99_ms": None, "slo_p99_ms": self._slo_p99_ms,
                           "avg_queue_depth": None, "live": 0}
        # a co-located FleetSupervisor may attach itself here (see
        # FleetSupervisor.attach_router) so /fleetz and /debugz carry
        # death attributions next to the routing view
        self.supervisor = None
        self._closed = threading.Event()
        self._poll_thread: Optional[threading.Thread] = None
        # persistent poll workers (idle threads are cheap; per-sweep
        # thread churn is not).  16 bounds the damage of many replicas
        # blackholing at once; each poll is timeout-bounded anyway.
        self._poll_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=16, thread_name_prefix="router-poll")
        if autostart:
            self.start()

    # -- registry -----------------------------------------------------------
    def add_replica(self, url: str):
        with self._lock:
            self._replicas.setdefault(url.rstrip("/"), _Replica(url))

    def remove_replica(self, url: str):
        with self._lock:
            self._replicas.pop(url.rstrip("/"), None)

    def replica_urls(self) -> List[str]:
        with self._lock:
            return list(self._replicas)

    def _all(self) -> List[_Replica]:
        with self._lock:
            return list(self._replicas.values())

    # -- health polling -----------------------------------------------------
    def start(self):
        if self._poll_thread is None:
            self._poll_thread = threading.Thread(
                target=self._poll_loop, name="router-health-poll",
                daemon=True)
            self._poll_thread.start()

    def close(self):
        self._closed.set()
        if self._poll_thread is not None:
            self._poll_thread.join(timeout=5.0)
        self._poll_pool.shutdown(wait=False)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False

    def _poll_loop(self):
        # an exception escaping poll_once kills health polling for the
        # whole fleet (every replica would go stale and eject) — dump
        # the flight recorder before the thread dies
        try:
            while not self._closed.wait(self._poll_s):
                self.poll_once()
        except BaseException as e:
            blackbox.dump_exception("router_poll_loop", e)
            raise

    def poll_once(self):
        """One health sweep over every replica + an autoscale-signal
        recompute.  Replicas poll CONCURRENTLY (on a persistent pool —
        a fresh thread per replica per sweep would churn 5N threads/s
        at the default cadence): a blackholed endpoint blocking its
        full timeout must not stall the sweep past the staleness
        budget and drag every healthy replica into the stale tier on
        frozen numbers.  Public: tests and the fleet supervisor call
        it to converge the routing view without waiting out the
        cadence."""
        reps = self._all()
        if len(reps) == 1:
            self._poll_replica(reps[0])
        elif reps:
            futs = [self._poll_pool.submit(self._poll_replica, r)
                    for r in reps]
            join_s = max(0.5, self._stale_s / 2.0) + 1.0
            concurrent.futures.wait(futs, timeout=join_s)
        self._recompute_autoscale()
        self._record_sweep_series()
        self.burn_monitor.evaluate()
        self._canary_evaluate()

    def _poll_replica(self, rep: _Replica):
        self._count("health_polls")
        stat_add("router_health_polls")
        timeout = max(0.5, self._stale_s / 2.0)
        try:
            with urllib.request.urlopen(rep.url + "/healthz",
                                        timeout=timeout) as r:
                body = json.loads(r.read())
        except urllib.error.HTTPError as e:
            # a 503 /healthz is still an ANSWER (closed engine): parse
            # it so status/ready reflect what the replica said — but
            # only a body that IS a health document counts; a 500 with
            # an error payload (broken health endpoint) must strike
            try:
                body = json.loads(e.read())
            except (OSError, ValueError):
                body = None
            if not isinstance(body, dict) or "status" not in body:
                self._poll_failed(rep, f"HTTP {e.code}")
                return
        except (OSError, TimeoutError, ValueError) as e:
            self._poll_failed(rep, f"{type(e).__name__}: {e}")
            return
        # an EJECTED replica rejoins only on a poll reporting it
        # actually serviceable (ready, not draining/closed) — the
        # documented FLAGS_router_eject_after contract.  A replica
        # flapping between connect-refused and answering-but-closed
        # must not churn the ejection/recovery counters (and operator
        # alerts keyed on them) without ever serving.
        serviceable = (bool(body.get("ready", True))
                       and body.get("status") not in ("draining",
                                                      "closed"))
        with self._lock:
            recovered = rep.ejected and serviceable
            rep.health = body
            rep.health_ts = time.monotonic()
            rep.poll_failures = 0
            rep.last_error = None
            if recovered:
                rep.ejected = False
        if recovered:
            self._count("recoveries")
            stat_add("router_recoveries")
            telemetry.log_event("router_replica_recovered", url=rep.url)
        if self.federate:
            self._scrape_replica(rep, timeout)

    def _scrape_replica(self, rep: _Replica, timeout: float):
        """Pull one replica's ``/metrics`` on the poll cadence and
        record its counter/gauge families as per-replica series (name
        pattern ``<family>[<host:port>]``) plus each histogram's
        ``_count``.  The parse is best-effort per family (a malformed
        family must not blind the fleet view to the rest); a failed
        scrape keeps the last good parse but stops advancing its
        series, so windowed rates age to None instead of freezing."""
        self._count("scrapes")
        stat_add("router_scrapes")
        try:
            with urllib.request.urlopen(rep.url + "/metrics",
                                        timeout=timeout) as r:
                text = r.read().decode("utf-8", "replace")
            fams = promtext.parse_exposition(text)
        except (OSError, TimeoutError, ValueError,
                urllib.error.HTTPError) as e:
            self._count("scrape_failures")
            stat_add("router_scrape_failures")
            with self._lock:
                rep.scrape_failures += 1
            logger.debug("scrape of %s failed: %s", rep.url, e)
            return
        now = time.monotonic()
        with self._lock:
            rep.scrape = fams
            rep.scrape_ts = now
            rep.scrape_failures = 0
        for name, fam in fams.items():
            short = _short_family(name)
            if fam.type in ("counter", "gauge"):
                v = fam.value()
                if v is not None:
                    self._db.record(f"{short}[{rep.rid}]", v, ts=now)
                if short.startswith("serving_tenant_"):
                    # per-tenant labeled samples get their own series
                    # per (family, tenant, replica): the reset-aware
                    # evidence /fleetz federates — delta/rate survive
                    # a replica SIGKILL-respawn where raw cross-fleet
                    # sums would dip and double-count
                    for s in fam.samples:
                        t = s.labels.get("tenant")
                        if t:
                            self._db.record(
                                f"{short}{{{t}}}[{rep.rid}]",
                                s.value, ts=now)
            elif fam.type == "histogram":
                self._db.record(f"{short}_count[{rep.rid}]",
                                fam.histogram_count(), ts=now)

    def _record_sweep_series(self):
        """Per-sweep bookkeeping series: the router's own counters
        (the burn-rate monitor's evidence) and fleet-level gauges."""
        now = time.monotonic()
        with self._lock:
            n = dict(self._n)
        # client-visible request failures: an empty fleet, a dead
        # forward, or an unretryable hang — NOT deadline sheds (the
        # client's own budget) and NOT replica-side admission 503s
        # (explicit backpressure passing through verbatim)
        self._db.record("router_request_failures",
                        n["no_ready"] + n["replica_errors"]
                        + n["forward_timeouts"], ts=now)
        self._db.record("router_requests_total", n["requests"], ts=now)
        self._db.record("router_polls_total", n["health_polls"], ts=now)
        self._db.record("router_poll_failures_total",
                        n["health_poll_failures"], ts=now)
        up = sum(1 for r in self._all()
                 if r.health is not None and not r.ejected)
        self._db.record("fleet_replicas_up", up, ts=now)
        telemetry.gauge_set("fleet_replicas_up", up)
        # fleet_tenant_* rollup series: the latest scraped per-tenant
        # counters summed across replicas, one series per
        # (family, tenant).  Dashboards read these; the conservation
        # math in /fleetz reads the per-replica series instead (these
        # raw sums dip on a replica respawn, those stay reset-aware)
        tenant_sums: Dict[str, float] = {}
        for rep in self._all():
            with self._lock:
                fams = rep.scrape
            if not fams:
                continue
            for name, fam in fams.items():
                short = _short_family(name)
                if fam.type != "counter" \
                        or not short.startswith("serving_tenant_"):
                    continue
                field = short[len("serving_tenant_"):]
                for s in fam.samples:
                    t = s.labels.get("tenant")
                    if t:
                        key = f"fleet_tenant_{field}{{{t}}}"
                        tenant_sums[key] = \
                            tenant_sums.get(key, 0.0) + s.value
        for key, v in tenant_sums.items():
            self._db.record(key, v, ts=now)
        with self._lock:
            epoch = (self._canary or {}).get("epoch")
        if epoch is not None:
            # the canary judge's evidence: per-version request/failure
            # counters (availability burn) — latency samples land per
            # request in _canary_observe.  Stable names feed /fleetz;
            # the #epoch twins feed this canary's judge (see canary())
            self._db.record("router_canary_requests",
                            n["canary_requests"], ts=now)
            self._db.record("router_canary_failures",
                            n["canary_failures"], ts=now)
            self._db.record(f"router_canary_requests#{epoch}",
                            n["canary_requests"], ts=now)
            self._db.record(f"router_canary_failures#{epoch}",
                            n["canary_failures"], ts=now)
            self._db.record("router_base_requests",
                            n["base_requests"], ts=now)
            self._db.record("router_base_failures",
                            n["base_failures"], ts=now)

    def _poll_failed(self, rep: _Replica, detail: str):
        self._count("health_poll_failures")
        stat_add("router_health_poll_failures")
        with self._lock:
            rep.poll_failures += 1
            rep.last_error = detail
            eject_now = (not rep.ejected
                         and rep.poll_failures >= self.eject_after)
            if eject_now:
                rep.ejected = True
        if eject_now:
            self._count("ejections")
            stat_add("router_ejections")
            logger.warning("replica %s ejected after %d failed health "
                           "polls (%s)", rep.url, rep.poll_failures,
                           detail)
            telemetry.log_event("router_replica_ejected", url=rep.url,
                                detail=detail)

    # -- autoscaling signal -------------------------------------------------
    def _window_p99(self) -> Optional[float]:
        """p99 of served latencies over the trailing window, read from
        the SAME tsdb series (`router_request_ms`) the burn-rate
        monitor and /fleetz expose — one windowed store, no private
        deque to drift from it."""
        return self._db.quantile("router_request_ms", 99,
                                 _LATENCY_WINDOW_S)

    def _recompute_autoscale(self):
        routable = [r for r in self._all() if r.ready()]
        live = len(routable)
        p99 = self._window_p99()
        depths = [float((r.health.get("serving") or {})
                        .get("queue_depth") or 0) for r in routable]
        caps = [r.queue_cap() for r in routable if r.queue_cap() > 0]
        avg_depth = sum(depths) / live if live else None
        # depth_target: a quarter-full admission queue is standing
        # backlog worth scaling for (well before shedding at cap)
        depth_target = max(1.0, (sum(caps) / len(caps)) / 4.0) \
            if caps else 1.0
        p99_pressure = (p99 / self._slo_p99_ms) \
            if p99 is not None and self._slo_p99_ms > 0 else 0.0
        depth_pressure = (avg_depth / depth_target) \
            if avg_depth is not None else 0.0
        pressure = max(p99_pressure, depth_pressure)
        if live == 0:
            wanted = max(1, len(self._all()))
        elif pressure > 1.0:
            wanted = min(int(math.ceil(live * _SCALE_UP_CAP)),
                         int(math.ceil(live * pressure)))
        elif pressure < _SCALE_DOWN_BAND and live > 1:
            # hysteresis band: only shrink when clearly idle, and never
            # below one replica
            wanted = max(1, int(math.ceil(live * max(pressure, 0.1)
                                          / 0.8)))
        else:
            wanted = live
        with self._lock:
            self._autoscale = {
                "wanted_replicas": wanted,
                "pressure": round(pressure, 4),
                "p99_ms": round(p99, 3) if p99 is not None else None,
                "slo_p99_ms": self._slo_p99_ms,
                "avg_queue_depth": round(avg_depth, 2)
                if avg_depth is not None else None,
                "live": live,
            }
        telemetry.gauge_set("fleet_wanted_replicas", wanted)
        telemetry.gauge_set("router_replicas_ready", live)

    # -- placement ----------------------------------------------------------
    def pick(self, exclude=(), role: Optional[str] = None
             ) -> Optional[_Replica]:
        """Least-loaded routable replica: fresh+healthy first, then
        stale-or-degraded (deprioritized, still better than shedding);
        ejected / not-ready / excluded never.  ``role`` restricts the
        pool to replicas serving that disagg hop ('prefill'/'decode';
        'both'-role replicas qualify for either).  None = empty
        fleet.

        During a canary soak, placement splits by weights version: an
        error-feedback accumulator sends exactly
        ``canary['fraction']`` of picks to the canary subset and the
        rest to the base subset — within each side the normal
        least-loaded/fresh-first order holds, and a side with no
        routable replica spills to the other (availability beats
        split fidelity; the judge sees the spill as missing canary
        traffic, never as client errors)."""
        fresh: List[Tuple[float, _Replica]] = []
        backup: List[Tuple[float, _Replica]] = []
        for rep in self._all():
            if rep.url in exclude or not rep.ready() \
                    or not rep.serves(role):
                continue
            tier = backup if (rep.stale(self._stale_s)
                              or rep.degraded()) else fresh
            tier.append((rep.load(), rep))
        canary_urls = None
        want_canary = False
        with self._lock:
            if self._canary is not None and (fresh or backup):
                canary_urls = set(self._canary["urls"])
                self._canary_accum += self._canary["fraction"]
                want_canary = self._canary_accum >= 1.0
                if want_canary:
                    self._canary_accum -= 1.0
        if canary_urls is not None:
            def side(tier, canary_side):
                return [t for t in tier
                        if (t[1].url in canary_urls) == canary_side]
            order = (side(fresh, want_canary)
                     or side(backup, want_canary)
                     or side(fresh, not want_canary)
                     or side(backup, not want_canary))
            if order:
                return min(order, key=lambda t: t[0])[1]
            return None
        pool = fresh or backup
        if not pool:
            return None
        return min(pool, key=lambda t: t[0])[1]

    # -- forwarding ---------------------------------------------------------
    def _count(self, key: str, n: int = 1):
        with self._lock:
            self._n[key] += n

    def _send(self, rep: _Replica, route: str, body: bytes,
              trace_id: Optional[str], timeout_s: float,
              deadline_ms: Optional[float],
              content_type: str = "application/json",
              tenant: Optional[str] = None
              ) -> Tuple[int, bytes, str, Optional[str],
                         Optional[str]]:
        headers = {"Content-Type": content_type,
                   TRACE_HEADER: trace_id or ""}
        if deadline_ms is not None:
            # the REMAINING budget (already decremented by this
            # router's elapsed time): replica admission sheds on it
            headers[DEADLINE_HEADER] = f"{deadline_ms:.1f}"
        if tenant:
            # the attribution identity rides EVERY hop — on a disagg
            # pipeline the prefill and decode cost must land on the
            # same tenant ledger
            headers[TENANT_HEADER] = tenant
        req = urllib.request.Request(rep.url + route, data=body,
                                     headers=headers)
        with self._lock:
            rep.inflight += 1
        try:
            try:
                with urllib.request.urlopen(req, timeout=timeout_s) as r:
                    return (r.status, r.read(),
                            r.headers.get("Content-Type",
                                          "application/json"),
                            r.headers.get("Retry-After"),
                            r.headers.get(VERSION_HEADER))
            except urllib.error.HTTPError as e:
                # the replica ANSWERED (400/404/500/503-shed): its
                # verdict passes through verbatim, never retried
                data = e.read()
                return (e.code, data,
                        e.headers.get("Content-Type",
                                      "application/json"),
                        e.headers.get("Retry-After"),
                        e.headers.get(VERSION_HEADER))
        finally:
            with self._lock:
                rep.inflight -= 1

    def _shed_deadline(self, trace_id, deadline_ms, retried) -> dict:
        self._count("deadline_sheds")
        stat_add("requests_shed_deadline")
        # every backpressure 503 carries a backoff hint (README
        # contract): the budget is the CLIENT's — a retry with a fresh
        # one can succeed immediately, so the hint is the floor
        return {"code": 503,
                "body": json.dumps(
                    {"error": "overloaded", "reason": "deadline",
                     "detail": f"deadline budget of {deadline_ms:.1f}ms "
                               f"exhausted at the router",
                     "retry_after_s": 1,
                     "trace_id": trace_id}).encode(),
                "content_type": "application/json", "replica": None,
                "retried": retried, "retry_after": 1}

    def route(self, route: str, body: bytes,
              trace_id: Optional[str] = None,
              deadline_ms: Optional[float] = None,
              role: Optional[str] = None, count: bool = True,
              tenant: Optional[str] = None) -> dict:
        """Place one request: pick → forward (bounded by the forward
        timeout and the remaining deadline budget) → on a connect
        failure OR a forward timeout, strike health + retry once on
        an alternate.  Returns ``{"code", "body", "content_type",
        "replica", "retried", "retry_after"}``; a fleet with no
        routable replica yields the explicit 503 ``no_ready_replicas``
        payload (with a backoff hint); a spent deadline yields 503
        ``deadline`` without burning a forward; an unretryable hang
        yields 504 ``forward_timeout``.  ``role`` restricts placement
        to a disagg hop's capable replicas; ``count=False`` lets the
        disaggregated pipeline reuse this as its prefill hop without
        double-counting the request."""
        if count:
            self._count("requests")
            stat_add("router_http_requests")
        t0 = time.monotonic()
        tried: List[str] = []
        rep = self.pick(role=role)
        retried = False
        while rep is not None:
            remaining_ms = None
            if deadline_ms is not None:
                remaining_ms = deadline_ms \
                    - (time.monotonic() - t0) * 1e3
                if remaining_ms <= 0:
                    return self._shed_deadline(trace_id, deadline_ms,
                                               retried)
            # deadline_bound: the socket timeout below is the CLIENT's
            # remaining budget, not the hang bound — running it out
            # means the deadline expired, which must neither strike a
            # healthy replica's health nor read as a replica hang
            deadline_bound = (remaining_ms is not None
                              and remaining_ms / 1e3
                              < self.forward_timeout_s)
            timeout_s = self.forward_timeout_s if remaining_ms is None \
                else max(0.05, min(self.forward_timeout_s,
                                   remaining_ms / 1e3))
            try:
                kind = fault.fire("router_forward")
                fault.maybe_delay(kind)  # chaos 'slow': stall the hop
                if kind == "fail":
                    raise ConnectionRefusedError(
                        "injected router_forward failure")
                code, data, ctype, retry_after, version = self._send(
                    rep, route, body, trace_id, timeout_s,
                    remaining_ms, tenant=tenant)
            except Exception as e:  # noqa: BLE001 — sort, don't die
                with self._lock:
                    rep.errors += 1
                timed_out = _is_timeout_error(e)
                if timed_out and deadline_bound:
                    # the client's budget ran out mid-forward: a
                    # deadline shed, not a replica hang — the replica
                    # may be perfectly healthy, just slower than this
                    # request's remaining budget
                    return self._shed_deadline(trace_id, deadline_ms,
                                               retried)
                if timed_out:
                    # hung replica: strike the same consecutive-failure
                    # counter the health poll uses (repeated hangs
                    # eject) — a hang must never look healthier than a
                    # crash
                    self._count("forward_timeouts")
                    stat_add("router_forward_timeouts")
                    self._poll_failed(
                        rep, f"forward timeout ({timeout_s:.2f}s)")
                if (timed_out or _is_connect_error(e)) and not tried:
                    # dead or wedged: try ONE alternate — inference is
                    # idempotent, so a replay (even after a timeout,
                    # where the work may have executed) wastes at most
                    # one batch slot and changes no answer
                    tried.append(rep.url)
                    if not timed_out:
                        self._poll_failed(rep, f"connect: {e}")
                    alt = self.pick(exclude=tried, role=role)
                    if alt is not None:
                        self._count("retries")
                        stat_add("router_retries")
                        retried = True
                        rep = alt
                        continue
                    if not timed_out:
                        # dead replica, empty fleet: the explicit
                        # no_ready_replicas 503 below
                        rep = None
                        continue
                    # a hang with no alternate surfaces as 504, not as
                    # an empty fleet — the replica exists, it's wedged
                if timed_out:
                    logger.warning("forward to %s timed out after "
                                   "%.2fs", rep.url, timeout_s)
                    if count:
                        self._canary_observe(rep.url, 504, t0)
                    return {"code": 504,
                            "body": json.dumps(
                                {"error": "forward_timeout",
                                 "replica": rep.url,
                                 "timeout_ms": round(timeout_s * 1e3, 1),
                                 "trace_id": trace_id}).encode(),
                            "content_type": "application/json",
                            "replica": rep.url, "retried": retried,
                            "retry_after": None}
                self._count("replica_errors")
                stat_add("router_replica_errors")
                logger.warning("forward to %s failed: %s", rep.url, e)
                if count:
                    self._canary_observe(rep.url, 502, t0)
                return {"code": 502,
                        "body": json.dumps(
                            {"error": "replica_error",
                             "replica": rep.url,
                             "detail": f"{type(e).__name__}: {e}",
                             "trace_id": trace_id}).encode(),
                        "content_type": "application/json",
                        "replica": rep.url, "retried": retried,
                        "retry_after": None}
            with self._lock:
                rep.routed += 1
                if retried:
                    rep.retries_to += 1
            self._count("routed")
            stat_add("router_requests_routed")
            if count:
                self._canary_observe(rep.url, code, t0)
            if code == 200 and count:
                # count=False = a disagg pipeline hop: the caller
                # observes the WHOLE request once — a hop's latency
                # must not pollute the SLO/autoscale series
                self._observe_request(t0, trace_id)
            return {"code": code, "body": data, "content_type": ctype,
                    "replica": rep.url, "retried": retried,
                    "retry_after": retry_after,
                    "weights_version": version}
        # fleet empty (or emptied by the retry exclusion)
        self._count("no_ready")
        stat_add("router_no_ready_replicas")
        # backoff hint: by the next staleness window the fleet either
        # recovered a replica or is still worth backing off from
        retry_after = int(math.ceil(min(30.0, max(1.0, self._stale_s))))
        return {"code": 503,
                "body": json.dumps(
                    {"error": "overloaded",
                     "reason": "no_ready_replicas",
                     "detail": f"{len(self._all())} registered, 0 "
                               f"routable",
                     "retry_after_s": retry_after,
                     "trace_id": trace_id}
                ).encode(),
                "content_type": "application/json", "replica": None,
                "retried": retried, "retry_after": retry_after}

    # -- canary rollout -----------------------------------------------------
    @staticmethod
    def _swap_post(url: str, body: bytes, timeout_s: float = 35.0
                   ) -> Tuple[Optional[int], dict]:
        """POST a ``/swap`` body to one replica: ``(status, payload)``
        with an HTTPError's body parsed (409/503 verdicts carry JSON)
        and a socket-level failure as ``(None, {"error": ...})``."""
        req = urllib.request.Request(
            url.rstrip("/") + "/swap", data=body,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=timeout_s) as r:
                return r.status, json.loads(r.read() or b"{}")
        except urllib.error.HTTPError as e:
            try:
                payload = json.loads(e.read() or b"{}")
            except (OSError, ValueError):
                payload = {}
            return e.code, payload
        except (OSError, TimeoutError, ValueError) as e:
            return None, {"error": f"{type(e).__name__}: {e}"}

    def canary(self, checkpoint_dir: str,
               fraction: Optional[float] = None,
               soak_s: Optional[float] = None,
               target: str = "predict",
               swap_timeout_s: float = 35.0) -> dict:
        """Start a canary rollout: hot-swap ``checkpoint_dir`` onto a
        minority of ready replicas (``ceil(fraction * N)``, clamped to
        ``[1, N-1]`` so both versions always serve), then split traffic
        by weights version (see :meth:`pick`) and judge the canary
        side with its own short-window burn-rate monitor.  The poll
        loop drives the verdict: sustained burn — or a canary replica
        crashing mid-soak — auto-reverts every canary replica to the
        retained previous weights; a clean soak of ``soak_s`` promotes
        the checkpoint to the rest of the fleet.

        Admission is atomic at the FLEET level too: if any chosen
        replica refuses the swap (409 structural mismatch, 503
        draining), the already-swapped ones are reverted and the
        canary never starts.  Raises ``ValueError`` on a canary
        already soaking / bad fraction, ``RuntimeError`` when the
        fleet cannot split (fewer than 2 ready replicas) or a swap is
        refused."""
        frac = float(fraction if fraction is not None
                     else flag_value("FLAGS_canary_fraction"))
        if not 0.0 < frac < 1.0:
            raise ValueError(f"canary fraction must be in (0, 1), "
                             f"got {frac}")
        soak = float(soak_s if soak_s is not None
                     else flag_value("FLAGS_canary_soak_s"))
        with self._lock:
            if self._canary is not None:
                raise ValueError("a canary is already soaking "
                                 "(cancel_canary() first)")
        ready = [r for r in self._all() if r.ready()]
        if len(ready) < 2:
            raise RuntimeError(
                f"canary needs >= 2 ready replicas to split traffic "
                f"({len(ready)} ready)")
        k = max(1, min(len(ready) - 1,
                       int(math.ceil(frac * len(ready)))))
        chosen = sorted(ready, key=lambda r: r.rid)[:k]
        body = json.dumps({"dir": checkpoint_dir,
                           "target": target}).encode()
        swapped: List[str] = []
        versions: Dict[str, int] = {}
        swaps = []
        for rep in chosen:
            status, payload = self._swap_post(rep.url, body,
                                              swap_timeout_s)
            swaps.append({"url": rep.url, "status": status,
                          "payload": payload})
            if status == 200:
                swapped.append(rep.url)
                versions[rep.url] = int(
                    payload.get("weights_version") or 0)
                continue
            # fleet-level atomicity: undo the minority already swapped
            # before refusing — a rejected canary must leave ZERO
            # replicas on the new version
            rb = json.dumps({"revert": True,
                             "target": target}).encode()
            for url in swapped:
                self._swap_post(url, rb, swap_timeout_s)
            raise RuntimeError(
                f"canary swap refused by {rep.url}: "
                f"HTTP {status} {payload}")
        # short-window judge: the soak bounds the evidence horizon, so
        # the burn windows scale down with it (a 60s soak judges on
        # 6s/20s windows) — the fleet-wide monitor's 60s/300s pair
        # would never convict inside the soak.  The judge reads
        # EPOCH-SUFFIXED series: the stable router_canary_* names are
        # shared across rollouts, and a fresh canary's burn window can
        # still contain the previous canary's failure deltas — stale
        # evidence must not convict a clean checkpoint
        with self._lock:
            epoch = self._n["canary_starts"] + 1
        fast = max(1.0, soak / 10.0)
        slow = max(fast * 2.0, soak / 3.0)
        monitor = tsdb.BurnRateMonitor(
            self._db,
            [tsdb.SloSpec("canary_availability", "availability",
                          error_series=f"router_canary_failures#{epoch}",
                          total_series=f"router_canary_requests#{epoch}"),
             tsdb.SloSpec("canary_p99", "latency",
                          latency_series=f"router_canary_request_ms#{epoch}",
                          threshold_ms=self._slo_p99_ms,
                          objective_pct=99.0)],
            fast_s=fast, slow_s=slow)
        with self._lock:
            self._canary = {
                "dir": checkpoint_dir, "fraction": frac,
                "soak_s": soak, "target": target, "epoch": epoch,
                "t0": time.monotonic(), "time": time.time(),
                "urls": list(swapped), "versions": versions,
                "swap_timeout_s": float(swap_timeout_s)}
            self._canary_monitor = monitor
            self._canary_accum = 0.0
            self._n["canary_starts"] += 1
        stat_add("router_canary_starts")
        telemetry.log_event("router_canary_started",
                            dir=checkpoint_dir, fraction=frac,
                            soak_s=soak, replicas=len(swapped))
        logger.info("canary soaking: %s on %d/%d replicas (%.0f%% of "
                    "traffic, %.0fs soak)", checkpoint_dir,
                    len(swapped), len(ready), frac * 100, soak)
        return {"state": "soaking", "urls": list(swapped),
                "versions": versions, "fraction": frac,
                "soak_s": soak, "swaps": swaps}

    def _canary_observe(self, rep_url: str, code: int, t0: float):
        """Book one routed request as canary- or base-side evidence.
        5xx answers are burn (500 = the model failed the request, 502
        / 504 = the replica died or hung under it) — EXCEPT 503,
        which is explicit admission backpressure: load shedding is the
        queue's verdict, not the new weights'."""
        with self._lock:
            c = self._canary
            if c is None:
                return
            side = "canary" if rep_url in c["urls"] else "base"
            epoch = c["epoch"]
            self._n[side + "_requests"] += 1
            if code >= 500 and code != 503:
                self._n[side + "_failures"] += 1
        if code == 200:
            ms = (time.monotonic() - t0) * 1e3
            self._db.record(f"router_{side}_request_ms", ms, cap=4096)
            if side == "canary":
                self._db.record(f"router_canary_request_ms#{epoch}",
                                ms, cap=4096)

    def _canary_evaluate(self):
        """The poll-loop judge: crash evidence + burn verdict + soak
        clock.  Any canary replica ejected, deregistered, or respawned
        onto a DIFFERENT weights version (the supervisor's restart
        fallback reverts to baseline) is evidence against the canary —
        a rollout that kills its replica must never soak to promotion
        just because the corpse stopped serving errors."""
        with self._lock:
            c = self._canary
            monitor = self._canary_monitor
        if c is None or monitor is None:
            return
        now = time.monotonic()
        lost = []
        for url in c["urls"]:
            with self._lock:
                rep = self._replicas.get(url)
            if rep is None or rep.ejected:
                lost.append(url)
                continue
            v = rep.weights_version()
            if (v is not None and rep.health_ts > c["t0"]
                    and v != c["versions"].get(url, v)):
                lost.append(url)
        verdict = monitor.evaluate(now)
        firing = [a["name"] for a in verdict["alerts"]
                  if a["state"] == "firing"]
        if lost or firing:
            reason = " + ".join(
                ([f"replica_lost:{','.join(lost)}"] if lost else [])
                + [f"burn:{n}" for n in firing])
            self._canary_revert(reason, lost=lost, verdict=verdict)
        elif now - c["t0"] >= c["soak_s"]:
            self._canary_promote(verdict=verdict)

    def _canary_revert(self, reason: str, lost=(), verdict=None
                       ) -> Optional[dict]:
        """Swap every canary replica back to the retained previous
        weights and end the soak.  Clears the canary state FIRST so
        placement stops preferring the bad version while the revert
        POSTs run; replicas in ``lost`` respawned onto baseline
        weights already — there is nothing to revert there."""
        with self._lock:
            c = self._canary
            self._canary = None
            self._canary_monitor = None
            if c is not None:
                # transient verdict: status must never show "inactive,
                # no outcome" while the revert POSTs are in flight
                self._last_canary = {"state": "reverting",
                                     "dir": c["dir"], "reason": reason}
        if c is None:
            return None
        t_detect = time.monotonic()
        rb = json.dumps({"revert": True,
                         "target": c["target"]}).encode()
        reverts = []
        failures = 0
        for url in c["urls"]:
            if url in lost:
                reverts.append({"url": url, "status": "lost"})
                continue
            status, payload = self._swap_post(url, rb,
                                              c["swap_timeout_s"])
            reverts.append({"url": url, "status": status,
                            "payload": payload})
            failures += status != 200
        latency_s = time.monotonic() - t_detect
        out = {
            "state": "reverted", "dir": c["dir"], "reason": reason,
            "time": time.time(),
            "soak_elapsed_s": round(t_detect - c["t0"], 3),
            "revert_latency_s": round(latency_s, 3),
            "lost": list(lost), "reverts": reverts,
            "revert_failures": failures,
            "fraction": c["fraction"], "urls": c["urls"],
        }
        if verdict is not None:
            out["verdict"] = verdict
        with self._lock:
            self._last_canary = out
            self._n["canary_reverts"] += 1
        stat_add("router_canary_reverts")
        telemetry.log_event("router_canary_reverted", reason=reason,
                            dir=c["dir"],
                            revert_latency_s=out["revert_latency_s"],
                            revert_failures=failures)
        logger.warning("canary REVERTED (%s): %s off %d replicas in "
                       "%.2fs", reason, c["dir"], len(c["urls"]),
                       latency_s)
        return out

    def _canary_promote(self, verdict=None) -> Optional[dict]:
        """Clean soak: roll the canary checkpoint out to the rest of
        the fleet.  A base replica refusing its swap here is recorded
        (and counted) but does not resurrect the canary — the verdict
        on the WEIGHTS is already in; finishing a partially-refused
        rollout is a fleet operation (hot_swap / restart), not a
        judging problem."""
        with self._lock:
            c = self._canary
            self._canary = None
            self._canary_monitor = None
            if c is not None:
                self._last_canary = {"state": "promoting",
                                     "dir": c["dir"]}
        if c is None:
            return None
        body = json.dumps({"dir": c["dir"],
                           "target": c["target"]}).encode()
        promotions = []
        failures = 0
        for rep in self._all():
            if rep.url in c["urls"] or not rep.ready():
                continue
            status, payload = self._swap_post(rep.url, body,
                                              c["swap_timeout_s"])
            promotions.append({"url": rep.url, "status": status,
                               "payload": payload})
            failures += status != 200
        out = {
            "state": "promoted", "dir": c["dir"],
            "time": time.time(),
            "soak_elapsed_s": round(time.monotonic() - c["t0"], 3),
            "promotions": promotions, "promote_failures": failures,
            "fraction": c["fraction"], "urls": c["urls"],
        }
        if verdict is not None:
            out["verdict"] = verdict
        with self._lock:
            self._last_canary = out
            self._n["canary_promotions"] += 1
        stat_add("router_canary_promotions")
        telemetry.log_event("router_canary_promoted", dir=c["dir"],
                            promote_failures=failures,
                            replicas=len(promotions))
        logger.info("canary PROMOTED: %s to %d more replicas "
                    "(%d refusals)", c["dir"], len(promotions),
                    failures)
        return out

    def cancel_canary(self, reason: str = "operator"
                      ) -> Optional[dict]:
        """Operator abort: revert the soak now, whatever the burn
        state.  None when no canary is active."""
        return self._canary_revert(f"cancelled:{reason}")

    def canary_status(self) -> dict:
        """The ``canary`` block for /statusz /fleetz: live soak state
        (with its judge's burn windows) + the last finished rollout's
        verdict + the lifetime counters."""
        with self._lock:
            c = dict(self._canary) if self._canary else None
            monitor = self._canary_monitor
            last = self._last_canary
            n = {k: self._n[k] for k in
                 ("canary_starts", "canary_reverts",
                  "canary_promotions", "canary_requests",
                  "canary_failures", "base_requests",
                  "base_failures")}
        out = {"active": c is not None, "counters": n, "last": last}
        if c is not None:
            out["current"] = {
                "dir": c["dir"], "fraction": c["fraction"],
                "soak_s": c["soak_s"], "target": c["target"],
                "urls": c["urls"], "versions": c["versions"],
                "elapsed_s": round(time.monotonic() - c["t0"], 3),
                "slo": monitor.state() if monitor else None,
            }
        return out

    # -- disaggregated generate: prefill hop -> segment -> adopt hop --------
    def disagg_active(self) -> bool:
        """True when the fleet is role-split (>= 1 ready replica
        reports a specialized 'prefill' or 'decode' role).  ALL
        ``/generate`` traffic then takes the two-hop pipeline — a
        'both'-role replica still qualifies for either hop, so mixed
        fleets keep serving."""
        return any(r.ready() and r.role() in ("prefill", "decode")
                   for r in self._all())

    def embedding_active(self) -> bool:
        """True when >= 1 ready replica advertises the 'embedding'
        capability — only then does the front door steer sparse-id
        /predict bodies by capability (a capability-free fleet keeps
        the role-blind path: nothing could serve the hop, so
        constraining it would just manufacture 503s)."""
        return any(r.ready() and "embedding" in r.capabilities()
                   for r in self._all())

    @staticmethod
    def _split_generate_body(body: bytes):
        """(prefill_body, max_new_tokens, stream): the prefill hop
        must not carry ``stream`` (its reply is a segment, not
        tokens) and the adopt hop needs ``max_new_tokens`` as a query
        arg.  A malformed body passes through untouched — the prefill
        replica 400s it verbatim."""
        try:
            doc = json.loads(body or b"{}")
        except ValueError:
            return body, None, False
        if not isinstance(doc, dict):
            return body, None, False
        stream = bool(doc.pop("stream", False))
        if stream:
            body = json.dumps(doc).encode()
        return body, doc.get("max_new_tokens"), stream

    def _count_affinity_lost(self, rep_url: str, trace_id,
                             detail: str, stream: bool = False):
        """Book one affinity-loss event (counter + log event) — split
        from the response builder so the stream pipeline books the
        SAME evidence per event whether or not a reprefill heals it
        (counter parity with the non-stream path)."""
        self._count("affinity_lost")
        stat_add("router_affinity_lost")
        telemetry.log_event("router_affinity_lost", replica=rep_url,
                            trace_id=trace_id, detail=detail,
                            stream=stream)

    def _affinity_lost_res(self, rep_url: str, trace_id, detail: str,
                           retried: bool, count: bool = True) -> dict:
        """The explicit mid-generation-death taxonomy: the replica
        holding this generation's KV cache died after adoption began.
        NEVER silently re-prefilled — ``FLAGS_disagg_reprefill=1`` is
        the only path that retries, and it marks the response."""
        if count:
            self._count_affinity_lost(rep_url, trace_id, detail)
        return {"code": 502,
                "body": json.dumps(
                    {"error": "affinity_lost",
                     "reason": "affinity_lost",
                     "replica": rep_url,
                     "detail": f"cache-holding decode replica died "
                               f"mid-generation: {detail}",
                     "trace_id": trace_id}).encode(),
                "content_type": "application/json", "replica": rep_url,
                "retried": retried, "retry_after": None,
                "_affinity_lost": True}

    def route_generate(self, body: bytes,
                       trace_id: Optional[str] = None,
                       deadline_ms: Optional[float] = None,
                       tenant: Optional[str] = None) -> dict:
        """Disaggregated ``/generate`` (non-stream): forward the
        prompt to least-loaded PREFILL capacity (retry-once semantics
        of :meth:`route` — a prefill hop is stateless-on-failure and
        safely replayable), receive the serialized KV segment, then
        pin the decode to one decode-capable replica's ``POST
        /adopt``.  A decode replica that dies after the segment went
        out fails the request with the explicit ``affinity_lost``
        taxonomy; ``FLAGS_disagg_reprefill=1`` instead restarts the
        whole pipeline ONCE (marked ``reprefilled`` in the access
        log).  A 'both'-role replica answering the prefill hop with a
        full result short-circuits — mixed fleets degrade to
        colocated serving, never to an error."""
        from .disagg import SEGMENT_CONTENT_TYPE

        self._count("requests")
        stat_add("router_http_requests")
        self._count("disagg_generations")
        stat_add("router_disagg_generations")
        t0 = time.monotonic()
        pre_body, mnt, _stream = self._split_generate_body(body)
        allow_reprefill = bool(flag_value("FLAGS_disagg_reprefill"))
        attempts = 0
        dead_decode: List[str] = []
        while True:
            span = telemetry.span_begin("router/prefill_hop",
                                        detached=True,
                                        trace_id=trace_id)
            try:
                pre = self.route("/generate", pre_body, trace_id,
                                 deadline_ms=self._remaining(
                                     deadline_ms, t0),
                                 role="prefill", count=False,
                                 tenant=tenant)
                if span is not None:
                    span.attrs["status"] = pre["code"]
                    span.attrs["replica"] = pre["replica"]
            finally:
                telemetry.span_end(span)
            if pre["code"] != 200 \
                    or pre["content_type"] != SEGMENT_CONTENT_TYPE:
                # shed / error / or a both-role replica's full answer:
                # passes through verbatim (and a 200 short-circuit is
                # a completed generation, not a handoff)
                if pre["code"] == 200:
                    self._observe_request(t0, trace_id)
                return pre
            seg_bytes = pre["body"]
            stat_add("router_segment_bytes", len(seg_bytes))
            res = self._adopt_hop(seg_bytes, mnt, trace_id,
                                  deadline_ms, t0, pre["replica"],
                                  exclude=dead_decode, tenant=tenant)
            if res.pop("_affinity_lost", False):
                if allow_reprefill and attempts == 0:
                    attempts += 1
                    if res.get("replica"):
                        # the reprefilled pipeline must not hand the
                        # fresh segment back to the replica that just
                        # died with the old one
                        dead_decode.append(res["replica"])
                    self._count("reprefills")
                    stat_add("router_reprefills")
                    telemetry.log_event("router_reprefill",
                                        trace_id=trace_id)
                    continue
                return res
            if res["code"] == 200:
                self._observe_request(t0, trace_id)
                if attempts:
                    res["reprefilled"] = True
            return res

    def _remaining(self, deadline_ms, t0) -> Optional[float]:
        if deadline_ms is None:
            return None
        return deadline_ms - (time.monotonic() - t0) * 1e3

    def _observe_request(self, t0: float, trace_id):
        ms = (time.monotonic() - t0) * 1e3
        self._h_request.observe(ms, trace_id=trace_id)
        telemetry.histogram_observe("router_request_ms", ms,
                                    trace_id=trace_id)
        self._db.record("router_request_ms", ms, cap=4096)

    def _adopt_hop(self, seg_bytes: bytes, mnt, trace_id,
                   deadline_ms, t0, prefill_url: str,
                   exclude=(), tenant: Optional[str] = None) -> dict:
        """Ship the segment to one decode-capable replica and pin the
        generation there.  A CONNECT-refused replica never received
        the segment — strike + try one alternate (safe); any failure
        after the POST went out is a mid-generation death of the
        cache holder → ``affinity_lost``."""
        query = "/adopt"
        if mnt is not None:
            query += f"?max_new_tokens={int(mnt)}"
        tried: List[str] = list(exclude)
        retried = False
        span = telemetry.span_begin("router/adopt_hop", detached=True,
                                    trace_id=trace_id,
                                    bytes=len(seg_bytes))
        try:
            while True:
                rep = self.pick(exclude=tried, role="decode")
                if rep is None:
                    self._count("no_ready")
                    stat_add("router_no_ready_replicas")
                    retry_after = int(math.ceil(
                        min(30.0, max(1.0, self._stale_s))))
                    return {"code": 503,
                            "body": json.dumps(
                                {"error": "overloaded",
                                 "reason": "no_ready_replicas",
                                 "detail": "no decode-capable replica "
                                           "for the adopt hop",
                                 "retry_after_s": retry_after,
                                 "trace_id": trace_id}).encode(),
                            "content_type": "application/json",
                            "replica": None, "retried": retried,
                            "retry_after": retry_after}
                remaining_ms = self._remaining(deadline_ms, t0)
                if remaining_ms is not None and remaining_ms <= 0:
                    return self._shed_deadline(trace_id, deadline_ms,
                                               retried)
                deadline_bound = (remaining_ms is not None
                                  and remaining_ms / 1e3
                                  < self.forward_timeout_s)
                timeout_s = self.forward_timeout_s \
                    if remaining_ms is None \
                    else max(0.05, min(self.forward_timeout_s,
                                       remaining_ms / 1e3))
                try:
                    kind = fault.fire("router_forward")
                    fault.maybe_delay(kind)
                    if kind == "fail":
                        raise ConnectionRefusedError(
                            "injected router_forward failure")
                    code, data, ctype, retry_after, _ = self._send(
                        rep, query, seg_bytes, trace_id, timeout_s,
                        remaining_ms,
                        content_type="application/octet-stream",
                        tenant=tenant)
                except Exception as e:  # noqa: BLE001 — sort, don't die
                    with self._lock:
                        rep.errors += 1
                    timed_out = _is_timeout_error(e)
                    if timed_out and deadline_bound:
                        return self._shed_deadline(
                            trace_id, deadline_ms, retried)
                    refused = (isinstance(e, ConnectionRefusedError)
                               or isinstance(
                                   getattr(e, "reason", None),
                                   ConnectionRefusedError))
                    if refused:
                        # the segment never left this process: an
                        # alternate decode replica adopts it safely
                        self._poll_failed(rep, f"connect: {e}")
                        if not retried:
                            tried.append(rep.url)
                            self._count("retries")
                            stat_add("router_retries")
                            retried = True
                            continue
                        # refused AGAIN: no adoption ever began, so
                        # this is a dead replica, not a lost cache —
                        # affinity taxonomy must not fire
                        self._count("replica_errors")
                        stat_add("router_replica_errors")
                        return {"code": 502,
                                "body": json.dumps(
                                    {"error": "replica_error",
                                     "replica": rep.url,
                                     "detail": f"adopt connect: {e}",
                                     "trace_id": trace_id}).encode(),
                                "content_type": "application/json",
                                "replica": rep.url, "retried": retried,
                                "retry_after": None}
                    if timed_out:
                        self._count("forward_timeouts")
                        stat_add("router_forward_timeouts")
                        self._poll_failed(
                            rep,
                            f"adopt timeout ({timeout_s:.2f}s)")
                    return self._affinity_lost_res(
                        rep.url, trace_id,
                        f"{type(e).__name__}: {e}", retried)
                with self._lock:
                    rep.routed += 1
                    if retried:
                        rep.retries_to += 1
                self._count("routed")
                stat_add("router_requests_routed")
                if span is not None:
                    span.attrs["replica"] = rep.url
                    span.attrs["status"] = code
                return {"code": code, "body": data,
                        "content_type": ctype, "replica": rep.url,
                        "retried": retried, "retry_after": retry_after,
                        "disagg": {"prefill": prefill_url,
                                   "decode": rep.url,
                                   "segment_bytes": len(seg_bytes)}}
        finally:
            telemetry.span_end(span)

    # -- federation ---------------------------------------------------------
    def fleet_metrics(self, window_s: float = 60.0) -> dict:
        """The federated fleet view: per-replica latest samples plus
        the aggregate — counters SUM (total and windowed per-second
        rate, monotonic-reset aware through the tsdb), gauges sum AND
        max (a fleet queue depth is a sum; a fleet HBM peak is a max
        — expose both, let the consumer pick), histograms merged
        bucket-vector-wise with interpolated fleet p50/p99."""
        reps = self._all()
        with self._lock:
            scrapes = [(r.rid, r.url, r.scrape, r.scrape_ts, r)
                       for r in reps]
        now = time.monotonic()
        per_replica: Dict[str, dict] = {}
        counters: Dict[str, dict] = {}
        gauges: Dict[str, dict] = {}
        hists: Dict[str, dict] = {}
        tenants: Dict[str, Dict[str, dict]] = {}
        for rid, url, fams, ts, rep in scrapes:
            entry = {
                "url": url,
                "up": fams is not None and not rep.ejected,
                "ready": rep.ready(),
                "scrape_age_ms": round((now - ts) * 1e3, 1)
                if ts else None,
                "counters": {}, "gauges": {},
            }
            per_replica[rid] = entry
            if not fams:
                continue
            for name, fam in fams.items():
                short = _short_family(name)
                if (fam.type == "counter"
                        and short.startswith("serving_tenant_")):
                    # per-tenant rollup: "total" sums the latest raw
                    # counters (dashboard view); "delta"/"rate_per_s"
                    # sum per-replica reset-aware windows — THOSE are
                    # the conservation-bearing numbers across a
                    # replica SIGKILL-respawn (raw totals dip when a
                    # respawned counter restarts from zero)
                    field = short[len("serving_tenant_"):]
                    for s in fam.samples:
                        t = s.labels.get("tenant")
                        if not t:
                            continue
                        agg = tenants.setdefault(field, {}).setdefault(
                            t, {"total": 0.0, "delta": None,
                                "rate_per_s": None, "replicas": 0})
                        agg["total"] += s.value
                        agg["replicas"] += 1
                        series = f"{short}{{{t}}}[{rid}]"
                        d = self._db.delta(series, window_s, now=now)
                        if d is not None:
                            agg["delta"] = (agg["delta"] or 0.0) + d
                        r = self._db.rate(series, window_s, now=now)
                        if r is not None:
                            agg["rate_per_s"] = \
                                (agg["rate_per_s"] or 0.0) + r
                if fam.type == "counter":
                    v = fam.value()
                    if v is None:
                        continue
                    entry["counters"][short] = v
                    agg = counters.setdefault(
                        short, {"total": 0.0, "rate_per_s": None,
                                "replicas": 0})
                    agg["total"] += v
                    agg["replicas"] += 1
                    rate = self._db.rate(f"{short}[{rid}]", window_s,
                                         now=now)
                    if rate is not None:
                        agg["rate_per_s"] = (agg["rate_per_s"] or 0.0) \
                            + rate
                elif fam.type == "gauge":
                    v = fam.value()
                    if v is None:
                        continue
                    entry["gauges"][short] = v
                    agg = gauges.setdefault(
                        short, {"sum": 0.0, "max": None, "replicas": 0})
                    agg["sum"] += v
                    agg["max"] = v if agg["max"] is None \
                        else max(agg["max"], v)
                    agg["replicas"] += 1
                elif fam.type == "histogram":
                    agg = hists.setdefault(
                        short, {"count": 0.0, "sum": 0.0,
                                "buckets": {}, "replicas": 0})
                    agg["count"] += fam.histogram_count()
                    agg["sum"] += fam.histogram_sum()
                    agg["replicas"] += 1
                    for ub, cum in fam.histogram_buckets():
                        agg["buckets"][ub] = \
                            agg["buckets"].get(ub, 0.0) + cum
        for short, agg in counters.items():
            agg["total"] = round(agg["total"], 6)
        for short, agg in hists.items():
            merged = sorted(agg.pop("buckets").items())
            agg["p50"] = promtext.merged_histogram_percentile(merged, 50)
            agg["p99"] = promtext.merged_histogram_percentile(merged, 99)
            agg["buckets"] = [[("+Inf" if math.isinf(ub) else ub), c]
                              for ub, c in merged]
        return {"window_s": window_s,
                "replicas": per_replica,
                "aggregate": {"counters": counters, "gauges": gauges,
                              "histograms": hists,
                              "tenants": tenants}}

    def fleetz(self, window_s: float = 60.0) -> dict:
        """The ``GET /fleetz`` payload: federation + windowed router
        series + SLO/alert state + autoscale — the one JSON document
        ROADMAP's autoscaling loop and canary judge consume."""
        fm = self.fleet_metrics(window_s) if self.federate else {
            "window_s": window_s, "replicas": {}, "aggregate": None,
            "disabled": "FLAGS_router_federate=0"}
        with self._lock:
            auto = dict(self._autoscale)
        fm.update({
            "time": time.time(),
            "federate": self.federate,
            "router": {
                "request_ms": {
                    "p50": self._db.quantile("router_request_ms", 50,
                                             window_s),
                    "p99": self._db.quantile("router_request_ms", 99,
                                             window_s),
                    "samples": len(self._db.window("router_request_ms",
                                                   window_s)),
                },
                "requests_rate_per_s": self._db.rate(
                    "router_requests_total", window_s),
                "failures_rate_per_s": self._db.rate(
                    "router_request_failures", window_s),
                "replicas_up": self._db.last("fleet_replicas_up"),
            },
            "slo": self.burn_monitor.state(),
            "canary": self.canary_status(),
            "autoscale": auto,
            "tsdb": self._db.stats(),
        })
        if self.supervisor is not None:
            # death attributions + postmortem inventory from the
            # attached FleetSupervisor — the crash-forensics half of
            # the fleet document
            fm["supervision"] = self.supervisor.forensics()
        return fm

    def fleet_prometheus_text(self) -> str:
        """``paddle_tpu_fleet_*`` families for the router's
        ``/metrics``: per-replica ``replica="host:port"``-labeled
        samples plus the unlabeled fleet aggregate (sum for counters
        and gauges), in strict exposition format (validated live by
        the router tests).  Scraping the router yields the whole
        fleet, labeled — the Prometheus-shaped half of federation."""
        if not self.federate:
            return ""
        fm = self.fleet_metrics()
        lines = []
        per_rep = fm["replicas"]
        for kind_key, kind in (("counters", "counter"),
                               ("gauges", "gauge")):
            fams = fm["aggregate"][kind_key]
            for short in sorted(fams):
                pn = f"{_PROM_PREFIX}fleet_{short}"
                lines.append(f"# HELP {pn} fleet-aggregated {short} "
                             f"(sum over replicas; per-replica samples "
                             f"labeled)")
                lines.append(f"# TYPE {pn} {kind}")
                for rid in sorted(per_rep):
                    v = per_rep[rid][kind_key].get(short)
                    if v is not None:
                        lines.append(f'{pn}{{replica="{rid}"}} {v}')
                agg = fams[short]
                total = agg["total"] if kind == "counter" \
                    else agg["sum"]
                lines.append(f"{pn} {total}")
        return "\n".join(lines) + ("\n" if lines else "")

    # -- introspection ------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            n = dict(self._n)
            auto = dict(self._autoscale)
        reps = [r.snapshot(self._stale_s) for r in self._all()]
        return {
            "counters": n,
            "replicas": reps,
            "routable": sum(1 for r in reps
                            if r["ready"] and not r["ejected"]),
            "request_ms": self._h_request.summary(),
            "autoscale": auto,
            "slo": self.burn_monitor.state(),
            "canary": self.canary_status(),
        }

    def healthz(self) -> Tuple[int, dict]:
        reps = self._all()
        routable = [r for r in reps if r.ready()]
        status = "ok" if routable else "no_ready_replicas"
        with self._lock:  # _autoscale/_canary are written under _lock
            auto = dict(self._autoscale)
            canary_active = self._canary is not None
        roles: Dict[str, int] = {}
        capabilities: Dict[str, int] = {}
        for r in routable:
            roles[r.role()] = roles.get(r.role(), 0) + 1
            for c in r.capabilities():
                capabilities[c] = capabilities.get(c, 0) + 1
        return (200 if routable else 503), {
            "status": status,
            "pid": os.getpid(),
            "time": time.time(),
            "uptime_s": round(time.time() - self._started, 3),
            "replicas": len(reps),
            "routable": len(routable),
            "roles": roles,
            "capabilities": capabilities,
            "disagg": self.disagg_active(),
            "embedding": self.embedding_active(),
            "autoscale": auto,
            "alerts_firing": self.burn_monitor.firing(),
            "canary_active": canary_active,
        }

    def debugz(self, timeout: float = 5.0) -> dict:
        """The federated one-shot debug bundle: every replica's
        ``GET /debugz`` document keyed by its url, plus the router's
        own state (statusz + fleetz + its own flight-recorder ring) —
        one fetch freezes the whole fleet for offline diagnosis.  A
        replica that cannot answer contributes ``{"error": ...}``
        instead of failing the bundle (a debug fetch during an
        incident must degrade, never 500)."""
        replicas = {}
        for rep in self._all():
            try:
                with urllib.request.urlopen(rep.url + "/debugz",
                                            timeout=timeout) as r:
                    replicas[rep.url] = json.loads(r.read())
            except (OSError, TimeoutError, ValueError) as e:
                replicas[rep.url] = {
                    "error": f"{type(e).__name__}: {e}"}
        return {
            "bundle": "paddle_tpu.debugz.v1",
            "tier": "router",
            "statusz": self.statusz(),
            "fleetz": self.fleetz(),
            "blackbox": blackbox.snapshot(),
            "metrics": telemetry.metrics.snapshot()
            if telemetry.enabled() else None,
            "replicas": replicas,
        }

    def statusz(self) -> dict:
        return {
            "pid": os.getpid(),
            "time": time.time(),
            "process_uptime_s": process_uptime_s(),
            "router_uptime_s": round(time.time() - self._started, 3),
            "restart_count": int(
                os.environ.get("PADDLE_TPU_RESTART_COUNT", "0") or 0),
            "poll_interval_ms": self._poll_s * 1e3,
            "stale_ms": self._stale_s * 1e3,
            "eject_after": self.eject_after,
            "slo_p99_ms": self._slo_p99_ms,
            "forward_timeout_ms": self.forward_timeout_s * 1e3,
            "default_deadline_ms": float(
                flag_value("FLAGS_router_default_deadline_ms") or 0.0),
            "flags": all_flags(),
            "fleet": self.stats(),
        }


class _RouterHandler(_JsonHandler):
    router: Router = None
    access_log: _AccessLog = None

    logger = logger

    def do_GET(self):
        route, _, query = self.path.partition("?")
        if route == "/healthz":
            code, payload = self.router.healthz()
            self._reply(code, payload)
        elif route == "/metrics":
            if not telemetry.enabled():
                self._reply(503, {"error": "telemetry disabled",
                                  "detail": "FLAGS_telemetry=0"})
                return
            # local registry families + the federated fleet_* families
            # (per-replica labeled samples + unlabeled aggregates) in
            # ONE strict exposition document
            text = telemetry.prometheus_text() \
                + self.router.fleet_prometheus_text()
            self._reply_raw(200, text.encode(),
                            "text/plain; version=0.0.4; charset=utf-8")
        elif route == "/fleetz":
            window_s = 60.0
            for part in query.split("&"):
                k, _, v = part.partition("=")
                if k == "window_s" and v:
                    try:
                        window_s = float(v)
                    except ValueError:
                        self._reply(400, {"error": "bad request",
                                          "detail": f"window_s={v!r} "
                                                    "is not a number"})
                        return
                    if not math.isfinite(window_s) or window_s <= 0:
                        # explicit 400, never a silent clamp: a caller
                        # asking for a zero/negative window would get
                        # an answer for a window it never requested
                        self._reply(400, {"error": "bad request",
                                          "detail": f"window_s={v!r} "
                                                    "must be a positive "
                                                    "finite number"})
                        return
            self._reply(200, self.router.fleetz(window_s))
        elif route == "/statusz":
            self._reply(200, self.router.statusz())
        elif route == "/debugz":
            self._reply(200, self.router.debugz())
        else:
            self._reply(404, {"error": "not found", "path": self.path})

    def _wants_stream(self, route: str, body: bytes) -> bool:
        """A ``/generate`` body asking for the NDJSON streaming
        contract: such a response must be forwarded LINE BY LINE —
        buffering it through the normal route() path would deliver
        every token at once and silently destroy the client-side
        TTFT/ITL measurement the contract exists for."""
        if route != "/generate" or b'"stream"' not in body:
            return False
        try:
            return bool(json.loads(body or b"{}").get("stream"))
        except (ValueError, AttributeError):
            return False  # malformed body: let the replica 400 it

    def _forward_stream(self, route: str, body: bytes,
                        trace_id: Optional[str],
                        deadline_ms: Optional[float], t0: float,
                        tenant: Optional[str] = None):
        """Streaming forward with route()'s exact containment
        taxonomy: pick → POST, where the CONNECT + response-HEADERS
        phase is bounded by the deadline-tightened forward timeout (a
        replica streams its headers at admission, before the first
        token, so a wedged one is caught here exactly like a one-shot
        hop — strike, one retry on an alternate, 504 when none; a
        deadline-bound timeout is a deadline shed).  Once headers
        arrive the socket timeout widens to the request timeout for
        the body copy: a stream legitimately pauses between tokens
        far longer than a hop, and once bytes went out no retry is
        possible anyway, so a mid-stream stall just ends the copy.
        Replica non-200s pass through verbatim (and count as routed,
        like route()); the ``router_forward`` fault site covers every
        attempt so the chaos slow/fail scenarios exercise streams
        too."""
        router = self.router
        router._count("requests")
        stat_add("router_http_requests")
        tried: List[str] = []
        rep = router.pick()
        retried = False
        while rep is not None:
            remaining_ms = None
            if deadline_ms is not None:
                remaining_ms = deadline_ms \
                    - (time.monotonic() - t0) * 1e3
                if remaining_ms <= 0:
                    res = router._shed_deadline(trace_id, deadline_ms,
                                                retried)
                    self._reply_raw(res["code"], res["body"],
                                    res["content_type"],
                                    trace_id=trace_id)
                    return res["code"], None
            deadline_bound = (remaining_ms is not None
                              and remaining_ms / 1e3
                              < router.forward_timeout_s)
            timeout_s = router.forward_timeout_s \
                if remaining_ms is None \
                else max(0.05, min(router.forward_timeout_s,
                                   remaining_ms / 1e3))
            headers = {"Content-Type": "application/json",
                       TRACE_HEADER: trace_id or ""}
            if remaining_ms is not None:
                headers[DEADLINE_HEADER] = f"{remaining_ms:.1f}"
            if tenant:
                headers[TENANT_HEADER] = tenant
            host_port = rep.url.split("://", 1)[-1]
            with router._lock:
                rep.inflight += 1
            conn = None
            try:
                kind = fault.fire("router_forward")
                fault.maybe_delay(kind)  # chaos 'slow' covers streams
                if kind == "fail":
                    raise ConnectionRefusedError(
                        "injected router_forward failure")
                conn = http.client.HTTPConnection(host_port,
                                                  timeout=timeout_s)
                conn.request("POST", route, body, headers)
                resp = conn.getresponse()  # headers: forward-timeout
            except Exception as e:  # noqa: BLE001 — sort, don't die
                with router._lock:
                    rep.inflight -= 1
                    rep.errors += 1
                if conn is not None:
                    conn.close()
                timed_out = _is_timeout_error(e)
                if timed_out and deadline_bound:
                    res = router._shed_deadline(trace_id, deadline_ms,
                                                retried)
                    self._reply_raw(res["code"], res["body"],
                                    res["content_type"],
                                    trace_id=trace_id)
                    return res["code"], rep.url
                if timed_out:
                    router._count("forward_timeouts")
                    stat_add("router_forward_timeouts")
                    router._poll_failed(
                        rep, f"forward timeout ({timeout_s:.2f}s)")
                if (timed_out or _is_connect_error(e)) and not tried:
                    tried.append(rep.url)
                    if not timed_out:
                        router._poll_failed(rep, f"connect: {e}")
                    alt = router.pick(exclude=tried)
                    if alt is not None:
                        router._count("retries")
                        stat_add("router_retries")
                        retried = True
                        rep = alt
                        continue
                    if not timed_out:
                        rep = None
                        continue
                if timed_out:
                    self._reply(504, {"error": "forward_timeout",
                                      "replica": rep.url,
                                      "timeout_ms": round(
                                          timeout_s * 1e3, 1),
                                      "trace_id": trace_id},
                                trace_id=trace_id)
                    return 504, rep.url
                router._count("replica_errors")
                stat_add("router_replica_errors")
                logger.warning("stream forward to %s failed: %s",
                               rep.url, e)
                self._reply(502, {"error": "replica_error",
                                  "replica": rep.url,
                                  "detail": f"{type(e).__name__}: {e}",
                                  "trace_id": trace_id},
                            trace_id=trace_id)
                return 502, rep.url
            try:
                if resp.status != 200:
                    # the replica ANSWERED (shed/400/...): nothing
                    # was streamed, the verdict passes through
                    # verbatim — and counts as routed, like route()
                    data = resp.read()
                    ra = resp.headers.get("Retry-After")
                    self._reply_raw(
                        resp.status, data,
                        resp.headers.get("Content-Type",
                                         "application/json"),
                        trace_id=trace_id,
                        headers={"Retry-After": ra} if ra else None)
                else:
                    # headers out, then the line-by-line copy: the
                    # client's first token line arrives when the
                    # replica's does.  Body reads get the WIDE timeout
                    if conn.sock is not None:
                        conn.sock.settimeout(router.request_timeout_s)
                    self.send_response(resp.status)
                    self.send_header(
                        "Content-Type",
                        resp.headers.get("Content-Type",
                                         "application/x-ndjson"))
                    self.send_header("Connection", "close")
                    if trace_id:
                        self.send_header(TRACE_HEADER, trace_id)
                    wv = resp.headers.get(VERSION_HEADER)
                    if wv:
                        self.send_header(VERSION_HEADER, wv)
                    self.end_headers()
                    self.close_connection = True
                    try:
                        for raw in resp:
                            self.wfile.write(raw)
                            self.wfile.flush()
                    except OSError:
                        pass  # ok: client hung up mid-stream; the
                        # replica finishes its sequence regardless
            finally:
                conn.close()
                with router._lock:
                    rep.inflight -= 1
                    rep.routed += 1
                    if retried:
                        rep.retries_to += 1
            router._count("routed")
            stat_add("router_requests_routed")
            router._canary_observe(rep.url, resp.status, t0)
            if resp.status == 200:
                ms = (time.monotonic() - t0) * 1e3
                router._h_request.observe(ms, trace_id=trace_id)
                telemetry.histogram_observe("router_request_ms", ms,
                                            trace_id=trace_id)
                router._db.record("router_request_ms", ms, cap=4096)
            return resp.status, rep.url
        router._count("no_ready")
        stat_add("router_no_ready_replicas")
        retry_after = int(math.ceil(min(30.0, max(1.0,
                                                  router._stale_s))))
        self._reply(503, {"error": "overloaded",
                          "reason": "no_ready_replicas",
                          "retry_after_s": retry_after,
                          "trace_id": trace_id}, trace_id=trace_id,
                    headers={"Retry-After": str(retry_after)})
        return 503, None

    # -- disaggregated streaming (prefill hop -> pinned adopt stream) -------
    def _disagg_stream(self, body: bytes, trace_id: Optional[str],
                       deadline_ms: Optional[float], t0: float,
                       tenant: Optional[str] = None):
        """Streamed ``/generate`` on a role-split fleet: non-stream
        prefill hop (retryable), then the NDJSON decode stream pinned
        to the adopting replica.  Pre-stream adopt failures follow the
        affinity taxonomy (connect-refused → one alternate;
        ``FLAGS_disagg_reprefill=1`` → one full-pipeline restart);
        once bytes are on the wire a dead decode replica ends the
        stream with a best-effort ``affinity_lost`` error line — the
        segment (and therefore the generation) died with it."""
        from .disagg import SEGMENT_CONTENT_TYPE

        router = self.router
        router._count("requests")
        stat_add("router_http_requests")
        router._count("disagg_generations")
        stat_add("router_disagg_generations")
        pre_body, mnt, _ = router._split_generate_body(body)
        allow_reprefill = bool(flag_value("FLAGS_disagg_reprefill"))
        attempts = 0
        dead_decode: List[str] = []
        while True:
            span = telemetry.span_begin("router/prefill_hop",
                                        detached=True,
                                        trace_id=trace_id, stream=True)
            try:
                pre = router.route(
                    "/generate", pre_body, trace_id,
                    deadline_ms=router._remaining(deadline_ms, t0),
                    role="prefill", count=False, tenant=tenant)
                if span is not None:
                    span.attrs["status"] = pre["code"]
                    span.attrs["replica"] = pre["replica"]
            finally:
                telemetry.span_end(span)
            if pre["code"] != 200 \
                    or pre["content_type"] != SEGMENT_CONTENT_TYPE:
                # a 200 here is a both-role replica's FULL non-stream
                # answer (mixed fleet): still a valid reply body —
                # stream framing is lost, correctness is not
                ra = pre.get("retry_after")
                self._reply_raw(pre["code"], pre["body"],
                                pre["content_type"], trace_id=trace_id,
                                headers={"Retry-After": str(ra)}
                                if ra else None)
                if pre["code"] == 200:
                    # the short-circuit IS the whole served request:
                    # it must feed the SLO/autoscale series like
                    # every other 200
                    router._observe_request(t0, trace_id)
                return pre["code"], pre["replica"]
            seg_bytes = pre["body"]
            stat_add("router_segment_bytes", len(seg_bytes))
            outcome = self._adopt_stream_hop(seg_bytes, mnt, trace_id,
                                             deadline_ms, t0,
                                             exclude=dead_decode,
                                             tenant=tenant)
            if outcome[0] == "retry":
                # post-send death of the adopting replica: the
                # affinity taxonomy books its evidence here whether
                # or not a reprefill heals the request — counter
                # parity with the non-stream pipeline
                router._count_affinity_lost(outcome[1], trace_id,
                                            outcome[2], stream=True)
                if allow_reprefill and attempts == 0:
                    attempts += 1
                    if outcome[1]:
                        dead_decode.append(outcome[1])
                    router._count("reprefills")
                    stat_add("router_reprefills")
                    telemetry.log_event("router_reprefill",
                                        trace_id=trace_id, stream=True)
                    continue
                res = router._affinity_lost_res(outcome[1], trace_id,
                                                outcome[2], False,
                                                count=False)
                res.pop("_affinity_lost", None)
                self._reply_raw(res["code"], res["body"],
                                res["content_type"], trace_id=trace_id)
                return res["code"], outcome[1]
            return outcome[1], outcome[2]

    def _adopt_stream_hop(self, seg_bytes: bytes, mnt,
                          trace_id: Optional[str],
                          deadline_ms: Optional[float], t0: float,
                          exclude=(), tenant: Optional[str] = None):
        """One pinned adopt-stream attempt.  Returns ``("done", code,
        replica)`` when a reply (stream or passthrough error) went to
        the client, or ``("retry", replica_url, detail)`` when the
        adopt failed BEFORE any byte reached the client (the caller
        decides between affinity_lost and a reprefill)."""
        router = self.router
        query = "/adopt?stream=1"
        if mnt is not None:
            query += f"&max_new_tokens={int(mnt)}"
        tried: List[str] = list(exclude)
        retried = False
        while True:
            rep = router.pick(exclude=tried, role="decode")
            if rep is None:
                router._count("no_ready")
                stat_add("router_no_ready_replicas")
                retry_after = int(math.ceil(
                    min(30.0, max(1.0, router._stale_s))))
                self._reply(503, {"error": "overloaded",
                                  "reason": "no_ready_replicas",
                                  "detail": "no decode-capable replica "
                                            "for the adopt hop",
                                  "retry_after_s": retry_after,
                                  "trace_id": trace_id},
                            trace_id=trace_id,
                            headers={"Retry-After": str(retry_after)})
                return "done", 503, None
            remaining_ms = router._remaining(deadline_ms, t0)
            if remaining_ms is not None and remaining_ms <= 0:
                res = router._shed_deadline(trace_id, deadline_ms,
                                            retried)
                self._reply_raw(res["code"], res["body"],
                                res["content_type"], trace_id=trace_id)
                return "done", res["code"], rep.url
            deadline_bound = (remaining_ms is not None
                              and remaining_ms / 1e3
                              < router.forward_timeout_s)
            timeout_s = router.forward_timeout_s \
                if remaining_ms is None \
                else max(0.05, min(router.forward_timeout_s,
                                   remaining_ms / 1e3))
            headers = {"Content-Type": "application/octet-stream",
                       TRACE_HEADER: trace_id or ""}
            if remaining_ms is not None:
                headers[DEADLINE_HEADER] = f"{remaining_ms:.1f}"
            if tenant:
                headers[TENANT_HEADER] = tenant
            host_port = rep.url.split("://", 1)[-1]
            with router._lock:
                rep.inflight += 1
            conn = None
            span = telemetry.span_begin("router/adopt_hop",
                                        detached=True,
                                        trace_id=trace_id, stream=True,
                                        bytes=len(seg_bytes))
            try:
                try:
                    kind = fault.fire("router_forward")
                    fault.maybe_delay(kind)
                    if kind == "fail":
                        raise ConnectionRefusedError(
                            "injected router_forward failure")
                    conn = http.client.HTTPConnection(
                        host_port, timeout=timeout_s)
                    conn.request("POST", query, seg_bytes, headers)
                    resp = conn.getresponse()
                except Exception as e:  # noqa: BLE001 — taxonomy below
                    with router._lock:
                        rep.errors += 1
                    if conn is not None:
                        conn.close()
                    timed_out = _is_timeout_error(e)
                    if timed_out and deadline_bound:
                        res = router._shed_deadline(
                            trace_id, deadline_ms, retried)
                        self._reply_raw(res["code"], res["body"],
                                        res["content_type"],
                                        trace_id=trace_id)
                        return "done", res["code"], rep.url
                    if isinstance(e, ConnectionRefusedError):
                        # segment never delivered: an alternate decode
                        # replica adopts it safely
                        router._poll_failed(rep, f"connect: {e}")
                        if not retried:
                            tried.append(rep.url)
                            router._count("retries")
                            stat_add("router_retries")
                            retried = True
                            continue
                        # refused again: dead replica, nothing ever
                        # adopted — not an affinity loss
                        router._count("replica_errors")
                        stat_add("router_replica_errors")
                        self._reply(502, {"error": "replica_error",
                                          "replica": rep.url,
                                          "detail": f"adopt connect: "
                                                    f"{e}",
                                          "trace_id": trace_id},
                                    trace_id=trace_id)
                        return "done", 502, rep.url
                    if timed_out:
                        router._count("forward_timeouts")
                        stat_add("router_forward_timeouts")
                        router._poll_failed(
                            rep, f"adopt timeout ({timeout_s:.2f}s)")
                    return "retry", rep.url, f"{type(e).__name__}: {e}"
                if span is not None:
                    span.attrs["replica"] = rep.url
                    span.attrs["status"] = resp.status
                if resp.status != 200:
                    data = resp.read()
                    ra = resp.headers.get("Retry-After")
                    with router._lock:
                        rep.routed += 1
                    router._count("routed")
                    stat_add("router_requests_routed")
                    self._reply_raw(
                        resp.status, data,
                        resp.headers.get("Content-Type",
                                         "application/json"),
                        trace_id=trace_id,
                        headers={"Retry-After": ra} if ra else None)
                    return "done", resp.status, rep.url
                # 200: copy the NDJSON stream, pinned — no retry is
                # possible once bytes go out (the cache lives there)
                if conn.sock is not None:
                    conn.sock.settimeout(router.request_timeout_s)
                self.send_response(resp.status)
                self.send_header("Content-Type",
                                 resp.headers.get(
                                     "Content-Type",
                                     "application/x-ndjson"))
                self.send_header("Connection", "close")
                if trace_id:
                    self.send_header(TRACE_HEADER, trace_id)
                self.end_headers()
                self.close_connection = True
                broken = None
                try:
                    while True:
                        try:
                            raw = resp.readline()
                        except Exception as e:  # noqa: BLE001 — the
                            # DECODE replica died mid-stream: the
                            # generation's cache died with it — the
                            # explicit taxonomy, surfaced as a final
                            # error line since the 200 is long gone
                            broken = f"{type(e).__name__}: {e}"
                            break
                        if not raw:
                            break
                        self.wfile.write(raw)
                        self.wfile.flush()
                except OSError:
                    pass  # ok: OUR client hung up; the replica
                    # finishes its sequence regardless
                if broken is not None:
                    router._count_affinity_lost(
                        rep.url, trace_id, f"mid-stream: {broken}",
                        stream=True)
                    try:
                        line = json.dumps(
                            {"done": True, "error": "affinity_lost",
                             "detail": broken,
                             "trace_id": trace_id}) + "\n"
                        self.wfile.write(line.encode())
                        self.wfile.flush()
                    except OSError:
                        pass  # ok: client gone too
                with router._lock:
                    rep.routed += 1
                router._count("routed")
                stat_add("router_requests_routed")
                if broken is None:
                    router._observe_request(t0, trace_id)
                return "done", resp.status, rep.url
            finally:
                telemetry.span_end(span)
                if conn is not None:
                    conn.close()
                with router._lock:
                    rep.inflight -= 1

    def do_POST(self):
        try:
            n = int(self.headers.get("Content-Length", 0) or 0)
        except ValueError:
            n = 0
        body = self.rfile.read(n) if n > 0 else b""
        route = self.path.split("?", 1)[0]
        if route not in ("/predict", "/generate"):
            self._reply(404, {"error": "not found", "path": self.path})
            return
        # forward the caller's trace id or mint one: the replica's
        # serving/request root adopts it, so the hop below and the
        # replica's spans share ONE trace
        trace_id = parse_trace_header(self.headers.get(TRACE_HEADER)) \
            or (telemetry.new_trace_id() if telemetry.enabled()
                else None)
        # forward the caller's deadline budget or mint the fleet
        # default: every downstream hop decrements and sheds on it
        deadline_ms = parse_deadline_header(
            self.headers.get(DEADLINE_HEADER))
        if deadline_ms is None:
            dflt = float(flag_value("FLAGS_router_default_deadline_ms")
                         or 0.0)
            if dflt > 0:
                deadline_ms = dflt
        # the attribution identity: forwarded verbatim on every hop so
        # both halves of a disagg pipeline bill the same tenant.
        # FLAGS_usage=0 keeps the header unread — zero per-request work
        tenant = parse_tenant_header(self.headers.get(TENANT_HEADER)) \
            if usage.enabled() else None
        t0 = time.monotonic()
        if self._wants_stream(route, body):
            root = telemetry.span_begin("router/request", detached=True,
                                        trace_id=trace_id, path=route,
                                        stream=True)
            try:
                if route == "/generate" and self.router.disagg_active():
                    code, replica = self._disagg_stream(
                        body, trace_id, deadline_ms, t0,
                        tenant=tenant)
                else:
                    code, replica = self._forward_stream(
                        route, body, trace_id, deadline_ms, t0,
                        tenant=tenant)
            except Exception as e:  # noqa: BLE001 — a passthrough bug
                # must not drop the connection silently (headers may
                # already be out; best-effort close, honest log line)
                logger.exception("stream forward (%s) raised", route)
                code, replica = 500, None
            finally:
                if root is not None:
                    root.attrs["status"] = code
                telemetry.span_end(root)
            self.access_log.write({
                "ts": round(time.time(), 6), "method": "POST",
                "path": route, "status": code,
                "ms": round((time.monotonic() - t0) * 1e3, 3),
                "trace_id": trace_id, "tier": "router",
                "replica": replica, "stream": True})
            return
        root = telemetry.span_begin("router/request", detached=True,
                                    trace_id=trace_id, path=route)
        fwd = telemetry.span_begin(
            "router/forward", detached=True,
            parent=root.context() if root is not None else None,
            trace_id=trace_id)
        res = None
        try:
            if route == "/generate" and self.router.disagg_active():
                res = self.router.route_generate(
                    body, trace_id, deadline_ms=deadline_ms,
                    tenant=tenant)
            else:
                # capability steering: a sparse-id /predict body can
                # only be served by an embedding-capable replica (byte
                # probe, not a JSON parse — the body is forwarded
                # verbatim either way, and a false positive on a
                # capability-free fleet is impossible: the gate below
                # requires a live capable replica first)
                role = None
                if (route == "/predict"
                        and self.router.embedding_active()):
                    role = ("embedding" if b'"sparse_ids"' in body
                            else "dense")
                res = self.router.route(route, body, trace_id,
                                        deadline_ms=deadline_ms,
                                        role=role, tenant=tenant)
            if fwd is not None:
                fwd.attrs["replica"] = res["replica"]
                fwd.attrs["retried"] = res["retried"]
                fwd.attrs["status"] = res["code"]
        except Exception as e:  # noqa: BLE001 — a routing bug must
            # answer 500, not drop the connection (and must not leak
            # the open hop spans)
            logger.exception("router route(%s) raised", route)
            res = {"code": 500,
                   "body": json.dumps(
                       {"error": "router internal",
                        "detail": f"{type(e).__name__}: {e}",
                        "trace_id": trace_id}).encode(),
                   "content_type": "application/json", "replica": None,
                   "retried": False}
            if fwd is not None:
                fwd.attrs["status"] = 500
        finally:
            telemetry.span_end(fwd)
            if root is not None:
                root.attrs["status"] = res["code"] if res else 500
            telemetry.span_end(root)
        headers = {}
        if res.get("retry_after"):
            # router-origin backoff hints AND replica Retry-After
            # headers (their 503s pass through verbatim) both land on
            # the client
            headers["Retry-After"] = str(res["retry_after"])
        if res.get("weights_version"):
            # the serving replica's weights version passes through to
            # the client — canary observability and the loadgen's
            # per-phase version distribution both read it here
            headers[VERSION_HEADER] = str(res["weights_version"])
        self._reply_raw(res["code"], res["body"], res["content_type"],
                        trace_id=trace_id, headers=headers or None)
        ms = (time.monotonic() - t0) * 1e3
        rec = {
            "ts": round(time.time(), 6), "method": "POST",
            "path": route, "status": res["code"],
            "ms": round(ms, 3), "trace_id": trace_id, "tier": "router",
            "replica": res["replica"], "retried": res["retried"]}
        if deadline_ms is not None:
            rec["deadline_ms"] = deadline_ms
        if res.get("disagg"):
            rec["disagg"] = res["disagg"]
        if res.get("reprefilled"):
            rec["reprefilled"] = True
        self.access_log.write(rec)


class RouterServer:
    """Own the router listener + serve_forever thread (the router tier
    analog of :class:`~paddle_tpu_torch.serving.server.ServingServer`).
    ``port=0`` binds ephemeral; ``close()`` stops the listener and the
    router's poll thread."""

    def __init__(self, router: Router, host: str = "127.0.0.1",
                 port: int = 0):
        self.router = router
        self.access_log = _AccessLog()
        handler = type("BoundRouterHandler", (_RouterHandler,),
                       {"router": router, "access_log": self.access_log})
        self._httpd = _HTTPServer((host, port), handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None
        self._closed = False

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "RouterServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                kwargs={"poll_interval": 0.1}, name="router-http",
                daemon=True)
            self._thread.start()
        return self

    def close(self):
        if self._closed:
            return
        self._closed = True
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except OSError as e:
            logger.warning("router listener shutdown: %s", e)
        if self._thread is not None:
            self._thread.join(5.0)
        self.router.close()
        self.access_log.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False


def serve_router(replicas, host: str = "127.0.0.1", port: int = 0,
                 **router_kw) -> RouterServer:
    """Create + start a :class:`RouterServer` over ``replicas``."""
    return RouterServer(Router(replicas, **router_kw), host,
                        port).start()
