"""HTTP front end for the serving engine (stdlib-only).

The port's counterpart of ``paddle_tpu/serving/server.py``, with the same
endpoints, bodies, status codes and headers, so a client or router of
either package talks to both.

A ``ThreadingHTTPServer`` JSON surface over
:class:`~paddle_tpu_torch.serving.engine.ServingEngine` — the network analog
of the reference's Paddle-Serving deployment, kept deliberately thin:
every scheduling decision (batching, shedding, deadlines) lives in the
engine, so in-process callers (tests, bench, loadgen) and HTTP clients
get identical semantics.

Endpoints:

* ``POST /predict`` — body ``{"inputs": {feed_name: nested_list}}``
  (each input carries its leading batch dim).  200 →
  ``{"outputs": [nested_list, ...], "shapes": [...], "ms": float,
  "trace_id": hex}``.  Overload/drain sheds → **503** ``{"error":
  "overloaded", "reason": "queue_full" | "deadline" | "draining" |
  "injected", "retry_after_s": float}`` with a ``Retry-After`` header
  derived from the engine's live backlog (explicit backpressure,
  never unbounded queueing); malformed body / wrong feeds → 400;
  batch execution failure → 500 (with poison bisection, exactly the
  poisoned request 500s — its batchmates still answer 200
  bit-exact).  An ``X-PaddleTPU-Deadline-Ms`` request header (the
  remaining end-to-end budget, minted/decremented by the fleet
  router) tightens the engine deadline: an exhausted budget sheds at
  admission (503 ``deadline``) instead of burning a batch slot.
* ``POST /generate`` — body ``{"prompt": [token ids],
  "max_new_tokens": N?, "stream": bool?}`` against the attached
  :class:`~paddle_tpu_torch.serving.generation.GenerationEngine` (slot-based
  continuous batching).  200 → ``{"tokens": [...], "prompt_len",
  "steps", "finish": "eos" | "length" | "cache_full", "trace_id",
  "queue_wait_ms", "prefill_ms", "ttft_ms", "total_ms", "ms",
  "timeline"?}`` (``timeline``: the per-sequence phase/token record —
  telemetry on).  With ``"stream": true`` the response is NDJSON —
  one ``{"i", "token"}`` line per token AS IT IS GENERATED, then one
  ``{"done": true, ...result}`` summary line; framed by ``Connection:
  close`` (no Content-Length), which is what lets a client measure
  true TTFT and inter-token latency.  Sheds → **503**
  like ``/predict``; malformed or over-long prompts → 400; no
  generator attached → 404.
* ``POST /swap`` — in-place weight hot-swap: body ``{"dir":
  checkpoint_dir}`` (or ``{"revert": true}`` to restore the previous
  weights, ``"target": "generate"`` to swap the attached generation
  engine instead of the predict pool).  200 → ``{"weights_version",
  "swap_ms"}``; **409** ``{"error": "swap_mismatch"}`` when the
  checkpoint's structure (shape/dtype/name set) drifts from the live
  weights — rejected at admission, never half-applied, exactly the
  ``/adopt`` fingerprint discipline; **503** while draining or when
  another swap is mid-flight / the quiesce timed out (the replica
  keeps serving the old weights).  Every ``/predict``, ``/generate``
  and ``/swap`` response carries the live ``X-PaddleTPU-Weights-
  Version`` header, and ``/healthz`` + ``/statusz`` publish
  ``weights_version`` — how the fleet supervisor and the canary
  router verify a rollout replica-by-replica.
* ``GET /healthz`` — 200 with :meth:`ServingEngine.health` (serving
  stats + the telemetry heartbeat's process fields); 503 once the
  engine is closed — a load balancer drains the instance on SIGTERM.
* ``GET /metrics`` — the live in-process registry rendered in strict
  Prometheus text exposition format (``text/plain; version=0.0.4``) —
  a real scrape target, not the textfile exporter.  503 when
  ``FLAGS_telemetry=0``.
* ``GET /statusz`` — JSON operator snapshot: every flag's current
  value, pid/uptime/restart count, engine state (queue depth + peak,
  buckets, workers, compiled executables), trace-store occupancy.
* ``GET /tracez`` — JSON of recent head-sampled request traces (full
  span trees) + the always-kept slowest-N tail.  503 when telemetry
  is off.

Every ``/predict`` request also appends one line to the JSONL access
log (``FLAGS_serving_access_log``, defaulting to
``<FLAGS_metrics_dir>/access.jsonl``): ts, status, total ms, trace_id,
and the per-phase latency breakdown (queue_wait/predict) from the
request's trace record — grep a slow trace_id straight from the log
into ``/tracez``.

``install_sigterm()`` wires graceful shutdown: SIGTERM stops admission,
flushes in-flight batches, then stops the listener (mirrors
``TrainGuard``'s preemption contract).
"""
from __future__ import annotations

import json
import logging
import math
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .. import blackbox, costmodel, fault, observatory, telemetry
from ..flags import all_flags, flag_value
from ..monitor import process_uptime_s, stat_add
from . import usage
from .engine import OverloadedError, RequestFailed, ServingEngine

__all__ = ["ServingServer", "serve"]

logger = logging.getLogger("paddle_tpu_torch.serving.http")

# cross-tier trace propagation: the fleet router mints (or forwards) a
# trace id in this header; the replica's serving/request root span
# adopts it, so one served request is ONE trace across both tiers
TRACE_HEADER = "X-PaddleTPU-Trace"
_TRACE_ID_RE = re.compile(r"^[A-Za-z0-9_-]{1,64}$")

# end-to-end deadline propagation: the REMAINING latency budget (ms) a
# request still has.  Minted by the client or the fleet router
# (FLAGS_router_default_deadline_ms), decremented by the router's own
# elapsed time before each forward, adopted by replica admission so a
# hopeless request sheds at the queue instead of burning a batch slot.
DEADLINE_HEADER = "X-PaddleTPU-Deadline-Ms"

# weight-rollout visibility: every data-plane response names the
# weights version that was live when it was answered, so a client (the
# chaos harness, the loadgen, the canary router) can assert a swap
# flipped atomically — per replica the observed version is monotonic,
# never a torn mix
VERSION_HEADER = "X-PaddleTPU-Weights-Version"

# per-tenant usage attribution: the tenant id a request's cost vector
# books under (serving/usage.py).  The router stamps it
# through BOTH hops of the disaggregated pipeline, so prefill and
# decode cost land on the same tenant; absent/malformed values book
# under FLAGS_usage_default_tenant
TENANT_HEADER = "X-PaddleTPU-Tenant"


def parse_trace_header(value) -> Optional[str]:
    """Validate an incoming trace-id header: a short url-safe token or
    nothing (a malformed id is dropped, never adopted — trace identity
    must stay greppable and log-safe)."""
    if not value:
        return None
    value = value.strip()
    return value if _TRACE_ID_RE.match(value) else None


def parse_deadline_header(value) -> Optional[float]:
    """Validate an incoming remaining-budget header: a finite float of
    milliseconds, or nothing (malformed / non-finite values are
    dropped — a garbage header must not become an infinite or NaN
    deadline)."""
    if not value:
        return None
    try:
        ms = float(str(value).strip())
    except ValueError:
        return None
    return ms if math.isfinite(ms) else None


def parse_tenant_header(value) -> Optional[str]:
    """Validate an incoming tenant header: a short log-safe token or
    nothing (a malformed id is dropped here and books under the
    default tenant — a garbage header must not mint ledger keys)."""
    if not value:
        return None
    value = str(value).strip()
    return value if usage.TENANT_RE.match(value) else None


_slo_monitor = None
_slo_monitor_lock = threading.Lock()


def replica_slo_monitor():
    """The replica-tier burn-rate monitor (lazily built, process-wide):
    availability over batch failures vs batches served (cadence-fed by
    :func:`telemetry.maybe_flush`), latency over the raw per-request
    ``serving_request_ms`` samples the engine records at resolve time.
    The fleet router runs the fleet-level twin over federated series;
    this one makes a single replica's ``/statusz`` alert-capable on
    its own."""
    global _slo_monitor
    from .. import tsdb

    if _slo_monitor is None:
        with _slo_monitor_lock:
            if _slo_monitor is None:
                slo_ms = usage.slo_p99_ms()
                _slo_monitor = tsdb.BurnRateMonitor(tsdb.default(), [
                    tsdb.SloSpec("availability", "availability",
                                 error_series="serving_batch_failures",
                                 total_series="serving_batches"),
                    # raw per-request samples (the engine records them
                    # at resolve time), NOT the histogram's p99 series:
                    # lifetime-cumulative percentiles would latch the
                    # alert long after a spike recovered
                    tsdb.SloSpec("p99", "latency",
                                 latency_series="serving_request_ms",
                                 threshold_ms=slo_ms,
                                 objective_pct=99.0),
                ])
    return _slo_monitor


class _AccessLog:
    """Append-only JSONL request log (one line per ``/predict``).

    Honors the telemetry never-raise contract: the path re-resolves
    per write (flags can change at runtime), I/O failures bump
    ``telemetry_write_failures`` and drop the line, and the
    ``metrics_write`` fault site covers it in CI.  The append handle is
    cached (reopened only when the resolved path changes, or after an
    error): handler threads must not pay an open/close plus a makedirs
    syscall per request on the response path."""

    def __init__(self):
        self._lock = threading.Lock()
        self._path: Optional[str] = None
        self._fh = None

    def path(self) -> Optional[str]:
        if not telemetry.enabled():
            return None
        p = flag_value("FLAGS_serving_access_log")
        if p:
            return str(p)
        d = flag_value("FLAGS_metrics_dir")
        return os.path.join(str(d), "access.jsonl") if d else None

    def write(self, rec: dict):
        path = self.path()
        if path is None:
            return
        line = json.dumps(rec, sort_keys=True, default=str) + "\n"
        try:
            if fault.fire("metrics_write") == "raise":
                raise fault.InjectedFault("injected access-log failure")
            with self._lock:
                if path != self._path or self._fh is None:
                    self._close_locked()
                    os.makedirs(os.path.dirname(path) or ".",
                                exist_ok=True)
                    self._fh = open(path, "a")
                    self._path = path
                self._fh.write(line)
                self._fh.flush()  # a tail -f / test reader sees it now
        except OSError as e:
            stat_add("telemetry_write_failures")
            logger.warning("access log write %s failed: %s", path, e)
            with self._lock:
                self._close_locked()  # reopen fresh on the next write

    def _close_locked(self):
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError as e:
                logger.debug("access log close: %s", e)
        self._fh, self._path = None, None

    def close(self):
        with self._lock:
            self._close_locked()


class _JsonHandler(BaseHTTPRequestHandler):
    """Shared reply framing for every serving-tier HTTP handler (the
    replica front end here and the fleet router's): keep-alive
    HTTP/1.1 with explicit Content-Length and the optional cross-tier
    trace-id response header — one place to change, so the two tiers'
    wire framing cannot drift apart."""

    logger = logger  # subclasses re-point at their tier's logger

    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet: route through logging
        self.logger.debug("%s " + fmt, self.address_string(), *args)

    def _reply(self, code: int, payload: dict,
               trace_id: Optional[str] = None,
               headers: Optional[dict] = None):
        body = json.dumps(payload).encode()
        self._reply_raw(code, body, "application/json",
                        trace_id=trace_id, headers=headers)

    def _reply_raw(self, code: int, body: bytes, content_type: str,
                   trace_id: Optional[str] = None,
                   headers: Optional[dict] = None):
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        if trace_id:
            self.send_header(TRACE_HEADER, trace_id)
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(body)


class _Handler(_JsonHandler):
    # set by ServingServer on the subclass
    engine: ServingEngine = None
    request_timeout_s: Optional[float] = None
    access_log: _AccessLog = None

    # -- GET introspection plane --------------------------------------------
    def do_GET(self):
        route = self.path.split("?", 1)[0]
        handler = {"/healthz": self._get_healthz,
                   "/metrics": self._get_metrics,
                   "/statusz": self._get_statusz,
                   "/tracez": self._get_tracez,
                   "/debugz": self._get_debugz,
                   "/usagez": self._get_usagez,
                   "/profilez": self._get_profilez}.get(route)
        if handler is None:
            self._reply(404, {"error": "not found", "path": self.path})
            return
        handler()

    def _get_healthz(self):
        # chaos site: a hanging or failing health endpoint is how a
        # wedged replica looks to the router's poll loop — delay:ms /
        # hang kinds stall THIS handler thread (the poll times out and
        # strikes), `fail` answers 500
        kind = fault.fire("replica_health")
        fault.maybe_delay(kind)
        if kind == "fail":
            self._reply(500, {"error": "injected replica_health "
                                       "failure"})
            return
        health = self.engine.health()
        self._reply(503 if health["status"] == "closed" else 200, health)

    def _get_metrics(self):
        """Prometheus scrape target over the LIVE in-process registry
        (the textfile exporter only refreshes on the flush cadence and
        dies with the process; a scrape answers now)."""
        if not telemetry.enabled():
            self._reply(503, {"error": "telemetry disabled",
                              "detail": "FLAGS_telemetry=0"})
            return
        text = telemetry.prometheus_text()
        if usage.enabled() and usage.peek_ledger() is not None:
            # labeled per-tenant families ride the same scrape (the
            # router's federation reads them from here)
            text += usage.peek_ledger().prometheus_text()
        self._reply_raw(200, text.encode(),
                        "text/plain; version=0.0.4; charset=utf-8")

    def _get_usagez(self):
        """Per-tenant cost vectors, heavy-hitter sketch occupancy, the
        live conservation check, and per-tenant SLO burn state.  200
        with ``{"enabled": false}`` when ``FLAGS_usage=0`` (an
        observatory dashboard polls this without special-casing), and
        an empty ledger view before the first booked request."""
        if not usage.enabled():
            self._reply(200, {"enabled": False,
                              "detail": "FLAGS_usage=0"})
            return
        led = usage.peek_ledger()
        if led is None:
            self._reply(200, {"enabled": True, "tenants": {},
                              "totals": {}, "detail": "nothing booked"})
            return
        self._reply(200, led.usagez())

    def _statusz_doc(self) -> dict:
        """The /statusz payload (also the spine of a /debugz bundle) —
        works with telemetry off too (flags and engine state carry no
        telemetry dependency; the tsdb/alerts blocks are None then)."""
        from .. import tsdb as _tsdb

        tele = {"enabled": telemetry.enabled(),
                "access_log": self.access_log.path(),
                "metrics_dir": flag_value("FLAGS_metrics_dir") or None,
                "trace_sample": flag_value("FLAGS_trace_sample"),
                "trace_tail_keep": flag_value("FLAGS_trace_tail_keep")}
        slo = None
        db_stats = None
        if telemetry.enabled() and _tsdb.enabled():
            slo = replica_slo_monitor().evaluate()
            db_stats = _tsdb.default().stats()
        return {
            "pid": os.getpid(),
            "time": time.time(),
            "process_uptime_s": process_uptime_s(),
            "restart_count": int(
                os.environ.get("PADDLE_TPU_RESTART_COUNT", "0") or 0),
            "server": {"host": self.server.server_address[0],
                       "port": self.server.server_address[1]},
            "telemetry": tele,
            "flags": all_flags(),
            "device": {"peaks": costmodel.device_peaks(),
                       "hbm": observatory.hbm_snapshot()},
            "slo": slo,
            "tsdb": db_stats,
            "usage": self._usage_block(),
            "engine": self.engine.introspect(),
        }

    @staticmethod
    def _usage_block() -> dict:
        """The /statusz usage summary: enough to see attribution is
        live and conserved without the full /usagez payload."""
        if not usage.enabled():
            return {"enabled": False}
        led = usage.peek_ledger()
        if led is None:
            return {"enabled": True, "tenants": 0, "booked": False}
        snap = led.snapshot()
        cons = led.conservation()
        return {
            "enabled": True,
            "booked": True,
            "tenants": len(snap["tenants"]) - 1,  # minus ~other
            "totals": snap["totals"],
            "sketch": led.sketch_stats(),
            "conservation_ok": all(v["delta"] == 0
                                   for v in cons.values()),
        }

    def _get_statusz(self):
        self._reply(200, self._statusz_doc())

    def _get_debugz(self):
        """One-shot debug bundle: statusz + tracez + the live metric
        registry + the blackbox flight-recorder ring in one JSON doc —
        one fetch captures everything a postmortem would have, from a
        process that is still alive.  ``?dump=1`` additionally writes
        a postmortem file (reason ``requested``) and reports its
        path.  Always 200: each block degrades to a disabled marker
        rather than failing the bundle."""
        doc = {"bundle": "paddle_tpu.debugz.v1",
               "statusz": self._statusz_doc(),
               "tracez": self.engine.tracez()
               if telemetry.enabled() else None,
               "metrics": telemetry.metrics.snapshot()
               if telemetry.enabled() else None,
               "blackbox": blackbox.snapshot()}
        query = self.path.partition("?")[2]
        if any(p in ("dump=1", "dump=true") for p in query.split("&")):
            doc["dump_path"] = blackbox.dump("requested")
        self._reply(200, doc)

    def _get_tracez(self):
        if not telemetry.enabled():
            self._reply(503, {"error": "telemetry disabled",
                              "detail": "FLAGS_telemetry=0"})
            return
        self._reply(200, self.engine.tracez())

    def _get_profilez(self):
        """On-demand profiler capture: ``GET /profilez?sec=N`` blocks
        this handler thread for N seconds (bounded) while torch.profiler
        traces whatever the engine is executing — serving
        never pauses (ThreadingHTTPServer keeps answering; the engine
        keeps batching).  200 with the artifact inventory, 503 with
        telemetry off, 409 when a capture is already in flight."""
        if not telemetry.enabled():
            self._reply(503, {"error": "telemetry disabled",
                              "detail": "FLAGS_telemetry=0"})
            return
        sec = None
        query = self.path.partition("?")[2]
        for part in query.split("&"):
            k, _, v = part.partition("=")
            if k == "sec" and v:
                try:
                    sec = float(v)
                except ValueError:
                    self._reply(400, {"error": "bad request",
                                      "detail": f"sec={v!r} is not a "
                                                "number"})
                    return
        try:
            rep = observatory.capture_profile(sec)
        except observatory.CaptureBusy as e:
            self._reply(409, {"error": "capture busy", "detail": str(e)})
            return
        except observatory.CaptureDisabled as e:
            self._reply(503, {"error": "telemetry disabled",
                              "detail": str(e)})
            return
        except Exception as e:  # profiler backend failure
            logger.warning("/profilez capture failed: %s", e)
            self._reply(500, {"error": "capture failed",
                              "detail": f"{type(e).__name__}: {e}"})
            return
        self._reply(200, rep)

    # -- POST /predict, /generate -------------------------------------------
    def do_POST(self):
        # drain the body FIRST, before any error reply: HTTP/1.1
        # keep-alive would otherwise parse leftover body bytes as the
        # next request line and desync the connection
        try:
            n = int(self.headers.get("Content-Length", 0) or 0)
        except ValueError:
            n = 0
        body = self.rfile.read(n) if n > 0 else b""
        route, _, query = self.path.partition("?")
        if route not in ("/predict", "/generate", "/adopt", "/swap"):
            self._reply(404, {"error": "not found", "path": self.path})
            return
        stat_add("serving_http_requests")
        if self.engine.warming():
            # a warming replica must not admit work: warmup runs the
            # generator's programs directly, outside the scheduler's
            # step boundary, and captures graphs one at a time, so an
            # early request would race it on the cache buffers.  The
            # router never places traffic here pre-ready; direct
            # clients get explicit backpressure.
            stat_add("serving_http_warming_shed")
            self._reply(503, {"error": "overloaded",
                              "reason": "warming",
                              "retry_after_s": 1.0},
                        headers={"Retry-After": "1",
                                 VERSION_HEADER:
                                 str(self.engine.weights_version)})
            return
        t0 = time.monotonic()
        hop_trace = parse_trace_header(self.headers.get(TRACE_HEADER))
        deadline_ms = parse_deadline_header(
            self.headers.get(DEADLINE_HEADER))
        # FLAGS_usage=0 zero-work contract: the header is not even read
        tenant = parse_tenant_header(self.headers.get(TENANT_HEADER)) \
            if usage.enabled() else None
        if route == "/predict":
            code, payload, trace = self._predict(body, hop_trace,
                                                 deadline_ms, tenant)
        elif route == "/adopt":
            code, payload, trace = self._adopt(body, query, hop_trace,
                                               deadline_ms, tenant)
        elif route == "/swap":
            code, payload, trace = self._swap(body, hop_trace)
        else:
            code, payload, trace = self._generate(body, hop_trace,
                                                  deadline_ms, tenant)
        tid = ((trace or {}).get("trace_id") or payload.get("trace_id")
               or hop_trace)
        if code is None:
            # a streaming reply already went out on the wire
            # (_generate_stream); only the access log is left
            code = payload.get("http_status", 200)
        else:
            # every data-plane reply names the weights version that
            # answered it (the torn-version chaos check reads this)
            headers = {VERSION_HEADER:
                       str(self.engine.weights_version)}
            if code == 503 and payload.get("retry_after_s"):
                # explicit backpressure carries its backoff hint:
                # clients (and the loadgen) back off instead of
                # hammering
                headers["Retry-After"] = \
                    str(int(math.ceil(payload["retry_after_s"])))
            self._reply(code, payload, trace_id=tid, headers=headers)
        ms = (time.monotonic() - t0) * 1e3
        rec = {"ts": round(time.time(), 6), "method": "POST",
               "path": route, "status": code, "ms": round(ms, 3),
               "trace_id": tid}
        if deadline_ms is not None:
            rec["deadline_ms"] = deadline_ms
        if trace:
            rec["rows"] = trace.get("rows")
            rec["phases"] = trace.get("phases")
            rec["request_status"] = trace.get("status")
        self.access_log.write(rec)

    def _generate(self, body: bytes, hop_trace: Optional[str] = None,
                  deadline_ms: Optional[float] = None,
                  tenant: Optional[str] = None):
        """One POST /generate body — ``{"prompt": [token ids],
        "max_new_tokens": N?}`` — against the attached GenerationEngine.
        404 when no generator is attached, 503 on overload sheds
        (queue_full / deadline / draining), 400 on malformed prompts,
        500 on a generation failure."""
        gen = getattr(self.engine, "generator", None)
        if gen is None:
            return 404, {"error": "not found",
                         "detail": "no generation engine attached"}, None
        try:
            doc = json.loads(body or b"{}")
            prompt = doc["prompt"]
            if not isinstance(prompt, list):
                raise TypeError("'prompt' must be a list of token ids")
            mnt = doc.get("max_new_tokens")
            stream = bool(doc.get("stream"))
            speculate = doc.get("speculate")
            if speculate is not None and not isinstance(speculate, bool):
                raise TypeError("'speculate' must be a boolean")
        except (KeyError, TypeError, ValueError) as e:
            return 400, {"error": "bad request",
                         "detail": f"{type(e).__name__}: {e}"}, None
        if stream:
            if getattr(gen, "role", "both") == "prefill":
                return 400, {"error": "bad request",
                             "detail": "prefill-role replica cannot "
                                       "stream — its /generate yields "
                                       "a KV segment, not tokens (the "
                                       "router owns the disaggregated "
                                       "handoff)"}, None
            return self._generate_stream(gen, prompt, mnt, hop_trace,
                                         deadline_ms, speculate, tenant)
        t0 = time.monotonic()
        try:
            fut = self.engine.submit_generate(prompt, max_new_tokens=mnt,
                                              trace_id=hop_trace,
                                              deadline_ms=deadline_ms,
                                              speculate=speculate,
                                              tenant=tenant)
            res = fut.result(self._wait_s(deadline_ms))
        except OverloadedError as e:
            return 503, {"error": "overloaded", "reason": e.reason,
                         "detail": str(e),
                         "retry_after_s": round(gen.retry_after_s(), 3),
                         "trace_id": getattr(e, "trace_id", None)}, None
        except ValueError as e:  # bad prompt shape/dtype/length
            return 400, {"error": "bad request", "detail": str(e)}, None
        except (RequestFailed, TimeoutError) as e:
            return 500, {"error": "request failed",
                         "detail": str(e)}, None
        res = dict(res)
        # keep_logits debug runs attach raw per-step logit arrays —
        # not JSON, and not part of the HTTP contract
        res.pop("logits", None)
        res["ms"] = round((time.monotonic() - t0) * 1e3, 3)
        trace = {"trace_id": res.get("trace_id"),
                 "rows": res.get("steps"),
                 "status": "ok:" + res.get("finish", ""),
                 "phases": {
                     "queue_wait_ms": res.get("queue_wait_ms"),
                     "predict_ms": res.get("prefill_ms")}}
        seg = res.pop("segment", None)
        if seg is not None:
            # prefill-role export: the reply IS the serialized segment
            # (octet payload the router ships to a decode replica's
            # POST /adopt); the request-record metadata rides a header
            from .disagg import SEGMENT_CONTENT_TYPE

            data = seg.to_bytes()
            meta = {k: res.get(k) for k in
                    ("trace_id", "prompt_len", "prefill_ms",
                     "queue_wait_ms", "total_ms", "ms")}
            self._reply_raw(
                200, data, SEGMENT_CONTENT_TYPE,
                trace_id=res.get("trace_id"),
                headers={"X-PaddleTPU-Segment-Meta": json.dumps(meta)})
            return None, {"http_status": 200,
                          "segment_bytes": len(data),
                          "trace_id": res.get("trace_id")}, trace
        return 200, res, trace

    def _adopt(self, body: bytes, query: str,
               hop_trace: Optional[str] = None,
               deadline_ms: Optional[float] = None,
               tenant: Optional[str] = None):
        """One ``POST /adopt`` — body is a serialized
        :class:`~paddle_tpu_torch.serving.disagg.KVSegment`; query args
        ``max_new_tokens`` and ``stream``.  404 when no decode-capable
        paged generator is attached, 400 on a corrupt segment, **409**
        on a fingerprint/geometry mismatch (the router surfaces it
        verbatim — adopting would decode garbage), 503 on overload
        sheds, 500 on a decode failure.  200 (or the NDJSON stream)
        carries the same result record as ``/generate`` — ``tokens``
        is the full sequence, the segment's tokens replayed first."""
        gen = getattr(self.engine, "generator", None)
        if gen is None or getattr(gen, "role", "both") == "prefill" \
                or not getattr(gen, "paged", False):
            return 404, {"error": "not found",
                         "detail": "no adopt-capable (decode-role "
                                   "paged) generation engine "
                                   "attached"}, None
        from .disagg import KVSegment, SegmentMismatch

        try:
            seg = KVSegment.from_bytes(body)
        except ValueError as e:
            return 400, {"error": "bad request",
                         "detail": f"segment: {e}"}, None
        stream = False
        mnt = None
        for part in query.split("&"):
            k, _, v = part.partition("=")
            if k == "stream" and v not in ("", "0", "false"):
                stream = True
            elif k == "max_new_tokens" and v:
                try:
                    mnt = int(v)
                except ValueError:
                    return 400, {"error": "bad request",
                                 "detail": f"max_new_tokens={v!r} is "
                                           "not an integer"}, None
        trace_id = hop_trace or seg.trace_id

        def submit(on_token=None):
            return gen.adopt(seg, max_new_tokens=mnt,
                             trace_id=trace_id,
                             deadline_ms=deadline_ms,
                             on_token=on_token,
                             tenant=tenant)

        if stream:
            return self._adopt_stream(gen, submit, trace_id,
                                      deadline_ms)
        t0 = time.monotonic()
        try:
            res = submit().result(self._wait_s(deadline_ms))
        except SegmentMismatch as e:
            return 409, {"error": "segment_mismatch",
                         "detail": str(e), "trace_id": trace_id}, None
        except OverloadedError as e:
            return 503, {"error": "overloaded", "reason": e.reason,
                         "detail": str(e),
                         "retry_after_s": round(gen.retry_after_s(), 3),
                         "trace_id": getattr(e, "trace_id", None)}, None
        except ValueError as e:
            return 400, {"error": "bad request", "detail": str(e)}, None
        except (RequestFailed, TimeoutError) as e:
            return 500, {"error": "request failed",
                         "detail": str(e)}, None
        res = dict(res)
        res.pop("logits", None)
        res["ms"] = round((time.monotonic() - t0) * 1e3, 3)
        return 200, res, {"trace_id": res.get("trace_id"),
                          "rows": res.get("steps"),
                          "status": "ok:" + res.get("finish", ""),
                          "phases": {
                              "queue_wait_ms": res.get("queue_wait_ms"),
                              "predict_ms": res.get("prefill_ms")}}

    def _generate_stream(self, gen, prompt, mnt,
                         hop_trace: Optional[str],
                         deadline_ms: Optional[float],
                         speculate: Optional[bool] = None,
                         tenant: Optional[str] = None):
        """``{"stream": true}`` generation: one NDJSON line per token,
        written the moment the scheduler books it (the engine's
        ``on_token`` hook feeds a handler-side queue, so a slow client
        never blocks the decode grid), then a final ``{"done": true,
        ...}`` summary line carrying the full result record (timeline
        included).  No Content-Length — the response frames by
        ``Connection: close``, which urllib and the loadgen read
        line-by-line; that is what makes CLIENT-side TTFT and
        inter-token latency measurable at all.  Admission sheds and
        bad prompts still answer plain JSON (nothing streamed yet).
        Returns ``(None, summary, trace)``: None tells ``do_POST`` the
        bytes are already on the wire."""
        return self._stream_from(
            gen,
            lambda on_token: self.engine.submit_generate(
                prompt, max_new_tokens=mnt, trace_id=hop_trace,
                deadline_ms=deadline_ms, on_token=on_token,
                speculate=speculate, tenant=tenant),
            hop_trace, deadline_ms)

    def _adopt_stream(self, gen, submit, trace_id, deadline_ms):
        """Streaming adoption: identical NDJSON contract to streamed
        ``/generate`` — the segment's replayed tokens arrive as the
        first lines, then every locally decoded one."""
        return self._stream_from(gen, submit, trace_id, deadline_ms)

    def _stream_from(self, gen, submit, hop_trace: Optional[str],
                     deadline_ms: Optional[float]):
        """Shared NDJSON streaming core: ``submit(on_token)`` starts
        the generation (a prompt submit or a segment adopt) and the
        handler copies tokens to the wire as they are booked."""
        import queue as queue_mod

        from .disagg import SegmentMismatch

        q: queue_mod.Queue = queue_mod.Queue()
        t0 = time.monotonic()
        try:
            fut = submit(lambda tok, ts: q.put((tok, ts)))
        except OverloadedError as e:
            return 503, {"error": "overloaded", "reason": e.reason,
                         "detail": str(e),
                         "retry_after_s": round(gen.retry_after_s(), 3),
                         "trace_id": getattr(e, "trace_id", None)}, None
        except SegmentMismatch as e:
            return 409, {"error": "segment_mismatch",
                         "detail": str(e)}, None
        except ValueError as e:
            return 400, {"error": "bad request", "detail": str(e)}, None
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Connection", "close")
        self.send_header(VERSION_HEADER,
                         str(self.engine.weights_version))
        if hop_trace:
            self.send_header(TRACE_HEADER, hop_trace)
        self.end_headers()
        self.close_connection = True
        wait_s = self._wait_s(deadline_ms)
        t_give_up = None if wait_s is None else t0 + wait_s
        n = 0
        client_gone = False
        timed_out = False
        while True:
            try:
                tok, ts = q.get(timeout=0.05)
            except queue_mod.Empty:
                if fut.done() and q.empty():
                    break
                if t_give_up is not None \
                        and time.monotonic() > t_give_up:
                    timed_out = True
                    break
                continue
            n += 1
            if client_gone:
                continue  # drain for accounting, write nothing
            line = json.dumps({"i": n, "token": int(tok)}) + "\n"
            try:
                self.wfile.write(line.encode())
                self.wfile.flush()
            except OSError:
                # the client hung up mid-stream: the sequence keeps
                # generating (no cancellation), we just stop writing
                client_gone = True
        final = {"done": True}
        status = 200
        try:
            # the loop only exits with the future resolved or the wait
            # budget spent — never block the handler a second time
            res = dict(fut.result(0.001))
            res.pop("logits", None)
            res["ms"] = round((time.monotonic() - t0) * 1e3, 3)
            res["streamed_tokens"] = n
            final.update(res)
        except (RequestFailed, TimeoutError) as e:
            status = 500
            final.update({"error": "request failed",
                          "detail": "stream timeout" if timed_out
                          else str(e)})
        except OverloadedError as e:
            # shed after admission (draining close): surfaced on the
            # final line — the HTTP status is long gone
            status = 503
            final.update({"error": "overloaded", "reason": e.reason,
                          "detail": str(e)})
        if not client_gone:
            try:
                self.wfile.write((json.dumps(final) + "\n").encode())
                self.wfile.flush()
            except OSError:
                client_gone = True
        summary = {"http_status": status, "stream": True,
                   "streamed_tokens": n, "client_gone": client_gone,
                   "trace_id": final.get("trace_id") or hop_trace}
        trace = {"trace_id": summary["trace_id"],
                 "rows": final.get("steps"),
                 "status": ("ok:" + final.get("finish", "")
                            if status == 200 else f"error:{status}"),
                 "phases": {"queue_wait_ms": final.get("queue_wait_ms"),
                            "predict_ms": final.get("prefill_ms")}}
        return None, summary, trace

    def _wait_s(self, deadline_ms: Optional[float]) -> Optional[float]:
        """How long the handler thread blocks for the future: the
        configured request timeout, tightened by the request's
        remaining deadline budget (+ grace for the in-batch tail — a
        deadline passing mid-batch still returns the real answer)."""
        if deadline_ms is None:
            return self.request_timeout_s
        budget = deadline_ms / 1e3 + 5.0
        return budget if self.request_timeout_s is None \
            else min(self.request_timeout_s, budget)

    def _predict(self, body: bytes, hop_trace: Optional[str] = None,
                 deadline_ms: Optional[float] = None,
                 tenant: Optional[str] = None):
        """Run one /predict body; returns (http_code, payload,
        trace_record_or_None) so do_POST can both reply and access-log
        without re-deciding anything."""
        try:
            doc = json.loads(body or b"{}")
            inputs = doc["inputs"]
            if not isinstance(inputs, dict):
                raise TypeError("'inputs' must be an object")
        except (KeyError, TypeError, ValueError) as e:
            return 400, {"error": "bad request",
                         "detail": f"{type(e).__name__}: {e}"}, None
        t0 = time.monotonic()
        fut = None
        try:
            fut = self.engine.submit(inputs, trace_id=hop_trace,
                                     deadline_ms=deadline_ms,
                                     tenant=tenant)
            outputs = fut.result(self._wait_s(deadline_ms))
        except OverloadedError as e:
            return 503, {"error": "overloaded", "reason": e.reason,
                         "detail": str(e),
                         "retry_after_s": round(
                             self.engine.retry_after_s(), 3),
                         "trace_id": getattr(e, "trace_id", None)}, \
                (fut.trace if fut is not None else None)
        except (ValueError, KeyError) as e:  # bad feed names/shapes
            return 400, {"error": "bad request", "detail": str(e)}, None
        except (RequestFailed, TimeoutError) as e:
            return 500, {"error": "request failed", "detail": str(e)}, \
                (fut.trace if fut is not None else None)
        trace = fut.trace
        return 200, {
            "outputs": [o.tolist() for o in outputs],
            "shapes": [list(o.shape) for o in outputs],
            "names": self.engine._base.get_output_names(),
            "ms": round((time.monotonic() - t0) * 1e3, 3),
            "trace_id": (trace or {}).get("trace_id"),
        }, trace

    def _swap(self, body: bytes, hop_trace: Optional[str] = None):
        """One ``POST /swap`` — the control-plane half of a safe
        rollout.  The engine does all the real work (validate →
        quiesce → commit-or-rollback); this handler only maps its
        error taxonomy onto HTTP: structural drift → **409** (the
        replica refused at admission, nothing flipped — the fleet
        supervisor falls back to a restart), drain / a concurrent
        swap / a quiesce timeout → **503** (the old weights keep
        serving; retry later), anything past validation → **500**
        (committed arrays were rolled back)."""
        from ..inference import SwapMismatch
        try:
            doc = json.loads(body or b"{}")
            revert = bool(doc.get("revert"))
            ckpt_dir = doc.get("dir")
            target = doc.get("target", "predict")
            timeout_s = doc.get("timeout_s")
            if not revert and not isinstance(ckpt_dir, str):
                raise TypeError("'dir' (checkpoint directory) required "
                                "unless 'revert' is true")
            if target not in ("predict", "generate"):
                raise ValueError(f"unknown swap target {target!r}")
        except (KeyError, TypeError, ValueError) as e:
            return 400, {"error": "bad request",
                         "detail": f"{type(e).__name__}: {e}"}, None
        eng = self.engine
        if target == "generate":
            eng = getattr(self.engine, "generator", None)
            if eng is None:
                return 404, {"error": "not found",
                             "detail": "no generation engine "
                                       "attached"}, None
        kw = {} if timeout_s is None else {"timeout_s": float(timeout_s)}
        try:
            if revert:
                res = eng.revert_weights(**({} if target == "generate"
                                            else kw))
            else:
                res = eng.swap_weights(ckpt_dir, **kw)
        except SwapMismatch as e:
            return 409, {"error": "swap_mismatch", "detail": str(e),
                         "trace_id": hop_trace}, None
        except OverloadedError as e:
            return 503, {"error": "overloaded", "reason": e.reason,
                         "detail": str(e),
                         "retry_after_s": round(
                             self.engine.retry_after_s(), 3),
                         "trace_id": hop_trace}, None
        except Exception as e:  # noqa: BLE001 — commit failure (rolled
            # back); the replica still serves the old weights
            logger.warning("/swap failed (rolled back): %s", e)
            return 500, {"error": "swap failed",
                         "detail": f"{type(e).__name__}: {e}",
                         "trace_id": hop_trace}, None
        res = dict(res)
        res["target"] = target
        res["trace_id"] = hop_trace
        return 200, res, None


class ServingServer:
    """Own the listener + its serve_forever thread.

    ``port=0`` binds an ephemeral port (read it back from ``.port``).
    ``close(drain=True)`` drains the engine before stopping the
    listener, so in-flight HTTP requests complete with real answers.
    """

    def __init__(self, engine: ServingEngine, host: str = "127.0.0.1",
                 port: int = 0, request_timeout_s: Optional[float] = 30.0):
        self.engine = engine
        self.access_log = _AccessLog()
        handler = type("BoundHandler", (_Handler,),
                       {"engine": engine,
                        "request_timeout_s": request_timeout_s,
                        "access_log": self.access_log})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None
        self._closed = False

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "ServingServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, kwargs={"poll_interval": 0.1},
                name="serving-http", daemon=True)
            self._thread.start()
        return self

    def install_sigterm(self):
        """SIGTERM → stop admissions, flush in-flight batches, stop the
        listener, exit clean (the engine handler does the drain; the
        server shutdown rides the same background thread)."""
        self.engine.install_sigterm()
        inner = self.engine._on_sigterm

        def _handler(signum, frame):
            inner(signum, frame)
            threading.Thread(target=self._stop_listener,
                             name="serving-http-stop", daemon=True).start()

        import signal
        try:
            signal.signal(signal.SIGTERM, _handler)
        except ValueError:
            from ..monitor import stat_add
            stat_add("serving_no_sigterm")

    def _stop_listener(self):
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except OSError as e:
            logger.warning("serving listener shutdown: %s", e)

    def close(self, drain: bool = True, timeout: Optional[float] = None):
        if self._closed:
            return
        self._closed = True
        self.engine.close(drain=drain, timeout=timeout)
        self._stop_listener()
        if self._thread is not None:
            self._thread.join(timeout)
        self.access_log.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False


def serve(engine: ServingEngine, host: str = "127.0.0.1",
          port: int = 0, **kw) -> ServingServer:
    """Create + start a :class:`ServingServer` on ``engine``."""
    return ServingServer(engine, host, port, **kw).start()
