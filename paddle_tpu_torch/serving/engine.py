"""Serving engine: dynamic-batching scheduler over a pool of predictors.

The port's counterpart of ``paddle_tpu/serving/engine.py``.  It turns
one :class:`~paddle_tpu_torch.inference.Predictor` into a trafficable
engine:

* **Predictor pool** — ``workers`` ``clone()``d predictors share the
  weight tensors (nothing copied); each owns a dispatch thread, a cache
  of compiled steps of its own (its own CUDA graphs, pools and feed
  buffers: a graph replays one run at a time) and, on the card, a
  ``torch.cuda.Stream`` of its own that every dispatch of its thread
  runs on, so the workers' replays and their blocking fetch copies
  overlap instead of serialising on one stream.  A pooled clone keeps
  at least as many compiled steps as the engine warms (its
  ``max_cached`` is raised to the warmed signatures where they exceed
  ``MAX_CACHED_STEPS``), so no warm graph is evicted and recaptured on
  the request path.
* **Dynamic micro-batching** — requests queue centrally; a worker pops
  the head, gathers same-signature requests until the batch reaches
  ``FLAGS_serving_max_batch`` rows or ``FLAGS_serving_max_delay_ms``
  elapses, pads up to the shape bucket
  (:mod:`paddle_tpu_torch.serving.batcher`) and dispatches one compiled call.
  Results split bit-exactly back to the per-request futures.
* **Warm-up** — every bucket of every declared signature is built and,
  on the card, captured on every worker at startup
  (``Predictor.warmup``), so no caller ever pays a build or a capture.
  Captures run one at a time in the process, so warmup takes workers x
  buckets captures in turn.
* **Admission control** — the queue is bounded
  (``FLAGS_serving_queue_cap``); a full queue sheds at ``submit()``
  with an explicit :class:`OverloadedError` (reason ``queue_full``),
  and requests that sat queued past ``FLAGS_serving_deadline_ms`` are
  shed when picked up (reason ``deadline``) — overload degrades into
  explicit errors with bounded latency, never unbounded queueing.
* **Graceful drain** — ``close(drain=True)`` (or SIGTERM via
  :meth:`ServingEngine.install_sigterm`, mirroring ``TrainGuard``)
  stops admissions, flushes every in-flight and queued request, joins
  the workers, and leaves the process clean.

* **Request-scoped tracing** — every request is ONE trace: a
  ``serving/request`` root span opened at admission and closed at
  respond, with ``serving/admit``, ``serving/queue_wait`` (ended on the
  dispatch thread — the span crosses the queue hop under the same
  trace_id), ``serving/predict`` and ``serving/respond`` children; the
  shared ``serving/batch`` span carries fan-in ``links`` to the N
  request traces it serves.  Head sampling (``FLAGS_trace_sample``,
  deterministic every-Nth) bounds overhead; the slowest
  ``FLAGS_trace_tail_keep`` requests are ALWAYS captured (phase-timing
  records, full span trees when also head-sampled) — :meth:`tracez`
  feeds the HTTP ``/tracez`` endpoint.  Latency histograms record the
  request's trace_id as an exemplar, so a bad p99 points at a trace.

* **Poison-request bisection** — when a multi-request batch raises,
  the engine does not fail every rider: it recursively splits the
  batch in half and retries each half, isolating exactly the
  poisoned request(s) (:class:`PoisonedInput`, a kernel crash, an
  injected fault) while every other request in the batch is served
  **bit-exact** (sub-batches pad to their own bucket; bucket size
  never changes a row's result — the standing ``np.array_equal``
  serving invariant).  Cost is bounded: at most ``log2(batch)+1``
  re-dispatches of the original row count.  ``FLAGS_serving_bisect=0``
  restores fail-the-whole-batch.

* **In-place weight hot-swap** — :meth:`swap_weights` admits a
  structurally-identical checkpoint (shape/dtype drift rejected with
  :class:`~paddle_tpu_torch.inference.SwapMismatch` before anything flips),
  quiesces dispatch at a drained-batch boundary (requests keep
  queueing — a swap pauses, it never sheds), flips every pooled
  predictor's weights under the SAME compiled steps (the contents are
  exchanged in place, every ``data_ptr`` kept: a captured graph reads
  its weights at fixed addresses, so nothing is recaptured) and bumps
  the published ``weights_version``.  A failed commit rolls back — the
  engine never serves a torn mix of versions — and
  :meth:`revert_weights` exchanges the previous weights back from the
  buffers the swap left them in (the canary auto-revert path).

* **End-to-end deadlines** — ``submit(deadline_ms=...)`` adopts a
  caller-propagated remaining budget (the HTTP front end reads it
  from the ``X-PaddleTPU-Deadline-Ms`` header the fleet router mints
  / decrements): the engine deadline tightens to it, and a request
  whose budget is already spent sheds at the queue (reason
  ``deadline``) instead of burning a batch slot.

* **Stuck-worker watchdog** — a dispatch worker wedged inside a batch
  longer than ``FLAGS_serving_worker_stuck_ms`` reports status
  ``stuck`` (+ live ``stuck_ms``) in :meth:`worker_health`, degrading
  the engine-level ``/healthz`` status so the fleet router stops
  preferring the replica — a hang is visible even though the thread
  cannot be killed in-process.

Fault sites (``paddle_tpu_torch/fault.py``): ``serve_request`` (kinds
``shed`` — forced admission shed — and ``fail`` — admission error) and
``serve_batch`` (``fail`` — the batch execution raises; only the
isolated request(s) error, the engine keeps serving — plus
``delay:ms`` / ``hang`` slow faults that stall the worker at the
dispatch point, which is what the stuck watchdog surfaces).

Stats (README catalog): counters ``serving_requests``,
``serving_requests_shed``, ``requests_shed_deadline`` (the subset of
sheds whose budget ran out — admission or pickup), ``serving_batches``,
``serving_batch_exact_bucket``, ``serving_batch_failures``,
``serving_batch_bisections`` (failed multi-request batches that
entered split-and-retry), ``serving_poison_rows`` (rows of requests a
bisection isolated as the poison), ``serving_pad_rows``,
``serving_no_sigterm``; gauges
``serving_queue_depth`` (refreshed at every enqueue AND dequeue),
``serving_queue_depth_peak`` (high watermark — bursty peaks that a
publish-time sample misses), ``serving_bucket_hit_rate``; histograms
``serving_request_ms``, ``serving_queue_wait_ms``,
``serving_batch_fill_pct``.

Not ported yet: mesh-placed pools (``ReplicaGroupEngine``'s sharded
predictors and their ``_sharded`` counters, ROADMAP.md queue 1 item 9)
and the embedding tier's duck-typed predictors (item 8).
"""
from __future__ import annotations

import collections
import logging
import math
import os
import signal
import threading
import time
from typing import List, Optional

import numpy as np

from .. import blackbox
from .. import fault
from .. import observatory
from .. import telemetry
from .. import tsdb
from ..flags import flag_value
from ..monitor import process_start_time, stat_add
from . import batcher
from . import usage

__all__ = ["ServingError", "OverloadedError", "RequestFailed",
           "PoisonedInput", "ServingFuture", "ServingEngine"]

logger = logging.getLogger("paddle_tpu_torch.serving")

FILL_BUCKETS = tuple(float(x) for x in range(5, 101, 5))


class ServingError(RuntimeError):
    """Base class for request-level serving failures."""


class OverloadedError(ServingError):
    """Explicit shed: the engine refused (or dropped) the request rather
    than queue unbounded latency.  ``reason`` is one of ``queue_full``,
    ``deadline``, ``draining``, ``injected`` — plus the weight-swap
    refusals ``swap_busy`` (another swap is mid-flight) and
    ``swap_timeout`` (the quiesce never reached a drained-batch
    boundary inside ``FLAGS_swap_timeout_s``)."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"serving overloaded ({reason})"
                         + (f": {detail}" if detail else ""))
        self.reason = reason


class RequestFailed(ServingError):
    """The step this request rode in raised during execution."""


class PoisonedInput(RuntimeError):
    """A request contained a feed value equal to the
    ``FLAGS_serving_poison_value`` sentinel — the deterministic stand-in
    for an input that crashes the model.  Deliberately NOT a
    ServingError: it surfaces to the engine exactly like a real
    execution crash and is contained by the same path."""


def poison_sentinel_matches(a: np.ndarray, v: float) -> bool:
    """True when array ``a`` contains the poison sentinel ``v`` exactly.
    A sentinel unrepresentable in the array's dtype (OverflowError) or
    saturating there (float16 casts 1e30 to inf) never matches, so a
    legitimate inf/extreme value cannot be misclassified as poison."""
    try:
        target = a.dtype.type(v)
    except (OverflowError, ValueError):
        return False
    if np.isfinite(v) and not np.isfinite(target):
        return False
    return bool(np.any(a == target))


class ServingFuture:
    """Completion handle returned by ``submit``.  After resolution,
    ``trace`` holds the request's trace record (trace_id, status, phase
    latencies, the span tree when head-sampled; None with telemetry off
    or from the generation engine): the HTTP front end writes it into
    the access log."""

    __slots__ = ("_event", "_outputs", "_error", "trace")

    def __init__(self):
        self._event = threading.Event()
        self._outputs = None
        self._error: Optional[Exception] = None
        self.trace: Optional[dict] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        """Block for the outputs; raises the request's error
        (OverloadedError / RequestFailed) if it was shed or failed."""
        if not self._event.wait(timeout):
            raise TimeoutError("serving request still pending")
        if self._error is not None:
            raise self._error
        return self._outputs

    def exception(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("serving request still pending")
        return self._error

    def _resolve(self, outputs=None, error=None):
        self._outputs, self._error = outputs, error
        self._event.set()


def _worker_stream(device):
    """A dispatch thread's own stream: on the card every dispatch of the
    thread (feed copies, replays, the blocking fetch copy) runs on a
    ``torch.cuda.Stream`` of its own, so two workers overlap instead of
    serialising on one stream; on the CPU nothing."""
    import contextlib

    import torch

    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.stream(torch.cuda.Stream(device))


class _Request:
    __slots__ = ("arrays", "rows", "sig", "future", "t_submit",
                 "t_picked", "t_deadline", "trace_id", "sampled",
                 "root", "spans", "bb", "tenant")

    def __init__(self, arrays: List[np.ndarray]):
        self.arrays = arrays
        self.rows = int(arrays[0].shape[0])
        self.sig = batcher.signature_of(arrays)
        self.future = ServingFuture()
        self.t_submit = time.monotonic()
        self.t_picked: Optional[float] = None
        self.t_deadline: float = float("inf")  # set at admission
        # trace identity: stamped by ServingEngine._trace_begin (None
        # with telemetry off); `root` is the serving/request span when
        # head-sampled, `spans` every span opened for this request
        self.trace_id: Optional[str] = None
        self.sampled = False
        self.root = None
        self.spans: List = []
        # flight-recorder last-words token (None when blackbox is off
        # or the in-flight cap is reached)
        self.bb: Optional[int] = None
        # usage-ledger tenant key (None with FLAGS_usage=0: the ledger
        # does zero per-request work, including this attribution)
        self.tenant: Optional[str] = None


class ServingEngine:
    """Batching scheduler + predictor pool + admission control.

    ``predictor`` is a :class:`~paddle_tpu_torch.inference.Predictor`
    (or a ``save_inference_model`` directory, loaded onto the card).
    ``warmup_shapes`` — one ``{feed_name: per_row_shape}`` dict (or a
    list of them) naming the per-example shapes to build and capture at
    every bucket on every worker; omit it to build lazily on first use
    instead.  Each worker gets a clone of its own.

    In-process API: :meth:`submit` (future) / :meth:`predict`
    (blocking) — tests drive the engine without sockets; the HTTP front
    end (:mod:`paddle_tpu_torch.serving.server`) is a thin JSON veneer
    over the same calls.
    """

    def __init__(self, predictor, workers: Optional[int] = None,
                 max_batch: Optional[int] = None,
                 max_delay_ms: Optional[float] = None,
                 queue_cap: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 warmup_shapes=None, autostart: bool = True):
        from ..inference import Predictor

        if not isinstance(predictor, Predictor):
            # a save_inference_model dir gets wrapped
            predictor = Predictor(predictor)
        self._base = predictor
        self.workers = int(workers if workers is not None
                           else flag_value("FLAGS_serving_workers") or 1)
        self.max_batch = int(max_batch if max_batch is not None
                             else flag_value("FLAGS_serving_max_batch"))
        self.buckets = batcher.bucket_sizes(self.max_batch)
        delay = (max_delay_ms if max_delay_ms is not None
                 else flag_value("FLAGS_serving_max_delay_ms"))
        self._max_delay_s = float(delay) / 1e3
        self.queue_cap = int(queue_cap if queue_cap is not None
                             else flag_value("FLAGS_serving_queue_cap"))
        dl = (deadline_ms if deadline_ms is not None
              else flag_value("FLAGS_serving_deadline_ms"))
        self._deadline_s = float(dl) / 1e3
        if self.workers < 1:
            raise ValueError("ServingEngine needs at least one worker")

        self._queue: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._draining = False
        self._closed = False
        self._started = time.time()
        self._threads: List[threading.Thread] = []
        # a clone a worker, so two workers replay the same bucket at
        # once, each on its own graph
        self._pool = [predictor.clone() for _ in range(self.workers)]

        # per-worker health: last-batch status, consecutive failure
        # streak.  Mutated under _n_lock.
        self._health = [{"worker": i, "batches": 0, "failures": 0,
                         "consecutive_failures": 0,
                         "in_flight_rows": 0, "rows_total": 0,
                         "busy_since": None, "last_batch": None}
                        for i in range(self.workers)]
        # per-worker batch-latency histograms (engine-local, like
        # _h_request): per replica GROUP p50/p99 for worker_health —
        # a slow shard set shows up HERE, not averaged away engine-wide
        self._h_worker = [telemetry.Histogram("serving_group_predict_ms")
                          for _ in range(self.workers)]

        # engine-local tallies (isolated from the process-global monitor,
        # which other subsystems and tests also bump) + mirrored global
        # telemetry so the exporters see serving alongside training
        # requests = every validated submit() (admitted OR shed);
        # served = requests completed with real outputs; shed covers
        # both admission sheds and deadline sheds, so at quiescence
        # requests == served + shed + batch-failed (+ injected
        # serve_request:fail admission errors)
        self._n = {"requests": 0, "served": 0, "shed": 0, "batches": 0,
                   "exact_bucket": 0, "batch_failures": 0, "pad_rows": 0,
                   "sampled": 0, "shed_deadline": 0, "bisections": 0,
                   "poison_rows": 0, "weight_swaps": 0,
                   "weight_swap_failures": 0}
        self._n_lock = threading.Lock()
        # per-(predictor, bucket) manifest-flops cache for usage
        # attribution: cache_info() walks the compile cache, so its
        # price is paid once per bucket, not per batch (_n_lock-guarded)
        self._usage_flops: dict = {}
        self._h_request = telemetry.Histogram("serving_request_ms")
        self._h_wait = telemetry.Histogram("serving_queue_wait_ms")
        self._h_fill = telemetry.Histogram("serving_batch_fill_pct",
                                           buckets=FILL_BUCKETS)
        # pre-register the global fill histogram with percent buckets —
        # a lazy first histogram_observe would get millisecond buckets
        telemetry.metrics.histogram("serving_batch_fill_pct",
                                    buckets=FILL_BUCKETS)
        # cached gauge handles: the queue-depth gauges update on EVERY
        # enqueue and dequeue, so the registry round-trip is paid once
        # here, not per request
        self._g_depth = telemetry.metrics.gauge("serving_queue_depth")
        self._g_peak = telemetry.metrics.gauge("serving_queue_depth_peak")
        self._peak_depth = 0  # engine-local high watermark (cv-guarded)

        # in-place weight hot-swap state: the published version starts
        # at 1 (the spawn checkpoint) and bumps on every successful
        # swap/revert.  _paused holds worker dispatch at the drained-
        # batch boundary while a swap quiesces + commits (submits keep
        # queueing — a swap pauses, it never sheds); _dispatching
        # counts batches from pickup (under _cv, inside _next_batch)
        # to completion, so the quiesce wait has no pickup-to-run
        # blind spot the per-worker in_flight_rows bookkeeping leaves.
        self.weights_version = 1
        self._swap_lock = threading.Lock()
        self._paused = False
        self._dispatching = 0

        # request-trace store for /tracez: a ring of recent head-sampled
        # traces + the slowest-N tail (kept regardless of sampling)
        self._sample_seq = 0
        self._trace_lock = threading.Lock()
        self._tracez_recent: collections.deque = collections.deque(
            maxlen=max(1, int(flag_value("FLAGS_tracez_recent") or 32)))
        self._tail_keep = max(0, int(flag_value("FLAGS_trace_tail_keep")
                                     or 0))
        self._tracez_slow: List[dict] = []

        self._sigterm_installed = False
        self._prev_sigterm = None
        self._hbm_sampling = False
        # optional slot-based generation scheduler (attach_generator):
        # generation requests route to it, the one-shot path is untouched
        self.generator = None

        if warmup_shapes is not None:
            self.warmup(warmup_shapes)
        if autostart:
            self.start()
        # HBM timeline: the engine holds the process-wide sampler open
        # for its lifetime (refcounted; a co-resident TrainGuard shares
        # the same thread).  Acquired LAST: a constructor that dies in
        # warmup must not leak a refcount close() can never release.
        self._hbm_sampling = observatory.start_hbm_sampler()

    # -- lifecycle ----------------------------------------------------------
    def warmup(self, warmup_shapes) -> int:
        """Build and, on the card, capture every bucket of every given
        per-row signature on every worker (so the first real request of
        any admissible batch size hits a warm graph).  A pooled clone's
        ``max_cached`` is raised to the signatures warmed where they
        exceed it, so none of them is evicted later.  Returns the
        signatures built now."""
        if isinstance(warmup_shapes, dict):
            warmup_shapes = [warmup_shapes]
        sigs = []
        for shapes in warmup_shapes:
            for b in self.buckets:
                sigs.append({n: (b,) + tuple(s)
                             for n, s in shapes.items()})
        compiled = 0
        with telemetry.trace_span("serving/warmup", buckets=len(sigs)):
            for p in self._pool:
                p.max_cached = max(p.max_cached, len(sigs))
                compiled += p.warmup(sigs)
        return compiled

    def ready(self) -> bool:
        """Routable: accepting requests (not draining, not closed).
        Surfaces as the ``ready`` field in ``/healthz``."""
        with self._cv:  # _draining/_closed are written under _cv
            return not (self._draining or self._closed)

    def start(self):
        if self._threads:
            return
        for i, p in enumerate(self._pool):
            t = threading.Thread(target=self._worker_loop, args=(i, p),
                                 name=f"serving-worker-{i}", daemon=True)
            t.start()
            self._threads.append(t)

    def install_sigterm(self):
        """SIGTERM → graceful drain (mirrors TrainGuard): stop accepting,
        flush in-flight batches, exit clean.  Main-thread only; elsewhere
        the launcher's restart path applies (``serving_no_sigterm``)."""
        try:
            self._prev_sigterm = signal.signal(signal.SIGTERM,
                                               self._on_sigterm)
            self._sigterm_installed = True
        except ValueError:
            stat_add("serving_no_sigterm")

    def _on_sigterm(self, signum, frame):
        stat_add("sigterm_received")
        telemetry.log_event("serving_sigterm", pid=os.getpid())
        # a signal handler must not block on worker joins: flip the drain
        # flag here (submit() rejects from this instant) and finish the
        # flush+join off the handler
        threading.Thread(target=self.close, kwargs={"drain": True},
                         name="serving-drain", daemon=True).start()

    def drain(self, timeout: Optional[float] = None):
        """Stop accepting and wait until queued + in-flight work flushed
        (workers exit once the queue is empty)."""
        with self._cv:
            self._draining = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout)

    def close(self, drain: bool = True, timeout: Optional[float] = None):
        """Shut the engine down.  ``drain=True`` serves out everything
        already admitted first; ``drain=False`` sheds the queue
        immediately (in-flight batches still finish).  Once the workers
        are gone the pool's clones close (their CUDA graphs and pools
        are freed) and an attached generator closes too."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._draining = True
            shed = []
            if not drain:
                shed, self._queue = list(self._queue), collections.deque()
            self._cv.notify_all()
        for req in shed:
            self._shed(req, "draining")
        for t in self._threads:
            t.join(timeout)
        if not any(t.is_alive() for t in self._threads):
            # the pool's clones are the engine's own: free their graphs
            # and memory pools (the base predictor keeps its own)
            for p in self._pool:
                p.close()
        if self.generator is not None:
            self.generator.close(drain=drain, timeout=timeout)
        if self._sigterm_installed:
            try:
                signal.signal(signal.SIGTERM,
                              self._prev_sigterm or signal.SIG_DFL)
            except ValueError:
                pass  # ok: restoring from a non-main thread (drain thread)
            self._sigterm_installed = False
        if self._hbm_sampling:
            self._hbm_sampling = False
            observatory.stop_hbm_sampler()
        with self._n_lock:
            served, shed_n = self._n["served"], self._n["shed"]
        telemetry.log_event("serving_drained", served=served, shed=shed_n)
        telemetry.flush()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False

    # -- request admission --------------------------------------------------
    def _feed_dtypes(self) -> List:
        dts = getattr(self, "_feed_dtypes_cache", None)
        if dts is None:
            from ..framework.core import dtype_to_np
            dts = self._feed_dtypes_cache = [
                dtype_to_np(self._base._block.var(n).dtype)
                for n in self._base.feed_names]
        return dts

    def coerce_feed(self, feed) -> List[np.ndarray]:
        """Validate + dtype-cast one request feed (dict name->array or
        list in input order) into the predictor's feed order.  Every
        array must carry a leading batch dim (>= 1 row), equal across
        feeds."""
        names = self._base.feed_names
        if not isinstance(feed, dict):
            feed = dict(zip(names, feed))
        arrays = []
        for n, want in zip(names, self._feed_dtypes()):
            if n not in feed:
                raise ValueError(f"missing feed {n!r}; expected {names}")
            a = np.asarray(feed[n])
            if a.ndim < 1 or a.shape[0] < 1:
                raise ValueError(f"feed {n!r} needs a leading batch dim, "
                                 f"got shape {a.shape}")
            if a.dtype != want:
                a = a.astype(want)
            arrays.append(a)
        rows = {a.shape[0] for a in arrays}
        if len(rows) != 1:
            shapes = {n: a.shape for n, a in zip(names, arrays)}
            raise ValueError(f"feeds disagree on batch dim: {shapes}")
        return arrays

    def submit(self, feed, trace_id: Optional[str] = None,
               deadline_ms: Optional[float] = None,
               tenant: Optional[str] = None) -> ServingFuture:
        """Admit one request (any batch size >= 1).  Returns a
        :class:`ServingFuture`; sheds with :class:`OverloadedError`
        when the queue is full or the engine is draining (the raised
        error carries the request's ``trace_id``).  ``trace_id`` adopts
        an externally-minted trace identity (the router hop forwards
        its ``X-PaddleTPU-Trace`` header here), so one served request
        is ONE trace across both tiers.  ``deadline_ms`` is the
        request's REMAINING end-to-end budget (the
        ``X-PaddleTPU-Deadline-Ms`` header, decremented across hops):
        it tightens the engine deadline, and a budget already spent
        sheds right here (reason ``deadline``) — a hopeless request
        must not burn a batch slot."""
        arrays = self.coerce_feed(feed)
        self._count("requests")
        stat_add("serving_requests")
        if usage.enabled():
            # booked at the SAME site as the global counters above:
            # per-tenant sums stay equal to them at tolerance 0
            tenant = usage.normalize_tenant(tenant)
            usage.ledger().book(tenant, requests=1,
                                tokens_in=int(arrays[0].shape[0]))
        else:
            tenant = None
        kind = fault.fire("serve_request")
        if kind == "fail":
            # stay inside the serving error taxonomy: callers (HTTP
            # handler, loadgen) handle ServingError, not raw OSError
            raise RequestFailed("injected serve_request failure")
        req = _Request(arrays)
        req.tenant = tenant
        budget_s = self._deadline_s
        if deadline_ms is not None:
            budget_s = min(budget_s, float(deadline_ms) / 1e3)
        req.t_deadline = req.t_submit + budget_s
        admit = self._trace_begin(req, trace_id=trace_id)
        if tenant is not None:
            # last words carry the tenant: a crash names its victim
            # traffic in the flight recorder
            req.bb = blackbox.request_begin(req.trace_id, "predict",
                                            rows=req.rows, tenant=tenant)
        else:
            req.bb = blackbox.request_begin(req.trace_id, "predict",
                                            rows=req.rows)
        with self._cv:
            if self._draining:
                raise self._submit_shed(req, admit, "draining")
            if budget_s <= 0:
                raise self._submit_shed(req, admit, "deadline",
                                        "budget exhausted upstream")
            if kind == "shed" or len(self._queue) >= self.queue_cap:
                raise self._submit_shed(
                    req, admit,
                    "injected" if kind == "shed" else "queue_full",
                    f"{len(self._queue)}/{self.queue_cap} queued")
            if req.sampled:
                # the wait span MUST exist before the request becomes
                # visible to workers (the append below): a worker can
                # pick the request up the instant the lock releases,
                # and its span_end must find the span to close
                wait = telemetry.span_begin("serving/queue_wait",
                                            parent=req.root.context(),
                                            detached=True)
                req.spans.append(wait)
            self._queue.append(req)
            depth = len(self._queue)
            if depth > self._peak_depth:
                self._peak_depth = depth
            # notify_all: a single notify can land on a worker holding a
            # partial batch open for a DIFFERENT signature, leaving an
            # idle worker asleep in its poll for up to 50ms
            self._cv.notify_all()
        if telemetry.enabled():
            # enqueue-time depth + high watermark: the peak gauge sees
            # every burst, not just the depth at batch-pickup instants
            self._g_depth.set(depth)
            self._g_peak.set_max(depth)
        telemetry.span_end(admit)
        return req.future

    # -- request-trace bookkeeping ------------------------------------------
    def _head_sample(self) -> bool:
        """Deterministic head sampling: every ~(1/rate)-th validated
        request records a full span tree (evenly spaced, no RNG on the
        admission path; rate>=1 keeps all, <=0 none)."""
        rate = flag_value("FLAGS_trace_sample")
        try:
            rate = float(rate if rate is not None else 0.0)
        except (TypeError, ValueError):
            rate = 0.0
        if rate <= 0.0:
            return False
        if rate >= 1.0:
            return True
        with self._n_lock:
            self._sample_seq += 1
            n = self._sample_seq
        return math.floor(n * rate) > math.floor((n - 1) * rate)

    def _trace_begin(self, req: _Request,
                     trace_id: Optional[str] = None):
        """Stamp the request's trace identity and (when head-sampled)
        open the ``serving/request`` root + ``serving/admit`` child.
        ``trace_id`` (when the caller carried one in — the router hop)
        is adopted instead of minting fresh, sampled or not.  Returns
        the admit span (None unsampled/disabled).  Constant time with
        telemetry off: one enabled() check, nothing else."""
        if not telemetry.enabled():
            return None
        if self._head_sample():
            req.sampled = True
            self._count("sampled")
            req.root = telemetry.span_begin("serving/request",
                                            detached=True, rows=req.rows,
                                            trace_id=trace_id)
            req.trace_id = req.root.trace_id
            admit = telemetry.span_begin("serving/admit",
                                         parent=req.root.context(),
                                         detached=True)
            req.spans += [req.root, admit]
            return admit
        # unsampled requests still get an identity: the access log and
        # histogram exemplars must be able to name ANY request
        req.trace_id = trace_id or telemetry.new_trace_id()
        return None

    def _wait_span_of(self, req: _Request):
        for s in req.spans:
            if s.name == "serving/queue_wait":
                return s
        return None

    def _trace_finish(self, req: _Request, status: str,
                      predict_ms: Optional[float] = None
                      ) -> Optional[dict]:
        """Build the request's trace record, feed the /tracez store
        (recent ring if sampled; slowest-N tail regardless), and return
        it.  Called after the request's spans are closed."""
        if req.bb is not None:
            # the request responded (ok, failed, or shed) — its last
            # words leave the flight recorder with it
            blackbox.request_end(req.bb)
            req.bb = None
        if req.trace_id is None:
            return None
        now = time.monotonic()
        total_ms = (now - req.t_submit) * 1e3
        wait_ms = ((req.t_picked or now) - req.t_submit) * 1e3
        rec = {
            "trace_id": req.trace_id,
            "ts": round(time.time() - total_ms / 1e3, 6),
            "status": status,
            "rows": req.rows,
            "sampled": req.sampled,
            "duration_ms": round(total_ms, 3),
            "phases": {
                "queue_wait_ms": round(wait_ms, 3),
                "predict_ms": None if predict_ms is None
                else round(predict_ms, 3),
            },
        }
        if req.sampled and req.root is not None:
            rec["spans"] = [s.to_tracez(t0=req.root.start)
                            for s in req.spans]
        with self._trace_lock:
            if req.sampled:
                self._tracez_recent.append(rec)
            if self._tail_keep:
                slow = self._tracez_slow
                slow.append(rec)
                slow.sort(key=lambda r: -r["duration_ms"])
                del slow[self._tail_keep:]
        return rec

    def _submit_shed(self, req: _Request, admit, reason: str,
                     detail: str = "") -> OverloadedError:
        """Book an admission-time shed and build the error to raise
        (spans closed, trace recorded, trace_id attached)."""
        self._count("shed")
        stat_add("serving_requests_shed")
        if req.tenant is not None and usage.enabled():
            usage.ledger().book(req.tenant, sheds=1)
        if reason == "deadline":
            self._count("shed_deadline")
            stat_add("requests_shed_deadline")
        telemetry.span_end(admit)
        if req.root is not None:
            req.root.attrs["status"] = "shed:" + reason
            telemetry.span_end(req.root)
        self._trace_finish(req, "shed:" + reason)
        err = OverloadedError(reason, detail)
        err.trace_id = req.trace_id
        return err

    def predict(self, feed, timeout: Optional[float] = None):
        """Blocking one-shot: ``submit(feed).result(timeout)``."""
        return self.submit(feed).result(timeout)

    # -- in-place weight hot-swap -------------------------------------------
    @staticmethod
    def _load_swap_checkpoint(checkpoint) -> dict:
        """Checkpoint dir -> ``{name: array}``, loaded once for the
        whole pool; an in-memory dict passes through untouched."""
        if isinstance(checkpoint, dict):
            return dict(checkpoint)
        from .. import io
        from ..inference import SwapMismatch
        path = os.path.join(str(checkpoint), "__params__")
        if not os.path.exists(path):
            raise SwapMismatch(
                f"swap checkpoint {str(checkpoint)!r} has no __params__")
        return io._read(path)

    def swap_weights(self, checkpoint, *,
                     timeout_s: Optional[float] = None) -> dict:
        """Hot-swap the pool's weights in place: the compiled steps (and
        their CUDA graphs) outlive the weights.

        ``checkpoint`` is a ``save_inference_model`` directory (or an
        in-memory ``{name: array or tensor}`` dict, whose buffers end up
        holding the old weights: see ``Predictor.swap_weights``).  The new arrays are
        validated against the live weight structure FIRST — any
        shape/dtype/missing-name drift raises
        :class:`~paddle_tpu_torch.inference.SwapMismatch` (HTTP ``/swap``
        maps it to 409) before a single array flips, exactly the
        admission discipline ``KVSegment`` adoption uses.  Then worker
        dispatch pauses, the quiesce waits for every in-flight batch
        to complete (bounded by ``FLAGS_swap_timeout_s`` — on timeout
        the engine keeps serving the OLD weights), and every distinct
        predictor commits the new values under its compiled steps, in
        place (every ``data_ptr`` kept, nothing recaptured).  Success
        bumps the published ``weights_version``; any commit failure
        rolls back to the old arrays — a torn mix of versions is never
        served.  Queued requests ride through untouched: a swap
        pauses, it never sheds."""
        if timeout_s is None:
            timeout_s = float(flag_value("FLAGS_swap_timeout_s") or 30.0)
        arrays = self._load_swap_checkpoint(checkpoint)
        return self._swap_apply(lambda p: p.swap_weights(arrays),
                                timeout_s, "swap")

    def revert_weights(self, *,
                       timeout_s: Optional[float] = None) -> dict:
        """Instantly restore the weights replaced by the last
        successful :meth:`swap_weights` from the retained device
        arrays — no checkpoint round-trip (the canary auto-revert
        path).  Same quiesce + version-bump discipline as a forward
        swap; :class:`~paddle_tpu_torch.inference.SwapMismatch` when there
        is nothing to revert to."""
        if timeout_s is None:
            timeout_s = float(flag_value("FLAGS_swap_timeout_s") or 30.0)
        return self._swap_apply(lambda p: p.revert_weights(),
                                timeout_s, "revert")

    def _swap_apply(self, apply_fn, timeout_s: float, what: str) -> dict:
        """Shared swap/revert machinery: serialize (``swap_busy``),
        refuse during drain (``draining``), pause dispatch, quiesce to
        the drained-batch boundary (``swap_timeout``), apply across
        the pool, bump + publish the version."""
        t0 = time.monotonic()
        if not self._swap_lock.acquire(timeout=timeout_s):
            raise OverloadedError("swap_busy",
                                  "another weight swap is mid-flight")
        try:
            with self._cv:
                if self._draining or self._closed:
                    raise OverloadedError("draining",
                                          "no weight swap during drain")
                self._paused = True
                self._cv.notify_all()
            try:
                deadline = t0 + timeout_s
                with self._cv:
                    while self._dispatching > 0:
                        left = deadline - time.monotonic()
                        if left <= 0:
                            raise OverloadedError(
                                "swap_timeout",
                                f"{self._dispatching} batch(es) still "
                                f"in flight after {timeout_s}s quiesce")
                        self._cv.wait(min(left, 0.05))
                self._swap_pool(apply_fn)
            finally:
                with self._cv:
                    self._paused = False
                    self._cv.notify_all()
            with self._n_lock:
                self.weights_version += 1
                self._n["weight_swaps"] += 1
                version = self.weights_version
            stat_add("serving_weight_swaps")
            telemetry.gauge_set("serving_weights_version", version)
            ms = round((time.monotonic() - t0) * 1e3, 3)
            telemetry.log_event("serving_weight_swap", op=what,
                                version=version, swap_ms=ms)
            logger.info("weight %s committed: version=%d in %.1fms",
                        what, version, ms)
            return {"weights_version": version, "swap_ms": ms}
        except OverloadedError:
            raise  # a refusal (busy/draining/timeout) is not a failure
        except BaseException:
            self._count("weight_swap_failures")
            stat_add("serving_weight_swap_failures")
            raise
        finally:
            self._swap_lock.release()

    def _swap_pool(self, apply_fn):
        """Apply one weight flip to every distinct scope of the pool (plus
        the base): the clones share the base's scope, so one in-place
        exchange swaps them all.  ``Predictor.swap_weights`` is atomic:
        a failure has been rolled back when it raises."""
        swapped = set()
        for p in self._pool + [self._base]:
            if id(p.scope) not in swapped:
                apply_fn(p)
                swapped.add(id(p.scope))

    # -- generation routing -------------------------------------------------
    def attach_generator(self, generator) -> "ServingEngine":
        """Attach a :class:`~paddle_tpu_torch.serving.generation.
        GenerationEngine`: generation requests (``submit_generate`` /
        HTTP ``POST /generate``) route to its slot scheduler while the
        one-shot ``/predict`` path stays untouched.  The generator
        drains and closes with the engine."""
        self.generator = generator
        return self

    def submit_generate(self, prompt, max_new_tokens=None,
                        trace_id=None, deadline_ms=None,
                        on_token=None, timeline=None, speculate=None,
                        tenant=None):
        """Admit one generation request to the attached slot scheduler
        (future of the generation record); raises RuntimeError when no
        generator is attached.  ``on_token``/``timeline``/``speculate``
        pass through to :meth:`GenerationEngine.submit` (per-token
        streaming callback, the per-sequence timeline switch, and the
        per-request speculative-decoding override)."""
        if self.generator is None:
            raise RuntimeError("no GenerationEngine attached; call "
                               "attach_generator() first")
        return self.generator.submit(prompt,
                                     max_new_tokens=max_new_tokens,
                                     trace_id=trace_id,
                                     deadline_ms=deadline_ms,
                                     on_token=on_token,
                                     timeline=timeline,
                                     speculate=speculate,
                                     tenant=tenant)

    # -- scheduler ----------------------------------------------------------
    def _count(self, key: str, n: int = 1):
        with self._n_lock:
            self._n[key] += n

    def _shed(self, req: _Request, reason: str):
        self._count("shed")
        stat_add("serving_requests_shed")
        if req.tenant is not None and usage.enabled():
            usage.ledger().book(req.tenant, sheds=1)
        if reason == "deadline":
            self._count("shed_deadline")
            stat_add("requests_shed_deadline")
        waited_ms = (time.monotonic() - req.t_submit) * 1e3
        telemetry.span_end(self._wait_span_of(req))
        if req.root is not None:
            req.root.attrs["status"] = "shed:" + reason
            telemetry.span_end(req.root)
        err = OverloadedError(reason, f"waited {waited_ms:.1f}ms")
        err.trace_id = req.trace_id
        req.future.trace = self._trace_finish(req, "shed:" + reason)
        req.future._resolve(error=err)

    def _pop_live_locked(self) -> Optional[_Request]:
        """Pop the queue head, shedding any that outlived the deadline
        (bounds p99 admission latency: a request is served fresh or
        refused, never served stale)."""
        now = time.monotonic()
        while self._queue:
            req = self._queue.popleft()
            if now > req.t_deadline:
                self._shed(req, "deadline")
                continue
            return req
        return None

    def _gather_locked(self, sig, max_rows: int) -> List[_Request]:
        """Pop a FIFO run of head requests matching ``sig`` while they
        fit in ``max_rows`` (deadline-shedding stale heads as they are
        encountered).  Strict head-of-line order keeps this O(batch) —
        a standing queue under load must not cost O(queue) per taken
        request."""
        taken: List[_Request] = []
        rows = 0
        now = time.monotonic()
        while self._queue and rows < max_rows:
            req = self._queue[0]
            if now > req.t_deadline:
                self._queue.popleft()
                self._shed(req, "deadline")
                continue
            if req.sig != sig or req.rows > max_rows - rows:
                break
            self._queue.popleft()
            taken.append(req)
            rows += req.rows
        return taken

    def _next_batch(self) -> Optional[List[_Request]]:
        """Block for the next batch: pop a head request, then hold the
        batch open up to max_delay for same-signature followers, up to
        max_batch rows.  Returns None when draining and drained."""
        with self._cv:
            first = None
            while first is None:
                if self._paused:
                    # a weight swap is quiescing/committing: hold at
                    # the drained-batch boundary (requests keep
                    # queueing; the swap's finally unpauses)
                    self._cv.wait(0.05)
                    continue
                first = self._pop_live_locked()
                if first is None:
                    if self._draining:
                        return None
                    self._cv.wait(0.05)
            batch, rows = [first], first.rows
            deadline = time.monotonic() + self._max_delay_s
            while rows < self.max_batch:
                more = self._gather_locked(first.sig,
                                           self.max_batch - rows)
                if more:
                    batch.extend(more)
                    rows += sum(r.rows for r in more)
                    continue
                if self._draining:
                    break
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._cv.wait(left)
            # booked while still holding _cv: the swap quiesce reads
            # _dispatching under the same lock, so a batch is never
            # invisible between pickup and _run_batch's bookkeeping
            self._dispatching += 1
            depth = len(self._queue)
        if telemetry.enabled():
            self._g_depth.set(depth)  # dequeue-time refresh
        now = time.monotonic()
        batch_rows = sum(r.rows for r in batch)
        for req in batch:
            req.t_picked = now
            if req.bb is not None:
                blackbox.request_phase(req.bb, "executing",
                                       batch_rows=batch_rows)
            # the queue_wait span ends HERE, on the dispatch thread —
            # the cross-thread half of the request's trace
            telemetry.span_end(self._wait_span_of(req))
            wait_ms = (now - req.t_submit) * 1e3
            self._h_wait.observe(wait_ms, trace_id=req.trace_id)
            telemetry.histogram_observe("serving_queue_wait_ms", wait_ms,
                                        trace_id=req.trace_id)
        return batch

    def _worker_loop(self, widx, predictor):
        # _run_batch resolves per-request failures into futures; an
        # exception escaping to HERE means the dispatch thread itself
        # is dying — dump the flight recorder before it goes (the
        # re-raise feeds threading.excepthook for the log line)
        try:
            with _worker_stream(predictor.device):
                while True:
                    batch = self._next_batch()
                    if batch is None:
                        return
                    self._run_batch(predictor, batch, widx)
        except BaseException as e:
            blackbox.dump_exception(f"serving_worker_{widx}", e)
            raise

    def _book_worker(self, widx: int, predictor, ok: bool, rows: int,
                     predict_ms: Optional[float] = None):
        """Per-worker health bookkeeping after a batch: tallies and the
        failure streak (one success clears it)."""
        if predict_ms is not None:
            self._h_worker[widx].observe(predict_ms)
        h = self._health[widx]
        with self._n_lock:
            h["batches"] += 1
            h["rows_total"] += rows
            if ok:
                h["consecutive_failures"] = 0
            else:
                h["failures"] += 1
                h["consecutive_failures"] += 1
            h["last_batch"] = {"status": "ok" if ok else "failed",
                               "rows": rows,
                               "ts": round(time.time(), 3)}

    def _poison_check(self, batch: List[_Request]):
        """The deterministic poison-input model (chaos/testing): any
        feed value equal to ``FLAGS_serving_poison_value`` crashes the
        whole dispatch — exactly like a kernel that dies on one bad
        row — and the bisection path isolates it.  Free when the flag
        is unset."""
        pv = flag_value("FLAGS_serving_poison_value")
        if not pv:
            return
        v = float(pv)
        for r in batch:
            for a in r.arrays:
                if poison_sentinel_matches(a, v):
                    raise PoisonedInput(
                        f"batch contains poisoned input (sentinel {pv})")

    def _execute(self, predictor, batch: List[_Request]
                 ) -> List[List[np.ndarray]]:
        """Execute ``batch`` as one padded dispatch (or the chunked
        path for an oversized single request) and return per-request
        output lists.  Raises on any failure — poison, kernel crash —
        WITHOUT touching futures: callers (`_run_batch`, `_bisect`)
        decide containment."""
        self._poison_check(batch)
        rows = sum(r.rows for r in batch)
        bucket = batcher.bucket_for(rows, self.buckets)
        if bucket is None:
            # one oversized request (> largest bucket): chunk it
            # across full batches and reassemble — still bit-exact
            outs = [self._run_chunked(predictor, batch[0])]
            if usage.enabled():
                self._book_usage(predictor, batch, None)
            return outs
        padded, _real = batcher.pad_stack([r.arrays for r in batch],
                                          bucket)
        outs = predictor.run(padded)
        per_req = batcher.split_rows(outs, [r.rows for r in batch])
        self._book_batch(rows, bucket)
        if usage.enabled():
            self._book_usage(predictor, batch, bucket)
        return per_req

    def _book_usage(self, predictor, batch: List[_Request],
                    bucket: Optional[int]):
        """Per-tenant cost capture for one successful dispatch: the
        executable's manifest flops, split across the batch's requests
        row-weighted (largest-remainder: the integer parts sum exactly,
        so conservation holds at tolerance 0)."""
        fl = self._bucket_flops(predictor, bucket) if bucket else 0
        if not fl:
            return
        led = usage.ledger()
        for r, f in zip(batch, usage.split_ints(fl, [r.rows
                                                     for r in batch])):
            if f and r.tenant is not None:
                led.book(r.tenant, flops=f)

    def _bucket_flops(self, predictor, bucket: int) -> int:
        """Manifest flops of the compiled step serving ``bucket`` rows on
        ``predictor`` (costmodel.step_manifest, through cache_info's
        ``costs``; 0 when it has none).  Memoized per (predictor,
        bucket)."""
        key = (id(predictor), bucket)
        with self._n_lock:
            fl = self._usage_flops.get(key)
        if fl is not None:
            return fl
        fl = 0
        info = None
        try:
            info = predictor.cache_info()
            mans = (info or {}).get("costs") or {}
            probe = f"(({bucket},"
            for sig, man in mans.items():
                if man and probe in str(sig):
                    fl = int(man.get("flops") or 0)
                    break
        except Exception:  # noqa: BLE001 — attribution must never
            # fail a dispatch; an unpriceable executable books 0 flops
            return 0
        if info and not info.get("busy"):
            with self._n_lock:
                self._usage_flops[key] = fl
        return fl

    def _resolve_ok(self, req: _Request, outputs, predict_ms: float,
                    now: float):
        rs = None
        if req.root is not None:
            rs = telemetry.span_begin("serving/respond",
                                      parent=req.root.context(),
                                      detached=True)
            req.spans.append(rs)
        ms = (now - req.t_submit) * 1e3
        self._h_request.observe(ms, trace_id=req.trace_id)
        telemetry.histogram_observe("serving_request_ms", ms,
                                    trace_id=req.trace_id)
        if req.tenant is not None and usage.enabled():
            led = usage.ledger()
            led.book(req.tenant, served=1)
            led.observe_latency(req.tenant, ms)
        if telemetry.enabled() and tsdb.enabled():
            # raw per-request latency series: the replica burn-rate
            # monitor's latency evidence must be WINDOWED samples —
            # the histogram's p99 is lifetime-cumulative, and a spec
            # reading it would latch firing long after recovery
            tsdb.default().record("serving_request_ms", ms, cap=4096)
        telemetry.span_end(rs)
        telemetry.span_end(req.root)
        req.future.trace = self._trace_finish(req, "ok", predict_ms)
        req.future._resolve(outputs=outputs)

    def _resolve_failed(self, req: _Request, cause: Exception,
                        predict_ms: float, isolated: bool = False):
        what = "request isolated by bisection" if isolated \
            else "batch execution failed"
        err = RequestFailed(f"{what}: {type(cause).__name__}: {cause}")
        if req.tenant is not None and usage.enabled():
            usage.ledger().book(req.tenant, failures=1)
        if req.root is not None:
            req.root.attrs["status"] = "failed"
            telemetry.span_end(req.root)
        req.future.trace = self._trace_finish(req, "failed", predict_ms)
        req.future._resolve(error=err)

    def _run_batch(self, predictor, batch: List[_Request],
                   widx: int = 0):
        rows = sum(r.rows for r in batch)
        with self._n_lock:
            self._health[widx]["in_flight_rows"] = rows
            # stuck-worker watchdog arm: worker_health() reads the live
            # wall time this worker has been inside the current batch
            self._health[widx]["busy_since"] = time.monotonic()
        bucket = batcher.bucket_for(rows, self.buckets)
        t_run0 = time.monotonic()
        pspans = []
        try:
            kind = fault.fire("serve_batch")
            # delay:ms / hang slow faults stall the worker HERE — the
            # stuck watchdog and the router's forward timeout are what
            # turn the stall into a visible, contained event
            fault.maybe_delay(kind)
            if kind == "fail":
                raise fault.InjectedFault("injected serve_batch failure")
            # the batch span is its own trace (it belongs to no single
            # request); `links` record the fan-in to every sampled
            # request trace riding in it
            links = [r.root.context() for r in batch if r.root is not None]
            with telemetry.trace_span("serving/batch", links=links,
                                      rows=rows, bucket=bucket or rows,
                                      requests=len(batch),
                                      sig=batcher.describe_signature(
                                          batch[0].sig)):
                for r in batch:
                    if r.root is not None:
                        ps = telemetry.span_begin(
                            "serving/predict", parent=r.root.context(),
                            detached=True, rows=r.rows)
                        r.spans.append(ps)
                        pspans.append(ps)
                per_req = self._execute(predictor, batch)
                for ps in pspans:
                    telemetry.span_end(ps)
                pspans = []
            now = time.monotonic()
            predict_ms = (now - t_run0) * 1e3
            self._count("served", len(batch))
            self._book_worker(widx, predictor, True, rows, predict_ms)
            for req, outputs in zip(batch, per_req):
                self._resolve_ok(req, outputs, predict_ms, now)
        except Exception as e:  # noqa: BLE001 — a batch failure must not
            # kill the worker: the poisoned request(s) error (isolated
            # by bisection when the batch had riders), the engine keeps
            # serving (tested via serve_batch:fail@N + the poison
            # fault matrix)
            for ps in pspans:
                telemetry.span_end(ps)
            self._count("batch_failures")
            self._book_worker(widx, predictor, False, rows,
                              (time.monotonic() - t_run0) * 1e3)
            stat_add("serving_batch_failures")
            logger.warning("serving batch of %d request(s) failed: %s",
                           len(batch), e)
            telemetry.log_event("serving_batch_failure", rows=rows,
                               error=f"{type(e).__name__}: {e}")
            predict_ms = (time.monotonic() - t_run0) * 1e3
            if len(batch) > 1 and flag_value("FLAGS_serving_bisect"):
                self._bisect(predictor, batch, widx, e)
            else:
                for req in batch:
                    self._resolve_failed(req, e, predict_ms)
        finally:
            with self._n_lock:
                self._health[widx]["in_flight_rows"] = 0
                self._health[widx]["busy_since"] = None
            with self._cv:
                self._dispatching -= 1
                self._cv.notify_all()  # wake a quiescing swap

    def _bisect(self, predictor, batch: List[_Request], widx: int,
                cause: Exception):
        """Poison containment: split the failed batch in half and
        retry each half, recursively, until every request is either
        served (bit-exact — a sub-batch pads to its own bucket, and
        bucket size never changes a row's result) or isolated alone
        as the poison and failed with :class:`RequestFailed`.  Cost
        is bounded: each bisection level re-dispatches at most the
        original row count, and there are at most ``log2(len(batch))
        + 1`` levels."""
        self._count("bisections")
        stat_add("serving_batch_bisections")
        telemetry.log_event("serving_batch_bisection",
                            requests=len(batch),
                            cause=f"{type(cause).__name__}: {cause}")
        stack = [list(batch)]
        while stack:
            group = stack.pop()
            t0 = time.monotonic()
            with self._n_lock:
                # re-arm the stuck watchdog per dispatch: it measures
                # ONE execution, not the whole (bounded but multi-
                # dispatch) containment episode — a routine bisection
                # must not read as a wedged worker
                self._health[widx]["busy_since"] = t0
            try:
                per_req = self._execute(predictor, group)
            except Exception as e:  # noqa: BLE001 — sort, don't die
                if len(group) > 1:
                    mid = len(group) // 2
                    # front half on top: requests resolve in FIFO order
                    stack.append(group[mid:])
                    stack.append(group[:mid])
                    continue
                req = group[0]
                self._count("poison_rows", req.rows)
                stat_add("serving_poison_rows", req.rows)
                logger.warning("bisection isolated a poisoned request "
                               "(%d row(s)): %s", req.rows, e)
                telemetry.log_event("serving_poison_isolated",
                                    rows=req.rows,
                                    error=f"{type(e).__name__}: {e}")
                self._resolve_failed(req, e,
                                     (time.monotonic() - t0) * 1e3,
                                     isolated=True)
                continue
            now = time.monotonic()
            predict_ms = (now - t0) * 1e3
            self._count("served", len(group))
            self._book_worker(widx, predictor, True,
                              sum(r.rows for r in group), predict_ms)
            for req, outputs in zip(group, per_req):
                self._resolve_ok(req, outputs, predict_ms, now)

    def _run_chunked(self, predictor, req: _Request) -> List[np.ndarray]:
        chunks = []
        for lo in range(0, req.rows, self.max_batch):
            part = [a[lo:lo + self.max_batch] for a in req.arrays]
            bucket = batcher.bucket_for(part[0].shape[0], self.buckets)
            padded, real = batcher.pad_stack([part], bucket)
            outs = predictor.run(padded)
            chunks.append([np.asarray(o)[:real] for o in outs])
            self._book_batch(real, bucket)
        return [np.concatenate([c[i] for c in chunks], axis=0)
                for i in range(len(chunks[0]))]

    def _book_batch(self, rows: int, bucket: Optional[int]):
        self._count("batches")
        stat_add("serving_batches")
        b = bucket or rows
        pad = b - rows
        if pad:
            self._count("pad_rows", pad)
            stat_add("serving_pad_rows", pad)
        else:
            self._count("exact_bucket")
            stat_add("serving_batch_exact_bucket")
        fill = batcher.fill_pct(rows, b)
        self._h_fill.observe(fill)
        telemetry.histogram_observe("serving_batch_fill_pct", fill)
        with self._n_lock:
            hit = self._n["exact_bucket"] / max(self._n["batches"], 1)
        telemetry.gauge_set("serving_bucket_hit_rate", hit)

    # -- introspection ------------------------------------------------------
    def worker_health(self) -> List[dict]:
        """Per-worker health: batch/failure tallies, the failure streak,
        rows currently in flight, the last batch's status, the worker's
        own batch-latency summary (``predict_ms``) and mean batch fill
        (``avg_batch_rows``).  ``status`` is ``ok | stuck``.  ``stuck`` is
        the dispatch
        watchdog's verdict: the worker has been inside its CURRENT
        batch longer than ``FLAGS_serving_worker_stuck_ms``
        (``stuck_ms`` carries the live wall time) — the thread cannot
        be killed in-process, but the engine status degrades so a
        router stops preferring this replica."""
        now = time.monotonic()
        stuck_after = float(
            flag_value("FLAGS_serving_worker_stuck_ms") or 0)
        with self._n_lock:
            snap = [dict(h, last_batch=dict(h["last_batch"])
                         if h["last_batch"] else None)
                    for h in self._health]
        for i, h in enumerate(snap):
            h["predict_ms"] = self._h_worker[i].summary()
            h["avg_batch_rows"] = round(
                h["rows_total"] / max(h["batches"], 1), 2)
            busy = h.pop("busy_since")
            h["stuck_ms"] = round((now - busy) * 1e3, 1) \
                if busy is not None else None
            h["stuck"] = bool(stuck_after > 0
                              and h["stuck_ms"] is not None
                              and h["stuck_ms"] >= stuck_after)
        for h in snap:
            h["status"] = "stuck" if h["stuck"] else "ok"
        return snap

    def retry_after_s(self) -> float:
        """Backoff hint for 503 responses (the ``Retry-After`` header):
        the estimated time for the current backlog to drain through
        the worker pool — queued batches over pool width at the
        measured per-batch p50 (the batching delay before anything is
        measured) — bounded to [0.5, 30] s so a bad estimate can
        neither hammer nor strand a well-behaved client."""
        with self._cv:
            depth = len(self._queue)
        per_batch_s = self._max_delay_s
        p50s = [h.summary().get("p50") for h in self._h_worker]
        p50s = [p for p in p50s if p]
        if p50s:
            per_batch_s = max(per_batch_s, max(p50s) / 1e3)
        batches_pending = math.ceil(depth / max(1, self.max_batch))
        est = self._max_delay_s \
            + (batches_pending / self.workers) * per_batch_s
        return min(30.0, max(0.5, est))

    def stats(self) -> dict:
        """Engine-local serving stats (isolated from the process-global
        monitor): counters, latency/wait/fill histogram summaries,
        queue depth + its high watermark."""
        with self._n_lock:
            n = dict(self._n)
            inflight = sum(h["in_flight_rows"] for h in self._health)
            version = self.weights_version
        with self._cv:
            depth = len(self._queue)
            peak = self._peak_depth
            draining = self._draining
        return {
            "queue_depth": depth,
            "inflight_rows": inflight,
            "queue_depth_peak": peak,
            "queue_cap": self.queue_cap,
            "workers": self.workers,
            "buckets": list(self.buckets),
            "draining": draining,
            "weights_version": version,
            "counters": n,
            "bucket_hit_rate": round(
                n["exact_bucket"] / max(n["batches"], 1), 4),
            "shed_rate": round(n["shed"] / max(n["requests"], 1), 4),
            "request_ms": self._h_request.summary(),
            "queue_wait_ms": self._h_wait.summary(),
            "batch_fill_pct": self._h_fill.summary(),
        }

    def tracez(self) -> dict:
        """The ``/tracez`` payload: recent head-sampled request traces
        (newest first, full span trees) + the slowest-N tail (kept
        regardless of sampling — phase-timing records, span trees when
        the slow request was also sampled)."""
        with self._trace_lock:
            recent = list(self._tracez_recent)
            slow = list(self._tracez_slow)
        rate = flag_value("FLAGS_trace_sample")
        out = {
            "sample_rate": float(rate) if rate is not None else 0.0,
            "tail_keep": self._tail_keep,
            "recent_sampled": recent[::-1],
            "slowest": slow,
        }
        if self.generator is not None:
            # finished-sequence timelines: the TTFT/ITL exemplars'
            # trace ids resolve against this block
            out["generation"] = self.generator.tracez()
        return out

    def introspect(self) -> dict:
        """The engine half of ``/statusz``: stats + per-predictor
        compiled-executable inventory + trace-store occupancy."""
        with self._trace_lock:
            traces = {"recent_sampled": len(self._tracez_recent),
                      "slowest_kept": len(self._tracez_slow)}
        out = {
            "stats": self.stats(),
            "max_batch": self.max_batch,
            "max_delay_ms": self._max_delay_s * 1e3,
            "deadline_ms": self._deadline_s * 1e3,
            "engine_uptime_s": round(time.time() - self._started, 3),
            "process_uptime_s": round(
                time.time() - process_start_time(), 3),
            "executables": [p.cache_info() for p in self._pool],
            "groups": self.worker_health(),
            "traces": traces,
        }
        if self.generator is not None:
            out["generator"] = self.generator.introspect()
        return out

    def health(self) -> dict:
        """The ``/healthz`` payload: serving liveness + the same
        process-level fields the telemetry heartbeat exports (pid,
        uptime, the cards' allocated and reserved memory)."""
        from ..telemetry import _device_memory

        groups = self.worker_health()
        status = "ok"
        if any(g["status"] != "ok" for g in groups):
            # a stuck worker: still serving (the other workers are
            # healthy), but a balancer and an operator must see it
            status = "degraded"
        with self._cv:
            draining, closed = self._draining, self._closed
        if draining:
            status = "draining"
        if closed:
            status = "closed"
        # ready computed from the SAME snapshot as status (a second
        # ready() would re-take _cv and could disagree mid-close)
        ready = not (draining or closed)
        with self._n_lock:
            version = self.weights_version
        out = {
            "status": status,
            "ready": ready,
            "weights_version": version,
            "pid": os.getpid(),
            "time": time.time(),
            "uptime_s": round(time.time() - self._started, 3),
            "device_memory": _device_memory(),
            "serving": self.stats(),
            "groups": groups,
        }
        if self.generator is not None:
            out["generation"] = self.generator.stats()
            # the disagg role, top-level: the router's affinity
            # placement reads it off every health poll
            out["role"] = getattr(self.generator, "role", "both")
        return out
