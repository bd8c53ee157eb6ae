#!/usr/bin/env python
"""Closed- and open-loop load generator for the port's serving engine.

    python -m paddle_tpu_torch.tools.serving_loadgen --synthetic --device cpu

The port's copy of ``tools/serving_loadgen.py``: the same module and
function names, flags, report schema and SLO verdicts, and the same
arithmetic and RNG calls, so equal seeds give equal feeds, prompts,
tenants and arrival schedules.  It drives a
:class:`paddle_tpu_torch.serving.ServingEngine` **in process** (the
engine's submit() API is the contract) — or, with ``--url``, a live
serving HTTP endpoint over real sockets (``POST /predict``; overload
503s count as sheds, and the report embeds a ``/statusz`` snapshot
instead of in-process engine stats) — and emits one JSON report:

    {"mode": "closed", "requests": N, "ok": N, "shed": N, "failed": N,
     "wall_s": ..., "qps": ..., "latency_ms": {"p50":..,"p95":..,"p99":..},
     "shed_rate": ..., "engine": {<ServingEngine.stats()>}}

Where it differs from the reference (each place names the reference's
line): the in-process drivers catch the port's ``OverloadedError`` /
``ServingError``, so a port engine's shed counts as ``shed`` and its
failure as ``failed``; the in-process engines run on the card
(``cuda:0``) unless ``--device cpu`` / ``device="cpu"``, and raise with
no GPU and no explicit CPU; in process, ``--sharded`` (mesh-sharded
serving, ROADMAP.md queue 1 item 9) and ``--recsys`` (the embedding
tier, item 8) raise ``NotImplementedError``.  ``--url`` speaks the
reference's wire format, so every ``--url`` mode works against a
replica or router of either package.

* **closed loop** (``--mode closed``): ``--concurrency`` callers, each
  submit→wait→repeat until ``--requests`` total — measures saturated
  throughput (the batcher sees a standing queue, batches run full).
* **open loop** (``--mode open``): requests arrive on a fixed ``--qps``
  clock regardless of completions — measures latency at a target rate
  and shed behavior past capacity (arrival rate does not slow down when
  the engine does, so overload actually overloads).
* ``--mode both`` runs closed then open and nests the two reports.

**Traffic shapes** (``--traffic const|sine|burst|step``, or a bare
``--shape sine``): the open-loop clock follows a diurnal ``sine``,
periodic ``burst``, or capacity-cliff ``step`` profile
(:class:`TrafficShape`; ``--traffic-amplitude`` / ``--traffic-period``
/ ``--traffic-burst-frac`` size it).  The report gains a ``phases``
block — per-phase requests / qps / p99 / shed — and the SLO
assertions below are evaluated in EVERY phase, so overload at the
crest fails the run even when the trough averages it away.

**SLO assertions**: ``--slo-p99-ms X`` and/or ``--slo-shed-pct Y`` make
the run load-bearing — the report gains an ``"slo"`` block listing every
violation (p99 latency above X ms, shed rate above Y percent, or zero
completed requests) and the process **exits 1** when any sub-report
violates.  In ``--mode both`` each sub-report is checked.  With
``--url`` a violation also saves the target's ``/debugz`` bundle.

Model: ``--model-dir`` (a ``save_inference_model`` export; give per-row
feed shapes as ``--shape name=d0,d1``) or ``--synthetic`` (an in-process
MLP — no files needed; ``--hidden/--depth/--feat`` size it).

**Generation mode** (``--generate``): drives a slot-based
:class:`paddle_tpu_torch.serving.GenerationEngine` instead of the one-shot
engine.  Each request draws its prompt length uniformly from
``[--gen-prompt-min, --gen-prompt-max]`` and its output length from
``--gen-out-dist`` (**geometric**, or a chat-style 75/25 short/long
**bimodal** mix; mean ``--gen-out-mean``, clamped to
``[1, --gen-out-max]``).  Closed loop measures saturated
``tokens_per_sec``; open loop (``--mode open``) paces request arrivals
on the ``--qps`` clock.  ``--gen-static`` schedules FIFO head-run
(batch drain) instead of continuous slot reclaim.  ``--gen-paged``
(with ``--gen-page-tokens``/``--gen-pages``/``--gen-prefill-chunk``)
swaps in the block-paged KV cache, ``--gen-speculate``/
``--gen-spec-tokens`` turn on speculative decoding (the report embeds
the measured acceptance rate; ``--slo-accept-rate`` floors it —
unmeasured is a violation), and ``--gen-prompt-dist shared-prefix
--gen-prefix-tokens N`` makes every prompt one fixed N-token header + a
random tail.  With ``--url`` the same workload posts ``/generate``
against a live replica or fleet router (``--gen-stream`` reads the
NDJSON stream and measures client TTFT and inter-token gaps) and the
report embeds the target's ``/statusz`` generation block.

**Multi-tenant runs** (``--tenants N``): each request carries one of N
tenant names; the report embeds the target's ``/usagez`` breakdown (a
router's ``/fleetz`` tenant families, as a router has no ``/usagez``)
and ``--slo-tenant-p99-ms`` bounds every tenant's p99.

**Recsys mode** (``--recsys``): zipfian int64 ``sparse_ids`` plus dense
features; with ``--url`` the bodies go to a live recsys target and the
report embeds its hot-row hit rate (``--slo-hit-rate`` floors it).  In
process it waits for the embedding tier (item 8).
"""
from __future__ import annotations

import argparse
import json
import os
import queue as queue_mod
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Dict, List, Optional

import numpy as np


# ---------------------------------------------------------------------------
# model builders
# ---------------------------------------------------------------------------

def build_synthetic(feat: int = 64, hidden: int = 256, depth: int = 2,
                    classes: int = 8, seed: int = 0, device=None):
    """In-process MLP predictor (no model dir needed): returns
    ``(predictor, per_row_shapes)``.  ``device`` (the reference's
    ``:119`` has none): the card (``cuda:0``) unless ``"cpu"``; with no
    GPU and no explicit CPU it raises."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.inference import Predictor

    device = resolve_device(device)
    main, startup = pt.Program(), pt.Program()
    startup._is_startup = True
    startup.random_seed = main.random_seed = seed
    with pt.program_guard(main, startup):
        x = layers.data("x", [feat])
        h = x
        for i in range(depth):
            h = layers.fc(h, hidden, act="relu", name=f"lg_fc{i}")
        out = layers.fc(h, classes, name="lg_head")
    scope = pt.Scope()
    pt.Executor(device).run(startup, scope=scope)
    return (Predictor(main, ["x"], [out], scope=scope, device=device),
            {"x": (feat,)})


def feed_maker(shapes: Dict[str, tuple], rows: int = 1,
               seed: int = 0) -> Callable[[int], dict]:
    """Deterministic per-request feed factory (a pool of distinct
    pre-generated feeds, cycled by request index — host RNG off the
    timed path)."""
    rng = np.random.RandomState(seed)
    pool = []
    for _ in range(16):
        pool.append({n: rng.rand(rows, *s).astype("float32")
                     for n, s in shapes.items()})
    return lambda i: pool[i % len(pool)]


def zipf_ids(rng, vocab: int, size, s: float) -> np.ndarray:
    """Bounded zipfian id sampler: ids 0..vocab-1 with
    P(rank k) ∝ 1/(k+1)^s via inverse-CDF — unlike np.random.zipf
    this is bounded to the vocab (no rejection loop), works for any
    s >= 0 (s=0 = uniform), and is deterministic under the seeded
    ``rng``.  The skew knob is what makes the hot-row cache testable:
    s≈1.2 concentrates most probability mass in a few hundred ids
    (recommender reality), s≈0 spreads it flat (cache-hostile)."""
    w = 1.0 / np.power(np.arange(1, vocab + 1, dtype=np.float64), s)
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    return np.searchsorted(cdf,
                           rng.random_sample(size)).astype(np.int64)


TENANT_HEADER = "X-PaddleTPU-Tenant"


def tenant_picker(n: int, dist: str = "zipf", seed: int = 0,
                  pool: int = 4096) -> Callable[[int], str]:
    """Deterministic request-index -> tenant-name assignment for
    multi-tenant runs (``--tenants N``): ``zipf`` concentrates most of
    the traffic on ``tenant-00`` (the noisy-neighbor shape the usage
    observatory exists to attribute), ``uniform`` spreads it evenly.
    Pre-sampled pool, cycled by request index — host RNG off the
    timed path, same run same assignment."""
    rng = np.random.RandomState(seed)
    if dist == "uniform":
        ids = rng.randint(0, n, size=pool)
    else:
        ids = zipf_ids(rng, n, pool, 1.2)
    names = [f"tenant-{i:02d}" for i in range(n)]
    return lambda i: names[int(ids[i % pool])]


def recsys_feed_maker(slots: int, dense: int, vocab: int,
                      zipf: float = 1.2, rows: int = 1, seed: int = 0,
                      pool_size: int = 64) -> Callable[[int], dict]:
    """Per-request recsys feed factory: zipfian int64 ``sparse_ids``
    (``[rows, slots]``) + uniform float32 ``dense_x`` (``[rows,
    dense]``), pre-generated and cycled like :func:`feed_maker`.  The
    pool is larger than the dense maker's (64 vs 16): the hit-rate
    measurement needs enough DISTINCT hot ids in flight that the cache
    is doing real work, not replaying 16 memoized feeds."""
    rng = np.random.RandomState(seed)
    pool = []
    for _ in range(pool_size):
        pool.append({
            "sparse_ids": zipf_ids(rng, vocab, (rows, slots), zipf),
            "dense_x": rng.rand(rows, dense).astype("float32")})
    return lambda i: pool[i % len(pool)]


# ---------------------------------------------------------------------------
# traffic shapes (open loop): diurnal / bursty offered-load profiles
# ---------------------------------------------------------------------------

TRAFFIC_SHAPES = ("const", "sine", "burst", "step")


class TrafficShape:
    """Time-varying offered load for the open loop.

    Real traffic is not a constant-qps clock: it swells and ebbs
    (diurnal), spikes (retry storms, cache stampedes), and steps
    (a feature launch).  ``rate(t)`` gives the instantaneous target
    qps at ``t`` seconds into the run and ``phase(t)`` labels the
    regime, so the report can show qps/p99/shed PER PHASE — overload
    behavior at the crest is visible instead of averaged away by the
    trough.

    * ``const`` — ``base`` throughout (phase ``steady``; the legacy
      behavior).
    * ``sine`` — ``base * (1 + A*sin(2πt/period))``: a compressed
      diurnal curve (phases ``crest`` / ``trough``); default period =
      the whole run (one cycle).
    * ``burst`` — ``base`` with ``base*(1+A)`` bursts for the first
      ``burst_frac`` of every period (phases ``burst`` / ``base``);
      default period = duration/4 (four bursts).
    * ``step`` — ``base`` for the first half, ``base*(1+A)`` after
      (phases ``low`` / ``high``): a capacity cliff.

    ``amplitude`` is relative: 1.0 doubles the rate at the peak."""

    def __init__(self, shape: str, base_qps: float, duration_s: float,
                 amplitude: float = 1.0,
                 period_s: Optional[float] = None,
                 burst_frac: float = 0.25):
        if shape not in TRAFFIC_SHAPES:
            raise ValueError(f"unknown traffic shape {shape!r}; "
                             f"one of {TRAFFIC_SHAPES}")
        self.shape = shape
        self.base = float(base_qps)
        self.duration = float(duration_s)
        self.amplitude = float(amplitude)
        if period_s is None:
            period_s = duration_s if shape == "sine" \
                else max(duration_s / 4.0, 1e-3)
        self.period = float(period_s)
        self.burst_frac = float(burst_frac)

    def rate(self, t: float) -> float:
        b, a = self.base, self.amplitude
        if self.shape == "sine":
            import math
            r = b * (1.0 + a * math.sin(2.0 * math.pi * t / self.period))
            return max(r, 0.05 * b)  # the trough still offers load
        if self.shape == "burst":
            return b * (1.0 + a) if (t % self.period) \
                < self.burst_frac * self.period else b
        if self.shape == "step":
            return b * (1.0 + a) if t >= self.duration / 2.0 else b
        return b

    def phase(self, t: float) -> str:
        if self.shape == "sine":
            import math
            return "crest" if math.sin(
                2.0 * math.pi * t / self.period) >= 0.0 else "trough"
        if self.shape == "burst":
            return "burst" if (t % self.period) \
                < self.burst_frac * self.period else "base"
        if self.shape == "step":
            return "high" if t >= self.duration / 2.0 else "low"
        return "steady"

    def describe(self) -> dict:
        return {"shape": self.shape, "base_qps": self.base,
                "amplitude": self.amplitude,
                "period_s": round(self.period, 3),
                "burst_frac": self.burst_frac
                if self.shape == "burst" else None}


def _arrival_clock(qps: float, duration_s: float,
                   traffic: Optional[TrafficShape] = None):
    """Paced arrival generator: yields ``(i, phase, now)`` at each
    arrival instant.  With ``traffic`` the inter-arrival gap follows
    the shape's instantaneous rate; without, a fixed ``1/qps`` clock
    (byte-identical to the legacy pacing)."""
    t0 = time.monotonic()
    end = t0 + duration_s
    next_at = t0
    n = 0
    while True:
        now = time.monotonic()
        if now >= end:
            return
        if now < next_at:
            time.sleep(min(next_at - now, 0.01))
            continue
        rel = next_at - t0
        rate = traffic.rate(rel) if traffic is not None else qps
        phase = traffic.phase(rel) if traffic is not None else None
        next_at += 1.0 / max(rate, 1e-6)
        yield n, phase, now
        n += 1


class _PhaseBook:
    """Per-phase tallies for a shaped open-loop run.

    Phase time is ACTIVE time — the sum of inter-arrival gaps spent
    inside each contiguous visit to the phase — not last-arrival minus
    first-arrival.  A periodic shape (`burst`, `sine`, multi-cycle
    `step`) re-enters a phase many times across the run; first-to-last
    would span every interval spent in the OTHER phases and dilute the
    reported qps/offered_qps by the duty cycle."""

    def __init__(self):
        self.phases: Dict[str, dict] = {}
        self._cur_phase: Optional[str] = None
        self._last_ts: Optional[float] = None

    def _get(self, phase: str) -> dict:
        ph = self.phases.get(phase)
        if ph is None:
            ph = self.phases[phase] = {
                "requests": 0, "ok": 0, "shed": 0, "failed": 0,
                "lat": [], "active_s": 0.0, "versions": {}}
        return ph

    def arrival(self, phase: str, now: float):
        ph = self._get(phase)
        ph["requests"] += 1
        if self._cur_phase == phase and self._last_ts is not None:
            ph["active_s"] += now - self._last_ts
        self._cur_phase = phase
        self._last_ts = now

    def outcome(self, phase: str, outcome: str,
                ms: Optional[float] = None,
                version: Optional[int] = None):
        ph = self._get(phase)
        ph[outcome] += 1
        if ms is not None:
            ph["lat"].append(ms)
        if outcome == "ok" and version is not None:
            # per-phase weights_version distribution: a hot swap
            # mid-run shows up as the old version draining out of one
            # phase and the new one taking over the next
            ph["versions"][str(version)] = \
                ph["versions"].get(str(version), 0) + 1

    def report(self) -> Dict[str, dict]:
        out = {}
        for name, ph in self.phases.items():
            wall = max(ph["active_s"], 1e-3)
            out[name] = {
                "requests": ph["requests"], "ok": ph["ok"],
                "shed": ph["shed"], "failed": ph["failed"],
                "qps": round(ph["ok"] / wall, 2),
                "offered_qps": round(ph["requests"] / wall, 2),
                "shed_rate": round(ph["shed"] / max(ph["requests"], 1),
                                   4),
                "latency_ms": _percentiles(ph["lat"]),
            }
            if ph["versions"]:
                out[name]["weights_versions"] = dict(ph["versions"])
        return out


# ---------------------------------------------------------------------------
# loops
# ---------------------------------------------------------------------------

def _percentiles(lat_ms: List[float]) -> dict:
    if not lat_ms:
        return {"count": 0}
    a = np.asarray(lat_ms)
    return {"count": len(lat_ms),
            "mean": round(float(a.mean()), 3),
            "p50": round(float(np.percentile(a, 50)), 3),
            "p95": round(float(np.percentile(a, 95)), 3),
            "p99": round(float(np.percentile(a, 99)), 3),
            "max": round(float(a.max()), 3)}


def _report(mode: str, n: int, ok: int, shed: int, failed: int,
            wall_s: float, lat_ms: List[float], engine) -> dict:
    return {"mode": mode, "requests": n, "ok": ok, "shed": shed,
            "failed": failed, "wall_s": round(wall_s, 4),
            "qps": round(ok / wall_s, 2) if wall_s > 0 else 0.0,
            "offered_qps": round(n / wall_s, 2) if wall_s > 0 else 0.0,
            "shed_rate": round(shed / max(n, 1), 4),
            "latency_ms": _percentiles(lat_ms),
            "engine": engine.stats() if engine is not None else None}


def run_closed_loop(engine, make_feed, n_requests: int,
                    concurrency: int, timeout_s: float = 60.0,
                    tenant_of: Optional[Callable[[int], str]] = None
                    ) -> dict:
    """``concurrency`` synchronous callers sharing a ticket counter."""
    # the port's error classes (the reference catches its own, :408):
    # a shed counts as shed, a failure as failed
    from paddle_tpu_torch.serving import OverloadedError, ServingError

    tickets = iter(range(n_requests))
    ticket_lock = threading.Lock()
    lat, lock = [], threading.Lock()
    counts = {"ok": 0, "shed": 0, "failed": 0}

    def caller():
        while True:
            with ticket_lock:
                i = next(tickets, None)
            if i is None:
                return
            feed = make_feed(i)
            t0 = time.monotonic()
            try:
                if tenant_of is None:
                    engine.predict(feed, timeout=timeout_s)
                else:
                    engine.submit(feed, tenant=tenant_of(i)) \
                        .result(timeout_s)
                ms = (time.monotonic() - t0) * 1e3
                with lock:
                    counts["ok"] += 1
                    lat.append(ms)
            except OverloadedError:
                with lock:
                    counts["shed"] += 1
            except (ServingError, TimeoutError):
                with lock:
                    counts["failed"] += 1

    threads = [threading.Thread(target=caller, daemon=True)
               for _ in range(concurrency)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t0
    rep = _report("closed", n_requests, counts["ok"], counts["shed"],
                  counts["failed"], wall, lat, engine)
    rep["concurrency"] = concurrency
    return rep


def run_open_loop(engine, make_feed, qps: float, duration_s: float,
                  timeout_s: float = 60.0, collectors: int = 8,
                  traffic: Optional[TrafficShape] = None,
                  tenant_of: Optional[Callable[[int], str]] = None
                  ) -> dict:
    """Fixed-rate arrivals: one pacing thread submits on a ``1/qps``
    clock; a collector pool stamps completions.  Sheds at submit() count
    against the offered load (that IS the overload behavior under
    test).  ``traffic`` (a :class:`TrafficShape`) replaces the fixed
    clock with a diurnal/bursty profile and adds per-phase qps/p99/shed
    to the report."""
    # the port's error classes (the reference catches its own, :465):
    # a shed counts as shed, a failure as failed
    from paddle_tpu_torch.serving import OverloadedError, ServingError

    lat, lock = [], threading.Lock()
    counts = {"ok": 0, "shed": 0, "failed": 0}
    phases = _PhaseBook() if traffic is not None else None
    pending: queue_mod.Queue = queue_mod.Queue()

    def collector():
        while True:
            item = pending.get()
            if item is None:
                return
            fut, t0, phase = item
            try:
                fut.result(timeout_s)
                ms = (time.monotonic() - t0) * 1e3
                with lock:
                    counts["ok"] += 1
                    lat.append(ms)
                    if phases is not None:
                        phases.outcome(phase, "ok", ms)
            except OverloadedError:
                with lock:
                    counts["shed"] += 1
                    if phases is not None:
                        phases.outcome(phase, "shed")
            except (ServingError, TimeoutError):
                with lock:
                    counts["failed"] += 1
                    if phases is not None:
                        phases.outcome(phase, "failed")

    pool = [threading.Thread(target=collector, daemon=True)
            for _ in range(collectors)]
    for t in pool:
        t.start()

    n = 0
    t0 = time.monotonic()
    for i, phase, now in _arrival_clock(qps, duration_s, traffic):
        n = i + 1
        if phases is not None:
            with lock:
                phases.arrival(phase, now)
        try:
            kw = {"tenant": tenant_of(i)} if tenant_of is not None \
                else {}
            fut = engine.submit(make_feed(i), **kw)
            pending.put((fut, now, phase))
        except OverloadedError:
            with lock:
                counts["shed"] += 1
                if phases is not None:
                    phases.outcome(phase, "shed")
    for _ in pool:
        pending.put(None)
    for t in pool:
        t.join()
    wall = time.monotonic() - t0
    rep = _report("open", n, counts["ok"], counts["shed"],
                  counts["failed"], wall, lat, engine)
    rep["target_qps"] = qps
    if traffic is not None:
        rep["traffic"] = traffic.describe()
        rep["phases"] = phases.report()
    return rep


# ---------------------------------------------------------------------------
# generation loops (--generate: drive a GenerationEngine's slot scheduler)
# ---------------------------------------------------------------------------

def prompt_maker(vocab_size: int, prompt_min: int, prompt_max: int,
                 out_mean: float, out_max: int, seed: int = 0,
                 pool: int = 64,
                 dist: str = "geometric",
                 prompt_dist: str = "uniform",
                 prefix_tokens: int = 0,
                 long_frac: float = 0.25,
                 long_tokens: int = 0) -> Callable[[int], tuple]:
    """Deterministic per-request ``(prompt_ids, max_new_tokens)``
    factory.  Prompt lengths are uniform in [prompt_min, prompt_max];
    output lengths draw from ``dist`` with mean ``out_mean`` clamped to
    [1, out_max] — most sequences finish fast, a tail runs long, which
    is the shape that makes batch-drain scheduling strand slots (host
    RNG off the timed path: a fixed pool cycled by request index).

    ``dist="geometric"``: memoryless tail; a full slot grid's expected
    longest draw is only ~2.7x the mean, so the batch-drain penalty it
    exposes is bounded.  ``dist="bimodal"``: 75% short (mean/8) / 25%
    long (~3.3x mean, same overall mean) — the chat-style mix where
    most turns are brief and a quarter run long, driving the grid's
    longest sequence to ~3.3x the mean (the harsher, more realistic
    test of slot reclaim).

    ``prompt_dist="shared-prefix"``: every prompt is one fixed
    ``prefix_tokens``-token header (drawn once — the system prompt /
    few-shot preamble of a chat product) followed by a random
    [prompt_min, prompt_max]-token tail — the workload where the paged
    engine's prefix index turns the header's prefill into a page-table
    hit.  ``"uniform"`` keeps fully random prompts.

    ``prompt_dist="mixed"``: the **bimodal long-prompt/short-chat**
    traffic shape disaggregated serving exists to fix — a
    ``long_frac`` fraction of prompts are LONG (uniform in
    ``[3*long_tokens//4, long_tokens]``; compute-bound prefill bursts
    that wreck colocated decode p99) and the rest are short chat
    turns (uniform in [prompt_min, prompt_max]).  ``long_tokens`` is
    required; tune ``long_frac`` to sweep the mix."""
    rng = np.random.RandomState(seed)
    reqs = []
    if dist == "bimodal":
        p_long = 0.25
        short = max(1.0, out_mean / 8.0)
        long_ = (out_mean - (1.0 - p_long) * short) / p_long
    elif dist != "geometric":
        raise ValueError(f"unknown output-length dist {dist!r}")
    header = None
    if prompt_dist == "shared-prefix":
        if prefix_tokens < 1:
            raise ValueError("shared-prefix prompts need "
                             "prefix_tokens >= 1")
        header = rng.randint(1, vocab_size,
                             size=prefix_tokens).astype("int64")
    elif prompt_dist == "mixed":
        if long_tokens < max(1, prompt_max):
            raise ValueError(f"mixed prompts need long_tokens > the "
                             f"short prompt_max ({prompt_max}), got "
                             f"{long_tokens}")
        if not 0.0 < long_frac < 1.0:
            raise ValueError(f"mixed prompts need 0 < long_frac < 1, "
                             f"got {long_frac}")
    elif prompt_dist != "uniform":
        raise ValueError(f"unknown prompt dist {prompt_dist!r}")
    for _ in range(pool):
        if prompt_dist == "mixed" \
                and rng.random_sample() < long_frac:
            plen = int(rng.randint(max(prompt_min,
                                       3 * long_tokens // 4),
                                   long_tokens + 1))
        else:
            plen = int(rng.randint(prompt_min, prompt_max + 1))
        prompt = rng.randint(1, vocab_size, size=plen).astype("int64")
        if header is not None:
            prompt = np.concatenate([header, prompt])
        if dist == "bimodal":
            mean = long_ if rng.random_sample() < p_long else short
        else:
            mean = out_mean
        out_len = int(np.clip(rng.geometric(1.0 / max(mean, 1.0)),
                              1, out_max))
        reqs.append((prompt, out_len))
    return lambda i: reqs[i % len(reqs)]


def _gen_report(mode: str, n: int, ok: int, shed: int, failed: int,
                wall_s: float, lat_ms: List[float], tokens: int,
                engine, ttft_ms: Optional[List[float]] = None,
                itl_ms: Optional[List[float]] = None) -> dict:
    rep = _report(mode, n, ok, shed, failed, wall_s, lat_ms, engine)
    rep["generated_tokens"] = tokens
    rep["tokens_per_sec"] = round(tokens / wall_s, 2) if wall_s > 0 \
        else 0.0
    spec = (rep.get("engine") or {}).get("speculate") \
        if isinstance(rep.get("engine"), dict) else None
    if isinstance(spec, dict):
        # measured acceptance rate at report level, same spot the HTTP
        # loop embeds it from /statusz — check_slo's accept_rate input
        rep["spec_acceptance_rate"] = spec.get("acceptance_rate")
    if ttft_ms is not None:
        # CLIENT-side time-to-first-token: submit (or POST) instant to
        # the first token's arrival at the caller — queue wait,
        # prefix mapping, and chunked-prefill interleave all included,
        # because the user waits through all of them
        rep["ttft_ms"] = _percentiles(ttft_ms)
    if itl_ms is not None:
        # client-side inter-token gaps, pooled across requests: the
        # p99 is "how long does a token ever stall", the decode-smooth
        # number the chunked-prefill knob trades against
        rep["inter_token_ms"] = _percentiles(itl_ms)
    return rep


class _TokenClock:
    """Per-request token-arrival recorder for the in-process loops:
    the engine's ``on_token`` hook stamps arrivals on the caller's
    clock; :meth:`fold` reduces them to a TTFT and inter-token gaps."""

    __slots__ = ("t0", "arrivals")

    def __init__(self, t0: float):
        self.t0 = t0
        self.arrivals: List[float] = []

    def on_token(self, tok, ts):
        self.arrivals.append(time.monotonic())

    def fold(self) -> tuple:
        """-> (ttft_ms or None, [gap_ms, ...])."""
        if not self.arrivals:
            return None, []
        ttft = (self.arrivals[0] - self.t0) * 1e3
        gaps = [(b - a) * 1e3
                for a, b in zip(self.arrivals, self.arrivals[1:])]
        return ttft, gaps


def run_closed_loop_generate(engine, make_prompt, n_requests: int,
                             concurrency: int,
                             timeout_s: float = 120.0,
                             tenant_of: Optional[
                                 Callable[[int], str]] = None) -> dict:
    """Closed loop against a GenerationEngine: ``concurrency``
    synchronous callers submit→wait→repeat; the slot grid sees a
    standing queue, so the measured ``tokens_per_sec`` is the
    scheduler's saturated decode throughput."""
    # the port's error classes (the reference catches its own, :681):
    # a shed counts as shed, a failure as failed
    from paddle_tpu_torch.serving import OverloadedError, ServingError

    tickets = iter(range(n_requests))
    ticket_lock = threading.Lock()
    lat, lock = [], threading.Lock()
    ttfts: List[float] = []
    itls: List[float] = []
    counts = {"ok": 0, "shed": 0, "failed": 0, "tokens": 0}

    def caller():
        while True:
            with ticket_lock:
                i = next(tickets, None)
            if i is None:
                return
            prompt, out_len = make_prompt(i)
            t0 = time.monotonic()
            clock = _TokenClock(t0)
            try:
                kw = {"tenant": tenant_of(i)} \
                    if tenant_of is not None else {}
                res = engine.submit(prompt, out_len,
                                    on_token=clock.on_token,
                                    **kw).result(timeout_s)
                ms = (time.monotonic() - t0) * 1e3
                ttft, gaps = clock.fold()
                with lock:
                    counts["ok"] += 1
                    counts["tokens"] += len(res["tokens"])
                    lat.append(ms)
                    if ttft is not None:
                        ttfts.append(ttft)
                    itls.extend(gaps)
            except OverloadedError:
                with lock:
                    counts["shed"] += 1
            except (ServingError, TimeoutError, ValueError):
                # ValueError = a rejected prompt (over-long / bad
                # dtype): counted as failed, NOT raised — a dead
                # caller thread would silently undercount the report
                with lock:
                    counts["failed"] += 1

    threads = [threading.Thread(target=caller, daemon=True)
               for _ in range(concurrency)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t0
    rep = _gen_report("closed", n_requests, counts["ok"],
                      counts["shed"], counts["failed"], wall, lat,
                      counts["tokens"], engine, ttft_ms=ttfts,
                      itl_ms=itls)
    rep["concurrency"] = concurrency
    return rep


def run_open_loop_generate(engine, make_prompt, qps: float,
                           duration_s: float, timeout_s: float = 120.0,
                           collectors: int = 8,
                           tenant_of: Optional[
                               Callable[[int], str]] = None) -> dict:
    """Open loop against a GenerationEngine: request arrivals on a
    fixed ``1/qps`` clock regardless of completions (offered load does
    not back off when the grid saturates — submit-time sheds ARE the
    overload signal under test); a collector pool stamps
    completions."""
    # the port's error classes (the reference catches its own, :750):
    # a shed counts as shed, a failure as failed
    from paddle_tpu_torch.serving import OverloadedError, ServingError

    lat, lock = [], threading.Lock()
    ttfts: List[float] = []
    itls: List[float] = []
    counts = {"ok": 0, "shed": 0, "failed": 0, "tokens": 0}
    pending: queue_mod.Queue = queue_mod.Queue()

    def collector():
        while True:
            item = pending.get()
            if item is None:
                return
            fut, t0, clock = item
            try:
                res = fut.result(timeout_s)
                ms = (time.monotonic() - t0) * 1e3
                ttft, gaps = clock.fold()
                with lock:
                    counts["ok"] += 1
                    counts["tokens"] += len(res["tokens"])
                    lat.append(ms)
                    if ttft is not None:
                        ttfts.append(ttft)
                    itls.extend(gaps)
            except OverloadedError:
                with lock:
                    counts["shed"] += 1
            except (ServingError, TimeoutError):
                with lock:
                    counts["failed"] += 1

    pool = [threading.Thread(target=collector, daemon=True)
            for _ in range(collectors)]
    for t in pool:
        t.start()

    period = 1.0 / qps
    n = 0
    t0 = time.monotonic()
    end = t0 + duration_s
    next_at = t0
    while True:
        now = time.monotonic()
        if now >= end:
            break
        if now < next_at:
            time.sleep(min(next_at - now, 0.01))
            continue
        next_at += period
        prompt, out_len = make_prompt(n)
        kw = {"tenant": tenant_of(n)} if tenant_of is not None else {}
        n += 1
        clock = _TokenClock(now)
        try:
            fut = engine.submit(prompt, out_len,
                                on_token=clock.on_token, **kw)
            pending.put((fut, now, clock))
        except OverloadedError:
            with lock:
                counts["shed"] += 1
        except ValueError:
            # rejected prompt: failed, not a crash of the arrival loop
            with lock:
                counts["failed"] += 1
    for _ in pool:
        pending.put(None)
    for t in pool:
        t.join()
    wall = time.monotonic() - t0
    rep = _gen_report("open", n, counts["ok"], counts["shed"],
                      counts["failed"], wall, lat, counts["tokens"],
                      engine, ttft_ms=ttfts, itl_ms=itls)
    rep["target_qps"] = qps
    return rep


# ---------------------------------------------------------------------------
# HTTP loops (--url: drive a live ServingServer over real sockets)
# ---------------------------------------------------------------------------

def _encode_bodies(make_feed, n: int = 16) -> List[bytes]:
    """Pre-serialize the feed pool to JSON bodies (host JSON encoding
    off the timed path, mirroring feed_maker's pre-generated arrays)."""
    return [json.dumps({"inputs": {k: np.asarray(v).tolist()
                                   for k, v in make_feed(i).items()}}
                       ).encode() for i in range(n)]


def _http_predict(url: str, body: bytes,
                  timeout_s: float,
                  tenant: Optional[str] = None) -> tuple:
    """One POST /predict -> ``('ok' | 'shed' | 'failed', version)``
    where ``version`` is the ``X-PaddleTPU-Weights-Version`` response
    header (replicas and the router both publish it; ``None`` when
    the server predates it or the connection died) — the rollout
    bench watches the distribution flip during a hot swap.

    Not every 503 is a shed: a replica's admission 503s (queue_full /
    deadline / draining) are explicit backpressure and count as shed,
    but the fleet router's ``no_ready_replicas`` 503 means ZERO
    routable replicas — total availability loss, the exact event the
    rolling-restart zero-non-shed-failure contract exists to catch —
    and must count as failed, never as an allowed shed."""
    headers = {"Content-Type": "application/json"}
    if tenant:
        headers[TENANT_HEADER] = tenant
    req = urllib.request.Request(url, data=body, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as r:
            r.read()
            v = r.headers.get("X-PaddleTPU-Weights-Version")
            return "ok", (int(v) if v else None)
    except urllib.error.HTTPError as e:
        try:
            payload = e.read()  # drain: keep-alive must not desync
        except OSError:
            payload = b""  # ok: error body gone with the connection
        if e.code != 503:
            return "failed", None
        try:
            reason = json.loads(payload).get("reason")
        except (ValueError, AttributeError):
            reason = None
        return ("failed" if reason == "no_ready_replicas"
                else "shed"), None
    except (OSError, TimeoutError, ValueError):
        return "failed", None


def _http_statusz(base_url: str, timeout_s: float = 10.0
                  ) -> Optional[dict]:
    try:
        with urllib.request.urlopen(base_url.rstrip("/") + "/statusz",
                                    timeout=timeout_s) as r:
            return json.loads(r.read())
    except (OSError, TimeoutError, ValueError):
        return None


def fetch_usagez(base_url: str, timeout_s: float = 10.0
                 ) -> Optional[dict]:
    """Pull the target's per-tenant ``/usagez`` breakdown (a replica
    endpoint).  A fleet router exposes no /usagez — fall back to the
    ``/fleetz`` per-tenant aggregate so a multi-tenant run through the
    router still embeds the fleet-level attribution (per-tenant
    latency summaries stay replica-only, so a tenant-p99 SLO bound
    against a router report violates as unmeasured, never passes
    vacuously).  Never raises."""
    base = base_url.rstrip("/")
    try:
        with urllib.request.urlopen(base + "/usagez",
                                    timeout=timeout_s) as r:
            return json.loads(r.read())
    except (OSError, TimeoutError, ValueError):
        pass  # ok: routers have no /usagez — the /fleetz fallback next
    try:
        with urllib.request.urlopen(base + "/fleetz",
                                    timeout=timeout_s) as r:
            doc = json.loads(r.read())
        agg = (doc.get("aggregate") or {}).get("tenants")
        if agg is not None:
            return {"fleet": True, "tenant_families": agg}
    except (OSError, TimeoutError, ValueError):
        pass  # ok: no usage endpoint at all — report embeds None and
        #     a tenant SLO bound then violates as unmeasured
    return None


def fetch_debugz(base_url: str, out_path: str,
                 timeout_s: float = 10.0) -> Optional[str]:
    """Pull the target's one-shot ``/debugz`` forensics bundle (statusz
    + tracez + metrics + blackbox ring in one doc) and save it to
    ``out_path``.  Called on SLO violation so the evidence of WHY the
    run failed is captured at the moment of failure, not re-derived
    later from a server that has since moved on.  Returns the saved
    path, or None when the target is unreachable or predates /debugz —
    never raises (the SLO verdict itself must not depend on this)."""
    try:
        with urllib.request.urlopen(base_url.rstrip("/") + "/debugz",
                                    timeout=timeout_s) as r:
            doc = json.loads(r.read())
        with open(out_path, "w") as f:
            json.dump(doc, f, indent=1)
        return out_path
    except (OSError, TimeoutError, ValueError):
        return None


def run_closed_loop_http(base_url: str, make_feed, n_requests: int,
                         concurrency: int,
                         timeout_s: float = 60.0,
                         tenant_of: Optional[
                             Callable[[int], str]] = None) -> dict:
    """Closed loop over HTTP: ``concurrency`` synchronous posters
    sharing a ticket counter against a live server."""
    url = base_url.rstrip("/") + "/predict"
    bodies = _encode_bodies(make_feed)
    tickets = iter(range(n_requests))
    ticket_lock = threading.Lock()
    lat, lock = [], threading.Lock()
    counts = {"ok": 0, "shed": 0, "failed": 0}

    def caller():
        while True:
            with ticket_lock:
                i = next(tickets, None)
            if i is None:
                return
            body = bodies[i % len(bodies)]
            t0 = time.monotonic()
            outcome, version = _http_predict(
                url, body, timeout_s,
                tenant=tenant_of(i) if tenant_of else None)
            ms = (time.monotonic() - t0) * 1e3
            with lock:
                counts[outcome] += 1
                if outcome == "ok":
                    lat.append(ms)
                    if version is not None:
                        versions[str(version)] = \
                            versions.get(str(version), 0) + 1

    versions: Dict[str, int] = {}
    threads = [threading.Thread(target=caller, daemon=True)
               for _ in range(concurrency)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t0
    rep = _report("closed", n_requests, counts["ok"], counts["shed"],
                  counts["failed"], wall, lat, None)
    rep["concurrency"] = concurrency
    rep["url"] = base_url
    rep["statusz"] = _http_statusz(base_url)
    if versions:
        rep["weights_versions"] = versions
    return rep


def _http_generate(url: str, body: bytes, timeout_s: float,
                   tenant: Optional[str] = None) -> tuple:
    """One POST /generate -> ('ok'|'shed'|'failed', generated token
    count).  Same 503 taxonomy as :func:`_http_predict`."""
    headers = {"Content-Type": "application/json"}
    if tenant:
        headers[TENANT_HEADER] = tenant
    req = urllib.request.Request(url, data=body, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as r:
            doc = json.loads(r.read())
            return "ok", len(doc.get("tokens") or [])
    except urllib.error.HTTPError as e:
        try:
            payload = e.read()
        except OSError:
            payload = b""  # ok: error body gone with the connection
        if e.code != 503:
            return "failed", 0
        try:
            reason = json.loads(payload).get("reason")
        except (ValueError, AttributeError):
            reason = None
        return (("failed", 0) if reason == "no_ready_replicas"
                else ("shed", 0))
    except (OSError, TimeoutError, ValueError):
        return "failed", 0


def _http_generate_stream(url: str, body: bytes, timeout_s: float,
                          tenant: Optional[str] = None) -> tuple:
    """One streaming POST /generate: read the NDJSON line-by-line,
    stamping each token line's ARRIVAL on this client's clock — the
    honest TTFT/ITL measurement (a whole-response timer cannot see
    token pacing at all).  -> (outcome, token_count, ttft_ms or None,
    [inter-token gap ms, ...])."""
    headers = {"Content-Type": "application/json"}
    if tenant:
        headers[TENANT_HEADER] = tenant
    req = urllib.request.Request(url, data=body, headers=headers)
    t0 = time.monotonic()
    arrivals: List[float] = []
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as r:
            final = None
            for raw in r:
                now = time.monotonic()
                line = raw.strip()
                if not line:
                    continue
                try:
                    doc = json.loads(line)
                except ValueError:
                    return "failed", 0, None, []
                if doc.get("done"):
                    final = doc
                    break
                if "token" in doc:
                    arrivals.append(now)
            if final is None:
                # token count 0 like the non-stream path: a broken
                # stream's partial tokens must not inflate the report's
                # tokens_per_sec vs the identical non-stream run
                return "failed", 0, None, []
            if "error" in final:
                # the stream's final line carries what the non-stream
                # path says with an HTTP status: overloaded = explicit
                # backpressure = shed, anything else failed
                return (("shed" if final.get("error") == "overloaded"
                         else "failed"), 0, None, [])
    except urllib.error.HTTPError as e:
        try:
            payload = e.read()
        except OSError:
            payload = b""  # ok: error body gone with the connection
        if e.code != 503:
            return "failed", 0, None, []
        try:
            reason = json.loads(payload).get("reason")
        except (ValueError, AttributeError):
            reason = None
        return ("failed" if reason == "no_ready_replicas" else "shed",
                0, None, [])
    except (OSError, TimeoutError, ValueError):
        return "failed", 0, None, []
    ttft = (arrivals[0] - t0) * 1e3 if arrivals else None
    gaps = [(b_ - a_) * 1e3 for a_, b_ in zip(arrivals, arrivals[1:])]
    return "ok", len(arrivals), ttft, gaps


def run_closed_loop_generate_http(base_url: str, make_prompt,
                                  n_requests: int, concurrency: int,
                                  timeout_s: float = 120.0,
                                  stream: bool = False,
                                  tenant_of: Optional[
                                      Callable[[int], str]] = None
                                  ) -> dict:
    """Closed loop of ``POST /generate`` against a live server or
    fleet router: the shared-prefix workload drivable end-to-end.  The
    report embeds the target's ``/statusz`` generation block —
    including the paged cache's prefix-hit rate — so the prefix-reuse
    win is observable from the outside.  ``stream=True`` switches to
    the NDJSON streaming contract and measures per-token arrivals
    client-side (the report gains ``ttft_ms``/``inter_token_ms``
    percentile blocks)."""
    url = base_url.rstrip("/") + "/generate"
    tickets = iter(range(n_requests))
    ticket_lock = threading.Lock()
    lat, lock = [], threading.Lock()
    ttfts: List[float] = []
    itls: List[float] = []
    counts = {"ok": 0, "shed": 0, "failed": 0, "tokens": 0}

    def caller():
        while True:
            with ticket_lock:
                i = next(tickets, None)
            if i is None:
                return
            prompt, out_len = make_prompt(i)
            doc = {"prompt": np.asarray(prompt).tolist(),
                   "max_new_tokens": int(out_len)}
            if stream:
                doc["stream"] = True
            body = json.dumps(doc).encode()
            tenant = tenant_of(i) if tenant_of else None
            t0 = time.monotonic()
            if stream:
                outcome, tokens, ttft, gaps = _http_generate_stream(
                    url, body, timeout_s, tenant=tenant)
            else:
                outcome, tokens = _http_generate(url, body, timeout_s,
                                                 tenant=tenant)
                ttft, gaps = None, []
            ms = (time.monotonic() - t0) * 1e3
            with lock:
                counts[outcome] += 1
                counts["tokens"] += tokens
                if outcome == "ok":
                    lat.append(ms)
                    if ttft is not None:
                        ttfts.append(ttft)
                    itls.extend(gaps)

    threads = [threading.Thread(target=caller, daemon=True)
               for _ in range(concurrency)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t0
    rep = _gen_report("closed", n_requests, counts["ok"],
                      counts["shed"], counts["failed"], wall, lat,
                      counts["tokens"], None,
                      ttft_ms=ttfts if stream else None,
                      itl_ms=itls if stream else None)
    rep["concurrency"] = concurrency
    rep["url"] = base_url
    rep["stream"] = stream
    sz = _http_statusz(base_url)
    rep["statusz"] = sz
    gen_stats = None
    if isinstance(sz, dict):
        gen_stats = ((sz.get("engine") or {}).get("generator")
                     or {}).get("stats")
    if isinstance(gen_stats, dict):
        rep["generation"] = gen_stats
        paged = gen_stats.get("paged")
        if isinstance(paged, dict):
            rep["prefix_hit_rate"] = paged.get("prefix_hit_rate")
        spec = gen_stats.get("speculate")
        if isinstance(spec, dict):
            # live acceptance rate from /statusz, like prefix_hit_rate
            # — the measured-or-violation input to check_slo
            rep["spec_acceptance_rate"] = spec.get("acceptance_rate")
    return rep


def run_open_loop_http(base_url: str, make_feed, qps: float,
                       duration_s: float, timeout_s: float = 60.0,
                       collectors: int = 16,
                       traffic: Optional[TrafficShape] = None,
                       tenant_of: Optional[
                           Callable[[int], str]] = None) -> dict:
    """Open loop over HTTP: one pacing thread enqueues request bodies
    on a ``1/qps`` clock; a poster pool sends them.  Arrivals stay on
    the clock regardless of completions (the client-side queue absorbs
    a slow server, so offered load does not back off), though with
    every poster busy the in-flight concurrency caps at the pool
    size.  ``traffic`` shapes the clock (diurnal/bursty) and adds
    per-phase qps/p99/shed to the report."""
    url = base_url.rstrip("/") + "/predict"
    bodies = _encode_bodies(make_feed)
    lat, lock = [], threading.Lock()
    counts = {"ok": 0, "shed": 0, "failed": 0}
    versions: Dict[str, int] = {}
    phases = _PhaseBook() if traffic is not None else None
    pending: queue_mod.Queue = queue_mod.Queue()

    def poster():
        while True:
            item = pending.get()
            if item is None:
                return
            body, t0, phase, tenant = item
            outcome, version = _http_predict(url, body, timeout_s,
                                             tenant=tenant)
            ms = (time.monotonic() - t0) * 1e3
            with lock:
                counts[outcome] += 1
                if outcome == "ok":
                    lat.append(ms)
                    if version is not None:
                        versions[str(version)] = \
                            versions.get(str(version), 0) + 1
                if phases is not None:
                    phases.outcome(phase, outcome,
                                   ms if outcome == "ok" else None,
                                   version=version)

    pool = [threading.Thread(target=poster, daemon=True)
            for _ in range(collectors)]
    for t in pool:
        t.start()

    n = 0
    t0 = time.monotonic()
    for i, phase, now in _arrival_clock(qps, duration_s, traffic):
        n = i + 1
        if phases is not None:
            with lock:
                phases.arrival(phase, now)
        pending.put((bodies[i % len(bodies)], now, phase,
                     tenant_of(i) if tenant_of else None))
    for _ in pool:
        pending.put(None)
    for t in pool:
        t.join()
    wall = time.monotonic() - t0
    rep = _report("open", n, counts["ok"], counts["shed"],
                  counts["failed"], wall, lat, None)
    rep["target_qps"] = qps
    rep["url"] = base_url
    rep["statusz"] = _http_statusz(base_url)
    if versions:
        rep["weights_versions"] = versions
    if traffic is not None:
        rep["traffic"] = traffic.describe()
        rep["phases"] = phases.report()
    return rep


# ---------------------------------------------------------------------------
# SLO assertions
# ---------------------------------------------------------------------------

def check_slo(report: dict, p99_ms: Optional[float] = None,
              shed_pct: Optional[float] = None,
              fail_degraded: bool = False,
              ttft_ms: Optional[float] = None,
              itl_ms: Optional[float] = None,
              expect_version: Optional[int] = None,
              accept_rate: Optional[float] = None,
              hit_rate: Optional[float] = None,
              tenant_p99_ms: Optional[float] = None) -> dict:
    """Evaluate the SLO against one report (recursing into the nested
    closed/open halves of ``--mode both``).  Returns
    ``{"p99_ms_limit", "shed_pct_limit", "violations": [...], "ok"}``;
    a sub-report with zero completed requests is itself a violation
    (a fully-shed run must not pass on a vacuous p99).  With
    ``fail_degraded`` (the ``--sharded`` contract) any replica group
    reporting non-``ok`` status — ``degraded`` failure streak or
    ``missing_shards`` — in the report's ``groups`` block (or the
    embedded ``statusz.groups`` when driving a live server) is a
    violation: a load test that "passed" while a group was down
    measured the wrong capacity.  ``ttft_ms`` / ``itl_ms`` bound the
    generation report's client-measured p99 time-to-first-token and
    inter-token gap — a bound given against a report that never
    measured them (no per-token clock) is itself a violation, never a
    vacuous pass.  ``expect_version`` asserts that EVERY completed
    request carried that ``weights_version`` response header (the
    post-rollout check: a stale version answering means a replica was
    skipped or silently reverted); a report that never observed any
    version against the bound is again a violation, not a vacuous
    pass.  ``accept_rate`` floors the speculative-decoding acceptance
    rate the report embedded from the engine's live stats
    (``spec_acceptance_rate``); a bound given against a report that
    never measured it (speculation off, or a server without the
    stats block) is a violation — never a vacuous pass.  ``hit_rate``
    floors the hot-row cache hit rate a ``--recsys`` run embedded
    from the embedding tier's live stats (in-process engine stats, or
    the target's ``/statusz`` embedding block over HTTP); exactly the
    acceptance-rate precedent — an unmeasured bound is a violation."""
    violations = []

    def _versions(rep: dict, label: str):
        if expect_version is None:
            return
        dist = rep.get("weights_versions")
        if not dist:
            if not rep.get("ok"):
                return  # zero completions already violates via p99
            violations.append(
                f"{label}: --expect-version {expect_version} given "
                f"but no response carried a weights_version header "
                f"(server predates the rollout layer?)")
            return
        stale = {v: n for v, n in dist.items()
                 if v != str(expect_version)}
        if stale:
            violations.append(
                f"{label}: {sum(stale.values())} response(s) carried "
                f"weights_version {sorted(stale)} != expected "
                f"{expect_version}")

    def _one_phase(ph: dict, label: str):
        lat = ph.get("latency_ms") or {}
        if p99_ms is not None:
            p99 = lat.get("p99")
            if p99 is None:
                violations.append(f"{label}: no completed requests — "
                                  f"p99 unmeasurable")
            elif p99 > p99_ms:
                violations.append(f"{label}: p99 {p99}ms > SLO "
                                  f"{p99_ms}ms")
        if shed_pct is not None:
            rate = ph.get("shed_rate")
            if rate is not None and rate * 100.0 > shed_pct:
                violations.append(
                    f"{label}: shed rate {rate * 100.0:.2f}% > SLO "
                    f"{shed_pct}%")

    def _one(rep: dict, label: str):
        lat = rep.get("latency_ms") or {}
        if p99_ms is not None:
            p99 = lat.get("p99")
            if p99 is None:
                violations.append(f"{label}: no completed requests — "
                                  f"p99 unmeasurable")
            elif p99 > p99_ms:
                violations.append(f"{label}: p99 {p99}ms > SLO "
                                  f"{p99_ms}ms")
        if shed_pct is not None:
            rate = rep.get("shed_rate")
            if rate is not None and rate * 100.0 > shed_pct:
                violations.append(
                    f"{label}: shed rate {rate * 100.0:.2f}% > SLO "
                    f"{shed_pct}%")
        for bound, key, label_ in ((ttft_ms, "ttft_ms", "TTFT"),
                                   (itl_ms, "inter_token_ms",
                                    "inter-token")):
            if bound is None:
                continue
            blk = rep.get(key)
            p99 = (blk or {}).get("p99")
            if p99 is None:
                if "latency_ms" in rep:  # a leaf report, not "both"
                    violations.append(
                        f"{label}: no per-token measurements — "
                        f"{label_} p99 unmeasurable (run --generate "
                        f"with token timing / --gen-stream)")
            elif p99 > bound:
                violations.append(f"{label}: {label_} p99 {p99}ms > "
                                  f"SLO {bound}ms")
        if accept_rate is not None:
            rate = rep.get("spec_acceptance_rate")
            if rate is None:
                if "latency_ms" in rep:  # a leaf report, not "both"
                    violations.append(
                        f"{label}: --slo-accept-rate {accept_rate} "
                        f"given but no measured acceptance rate in "
                        f"the report (speculation off, or the server "
                        f"exposes no speculate stats block)")
            elif rate < accept_rate:
                violations.append(
                    f"{label}: spec acceptance rate {rate} < SLO "
                    f"floor {accept_rate}")
        if hit_rate is not None:
            rate = rep.get("hit_rate")
            if rate is None:
                if "latency_ms" in rep:  # a leaf report, not "both"
                    violations.append(
                        f"{label}: --slo-hit-rate {hit_rate} given "
                        f"but no measured hot-row hit rate in the "
                        f"report (not a --recsys run, or the server "
                        f"exposes no embedding stats block)")
            elif rate < hit_rate:
                violations.append(
                    f"{label}: hot-row hit rate {rate} < SLO floor "
                    f"{hit_rate}")
        _versions(rep, label)
        # shaped-traffic runs: the SLO binds in EVERY phase — a crest
        # that sheds half its load must not pass on the run's average
        for name, ph in (rep.get("phases") or {}).items():
            if not ph.get("requests"):
                continue  # a phase the clock never entered
            _one_phase(ph, f"{label}[{name}]")
        if fail_degraded:
            st = rep.get("statusz") or {}
            # in-process reports carry `groups` flat; a live /statusz
            # nests the engine block (statusz.engine.groups)
            groups = (rep.get("groups") or st.get("groups")
                      or (st.get("engine") or {}).get("groups") or [])
            for g in groups:
                status = g.get("status", "ok")
                if status != "ok":
                    violations.append(
                        f"{label}: replica group {g.get('worker')} "
                        f"(mesh {g.get('mesh')}, devices "
                        f"{g.get('devices')}) reports {status}")

    if report.get("mode") == "both":
        _one(report["closed"], "closed")
        _one(report["open"], "open")
    else:
        _one(report, report.get("mode", "report"))
    if tenant_p99_ms is not None:
        # the per-tenant latency SLO binds on the report's embedded
        # /usagez breakdown — one bound, EVERY tenant.  A tenant whose
        # latency was never measured (all sheds, a router-only fetch
        # with no replica histograms, usage disabled) is a violation,
        # never a vacuous pass: an SLO that skips unmeasured tenants
        # is exactly how a noisy neighbor's victims go unnoticed.
        tenants = (report.get("usage") or {}).get("tenants") or {}
        if not tenants:
            violations.append(
                f"usage: --slo-tenant-p99-ms {tenant_p99_ms} given "
                f"but the report embeds no per-tenant usage breakdown "
                f"(FLAGS_usage=0 target, router without replica "
                f"/usagez, or a run without --tenants)")
        for t, blk in sorted(tenants.items()):
            p99 = ((blk or {}).get("request_ms") or {}).get("p99")
            if p99 is None:
                violations.append(
                    f"usage[{t}]: no measured request p99 — tenant "
                    f"latency unmeasurable against SLO "
                    f"{tenant_p99_ms}ms")
            elif p99 > tenant_p99_ms:
                violations.append(
                    f"usage[{t}]: p99 {p99}ms > tenant SLO "
                    f"{tenant_p99_ms}ms")
    out = {"p99_ms_limit": p99_ms, "shed_pct_limit": shed_pct,
           "violations": violations, "ok": not violations}
    if ttft_ms is not None:
        out["ttft_ms_limit"] = ttft_ms
    if itl_ms is not None:
        out["itl_ms_limit"] = itl_ms
    if expect_version is not None:
        out["expect_version"] = expect_version
    if accept_rate is not None:
        out["accept_rate_limit"] = accept_rate
    if hit_rate is not None:
        out["hit_rate_limit"] = hit_rate
    if tenant_p99_ms is not None:
        out["tenant_p99_ms_limit"] = tenant_p99_ms
    if fail_degraded:
        out["fail_degraded"] = True
    return out


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _parse_shapes(specs: List[str]) -> Dict[str, tuple]:
    out = {}
    for spec in specs or []:
        name, _, dims = spec.partition("=")
        out[name] = tuple(int(d) for d in dims.split(",") if d)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--model-dir", help="save_inference_model export")
    src.add_argument("--synthetic", action="store_true",
                     help="in-process MLP (default)")
    src.add_argument("--url", help="drive a live serving HTTP endpoint "
                                   "(http://host:port) instead of an "
                                   "in-process engine; feed shapes come "
                                   "from --shape (default: x=<feat>)")
    ap.add_argument("--shape", action="append", metavar="name=d0,d1",
                    help="per-row feed shape (required with --model-dir)")
    ap.add_argument("--feat", type=int, default=64)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--rows", type=int, default=1,
                    help="rows per request")
    ap.add_argument("--mode", choices=["closed", "open", "both"],
                    default="closed")
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--concurrency", type=int, default=8)
    ap.add_argument("--qps", type=float, default=200.0)
    ap.add_argument("--duration", type=float, default=2.0)
    ap.add_argument("--traffic", choices=TRAFFIC_SHAPES, default=None,
                    help="open-loop offered-load profile: const (fixed "
                         "clock), sine (diurnal), burst (periodic "
                         "spikes), step (capacity cliff); also "
                         "accepted as a bare --shape value.  The "
                         "report gains per-phase qps/p99/shed and the "
                         "SLO is asserted in every phase")
    ap.add_argument("--traffic-amplitude", type=float, default=1.0,
                    help="relative swing: 1.0 doubles the rate at the "
                         "peak")
    ap.add_argument("--traffic-period", type=float, default=None,
                    help="shape period in seconds (default: the whole "
                         "run for sine, duration/4 for burst)")
    ap.add_argument("--traffic-burst-frac", type=float, default=0.25,
                    help="fraction of each burst period spent at the "
                         "spiked rate")
    ap.add_argument("--workers", type=int, default=None)
    ap.add_argument("--max-batch", type=int, default=None)
    ap.add_argument("--max-delay-ms", type=float, default=None)
    ap.add_argument("--queue-cap", type=int, default=None)
    ap.add_argument("--deadline-ms", type=float, default=None)
    ap.add_argument("--sharded", action="store_true",
                    help="with --url: the target is a mesh-sharded "
                         "fleet, and the SLO check FAILS when any "
                         "replica group in its live /statusz reports "
                         "degraded or missing shards.  In process it "
                         "raises NotImplementedError: mesh-sharded "
                         "serving is not ported yet (ROADMAP.md queue 1 "
                         "item 9)")
    ap.add_argument("--groups", type=int, default=None,
                    help="dp replica-group count (sharded mode)")
    ap.add_argument("--mp", type=int, default=None,
                    help="model-parallel width per group (sharded)")
    ap.add_argument("--ep", type=int, default=None,
                    help="expert-parallel width per group (sharded)")
    ap.add_argument("--mesh", default=None, metavar="dp=4,mp=2",
                    help="serving-mesh spec (sharded mode; explicit "
                         "--groups/--mp/--ep win)")
    ap.add_argument("--recsys", action="store_true",
                    help="drive the Wide&Deep recsys path: POST "
                         "zipfian sparse_ids + dense_x bodies at a "
                         "--url target; the report embeds the live "
                         "hot-row hit rate (--slo-hit-rate floors it).  "
                         "In process it raises NotImplementedError: the "
                         "embedding tier is not ported yet (ROADMAP.md "
                         "queue 1 item 8)")
    ap.add_argument("--rec-slots", type=int, default=26,
                    help="sparse slots per example (Criteo: 26)")
    ap.add_argument("--rec-dense", type=int, default=13,
                    help="dense features per example (Criteo: 13)")
    ap.add_argument("--rec-vocab", type=int, default=100000,
                    help="embedding vocab (rows in the sharded table)")
    ap.add_argument("--rec-dim", type=int, default=8,
                    help="deep embedding dim (the wide column rides "
                         "fused in the same table)")
    ap.add_argument("--rec-zipf", type=float, default=1.2,
                    help="zipf skew of the sparse-id distribution: "
                         "~1.2 = recommender-hot (cache-friendly), "
                         "0 = uniform (cache-hostile)")
    ap.add_argument("--rec-hidden", default="64,32",
                    help="comma-separated deep MLP widths "
                         "(in-process --recsys)")
    ap.add_argument("--rec-shards", type=int, default=None,
                    help="embedding shard count (default "
                         "FLAGS_embedding_shards; 0 = one per device)")
    ap.add_argument("--rec-cache-rows", type=int, default=None,
                    help="hot-row cache capacity (default "
                         "FLAGS_embedding_cache_rows)")
    ap.add_argument("--generate", action="store_true",
                    help="drive a slot-based GenerationEngine "
                         "(autoregressive decode) instead of the "
                         "one-shot engine; --gen-* flags size it")
    ap.add_argument("--gen-vocab", type=int, default=128)
    ap.add_argument("--gen-hidden", type=int, default=64)
    ap.add_argument("--gen-layers", type=int, default=2)
    ap.add_argument("--gen-heads", type=int, default=4)
    ap.add_argument("--gen-kv-heads", type=int, default=None)
    ap.add_argument("--gen-intermediate", type=int, default=128)
    ap.add_argument("--gen-slots", type=int, default=4,
                    help="decode-slot grid size")
    ap.add_argument("--gen-max-seq", type=int, default=64,
                    help="per-slot KV-cache capacity")
    ap.add_argument("--gen-prompt-min", type=int, default=4)
    ap.add_argument("--gen-prompt-max", type=int, default=16)
    ap.add_argument("--gen-out-mean", type=float, default=8.0,
                    help="mean of the output-length distribution")
    ap.add_argument("--gen-out-max", type=int, default=32,
                    help="per-request output-length clamp")
    ap.add_argument("--gen-out-dist", choices=("geometric", "bimodal"),
                    default="geometric",
                    help="output-length distribution: memoryless "
                         "geometric, or a 75/25 short/long chat-style "
                         "mix at the same mean (heavier tail)")
    ap.add_argument("--gen-static", action="store_true",
                    help="FIFO head-run (batch drain) scheduling "
                         "instead of continuous slot reclaim")
    ap.add_argument("--gen-prompt-dist",
                    choices=("uniform", "shared-prefix", "mixed"),
                    default="uniform",
                    help="prompt shape: fully random; a fixed "
                         "--gen-prefix-tokens system-prompt header + "
                         "random tail (the chat workload where the "
                         "paged engine's prefix index skips the "
                         "header's prefill); or 'mixed' — the bimodal "
                         "long-prompt/short-chat blend (--gen-long-"
                         "frac long prompts of ~--gen-long-tokens, "
                         "the rest short chat turns) that "
                         "disaggregated prefill/decode exists to fix")
    ap.add_argument("--gen-prefix-tokens", type=int, default=32,
                    help="shared-prefix mode: tokens in the common "
                         "header every prompt starts with")
    ap.add_argument("--gen-long-frac", type=float, default=0.25,
                    help="mixed mode: fraction of prompts that are "
                         "long (tunable burst ratio)")
    ap.add_argument("--gen-long-tokens", type=int, default=0,
                    help="mixed mode: long-prompt length (drawn "
                         "uniform in [3/4*N, N]); default 0 = the "
                         "in-process engine's max prompt length, or "
                         "half of --gen-max-seq for a remote --url "
                         "target")
    ap.add_argument("--gen-paged", action="store_true",
                    help="block-paged KV cache (page pool + per-slot "
                         "block tables + prefix reuse) instead of the "
                         "dense per-slot reservation "
                         "(FLAGS_serving_paged for a live replica)")
    ap.add_argument("--gen-page-tokens", type=int, default=None,
                    help="paged: tokens per KV page (default "
                         "FLAGS_serving_kv_page_tokens)")
    ap.add_argument("--gen-pages", type=int, default=None,
                    help="paged: physical pages in the pool (default "
                         "auto-size to the dense capacity)")
    ap.add_argument("--gen-prefill-chunk", type=int, default=None,
                    help="paged: chunked-prefill slice size (0 = "
                         "whole-prompt prefill; default "
                         "FLAGS_serving_prefill_chunk)")
    ap.add_argument("--gen-speculate", action="store_true",
                    help="speculative decoding on the in-process "
                         "engine (n-gram self-drafts, one-chunk "
                         "verify, bit-exact acceptance; implies "
                         "--gen-paged) — the report embeds the "
                         "measured acceptance rate")
    ap.add_argument("--gen-spec-tokens", type=int, default=None,
                    help="speculative: max draft tokens per verify "
                         "(default FLAGS_serving_spec_tokens)")
    ap.add_argument("--out", help="also write the JSON report here")
    ap.add_argument("--slo-p99-ms", type=float, default=None,
                    help="assert p99 latency <= this (ms); violation "
                         "exits 1 with an 'slo' block in the report")
    ap.add_argument("--slo-shed-pct", type=float, default=None,
                    help="assert shed rate <= this (percent); "
                         "violation exits 1")
    ap.add_argument("--slo-ttft-ms", type=float, default=None,
                    help="assert client-measured p99 time-to-first-"
                         "token <= this (ms); needs a --generate run "
                         "with per-token timing (in-process loops "
                         "always have it; --url needs --gen-stream)")
    ap.add_argument("--slo-itl-ms", type=float, default=None,
                    help="assert client-measured p99 inter-token gap "
                         "<= this (ms); same measurement requirement "
                         "as --slo-ttft-ms")
    ap.add_argument("--gen-stream", action="store_true",
                    help="--url --generate: use the NDJSON streaming "
                         "/generate contract and record each token's "
                         "client-side arrival (enables ttft_ms / "
                         "inter_token_ms report blocks over HTTP)")
    ap.add_argument("--slo-accept-rate", type=float, default=None,
                    help="assert the speculative-decoding acceptance "
                         "rate >= this floor (0..1), read from the "
                         "report's embedded engine stats; a run with "
                         "no measured acceptance rate (speculation "
                         "off) violates too, never a vacuous pass")
    ap.add_argument("--slo-hit-rate", type=float, default=None,
                    help="assert the hot-row cache hit rate >= this "
                         "floor (0..1), read from the --recsys "
                         "report's embedded embedding stats (live "
                         "/statusz with --url); a run with no "
                         "measured hit rate violates too, never a "
                         "vacuous pass")
    ap.add_argument("--tenants", type=int, default=0,
                    help="multi-tenant run: assign each request one of "
                         "N tenant identities (tenant-00..) via the "
                         "X-PaddleTPU-Tenant header (--url) or the "
                         "submit(tenant=) kwarg (in-process); the "
                         "report embeds the target's /usagez per-"
                         "tenant breakdown")
    ap.add_argument("--tenant-dist", choices=("zipf", "uniform"),
                    default="zipf",
                    help="tenant traffic mix: zipf concentrates most "
                         "load on tenant-00 (noisy-neighbor shape), "
                         "uniform spreads it evenly")
    ap.add_argument("--slo-tenant-p99-ms", type=float, default=None,
                    help="assert EVERY tenant's p99 request latency "
                         "<= this (ms), read from the report's "
                         "embedded /usagez breakdown; a tenant with "
                         "no measured latency violates too, never a "
                         "vacuous pass")
    ap.add_argument("--expect-version", type=int, default=None,
                    help="assert every completed request carried this "
                         "weights_version response header (the post-"
                         "rollout convergence check); a run that never "
                         "observed the header violates too, never a "
                         "vacuous pass")
    # the one flag the reference lacks: the port's entry points run on
    # the card unless the caller asks for the CPU
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the in-process engine runs: 'cuda' "
                         "(cuda:0, the default) or 'cpu'; with no GPU "
                         "and no --device cpu the run raises.  Unused "
                         "with --url")
    args = ap.parse_args(argv)
    # `--shape sine` convenience: a bare traffic-shape name given via
    # --shape (which otherwise takes name=d0,d1 feed specs) selects
    # the traffic profile — the spelling the fleet runbooks use
    if args.shape:
        feeds = []
        for spec in args.shape:
            if spec in TRAFFIC_SHAPES and "=" not in spec:
                args.traffic = spec
            else:
                feeds.append(spec)
        args.shape = feeds
    traffic = None
    if args.traffic:
        traffic = TrafficShape(args.traffic, args.qps, args.duration,
                               amplitude=args.traffic_amplitude,
                               period_s=args.traffic_period,
                               burst_frac=args.traffic_burst_frac)
    tenant_of = tenant_picker(args.tenants, args.tenant_dist) \
        if args.tenants > 0 else None
    if args.sharded and args.generate:
        # the generate branch would silently drive a plain single-mesh
        # GenerationEngine while the report claimed a sharded health
        # check ran — refuse instead (GenerationEngine(mesh=...) is the
        # in-process API for mesh-partitioned generation)
        ap.error("--sharded cannot combine with --generate")
    if traffic is not None and args.traffic != "const":
        # shapes only exist on the one-shot open loop: running anyway
        # would print a report with no phases block while the operator
        # believes the crest was survived — refuse instead of
        # silently measuring a constant clock
        if args.generate:
            ap.error("--traffic shapes are not supported by the "
                     "--generate loops yet; drop --traffic or "
                     "--generate")
        if args.mode == "closed":
            ap.error("--traffic shapes apply to the open loop; use "
                     "--mode open or --mode both")

    def finish(report: dict) -> int:
        rc = 0
        if args.tenants or args.slo_tenant_p99_ms is not None:
            # embed the per-tenant attribution next to the latency
            # report — check_slo's tenant bound reads it, operators
            # diff it against the client-side mix
            if args.url:
                report["usage"] = fetch_usagez(args.url)
            else:
                try:
                    from paddle_tpu_torch.serving import usage as usage_mod
                    led = usage_mod.peek_ledger()
                    report["usage"] = led.usagez() \
                        if led is not None else None
                except Exception:  # noqa: BLE001 — report must print
                    report["usage"] = None
        if args.slo_p99_ms is not None or args.slo_shed_pct is not None \
                or args.slo_ttft_ms is not None \
                or args.slo_itl_ms is not None or args.sharded \
                or args.expect_version is not None \
                or args.slo_accept_rate is not None \
                or args.slo_hit_rate is not None \
                or args.slo_tenant_p99_ms is not None:
            slo = check_slo(report, args.slo_p99_ms, args.slo_shed_pct,
                            fail_degraded=args.sharded,
                            ttft_ms=args.slo_ttft_ms,
                            itl_ms=args.slo_itl_ms,
                            expect_version=args.expect_version,
                            accept_rate=args.slo_accept_rate,
                            hit_rate=args.slo_hit_rate,
                            tenant_p99_ms=args.slo_tenant_p99_ms)
            report["slo"] = slo
            if not slo["ok"]:
                for v in slo["violations"]:
                    print(f"SLO VIOLATION: {v}", file=sys.stderr)
                rc = 1
                if args.url:
                    # grab the target's forensics bundle while the
                    # violating state is still live on the server
                    base = (os.path.splitext(args.out)[0]
                            if args.out else
                            os.path.join(tempfile.gettempdir(),
                                         f"loadgen-{os.getpid()}"))
                    path = fetch_debugz(args.url,
                                        base + ".debugz.json")
                    slo["debugz"] = path
                    if path:
                        print(f"SLO VIOLATION: /debugz bundle saved "
                              f"to {path}", file=sys.stderr)
        text = json.dumps(report)
        print(text)
        if args.out:
            with open(args.out, "w") as f:
                f.write(text + "\n")
        return rc

    if args.url and args.generate:
        # remote generation target (replica or fleet router): paced
        # POST /generate; prefix-hit rate rides in from /statusz
        if args.mode != "closed":
            ap.error("--url --generate supports --mode closed only")
        make_prompt = prompt_maker(
            args.gen_vocab, args.gen_prompt_min, args.gen_prompt_max,
            args.gen_out_mean, args.gen_out_max,
            dist=args.gen_out_dist, prompt_dist=args.gen_prompt_dist,
            prefix_tokens=args.gen_prefix_tokens
            if args.gen_prompt_dist == "shared-prefix" else 0,
            long_frac=args.gen_long_frac,
            # remote default: half the replica's cache capacity
            # (--gen-max-seq describes the target) — guaranteed under
            # its largest prefill bucket, unlike a prompt_max multiple
            long_tokens=args.gen_long_tokens
            or max(args.gen_prompt_max + 1, args.gen_max_seq // 2))
        report = run_closed_loop_generate_http(
            args.url, make_prompt, args.requests, args.concurrency,
            stream=args.gen_stream, tenant_of=tenant_of)
        return finish(report)

    if args.url:
        # remote target: no model, no engine — just paced HTTP traffic
        if args.recsys:
            make_feed = recsys_feed_maker(
                args.rec_slots, args.rec_dense, args.rec_vocab,
                zipf=args.rec_zipf, rows=args.rows)

            def _with_hit_rate(rep: dict) -> dict:
                # live hot-row hit rate off the target's /statusz
                # embedding block — the measurement --slo-hit-rate
                # floors (a router target exposes no embedding block;
                # the floor then violates, never passes vacuously)
                emb = ((rep.get("statusz") or {}).get("engine")
                       or {}).get("embedding") or {}
                if emb.get("hit_rate") is not None:
                    rep["hit_rate"] = emb["hit_rate"]
                    rep["embedding"] = emb
                return rep
        else:
            shapes = _parse_shapes(args.shape) or {"x": (args.feat,)}
            make_feed = feed_maker(shapes, rows=args.rows)

            def _with_hit_rate(rep: dict) -> dict:
                return rep
        if args.mode == "both":
            report = {"mode": "both",
                      "closed": _with_hit_rate(run_closed_loop_http(
                          args.url, make_feed, args.requests,
                          args.concurrency, tenant_of=tenant_of)),
                      "open": _with_hit_rate(run_open_loop_http(
                          args.url, make_feed, args.qps,
                          args.duration, traffic=traffic,
                          tenant_of=tenant_of))}
        elif args.mode == "closed":
            report = _with_hit_rate(run_closed_loop_http(
                args.url, make_feed, args.requests, args.concurrency,
                tenant_of=tenant_of))
        else:
            report = _with_hit_rate(run_open_loop_http(
                args.url, make_feed, args.qps, args.duration,
                traffic=traffic, tenant_of=tenant_of))
        return finish(report)

    if args.sharded or args.groups or args.mp or args.ep or args.mesh:
        # the reference drives a ReplicaGroupEngine here (:1994)
        raise NotImplementedError(
            "in-process --sharded / --groups / --mp / --ep / --mesh: "
            "mesh-sharded serving is not ported yet (ROADMAP.md queue 1 "
            "item 9); --url drives a sharded target over HTTP")
    if args.recsys:
        # the reference builds the embedding tier here (:1916)
        raise NotImplementedError(
            "in-process --recsys: the embedding tier is not ported yet "
            "(ROADMAP.md queue 1 item 8); --url drives a recsys target "
            "over HTTP")

    if args.generate:
        from paddle_tpu_torch.serving import GenerationEngine

        model = dict(vocab_size=args.gen_vocab, hidden=args.gen_hidden,
                     num_layers=args.gen_layers, num_heads=args.gen_heads,
                     num_kv_heads=args.gen_kv_heads,
                     intermediate=args.gen_intermediate)
        paged_kw = {}
        if args.gen_paged or args.gen_speculate:
            # speculation verifies against the slot's pages: it
            # implies the paged cache
            paged_kw = dict(paged=True,
                            page_tokens=args.gen_page_tokens,
                            num_pages=args.gen_pages,
                            prefill_chunk=args.gen_prefill_chunk)
        if args.gen_speculate:
            paged_kw.update(speculate=True,
                            spec_tokens=args.gen_spec_tokens)
        gen = GenerationEngine(
            model, num_slots=args.gen_slots, max_seq_len=args.gen_max_seq,
            max_new_tokens=args.gen_out_max,
            continuous=not args.gen_static,
            queue_cap=args.queue_cap or 4 * args.requests,
            deadline_ms=args.deadline_ms or 600000.0,
            device=args.device, **paged_kw)
        gen.warmup()
        shared = args.gen_prompt_dist == "shared-prefix"
        prefix = args.gen_prefix_tokens if shared else 0
        tail_max = min(args.gen_prompt_max,
                       max(1, gen.max_prompt_len - prefix))
        make_prompt = prompt_maker(args.gen_vocab, args.gen_prompt_min,
                                   tail_max,
                                   args.gen_out_mean, args.gen_out_max,
                                   dist=args.gen_out_dist,
                                   prompt_dist=args.gen_prompt_dist,
                                   prefix_tokens=prefix,
                                   long_frac=args.gen_long_frac,
                                   long_tokens=min(
                                       args.gen_long_tokens
                                       or gen.max_prompt_len,
                                       gen.max_prompt_len))
        try:
            if args.mode == "both":
                report = {"mode": "both",
                          "closed": run_closed_loop_generate(
                              gen, make_prompt, args.requests,
                              args.concurrency, tenant_of=tenant_of),
                          "open": run_open_loop_generate(
                              gen, make_prompt, args.qps,
                              args.duration, tenant_of=tenant_of)}
            elif args.mode == "closed":
                report = run_closed_loop_generate(gen, make_prompt,
                                                  args.requests,
                                                  args.concurrency,
                                                  tenant_of=tenant_of)
            else:
                report = run_open_loop_generate(gen, make_prompt,
                                                args.qps, args.duration,
                                                tenant_of=tenant_of)
        finally:
            gen.close()
        return finish(report)

    from paddle_tpu_torch.serving import ServingEngine

    if args.model_dir:
        from paddle_tpu_torch.inference import Predictor
        shapes = _parse_shapes(args.shape)
        if not shapes:
            ap.error("--model-dir needs at least one --shape name=dims")
        predictor = Predictor(args.model_dir, device=args.device)
    else:
        predictor, shapes = build_synthetic(args.feat, args.hidden,
                                            args.depth, device=args.device)
    engine_kw = dict(max_batch=args.max_batch,
                     max_delay_ms=args.max_delay_ms,
                     queue_cap=args.queue_cap,
                     deadline_ms=args.deadline_ms,
                     warmup_shapes=shapes)
    engine = ServingEngine(predictor, workers=args.workers, **engine_kw)
    make_feed = feed_maker(shapes, rows=args.rows)

    try:
        if args.mode == "both":
            report = {"mode": "both",
                      "closed": run_closed_loop(engine, make_feed,
                                                args.requests,
                                                args.concurrency,
                                                tenant_of=tenant_of),
                      "open": run_open_loop(engine, make_feed, args.qps,
                                            args.duration,
                                            traffic=traffic,
                                            tenant_of=tenant_of)}
        elif args.mode == "closed":
            report = run_closed_loop(engine, make_feed, args.requests,
                                     args.concurrency,
                                     tenant_of=tenant_of)
        else:
            report = run_open_loop(engine, make_feed, args.qps,
                                   args.duration, traffic=traffic,
                                   tenant_of=tenant_of)
    finally:
        engine.close()
        # the base predictor's compiled steps (graphs and pools on the
        # card) go with the run; the reference leaves them to the GC
        predictor.close()

    return finish(report)


if __name__ == "__main__":
    sys.exit(main())
