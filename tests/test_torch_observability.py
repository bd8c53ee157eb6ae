"""Twins of the JAX package's observability tests for the modules the
port copies or rewrites: telemetry.py (spans, trace ids across threads,
histograms with exemplars, Prometheus text), the stat monitor,
blackbox.py (rings, dumps, the never-raise discipline), observatory.py
(the refcounted sampler, torch.profiler captures, busy / disabled),
serving/usage.py (the ledger's exactness, conservation, determinism and
memory bound; zero work when off; a live ServingEngine conserving
against its totals), and costmodel.py (the H100 peaks, no TPU row,
manifests counted from a program's ops).  Each twin is the reference
test's body run against ``paddle_tpu_torch``; the engine tests serve the
port loadgen's MLP (``paddle_tpu_torch.tools.serving_loadgen``).
"""
import importlib.util
import json
import os
import re
import threading

import numpy as np
import pytest

import paddle_tpu_torch as pt
from paddle_tpu_torch import (blackbox, costmodel, fault, observatory,
                              telemetry)
from paddle_tpu_torch.monitor import stat_add, stat_get
from paddle_tpu_torch.serving import ServingEngine, usage
from paddle_tpu_torch.serving.usage import (COST_FIELDS, OTHER_TENANT,
                                            UsageLedger, split_ints)
from paddle_tpu_torch.tools import serving_loadgen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _defaults():
    telemetry.clear_spans()
    blackbox.reset()
    fault.reset()
    yield
    pt.set_flags({"FLAGS_telemetry": True, "FLAGS_metrics_dir": "",
                  "FLAGS_metrics_interval": 10.0,
                  "FLAGS_trace_buffer_size": 4096,
                  "FLAGS_histogram_buckets": "",
                  "FLAGS_fault_inject": "", "FLAGS_blackbox": True,
                  "FLAGS_blackbox_events": 256,
                  "FLAGS_blackbox_requests": 64,
                  "FLAGS_hbm_sample_interval": 0.25, "FLAGS_usage": True,
                  "FLAGS_device_peak_flops": 0.0,
                  "FLAGS_device_peak_bw": 0.0})
    fault.reset()
    blackbox.reset()
    telemetry.clear_spans()


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_torch_obs_tests", os.path.join(REPO, "tools",
                                                f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tiny_engine():
    pred, _shapes = serving_loadgen.build_synthetic(4, 8, 1, device="cpu")
    eng = ServingEngine(pred, workers=1)
    eng.warmup({"x": (4,)})
    return eng


def test_nested_spans_reconstruct_the_tree():
    telemetry.clear_spans()
    with telemetry.trace_span("root", step=7):
        with telemetry.trace_span("child_a"):
            with telemetry.trace_span("leaf"):
                pass
        with telemetry.trace_span("child_b"):
            pass
    spans = telemetry.get_spans()
    # completion order: innermost first
    assert [s.name for s in spans] == ["leaf", "child_a", "child_b",
                                       "root"]
    assert all(s.duration_ms is not None and s.duration_ms >= 0
               for s in spans)
    roots = telemetry.span_tree(spans)
    assert len(roots) == 1 and roots[0]["span"].name == "root"
    assert roots[0]["span"].attrs == {"step": 7}
    kids = [n["span"].name for n in roots[0]["children"]]
    assert kids == ["child_a", "child_b"]
    grand = roots[0]["children"][0]["children"]
    assert [n["span"].name for n in grand] == ["leaf"]
    # the parent encloses the child on the monotonic clock
    root, leaf = spans[3], spans[0]
    assert root.start <= leaf.start and root.end >= leaf.end


def test_spans_on_other_threads_root_separately():
    telemetry.clear_spans()

    def worker():
        with telemetry.trace_span("thread_root"):
            pass

    with telemetry.trace_span("main_root"):
        t = threading.Thread(target=worker)
        t.start()
        t.join()
    by_name = {s.name: s for s in telemetry.get_spans()}
    assert by_name["thread_root"].parent_id is None  # not under main_root
    assert by_name["main_root"].parent_id is None
    assert by_name["thread_root"].tid != by_name["main_root"].tid


def test_span_end_closes_abandoned_children():
    telemetry.clear_spans()
    outer = telemetry.span_begin("outer")
    telemetry.span_begin("inner_abandoned")  # never explicitly ended
    telemetry.span_end(outer)
    spans = telemetry.get_spans()
    assert {s.name for s in spans} == {"outer", "inner_abandoned"}
    assert all(s.end is not None for s in spans)
    # next root does not parent under a leaked span
    with telemetry.trace_span("fresh"):
        pass
    assert telemetry.get_spans()[-1].parent_id is None


def test_span_context_reparents_across_threads():
    """The Dapper contract: a SpanContext handed across a thread hop
    keeps the child in the SAME trace (trace_id + parent linkage),
    unlike the thread-local stack which roots per thread."""
    telemetry.clear_spans()
    captured = {}

    with telemetry.trace_span("request_root", rows=2):
        ctx = telemetry.current_span()
        assert isinstance(ctx, telemetry.SpanContext)

        def worker():
            with telemetry.trace_span("hop_child", parent=ctx):
                captured["inner"] = telemetry.current_span()

        t = threading.Thread(target=worker)
        t.start()
        t.join()
    by = {s.name: s for s in telemetry.get_spans()}
    root, child = by["request_root"], by["hop_child"]
    assert child.trace_id == root.trace_id == ctx.trace_id
    assert child.parent_id == root.span_id
    assert child.tid != root.tid
    # the hop child was the worker thread's current span (same trace)
    assert captured["inner"].trace_id == root.trace_id
    # a root mints a fresh id; another root gets a different one
    with telemetry.trace_span("other_root"):
        pass
    assert telemetry.get_spans()[-1].trace_id != root.trace_id


def test_detached_span_cross_thread_end_and_links():
    """Detached spans stay off the thread-local stack (an unrelated
    same-thread span must not parent under them) and may be ended from
    another thread; links record fan-in to other traces."""
    telemetry.clear_spans()
    root = telemetry.span_begin("req", detached=True)
    with telemetry.trace_span("unrelated"):
        pass
    assert telemetry.get_spans()[-1].parent_id is None  # not under req

    t = threading.Thread(target=telemetry.span_end, args=(root,))
    t.start()
    t.join()
    assert root.end is not None
    assert telemetry.get_spans()[-1] is root
    n = len(telemetry.get_spans())
    telemetry.span_end(root)  # double-end: no duplicate record
    assert len(telemetry.get_spans()) == n

    batch = telemetry.span_begin("batch", links=[root.context()],
                                 detached=True)
    telemetry.span_end(batch)
    assert batch.trace_id != root.trace_id  # its own trace...
    assert batch.links[0] == root.context()  # ...linked to the request
    ev = batch.to_event()
    assert ev["args"]["links"][0]["trace_id"] == root.trace_id
    assert ev["args"]["trace_id"] == batch.trace_id


def test_cross_thread_end_of_stacked_span_records_once():
    """A stacked span ended from ANOTHER thread keeps its recorded end
    and is not re-recorded (with a different duration) when its own
    thread later unwinds the stack past it."""
    telemetry.clear_spans()
    outer = telemetry.span_begin("outer")
    inner = telemetry.span_begin("inner")
    t = threading.Thread(target=telemetry.span_end, args=(inner,))
    t.start()
    t.join()
    end0 = inner.end
    assert end0 is not None
    telemetry.span_end(outer)  # unwind pops inner off this stack too
    names = [s.name for s in telemetry.get_spans()]
    assert names.count("inner") == 1 and names.count("outer") == 1
    assert inner.end == end0  # duration untouched by the unwind


def test_span_ring_is_bounded():
    pt.set_flags({"FLAGS_trace_buffer_size": 8})
    telemetry.clear_spans()  # re-reads the capacity flag
    for i in range(20):
        with telemetry.trace_span(f"s{i}"):
            pass
    spans = telemetry.get_spans()
    assert len(spans) == 8
    assert [s.name for s in spans] == [f"s{i}" for i in range(12, 20)]


def test_histogram_percentiles_on_known_distribution():
    # decade buckets make 1..100 land exactly on interpolated percentiles
    h = telemetry.Histogram("t_ms", buckets=tuple(
        float(b) for b in range(10, 101, 10)))
    for v in range(1, 101):
        h.observe(float(v))
    s = h.summary()
    assert s["count"] == 100 and s["sum"] == 5050.0
    assert s["min"] == 1.0 and s["max"] == 100.0 and s["mean"] == 50.5
    assert abs(s["p50"] - 50.0) < 1e-6
    assert abs(s["p95"] - 95.0) < 1e-6
    assert abs(s["p99"] - 99.0) < 1e-6
    # overflow bucket: values beyond the last bound still count
    h.observe(1e9)
    assert h.summary()["count"] == 101 and h.summary()["max"] == 1e9
    cum = h.cumulative_buckets()
    assert cum[-1][1] == 101 and cum[-1][0] == float("inf")
    assert [c for _, c in cum] == sorted(c for _, c in cum)  # monotonic


def test_histogram_constant_distribution_is_exact():
    h = telemetry.Histogram("c")
    for _ in range(10):
        h.observe(500.0)
    s = h.summary()
    assert s["p50"] == s["p95"] == s["p99"] == 500.0


def test_histogram_overflow_censoring_and_exemplars():
    """Percentile estimates landing in the +Inf overflow bucket report
    the top bucket edge marked censored (a floor, not an extrapolated
    guess); the overflow population is exposed; trace_id'd observations
    surface as slowest-first exemplars."""
    h = telemetry.Histogram("cens_ms", buckets=(1.0, 2.0, 4.0))
    for i, v in enumerate((0.5, 1.5, 1.7, 200.0, 300.0)):
        h.observe(v, trace_id=f"t{i}")
    assert h.overflow_count() == 2
    s = h.summary()
    assert s["overflow"] == 2
    # p99 (and p95) fall in the overflow bucket: value = top edge, not
    # something interpolated toward max=300
    assert s["p99"] == 4.0 and s["p95"] == 4.0
    assert "p99" in s["censored"] and "p95" in s["censored"]
    assert "p50" not in s["censored"]  # the median IS finite here
    v, cens = h.percentile(99, with_censor=True)
    assert v == 4.0 and cens
    v, cens = h.percentile(10, with_censor=True)
    assert v <= 1.0 and not cens
    # exemplars: slowest recent first, carrying their trace ids
    ex = s["exemplars"]
    assert [e["trace_id"] for e in ex[:3]] == ["t4", "t3", "t2"]
    assert ex[0]["value"] == 300.0
    # a histogram with no censored percentiles has no marker key
    ok = telemetry.Histogram("fine_ms", buckets=(1.0, 1000.0))
    ok.observe(3.0)
    assert "censored" not in ok.summary()


def test_histogram_custom_buckets_flag():
    pt.set_flags({"FLAGS_histogram_buckets": "5, 10,20"})
    h = telemetry.Histogram("flagged_ms")
    assert h.buckets == (5.0, 10.0, 20.0)
    # explicit buckets still win over the flag
    h2 = telemetry.Histogram("explicit_ms", buckets=(1.0, 2.0))
    assert h2.buckets == (1.0, 2.0)
    # malformed spec falls back to the defaults instead of raising
    pt.set_flags({"FLAGS_histogram_buckets": "not,numbers"})
    h3 = telemetry.Histogram("fallback_ms")
    assert h3.buckets == telemetry.DEFAULT_BUCKETS_MS
    pt.set_flags({"FLAGS_histogram_buckets": ""})
    assert telemetry.Histogram("default_ms").buckets == \
        telemetry.DEFAULT_BUCKETS_MS


def test_gauge_and_timer():
    g = telemetry.metrics.gauge("test_gauge")
    g.set(3.5)
    assert g.get() == 3.5
    g.add(1.5)
    assert g.get() == 5.0
    with telemetry.metrics.timer("test_timer_ms").time():
        pass
    s = telemetry.metrics.histogram("test_timer_ms").summary()
    assert s["count"] == 1 and s["min"] >= 0.0
    snap = telemetry.metrics.snapshot()
    assert snap["gauges"]["test_gauge"] == 5.0
    assert snap["histograms"]["test_timer_ms"]["count"] == 1
    assert "executor_run_steps" in snap["counters"]


def test_prometheus_text_wellformed():
    telemetry.metrics.gauge("prom_gauge").set(2.25)
    telemetry.metrics.histogram("prom_hist_ms").observe(3.0)
    text = telemetry.prometheus_text()
    line_re = re.compile(
        r'^[a-zA-Z_][a-zA-Z0-9_]*(\{le="[^"]+"\})? -?[0-9.eE+inf-]+$')
    for line in text.strip().splitlines():
        assert line.startswith("# ") or line_re.match(line), line
    assert "# HELP paddle_tpu_prom_gauge " in text
    assert "# TYPE paddle_tpu_prom_gauge gauge" in text
    assert "# TYPE paddle_tpu_prom_hist_ms histogram" in text
    assert 'paddle_tpu_prom_hist_ms_bucket{le="+Inf"}' in text
    assert "paddle_tpu_prom_hist_ms_count 1" in text
    assert "# TYPE paddle_tpu_executor_run_steps counter" in text


def test_prometheus_text_passes_strict_validator():
    """The registry's own rendering must satisfy the strict exposition
    validator that tier-1 also runs against a live /metrics scrape."""
    csc = _load_tool("check_stat_catalog")
    telemetry.metrics.gauge("strict_gauge").set(1.0)
    telemetry.metrics.histogram("strict_hist_ms").observe(2.0)
    errs = csc.validate_exposition(telemetry.prometheus_text())
    assert errs == [], errs[:10]


def test_monitor_publish_atomic_under_concurrent_writers():
    """reset=True publishes must conserve every increment: sum of all
    published snapshots + the residual equals the writes."""
    from paddle_tpu_torch.monitor import monitor, stat_add
    N_THREADS, N_INC = 4, 2000
    monitor.get("race_stat").reset()

    def writer():
        for _ in range(N_INC):
            stat_add("race_stat")

    threads = [threading.Thread(target=writer) for _ in range(N_THREADS)]
    for t in threads:
        t.start()
    harvested = 0
    while any(t.is_alive() for t in threads):
        harvested += dict(monitor.publish(reset=True)).get("race_stat", 0)
    for t in threads:
        t.join()
    harvested += dict(monitor.publish(reset=True)).get("race_stat", 0)
    assert harvested == N_THREADS * N_INC


def test_stat_registry_singleton_identity():
    from paddle_tpu_torch.monitor import StatRegistry, monitor
    assert StatRegistry.instance() is monitor
    assert StatRegistry.instance() is StatRegistry.instance()


def test_telemetry_off_then_on_round_trip(tmp_path):
    pt.set_flags({"FLAGS_telemetry": 0})
    with telemetry.trace_span("invisible"):
        pass
    assert telemetry.get_spans() == []
    pt.set_flags({"FLAGS_telemetry": 1})
    with telemetry.trace_span("visible"):
        pass
    assert [s.name for s in telemetry.get_spans()] == ["visible"]


def test_event_ring_bounded_and_evicts_oldest():
    pt.set_flags({"FLAGS_blackbox_events": 4})
    blackbox.reset()  # capacity is read at recorder build
    for i in range(10):
        blackbox.record_event("tick", i=i)
    ring = blackbox.snapshot()
    assert ring["enabled"] is True
    assert ring["capacity"]["events"] == 4
    assert [e["i"] for e in ring["events"]] == [6, 7, 8, 9]


def test_request_ring_cap_drops_and_counts():
    pt.set_flags({"FLAGS_blackbox_requests": 2})
    blackbox.reset()
    t1 = blackbox.request_begin("tid-1", "predict", rows=1)
    t2 = blackbox.request_begin("tid-2", "predict", rows=2)
    assert t1 is not None and t2 is not None
    # over cap: not recorded (None token), counted, nothing raises
    assert blackbox.request_begin("tid-3", "predict") is None
    ring = blackbox.snapshot()
    assert len(ring["live_requests"]) == 2
    assert ring["requests_dropped"] == 1
    # retiring frees a slot; phase/end on a None token are no-ops
    blackbox.request_end(t1)
    blackbox.request_phase(None, "executing")
    blackbox.request_end(None)
    assert blackbox.request_begin("tid-4", "generate") is not None
    live = blackbox.snapshot()["live_requests"]
    assert sorted(r["trace_id"] for r in live) == ["tid-2", "tid-4"]


def test_request_phase_and_age_in_snapshot():
    tok = blackbox.request_begin("tid-9", "generate", prompt_len=7)
    blackbox.request_phase(tok, "prefill", slot=3)
    [rec] = blackbox.snapshot()["live_requests"]
    assert rec["phase"] == "prefill" and rec["slot"] == 3
    assert rec["endpoint"] == "generate" and rec["prompt_len"] == 7
    assert rec["age_ms"] >= 0.0 and "t_admit" not in rec


def test_log_event_tap_mirrors_without_metrics_dir():
    # no FLAGS_metrics_dir: events.jsonl is off, the ring still fills
    telemetry.log_event("ckpt_publish", step=12)
    evs = blackbox.snapshot()["events"]
    assert any(e["event"] == "ckpt_publish" and e["step"] == 12
               for e in evs)


def test_flush_tap_snapshots_metrics_and_rolls_dump(tmp_path):
    mdir = str(tmp_path / "m")
    pt.set_flags({"FLAGS_metrics_dir": mdir,
                  "FLAGS_metrics_interval": 0.0})
    stat_add("bb_test_counter", 5)
    telemetry.flush(force=True)
    snaps = blackbox.snapshot()["metric_snapshots"]
    assert snaps and "bb_test_counter" in snaps[-1]["counters"]
    rolling = os.path.join(mdir, "postmortem",
                           f"{os.getpid()}-rolling.json")
    assert os.path.isfile(rolling)
    doc = json.load(open(rolling))
    assert doc["schema"] == "paddle_tpu.postmortem.v1"
    assert doc["reason"] == "rolling" and doc["pid"] == os.getpid()


@pytest.mark.parametrize("flags", [{"FLAGS_blackbox": False},
                                   {"FLAGS_telemetry": False}])
def test_disabled_means_zero_work_and_no_files(tmp_path, flags):
    mdir = str(tmp_path / "m")
    pt.set_flags(dict(flags, FLAGS_metrics_dir=mdir))
    assert blackbox.enabled() is False
    assert blackbox.request_begin("tid", "predict") is None
    blackbox.record_event("ignored")
    assert blackbox.dump("testing") is None
    assert blackbox.snapshot() == {"enabled": False}
    assert blackbox.install() is False
    assert not os.path.isdir(os.path.join(mdir, "postmortem"))
    # nothing was buffered while off: re-enabling starts empty
    pt.set_flags({"FLAGS_blackbox": True, "FLAGS_telemetry": True})
    assert blackbox.snapshot()["events"] == []


def test_dump_document_schema(tmp_path):
    pt.set_flags({"FLAGS_metrics_dir": str(tmp_path)})
    blackbox.record_event("last_words", n=1)
    tok = blackbox.request_begin("tid-d", "predict", rows=2)
    try:
        raise ValueError("engine exploded")
    except ValueError as e:
        path = blackbox.dump_exception("unit_test", e)
    assert path and os.path.isfile(path)
    assert os.path.basename(path) == \
        f"{os.getpid()}-uncaught_unit_test.json"
    doc = json.load(open(path))
    assert doc["schema"] == "paddle_tpu.postmortem.v1"
    assert doc["reason"] == "uncaught_unit_test"
    assert doc["exception"]["type"] == "ValueError"
    assert "engine exploded" in doc["exception"]["message"]
    assert any(e["event"] == "last_words"
               for e in doc["blackbox"]["events"])
    assert any(r["trace_id"] == "tid-d"
               for r in doc["blackbox"]["live_requests"])
    assert doc["flags"]["FLAGS_blackbox"] is True
    assert isinstance(doc["trace_events"], list)
    assert "counters" in doc["metrics"]
    blackbox.request_end(tok)


def test_injected_dump_fault_never_raises(tmp_path):
    pt.set_flags({"FLAGS_metrics_dir": str(tmp_path)})
    fault.configure("blackbox_dump:raise@1")
    before = stat_get("blackbox_dump_failures")
    assert blackbox.dump("doomed") is None  # swallowed, not raised
    assert stat_get("blackbox_dump_failures") == before + 1
    # the fault fired before any file was created (dir included)
    assert not os.path.exists(os.path.join(str(tmp_path),
                                           "postmortem"))
    # the site is per-hit: the next dump (hit 2) succeeds
    path = blackbox.dump("survivor")
    assert path and os.path.isfile(path)


def test_dump_reason_is_sanitized(tmp_path):
    pt.set_flags({"FLAGS_metrics_dir": str(tmp_path)})
    path = blackbox.dump("../../../etc/passwd !")
    assert os.path.dirname(path) == os.path.join(str(tmp_path),
                                                 "postmortem")
    assert "/etc/" not in os.path.basename(path)


def test_hbm_sampler_refcounting():
    pt.set_flags({"FLAGS_hbm_sample_interval": 0.01})
    assert observatory.start_hbm_sampler()
    assert observatory.start_hbm_sampler()  # second holder
    assert observatory._sampler is not None
    observatory.stop_hbm_sampler()
    assert observatory._sampler is not None  # one holder left
    observatory.stop_hbm_sampler()
    assert observatory._sampler is None
    pt.set_flags({"FLAGS_hbm_sample_interval": 0.0})
    assert not observatory.start_hbm_sampler()  # disabled


def test_capture_profile_writes_artifact(tmp_path):
    pt.set_flags({"FLAGS_metrics_dir": str(tmp_path)})
    rep = observatory.capture_profile(0.1)
    assert rep["dir"].startswith(str(tmp_path))
    assert rep["files"] and rep["bytes"] > 0
    assert stat_get("profile_captures") >= 1


def test_capture_profile_disabled_and_busy(tmp_path):
    pt.set_flags({"FLAGS_telemetry": False})
    with pytest.raises(observatory.CaptureDisabled):
        observatory.capture_profile(0.05)
    pt.set_flags({"FLAGS_telemetry": True,
                  "FLAGS_metrics_dir": str(tmp_path)})
    t = observatory.capture_profile_async(0.5)
    import time
    deadline = time.monotonic() + 2.0
    while not observatory._capture_active[0] \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    assert observatory._capture_active[0]
    with pytest.raises(observatory.CaptureBusy):
        observatory.capture_profile(0.05)
    t.join(10.0)
    assert not observatory._capture_active[0]


def test_capture_marks_itself_while_it_runs(tmp_path, monkeypatch):
    """A capture leaves CAPTURE_MARK (its pid, start and length) in
    FLAGS_metrics_dir while it runs and removes it after, also when the
    profiler fails; capture_waiver_until reads it for that pid only."""
    pt.set_flags({"FLAGS_metrics_dir": str(tmp_path)})
    mark = os.path.join(str(tmp_path), observatory.CAPTURE_MARK)
    seen = []

    def profile_for(sec, target):
        with open(mark) as f:
            seen.append(json.load(f))
        seen.append(observatory.capture_waiver_until(str(tmp_path),
                                                     os.getpid()))
        seen.append(observatory.capture_waiver_until(str(tmp_path),
                                                     os.getpid() + 1))
        os.makedirs(target, exist_ok=True)

    monkeypatch.setattr(observatory, "_profile_for", profile_for)
    observatory.capture_profile(0.5)
    doc, until, other = seen
    assert doc["pid"] == os.getpid() and doc["sec"] == 0.5
    assert until == doc["started"] + 0.5 + observatory.CAPTURE_STOP_S
    assert other is None
    assert not os.path.exists(mark)
    assert observatory.capture_waiver_until(str(tmp_path),
                                            os.getpid()) is None

    def broken(sec, target):
        assert os.path.exists(mark)
        raise RuntimeError("profiler backend failure")

    monkeypatch.setattr(observatory, "_profile_for", broken)
    with pytest.raises(RuntimeError):
        observatory.capture_profile(0.05)
    assert not os.path.exists(mark)
    with open(mark, "w") as f:
        f.write("{not json")
    assert observatory.capture_waiver_until(str(tmp_path),
                                            os.getpid()) is None


def _assert_conserved(led: UsageLedger):
    cons = led.conservation()
    assert set(cons) == set(COST_FIELDS)
    for field, c in cons.items():
        assert c["delta"] == 0, (field, c)


def test_split_ints_sums_exactly_and_is_deterministic():
    rng = np.random.RandomState(3)
    for _ in range(200):
        total = int(rng.randint(0, 10_000))
        weights = [int(x) for x in rng.randint(0, 50, size=rng.randint(
            1, 9))]
        shares = split_ints(total, weights)
        assert sum(shares) == total
        assert shares == split_ints(total, weights)
        assert all(s >= 0 for s in shares)
    assert split_ints(7, []) == []
    # zero weights split evenly, remainder by index order
    assert sum(split_ints(10, [0, 0, 0])) == 10


def test_tenant_normalization_guards_the_key_space():
    assert usage.normalize_tenant(None) == usage.default_tenant()
    assert usage.normalize_tenant("") == usage.default_tenant()
    # a claim on the reserved aggregate bucket is remapped, not booked
    assert usage.normalize_tenant(OTHER_TENANT) == usage.default_tenant()
    assert usage.normalize_tenant("x" * 65) == usage.default_tenant()
    assert usage.normalize_tenant("no spaces!") == usage.default_tenant()
    assert usage.normalize_tenant("org:team.svc-1") == "org:team.svc-1"


def test_topk_exact_under_adversarial_interleaving():
    """Four heavy tenants booked early must survive a churning tail of
    hundreds of one-shot tenants with EXACT vectors: the tail demotes
    only itself (min weight) while the heavies' weights keep them
    pinned in the sketch."""
    led = UsageLedger(top_k=8)
    heavies = [f"heavy-{i}" for i in range(4)]
    booked = dict.fromkeys(heavies, 0)
    # seed each heavy past any single's possible inherited weight
    for h in heavies:
        for _ in range(50):
            led.book(h, requests=1, tokens_in=3)
            booked[h] += 1
    rng = np.random.RandomState(0)
    for i in range(600):
        led.book(f"one-shot-{i}", requests=1, tokens_in=1)
        h = heavies[int(rng.randint(len(heavies)))]
        led.book(h, requests=1, tokens_in=3)
        booked[h] += 1
    snap = led.snapshot()
    for h in heavies:
        assert h in snap["tenants"], h
        vec = snap["tenants"][h]
        assert vec["requests"] == booked[h]
        assert vec["tokens_in"] == 3 * booked[h]
    # exactness is certified: a never-demoted tenant carries err == 0
    uz = led.usagez()
    for h in heavies:
        assert uz["tenants"][h]["err"] == 0
    _assert_conserved(led)


def test_other_bucket_conserves_demoted_and_trailing_costs():
    led = UsageLedger(top_k=4)
    for i in range(40):
        led.book(f"t-{i:02d}", requests=1, tokens_out=5, page_us=7)
    snap = led.snapshot()
    # 40 tenants through a 4-slot sketch: everything demoted landed in
    # ~other and nothing was lost — per-field conservation at 0
    # (snapshot nests ~other inside "tenants" alongside the tracked 4)
    assert len(snap["tenants"]) <= 4 + 1
    _assert_conserved(led)
    assert snap["totals"]["requests"] == 40
    assert snap["totals"]["tokens_out"] == 200
    # a demoted tenant's TRAILING costs (requests=0 bookings: tokens
    # still decoding, pages still held) aggregate into ~other instead
    # of re-churning the sketch
    gone = sorted(set(f"t-{i:02d}" for i in range(40))
                  - set(snap["tenants"]))[0]
    before = led.snapshot()["tenants"]
    other_before = before[OTHER_TENANT]["tokens_out"]
    key = led.book(gone, tokens_out=9)
    assert key == OTHER_TENANT
    after = led.snapshot()
    assert after["tenants"].keys() == before.keys()
    assert after["tenants"][OTHER_TENANT]["tokens_out"] == \
        other_before + 9
    _assert_conserved(led)


def test_demotion_is_deterministic_min_weight_lexicographic():
    def run():
        led = UsageLedger(top_k=3)
        # equal weights: b, a, c each one request
        for t in ("b", "a", "c"):
            led.book(t, requests=1)
        # full sketch + a new requester: the tie among (a, b, c) breaks
        # to the lexicographically smallest — 'a' is demoted
        led.book("d", requests=1)
        return led

    led = run()
    snap = led.snapshot()
    assert set(snap["tenants"]) == {"b", "c", "d", OTHER_TENANT}
    # a's exact vector folded into ~other
    assert snap["tenants"][OTHER_TENANT]["requests"] == 1
    # the newcomer inherits the victim's weight as its overestimate
    assert led.usagez()["tenants"]["d"]["err"] == 1
    assert led.sketch_stats()["demotions"] == 1
    # identical sequences -> identical sketches, bit for bit
    led2 = run()
    assert led2.snapshot() == snap
    assert led2.usagez()["tenants"].keys() == led.usagez()[
        "tenants"].keys()
    _assert_conserved(led)


def test_sketch_memory_hard_bound_under_high_cardinality():
    led = UsageLedger(top_k=16)
    rng = np.random.RandomState(1)
    for i in range(5000):
        led.book(f"tenant-{int(rng.randint(100000)):06d}", requests=1,
                 tokens_in=int(rng.randint(10)))
        if i % 500 == 0:
            assert len(led._tenants) <= led.top_k
    sk = led.sketch_stats()
    assert sk["tracked"] <= sk["top_k"] == 16
    assert sk["capacity_vectors"] == 17
    assert sk["within_bound"] is True
    assert sk["demotions"] > 0
    _assert_conserved(led)


def test_flags_usage_off_does_zero_per_request_work():
    pt.set_flags({"FLAGS_usage": False})
    usage.reset_ledger()
    try:
        assert not usage.enabled()
        eng = _tiny_engine()
        feed = {"x": np.random.RandomState(0).rand(1, 4)
                .astype("float32")}
        for _ in range(3):
            eng.predict(feed, timeout=60)
        # a tenant kwarg with the flag off must not resurrect the path
        eng.submit(feed, tenant="acme").result(60)
        eng.close()
        # the witness: the singleton was NEVER constructed — no vector,
        # no histogram, no lock was ever allocated on the request path
        assert usage.peek_ledger() is None
    finally:
        pt.set_flags({"FLAGS_usage": True})
        usage.reset_ledger()


def test_engine_books_tenants_and_conserves_against_totals():
    pt.set_flags({"FLAGS_usage": True})
    usage.reset_ledger()
    try:
        eng = _tiny_engine()
        feed = {"x": np.random.RandomState(0).rand(1, 4)
                .astype("float32")}
        for i in range(6):
            eng.submit(feed, tenant=("acme" if i % 2 else "umbrella")
                       ).result(60)
        # headerless traffic books to the default tenant, never drops
        eng.predict(feed, timeout=60)
        eng.close()
        led = usage.peek_ledger()
        assert led is not None
        snap = led.snapshot()
        assert snap["tenants"]["acme"]["requests"] == 3
        assert snap["tenants"]["umbrella"]["requests"] == 3
        assert snap["tenants"][usage.default_tenant()]["requests"] == 1
        # the tentpole contract: per-tenant sums equal the global
        # counters at tolerance 0 — and the ledger totals saw every
        # request the engine's own counter did (7 of them)
        assert snap["totals"]["requests"] == 7
        assert snap["totals"]["served"] == 7
        _assert_conserved(led)
        # per-tenant latency measured for every tracked tenant
        uz = led.usagez()
        for t in ("acme", "umbrella"):
            rm = uz["tenants"][t]["request_ms"]
            assert rm is not None and rm["count"] == 3
            assert rm["p99"] is not None
    finally:
        usage.reset_ledger()


# ---------------------------------------------------------------------------
# the cost model (the port's own: H100 peaks, manifests from the program)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,want", [
    ("NVIDIA H100 80GB HBM3", (989e12, 67e12, 3350e9)),
    ("NVIDIA H100 PCIe", (989e12, 67e12, 3350e9)),
    ("TPU v5 lite", (None, None, None)),
    ("", (None, None, None))])
def test_peak_table_holds_the_h100_and_nothing_else(kind, want):
    p = costmodel.device_peaks(kind)
    assert (p["peak_flops"], p["peak_flops_fp32"], p["peak_bw"]) == want
    assert p["source"] == ("table" if want[0] else "unknown")
    # no TPU row at all: every key names an NVIDIA card
    assert all(row[0].startswith("h") for row in costmodel.PEAK_TABLE)
    assert costmodel.mfu(1e12, kind) == (1e12 / want[0] if want[0]
                                         else None)


def test_peak_overrides():
    pt.set_flags({"FLAGS_device_peak_flops": 100.0,
                  "FLAGS_device_peak_bw": 2000.0})
    p = costmodel.device_peaks("anything")
    assert p["peak_flops"] == 100e12 and p["peak_bw"] == 2000e9
    assert p["source"] == "FLAGS_device_peak_flops"


def test_predictor_costs_count_the_products():
    """cache_info's cost manifest: 2 M K N flops a mul at the bucket's
    rows, the weights' bytes, and no graph pool on the CPU."""
    pred, _ = serving_loadgen.build_synthetic(4, 8, 1, classes=2,
                                              device="cpu")
    pred.warmup([{"x": (b, 4)} for b in (1, 4)])
    info = pred.cache_info()
    costs = info["costs"]
    assert len(costs) == 2
    by_rows = {int(re.match(r"\(\(\((\d+),", s).group(1)): c
               for s, c in costs.items()}
    for rows, c in by_rows.items():
        assert c["flops"] == 2 * rows * (4 * 8 + 8 * 2)
        assert c["peak_bytes"] is None
    weights = 4 * (4 * 8 + 8 + 8 * 2 + 2)
    assert by_rows[4]["bytes_accessed"] == weights + 4 * (4 * 4 + 4 * 2)
    assert set(info["manifests"].values()) == {None}  # nothing captured

