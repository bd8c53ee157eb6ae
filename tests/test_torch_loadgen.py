"""The port's load generator (``paddle_tpu_torch/tools/serving_loadgen.py``)
on the CPU.

Parity at tolerance 0: the same seeds through the reference tool
(``tools/serving_loadgen.py``, loaded by path as the reference tests load
it) and the port's copy give equal feeds, zipf ids, tenants, recsys
feeds, prompts in every distribution, traffic-shape rates and phases,
arrival schedules (both clocks driven by one fake clock), phase books and
SLO verdicts with their violation strings.

Live twins (``device="cpu"`` / ``--device cpu``): each is the reference
test's body against ``paddle_tpu_torch`` — the shaped open loop and the
per-phase SLO through a port router over port replicas
(``tests/test_router.py``), the ``/debugz`` fetch on an SLO violation
(``tests/test_blackbox.py``), the open loop against a live server and the
CLI (``tests/test_serving.py``), the generation CLI
(``tests/test_generation.py``), streamed TTFT through a server and a
router (``tests/test_fleet_observatory.py``), the ``/profilez`` contract
(``tests/test_observatory.py``); and the reason the copy exists: a port
engine's shed is counted as a shed.
"""
import importlib.util
import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu_torch as tpt
from paddle_tpu_torch import fault, promtext, telemetry
from paddle_tpu_torch.serving import (FleetSupervisor, GenerationEngine,
                                      ServingEngine, ServingServer, serve)
from paddle_tpu_torch.tools import serving_loadgen as lg

from torch_fleet_util import TINY_ARGV, router_over

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_LLAMA = dict(vocab_size=64, hidden=32, num_layers=2, num_heads=4,
                  num_kv_heads=2, intermediate=64)


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_torch_loadgen_tests",
        os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _load_tool("serving_loadgen")


@pytest.fixture(autouse=True)
def _reset():
    fault.reset()
    yield
    fault.reset()
    tpt.set_flags({"FLAGS_fault_inject": "", "FLAGS_telemetry": True,
                   "FLAGS_metrics_dir": "", "FLAGS_metrics_interval": 10.0,
                   "FLAGS_usage": True})


def _same_feeds(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        assert np.array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# parity with the reference tool, tolerance 0
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shapes,rows,seed", [
    ({"x": (8,)}, 1, 0), ({"x": (4,)}, 3, 7),
    ({"input_ids": (16,), "attn_mask": (16,)}, 2, 11)])
def test_feed_maker_matches_the_reference(shapes, rows, seed):
    mine, theirs = (m.feed_maker(shapes, rows=rows, seed=seed)
                    for m in (lg, ref))
    for i in range(40):
        _same_feeds(mine(i), theirs(i))


@pytest.mark.parametrize("vocab,size,s,seed", [
    (1000, 64, 1.2, 0), (50, (4, 8), 0.0, 3), (100000, 256, 0.8, 9)])
def test_zipf_ids_match_the_reference(vocab, size, s, seed):
    a = lg.zipf_ids(np.random.RandomState(seed), vocab, size, s)
    b = ref.zipf_ids(np.random.RandomState(seed), vocab, size, s)
    assert a.dtype == b.dtype == np.int64 and np.array_equal(a, b)


@pytest.mark.parametrize("n,dist,seed", [(4, "zipf", 0), (3, "uniform", 5),
                                         (12, "zipf", 2)])
def test_tenant_picker_matches_the_reference(n, dist, seed):
    mine = lg.tenant_picker(n, dist, seed=seed, pool=512)
    theirs = ref.tenant_picker(n, dist, seed=seed, pool=512)
    assert [mine(i) for i in range(1100)] == \
        [theirs(i) for i in range(1100)]
    assert lg.TENANT_HEADER == ref.TENANT_HEADER


def test_recsys_feed_maker_matches_the_reference():
    mine = lg.recsys_feed_maker(8, 4, 2000, zipf=1.2, rows=2, seed=4)
    theirs = ref.recsys_feed_maker(8, 4, 2000, zipf=1.2, rows=2, seed=4)
    for i in range(70):
        _same_feeds(mine(i), theirs(i))


PROMPT_CASES = [
    dict(dist="geometric"),
    dict(dist="bimodal"),
    dict(dist="geometric", prompt_dist="shared-prefix", prefix_tokens=24),
    dict(dist="bimodal", prompt_dist="shared-prefix", prefix_tokens=5),
    dict(dist="bimodal", prompt_dist="mixed", long_frac=0.25,
         long_tokens=48),
    dict(dist="geometric", prompt_dist="mixed", long_frac=0.6,
         long_tokens=30)]


@pytest.mark.parametrize("kw", PROMPT_CASES)
def test_prompt_maker_matches_the_reference(kw):
    mine = lg.prompt_maker(64, 4, 8, 16.0, 128, pool=256, seed=3, **kw)
    theirs = ref.prompt_maker(64, 4, 8, 16.0, 128, pool=256, seed=3, **kw)
    for i in range(300):
        (p, n), (q, m) = mine(i), theirs(i)
        assert p.dtype == q.dtype == np.int64
        assert np.array_equal(p, q) and n == m


@pytest.mark.parametrize("kw,match", [
    (dict(dist="zipf"), "output-length"),
    (dict(prompt_dist="shared-prefix", prefix_tokens=0), "prefix_tokens"),
    (dict(prompt_dist="mixed", long_tokens=0), "long_tokens"),
    (dict(prompt_dist="mixed", long_tokens=48, long_frac=1.5),
     "long_frac"),
    (dict(prompt_dist="zipf"), "prompt dist")])
def test_prompt_maker_refuses_what_the_reference_refuses(kw, match):
    for mod in (lg, ref):
        with pytest.raises(ValueError, match=match):
            mod.prompt_maker(64, 4, 8, 4.0, 8, **kw)


def test_loadgen_prompt_distributions_as_the_reference_tests_read_them():
    """The reference tests' own checks (``test_generation.py:443``,
    ``test_paged_generation.py:364``, ``test_disagg.py:434``) on the
    port's prompts."""
    for dist in ("geometric", "bimodal"):
        lens = [lg.prompt_maker(64, 4, 8, 16.0, 128, pool=512,
                                dist=dist)(i)[1] for i in range(512)]
        assert all(1 <= n <= 128 for n in lens)
        assert abs(np.mean(lens) - 16.0) < 4.0, (dist, np.mean(lens))
    mk = lg.prompt_maker(64, 4, 8, 8.0, 16, pool=32,
                         prompt_dist="shared-prefix", prefix_tokens=24)
    header = mk(0)[0][:24]
    assert all(np.array_equal(mk(i)[0][:24], header) for i in range(32))
    assert len({mk(i)[0][24:].tobytes() for i in range(32)}) > 1
    make = lg.prompt_maker(64, 4, 8, 4.0, 8, pool=200, dist="bimodal",
                           prompt_dist="mixed", long_frac=0.25,
                           long_tokens=48)
    lens = [make(i)[0].size for i in range(200)]
    longs = [n for n in lens if n >= 36]
    assert longs and len(longs) + sum(1 for n in lens if n <= 8) == 200
    assert 0.10 < len(longs) / len(lens) < 0.45


SHAPES = [("const", {}), ("sine", {}), ("sine", dict(period_s=3.0)),
          ("burst", dict(amplitude=2.0, period_s=2.0, burst_frac=0.25)),
          ("burst", {}), ("step", dict(amplitude=0.5))]


@pytest.mark.parametrize("shape,kw", SHAPES)
def test_traffic_shape_matches_the_reference(shape, kw):
    mine = lg.TrafficShape(shape, 100.0, 8.0, **kw)
    theirs = ref.TrafficShape(shape, 100.0, 8.0, **kw)
    for t in np.linspace(0.0, 8.0, 321):
        assert mine.rate(float(t)) == theirs.rate(float(t))
        assert mine.phase(float(t)) == theirs.phase(float(t))
    assert mine.describe() == theirs.describe()
    assert lg.TRAFFIC_SHAPES == ref.TRAFFIC_SHAPES


def test_traffic_shape_math_as_the_reference_test_reads_it():
    """``tests/test_router.py:362``'s checks on the port's shapes."""
    sine = lg.TrafficShape("sine", 100.0, 8.0, amplitude=1.0)
    assert sine.rate(2.0) == pytest.approx(200.0)
    assert sine.rate(6.0) == pytest.approx(5.0)
    assert sine.phase(2.0) == "crest" and sine.phase(6.0) == "trough"
    burst = lg.TrafficShape("burst", 100.0, 8.0, amplitude=2.0,
                            period_s=2.0, burst_frac=0.25)
    assert burst.rate(0.1) == pytest.approx(300.0)
    assert burst.phase(2.1) == "burst" and burst.phase(3.0) == "base"
    with pytest.raises(ValueError):
        lg.TrafficShape("square", 1.0, 1.0)


class _FakeClock:
    """A stand-in for the ``time`` module: monotonic() reads a counter that
    sleep() advances (plus a fixed cost a reading), so a pacing loop runs
    to a deterministic schedule."""

    def __init__(self, tick=0.0007):
        self.t = 1000.0
        self.tick = tick

    def monotonic(self):
        self.t += self.tick
        return self.t

    def sleep(self, s):
        self.t += s


@pytest.mark.parametrize("shape,kw", [(None, {})] + SHAPES)
def test_arrival_clock_schedule_matches_the_reference(monkeypatch, shape,
                                                      kw):
    runs = []
    for mod in (lg, ref):
        monkeypatch.setattr(mod, "time", _FakeClock())
        traffic = None if shape is None else mod.TrafficShape(
            shape, 40.0, 3.0, **kw)
        runs.append([(i, phase, round(now, 9)) for i, phase, now in
                     mod._arrival_clock(40.0, 3.0, traffic)])
    assert runs[0] == runs[1] and len(runs[0]) > 100


def test_phase_book_and_reports_match_the_reference():
    rng = np.random.RandomState(0)
    events = []
    t = 0.0
    for i in range(200):
        t += float(rng.rand()) * 0.01
        phase = ("burst", "base")[(i // 17) % 2]
        outcome = ("ok", "ok", "ok", "shed", "failed")[rng.randint(5)]
        ms = float(rng.rand() * 50) if outcome == "ok" else None
        version = int(rng.randint(1, 3)) if outcome == "ok" else None
        events.append((phase, t, outcome, ms, version))
    books = []
    for mod in (lg, ref):
        book = mod._PhaseBook()
        for phase, now, outcome, ms, version in events:
            book.arrival(phase, now)
            book.outcome(phase, outcome, ms, version=version)
        books.append(book.report())
    assert books[0] == books[1]
    lat = [e[3] for e in events if e[3] is not None]
    assert lg._percentiles(lat) == ref._percentiles(lat)
    assert lg._percentiles([]) == ref._percentiles([]) == {"count": 0}
    args = ("open", 200, 120, 40, 40, 2.5, lat, None)
    assert lg._report(*args) == ref._report(*args)
    g = ("closed", 200, 120, 40, 40, 2.5, lat, 777, None)
    assert lg._gen_report(*g, ttft_ms=lat[:9], itl_ms=lat) == \
        ref._gen_report(*g, ttft_ms=lat[:9], itl_ms=lat)


def test_token_clock_folds_as_the_reference(monkeypatch):
    folds = []
    for mod in (lg, ref):
        monkeypatch.setattr(mod, "time", _FakeClock(tick=0.013))
        clock = mod._TokenClock(mod.time.monotonic())
        for tok in range(5):
            clock.on_token(tok, None)
        folds.append(clock.fold())
        assert mod._TokenClock(1.0).fold() == (None, [])
    assert folds[0] == folds[1]


# the synthetic reports of the reference tests (test_router.py:362,
# test_observatory.py:508, test_fleet_observatory.py:609) and every other
# bound check_slo takes
PHASED = {"mode": "open", "requests": 100, "ok": 95, "shed": 5,
          "failed": 0, "shed_rate": 0.05,
          "latency_ms": {"count": 95, "p99": 10.0},
          "phases": {
              "crest": {"requests": 50, "ok": 45, "shed": 5, "failed": 0,
                        "shed_rate": 0.10,
                        "latency_ms": {"count": 45, "p99": 30.0}},
              "trough": {"requests": 50, "ok": 50, "shed": 0, "failed": 0,
                         "shed_rate": 0.0,
                         "latency_ms": {"count": 50, "p99": 5.0}},
              "never": {"requests": 0, "ok": 0, "shed": 0, "failed": 0,
                        "shed_rate": 0.0, "latency_ms": {"count": 0}}}}
CLOSED = {"mode": "closed", "shed_rate": 0.02, "latency_ms": {"p99": 12.0}}
BOTH = {"mode": "both",
        "closed": {"shed_rate": 0.0, "latency_ms": {"p99": 5.0}},
        "open": {"shed_rate": 0.5, "latency_ms": {"p99": 5.0}}}
EMPTY = {"mode": "open", "shed_rate": 1.0, "latency_ms": {}}
GEN = {"mode": "closed", "ok": 6, "shed_rate": 0.0,
       "latency_ms": {"count": 6, "p99": 40.0},
       "ttft_ms": {"count": 6, "p99": 9.0},
       "inter_token_ms": {"count": 30, "p99": 3.0},
       "spec_acceptance_rate": 0.6, "hit_rate": 0.4,
       "weights_versions": {"2": 5, "1": 1},
       "statusz": {"engine": {"groups": [
           {"worker": 0, "status": "ok"},
           {"worker": 1, "status": "degraded", "mesh": "dp=2",
            "devices": [1]}]}},
       "usage": {"tenants": {
           "tenant-00": {"request_ms": {"p99": 11.0}},
           "tenant-01": {"request_ms": {"p99": 99.0}},
           "tenant-02": {"request_ms": {}}}}}
PLAIN = {"mode": "closed", "ok": 2, "shed_rate": 0.0,
         "latency_ms": {"count": 2, "p99": 40.0}}
FLEET_USAGE = dict(PLAIN, usage={"fleet": True, "tenant_families": {}})

SLO_CASES = [
    (PHASED, dict(p99_ms=20.0, shed_pct=8.0)),
    (PHASED, dict(p99_ms=50.0, shed_pct=20.0)),
    (CLOSED, dict(p99_ms=20.0, shed_pct=5.0)),
    (CLOSED, dict(p99_ms=10.0)), (CLOSED, dict(shed_pct=1.0)),
    (BOTH, dict(p99_ms=20.0, shed_pct=10.0)),
    (EMPTY, dict(p99_ms=20.0)),
    (GEN, dict(ttft_ms=60000.0, itl_ms=60000.0)),
    (GEN, dict(ttft_ms=0.0001, itl_ms=1.0)),
    (PLAIN, dict(ttft_ms=60000.0)),
    (GEN, dict(accept_rate=0.9, hit_rate=0.5)),
    (PLAIN, dict(accept_rate=0.5, hit_rate=0.5)),
    (GEN, dict(expect_version=2)), (PLAIN, dict(expect_version=2)),
    (GEN, dict(fail_degraded=True)),
    (GEN, dict(tenant_p99_ms=50.0)),
    (FLEET_USAGE, dict(tenant_p99_ms=50.0)),
    (dict(BOTH, closed=GEN, open=PLAIN),
     dict(p99_ms=30.0, ttft_ms=5.0, accept_rate=0.5))]


@pytest.mark.parametrize("report,kw", SLO_CASES)
def test_check_slo_matches_the_reference(report, kw):
    got = lg.check_slo(json.loads(json.dumps(report)), **kw)
    want = ref.check_slo(json.loads(json.dumps(report)), **kw)
    assert got == want


def test_check_slo_verdicts_as_the_reference_tests_read_them():
    slo = lg.check_slo(PHASED, p99_ms=20.0, shed_pct=8.0)
    joined = " ".join(slo["violations"])
    assert not slo["ok"] and "open[crest]" in joined
    assert "trough" not in joined and "never" not in joined
    assert lg.check_slo(CLOSED, p99_ms=20.0, shed_pct=5.0)["ok"]
    r = lg.check_slo(BOTH, p99_ms=20.0, shed_pct=10.0)
    assert not r["ok"] and any("open" in v for v in r["violations"])
    assert not lg.check_slo(EMPTY, p99_ms=20.0)["ok"]
    assert not lg.check_slo(PLAIN, ttft_ms=60000.0)["ok"]


# ---------------------------------------------------------------------------
# in process: the port's engine and its error classes
# ---------------------------------------------------------------------------

def _engine(**kw):
    predictor, shapes = lg.build_synthetic(feat=4, hidden=8, depth=1,
                                           classes=2, device="cpu")
    eng = ServingEngine(predictor, **dict(dict(
        workers=1, max_batch=2, max_delay_ms=1.0, deadline_ms=60000.0),
        **kw))
    return eng, predictor, shapes


def test_build_synthetic_runs_on_the_card_unless_given_the_cpu():
    pred, shapes = lg.build_synthetic(feat=4, hidden=8, depth=1,
                                      classes=2, device="cpu")
    assert pred.device.type == "cpu" and shapes == {"x": (4,)}
    out = pred.run({"x": np.ones((3, 4), "float32")})[0]
    assert out.shape == (3, 2)
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            lg.build_synthetic(feat=4, hidden=8, depth=1)


def test_shaped_open_loop_reports_phases():
    """``tests/test_router.py:408`` against a port engine."""
    eng, pred, shapes = _engine()
    eng.warmup(shapes)
    srv = serve(eng)
    try:
        traffic = lg.TrafficShape("burst", 80.0, 1.0, amplitude=1.0,
                                  period_s=0.5, burst_frac=0.5)
        rep = lg.run_open_loop(eng, lg.feed_maker(shapes, rows=1),
                               qps=80.0, duration_s=1.0, traffic=traffic)
        assert rep["traffic"]["shape"] == "burst"
        assert set(rep["phases"]) <= {"burst", "base"}
        assert sum(p["requests"] for p in rep["phases"].values()) \
            == rep["requests"]
        for p in rep["phases"].values():
            assert p["ok"] + p["shed"] + p["failed"] == p["requests"]
    finally:
        srv.close()


def test_in_process_open_loop_counts_a_port_engine_shed_as_shed():
    """Why the copy exists: the reference's drivers catch the JAX
    package's OverloadedError, so a port engine's shed escaped its
    caller thread uncounted.  Against a port engine with queue_cap 1 the
    sheds land in ``shed``, nothing in ``failed``, and every phase's
    books balance."""
    eng, pred, shapes = _engine(queue_cap=1, max_batch=1)
    eng.warmup(shapes)
    try:
        fault.configure("serve_batch:delay:20~1.0")
        traffic = lg.TrafficShape("step", 200.0, 0.8, amplitude=1.0)
        rep = lg.run_open_loop(eng, lg.feed_maker(shapes), qps=200.0,
                               duration_s=0.8, traffic=traffic)
        fault.configure("")
        assert rep["shed"] > 0 and rep["failed"] == 0, rep
        assert rep["ok"] + rep["shed"] + rep["failed"] == rep["requests"]
        for p in rep["phases"].values():
            assert p["ok"] + p["shed"] + p["failed"] == p["requests"]
        assert rep["engine"]["counters"]["shed"] == rep["shed"]
        # the closed loop books the same way
        fault.configure("serve_batch:delay:20~1.0")
        rep = lg.run_closed_loop(eng, lg.feed_maker(shapes), 40, 8)
        fault.configure("")
        assert rep["shed"] > 0 and rep["failed"] == 0, rep
        assert rep["ok"] + rep["shed"] == 40
    finally:
        fault.configure("")
        eng.close()


def test_in_process_generate_loops_on_a_port_engine():
    gen = GenerationEngine(TINY_LLAMA, num_slots=2, max_seq_len=64,
                           max_new_tokens=8, attn_impl="xla", seed=0,
                           queue_cap=64, deadline_ms=60000.0,
                           device="cpu")
    try:
        mk = lg.prompt_maker(64, 4, 8, 4.0, 6)
        rep = lg.run_closed_loop_generate(gen, mk, 6, 2)
        assert rep["ok"] == 6 and rep["failed"] == 0
        assert rep["generated_tokens"] > 0
        assert rep["ttft_ms"]["count"] == 6
        rep = lg.run_open_loop_generate(gen, mk, qps=40.0, duration_s=0.3)
        assert rep["failed"] == 0
        assert rep["ok"] + rep["shed"] == rep["requests"] > 0
    finally:
        gen.close()


def test_in_process_sharded_and_recsys_wait_for_their_items():
    with pytest.raises(NotImplementedError, match="item 9"):
        lg.main(["--synthetic", "--sharded", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="item 9"):
        lg.main(["--synthetic", "--groups", "2", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="item 8"):
        lg.main(["--recsys", "--device", "cpu"])


# ---------------------------------------------------------------------------
# HTTP: a live port server
# ---------------------------------------------------------------------------

@pytest.fixture()
def mini_server():
    eng, pred, shapes = _engine()
    eng.warmup(shapes)
    srv = ServingServer(eng).start()
    yield eng, srv
    srv.close()


def test_loadgen_slo_violation_autofetches_debugz(mini_server, tmp_path,
                                                  capsys):
    """``tests/test_blackbox.py:410`` against a port server."""
    _eng, srv = mini_server
    out = str(tmp_path / "report.json")
    rc = lg.main(["--url", srv.url, "--feat", "4", "--mode", "closed",
                  "--requests", "3", "--concurrency", "1",
                  "--slo-p99-ms", "0.000001", "--out", out])
    assert rc == 1
    with open(out) as f:
        report = json.load(f)
    assert not report["slo"]["ok"]
    bundle_path = report["slo"]["debugz"]
    assert bundle_path and os.path.isfile(bundle_path)
    with open(bundle_path) as f:
        assert json.load(f)["bundle"] == "paddle_tpu.debugz.v1"
    assert "SLO VIOLATION" in capsys.readouterr().err


def test_loadgen_slo_pass_skips_debugz(mini_server, tmp_path):
    """``tests/test_blackbox.py:427`` against a port server."""
    _eng, srv = mini_server
    out = str(tmp_path / "report.json")
    rc = lg.main(["--url", srv.url, "--feat", "4", "--mode", "closed",
                  "--requests", "3", "--concurrency", "1",
                  "--slo-p99-ms", "60000", "--out", out])
    assert rc == 0
    with open(out) as f:
        assert "debugz" not in json.load(f)["slo"]


def test_loadgen_open_loop_against_live_http_server(tmp_path):
    """``tests/test_serving.py:671`` against a port server: the report
    carries qps / p99 / shed, ``/metrics`` agrees with the access log on
    request counts, a request's trace crosses two threads in ``/tracez``
    and, merged by the JAX package's ``tools/trace_export.py`` with a
    trainer directory, keeps its trace id."""
    mdir = str(tmp_path / "serve_metrics")
    tpt.set_flags({"FLAGS_metrics_dir": mdir, "FLAGS_metrics_interval": 0.0})
    predictor, shapes = lg.build_synthetic(feat=8, hidden=16, depth=1,
                                           device="cpu")
    eng = ServingEngine(predictor, workers=2, max_batch=4, max_delay_ms=2.0,
                        deadline_ms=60000, warmup_shapes=shapes)
    srv = serve(eng)
    try:
        def scrape_http_count():
            with urllib.request.urlopen(srv.url + "/metrics",
                                        timeout=30) as r:
                text = r.read().decode()
            line = [ln for ln in text.splitlines()
                    if ln.startswith("paddle_tpu_serving_http_requests ")]
            return int(line[0].split()[1]) if line else 0, text

        before, _ = scrape_http_count()
        rep = lg.run_open_loop_http(srv.url, lg.feed_maker(shapes, rows=1),
                                    qps=120, duration_s=0.5)
        assert rep["mode"] == "open" and rep["url"] == srv.url
        assert rep["requests"] > 0 and rep["ok"] > 0
        assert rep["failed"] == 0 and rep["shed"] == 0
        assert rep["qps"] > 0 and rep["target_qps"] == 120
        assert {"p50", "p95", "p99"} <= set(rep["latency_ms"])
        assert rep["engine"] is None
        assert rep["statusz"]["engine"]["stats"]["counters"]["served"] \
            >= rep["ok"]
        after, text = scrape_http_count()
        with open(os.path.join(mdir, "access.jsonl")) as f:
            lines = [json.loads(ln) for ln in f if ln.strip()]
        assert after - before == rep["requests"] == len(lines)
        assert all(ln["status"] == 200 and ln["trace_id"]
                   and ln["phases"]["queue_wait_ms"] is not None
                   for ln in lines)
        assert "paddle_tpu_serving_request_ms_count" in text
        assert promtext.validate_lines(text) == []
        csc = _load_tool("check_stat_catalog")
        assert csc.validate_exposition(text) == []
        with urllib.request.urlopen(srv.url + "/tracez", timeout=30) as r:
            tz = json.loads(r.read())
        recs = [t for t in tz["recent_sampled"] if t.get("spans")]
        assert recs
        rec = recs[-1]
        assert {"serving/request", "serving/admit", "serving/queue_wait",
                "serving/predict", "serving/respond"} <= \
            {s["name"] for s in rec["spans"]}
        assert len({s["tid"] for s in rec["spans"]}) >= 2
        srv.close()  # flush writes trace.json into mdir
        other = str(tmp_path / "trainer_metrics")
        telemetry.export_chrome_trace(
            os.path.join(other, "trace.json"),
            spans=[s for s in telemetry.get_spans()
                   if s.name.startswith("executor/")])
        out = str(tmp_path / "merged.json")
        r = subprocess.run(
            [sys.executable, os.path.join(REPO, "tools", "trace_export.py"),
             "--metrics-dir", other, "--metrics-dir", mdir, out],
            capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stdout + r.stderr
        with open(out) as f:
            evs = json.load(f)["traceEvents"]
        merged = [e for e in evs
                  if e.get("args", {}).get("trace_id") == rec["trace_id"]]
        assert {e["name"] for e in merged} >= {"serving/request",
                                               "serving/predict"}
        assert len({e["tid"] for e in merged}) >= 2
    finally:
        srv.close()


def _run_cli(args, timeout=240):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.serving_loadgen"]
        + args, capture_output=True, text=True, timeout=timeout, env=env,
        cwd=REPO)


def test_serving_loadgen_cli(tmp_path):
    """``tests/test_serving.py:776``: the CLI as a subprocess."""
    out = str(tmp_path / "report.json")
    r = _run_cli(["--synthetic", "--feat", "8", "--hidden", "16",
                  "--depth", "1", "--mode", "both", "--requests", "24",
                  "--concurrency", "4", "--qps", "120", "--duration", "0.4",
                  "--workers", "2", "--max-batch", "4", "--device", "cpu",
                  "--out", out])
    assert r.returncode == 0, r.stdout + r.stderr
    with open(out) as f:
        report = json.load(f)
    assert report["mode"] == "both"
    for mode in ("closed", "open"):
        leg = report[mode]
        assert leg["ok"] > 0 and leg["failed"] == 0
        assert {"p50", "p95", "p99"} <= set(leg["latency_ms"])
        assert "batch_fill_pct" in leg["engine"]
    assert report["closed"]["ok"] == 24


def test_serving_loadgen_cli_needs_a_gpu_or_the_cpu(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device exists")
    r = _run_cli(["--synthetic", "--requests", "2"])
    assert r.returncode != 0 and "no CUDA device" in r.stderr


def test_loadgen_generate_cli(tmp_path):
    """``tests/test_generation.py:467``: the generation CLI as a
    subprocess, on the CPU."""
    out = tmp_path / "rep.json"
    r = _run_cli(["--generate", "--mode", "closed", "--requests", "6",
                  "--concurrency", "3", "--gen-slots", "2", "--gen-max-seq",
                  "32", "--gen-out-mean", "4", "--gen-out-max", "8",
                  "--gen-hidden", "32", "--gen-vocab", "64", "--device",
                  "cpu", "--out", str(out)], timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    rep = json.loads(out.read_text())
    assert rep["ok"] == 6 and rep["generated_tokens"] > 0


def _gen_server(max_new_tokens=8):
    pred, _shapes = lg.build_synthetic(4, 8, 1, device="cpu")
    eng = ServingEngine(pred, workers=1)
    gen = GenerationEngine(TINY_LLAMA, num_slots=2, max_seq_len=64,
                           max_new_tokens=max_new_tokens, attn_impl="xla",
                           seed=0, deadline_ms=60000.0, device="cpu")
    eng.attach_generator(gen)
    gen.warmup()
    return eng, ServingServer(eng).start()


def test_ttft_histograms_on_live_metrics_and_stream():
    """``tests/test_fleet_observatory.py:609`` against a port server."""
    _eng, srv = _gen_server()
    try:
        mk = lg.prompt_maker(64, 4, 8, 4.0, 6)
        rep = lg.run_closed_loop_generate_http(srv.url, mk, 6, 2,
                                               stream=True)
        assert rep["ok"] == 6 and rep["failed"] == 0
        assert rep["ttft_ms"]["count"] == 6
        assert rep["inter_token_ms"]["count"] > 0
        with urllib.request.urlopen(srv.url + "/metrics", timeout=30) as r:
            text = r.read().decode()
        assert promtext.validate_lines(text) == []
        fams = promtext.parse_exposition(text)
        assert fams["paddle_tpu_serving_ttft_ms"].histogram_count() >= 6
        assert fams["paddle_tpu_serving_inter_token_ms"] \
            .histogram_count() > 0
        with urllib.request.urlopen(srv.url + "/tracez", timeout=30) as r:
            gen_tz = json.loads(r.read())["generation"]
        assert gen_tz["ttft_exemplars"]
        known = {rec["trace_id"] for rec in gen_tz["recent"]} \
            | {rec["trace_id"] for rec in gen_tz["slowest"]}
        assert gen_tz["ttft_exemplars"][0]["trace_id"] in known
        assert lg.check_slo(rep, ttft_ms=60000.0, itl_ms=60000.0)["ok"]
        slo = lg.check_slo(rep, ttft_ms=0.0001)
        assert not slo["ok"] and "TTFT" in slo["violations"][0]
        plain = lg.run_closed_loop_generate_http(srv.url, mk, 2, 1,
                                                 stream=False)
        assert not lg.check_slo(plain, ttft_ms=60000.0)["ok"]
    finally:
        srv.close()


def test_stream_through_router_is_not_buffered():
    """``tests/test_fleet_observatory.py:659`` through a port router: with
    decode steps slowed to ~40 ms the client sees TTFT well below the
    total and gaps near the delay; an injected connect failure on the
    stream path fails the request, never hangs it; a spent deadline
    sheds before any forward."""
    from paddle_tpu_torch.serving import Router, RouterServer

    _eng, srv = _gen_server(max_new_tokens=16)
    router = Router([srv.url], poll_interval_ms=200.0, autostart=False)
    rserver = RouterServer(router).start()
    router.poll_once()
    try:
        fault.configure("decode_step:delay:40~1.0")
        body = json.dumps({"prompt": list(range(1, 9)),
                           "max_new_tokens": 10, "stream": True}).encode()
        outcome, ntok, ttft, gaps = lg._http_generate_stream(
            rserver.url + "/generate", body, 120.0)
        assert outcome == "ok" and ntok == 10
        total = ttft + sum(gaps)
        assert sum(1 for g in gaps if g >= 30.0) >= 7, gaps
        assert ttft < total * 0.5, (ttft, total)
        fault.configure("")
        fault.configure("router_forward:fail@1")
        outcome, ntok, _, _ = lg._http_generate_stream(
            rserver.url + "/generate", body, 30.0)
        assert outcome == "failed" and ntok == 0
        fault.configure("")
        req = urllib.request.Request(
            rserver.url + "/generate", data=body,
            headers={"Content-Type": "application/json",
                     "X-PaddleTPU-Deadline-Ms": "0.0"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 503
        assert json.loads(e.value.read())["reason"] == "deadline"
    finally:
        fault.configure("")
        rserver.close()
        router.close()
        srv.close()


def test_profilez_endpoint_contract(tmp_path):
    """``tests/test_observatory.py:287`` against a port server, its one
    request posted by the loadgen's HTTP helpers."""
    tpt.set_flags({"FLAGS_telemetry": True,
                   "FLAGS_metrics_dir": str(tmp_path)})
    predictor, shapes = lg.build_synthetic(feat=4, hidden=8, depth=1,
                                           classes=2, device="cpu")
    eng = ServingEngine(predictor, workers=1, max_batch=2,
                        max_delay_ms=1.0, deadline_ms=60000)
    srv = serve(eng)
    try:
        with urllib.request.urlopen(srv.url + "/profilez?sec=0.15",
                                    timeout=60) as r:
            assert r.status == 200
            rep = json.loads(r.read())
        assert rep["files"] and rep["bytes"] > 0
        assert os.path.isdir(rep["dir"])
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(srv.url + "/profilez?sec=abc",
                                   timeout=30)
        assert e.value.code == 400
        tpt.set_flags({"FLAGS_telemetry": False})
        try:
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(srv.url + "/profilez?sec=0.1",
                                       timeout=30)
            assert e.value.code == 503
        finally:
            tpt.set_flags({"FLAGS_telemetry": True})
        make_feed = lg.feed_maker(shapes, rows=1)
        outcome, _version = lg._http_predict(
            srv.url + "/predict", lg._encode_bodies(make_feed, 1)[0], 60.0)
        assert outcome == "ok"
    finally:
        srv.close()


def test_many_clients_connecting_at_once_lose_no_request():
    """A closed loop of 48 clients through a port router over two port
    servers: every request answered.  With socketserver's default listen
    backlog of 5 a few connections were reset before any handler saw
    them; the port's listeners keep a backlog of 128."""
    from paddle_tpu_torch.serving import Router, RouterServer
    from paddle_tpu_torch.serving.server import _HTTPServer

    assert _HTTPServer.request_queue_size >= 128
    servers = []
    for _ in range(2):
        eng, _pred, shapes = _engine(max_batch=8)
        eng.warmup(shapes)
        servers.append(ServingServer(eng).start())
    router = Router([s.url for s in servers], autostart=False)
    rserver = RouterServer(router).start()
    router.poll_once()
    try:
        assert rserver._httpd.request_queue_size >= 128
        rep = lg.run_closed_loop_http(
            rserver.url, lg.feed_maker({"x": (4,)}), 768, 48)
        assert rep["ok"] == 768 and rep["failed"] == 0, rep
    finally:
        rserver.close()
        router.close()
        for s in servers:
            s.close()


# ---------------------------------------------------------------------------
# a live port fleet behind a port router
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fleet():
    sup = FleetSupervisor(replicas=2, replica_argv=TINY_ARGV,
                          max_restarts=3, backoff_ms=100.0)
    try:
        sup.wait_ready(timeout_s=240)
        yield sup
    finally:
        sup.close()


def test_loadgen_live_fleet_e2e_with_per_phase_slo(fleet, tmp_path):
    """``tests/test_router.py:576``: shaped open loop through a port
    router over port replicas, per-phase SLO; an impossible p99 budget
    fails with phase-labelled violations and exit 1."""
    router, server = router_over(fleet)
    out = tmp_path / "report.json"
    try:
        rc = lg.main(["--url", server.url, "--feat", "4", "--mode", "open",
                      "--qps", "30", "--duration", "2.0", "--shape",
                      "burst", "--traffic-amplitude", "1.0",
                      "--slo-p99-ms", "30000", "--slo-shed-pct", "60",
                      "--out", str(out)])
        assert rc == 0
        rep = json.loads(out.read_text())
        assert rep["traffic"]["shape"] == "burst"
        assert rep["phases"] and rep["slo"]["ok"]
        rc = lg.main(["--url", server.url, "--feat", "4", "--mode", "open",
                      "--qps", "30", "--duration", "1.0", "--traffic",
                      "sine", "--slo-p99-ms", "0.001", "--out", str(out)])
        assert rc == 1
        rep = json.loads(out.read_text())
        assert any("[" in v for v in rep["slo"]["violations"])
    finally:
        server.close()
        router.close()


def test_loadgen_tenants_through_the_router_and_a_replica(fleet, tmp_path):
    """``--tenants``: through the router the report embeds the federated
    tenant families (a router has no ``/usagez``), so a tenant p99 bound
    is unmeasured and violates; against a replica it reads the replica's
    ``/usagez`` and every tenant's p99 is measured."""
    router, server = router_over(fleet)
    out = tmp_path / "report.json"
    try:
        for _ in range(3):
            router.poll_once()
        rc = lg.main(["--url", server.url, "--feat", "4", "--mode",
                      "closed", "--requests", "24", "--concurrency", "4",
                      "--tenants", "4", "--tenant-dist", "uniform",
                      "--slo-tenant-p99-ms", "60000", "--out", str(out)])
        rep = json.loads(out.read_text())
        assert rc == 1 and rep["usage"]["fleet"] is True
        assert any("no per-tenant usage breakdown" in v
                   for v in rep["slo"]["violations"])
        rc = lg.main(["--url", fleet.endpoints()[0], "--feat", "4",
                      "--mode", "closed", "--requests", "24",
                      "--concurrency", "4", "--tenants", "4",
                      "--tenant-dist", "uniform", "--slo-tenant-p99-ms",
                      "60000", "--out", str(out)])
        rep = json.loads(out.read_text())
        assert rc == 0, rep["slo"]
        tenants = rep["usage"]["tenants"]
        assert {f"tenant-{i:02d}" for i in range(4)} <= set(tenants)
    finally:
        server.close()
        router.close()
