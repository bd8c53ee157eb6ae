"""The port's fleet router on the CPU: twins of ``tests/test_router.py``
and of the router and fleet tests of ``tests/test_fault_containment.py``,
then the port's router, parser and fleet against the JAX package's.

Two tiers, as in the reference: in-process (port ServingServers behind a
port Router in one process — placement, ejection, retry, deadlines,
timeouts, traces; deterministic through injected health snapshots and a
manual poll) and subprocess (a real port ``FleetSupervisor`` of
``python -m paddle_tpu_torch.serving.replica --device cpu`` processes —
crash → respawn, drain-aware rolling restart, a SIGSTOP'd replica, a
``--generate`` replica).  The module's fleet serves a small MLP saved by
the JAX package, so the same fleet carries the parity check: its routed
answers lie within fp32 1e-5 of the JAX ``Predictor``'s.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

import paddle_tpu_torch as tpt
from paddle_tpu_torch import fault, observatory, promtext, telemetry
from paddle_tpu_torch.monitor import stat_get
from paddle_tpu_torch.ops.registry import reset_op_seed
from paddle_tpu_torch.serving import (FleetSupervisor, GenerationEngine,
                                      Router, RouterServer, ServingEngine)
from paddle_tpu_torch.tools import serving_loadgen

from torch_fleet_util import (TINY_ARGV, free_port, inject_health,
                              kill, mini_replica, post, post_raw,
                              router_over, synthetic, wait_respawned)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEAT = 4


@pytest.fixture(autouse=True)
def _reset():
    fault.reset()
    yield
    fault.reset()
    tpt.set_flags({"FLAGS_fault_inject": "", "FLAGS_telemetry": True,
                   "FLAGS_serving_access_log": "",
                   "FLAGS_router_default_deadline_ms": 0.0,
                   "FLAGS_serving_worker_stuck_ms": 10000.0})


# ---------------------------------------------------------------------------
# placement + tiering (unit: injected health, no poll thread)
# ---------------------------------------------------------------------------

def test_least_loaded_placement_and_tiering():
    urls = ["http://a:1", "http://b:1", "http://c:1"]
    router = Router(urls, autostart=False, stale_ms=2000.0)
    inject_health(router, urls[0], depth=5)
    inject_health(router, urls[1], depth=1)
    inject_health(router, urls[2], depth=9)
    assert router.pick().url == "http://b:1"

    # router-side inflight counts toward the score
    router._replicas["http://b:1"].inflight = 10
    assert router.pick().url == "http://a:1"
    router._replicas["http://b:1"].inflight = 0

    # degraded: below ANY fresh-ok replica, even a busier one
    inject_health(router, urls[1], depth=0, status="degraded")
    assert router.pick().url == "http://a:1"

    # stale: same second tier
    inject_health(router, urls[0], depth=0, age_s=10.0)
    inject_health(router, urls[2], depth=3)
    assert router.pick().url == "http://c:1"

    # only stale/degraded replicas: still served, least-loaded
    inject_health(router, urls[2], depth=3, age_s=10.0)
    assert router.pick() is not None

    # ejected / not-ready / draining are never picked
    for u in urls:
        router._replicas[u].ejected = True
    assert router.pick() is None
    inject_health(router, urls[0], ready=False)
    assert router.pick() is None
    inject_health(router, urls[0], status="draining")
    assert router.pick() is None
    inject_health(router, urls[0])
    assert router.pick(exclude=("http://a:1",)) is None


def test_skewed_load_routes_to_the_idle_replica():
    eng_a, srv_a, _ = mini_replica()
    eng_b, srv_b, _ = mini_replica()
    router = Router([srv_a.url, srv_b.url], autostart=False)
    server = RouterServer(router).start()
    try:
        router.poll_once()
        inject_health(router, srv_a.url, depth=50)
        for _ in range(10):
            assert post(server.url)[0] == 200
        assert eng_b.stats()["counters"]["requests"] == 10
        assert eng_a.stats()["counters"]["requests"] == 0
        st = router.stats()
        assert st["counters"]["routed"] == 10
        by_url = {r["url"]: r for r in st["replicas"]}
        assert by_url[srv_b.url]["routed"] == 10
        assert by_url[srv_a.url]["routed"] == 0
    finally:
        server.close()
        srv_a.close()
        srv_b.close()


# ---------------------------------------------------------------------------
# empty-fleet 503 + readiness gating
# ---------------------------------------------------------------------------

def test_no_ready_replicas_503_and_warmup_readiness_gate():
    router = Router([], autostart=False)
    server = RouterServer(router).start()
    srv = None
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            post(server.url)
        assert e.value.code == 503
        assert json.loads(e.value.read())["reason"] == "no_ready_replicas"
        code, payload = router.healthz()
        assert code == 503 and payload["status"] == "no_ready_replicas"

        # a warming replica registers but is NOT routable
        eng, srv, shapes = mini_replica(ready_gate=True, warm=False)
        router.add_replica(srv.url)
        router.poll_once()
        assert eng.health()["ready"] is False and eng.warming()
        with pytest.raises(urllib.error.HTTPError) as e:
            post(server.url)
        assert e.value.code == 503
        assert json.loads(e.value.read())["reason"] == "no_ready_replicas"

        eng.warmup(shapes)
        assert eng.health()["ready"] is True and not eng.warming()
        router.poll_once()
        assert post(server.url)[0] == 200
        assert router.healthz()[0] == 200
    finally:
        server.close()
        if srv is not None:
            srv.close()


# ---------------------------------------------------------------------------
# stale-health ejection + recovery, retry-on-connect-refused
# ---------------------------------------------------------------------------

def test_stale_health_ejection_and_recovery():
    _eng, srv, _ = mini_replica()
    port = srv.port
    router = Router([srv.url], autostart=False, stale_ms=400.0,
                    eject_after=2)
    server = RouterServer(router).start()
    try:
        router.poll_once()
        assert router.pick() is not None
        url = srv.url
        srv.close()
        router.poll_once()
        router.poll_once()
        snap = router.stats()["replicas"][0]
        assert snap["ejected"] is True and snap["poll_failures"] >= 2
        assert router.pick() is None
        with pytest.raises(urllib.error.HTTPError) as e:
            post(server.url)
        assert e.value.code == 503

        # a new process binds the SAME port: one good poll re-admits it
        _eng2, srv2, _ = mini_replica(port=port)
        assert srv2.url == url
        try:
            router.poll_once()
            assert router.stats()["replicas"][0]["ejected"] is False
            assert router.stats()["counters"]["recoveries"] >= 1
            assert post(server.url)[0] == 200
        finally:
            srv2.close()
    finally:
        server.close()


def test_retry_on_connect_refused_lands_on_alternate():
    _eng_b, srv_b, _ = mini_replica()
    dead_url = f"http://127.0.0.1:{free_port()}"
    router = Router([dead_url, srv_b.url], autostart=False, eject_after=1)
    server = RouterServer(router).start()
    try:
        router.poll_once()
        inject_health(router, dead_url, depth=0)
        inject_health(router, srv_b.url, depth=5)
        code, doc, _ = post(server.url)
        assert code == 200 and "outputs" in doc
        st = router.stats()
        assert st["counters"]["retries"] == 1
        by_url = {r["url"]: r for r in st["replicas"]}
        assert by_url[srv_b.url]["retries_to"] == 1
        assert by_url[dead_url]["ejected"] is True
    finally:
        server.close()
        srv_b.close()


# ---------------------------------------------------------------------------
# trace continuity across the hop, strict /metrics
# ---------------------------------------------------------------------------

def test_trace_continuity_across_router_hop(tmp_path):
    tpt.set_flags({"FLAGS_telemetry": True, "FLAGS_trace_sample": 1.0,
                   "FLAGS_serving_access_log":
                       str(tmp_path / "access.jsonl")})
    _eng, srv, _ = mini_replica()
    router = Router([srv.url], autostart=False)
    server = RouterServer(router).start()
    try:
        router.poll_once()
        wanted = "cafef00d" * 3
        code, doc, headers = post(server.url, trace=wanted)
        assert code == 200
        assert doc["trace_id"] == wanted
        assert headers.get("X-PaddleTPU-Trace") == wanted
        code, doc2, _ = post(server.url)
        assert code == 200 and doc2["trace_id"]
        names = {s.name for s in telemetry.get_spans()
                 if s.trace_id == wanted}
        assert {"router/request", "router/forward", "serving/request",
                "serving/predict"} <= names
        with open(tmp_path / "access.jsonl") as f:
            recs = [json.loads(line) for line in f]
        mine = [r for r in recs if r["trace_id"] == wanted]
        assert {r.get("tier", "replica") for r in mine} == \
            {"router", "replica"}
    finally:
        server.close()
        srv.close()


def test_router_metrics_scrape_is_strict_prometheus():
    _eng, srv, _ = mini_replica()
    router = Router([srv.url], autostart=False)
    server = RouterServer(router).start()
    try:
        router.poll_once()
        assert post(server.url)[0] == 200
        with urllib.request.urlopen(server.url + "/metrics",
                                    timeout=30) as r:
            assert r.status == 200
            assert "version=0.0.4" in r.headers["Content-Type"]
            text = r.read().decode()
    finally:
        server.close()
        srv.close()
    assert promtext.validate_lines(text) == []
    assert "paddle_tpu_router_http_requests" in text
    assert "paddle_tpu_fleet_wanted_replicas" in text


# ---------------------------------------------------------------------------
# deadlines, timeouts, health fault site, stuck worker (fault containment)
# ---------------------------------------------------------------------------

class _CaptureReplica(BaseHTTPRequestHandler):
    """A replica stand-in: healthy /healthz, records every forwarded
    request's headers, optionally sleeps before answering /predict."""
    protocol_version = "HTTP/1.1"
    seen = None
    predict_sleep_s = 0.0

    def log_message(self, *a):
        pass

    def _send(self, code, payload):
        body = json.dumps(payload).encode()
        try:
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except OSError:
            pass  # ok: the router timed out and closed the socket

    def do_GET(self):
        self._send(200, {"status": "ok", "ready": True,
                         "serving": {"queue_depth": 0, "inflight_rows": 0,
                                     "queue_cap": 64}})

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0) or 0)
        self.rfile.read(n)
        type(self).seen.append({k.lower(): v
                                for k, v in self.headers.items()})
        if type(self).predict_sleep_s:
            time.sleep(type(self).predict_sleep_s)
        self._send(200, {"outputs": [[0.0]]})


def _capture_replica(sleep_s=0.0):
    handler = type("Cap", (_CaptureReplica,),
                   {"seen": [], "predict_sleep_s": sleep_s})
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    httpd.daemon_threads = True
    threading.Thread(target=httpd.serve_forever,
                     kwargs={"poll_interval": 0.1}, daemon=True).start()
    return httpd, handler, f"http://127.0.0.1:{httpd.server_address[1]}"


def _stop(httpd):
    httpd.shutdown()
    httpd.server_close()


def test_router_mints_decrements_and_sheds_deadlines():
    httpd, handler, url = _capture_replica()
    router = Router([url], autostart=False)
    server = RouterServer(router).start()
    try:
        router.poll_once()
        code, _, _ = post_raw(server.url,
                              headers={"X-PaddleTPU-Deadline-Ms": "5000"})
        assert code == 200
        assert 4000.0 < float(handler.seen[-1]["x-paddletpu-deadline-ms"]) \
            <= 5000.0
        tpt.set_flags({"FLAGS_router_default_deadline_ms": 4000.0})
        assert post_raw(server.url)[0] == 200
        assert 3000.0 < float(handler.seen[-1]["x-paddletpu-deadline-ms"]) \
            <= 4000.0
        before = len(handler.seen)
        code, body, _ = post_raw(server.url,
                                 headers={"X-PaddleTPU-Deadline-Ms": "0"})
        assert code == 503 and body["reason"] == "deadline"
        assert len(handler.seen) == before
        assert router.stats()["counters"]["deadline_sheds"] == 1
    finally:
        server.close()
        _stop(httpd)


def test_router_no_ready_replicas_503_carries_retry_after():
    router = Router([], autostart=False)
    server = RouterServer(router).start()
    try:
        code, body, headers = post_raw(server.url)
        assert code == 503 and body["reason"] == "no_ready_replicas"
        assert int(headers["Retry-After"]) >= 1
    finally:
        server.close()


def test_router_forward_timeout_hung_replica_504_and_health_strike():
    httpd, _handler, url = _capture_replica(sleep_s=3.0)
    router = Router([url], autostart=False, forward_timeout_ms=250.0)
    server = RouterServer(router).start()
    try:
        router.poll_once()
        t0 = time.monotonic()
        code, body, _ = post_raw(
            server.url, headers={"X-PaddleTPU-Trace": "deadbeef01"})
        elapsed = time.monotonic() - t0
        assert code == 504 and body["error"] == "forward_timeout"
        assert body["trace_id"] == "deadbeef01"
        assert elapsed < 2.5
        assert router.stats()["counters"]["forward_timeouts"] == 1
        assert router._replicas[url].poll_failures >= 1
        with urllib.request.urlopen(server.url + "/statusz",
                                    timeout=5) as r:
            assert r.status == 200
    finally:
        server.close()
        _stop(httpd)


def test_deadline_bound_timeout_is_a_shed_not_a_replica_strike():
    httpd, _handler, url = _capture_replica(sleep_s=1.0)
    router = Router([url], autostart=False, forward_timeout_ms=5000.0)
    server = RouterServer(router).start()
    try:
        router.poll_once()
        code, body, _ = post_raw(server.url,
                                 headers={"X-PaddleTPU-Deadline-Ms": "300"})
        assert code == 503 and body["reason"] == "deadline"
        n = router.stats()["counters"]
        assert n["forward_timeouts"] == 0 and n["deadline_sheds"] == 1
        assert router._replicas[url].poll_failures == 0
    finally:
        server.close()
        _stop(httpd)


class _CutShortReplica(_CaptureReplica):
    """A replica that dies while it answers: /predict's reply promises
    more bytes than it sends, then the connection closes."""

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0) or 0)
        self.rfile.read(n)
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", "4096")
        self.end_headers()
        self.wfile.write(b'{"outputs": [[0.')
        self.wfile.flush()
        self.close_connection = True


def test_reply_cut_short_retries_on_alternate():
    """A replica killed mid-reply (the router reads an IncompleteRead)
    is a connect-level failure: struck, and the request replayed once on
    an alternate, so the client gets the alternate's 200."""
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _CutShortReplica)
    httpd.daemon_threads = True
    threading.Thread(target=httpd.serve_forever,
                     kwargs={"poll_interval": 0.1}, daemon=True).start()
    cut_url = f"http://127.0.0.1:{httpd.server_address[1]}"
    _eng, good_srv, _ = mini_replica()
    router = Router([cut_url, good_srv.url], autostart=False)
    server = RouterServer(router).start()
    try:
        router.poll_once()
        router._replicas[good_srv.url].health["serving"]["queue_depth"] = 5
        code, body, _ = post_raw(server.url)
        assert code == 200 and body["outputs"]
        n = router.stats()["counters"]
        assert n["retries"] == 1 and n["replica_errors"] == 0
        assert router._replicas[cut_url].poll_failures >= 1
    finally:
        server.close()
        good_srv.close()
        _stop(httpd)


def test_router_forward_timeout_retries_once_on_alternate():
    hang_httpd, _h, hang_url = _capture_replica(sleep_s=3.0)
    _eng, good_srv, _ = mini_replica()
    router = Router([hang_url, good_srv.url], autostart=False,
                    forward_timeout_ms=250.0)
    server = RouterServer(router).start()
    try:
        router.poll_once()
        router._replicas[good_srv.url].health["serving"]["queue_depth"] = 5
        code, body, _ = post_raw(server.url)
        assert code == 200 and body["outputs"]
        n = router.stats()["counters"]
        assert n["forward_timeouts"] == 1 and n["retries"] == 1
    finally:
        server.close()
        good_srv.close()
        _stop(hang_httpd)


def test_replica_health_fault_site_drives_ejection_and_recovery():
    _eng, srv, _ = mini_replica()
    router = Router([srv.url], autostart=False, eject_after=2)
    try:
        router.poll_once()
        assert router.stats()["routable"] == 1
        fault.configure("replica_health:fail@1+")
        router.poll_once()
        router.poll_once()
        rep = router._replicas[srv.url]
        assert rep.ejected
        assert router.stats()["counters"]["ejections"] == 1
        fault.configure("")
        router.poll_once()
        assert not rep.ejected
        assert router.stats()["counters"]["recoveries"] == 1
    finally:
        router.close()
        srv.close()


def test_stuck_worker_watchdog_degrades_and_recovers():
    p, _ = synthetic(feat=6, hidden=16, classes=3, seed=20)
    tpt.set_flags({"FLAGS_serving_worker_stuck_ms": 100.0})
    fault.configure("serve_batch:delay:1200@1")
    eng = ServingEngine(p, workers=1, max_batch=4, max_delay_ms=1.0,
                        deadline_ms=60000)
    try:
        fut = eng.submit({"x": np.random.rand(1, 6).astype("float32")})
        time.sleep(0.5)
        wh = eng.worker_health()
        assert wh[0]["status"] == "stuck" and wh[0]["stuck_ms"] >= 100.0
        assert eng.health()["status"] == "degraded"
        assert fut.result(30) is not None
        assert eng.worker_health()[0]["status"] == "ok"
        assert eng.health()["status"] == "ok"
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# against the JAX package: the pick() sequence and the exposition parser
# ---------------------------------------------------------------------------

def _seeded_snapshots(rng, urls, steps):
    """A seeded sequence of /healthz snapshots (load, status, ready,
    age, router inflight, role, paged generation) for every replica."""
    seq = []
    for _ in range(steps):
        snap = {}
        for u in urls:
            snap[u] = dict(
                depth=int(rng.randint(0, 6)),
                inflight_rows=int(rng.randint(0, 4)),
                status=str(rng.choice(["ok"] * 6 + ["degraded",
                                                    "draining"])),
                ready=bool(rng.rand() > 0.1),
                stale=bool(rng.rand() < 0.2),
                router_inflight=int(rng.randint(0, 3)),
                role=str(rng.choice(["both", "prefill", "decode"])),
                paged=bool(rng.rand() > 0.3),
                ejected=bool(rng.rand() < 0.1))
        seq.append(snap)
    return seq


def _apply(router, snap, now):
    for u, s in snap.items():
        rep = router._replicas[u]
        rep.health = {"status": s["status"], "ready": s["ready"],
                      "role": s["role"],
                      "generation": {"paged": {"pages_live": 0}
                                     if s["paged"] else None},
                      "serving": {"queue_depth": s["depth"],
                                  "inflight_rows": s["inflight_rows"],
                                  "queue_cap": 64}}
        rep.health_ts = now - (10.0 if s["stale"] else 0.0)
        rep.inflight = s["router_inflight"]
        rep.ejected = s["ejected"]


def test_pick_sequence_matches_the_jax_router():
    """Tolerance: exact (the same replica every pick, canary split
    included)."""
    from paddle_tpu.serving.router import Router as JaxRouter

    urls = [f"http://10.0.0.{i}:8000" for i in range(5)]
    ours = Router(urls, autostart=False, stale_ms=2000.0)
    ref = JaxRouter(urls, autostart=False, stale_ms=2000.0)
    rng = np.random.RandomState(15)
    picks_ours, picks_ref = [], []
    try:
        for step, snap in enumerate(_seeded_snapshots(rng, urls, 200)):
            if step == 100:
                # a canary soak over two replicas splits the rest
                canary = {"urls": urls[:2], "fraction": 0.3}
                ours._canary, ref._canary = dict(canary), dict(canary)
            now = time.monotonic()
            _apply(ours, snap, now)
            _apply(ref, snap, now)
            excl = (urls[step % 5],) if step % 7 == 0 else ()
            for role in (None, "prefill", "decode"):
                a = ours.pick(exclude=excl, role=role)
                b = ref.pick(exclude=excl, role=role)
                picks_ours.append(a.url if a else None)
                picks_ref.append(b.url if b else None)
        assert picks_ours == picks_ref
        assert len({p for p in picks_ours if p}) == 5
        assert ours._canary_accum == ref._canary_accum
    finally:
        ours.close()
        ref.close()


def test_promtext_parsers_read_the_port_metrics_identically():
    """Tolerance: exact (every family's type, every sample's name,
    labels and value)."""
    from paddle_tpu import promtext as jax_promtext

    tpt.set_flags({"FLAGS_telemetry": True})
    _eng, srv, _ = mini_replica()
    try:
        for i in range(3):
            post_raw(srv.url, headers={"X-PaddleTPU-Tenant": f"t{i % 2}"})
        with urllib.request.urlopen(srv.url + "/metrics", timeout=30) as r:
            text = r.read().decode()
    finally:
        srv.close()
    assert promtext.validate_lines(text) == []
    assert jax_promtext.validate_lines(text) == []
    ours = promtext.parse_exposition(text, strict=True)
    ref = jax_promtext.parse_exposition(text, strict=True)
    assert sorted(ours) == sorted(ref) and len(ours) > 20

    def view(fams):
        return {n: (f.type, [(s.name, sorted(s.labels.items()), s.value)
                             for s in f.samples])
                for n, f in fams.items()}

    assert view(ours) == view(ref)
    assert ours["paddle_tpu_serving_http_requests"].value() >= 3.0


# ---------------------------------------------------------------------------
# the replica process: the card unless --device cpu, no fallback
# ---------------------------------------------------------------------------

def test_replica_refuses_to_serve_without_a_gpu(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("the no-GPU exit is what this host cannot show")
    ep = tmp_path / "ep.json"
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-m",
                        "paddle_tpu_torch.serving.replica",
                        "--endpoint-file", str(ep)],
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "--device cpu" in r.stderr and "no CUDA device" in r.stderr
    assert not ep.exists()  # it never bound
    r = subprocess.run([sys.executable, "-m",
                        "paddle_tpu_torch.serving.replica", "--device",
                        "cpu", "--recsys", "--endpoint-file", str(ep)],
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "queue 1 item 8" in r.stderr
    assert not ep.exists()


# ---------------------------------------------------------------------------
# live fleet (subprocess replicas): the JAX-saved model, crash, rollout,
# SIGSTOP
# ---------------------------------------------------------------------------

def _save_jax_mlp(dirname):
    """A small relu MLP from a seed, saved by the JAX package; returns
    the JAX Predictor over the saved directory."""
    import paddle_tpu as pt
    from paddle_tpu import io, layers
    from paddle_tpu.inference import Predictor as JaxPredictor

    main, startup = pt.Program(), pt.Program()
    startup._is_startup = True
    startup.random_seed = main.random_seed = 11
    with pt.program_guard(main, startup):
        x = layers.data("x", [FEAT])
        h = layers.fc(x, 16, act="relu", name="jx_fc0")
        out = layers.fc(h, 3, name="jx_head")
    scope = pt.Scope()
    exe = pt.Executor()
    exe.run(startup, scope=scope)
    with pt.scope_guard(scope):
        io.save_inference_model(dirname, ["x"], [out], exe,
                                main_program=main)
    return JaxPredictor(dirname)


@pytest.fixture(scope="module")
def jax_model(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("jax_mlp"))
    return d, _save_jax_mlp(d)


@pytest.fixture(scope="module")
def fleet(jax_model):
    d, _ = jax_model
    argv = ["--model-dir", d, "--shape", f"x={FEAT}", "--workers", "1",
            "--max-batch", "4", "--max-delay-ms", "1", "--deadline-ms",
            "60000", "--device", "cpu"]
    sup = FleetSupervisor(replicas=2, replica_argv=argv, max_restarts=3,
                          backoff_ms=100.0)
    try:
        sup.wait_ready(timeout_s=240)
        yield sup
    finally:
        sup.close()


def test_fleet_serves_the_jax_saved_model_within_1e5(fleet, jax_model):
    """Tolerance: fp32 max |d| <= 1e-5 against the JAX Predictor on the
    same rows, through the port's router and both replicas."""
    _d, jax_pred = jax_model
    router, server = router_over(fleet)
    try:
        rng = np.random.RandomState(3)
        for rows in (1, 2, 3, 4, 1, 3):
            x = rng.randn(rows, FEAT).astype("float32")
            want = np.asarray(jax_pred.run({"x": x})[0])
            code, doc, _ = post(server.url, {"inputs": {"x": x.tolist()}})
            assert code == 200
            got = np.asarray(doc["outputs"][0], "float32")
            assert got.shape == want.shape
            assert np.max(np.abs(got - want)) <= 1e-5
        assert router.stats()["counters"]["routed"] == 6
        # each replica answers the same rows directly too
        for url in fleet.endpoints():
            code, doc, _ = post(url, {"inputs": {"x": x.tolist()}})
            assert code == 200
            got = np.asarray(doc["outputs"][0], "float32")
            assert np.max(np.abs(got - want)) <= 1e-5
    finally:
        server.close()
        router.close()


def test_fleet_replica_crash_respawns_without_nonshed_failures(fleet):
    router, server = router_over(fleet)
    make_feed = serving_loadgen.feed_maker({"x": (FEAT,)}, rows=1)
    box = {}

    def _traffic():
        box["rep"] = serving_loadgen.run_open_loop_http(
            server.url, make_feed, qps=40.0, duration_s=6.0)

    try:
        t = threading.Thread(target=_traffic, daemon=True)
        t.start()
        time.sleep(1.0)
        victim = fleet._replicas[0]
        old_pid = victim.proc.pid
        kill(old_pid)
        t.join(timeout=60.0)
        assert not t.is_alive()
        rep = box["rep"]
        # only requests IN FLIGHT on the victim at the kill may fail
        assert rep["ok"] > 0.8 * rep["requests"], rep
        assert rep["failed"] <= 8, rep
        wait_respawned(victim, old_pid)
        assert victim.crash_restarts == 1
        assert victim.url in fleet.endpoints()
        router.poll_once()
        assert post(server.url)[0] == 200
    finally:
        server.close()
        router.close()


def test_rolling_restart_zero_nonshed_failure_window(fleet):
    router, server = router_over(fleet)
    make_feed = serving_loadgen.feed_maker({"x": (FEAT,)}, rows=1)
    box = {}

    def _traffic():
        box["rep"] = serving_loadgen.run_open_loop_http(
            server.url, make_feed, qps=30.0, duration_s=10.0)

    try:
        t = threading.Thread(target=_traffic, daemon=True)
        t.start()
        time.sleep(0.5)
        report = fleet.rolling_restart(ready_timeout_s=120.0)
        t.join(timeout=90.0)
        assert not t.is_alive()
        for entry in report["replicas"]:
            assert entry.get("exit_rc") == 0, report
            assert entry.get("successor_ready") is True, report
        rep = box["rep"]
        assert rep["failed"] == 0, rep
        assert rep["ok"] > 0, rep
        # a planned exit is attributed clean, never a crash
        for st in fleet.statusz()["replicas"]:
            assert st["last_death"]["attribution"] == "clean_exit", st
    finally:
        server.close()
        router.close()


def test_sigstop_replica_router_reroutes_and_supervisor_recovers(fleet):
    """SIGSTOP one of two replicas under open-loop traffic: forward
    timeouts strike it to ejection with zero failed requests, and the
    supervisor's liveness deadline (lowered to 1.2 s for this test)
    SIGKILLs the stopped PID and respawns it ready at the same URL."""
    liveness = fleet._liveness_s
    fleet._liveness_s = 1.2
    router, server = router_over(fleet, stale_ms=1500.0,
                                 forward_timeout_ms=500.0)
    make_feed = serving_loadgen.feed_maker({"x": (FEAT,)}, rows=1)
    box = {}

    def _traffic():
        box["rep"] = serving_loadgen.run_open_loop_http(
            server.url, make_feed, qps=25.0, duration_s=5.0)

    try:
        t = threading.Thread(target=_traffic, daemon=True)
        t.start()
        time.sleep(0.8)
        # replica 0: ties in least-loaded pick go to the first, so the
        # stopped one is the one holding forwards
        victim = fleet._replicas[0]
        old_pid = victim.proc.pid
        kill(old_pid, signal.SIGSTOP)
        t.join(timeout=90.0)
        assert not t.is_alive()
        rep = box["rep"]
        assert rep["failed"] == 0, rep
        assert rep["ok"] >= 0.9 * rep["requests"], rep
        n = router.stats()["counters"]
        assert n["ejections"] >= 1 and n["forward_timeouts"] >= 1, n
        wait_respawned(victim, old_pid, hung_kill=True)
        assert victim.hung_kills == 1
        assert stat_get("fleet_hung_kills") >= 1
        assert victim.last_death["attribution"] == "hung_kill"
        router.poll_once()
        assert post(server.url)[0] == 200
    finally:
        fleet._liveness_s = liveness
        server.close()
        router.close()


def test_liveness_deadline_waits_out_a_marked_profile_capture(
        fleet, monkeypatch):
    """A replica that marks a /profilez capture in its metrics dir (as
    observatory.capture_profile does; torch.profiler's stop and export
    hold its GIL) and goes silent is not SIGKILLed before the capture's
    waiver (its recording plus the stop's allowance) and the liveness
    deadline; past them it is, and respawns."""
    monkeypatch.setattr(observatory, "CAPTURE_STOP_S", 1.5)
    liveness = fleet._liveness_s
    fleet._liveness_s = 1.2
    victim = fleet._replicas[0]
    old_pid = victim.proc.pid
    kills = victim.hung_kills
    sec = 1.5
    mark = os.path.join(victim.metrics_dir, observatory.CAPTURE_MARK)
    # the deadline arms at the watchdog's first answer from this life
    deadline = time.monotonic() + 30.0
    while victim.last_alive is None and time.monotonic() < deadline:
        time.sleep(0.1)
    assert victim.last_alive is not None
    try:
        with open(mark, "w") as f:
            json.dump({"pid": old_pid, "started": time.time(),
                       "sec": sec}, f)
        t0 = time.monotonic()
        kill(old_pid, signal.SIGSTOP)
        waiver = sec + observatory.CAPTURE_STOP_S
        while time.monotonic() - t0 < waiver:
            assert victim.hung_kills == kills and victim.proc.pid == old_pid
            time.sleep(0.1)
        wait_respawned(victim, old_pid, hung_kill=True)
        assert victim.hung_kills == kills + 1
        assert victim.last_death["attribution"] == "hung_kill"
    finally:
        fleet._liveness_s = liveness
        kill(old_pid, signal.SIGKILL)
        if os.path.exists(mark):
            os.remove(mark)


GEN_TINY = dict(vocab_size=32, hidden=16, num_layers=1, num_heads=2,
                num_kv_heads=None, intermediate=32)


def _tiny_generator():
    """An in-process engine built as a ``--generate`` replica builds its
    own (the op-seed counter restarts first), so its weights are the
    replica's."""
    reset_op_seed()
    return GenerationEngine(dict(GEN_TINY), num_slots=2, max_seq_len=32,
                            max_new_tokens=32, deadline_ms=60000.0,
                            role="both", seed=0, device="cpu")


@pytest.fixture(scope="module")
def gen_fleet():
    """One ``--generate`` replica behind a router, shared by the
    generation tests of this module (the swap test runs last)."""
    sup = FleetSupervisor(
        replicas=1,
        replica_argv=TINY_ARGV + ["--generate", "--gen-vocab", "32",
                                  "--gen-hidden", "16", "--gen-layers",
                                  "1", "--gen-heads", "2",
                                  "--gen-intermediate", "32",
                                  "--gen-slots", "2", "--gen-max-seq",
                                  "32"],
        max_restarts=0)
    router = server = None
    try:
        sup.wait_ready(timeout_s=240)
        router, server = router_over(sup)
        yield sup, server
    finally:
        if server is not None:
            server.close()
            router.close()
        sup.close()


def _routed_generate(url, prompt, n, trace=None):
    headers = {"Content-Type": "application/json"}
    if trace:
        headers["X-PaddleTPU-Trace"] = trace
    req = urllib.request.Request(
        url + "/generate", headers=headers,
        data=json.dumps({"prompt": prompt, "max_new_tokens": n}).encode())
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.status == 200
        return json.loads(r.read())


def test_fleet_replica_serves_generate_through_router(gen_fleet):
    """A --generate replica serves routed POST /generate; the trace
    header is adopted by the generation path too."""
    _sup, server = gen_fleet
    doc = _routed_generate(server.url, [1, 2, 3], 4, trace="feedc0de01")
    assert doc["tokens"] and doc["finish"] in ("eos", "length",
                                               "cache_full")
    assert doc["trace_id"] == "feedc0de01"
    # the replica's generator weights come from its --seed alone (the
    # op-seed counter restarts before the engine is built, after the
    # MLP): an in-process engine built the same way gives its tokens
    gen = _tiny_generator()
    try:
        assert gen.generate([1, 2, 3], 4)["tokens"] == doc["tokens"]
    finally:
        gen.close()
    # the predict route of the same replica still answers
    assert post(server.url)[0] == 200


def test_fleet_hot_swap_of_the_generation_weights(gen_fleet, tmp_path):
    """``FleetSupervisor.hot_swap(target="generate")`` swaps the attached
    generation engine's weights in place: the rollout gate reads the
    generation engine's own ``weights_version`` (the predict engine's
    stays 1), so the swap converges with no restart fallback; the
    routed tokens then equal an in-process engine's after the same
    checkpoint's swap (tolerance 0)."""
    import pickle

    sup, server = gen_fleet
    gen = _tiny_generator()
    try:
        rng = np.random.RandomState(9)
        second = {n: (rng.randn(*gen.scope.find_var(n).shape) * 0.02
                      ).astype("float32") for n in gen._weight_names()}
        ck = tmp_path / "gen_v2"
        ck.mkdir()
        with open(ck / "__params__", "wb") as f:
            pickle.dump(second, f, protocol=2)  # as the port's io writes
        rep = sup.hot_swap(str(ck), ready_timeout_s=60.0,
                           target="generate")
        assert rep["converged"], rep
        (entry,) = rep["replicas"]
        assert entry["swap_status"] == 200 and not entry.get("fallback")
        assert entry["weights_version"] == 2
        with urllib.request.urlopen(sup.endpoints()[0] + "/healthz",
                                    timeout=10) as r:
            h = json.loads(r.read())
        assert h["generation"]["weights_version"] == 2
        assert h["weights_version"] == 1  # the predict engine's
        gen.swap_weights(str(ck))
        want = gen.generate([1, 2, 3], 6)["tokens"]
    finally:
        gen.close()
    assert _routed_generate(server.url, [1, 2, 3], 6)["tokens"] == want
