"""Helpers shared by the port's fleet-tier CPU tests
(``test_torch_router.py``, ``test_torch_fleet.py``, ``test_torch_disagg.py``):
in-process replicas over the synthetic MLP, injected health snapshots, raw
HTTP posts, open-loop HTTP traffic and a fully routable router over a
spawned fleet.  Spawned replicas get ``--device cpu``; in-process servers
run on the CPU.
"""
import argparse
import concurrent.futures
import json
import os
import signal
import socket
import time
import urllib.error
import urllib.request

from paddle_tpu_torch.framework.core import reset_unique_name
from paddle_tpu_torch.serving import Router, RouterServer, ServingEngine, \
    serve
from paddle_tpu_torch.serving.replica import build_predictor

TINY = dict(feat=4, hidden=8, depth=1, classes=2)
TINY_ARGV = ["--feat", "4", "--hidden", "8", "--depth", "1",
             "--classes", "2", "--workers", "1", "--max-batch", "2",
             "--max-delay-ms", "1", "--deadline-ms", "60000",
             "--device", "cpu"]
BODY = json.dumps({"inputs": {"x": [[0.1, 0.2, 0.3, 0.4]]}}).encode()


def synthetic(feat=4, hidden=8, depth=1, classes=2, seed=0):
    """(Predictor, per-row shapes): the replica's synthetic MLP on the
    CPU, named as a fresh replica process names it (``rep_fc0`` ...)."""
    reset_unique_name()
    args = argparse.Namespace(recsys=False, model_dir=None, shape=None,
                              feat=feat, hidden=hidden, depth=depth,
                              classes=classes, seed=seed, device="cpu")
    return build_predictor(args)


def mini_replica(ready_gate=False, warm=True, port=0, **sizes):
    predictor, shapes = synthetic(**dict(TINY, **sizes))
    eng = ServingEngine(predictor, workers=1, max_batch=2,
                        max_delay_ms=1.0, deadline_ms=60000.0,
                        ready_requires_warmup=ready_gate)
    if warm:
        eng.warmup(shapes)
    srv = serve(eng, port=port)
    return eng, srv, shapes


def inject_health(router, url, depth=0, inflight=0, status="ok",
                  ready=True, age_s=0.0, cap=64):
    """Deterministic routing-view control: write the health snapshot
    the poll thread would have produced."""
    rep = router._replicas[url.rstrip("/")]
    rep.health = {"status": status, "ready": ready,
                  "serving": {"queue_depth": depth,
                              "inflight_rows": inflight,
                              "queue_cap": cap}}
    rep.health_ts = time.monotonic() - age_s
    rep.poll_failures = 0
    rep.ejected = False
    return rep


def post(url, body=BODY, trace=None, timeout=30.0, route="/predict"):
    """POST that raises on an HTTP error (as urllib does)."""
    headers = {"Content-Type": "application/json"}
    if trace:
        headers["X-PaddleTPU-Trace"] = trace
    if not isinstance(body, bytes):
        body = json.dumps(body).encode()
    req = urllib.request.Request(url + route, data=body, headers=headers)
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read()), dict(r.headers)


def post_raw(url, body=BODY, headers=None, route="/predict",
             timeout=30.0):
    """(status, json body, headers) for any status."""
    h = {"Content-Type": "application/json"}
    h.update(headers or {})
    req = urllib.request.Request(url + route, data=body, headers=h)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers)


def get_json(url, timeout=30.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        assert r.status == 200
        return json.loads(r.read())


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def open_loop(url, qps, duration_s, body=BODY, timeout=60.0):
    """Open-loop traffic: one POST every 1/qps seconds for duration_s,
    each on its own pool thread.  A 200 is ok, a 503 a shed (explicit
    backpressure), anything else (another code, a socket error) a
    failure."""
    n = max(1, int(qps * duration_s))
    out = {"requests": n, "ok": 0, "shed": 0, "failed": 0, "errors": []}

    def one():
        try:
            code, _doc, _h = post_raw(url, body, timeout=timeout)
        except OSError as e:
            return None, f"{type(e).__name__}: {e}"
        return code, None

    t0 = time.monotonic()
    with concurrent.futures.ThreadPoolExecutor(max_workers=32) as pool:
        futs = []
        for i in range(n):
            wait = t0 + i / qps - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            futs.append(pool.submit(one))
        for f in futs:
            code, err = f.result()
            if code == 200:
                out["ok"] += 1
            elif code == 503:
                out["shed"] += 1
            else:
                out["failed"] += 1
                out["errors"].append(err or code)
    return out


def router_over(sup, timeout_s=30.0, **kw):
    """A Router (polling) and its RouterServer over a ready fleet, once
    every replica is routable."""
    kw = dict(dict(poll_interval_ms=60.0, stale_ms=2000.0, eject_after=2),
              **kw)
    router = Router(sup.endpoints(), **kw)
    server = RouterServer(router).start()
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        router.poll_once()
        if router.stats()["routable"] == len(sup.endpoints()):
            return router, server
        time.sleep(0.1)
    server.close()
    router.close()
    raise AssertionError("fleet never became fully routable")


def wait_respawned(rep, old_pid, timeout_s=60.0, hung_kill=False):
    """Wait until the supervisor's slot ``rep`` runs a new life that
    answers ``ready`` on its (pinned) URL."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if rep.proc.pid != old_pid and rep.proc.poll() is None \
                and (rep.hung_kills >= 1 or not hung_kill):
            try:
                with urllib.request.urlopen(rep.url + "/healthz",
                                            timeout=2) as r:
                    if json.loads(r.read()).get("ready"):
                        return
            except OSError:
                pass  # ok: successor still binding/warming
        time.sleep(0.2)
    raise AssertionError(f"replica {rep.idx} never respawned ready")


def kill(pid, sig=signal.SIGKILL):
    try:
        os.kill(pid, sig)
    except ProcessLookupError:
        pass
