"""The port's fleet tier on the CPU: twins of the canary, warming and
fleet hot-swap tests of ``tests/test_rollout.py``, of the router and fleet
tests of ``tests/test_blackbox.py`` and of ``tests/test_fleet_observatory.py``
(promtext, federation, ``/fleetz``, usage conservation, burn alerts), the
lock-order sanitizer's serving leg (``tests/test_serving.py``) and its
unit checks, and the SLO flag both packages read.

Answers are held to tolerance 0 against a fresh port ``Predictor`` over
the same weights (on the CPU the port's product rows do not depend on
how many rows a batch has, so a padded batch answers as a row alone).
One module-scoped fleet of two spawned replicas (``--device cpu``)
carries the hot swap, the swap revert and the SIGKILL attribution.
"""
import errno
import json
import os
import signal
import socket
import struct
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu_torch as tpt
from paddle_tpu_torch import blackbox, fault, locksan, promtext, telemetry
from paddle_tpu_torch.serving import (FleetSupervisor, Router, RouterServer,
                                      ServingEngine, ServingServer, serve,
                                      usage)
from paddle_tpu_torch.serving.fleet import BIND_ERROR, ephemeral_range
from paddle_tpu_torch.serving.replica import build_synthetic_checkpoint
from paddle_tpu_torch.serving.server import VERSION_HEADER

from torch_fleet_util import (TINY_ARGV, get_json, kill, post, synthetic,
                              wait_respawned)

DIMS = dict(feat=8, hidden=16, depth=1, classes=4)


@pytest.fixture(autouse=True)
def _reset():
    fault.reset()
    yield
    fault.reset()
    tpt.set_flags({"FLAGS_fault_inject": "", "FLAGS_telemetry": True,
                   "FLAGS_metrics_dir": "", "FLAGS_blackbox": True,
                   "FLAGS_usage": True, "FLAGS_serving_check_outputs": False,
                   "FLAGS_slo_p99_ms": 0.0,
                   "FLAGS_router_slo_p99_ms": 250.0})


def _ckpt(tmp_path, name, seed, poison_nan=False, **overrides):
    d = str(tmp_path / name)
    build_synthetic_checkpoint(d, seed=seed, poison_nan=poison_nan,
                               device="cpu", **{**DIMS, **overrides})
    return d


def _probe(feat=DIMS["feat"]):
    return np.linspace(-1.0, 1.0, feat, dtype="float32").reshape(1, feat)


def _fresh_answer(ck, x, dims=DIMS):
    """A fresh port Predictor's answer on checkpoint ``ck``."""
    p, _ = synthetic(**dims)
    p.swap_weights(ck)
    return np.asarray(p.run({"x": x})[0])


def _post_json(url, doc, timeout=30.0):
    return post(url, doc, timeout=timeout, route="")


# ---------------------------------------------------------------------------
# warming replica sheds; engine swap under load never torn
# ---------------------------------------------------------------------------

def test_http_warming_replica_sheds():
    """A replica gated on warmup refuses data-plane POSTs outright
    (503 ``warming``, Retry-After, the weights version) until warmup
    returns."""
    predictor, shapes = synthetic(**DIMS)
    eng = ServingEngine(predictor, workers=1, max_batch=2,
                        max_delay_ms=1.0, deadline_ms=60000.0,
                        ready_requires_warmup=True)
    srv = serve(eng, port=0)
    try:
        x = _probe()
        with pytest.raises(urllib.error.HTTPError) as e:
            _post_json(srv.url + "/predict", {"inputs": {"x": x.tolist()}})
        assert e.value.code == 503
        assert json.loads(e.value.read())["reason"] == "warming"
        assert e.value.headers.get("Retry-After")
        assert e.value.headers.get(VERSION_HEADER) == "1"
        assert eng.health()["ready"] is False
        eng.warmup(shapes)
        code, _, _ = _post_json(srv.url + "/predict",
                                {"inputs": {"x": x.tolist()}})
        assert code == 200 and eng.health()["ready"] is True
    finally:
        srv.close()
        eng.close()


def test_engine_swap_under_load_never_torn(tmp_path):
    """Swap while requests stream through: every answer equals exactly
    one version's (a fresh predictor's on it, tolerance 0), and the
    engine never sheds."""
    p, _ = synthetic(**DIMS)
    eng = ServingEngine(p, workers=2, max_batch=4, max_delay_ms=1.0,
                        deadline_ms=60000.0)
    try:
        ck = _ckpt(tmp_path, "ck_v2", seed=2)
        x = _probe()
        old = np.asarray(eng.submit({"x": x}).result(30.0)[0])
        new = _fresh_answer(ck, x)
        assert not np.array_equal(old, new)
        futs = [eng.submit({"x": x}) for _ in range(16)]
        res = eng.swap_weights(ck, timeout_s=30.0)
        futs += [eng.submit({"x": x}) for _ in range(16)]
        assert res["weights_version"] == 2
        for f in futs:
            got = np.asarray(f.result(30.0)[0])
            assert np.array_equal(got, old) or np.array_equal(got, new)
        got = np.asarray(eng.submit({"x": x}).result(30.0)[0])
        assert np.array_equal(got, new)
        assert eng.stats()["counters"]["shed"] == 0
    finally:
        eng.close()


def test_output_check_fails_a_poisoned_checkpoint(tmp_path):
    """``FLAGS_serving_check_outputs``: a NaN checkpoint's answers fail
    loudly (500) instead of serving garbage; off, they pass through."""
    p, shapes = synthetic(**DIMS)
    eng = ServingEngine(p, workers=1, max_batch=2, max_delay_ms=1.0,
                        deadline_ms=60000.0)
    srv = serve(eng)
    try:
        eng.swap_weights(_ckpt(tmp_path, "ck_nan", seed=7, poison_nan=True))
        body = {"inputs": {"x": _probe().tolist()}}
        code, doc, _ = _post_json(srv.url + "/predict", body)
        assert code == 200 and np.isnan(np.asarray(doc["outputs"][0],
                                                   "float32")).all()
        tpt.set_flags({"FLAGS_serving_check_outputs": True})
        with pytest.raises(urllib.error.HTTPError) as e:
            _post_json(srv.url + "/predict", body)
        assert e.value.code == 500
        assert "non-finite" in json.loads(e.value.read())["detail"]
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# router canary: NaN burn -> auto-revert; clean soak -> promote
# ---------------------------------------------------------------------------

def _canary_fleet(tmp_path, n=3):
    """n in-process replicas starting bit-identical: a common baseline
    checkpoint swapped onto every engine."""
    base = _ckpt(tmp_path, "ck_base", seed=5)
    engines, servers = [], []
    for _ in range(n):
        p, _ = synthetic(**DIMS)
        eng = ServingEngine(p, workers=1, max_batch=4, max_delay_ms=1.0,
                            deadline_ms=60000.0)
        eng.swap_weights(base)
        engines.append(eng)
        servers.append(serve(eng, port=0))
    return engines, servers


def _pump_until(router, server, deadline_s, stop):
    """Drive traffic through the router and its judge until ``stop()``
    (poll_once() runs the canary evaluation inline)."""
    x = _probe().tolist()
    t_end = time.monotonic() + deadline_s
    while time.monotonic() < t_end:
        for _ in range(6):
            try:
                _post_json(server.url + "/predict", {"inputs": {"x": x}},
                           timeout=10.0)
            except urllib.error.HTTPError:
                pass  # canary-side failures are the evidence
        router.poll_once()
        st = router.canary_status()
        if stop(st):
            return st
        time.sleep(0.05)
    return router.canary_status()


def _settled(s):
    return not s["active"] and (s["last"] or {}).get("state") in (
        "reverted", "promoted")


def test_canary_revert_and_promote(tmp_path):
    tpt.set_flags({"FLAGS_serving_check_outputs": True})
    engines, servers = _canary_fleet(tmp_path, 3)
    router = Router([s.url for s in servers], autostart=False,
                    poll_interval_ms=100.0, stale_ms=5000.0)
    front = RouterServer(router).start()
    try:
        router.poll_once()
        assert router.healthz()[1]["routable"] == 3

        ck_bad = _ckpt(tmp_path, "ck_bad", seed=7, poison_nan=True)
        started = router.canary(ck_bad, fraction=0.3, soak_s=30.0)
        assert started["state"] == "soaking"
        assert len(started["urls"]) == 1
        st = _pump_until(router, front, 60.0, _settled)
        assert st["last"]["state"] == "reverted", st["last"]
        assert st["last"]["reason"].startswith("burn:")
        assert st["counters"]["canary_reverts"] == 1
        x = _probe()
        base = np.asarray(engines[-1].submit({"x": x}).result(30.0)[0])
        for eng in engines:
            assert np.array_equal(
                np.asarray(eng.submit({"x": x}).result(30.0)[0]), base)

        ck_good = _ckpt(tmp_path, "ck_good", seed=2)
        router.canary(ck_good, fraction=0.3, soak_s=1.5)
        st = _pump_until(router, front, 60.0, _settled)
        assert st["last"]["state"] == "promoted", st["last"]
        assert st["counters"]["canary_promotions"] == 1
        assert st["counters"]["canary_reverts"] == 1
        want = _fresh_answer(ck_good, x)
        for eng in engines:
            got = np.asarray(eng.submit({"x": x}).result(30.0)[0])
            assert np.array_equal(got, want)
            assert eng.weights_version >= 2
    finally:
        front.close()
        router.close()
        for s in servers:
            s.close()


def test_canary_fleet_level_atomicity(tmp_path):
    """A refused canary swap (structural drift) leaves ZERO replicas on
    the new version; a fleet that cannot split refuses outright."""
    engines, servers = _canary_fleet(tmp_path, 2)
    router = Router([s.url for s in servers], autostart=False)
    try:
        router.poll_once()
        bad = _ckpt(tmp_path, "ck_wide", seed=3, hidden=32)
        with pytest.raises(RuntimeError, match="refused"):
            router.canary(bad, fraction=0.5, soak_s=5.0)
        assert not router.canary_status()["active"]
        for eng in engines:
            assert eng.weights_version == 2  # baseline swap only
        solo = Router([servers[0].url], autostart=False)
        try:
            solo.poll_once()
            with pytest.raises(RuntimeError, match="split"):
                solo.canary(bad, fraction=0.5, soak_s=5.0)
        finally:
            solo.close()
    finally:
        router.close()
        for s in servers:
            s.close()


# ---------------------------------------------------------------------------
# live fleet: hot swap, then a SIGKILLed replica comes back attributed
# ---------------------------------------------------------------------------

TINY_DIMS = dict(feat=4, hidden=8, depth=1, classes=2)


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    sup = FleetSupervisor(replicas=2, replica_argv=TINY_ARGV,
                          max_restarts=3, backoff_ms=100.0,
                          workdir=str(tmp_path_factory.mktemp("fleet")))
    try:
        sup.wait_ready(timeout_s=240)
        yield sup
    finally:
        sup.close()


def test_fleet_hot_swap_converges(fleet, tmp_path):
    ck = str(tmp_path / "ck_v2")
    build_synthetic_checkpoint(ck, seed=9, device="cpu", **TINY_DIMS)
    rep = fleet.hot_swap(ck)
    assert rep["converged"], rep
    assert [r["weights_version"] for r in rep["replicas"]] == [2, 2]
    assert all(r["swap_status"] == 200 and not r.get("fallback")
               for r in rep["replicas"])
    x = np.linspace(-1.0, 1.0, 4, dtype="float32").reshape(1, 4)
    want = _fresh_answer(ck, x, TINY_DIMS)
    for url in fleet.endpoints():
        code, doc, hdr = _post_json(url + "/predict",
                                    {"inputs": {"x": x.tolist()}})
        assert code == 200 and hdr[VERSION_HEADER] == "2"
        got = np.asarray(doc["outputs"][0], "float32")
        assert np.array_equal(got, want)
    # a structurally different checkpoint is refused (409), the
    # replica keeps serving version 2
    wide = str(tmp_path / "ck_wide")
    build_synthetic_checkpoint(wide, seed=9, device="cpu",
                               **dict(TINY_DIMS, hidden=16))
    code, doc, _ = _post_json_err(fleet.endpoints()[0] + "/swap",
                                  {"dir": wide})
    assert code == 409 and doc["error"] == "swap_mismatch"


def test_swap_timeout_grows_with_the_checkpoint(tmp_path):
    """One ``POST /swap`` is bounded by 35 s plus 4 s a GiB of the
    checkpoint the replica reads inside it: a missing or tiny file gets
    the reference's 35 s, Llama-2-7B's 25.10 GiB gets 135.4 s."""
    from paddle_tpu_torch.serving.fleet import swap_timeout_s

    assert swap_timeout_s(str(tmp_path / "none")) == 35.0
    small = tmp_path / "small"
    build_synthetic_checkpoint(str(small), seed=1, device="cpu",
                               **TINY_DIMS)
    assert 35.0 < swap_timeout_s(str(small)) < 35.01
    big = tmp_path / "big"
    big.mkdir()
    with open(big / "__params__", "wb") as f:
        f.truncate(int(25.10 * 2 ** 30))  # sparse: no disk is written
    assert swap_timeout_s(str(big)) == pytest.approx(135.4)


def _post_json_err(url, doc):
    try:
        return _post_json(url, doc)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def test_fleet_books_sigkill_death_with_postmortems(fleet):
    rep = fleet._replicas[0]
    old_pid = rep.proc.pid
    kill(old_pid)
    deadline = time.monotonic() + 60.0
    while time.monotonic() < deadline:
        death = rep.last_death
        if death is not None and death["pid"] == old_pid:
            break
        time.sleep(0.2)
    else:
        raise AssertionError("supervisor never booked the death")
    assert death["attribution"] == "signal:SIGKILL"
    assert death["signal"] == "SIGKILL"
    assert death["rc"] == -signal.SIGKILL
    # the seeded rolling dump means even an instant SIGKILL leaves one
    assert death["postmortems"]
    assert all(os.path.isfile(p) for p in death["postmortems"])
    st = fleet.statusz()["replicas"][0]
    assert st["last_death"]["attribution"] == "signal:SIGKILL"
    assert st["postmortems_collected"] >= 1
    assert st["unexplained_deaths"] == 0
    fz = fleet.forensics()
    assert fz["unexplained_deaths"] == 0
    assert fz["postmortems_collected"] >= 1
    assert any(d["replica"] == 0 and d["attribution"] == "signal:SIGKILL"
               for d in fz["deaths"])
    wait_respawned(rep, old_pid)
    fleet.wait_ready(timeout_s=240)


# ---------------------------------------------------------------------------
# /debugz: replica bundle, federated router bundle, supervision on /fleetz
# ---------------------------------------------------------------------------

@pytest.fixture()
def mini_server():
    pred, shapes = synthetic(**TINY_DIMS)
    eng = ServingEngine(pred, workers=1, max_batch=2, max_delay_ms=1.0,
                        deadline_ms=60000.0)
    eng.warmup(shapes)
    srv = ServingServer(eng).start()
    yield eng, srv
    srv.close()


def test_replica_debugz_bundle(mini_server, tmp_path):
    eng, srv = mini_server
    tpt.set_flags({"FLAGS_metrics_dir": str(tmp_path)})
    assert post(srv.url)[0] == 200
    doc = get_json(srv.url + "/debugz")
    assert doc["bundle"] == "paddle_tpu.debugz.v1"
    assert doc["statusz"]["pid"] == os.getpid()
    assert "engine" in doc["statusz"]
    assert doc["tracez"] is not None and doc["metrics"] is not None
    bb = doc["blackbox"]
    assert bb["enabled"] is True and bb["live_requests"] == []
    doc2 = get_json(srv.url + "/debugz?dump=1")
    assert doc2["dump_path"] and os.path.isfile(doc2["dump_path"])
    with open(doc2["dump_path"]) as f:
        assert json.load(f)["reason"] == "requested"


def test_replica_debugz_degrades_when_disabled(mini_server):
    _eng, srv = mini_server
    tpt.set_flags({"FLAGS_blackbox": False})
    doc = get_json(srv.url + "/debugz")
    assert doc["blackbox"] == {"enabled": False}
    assert doc["statusz"]


def test_router_debugz_federates(mini_server):
    _eng, srv = mini_server
    router = Router([srv.url], poll_interval_ms=200.0, autostart=False)
    rserver = RouterServer(router).start()
    try:
        router.poll_once()
        doc = get_json(rserver.url + "/debugz")
        assert doc["tier"] == "router"
        assert doc["bundle"] == "paddle_tpu.debugz.v1"
        assert "fleetz" in doc and "statusz" in doc
        sub = doc["replicas"][srv.url]
        assert sub["bundle"] == "paddle_tpu.debugz.v1"
        assert "statusz" in sub and "blackbox" in sub
    finally:
        rserver.close()
        router.close()


def test_router_debugz_degrades_on_dead_replica(mini_server):
    _eng, srv = mini_server
    dead = "http://127.0.0.1:1"  # nothing listens on port 1
    router = Router([srv.url, dead], poll_interval_ms=200.0,
                    autostart=False)
    try:
        doc = router.debugz(timeout=2.0)
        assert "error" in doc["replicas"][dead]
        assert doc["replicas"][srv.url]["bundle"] == "paddle_tpu.debugz.v1"
    finally:
        router.close()


def test_attach_router_surfaces_supervision_on_fleetz(mini_server):
    _eng, srv = mini_server

    class _StubSup:  # forensics-only stand-in, no subprocesses
        def forensics(self):
            return {"deaths": [], "postmortems_collected": 2,
                    "unexplained_deaths": 0}

    sup = _StubSup()
    router = Router([srv.url], poll_interval_ms=200.0, autostart=False)
    try:
        assert router.supervisor is None
        FleetSupervisor.attach_router(sup, router)
        assert router.supervisor is sup
        router.poll_once()
        fz = router.fleetz()
        assert fz["supervision"]["postmortems_collected"] == 2
        assert fz["supervision"]["unexplained_deaths"] == 0
    finally:
        router.close()


def test_death_attribution_and_signal_names():
    assert blackbox.signal_name(-signal.SIGKILL) == "SIGKILL"
    assert blackbox.signal_name(0) is None
    assert blackbox.attribute_death(0, []) == "clean_exit"
    assert blackbox.attribute_death(-signal.SIGKILL, []) == "signal:SIGKILL"
    assert blackbox.attribute_death(1, []) == "unexplained"


# ---------------------------------------------------------------------------
# promtext: the shared parser
# ---------------------------------------------------------------------------

def test_promtext_parses_live_exposition():
    telemetry.gauge_set("obs_parse_gauge", 3.5)
    telemetry.histogram_observe("obs_parse_ms", 12.0)
    text = telemetry.prometheus_text()
    assert promtext.validate_lines(text) == []
    fams = promtext.parse_exposition(text, strict=True)
    g = fams["paddle_tpu_obs_parse_gauge"]
    assert g.type == "gauge" and g.value() == 3.5
    h = fams["paddle_tpu_obs_parse_ms"]
    assert h.type == "histogram"
    assert h.histogram_count() >= 1.0
    buckets = h.histogram_buckets()
    assert buckets[-1][0] == float("inf")
    assert promtext.parse_labels('{a="x",le="+Inf"}') == \
        {"a": "x", "le": "+Inf"}
    assert promtext.parse_labels('{p="C:\\\\net"}') == {"p": "C:\\net"}
    assert promtext.parse_labels('{p="a\\nb\\"c"}') == {"p": 'a\nb"c'}
    with pytest.raises(ValueError):
        promtext.parse_exposition("no_type_sample 1\n", strict=True)
    doc = ("# HELP fleet_x d\n# TYPE fleet_x counter\n"
           'fleet_x{replica="a:1"} 5\nfleet_x{replica="b:2"} 7\n'
           "fleet_x 12\n")
    assert promtext.parse_exposition(doc, strict=True)["fleet_x"] \
        .value() == 12.0
    doc2 = ("# HELP fleet_y d\n# TYPE fleet_y counter\n"
            'fleet_y{replica="a:1"} 5\n')
    assert promtext.parse_exposition(doc2)["fleet_y"].value() is None


def test_promtext_merged_histogram_percentile():
    merged = [(10.0, 40.0), (100.0, 80.0), (float("inf"), 80.0)]
    assert promtext.merged_histogram_percentile(merged, 50) == \
        pytest.approx(10.0)
    p99 = promtext.merged_histogram_percentile(merged, 99)
    assert 10.0 < p99 <= 100.0
    merged = [(10.0, 1.0), (float("inf"), 100.0)]
    assert promtext.merged_histogram_percentile(merged, 99) == 10.0
    assert promtext.merged_histogram_percentile([], 99) is None
    assert promtext.merged_histogram_percentile(
        [(10.0, 0.0), (float("inf"), 0.0)], 99) is None


def test_promtext_is_the_reference_parser_line_for_line():
    """The port's copy differs from ``paddle_tpu/promtext.py`` only in
    its module docstring and the package its comments name."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def body(path):
        with open(os.path.join(repo, path)) as f:
            src = f.read()
        return src[src.index('"""', 3) + 3:]

    assert body("paddle_tpu_torch/promtext.py").replace(
        "paddle_tpu_torch.", "paddle_tpu.") == body("paddle_tpu/promtext.py")


# ---------------------------------------------------------------------------
# router federation over two in-process replicas
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_replica_fleet():
    pred, shapes = synthetic(**TINY_DIMS)
    servers = []
    for _ in range(2):
        eng = ServingEngine(pred.clone(), workers=1)
        eng.warmup(shapes)
        servers.append(ServingServer(eng).start())
    router = Router([s.url for s in servers], poll_interval_ms=200.0,
                    autostart=False, slo_fast_s=2.0, slo_slow_s=6.0)
    rserver = RouterServer(router).start()
    router.poll_once()
    yield router, rserver, servers
    rserver.close()
    router.close()
    for s in servers:
        s.close()


def _post_predict(url, n=6, headers=None):
    body = json.dumps({"inputs": {"x": np.random.RandomState(0)
                                  .rand(1, 4).tolist()}}).encode()
    for i in range(n):
        h = {"Content-Type": "application/json"}
        if headers:
            h.update(headers(i))
        req = urllib.request.Request(url + "/predict", data=body,
                                     headers=h)
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.status == 200


def test_federation_two_replicas_aggregate_equals_sum(two_replica_fleet):
    router, rserver, _servers = two_replica_fleet
    _post_predict(rserver.url)
    router.poll_once()
    _post_predict(rserver.url)
    time.sleep(0.25)
    router.poll_once()
    fz = get_json(rserver.url + "/fleetz?window_s=30")
    assert fz["window_s"] == 30.0
    rids = sorted(fz["replicas"])
    assert len(rids) == 2
    for rid in rids:
        assert fz["replicas"][rid]["up"] is True
        assert fz["replicas"][rid]["scrape_age_ms"] is not None
    agg = fz["aggregate"]["counters"]["serving_http_requests"]
    per = [fz["replicas"][rid]["counters"]["serving_http_requests"]
           for rid in rids]
    assert agg["total"] == sum(per)
    assert agg["replicas"] == 2
    assert agg["rate_per_s"] is not None and agg["rate_per_s"] > 0
    assert any(v["replicas"] == 2 and v["max"] is not None
               for v in fz["aggregate"]["gauges"].values())
    req_ms = fz["aggregate"]["histograms"].get("serving_request_ms")
    assert req_ms and req_ms["count"] > 0 and req_ms["p99"] is not None
    assert {a["name"] for a in fz["slo"]["alerts"]} == {
        "availability", "replica_availability", "p99"}
    assert all(a["state"] == "ok" for a in fz["slo"]["alerts"])
    assert fz["autoscale"]["wanted_replicas"] is not None
    assert fz["tsdb"]["series"] > 0
    assert fz["router"]["request_ms"]["p99"] is not None


def test_federation_labels_on_router_metrics(two_replica_fleet):
    router, rserver, _servers = two_replica_fleet
    _post_predict(rserver.url, n=2)
    router.poll_once()
    with urllib.request.urlopen(rserver.url + "/metrics", timeout=30) as r:
        text = r.read().decode()
    assert promtext.validate_lines(text) == []
    fams = promtext.parse_exposition(text, strict=True)
    fleet = fams["paddle_tpu_fleet_serving_http_requests"]
    assert fleet.type == "counter"
    labeled = [s for s in fleet.samples if "replica" in s.labels]
    bare = [s for s in fleet.samples if not s.labels]
    assert len(labeled) == 2 and len(bare) == 1
    assert bare[0].value == sum(s.value for s in labeled)
    assert {s.labels["replica"] for s in labeled} == \
        {r_.rid for r_ in router._all()}


def test_fleetz_statusz_and_healthz_carry_alerts(two_replica_fleet):
    router, rserver, _servers = two_replica_fleet
    router.poll_once()
    assert get_json(rserver.url + "/statusz")["fleet"]["slo"]["alerts"]
    assert get_json(rserver.url + "/healthz")["alerts_firing"] == []
    router2 = Router([], federate=False, autostart=False)
    try:
        fz = router2.fleetz()
        assert fz["federate"] is False and fz["aggregate"] is None
    finally:
        router2.close()


@pytest.mark.parametrize("bad", ["0", "-5", "abc", "nan", "inf", "-inf"])
def test_fleetz_window_s_rejects_nonpositive_and_nonnumeric(
        two_replica_fleet, bad):
    _router, rserver, _servers = two_replica_fleet
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(rserver.url + f"/fleetz?window_s={bad}",
                               timeout=30)
    assert ei.value.code == 400, bad
    assert get_json(rserver.url + "/fleetz?window_s=")["window_s"] == 60.0
    assert get_json(rserver.url + "/fleetz?window_s=12.5")["window_s"] \
        == 12.5


def test_usage_federation_multi_tenant_conservation(two_replica_fleet):
    router, rserver, servers = two_replica_fleet
    tenants = ("tenant-red", "tenant-blue")
    _post_predict(rserver.url, n=8,
                  headers=lambda i: {"X-PaddleTPU-Tenant": tenants[i % 2]})
    router.poll_once()
    time.sleep(0.25)
    router.poll_once()
    for s in servers:
        uz = get_json(s.url + "/usagez")
        assert uz["enabled"] is True
        for field, c in uz["conservation"].items():
            assert c["delta"] == 0, (s.url, field, c)
        for t in tenants:
            assert uz["tenants"][t]["vector"]["requests"] > 0
            assert uz["tenants"][t]["request_ms"]["p99"] is not None
        assert uz["sketch"]["within_bound"] is True
    with urllib.request.urlopen(servers[0].url + "/metrics",
                                timeout=30) as r:
        text = r.read().decode()
    assert promtext.validate_lines(text) == []
    fam = promtext.parse_exposition(text, strict=True)[
        "paddle_tpu_serving_tenant_requests"]
    labeled = [s for s in fam.samples if "tenant" in s.labels]
    bare = [s for s in fam.samples if not s.labels]
    assert len(bare) == 1 and labeled
    assert bare[0].value == sum(s.value for s in labeled)
    assert set(tenants) <= {s.labels["tenant"] for s in labeled}
    fz = get_json(rserver.url + "/fleetz?window_s=60")
    ften = fz["aggregate"]["tenants"]
    for t in tenants:
        assert ften["requests"][t]["total"] > 0
        assert ften["requests"][t]["replicas"] == 2
        assert ften["requests"][t]["delta"] is not None
    fam_total = fz["aggregate"]["counters"]["serving_tenant_requests"][
        "total"]
    assert sum(v["total"] for v in ften["requests"].values()) == fam_total
    for t in tenants:
        assert router._db.last(f"fleet_tenant_requests{{{t}}}") is not None
    for rep_ in router._all():
        for t in tenants:
            assert router._db.points(
                f"serving_tenant_requests{{{t}}}[{rep_.rid}]"), (rep_.rid, t)
    _post_predict(rserver.url, n=1,
                  headers=lambda i: {"X-PaddleTPU-Tenant": "bad tenant!!"})
    uz = get_json(servers[0].url + "/usagez")
    assert "bad tenant!!" not in uz["tenants"]
    assert usage.default_tenant() in uz["tenants"]


def test_router_burn_alert_fires_on_dead_fleet_and_clears():
    """Failed health polls against an unbound port burn
    replica_availability until the alert fires; clean poll counters
    age the fast window out and it clears."""
    router = Router(["http://127.0.0.1:9"], poll_interval_ms=50.0,
                    autostart=False, slo_fast_s=0.4, slo_slow_s=1.0,
                    slo_burn_threshold=2.0)
    try:
        deadline = time.monotonic() + 10.0
        fired = False
        while time.monotonic() < deadline:
            router.poll_once()
            if router.burn_monitor.firing():
                fired = True
                break
            time.sleep(0.05)
        assert fired, "replica_availability alert never fired"
        assert "replica_availability" in router.burn_monitor.firing()
        db = router._db
        t = time.monotonic()
        with router._lock:
            n = dict(router._n)
        for i in range(1, 30):
            db.record("router_polls_total", n["health_polls"] + 10 * i,
                      ts=t + i * 0.1)
            db.record("router_poll_failures_total",
                      n["health_poll_failures"], ts=t + i * 0.1)
        st = router.burn_monitor.evaluate(now=t + 3.0)
        by_name = {a["name"]: a for a in st["alerts"]}
        assert by_name["replica_availability"]["state"] == "ok"
    finally:
        router.close()


# ---------------------------------------------------------------------------
# the SLO both packages hold p99 to
# ---------------------------------------------------------------------------

def _latency_threshold(monitor, name="p99"):
    return {s.name: s for s in monitor.specs}[name].threshold_ms


@pytest.mark.parametrize("router_slo, slo, want", [
    (250.0, 0.0, 250.0), (400.0, 0.0, 400.0), (400.0, 120.0, 120.0)])
def test_slo_p99_inherits_the_router_flag_in_both_packages(
        router_slo, slo, want):
    """``FLAGS_slo_p99_ms`` = 0 inherits ``FLAGS_router_slo_p99_ms``: the
    port's ``usage.slo_p99_ms()``, both packages' router burn monitors
    and their usage ledgers' per-tenant monitors hold p99 to the same
    threshold (exact)."""
    import paddle_tpu as pt
    from paddle_tpu.serving import usage as jax_usage
    from paddle_tpu.serving.router import Router as JaxRouter

    flags = {"FLAGS_router_slo_p99_ms": router_slo, "FLAGS_slo_p99_ms": slo}
    old = pt.get_flags(list(flags))
    tpt.set_flags(flags)
    pt.set_flags(flags)
    ours, ref = Router([], autostart=False), JaxRouter([], autostart=False)
    try:
        assert usage.slo_p99_ms() == want
        assert _latency_threshold(ours.burn_monitor) == want
        assert _latency_threshold(ref.burn_monitor) == want
        for mod in (usage, jax_usage):
            ledger = mod.UsageLedger()
            ledger._ensure_slo_spec("t1")
            assert _latency_threshold(ledger._slo_monitor,
                                      "tenant_p99:t1") == want
    finally:
        ours.close()
        ref.close()
        pt.set_flags(old)


# ---------------------------------------------------------------------------
# the lock-order sanitizer
# ---------------------------------------------------------------------------

def test_concurrent_submitters_under_the_lock_order_sanitizer():
    """The serving leg: the engine's locks are built under locksan, 32
    concurrent submits run order-checked, every answer equals the same
    rows run together (tolerance 0), and no inversion is recorded."""
    p, _ = synthetic(**DIMS)
    xs = np.random.RandomState(0).randn(32, DIMS["feat"]).astype("float32")
    was_enabled = locksan.enabled()
    before = locksan.violations()
    if not was_enabled:
        locksan.clear_violations()
        locksan.enable(raise_on_violation=False)
    try:
        with ServingEngine(p, workers=2, max_batch=8, max_delay_ms=5.0,
                           deadline_ms=60000) as eng:
            futs = [eng.submit({"x": xs[i:i + 1]}) for i in range(32)]
            ref = p.run({"x": xs})[0]
            for i, f in enumerate(futs):
                assert np.array_equal(f.result(60)[0], ref[i:i + 1])
            stats = eng.stats()
            assert stats["counters"]["batches"] < \
                stats["counters"]["requests"] == 32
    finally:
        if not was_enabled:
            locksan.disable()
    assert locksan.violations() == ([] if not was_enabled else before)


def _run_threads(*fns):
    for fn in fns:
        th = threading.Thread(target=fn)
        th.start()
        th.join(10)


def test_locksan_detects_ab_ba_inversion():
    locksan.clear_violations()
    locksan.enable(raise_on_violation=True)
    try:
        A = threading.Lock()
        B = threading.Lock()
        boom = []

        def t_forward():
            with A:
                with B:
                    pass

        def t_backward():
            try:
                with B:
                    with A:       # closes the cycle
                        pass
            except locksan.LockOrderError as e:
                boom.append(str(e))

        _run_threads(t_forward, t_backward)
        assert len(boom) == 1 and "inversion" in boom[0]
        assert len(locksan.violations()) == 1
        # the failed acquire gave the real lock back: A is free
        assert A.acquire(timeout=1)
        A.release()
    finally:
        locksan.disable()
        locksan.clear_violations()


def test_locksan_record_mode_reports_each_inversion_once():
    """Record mode (FLAGS_debug_lock_order's): an inversion hit N times
    yields ONE violation."""
    locksan.clear_violations()
    locksan.enable(raise_on_violation=False)
    try:
        A = threading.Lock()
        B = threading.Lock()

        def forward():
            with A:
                with B:
                    pass

        def backward():
            with B:
                with A:
                    pass

        _run_threads(forward, backward, backward, backward)
        assert len(locksan.violations()) == 1, locksan.violations()
    finally:
        locksan.disable()
        locksan.clear_violations()


def test_locksan_cross_thread_lock_handoff_is_legal():
    locksan.clear_violations()
    locksan.enable(raise_on_violation=True)
    try:
        token = threading.Lock()
        A = threading.Lock()
        token.acquire()          # main thread holds the token
        _run_threads(token.release)  # handoff release
        with A:
            pass
        assert locksan.violations() == [], locksan.violations()
    finally:
        locksan.disable()
        locksan.clear_violations()


def test_locksan_clean_patterns_record_nothing():
    locksan.clear_violations()
    locksan.enable(raise_on_violation=True)
    try:
        A = threading.Lock()
        R = threading.RLock()
        cv = threading.Condition()
        with A:
            with R:
                with R:           # reentrant: legal
                    pass
        done = []

        def waiter():
            with cv:
                while not done:
                    cv.wait(1.0)

        th = threading.Thread(target=waiter)
        th.start()
        with cv:
            done.append(1)
            cv.notify_all()
        th.join(10)
        assert locksan.violations() == []
    finally:
        locksan.disable()
        locksan.clear_violations()


def test_locksan_installs_from_the_flag():
    """``FLAGS_debug_lock_order`` off: importing the port patches
    nothing; on, ``install_from_flag`` enables record mode."""
    assert not locksan.enabled()
    assert threading.Lock is locksan._REAL_LOCK
    tpt.set_flags({"FLAGS_debug_lock_order": True})
    try:
        locksan.install_from_flag()
        assert locksan.enabled() and threading.Lock is not \
            locksan._REAL_LOCK
    finally:
        locksan.disable()
        tpt.set_flags({"FLAGS_debug_lock_order": False})
    assert threading.Lock is locksan._REAL_LOCK


# ---------------------------------------------------------------------------
# a respawn whose pinned port an outgoing connection holds
# ---------------------------------------------------------------------------

def _holding(port, peer):
    """A client socket bound to `port` and connected to `peer`, as an
    outgoing connection that drew `port` from the ephemeral range holds
    it (no SO_REUSEADDR: a listener cannot bind beside it).  The bind
    itself sets SO_REUSEADDR for a moment to pass the dead listener's
    TIME_WAIT connections."""
    deadline = time.monotonic() + 30.0
    while True:
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            sock.bind(("127.0.0.1", port))
            break
        except OSError:
            sock.close()
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)  # the killed listener not reaped yet
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 0)
    sock.connect(peer)
    return sock


def test_respawn_whose_pinned_port_is_taken_names_the_bind_error(tmp_path):
    """The first life's port lies outside ``ip_local_port_range``, where
    no outgoing connection draws its source port.  SIGKILL the replica
    and hold its pinned port with a connected client socket: each respawn
    then cannot bind, logs ``BIND_ERROR`` with the errno and the port and
    exits 1, and the supervisor's death record names that error; once the
    socket closes (abortively: no TIME_WAIT of its own) the next respawn
    serves on the same URL."""
    lo, hi = ephemeral_range()
    peer = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    peer.bind(("127.0.0.1", 0))
    peer.listen(4)
    hold = None
    sup = FleetSupervisor(replicas=1, replica_argv=TINY_ARGV,
                          workdir=str(tmp_path / "fleet"), max_restarts=20,
                          backoff_ms=100.0, liveness_timeout_ms=0)
    try:
        url = sup.wait_ready(240)[0]
        rep = sup._replicas[0]
        port = rep.port
        assert url.endswith(f":{port}")
        assert not lo <= port <= hi, (port, lo, hi)
        old_pid = rep.proc.pid
        kill(old_pid)
        hold = _holding(port, peer.getsockname())
        deadline = time.monotonic() + 120.0
        while True:
            death = rep.last_death
            if death is not None and death["pid"] != old_pid:
                break
            assert time.monotonic() < deadline, "no respawn died"
            time.sleep(0.1)
        assert death["rc"] == 1
        assert death["bind_error"] == {"port": port,
                                       "errno": errno.EADDRINUSE,
                                       "name": "EADDRINUSE"}
        with open(rep.log_path, encoding="utf-8") as f:
            assert (f"{BIND_ERROR}: pid {death['pid']} port {port} errno "
                    f"{errno.EADDRINUSE} (EADDRINUSE)") in f.read()
        assert sup.statusz()["replicas"][0]["last_death"]["bind_error"] == \
            death["bind_error"]
        # the port free again: a later respawn binds it and serves
        hold.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                        struct.pack("ii", 1, 0))
        hold.close()
        hold = None
        deadline = time.monotonic() + 240.0
        while True:
            try:
                health = get_json(url + "/healthz")
                if health.get("ready"):
                    break
            except OSError:
                pass
            assert time.monotonic() < deadline, "never served again"
            time.sleep(0.2)
        assert rep.port == port and rep.proc.poll() is None
        status, body, _ = post(url)
        assert status == 200 and body["outputs"]
    finally:
        if hold is not None:
            hold.close()
        peer.close()
        sup.close()
