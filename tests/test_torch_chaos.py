"""The port's chaos harness (``paddle_tpu_torch/tools/chaos.py``) on the
CPU: ``classify``, ``_epoch_total`` and the traffic bodies at tolerance 0
against the reference tool (``tools/chaos.py``, loaded by path); the
scenarios the port leaves for later; and the twin of
``tests/test_fault_containment.py:650``, the chaos smoke — ``baseline``,
``crash``, ``hang``, ``slow``, ``poison`` and ``poison_paged`` against a
fleet of 3 port replicas (``--device cpu``) under the same contract."""
import importlib.util
import os

import numpy as np
import pytest

import paddle_tpu_torch as tpt
from paddle_tpu_torch import fault
from paddle_tpu_torch.tools import chaos

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_torch_chaos_tests",
        os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _load_tool("chaos")


@pytest.fixture(autouse=True)
def _reset():
    fault.reset()
    yield
    fault.reset()
    tpt.set_flags({"FLAGS_fault_inject": "", "FLAGS_telemetry": True,
                   "FLAGS_serving_poison_value": ""})


def _records(seed, n=300):
    """Synthetic request records: every outcome, poisoned or not, inside
    and outside the windows, on both sides of the window edges."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        t0 = float(rng.rand() * 20.0)
        t1 = t0 + float(rng.rand() * 2.0)
        out.append({"t0": t0, "t1": t1,
                    "outcome": ("ok", "ok", "ok", "shed",
                                "failed")[rng.randint(5)],
                    "status": None, "poison": bool(rng.rand() < 0.1),
                    "tenant": None, "ms": (t1 - t0) * 1e3})
    return out


@pytest.mark.parametrize("seed,windows", [
    (0, []), (1, [(5.0, 7.5)]), (2, [(2.0, 3.0), (11.0, 14.0)]),
    (3, [(0.0, 25.0)])])
def test_classify_matches_the_reference(seed, windows):
    records = _records(seed)
    assert chaos.classify(records, windows) == \
        ref.classify(records, windows)


def test_classify_edges_as_the_contract_reads_them():
    recs = [
        {"t0": 0.0, "t1": 1.0, "outcome": "failed", "poison": False,
         "ms": 1.0},                        # before the window: collateral
        {"t0": 1.5, "t1": 2.0, "outcome": "failed", "poison": False,
         "ms": 1.0},                        # ends at its start: injected
        {"t0": 3.0, "t1": 4.0, "outcome": "ok", "poison": True,
         "ms": 1.0},                        # a poisoned 200: a leak
        {"t0": 3.0, "t1": 4.0, "outcome": "failed", "poison": True,
         "ms": 1.0},                        # poisoned failure: injected
        {"t0": 5.0, "t1": 6.0, "outcome": "shed", "poison": False,
         "ms": 1.0}]
    for mod in (chaos, ref):
        n = mod.classify(recs, [(2.0, 2.5)])
        assert (n["collateral_failures"], n["injected_failures"],
                n["poison_leaks"], n["shed"], n["poisoned"]) == \
            (1, 2, 1, 1, 2)
        assert n["availability_pct"] == round(100.0 * (1 - 2 / 3), 3)
    assert chaos.classify([], []) == ref.classify([], [])


@pytest.mark.parametrize("points,bounds", [
    ([(1.0, 3.0), (2.0, 5.0), (3.0, 1.0), (4.0, 2.0)], [2.5]),
    ([(1.0, 3.0), (2.0, 5.0)], []),
    ([(1.0, 3.0), (2.0, 5.0), (3.0, 7.0)], [0.5, 2.0]),
    ([], [1.0])])
def test_epoch_total_matches_the_reference(points, bounds):
    assert chaos._epoch_total(points, bounds) == \
        ref._epoch_total(points, bounds)


def test_restart_bound_skips_a_scrape_that_left_before_the_kill():
    """The victim's all-tenant requests series: scrapes at 1 and 2 s of
    the old process (5, 9 requests), one sent before the kill at 2.5 s
    whose reply landed at 2.6 s (11: the old process's), then the
    respawned process (1, 3).  The epoch starts at 3.0, where the count
    fell, not at 2.6; a tenant the new process never served (its series
    ends at the stale 2.6 sample) is then counted once, as its total
    is, where the first-sample-after-the-kill boundary of the reference
    counted it twice.  Without a drop the first sample after the kill
    still bounds the epoch."""
    total = [(1.0, 5.0), (2.0, 9.0), (2.6, 11.0), (3.0, 1.0), (4.0, 3.0)]
    hog = [(1.0, 4.0), (2.0, 7.0), (2.6, 8.0)]
    rest = [(1.0, 1.0), (2.0, 2.0), (2.6, 3.0), (3.0, 1.0), (4.0, 3.0)]
    bound = chaos._restart_bound(total, 2.5)
    assert bound == [3.0]
    assert chaos._epoch_total(hog, bound) + chaos._epoch_total(
        rest, bound) == chaos._epoch_total(total, bound) == 14.0
    stale = [2.6]  # the reference's boundary: 15 + 5 against 12
    assert chaos._epoch_total(hog, stale) + chaos._epoch_total(
        rest, stale) - chaos._epoch_total(total, stale) == 8.0
    assert chaos._restart_bound([(1.0, 2.0), (3.0, 4.0)], 2.0) == [3.0]
    assert chaos._restart_bound([(1.0, 2.0)], 2.0) == []


def test_bodies_and_constants_match_the_reference():
    for seed in (0, 3, 7):
        assert chaos._bodies(8, seed=seed) == ref._bodies(8, seed=seed)
    assert chaos._bodies(4, n=1, seed=7)[0] == ref._bodies(4, n=1,
                                                           seed=7)[0]
    assert chaos._poison_body(8) == ref._poison_body(8)
    assert (chaos.POISON, chaos.POISON_TOKEN) == (ref.POISON,
                                                  ref.POISON_TOKEN)
    assert set(chaos.DEFAULT_SCENARIOS) == \
        set(ref.DEFAULT_SCENARIOS) - {"embedding_shard_crash"}
    model = chaos.synthetic_model(8, 32, 1, "cpu")
    assert model.bodies(0) == ref._bodies(8)
    assert model.poison == ref._poison_body(8)
    assert model.argv == ["--feat", "8", "--hidden", "32", "--depth", "1"]


def test_embedding_shard_crash_waits_for_the_embedding_tier():
    with pytest.raises(NotImplementedError, match="item 8"):
        chaos.run_chaos(scenarios=("baseline", "embedding_shard_crash"),
                        device="cpu")
    with pytest.raises(SystemExit):
        chaos.main(["--scenarios", "nonsense", "--device", "cpu"])


def test_run_chaos_runs_on_the_card_unless_given_the_cpu():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chaos.run_chaos(scenarios=("baseline",))


def test_chaos_harness_smoke_three_replica_fleet():
    """The reference's acceptance scenario against the port: crash +
    hang + slow + poison injected against a 3-replica fleet under
    open-loop load — zero collateral (non-injected) failures, zero
    poison leaks, availability >= 99%, and every recovery path actually
    fired."""
    report = chaos.run_chaos(replicas=3, qps=30.0, duration_s=2.5,
                             availability_pct=99.0,
                             liveness_timeout_ms=1200.0,
                             forward_timeout_ms=600.0,
                             scenarios=("baseline", "crash", "hang",
                                        "slow", "poison",
                                        "poison_paged"),
                             log=lambda *a: None, device="cpu")
    assert report["errors"] == {}, report["errors"]
    totals = report["totals"]
    assert totals["collateral_failures"] == 0, report
    assert totals["poison_leaks"] == 0, report
    assert report["availability_pct"] >= 99.0, report
    assert report["ok"] is True
    scen = report["scenarios"]
    assert set(scen) == {"baseline", "crash", "hang", "slow", "poison",
                         "poison_paged"}
    assert totals["alert_errors"] == 0
    assert scen["baseline"]["alerts"]["fired"] == []
    for fault_scen in ("crash", "hang"):
        al = scen[fault_scen]["alerts"]
        assert al["fired_in_window"], (fault_scen, al)
        assert al["cleared"] is True, (fault_scen, al)
    assert scen["crash"]["notes"]["postmortem"]["attribution"] == \
        "signal:SIGKILL"
    assert scen["hang"]["notes"]["hung_kills_after"] > \
        scen["hang"]["notes"]["hung_kills_before"]
    assert scen["poison"]["injected_failures"] >= 1
    assert scen["poison"]["collateral_failures"] == 0
    assert scen["poison_paged"]["injected_failures"] >= 1
    assert scen["poison_paged"]["collateral_failures"] == 0
    assert scen["poison_paged"]["poison_leaks"] == 0
    assert scen["poison_paged"]["notes"]["page_evictions"] == 0
    assert report["config"]["device"] == "cpu"


@pytest.mark.parametrize("name,steady,want", [
    ("baseline", 1.5, 1.5), ("slow", 1.5, 1.5), ("baseline", None, 4.0),
    ("slow", None, 4.0)])
def test_steady_scenarios_take_their_own_length(monkeypatch, name, steady,
                                                want):
    """run_chaos's steady_duration_s is the traffic length of the
    scenarios that kill no replica (STEADY_SCENARIOS); unset, they run
    duration_s as the others do."""
    seen = []

    def traffic(url, feat, qps, duration_s, **kw):
        seen.append(duration_s)
        return []

    class Monitor:
        fast_s = 0.1

        def firing(self):
            return []

    class Router:
        burn_monitor = Monitor()

    monkeypatch.setattr(chaos, "run_traffic", traffic)
    model = chaos.synthetic_model(8, 16, 1, "cpu")
    cfg = {"qps": 10.0, "duration_s": 4.0, "steady_duration_s": steady,
           "feat": 8, "model": model, "timeout_s": 1.0,
           "slow_delay_ms": 40, "slow_prob": 0.25}
    rep = chaos._scenario(name, None, Router(), "http://127.0.0.1:1", cfg)
    assert seen == [want]
    assert "error" not in rep, rep
    assert set(chaos.STEADY_SCENARIOS) == {"baseline", "slow", "poison"}


def test_poison_runs_on_a_fleet_of_its_own_model(monkeypatch):
    """With poison_model, run_chaos runs poison against a shared-fleet
    twin spawned for it (the same replicas and router, that model's
    argv: a longer batch window) and every other shared-fleet scenario
    against the shared fleet and its model; without it, poison runs on
    the shared fleet."""
    from paddle_tpu_torch import serving

    spawned, ran = [], []

    class Supervisor:
        def __init__(self, replicas, replica_argv, **kw):
            spawned.append((replicas, list(replica_argv)))

        def wait_ready(self, timeout_s):
            return ["http://127.0.0.1:1"]

        def close(self):
            pass

    class Server:
        url = "http://127.0.0.1:2"

        def close(self):
            pass

    class Router:
        def poll_once(self):
            pass

    def scenario(name, sup, router, url, cfg):
        ran.append((name, cfg["model"].argv[-1], len(spawned)))
        rep = chaos.classify([], [])
        rep.update(_records=[], notes={})
        return rep

    monkeypatch.setattr(serving, "FleetSupervisor", Supervisor)
    monkeypatch.setattr(chaos, "_shared_router",
                        lambda urls, cfg: (Router(), Server()))
    monkeypatch.setattr(chaos, "_scenario", scenario)
    shared = chaos.PredictModel(["--max-delay-ms", "10"], None, b"p")
    own = chaos.PredictModel(["--max-delay-ms", "110.193"], None, b"p")
    chaos.run_chaos(replicas=3, scenarios=("baseline", "poison", "slow"),
                    model=shared, poison_model=own, device="cpu",
                    log=lambda m: None)
    assert [r[:2] for r in ran] == [("baseline", "10"),
                                    ("poison", "110.193"), ("slow", "10")]
    assert [n for n, _ in spawned] == [3, 3]
    assert spawned[1][1] == chaos.shared_fleet_argv(own, "cpu")
    assert spawned[0][1] == chaos.shared_fleet_argv(shared, "cpu")
    spawned.clear()
    ran.clear()
    chaos.run_chaos(replicas=3, scenarios=("poison",), model=shared,
                    device="cpu", log=lambda m: None)
    assert ran == [("poison", "10", 1)] and len(spawned) == 1
