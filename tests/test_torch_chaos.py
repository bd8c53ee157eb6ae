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
