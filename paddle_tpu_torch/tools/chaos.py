#!/usr/bin/env python
"""Fleet chaos harness for the port: kill / hang / slow / poison
scenarios against a LIVE replica fleet under open-loop load, asserting
an availability budget.

The serving tier's answer to the training tier's fault-matrix tests:
every containment mechanism the stack claims — router connect-refused
retry, forward timeouts + timeout retry (hung replicas), health
ejection, supervisor crash respawn and the liveness SIGKILL, poison
request bisection, deadline shedding — is exercised against real
processes and real sockets, and the run FAILS unless:

* **zero collateral failures** — every failed request must be
  attributable to an injected fault (inside the fault window, or a
  deliberately poisoned request); a failure outside any window means
  containment leaked;
* **zero poison leaks** — a poisoned request that returned 200 means
  bisection served a row the model should have crashed on;
* **availability >= the budget** (default 99%) over all non-poisoned
  requests across every scenario, injected damage included;

* **the burn-rate alert contract holds** — the router's multi-window
  SLO burn-rate monitor (paddle_tpu_torch/tsdb.py, windows scaled to
  scenario time) must FIRE inside every crash/hang fault window (a
  dead or wedged replica burns replica-availability budget at 10-30x)
  and CLEAR after recovery, and a clean scenario — the leading
  ``baseline`` (no injection at all), ``slow``, ``poison`` — must
  raise ZERO alerts (the false-positive guard).  Both verdicts are
  scenario errors riding the same hard gate as collateral failures
  (``totals.alert_errors`` in the report).

Scenarios (one shared fleet; traffic is open-loop ``POST /predict``
through the router):

=============  ==========================================  =============
scenario       injection                                   recovery path
=============  ==========================================  =============
crash          SIGKILL one replica mid-traffic             connect-refused retry +
                                                           supervisor respawn
hang           SIGSTOP one replica (PID alive, sockets     forward-timeout retry +
               open)                                       health ejection +
                                                           liveness SIGKILL/respawn
slow           ``router_forward:delay:<ms>~<p>`` fault in  none needed: slow is
               the router process (random per-forward      not failure — zero
               delay)                                      failures allowed
poison         every Nth request carries the
               ``FLAGS_serving_poison_value`` sentinel     bisection: poisoned
                                                           request 500s, riders
                                                           answer bit-exact
poison_paged   every Nth *generation prompt* carries a     prefill-time poison
               poisoned token while sharing a cached       check fires BEFORE any
               prefix with clean prompts (in-process       shared page is mapped:
               paged GenerationEngine, prefix reuse on)    exactly the poisoned
                                                           request fails; the
                                                           shared pages are
                                                           neither evicted nor
                                                           corrupted — every
                                                           clean stream stays
                                                           bit-exact and later
                                                           borrowers still hit
                                                           the prefix index
spec_storm     poisoned prompts + a ``decode_step:fail``   speculation never
               fault detonated MID-VERIFY while            widens the blast
               concurrent slots speculate over a shared    radius: fault victims
               cached prefix (in-process paged             fail inside their own
               GenerationEngine, FLAGS_serving_speculate   window (injected),
               on)                                         surviving clean
                                                           streams stay
                                                           bit-exact vs the
                                                           speculation-on
                                                           reference, rollback
                                                           counters balance
                                                           (accepted <=
                                                           proposed, rollbacks
                                                           <= drafts), and the
                                                           page pool drains to
                                                           ZERO live pages
disagg_crash   role-split generation fleet (2 prefill +    router affinity
               2 decode) under MIXED long-prompt/short-    containment: requests
               chat /generate load; SIGKILL a prefill      on the dead replica
               replica mid-handoff, then a decode          fail inside the fault
               replica holding live adopted segments       window (affinity_lost
                                                           for the decode kill —
                                                           never silently
                                                           re-prefilled), the
                                                           survivors keep
                                                           serving (zero
                                                           collateral), the
                                                           supervisor respawns
                                                           both, burn-rate
                                                           alerts fire in-window
                                                           and clear, and after
                                                           the storm every
                                                           replica's page pool
                                                           drains to ZERO live
                                                           pages (no leak)
hot_swap       rolling ``hot_swap`` weight rollout under   quiesce-and-commit
               mixed /predict + /generate load, then a     swap discipline (zero
               second rollout with one replica SIGKILLed   non-shed failures
               MID-COMMIT (``weight_swap:delay`` fault     outside the kill
               widens the window)                          window), monotonic
                                                           per-replica
                                                           weights-version flip
                                                           (zero torn
                                                           responses), restart
                                                           fallback converges
                                                           the killed slot,
                                                           post-swap outputs
                                                           bit-exact vs a fresh
                                                           predictor
=============  ==========================================  =============

Usage::

    python -m paddle_tpu_torch.tools.chaos --replicas 3 --qps 40 \
        --duration 6 --scenarios crash,hang,slow,poison \
        --availability-pct 99 --device cpu --out chaos.json

The port's copy of ``tools/chaos.py``: the same scenarios, verdicts,
report schema and function names, run against
``paddle_tpu_torch.serving``'s ``FleetSupervisor`` / ``Router`` /
``RouterServer`` / ``GenerationEngine`` and the port's ``fault`` module.
Where it differs from the reference (each place names the reference's
line): the fleets run ``python -m paddle_tpu_torch.serving.replica`` on
the card unless ``device="cpu"`` / ``--device cpu`` (no GPU and no
explicit CPU raises); the poison sentinel reaches the shared fleet
through the replica's ``--poison-value``; :func:`run_chaos` also takes
the model a ``/predict`` fleet serves (:class:`PredictModel`: its
replica arguments, request and poison bodies, swap checkpoints and a
fresh reference predictor), the generation model and engine of the
in-process scenarios and the argv of the role-split fleet, so the same
scenarios run at full width (with the defaults it builds exactly the
reference's fleets); ``embedding_shard_crash`` waits for the embedding
tier (ROADMAP.md queue 1 item 8) and raises ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import json
import os
import queue as queue_mod
import signal
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional

import numpy as np

# the poison sentinel: representable exactly in float32 and JSON, far
# outside any real feature distribution
POISON = 1e30

# the generation-path sentinel must be a real token id (prompts are
# int ids, not floats); the paged scenario keeps every legitimate
# token >= POISON_TOKEN + 1 so only deliberate prompts carry it
POISON_TOKEN = 7

# the reference's ten (:168-171) but embedding_shard_crash, which waits
# for the embedding tier (ROADMAP.md queue 1 item 8)
DEFAULT_SCENARIOS = ("baseline", "crash", "hang", "slow", "poison",
                     "poison_paged", "spec_storm", "disagg_crash",
                     "hot_swap", "noisy_neighbor")
NOT_PORTED = {"embedding_shard_crash": "the embedding tier is not ported "
                                       "yet (ROADMAP.md queue 1 item 8)"}

# burn-rate scaling for the chaos run: scenario durations are seconds,
# not SRE hours, so the router's alert windows shrink to fractions of
# one scenario (fast proves "still happening", slow proves "real")
_ALERT_CLEAR_GRACE_S = 5.0


class _AlertSampler:
    """Samples the router burn-rate monitor's firing set on a fast
    clock while a scenario runs, so assertions can ask 'did an alert
    fire INSIDE the fault window' and 'was it clear at the end' from
    the recorded (t, names) trail instead of racing the live state."""

    def __init__(self, router, period_s: float = 0.05):
        self._router = router
        self._period = period_s
        self.samples: List[tuple] = []  # (monotonic_t, (name, ...))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="chaos-alert-sampler",
                                        daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.wait(self._period):
            self.samples.append(
                (time.monotonic(),
                 tuple(self._router.burn_monitor.firing())))

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5.0)

    def fired_between(self, t0: float, t1: float) -> List[str]:
        names = set()
        for t, firing in self.samples:
            if t0 <= t <= t1:
                names.update(firing)
        return sorted(names)

    def fired_ever(self) -> List[str]:
        names = set()
        for _, firing in self.samples:
            names.update(firing)
        return sorted(names)


# ---------------------------------------------------------------------------
# traffic: open-loop POST /predict with per-request attribution
# ---------------------------------------------------------------------------

def _bodies(feat: int, n: int = 16, seed: int = 0) -> List[bytes]:
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        row = rng.rand(1, feat).astype("float32")
        out.append(json.dumps({"inputs": {"x": row.tolist()}}).encode())
    return out


def _poison_body(feat: int) -> bytes:
    row = [[POISON] + [0.5] * (feat - 1)]
    return json.dumps({"inputs": {"x": row}}).encode()


class PredictModel:
    """What the ``/predict`` fleets of :func:`run_chaos` serve.  The
    reference hard-codes the replica's synthetic MLP (``:1907-1910``,
    ``:1371-1373``, ``:1610-1617``); the port takes it as an argument so
    the same scenarios run at a model's full width.

    ``argv``: the replica's model arguments, placed after each
    scenario's engine arguments (so a model may set its own, such as
    ``--max-delay-ms``) and before ``--device``.  ``bodies(seed)``: 16
    ``POST /predict`` bodies from a seed.  ``poison``: a body carrying
    :data:`POISON` in a float feed.  ``write_checkpoint(dirname,
    seed)``: a swap checkpoint of the served structure with other
    weights.  ``fresh(checkpoint)``: a Predictor on the replicas' device
    serving ``checkpoint``'s weights, whose answer to ``probe`` (a feed
    dict) every replica must give after ``hot_swap`` (tolerance 0).
    ``gen_argv``: the generator ``hot_swap``'s fleet also serves (a
    quarter of its storm is ``/generate``), None for a fleet that serves
    ``/predict`` alone.  ``swap_fault``: the fault spec that widens each
    replica's swap commit (one delay a weight array)."""

    def __init__(self, argv, bodies, poison, write_checkpoint=None,
                 fresh=None, probe=None, gen_argv=None,
                 swap_fault="weight_swap:delay:150~1.0"):
        self.argv = list(argv)
        self.bodies = bodies
        self.poison = poison
        self.write_checkpoint = write_checkpoint
        self.fresh = fresh
        self.probe = probe
        self.gen_argv = None if gen_argv is None else list(gen_argv)
        self.swap_fault = swap_fault


# the reference hot_swap fleet's generator (:1612-1615)
SYNTHETIC_GEN_ARGV = ("--generate", "--gen-vocab", "64", "--gen-hidden",
                      "32", "--gen-layers", "2", "--gen-heads", "4",
                      "--gen-intermediate", "64", "--gen-slots", "4",
                      "--gen-max-seq", "64", "--gen-max-new", "4")


def synthetic_model(feat: int, hidden: int, depth: int, device,
                    gen_argv=None) -> PredictModel:
    """The replica's synthetic MLP (``--feat/--hidden/--depth``, 8
    classes), the reference's bodies and poison body, checkpoints from
    ``build_synthetic_checkpoint`` and a fresh predictor built as a
    replica process builds it."""
    import argparse as _argparse

    from paddle_tpu_torch.framework.core import reset_unique_name
    from paddle_tpu_torch.serving.replica import (
        build_predictor, build_synthetic_checkpoint)

    def write_checkpoint(dirname, seed):
        build_synthetic_checkpoint(dirname, feat=feat, hidden=hidden,
                                   depth=depth, classes=8, seed=seed,
                                   device=device)

    def fresh(checkpoint):
        reset_unique_name()
        pred, _ = build_predictor(_argparse.Namespace(
            recsys=False, model_dir=None, shape=None, feat=feat,
            hidden=hidden, depth=depth, classes=8, seed=0,
            device=device))
        pred.swap_weights(checkpoint)
        return pred

    return PredictModel(
        ["--feat", str(feat), "--hidden", str(hidden), "--depth",
         str(depth)],
        lambda seed: _bodies(feat, seed=seed), _poison_body(feat),
        write_checkpoint=write_checkpoint, fresh=fresh,
        probe={"x": np.linspace(-1.0, 1.0, feat,
                                dtype="float32").reshape(1, feat)},
        gen_argv=gen_argv)


def _post(url: str, body: bytes, timeout_s: float,
          tenant: Optional[str] = None):
    """One POST → (outcome, http_status).  Same taxonomy as the
    loadgen: replica/router backpressure 503s are ``shed`` (the
    router's ``no_ready_replicas`` = total availability loss =
    ``failed``), everything else non-200 is ``failed``."""
    headers = {"Content-Type": "application/json"}
    if tenant:
        headers["X-PaddleTPU-Tenant"] = tenant
    req = urllib.request.Request(url, data=body, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as r:
            r.read()
            return "ok", r.status
    except urllib.error.HTTPError as e:
        try:
            payload = e.read()
        except OSError:
            payload = b""  # ok: error body gone with the connection
        if e.code != 503:
            return "failed", e.code
        try:
            reason = json.loads(payload).get("reason")
        except (ValueError, AttributeError):
            reason = None
        return (("failed", e.code) if reason == "no_ready_replicas"
                else ("shed", e.code))
    except (OSError, TimeoutError, ValueError):
        return "failed", None


def run_traffic(url: str, feat: int, qps: float, duration_s: float,
                poison_every: int = 0, timeout_s: float = 15.0,
                workers: int = 16, route: str = "/predict",
                bodies: Optional[List[bytes]] = None,
                tenant_of=None,
                poison: Optional[bytes] = None) -> List[dict]:
    """Open-loop traffic: a pacing clock enqueues bodies at ``qps``; a
    poster pool sends them.  Every request is recorded with its
    monotonic start/end and whether it was deliberately poisoned —
    the attribution the collateral-failure contract needs.
    ``route``/``bodies`` repoint the storm (the disagg scenario sends
    generation bodies at ``/generate``); ``tenant_of(i)`` stamps the
    i-th request with a usage-attribution tenant header and records it
    (the noisy-neighbor scenario's client-side ground truth).
    ``poison`` (the reference's ``:283`` always builds ``_poison_body``)
    is the body every ``poison_every``-th request carries."""
    predict = url.rstrip("/") + route
    bodies = bodies if bodies is not None else _bodies(feat)
    poison = poison if poison is not None else _poison_body(feat)
    records: List[dict] = []
    lock = threading.Lock()
    pending: queue_mod.Queue = queue_mod.Queue()

    def poster():
        while True:
            item = pending.get()
            if item is None:
                return
            body, is_poison, t0, tenant = item
            outcome, status = _post(predict, body, timeout_s,
                                    tenant=tenant)
            t1 = time.monotonic()
            with lock:
                records.append({"t0": t0, "t1": t1, "outcome": outcome,
                                "status": status, "poison": is_poison,
                                "tenant": tenant,
                                "ms": (t1 - t0) * 1e3})

    pool = [threading.Thread(target=poster, daemon=True)
            for _ in range(workers)]
    for t in pool:
        t.start()
    period = 1.0 / max(qps, 0.001)
    t_start = time.monotonic()
    i = 0
    while True:
        now = time.monotonic()
        if now - t_start >= duration_s:
            break
        is_poison = bool(poison_every and (i + 1) % poison_every == 0)
        pending.put((poison if is_poison else bodies[i % len(bodies)],
                     is_poison, now,
                     tenant_of(i) if tenant_of is not None else None))
        i += 1
        sleep_for = t_start + i * period - time.monotonic()
        if sleep_for > 0:
            time.sleep(sleep_for)
    for _ in pool:
        pending.put(None)
    for t in pool:
        t.join()
    return records


# ---------------------------------------------------------------------------
# classification
# ---------------------------------------------------------------------------

def classify(records: List[dict], windows: List[tuple]) -> dict:
    """Attribute every outcome: a failure is *injected* when the
    request was poisoned or its lifetime overlaps a fault window,
    *collateral* otherwise (the hard-zero contract); a poisoned
    request that returned 200 is a *leak* (bisection served a row the
    model must crash on)."""
    n = {"requests": len(records), "ok": 0, "shed": 0,
         "injected_failures": 0, "collateral_failures": 0,
         "poison_leaks": 0, "poisoned": 0}
    ok_ms = []
    for r in records:
        if r["poison"]:
            n["poisoned"] += 1
        if r["outcome"] == "ok":
            n["ok"] += 1
            ok_ms.append(r["ms"])
            if r["poison"]:
                n["poison_leaks"] += 1
        elif r["outcome"] == "shed":
            n["shed"] += 1
        else:
            in_window = any(r["t1"] >= w0 and r["t0"] <= w1
                            for w0, w1 in windows)
            if r["poison"] or in_window:
                n["injected_failures"] += 1
            else:
                n["collateral_failures"] += 1
    nonpoison = n["requests"] - n["poisoned"]
    failed_nonpoison = sum(
        1 for r in records
        if r["outcome"] not in ("ok", "shed") and not r["poison"])
    n["availability_pct"] = round(
        100.0 * (1.0 - failed_nonpoison / max(1, nonpoison)), 3)
    if ok_ms:
        ok_ms.sort()
        n["p99_ms"] = round(
            ok_ms[min(len(ok_ms) - 1,
                      int(np.ceil(0.99 * len(ok_ms))) - 1)], 3)
    else:
        n["p99_ms"] = None
    return n


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------

def _wait_respawned_ready(rep, old_pid, timeout_s: float = 90.0
                          ) -> Optional[float]:
    """Block until the replica slot runs a NEW, ready process; returns
    the monotonic recovery instant (None on timeout)."""
    from paddle_tpu_torch.serving.fleet import _healthz

    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        proc = rep.proc
        if proc is not None and proc.pid != old_pid \
                and proc.poll() is None:
            h = _healthz(rep.url, timeout=2.0)
            if h is not None and h.get("ready"):
                return time.monotonic()
        time.sleep(0.1)
    return None


def _postmortem_verdict(victim, old_pid: int,
                        expect_attr: Optional[str] = None,
                        timeout_s: float = 30.0):
    """The crash-forensics contract for one induced death: the
    supervisor must BOOK the death (harvest + attribution), the
    harvest must have collected at least one flight-recorder artifact
    (the fault-window evidence — a self/rolling dump or the
    supervisor's kill mark), and the attribution must not be
    ``unexplained`` (and must match ``expect_attr`` when the scenario
    knows exactly how it killed).  Returns ``(death_record, error)``
    — ``death_record`` None when the death was never booked."""
    deadline = time.monotonic() + timeout_s
    death = None
    while time.monotonic() < deadline:
        d = victim.last_death
        if d is not None and d.get("pid") == old_pid:
            death = d
            break
        time.sleep(0.1)
    if death is None:
        return None, (f"supervisor never booked the induced death of "
                      f"pid {old_pid} (no harvest/attribution)")
    if not death["postmortems"]:
        return death, (f"no postmortem collected for induced death "
                       f"pid {old_pid} ({death['attribution']})")
    if death["attribution"] == "unexplained":
        return death, (f"induced death pid {old_pid} attributed "
                       f"unexplained despite {len(death['postmortems'])}"
                       f" artifact(s)")
    if expect_attr is not None and death["attribution"] != expect_attr:
        return death, (f"induced death pid {old_pid} attributed "
                       f"{death['attribution']!r}, expected "
                       f"{expect_attr!r}")
    return death, None


def _replica_counters(sup, names) -> dict:
    """Each serving counter in ``names`` summed over the fleet's
    replicas' ``/statusz`` (a replica that does not answer adds
    nothing)."""
    out = dict.fromkeys(names, 0)
    for r in sup._replicas:
        doc = _get_json(r.url.rstrip("/") + "/statusz") or {}
        counters = ((doc.get("engine") or {}).get("stats")
                    or {}).get("counters") or {}
        for n in names:
            out[n] += int(counters.get(n) or 0)
    return out


def _scenario(name: str, sup, router, url: str, cfg: dict) -> dict:
    """Run one scenario's traffic with its injection; returns the
    classified report + the raw records (for the aggregate)."""
    from paddle_tpu_torch import fault

    qps, duration = cfg["qps"], cfg["duration_s"]
    feat = cfg["feat"]
    model = cfg["model"]
    box: Dict[str, Optional[float]] = {"t_fault": None, "t_recover": None}
    error = None
    notes = {}
    injector = None
    poison_every = 0

    if name == "baseline":
        # clean traffic, no injection: the burn-rate false-positive
        # guard (zero alerts allowed) plus the usual hard-zero
        # collateral contract
        pass
    elif name in ("crash", "hang"):
        victim = sup._replicas[0]
        old_pid = victim.proc.pid
        sig = signal.SIGKILL if name == "crash" else signal.SIGSTOP

        def inject():
            time.sleep(duration * 0.25)
            box["t_fault"] = time.monotonic()
            try:
                os.kill(old_pid, sig)
            except OSError as e:
                box["error"] = f"inject: {e}"
                return
            box["t_recover"] = _wait_respawned_ready(victim, old_pid)

        notes["victim"] = victim.url
        if name == "hang":
            notes["hung_kills_before"] = victim.hung_kills
        injector = threading.Thread(target=inject, daemon=True)
        injector.start()
    elif name == "slow":
        # injected in THIS process: the router's forward hop randomly
        # stalls — latency rises, nothing may fail
        fault.configure(f"router_forward:delay:{cfg['slow_delay_ms']}"
                        f"~{cfg['slow_prob']}")
        notes["delay_ms"] = cfg["slow_delay_ms"]
        notes["delay_prob"] = cfg["slow_prob"]
    elif name == "poison":
        poison_every = cfg["poison_every"]
        notes["poison_every"] = poison_every
    else:
        raise ValueError(f"unknown scenario {name!r}")

    sampler = _AlertSampler(router)
    try:
        records = run_traffic(url, feat, qps, duration,
                              poison_every=poison_every,
                              timeout_s=cfg["timeout_s"],
                              bodies=model.bodies(0), poison=model.poison)
    finally:
        if name == "slow":
            fault.configure("")  # restore: later scenarios run clean
    if injector is not None:
        injector.join(timeout=120.0)
        if box.get("error"):
            error = box["error"]
        elif box["t_fault"] is None:
            error = "injection never fired"
        elif box["t_recover"] is None:
            error = "victim never respawned ready"
    if name == "hang" and error is None:
        victim = sup._replicas[0]
        notes["hung_kills_after"] = victim.hung_kills
        if victim.hung_kills <= notes["hung_kills_before"]:
            # the supervisor must have done the killing — a recovery
            # via any other path means the watchdog did not fire
            error = "liveness watchdog never SIGKILLed the hung replica"
    unexplained_deaths = None
    if name in ("crash", "hang"):
        # crash-forensics contract: the induced death must be booked,
        # carry >=1 harvested artifact, and be attributed exactly as
        # induced (SIGKILL decodes to signal:SIGKILL; the watchdog's
        # kill mark decodes to hung_kill).  The per-scenario
        # unexplained count rides into totals for the perf_gate
        # hard-zero (None = the death was never even booked)
        death, pm_err = _postmortem_verdict(
            sup._replicas[0], old_pid,
            "signal:SIGKILL" if name == "crash" else "hung_kill")
        notes["postmortem"] = death
        if death is not None:
            unexplained_deaths = \
                1 if death["attribution"] == "unexplained" else 0
        if error is None and pm_err is not None:
            error = pm_err

    windows = []
    if box["t_fault"] is not None:
        # +grace: the router may still be converging (poll cadence)
        # right after the successor reports ready
        w_end = (box["t_recover"] or time.monotonic()) + 1.0
        windows.append((box["t_fault"], w_end))

    # burn-rate alert contract.  Fault scenarios (a window exists):
    # an alert must FIRE inside the window and CLEAR after recovery.
    # Clean scenarios (baseline / slow / poison): any firing alert is
    # a false positive.  Both are scenario errors — they ride the same
    # hard gate as collateral failures.
    alerts: Dict[str, object] = {}
    if windows:
        w0, w1 = windows[0]
        # the fast window must age past the fault before the clear
        # verdict; sample until cleared or the grace runs out
        clear_deadline = time.monotonic() \
            + router.burn_monitor.fast_s + _ALERT_CLEAR_GRACE_S
        while time.monotonic() < clear_deadline \
                and router.burn_monitor.firing():
            time.sleep(0.1)
        sampler.stop()
        fired = sampler.fired_between(w0, w1)
        still = router.burn_monitor.firing()
        alerts = {"fired_in_window": fired, "cleared": not still,
                  "still_firing": still}
        if error is None and not fired:
            error = ("burn-rate alert never fired inside the "
                     f"{name} fault window")
        elif error is None and still:
            error = (f"burn-rate alert(s) {still} never cleared "
                     f"after {name} recovery")
    else:
        sampler.stop()
        fired = sampler.fired_ever()
        alerts = {"fired": fired, "expected": "none"}
        if error is None and fired:
            error = (f"false-positive burn-rate alert(s) {fired} "
                     f"during clean scenario {name}")
    rep = classify(records, windows)
    rep["scenario"] = name
    rep["notes"] = notes
    rep["alerts"] = alerts
    if name in ("crash", "hang"):
        rep["unexplained_deaths"] = unexplained_deaths
    if box["t_fault"] is not None and box["t_recover"] is not None:
        rep["recovery_s"] = round(box["t_recover"] - box["t_fault"], 3)
    if name == "poison":
        # the replicas' own books of the isolation (the port's addition:
        # the reference reads the client side alone)
        rep["notes"].update(_replica_counters(
            sup, ("bisections", "poison_rows")))
    if name == "poison" and error is None:
        if rep["poisoned"] == 0:
            error = "no poisoned requests were sent"
        elif rep["injected_failures"] == 0 and rep["poison_leaks"] == 0:
            # every poisoned request was shed before reaching a model:
            # the run proved nothing about bisection
            error = "no poisoned request reached a model"
    if error is not None:
        rep["error"] = error
    rep["_records"] = records
    return rep


# the in-process scenarios' model and engine: the reference's
# (:603-608, :730-736), except the attention, which is the reference's
# einsum formulation ("xla") on the CPU and the kernel on the card (the
# port runs no plain version there)
GEN_MODEL = dict(vocab_size=64, hidden=32, num_layers=2, num_heads=4,
                 num_kv_heads=2, intermediate=64)
GEN_ENGINE = dict(num_slots=4, max_seq_len=64, max_new_tokens=8, seed=0,
                  queue_cap=256, deadline_ms=600000.0, paged=True,
                  page_tokens=8, prefill_chunk=0, prefix_reuse=True)


def _gen_model(cfg: dict) -> dict:
    return cfg.get("gen_model") or GEN_MODEL


def _gen_engine(cfg: dict, **extra):
    """A paged GenerationEngine for poison_paged / spec_storm on
    ``cfg["device"]``: the reference's engine, ``cfg["gen_engine"]``'s
    arguments over it (the width a run serves), then ``extra``."""
    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.serving import GenerationEngine

    device = resolve_device(cfg.get("device"))
    kw = dict(GEN_ENGINE, attn_impl="xla" if device.type == "cpu"
              else "auto", device=device)
    kw.update(cfg.get("gen_engine") or {})
    kw.update(extra)
    # the weights from the engine's seed alone, as a replica draws its
    # generator's (the reference's engines draw from the op-seed counter
    # as the process left it): a run's scenarios see the same model
    # whatever was built before them; the counter is put back after
    op_seed = registry._OP_SEED[0]
    registry.reset_op_seed()
    try:
        return GenerationEngine(_gen_model(cfg), **kw)
    finally:
        registry.reset_op_seed(op_seed)


def _release(device):
    """Hand what the process's caching allocator holds back to the card
    (after an in-process scenario's engine is gone), so the fleets that
    later scenarios spawn find it free."""
    if device.type == "cuda":
        import gc

        import torch

        gc.collect()
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def _scenario_poison_paged(cfg: dict) -> dict:
    """Paged-path poison containment, in-process (the page pool and
    prefix index live inside a GenerationEngine, not behind the
    router): clean prompts sharing a system header decode bit-exact
    against a poison-free reference while every Nth prompt — sharing
    the SAME cached prefix — carries the poison token.

    The contract under test: the prefill-time poison check fires
    BEFORE the prefix index maps any shared page into the slot, so a
    poisoned prompt (a) fails exactly itself, (b) evicts nothing, and
    (c) cannot corrupt the shared pages other slots are concurrently
    reading — asserted by bit-exact rider streams AND by a post-storm
    borrower that must still hit the index and match the reference."""
    import paddle_tpu_torch as pt

    vocab = _gen_model(cfg)["vocab_size"]
    poison_every = max(2, int(cfg.get("poison_every", 5)))
    rng = np.random.RandomState(5)
    # all legitimate tokens sit above the sentinel id (the reference
    # draws them below its model's vocab, 64: the same draws here)
    header = rng.randint(POISON_TOKEN + 1, vocab, size=32).tolist()
    tails = [rng.randint(POISON_TOKEN + 1, vocab, size=6).tolist()
             for _ in range(9)]
    n_steps = 3
    error = None
    notes: Dict[str, object] = {}
    records: List[dict] = []

    # poison-free reference streams run on the SAME engine before the
    # sentinel flag arms (the poison check reads the flag per prefill),
    # so stream equality is exact and only one engine pays the
    # program-build cost; the reference pass also pre-warms the prefix
    # index, making the storm all-borrowers — the sharper COW test
    old_flag = pt.get_flags("FLAGS_serving_poison_value")[
        "FLAGS_serving_poison_value"]
    eng = _gen_engine(cfg)
    try:
        want = [eng.generate(header + t, n_steps)["tokens"]
                for t in tails]
        pt.set_flags({"FLAGS_serving_poison_value":
                      str(float(POISON_TOKEN))})

        def run_one(i, poisoned):
            prompt = header + tails[i]
            if poisoned:
                prompt = prompt[:-1] + [POISON_TOKEN]
            t0 = time.monotonic()
            return i, poisoned, t0, eng.submit(prompt, n_steps)

        # the donor populates the prefix index first, then the storm:
        # clean borrowers and poisoned prompts in flight CONCURRENTLY
        donor = run_one(0, False)
        futs = [donor] + [run_one(i, i % poison_every == 0)
                          for i in range(1, len(tails) - 1)]
        for i, poisoned, t0, fut in futs:
            rec = {"t0": t0, "poison": poisoned, "status": None}
            try:
                res = fut.result(120)
                # a clean stream that drifted from the reference means
                # a poisoned neighbor corrupted shared state: that is
                # a containment break, counted as a (collateral)
                # failure even though the HTTP-level answer was 200
                rec["outcome"] = "ok" if (poisoned
                                          or res["tokens"] == want[i]) \
                    else "failed"
                if not poisoned and res["tokens"] != want[i]:
                    notes.setdefault("corrupted", []).append(i)
            except Exception:  # noqa: BLE001 — the failure taxonomy is
                # the record's job; poisoned failures are the injection
                rec["outcome"] = "failed"
            rec["t1"] = time.monotonic()
            rec["ms"] = (rec["t1"] - rec["t0"]) * 1e3
            records.append(rec)

        hits_during = eng.stats()["counters"]["prefix_hits"]
        # post-storm borrower: the shared pages must still be indexed
        # (not evicted by the poisoned prompts) and bit-exact
        last = len(tails) - 1
        t0 = time.monotonic()
        res = eng.generate(header + tails[last], n_steps)
        records.append({"t0": t0, "t1": time.monotonic(),
                        "ms": (time.monotonic() - t0) * 1e3,
                        "status": None, "poison": False,
                        "outcome": "ok" if res["tokens"] == want[last]
                        else "failed"})
        st = eng.stats()
        notes["prefix_hits"] = st["counters"]["prefix_hits"]
        notes["prefix_index_entries"] = \
            st["paged"]["prefix_index_entries"]
        notes["page_evictions"] = st["counters"]["page_evictions"]
        if res["tokens"] != want[last]:
            error = "post-storm borrower stream drifted (shared " \
                    "pages corrupted?)"
        elif st["counters"]["prefix_hits"] <= hits_during:
            error = "post-storm borrower missed the prefix index " \
                    "(poisoned prompts evicted shared pages?)"
        elif notes.get("corrupted"):
            error = f"clean stream(s) {notes['corrupted']} drifted " \
                    f"from the poison-free reference"
    finally:
        pt.set_flags({"FLAGS_serving_poison_value": old_flag})
        eng.close()

    rep = classify(records, [])
    rep["scenario"] = "poison_paged"
    rep["notes"] = notes
    if error is None:
        if rep["poisoned"] == 0:
            error = "no poisoned prompts were submitted"
        elif rep["poison_leaks"] == 0 and rep["injected_failures"] == 0:
            error = "no poisoned prompt reached the prefill check"
    if error is not None:
        rep["error"] = error
    rep["_records"] = records
    return rep


def _scenario_spec_storm(cfg: dict) -> dict:
    """Speculative-decoding storm, in-process (extends the
    ``poison_paged`` family): concurrent speculating slots share a
    cached prefix while every Nth prompt carries the poison token AND
    a ``decode_step:fail`` fault detonates MID-VERIFY (the verify
    chunk fires the same decode_step fault site as the plain step).

    The contract under test: speculation never widens the blast
    radius.  A mid-verify fault fails exactly the requests active at
    that instant (injected, window = each victim's own lifetime), a
    poisoned prompt fails exactly itself, and every clean stream that
    COMPLETES is bit-exact against the speculation-on poison-free
    reference — drift is collateral.  Afterward the rollback
    accounting must balance (accepted <= proposed, rollbacks <=
    drafts) and the page pool must drain to ZERO live pages once the
    prefix index is flushed: rejected drafts and fault-killed slots
    alike return every provisionally-held page."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import fault as fault_mod

    poison_every = max(2, int(cfg.get("poison_every", 5)))
    # periodic prompts so the n-gram drafter fires every round: the
    # suffix trigram always has an earlier occurrence in the header,
    # and the distinct repetitive tails keep the streams per-request
    header = [11, 23, 42, 9] * 8
    tails = [[20 + i, 33, 20 + i, 33, 20 + i, 33] for i in range(9)]
    n_steps = 6
    error = None
    notes: Dict[str, object] = {}
    records: List[dict] = []
    windows: List[tuple] = []

    # speculation-on reference streams run on the SAME engine before
    # the poison flag and the fault injector arm — bit-exactness of
    # spec-vs-plain is the tentpole's own gate; here the reference
    # fixes the target the storm's survivors must still hit
    old_flag = pt.get_flags("FLAGS_serving_poison_value")[
        "FLAGS_serving_poison_value"]
    eng = _gen_engine(cfg, speculate=True, spec_tokens=4, spec_ngram=3)
    try:
        want = [eng.generate(header + t, n_steps)["tokens"]
                for t in tails]
        sp0 = eng.stats()["speculate"]
        pt.set_flags({"FLAGS_serving_poison_value":
                      str(float(POISON_TOKEN))})
        # the 9th decode_step hit lands a few scheduler iterations in,
        # with several speculating slots in flight; one-shot (not
        # sticky) so the post-storm borrower decodes fault-free
        fault_mod.configure("decode_step:fail@9")

        def run_one(i, poisoned):
            prompt = header + tails[i]
            if poisoned:
                prompt = prompt[:-1] + [POISON_TOKEN]
            t0 = time.monotonic()
            return i, poisoned, t0, eng.submit(prompt, n_steps)

        futs = [run_one(0, False)] \
            + [run_one(i, i % poison_every == 0)
               for i in range(1, len(tails) - 1)]
        victims = 0
        poison_hits = 0
        for i, poisoned, t0, fut in futs:
            rec = {"t0": t0, "poison": poisoned, "status": None}
            try:
                res = fut.result(120)
                # a clean stream that COMPLETED but drifted means the
                # storm corrupted shared state: collateral (no window
                # covers a successful-but-wrong answer)
                rec["outcome"] = "ok" if (poisoned
                                          or res["tokens"] == want[i]) \
                    else "failed"
                if not poisoned and res["tokens"] != want[i]:
                    notes.setdefault("corrupted", []).append(i)
            except Exception as e:  # noqa: BLE001 — taxonomy below
                rec["outcome"] = "failed"
                rec["t1"] = time.monotonic()
                if "injected decode_step" in str(e):
                    # mid-verify fault victim: injected by
                    # construction, so its own lifetime is the window
                    victims += 1
                    windows.append((t0, rec["t1"]))
                elif poisoned:
                    poison_hits += 1
            rec.setdefault("t1", time.monotonic())
            rec["ms"] = (rec["t1"] - rec["t0"]) * 1e3
            if rec["outcome"] == "failed" and rec["poison"]:
                poison_hits = max(poison_hits, 1)
            records.append(rec)

        # disarm before the post-storm borrower: it must decode (and
        # speculate) clean, bit-exact, after the fault flushed the
        # prefix index and rolled every victim's pages back
        fault_mod.reset()
        last = len(tails) - 1
        t0 = time.monotonic()
        res = eng.generate(header + tails[last], n_steps)
        records.append({"t0": t0, "t1": time.monotonic(),
                        "ms": (time.monotonic() - t0) * 1e3,
                        "status": None, "poison": False,
                        "outcome": "ok" if res["tokens"] == want[last]
                        else "failed"})
        st = eng.stats()
        sp = st["speculate"]
        notes["spec"] = {k: sp[k] for k in
                         ("drafts", "tokens_proposed",
                          "tokens_accepted", "rollbacks",
                          "acceptance_rate")}
        notes["fault_victims"] = victims
        # drain accounting: every request resolved, so only the
        # prefix index may legitimately hold pages; flush it and the
        # pool must hit zero — anything left is a leaked draft page
        deadline = time.monotonic() + 5.0
        live = st["paged"]["pages_live"]
        while time.monotonic() < deadline:
            time.sleep(0.05)
            now_live = eng.stats()["paged"]["pages_live"]
            if now_live == live:
                break
            live = now_live
        eng._prefix.flush()
        leaked = eng.stats()["paged"]["pages_live"]
        notes["leaked_pages"] = leaked
        if res["tokens"] != want[last]:
            error = "post-storm borrower stream drifted (rollback " \
                    "left corrupt state behind?)"
        elif notes.get("corrupted"):
            error = f"clean stream(s) {notes['corrupted']} drifted " \
                    f"from the speculation-on reference"
        elif victims == 0:
            error = "decode_step fault never fired mid-verify"
        elif sp["drafts"] <= sp0["drafts"]:
            error = "no drafts proposed during the storm " \
                    "(speculation never exercised)"
        elif sp["tokens_accepted"] > sp["tokens_proposed"]:
            error = f"accepted {sp['tokens_accepted']} > proposed " \
                    f"{sp['tokens_proposed']} (counter imbalance)"
        elif sp["rollbacks"] > sp["drafts"]:
            error = f"rollbacks {sp['rollbacks']} > drafts " \
                    f"{sp['drafts']} (counter imbalance)"
        elif leaked > 0:
            error = f"{leaked} page(s) still live after drain " \
                    f"(rejected-draft rollback leaked)"
    finally:
        fault_mod.reset()
        pt.set_flags({"FLAGS_serving_poison_value": old_flag})
        eng.close()

    rep = classify(records, windows)
    rep["scenario"] = "spec_storm"
    rep["notes"] = notes
    rep["leaked_pages"] = notes.get("leaked_pages")
    if error is None:
        if rep["poisoned"] == 0:
            error = "no poisoned prompts were submitted"
        elif rep["poison_leaks"] == 0 and poison_hits == 0:
            error = "no poisoned prompt reached the prefill check"
    if error is not None:
        rep["error"] = error
    rep["_records"] = records
    return rep


DISAGG_ARGV = ("--feat", "8", "--hidden", "16", "--depth", "1",
               "--generate", "--gen-vocab", "64", "--gen-hidden", "32",
               "--gen-layers", "2", "--gen-heads", "4",
               "--gen-intermediate", "64", "--gen-slots", "4",
               "--gen-max-seq", "64", "--gen-max-new", "8",
               "--gen-page-tokens", "8",
               "--queue-cap", "512", "--deadline-ms", "60000")


def _scenario_disagg_crash(cfg: dict, log=print) -> dict:
    """Disaggregated-fleet containment: a role-split generation fleet
    (2 prefill + 2 decode replicas) serves MIXED long-prompt/
    short-chat ``/generate`` traffic through an affinity router while
    a prefill replica is SIGKILLed mid-handoff and then a decode
    replica is SIGKILLed while holding live adopted segments.

    The contract: (a) zero collateral failures — every failed request
    lies inside a fault window (prefill kills heal by the router's
    connect-refused retry onto the surviving prefill replica; decode
    kills surface as the explicit ``affinity_lost`` taxonomy, never a
    silent re-prefill); (b) the burn-rate alert fires inside each
    fault window and clears after recovery; (c) after the storm
    drains, EVERY replica's page pool reports zero live pages — a
    leaked page means a refcount path (export, adopt, failure) lost a
    decref; (d) the supervisor respawned both victims ready, roles
    pinned."""
    from paddle_tpu_torch.serving import FleetSupervisor, Router, \
        RouterServer
    from paddle_tpu_torch.serving.fleet import _healthz

    duration = max(float(cfg["duration_s"]) * 1.5, 8.0)
    qps = min(float(cfg["qps"]), 10.0)  # generation >> /predict cost
    roles = ["prefill", "prefill", "decode", "decode"]
    # the replicas' generator: the reference's (:904-910) unless
    # cfg["disagg_argv"] gives one, then the device
    argv = list(cfg.get("disagg_argv") or DISAGG_ARGV) \
        + ["--device", cfg["device"].type]
    # prefix reuse off: a drained pool must read EXACTLY zero live
    # pages (with reuse on, index-held pages are by-design residents)
    env = dict(cfg.get("disagg_env") or {},
               FLAGS_serving_prefix_reuse="0")
    error = None
    notes: Dict[str, object] = {"roles": roles}
    records: List[dict] = []
    windows: List[tuple] = []
    alerts: Dict[str, object] = {}
    leaked = None
    sup = FleetSupervisor(replicas=4, roles=roles, replica_argv=argv,
                          env=env, max_restarts=8, backoff_ms=100.0,
                          liveness_timeout_ms=cfg.get(
                              "liveness_timeout_ms", 1500.0))
    server = None
    sampler = None
    try:
        urls = sup.wait_ready(timeout_s=600)
        fast_s = max(1.0, duration / 4.0)
        slow_s = max(fast_s * 2.0, duration * 0.75)
        # the adopt hop carries a WHOLE generation (prefill hop +
        # decode to completion), not one /predict batch: derive its
        # bound from the caller's knob but floor it well above a
        # full generation on a contended host — a slow-but-healthy
        # adopt timing out outside a fault window would read as a
        # collateral failure and flake the hard-zero contract
        fwd_ms = max(4.0 * float(cfg.get("forward_timeout_ms", 800.0)),
                     5000.0)
        router = Router(urls, poll_interval_ms=100.0, stale_ms=1500.0,
                        eject_after=2, forward_timeout_ms=fwd_ms,
                        slo_fast_s=fast_s, slo_slow_s=slow_s)
        server = RouterServer(router).start()
        router.poll_once()
        if not router.disagg_active():
            raise RuntimeError("role-split fleet did not report "
                               "disagg roles through /healthz")
        # mixed long-prompt/short-chat bodies — the exact traffic
        # shape the subsystem exists to fix
        rng = np.random.RandomState(7)
        bodies = []
        for _ in range(32):
            if rng.random_sample() < 0.25:
                n = int(rng.randint(36, 49))   # long-prompt burst
            else:
                n = int(rng.randint(4, 9))     # short chat turn
            bodies.append(json.dumps(
                {"prompt": rng.randint(8, 64, size=n).tolist(),
                 "max_new_tokens": 4}).encode())
        box: Dict[str, Optional[float]] = {}
        victim_p, victim_d = sup._replicas[0], sup._replicas[2]
        notes["victims"] = {"prefill": victim_p.url,
                            "decode": victim_d.url}

        def inject():
            time.sleep(duration * 0.25)
            old_p = box["pid_p"] = victim_p.proc.pid
            box["t1"] = time.monotonic()
            try:
                os.kill(old_p, signal.SIGKILL)   # mid-handoff
            except OSError as e:
                box["err"] = f"prefill kill: {e}"
                return
            time.sleep(duration * 0.3)
            old_d = box["pid_d"] = victim_d.proc.pid
            box["t2"] = time.monotonic()
            try:
                os.kill(old_d, signal.SIGKILL)   # live segments die
            except OSError as e:
                box["err"] = f"decode kill: {e}"
                return
            box["r1"] = _wait_respawned_ready(victim_p, old_p)
            box["r2"] = _wait_respawned_ready(victim_d, old_d)

        sampler = _AlertSampler(router)
        injector = threading.Thread(target=inject, daemon=True)
        injector.start()
        records = run_traffic(server.url, 8, qps, duration,
                              timeout_s=cfg.get("timeout_s", 30.0),
                              workers=8, route="/generate",
                              bodies=bodies)
        injector.join(timeout=180.0)
        if box.get("err"):
            error = box["err"]
        elif box.get("t1") is None or box.get("t2") is None:
            error = "injection never fired both kills"
        elif box.get("r1") is None:
            error = "prefill victim never respawned ready"
        elif box.get("r2") is None:
            error = "decode victim never respawned ready"
        else:
            windows = [(box["t1"], box["r1"] + 1.0),
                       (box["t2"], box["r2"] + 1.0)]
            notes["recovery_s"] = {
                "prefill": round(box["r1"] - box["t1"], 3),
                "decode": round(box["r2"] - box["t2"], 3)}
        # crash-forensics contract for BOTH induced kills (same
        # verdict as the plain crash scenario): booked, artifacted,
        # attributed signal:SIGKILL
        unexplained = None
        if box.get("pid_p") is not None or box.get("pid_d") is not None:
            unexplained = 0
            notes["postmortems"] = {}
            for label, vic, pid in (("prefill", victim_p,
                                     box.get("pid_p")),
                                    ("decode", victim_d,
                                     box.get("pid_d"))):
                if pid is None:
                    continue
                death, pm_err = _postmortem_verdict(
                    vic, pid, "signal:SIGKILL")
                notes["postmortems"][label] = death
                if death is None:
                    unexplained = None
                elif death["attribution"] == "unexplained" \
                        and unexplained is not None:
                    unexplained += 1
                if error is None and pm_err is not None:
                    error = pm_err
        # burn-rate contract: fire inside EACH fault window, clear
        # after recovery (same machinery as the crash/hang scenarios)
        if windows:
            clear_deadline = time.monotonic() \
                + router.burn_monitor.fast_s + _ALERT_CLEAR_GRACE_S
            while time.monotonic() < clear_deadline \
                    and router.burn_monitor.firing():
                time.sleep(0.1)
        sampler.stop()
        if windows:
            fired = [sampler.fired_between(w0, w1)
                     for w0, w1 in windows]
            still = router.burn_monitor.firing()
            alerts = {"fired_in_windows": fired,
                      "cleared": not still, "still_firing": still}
            if error is None and not all(fired):
                error = ("burn-rate alert missed a disagg_crash "
                         "fault window")
            elif error is None and still:
                error = (f"burn-rate alert(s) {still} never cleared "
                         f"after disagg_crash recovery")
        # leak check: once the queues drain, every replica's pool
        # must hold ZERO live pages (reuse off) — retry until the
        # fleet settles, then read the verdict
        deadline = time.monotonic() + 60.0
        live_view = []
        while time.monotonic() < deadline:
            live_view = []
            for rep in sup._replicas:
                h = _healthz(rep.url, timeout=2.0) or {}
                g = h.get("generation") or {}
                paged = g.get("paged") or {}
                live_view.append({
                    "url": rep.url, "role": rep.role,
                    "pages_live": paged.get("pages_live"),
                    "queue_depth": g.get("queue_depth"),
                    "slots_active": g.get("slots_active")})
            settled = (len(live_view) == 4 and all(
                v["pages_live"] == 0 and v["queue_depth"] == 0
                and v["slots_active"] == 0 for v in live_view))
            if settled:
                leaked = 0
                break
            time.sleep(0.5)
        notes["pools_after"] = live_view
        if leaked is None:
            leaked = sum(v["pages_live"] or 0 for v in live_view)
            if error is None:
                error = (f"page pools never drained to zero after "
                         f"the storm: {live_view}")
        st = router.stats()["counters"]
        notes["router"] = {k: st[k] for k in
                           ("disagg_generations", "affinity_lost",
                            "reprefills", "retries", "no_ready")}
        if error is None and st["disagg_generations"] == 0:
            error = "no request took the disaggregated pipeline"
        if error is None and st["reprefills"] > 0:
            error = ("router re-prefilled despite "
                     "FLAGS_disagg_reprefill=0 (silent re-prefill "
                     "is forbidden by the taxonomy)")
    finally:
        if sampler is not None:
            sampler.stop()
        if server is not None:
            server.close()
        sup.close()

    rep = classify(records, windows)
    rep["scenario"] = "disagg_crash"
    rep["notes"] = notes
    rep["alerts"] = alerts
    rep["leaked_pages"] = leaked
    rep["unexplained_deaths"] = unexplained
    if "recovery_s" in notes:
        rep["recovery_s"] = max(notes["recovery_s"].values())
    if error is None and rep["ok"] == 0:
        error = "no generation request succeeded (fleet never served)"
    if error is not None:
        rep["error"] = error
    rep["_records"] = records
    return rep


def _get_json(url: str, timeout_s: float = 5.0) -> Optional[dict]:
    try:
        with urllib.request.urlopen(url, timeout=timeout_s) as r:
            return json.loads(r.read().decode("utf-8", "replace"))
    except (OSError, TimeoutError, ValueError,
            urllib.error.HTTPError):
        return None


def _epoch_total(points, boundaries) -> float:
    """True lifetime total of a counter series that may have been
    reset by process respawns: every boundary timestamp starts a new
    epoch (a fresh process whose counter restarted from zero), so the
    lifetime total is the sum of each epoch's final sample.  A naive
    ``last(series)`` read would lose every pre-respawn epoch — the
    dip the reset-aware federation exists to survive."""
    total, last, bi = 0.0, None, 0
    bounds = sorted(boundaries)
    for ts, v in points:
        while bi < len(bounds) and ts >= bounds[bi]:
            if last is not None:
                total += last
            last = None
            bi += 1
        last = v
    if last is not None:
        total += last
    return total


def _scenario_noisy_neighbor(cfg: dict, log=print) -> dict:
    """Usage-observatory forensics: a 3-replica dense fleet behind its
    own federating router serves multi-tenant ``/predict`` traffic —
    one zipf-hot hog tenant floods (~80% of offered load) while three
    background tenants trickle — and one replica is SIGKILLed
    mid-storm.

    The contract: (a) **attribution** — the hog's share of booked
    per-tenant request cost is at least 90% of its client-side share
    (a dropped tenant header anywhere on the path collapses the hog
    into ``~default`` and fails this); (b) **measurement** — every
    replica, including the respawned victim, reports a measured
    per-tenant request p99 for every background tenant via
    ``/usagez`` (noisy-neighbor forensics needs the victims' latency,
    not just the hog's volume); (c) **conservation across the
    respawn** — on every replica the live ledger's per-field deltas
    are zero, AND the router's federated per-(tenant, replica) series
    conserve at tolerance 0 against the per-replica all-tenant totals
    when both are summed epoch-aware across the SIGKILL reset (raw
    last-value reads would drop the victim's pre-kill bookings);
    (d) the sketch stays within its hard memory bound on every
    replica; (e) the kill is harvested and attributed
    ``signal:SIGKILL``."""
    from paddle_tpu_torch.serving import FleetSupervisor, Router, \
        RouterServer
    from paddle_tpu_torch.serving import usage
    from paddle_tpu_torch.serving.fleet import _healthz

    duration = max(float(cfg["duration_s"]), 6.0)
    qps = float(cfg["qps"])
    feat = cfg["feat"]
    model = cfg["neighbor_model"]
    hog = "tenant-hog"
    bg = ["tenant-bg-0", "tenant-bg-1", "tenant-bg-2"]
    tenant_names = [hog] + bg + [usage.OTHER_TENANT,
                                 usage.default_tenant()]
    fields = list(usage.COST_FIELDS)
    # the reference's engine arguments, then the model's (the
    # reference's MLP, :1371-1373) and the device
    argv = ["--max-batch", "8", "--max-delay-ms", "2.0", "--queue-cap",
            "512", "--deadline-ms", "30000"] + model.argv + [
        "--device", cfg["device"].type]
    error = None
    notes: Dict[str, object] = {"hog": hog, "background": bg}
    records: List[dict] = []
    windows: List[tuple] = []
    unexplained = None
    conservation_delta = None
    attribution_ratio = None
    sketch_violations = None
    sup = FleetSupervisor(replicas=3, replica_argv=argv,
                          max_restarts=8, backoff_ms=100.0,
                          liveness_timeout_ms=cfg.get(
                              "liveness_timeout_ms", 1500.0))
    server = None
    try:
        urls = sup.wait_ready(timeout_s=600)
        fwd_ms = max(4.0 * float(cfg.get("forward_timeout_ms", 800.0)),
                     5000.0)
        router = Router(urls, poll_interval_ms=100.0, stale_ms=1500.0,
                        eject_after=2, forward_timeout_ms=fwd_ms)
        server = RouterServer(router).start()
        router.poll_once()

        # 4 requests in 5 go to the hog; the rest round-robin the
        # background trickle — the zipf-hot shape at deterministic odds
        def tenant_of(i: int) -> str:
            return hog if i % 5 else bg[(i // 5) % len(bg)]

        box: Dict[str, Optional[float]] = {}
        victim = sup._replicas[0]
        notes["victim"] = victim.url

        def inject():
            time.sleep(duration * 0.35)
            old = box["pid"] = victim.proc.pid
            box["t_kill"] = time.monotonic()
            try:
                os.kill(old, signal.SIGKILL)
            except OSError as e:
                box["err"] = f"kill: {e}"
                return
            box["t_ready"] = _wait_respawned_ready(victim, old)

        injector = threading.Thread(target=inject, daemon=True)
        injector.start()
        records = run_traffic(server.url, feat, qps, duration,
                              timeout_s=cfg.get("timeout_s", 30.0),
                              workers=8, tenant_of=tenant_of,
                              bodies=model.bodies(0),
                              poison=model.poison)
        injector.join(timeout=180.0)
        if box.get("err"):
            error = box["err"]
        elif box.get("t_kill") is None:
            error = "injection never fired the kill"
        elif box.get("t_ready") is None:
            error = "victim never respawned ready"
        else:
            windows = [(box["t_kill"], box["t_ready"] + 1.0)]
            notes["recovery_s"] = round(
                box["t_ready"] - box["t_kill"], 3)
        if box.get("pid") is not None:
            death, pm_err = _postmortem_verdict(victim, box["pid"],
                                                "signal:SIGKILL")
            notes["postmortem"] = death
            unexplained = (None if death is None else
                           int(death["attribution"] == "unexplained"))
            if error is None and pm_err is not None:
                error = pm_err
        # direct per-replica background probes: forensics needs the
        # background tenants' latency MEASURED on every replica —
        # including the respawned victim, whose ledger restarted empty
        probe = model.bodies(7)[0]
        probe_ok: Dict[str, int] = {}
        for rep_ in sup._replicas:
            for t in bg:
                for _ in range(3):
                    outcome, _status = _post(
                        rep_.url.rstrip("/") + "/predict", probe,
                        cfg.get("timeout_s", 30.0), tenant=t)
                    if outcome == "ok":
                        probe_ok[t] = probe_ok.get(t, 0) + 1
        # settle: queues drained on every replica, then one more poll
        # so the federation's final scrape sees every booking
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            depths = []
            for rep_ in sup._replicas:
                h = _healthz(rep_.url, timeout=2.0) or {}
                depths.append((h.get("serving") or {}).get(
                    "queue_depth"))
            if len(depths) == 3 and all(d == 0 for d in depths):
                break
            time.sleep(0.3)
        router.poll_once()
        # (b) + (d): per-replica /usagez — background p99 measured
        # everywhere, ledger conservation zero, sketch within bound
        ledger_delta = 0
        sketch_violations = 0
        unmeasured: List[str] = []
        usage_after = []
        for rep_ in sup._replicas:
            uz = _get_json(rep_.url.rstrip("/") + "/usagez")
            if uz is None:
                unmeasured.append(f"{rep_.url}: /usagez unreachable")
                continue
            tenants = uz.get("tenants") or {}
            for t in bg:
                p99 = ((tenants.get(t) or {}).get("request_ms")
                       or {}).get("p99")
                if p99 is None:
                    unmeasured.append(f"{rep_.url}: {t} p99 missing")
            for f, c in (uz.get("conservation") or {}).items():
                ledger_delta = max(ledger_delta, abs(c["delta"]))
            sk = uz.get("sketch") or {}
            if not (sk.get("within_bound")
                    and sk.get("tracked", 1 << 30) <= sk.get("top_k", 0)
                    and sk.get("capacity_vectors")
                    == sk.get("top_k", 0) + 1):
                sketch_violations += 1
            usage_after.append({
                "url": rep_.url,
                "requests": {t: (tenants.get(t) or {}).get(
                    "vector", {}).get("requests", 0)
                    for t in [hog] + bg},
                "sketch": sk})
        notes["usage_after"] = usage_after
        if error is None and unmeasured:
            error = ("background tenant latency unmeasured: "
                     + "; ".join(unmeasured))
        if error is None and sketch_violations:
            error = (f"{sketch_violations} replica(s) violate the "
                     f"sketch memory bound")
        # (c): federated conservation at tolerance 0, epoch-aware
        # across the victim's SIGKILL reset.  The victim's series
        # restart from zero mid-run; splitting every one of its series
        # at the first post-kill scrape and summing epoch-final values
        # recovers the true lifetime totals on both sides, so the
        # per-tenant sum must equal the all-tenant total EXACTLY
        fed_delta = 0.0
        booked: Dict[str, float] = {t: 0.0 for t in tenant_names}
        for rep_ in sup._replicas:
            rid = rep_.url.split("://", 1)[-1]
            t_kill = box.get("t_kill")
            bounds: List[float] = []
            if rep_ is victim and t_kill is not None:
                pts = router._db.points(
                    f"serving_tenant_requests[{rid}]")
                bounds = [ts for ts, _ in pts if ts > t_kill][:1]
            for f in fields:
                labeled = 0.0
                for t in tenant_names:
                    v = _epoch_total(router._db.points(
                        f"serving_tenant_{f}{{{t}}}[{rid}]"), bounds)
                    labeled += v
                    if f == "requests":
                        booked[t] += v
                total = _epoch_total(router._db.points(
                    f"serving_tenant_{f}[{rid}]"), bounds)
                fed_delta = max(fed_delta, abs(labeled - total))
        conservation_delta = max(float(ledger_delta), fed_delta)
        notes["ledger_conservation_delta"] = ledger_delta
        notes["federated_conservation_delta"] = fed_delta
        if error is None and conservation_delta != 0:
            error = (f"per-tenant usage does not conserve across the "
                     f"respawn: ledger delta {ledger_delta}, "
                     f"federated delta {fed_delta}")
        # (a): attribution — the hog's booked share must track its
        # client-side share (>= 90% of it); a header dropped on any
        # hop folds the hog into ~default and collapses this ratio
        ok_by_tenant: Dict[str, int] = dict(probe_ok)
        for r in records:
            if r["outcome"] == "ok" and r.get("tenant"):
                ok_by_tenant[r["tenant"]] = \
                    ok_by_tenant.get(r["tenant"], 0) + 1
        client_total = sum(ok_by_tenant.values())
        booked_total = sum(booked.values())
        notes["booked_requests"] = {t: booked[t] for t in tenant_names}
        notes["client_ok_requests"] = ok_by_tenant
        if client_total and booked_total:
            client_share = ok_by_tenant.get(hog, 0) / client_total
            booked_share = booked[hog] / booked_total
            attribution_ratio = round(
                booked_share / client_share, 4) if client_share else None
            notes["hog_client_share"] = round(client_share, 4)
            notes["hog_booked_share"] = round(booked_share, 4)
        if error is None and (attribution_ratio is None
                              or attribution_ratio < 0.9):
            error = (f"hog attribution ratio {attribution_ratio} "
                     f"below the 0.9 floor — excess cost was not "
                     f"booked to the noisy tenant")
    finally:
        if server is not None:
            server.close()
        sup.close()

    rep = classify(records, windows)
    rep["scenario"] = "noisy_neighbor"
    rep["notes"] = notes
    rep["unexplained_deaths"] = unexplained
    rep["usage_conservation_delta"] = conservation_delta
    rep["hog_attribution_ratio"] = attribution_ratio
    rep["sketch_violations"] = sketch_violations
    if "recovery_s" in notes:
        rep["recovery_s"] = notes["recovery_s"]
    if error is None and rep["ok"] == 0:
        error = "no multi-tenant request succeeded (fleet never served)"
    if error is not None:
        rep["error"] = error
    rep["_records"] = records
    return rep


def _scenario_hot_swap(cfg: dict, log=print) -> dict:
    """Hot-swap discipline under fire: a fleet serving MIXED open-loop
    ``/predict`` + ``/generate`` load takes a clean rolling hot-swap,
    then a second rolling swap with one replica SIGKILLed MID-SWAP
    (``weight_swap:delay`` fault widens the commit window so the kill
    reliably lands inside it; the supervisor's restart fallback must
    converge the slot anyway).

    The contract: (a) zero non-shed failures outside the kill window —
    a clean swap quiesces and queues, it never errors live traffic;
    (b) zero torn-version responses — per replica, the published
    ``X-PaddleTPU-Weights-Version`` must flip monotonically (a request
    that STARTED after a new-version response finished may never
    observe an older version; the killed replica may reset to baseline
    exactly once, at the kill); (c) post-rollout outputs are BIT-EXACT
    against a fresh in-process predictor loaded from the same
    checkpoint — swapped-in-place weights and freshly-built weights
    must be indistinguishable; (d) both rollouts report converged."""
    import shutil

    from paddle_tpu_torch.serving import FleetSupervisor

    duration = max(float(cfg["duration_s"]) * 2.5, 12.0)
    qps = min(float(cfg["qps"]), 30.0)
    model = cfg["swap_model"]
    # the reference's engine arguments, then the model's (the
    # reference's MLP and generator, :1611-1617; a model without a
    # generator takes /predict alone) and the device
    argv = ["--max-batch", "8", "--max-delay-ms", "2.0", "--queue-cap",
            "512"] + model.argv + (model.gen_argv or []) + [
        "--device", cfg["device"].type]
    # widen each replica's swap-commit window (per-array delay) so the
    # mid-swap SIGKILL lands INSIDE a commit instead of racing a
    # millisecond flip
    env = {"FLAGS_fault_inject": model.swap_fault}
    workdir = tempfile.mkdtemp(prefix="chaos-hotswap-")
    ck_v2 = os.path.join(workdir, "ck_v2")
    ck_v3 = os.path.join(workdir, "ck_v3")
    model.write_checkpoint(ck_v2, 11)
    model.write_checkpoint(ck_v3, 12)

    error = None
    notes: Dict[str, object] = {}
    records: List[dict] = []
    windows: List[tuple] = []
    rec_lock = threading.Lock()
    stop = threading.Event()
    sup = FleetSupervisor(replicas=3, replica_argv=argv, env=env,
                          max_restarts=8, backoff_ms=100.0,
                          liveness_timeout_ms=cfg.get(
                              "liveness_timeout_ms", 1500.0),
                          workdir=os.path.join(workdir, "fleet"))
    try:
        urls = sup.wait_ready(timeout_s=300)
        rng = np.random.RandomState(3)
        predict_bodies = model.bodies(3)
        gen_bodies = [json.dumps(
            {"prompt": rng.randint(1, 64, size=int(n)).tolist(),
             "max_new_tokens": 3}).encode()
            for n in rng.randint(4, 12, size=16)]

        def one_request(i):
            """Round-robin direct-to-replica with one failover retry
            on a dead socket — the client plays router so the torn
            check keeps exact per-replica attribution."""
            # 25% generation load riding along, on a fleet that
            # generates
            gen = model.gen_argv is not None and i % 4 == 3
            body = (gen_bodies if gen else predict_bodies)[
                i % len(predict_bodies)]
            route = "/generate" if gen else "/predict"
            t0 = time.monotonic()
            for attempt in range(2):
                url = urls[(i + attempt) % len(urls)]
                req = urllib.request.Request(
                    url + route, data=body,
                    headers={"Content-Type": "application/json"})
                try:
                    with urllib.request.urlopen(
                            req, timeout=cfg["timeout_s"]) as r:
                        r.read()
                        outcome, status = "ok", r.status
                        version = r.headers.get(
                            "X-PaddleTPU-Weights-Version")
                        break
                except urllib.error.HTTPError as e:
                    try:
                        e.read()
                    except OSError:
                        pass  # ok: draining the error body is best-effort
                    outcome = "shed" if e.code == 503 else "failed"
                    status = e.code
                    version = e.headers.get(
                        "X-PaddleTPU-Weights-Version")
                    break
                except (OSError, TimeoutError, ValueError):
                    outcome, status, version = "failed", None, None
                    # connect-level death: fail over once, like the
                    # router's connect-refused retry
            t1 = time.monotonic()
            with rec_lock:
                records.append({
                    "t0": t0, "t1": t1, "outcome": outcome,
                    "status": status, "ms": (t1 - t0) * 1e3,
                    "poison": False, "url": url,
                    "version": int(version) if version else None})

        def storm():
            period = 1.0 / max(qps, 0.001)
            t_start = time.monotonic()
            i = 0
            posters: List[threading.Thread] = []
            while not stop.is_set() \
                    and time.monotonic() - t_start < duration:
                th = threading.Thread(target=one_request, args=(i,),
                                      daemon=True)
                th.start()
                posters.append(th)
                i += 1
                sleep_for = t_start + i * period - time.monotonic()
                if sleep_for > 0:
                    time.sleep(sleep_for)
            for th in posters:
                th.join(timeout=cfg["timeout_s"] + 5.0)

        traffic = threading.Thread(target=storm, daemon=True)
        traffic.start()
        time.sleep(duration * 0.15)

        # phase 1: clean rolling hot-swap under load — no fault
        # window, so ANY failure it causes is collateral
        res1 = sup.hot_swap(ck_v2)
        notes["swap_clean"] = {
            "converged": res1["converged"],
            "duration_s": res1["duration_s"],
            "statuses": [r.get("swap_status") for r in
                         res1["replicas"]]}
        if not res1["converged"]:
            error = f"clean hot swap did not converge: {res1}"

        time.sleep(duration * 0.15)

        # phase 2: rolling swap with the middle replica SIGKILLed
        # mid-commit (in_rollout + the injected commit delay time the
        # kill inside the swap)
        victim = sup._replicas[1]
        box: Dict[str, Optional[float]] = {"t_kill": None}

        def killer():
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline:
                if victim.in_rollout:
                    time.sleep(0.25)  # inside the delayed commit
                    try:
                        box["pid"] = victim.proc.pid
                        os.kill(victim.proc.pid, signal.SIGKILL)
                        box["t_kill"] = time.monotonic()
                    except OSError as e:
                        box["err"] = f"kill: {e}"
                    return
                time.sleep(0.002)

        kth = threading.Thread(target=killer, daemon=True)
        kth.start()
        res2 = sup.hot_swap(ck_v3) if error is None else None
        kth.join(timeout=90.0)
        t_swap2_done = time.monotonic()
        if error is None:
            notes["swap_killed"] = {
                "converged": res2["converged"],
                "duration_s": res2["duration_s"],
                "victim": victim.url,
                "fallbacks": sum(1 for r in res2["replicas"]
                                 if "fallback" in r)}
            if box.get("err"):
                error = box["err"]
            elif box["t_kill"] is None:
                error = "SIGKILL never landed mid-swap"
            elif not res2["converged"]:
                error = (f"post-kill rollout did not converge "
                         f"(restart fallback failed): {res2}")
            else:
                # +1s grace: round-robin clients may still be timing
                # out on the respawned socket right at ready
                windows.append((box["t_kill"], t_swap2_done + 1.0))
        # crash-forensics contract: the mid-swap SIGKILL is a death
        # like any other — the fallback-restart path must have booked
        # it (harvested + attributed signal:SIGKILL)
        unexplained = None
        if box.get("pid") is not None:
            death, pm_err = _postmortem_verdict(
                victim, box["pid"], "signal:SIGKILL")
            notes["postmortem"] = death
            if death is not None:
                unexplained = \
                    1 if death["attribution"] == "unexplained" else 0
            if error is None and pm_err is not None:
                error = pm_err

        traffic.join(timeout=duration + 60.0)
        stop.set()

        # torn-version check: per replica, happens-before monotonic —
        # for any request A started strictly after request B finished,
        # version(A) >= version(B).  The killed replica is checked per
        # segment (before / after the kill): its respawn legitimately
        # resets the counter to baseline exactly once
        torn = 0
        seen_versions: Dict[str, List[int]] = {}
        with rec_lock:
            recs = list(records)
        for url in urls:
            mine = [r for r in recs
                    if r["url"] == url and r["version"] is not None]
            seen_versions[url] = sorted(
                {r["version"] for r in mine})
            segments = [mine]
            if url == victim.url and box.get("t_kill"):
                segments = [
                    [r for r in mine if r["t1"] <= box["t_kill"]],
                    [r for r in mine if r["t0"] > box["t_kill"]]]
            for seg in segments:
                by_t1 = sorted(seg, key=lambda r: r["t1"])
                by_t0 = sorted(seg, key=lambda r: r["t0"])
                max_done = 0
                j = 0
                for a in by_t0:
                    while j < len(by_t1) and by_t1[j]["t1"] < a["t0"]:
                        max_done = max(max_done,
                                       by_t1[j]["version"])
                        j += 1
                    if a["version"] < max_done:
                        torn += 1
        notes["versions_seen"] = seen_versions
        notes["torn_responses"] = torn
        if error is None and torn:
            error = (f"{torn} torn-version response(s): a replica "
                     f"served an older weights version after a newer "
                     f"one was already visible")

        # bit-exact: every replica's post-rollout answer must equal a
        # FRESH in-process predictor loaded from the same checkpoint
        # (the model's own: the reference builds its MLP, :1828-1846)
        if error is None:
            ref = model.fresh(ck_v3)
            try:
                want = [np.asarray(o).tolist()
                        for o in ref.run(model.probe)]
            finally:
                ref.close()
            body = json.dumps({"inputs": {
                n: np.asarray(a).tolist()
                for n, a in model.probe.items()}}).encode()
            mismatched = []
            for url in urls:
                req = urllib.request.Request(
                    url + "/predict", data=body,
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=30.0) as r:
                    got = json.loads(r.read())["outputs"]
                if got != want:
                    mismatched.append(url)
            notes["bit_exact"] = not mismatched
            if mismatched:
                error = (f"post-swap outputs diverged from a fresh "
                         f"predictor on {mismatched} — the swap "
                         f"discipline leaked state")
    finally:
        stop.set()
        sup.close()
        shutil.rmtree(workdir, ignore_errors=True)

    rep = classify(records, windows)
    rep["scenario"] = "hot_swap"
    rep["notes"] = notes
    rep["torn_responses"] = notes.get("torn_responses")
    rep["unexplained_deaths"] = unexplained
    if error is None and rep["ok"] == 0:
        error = "no request succeeded (fleet never served)"
    if error is None and rep.get("torn_responses") is None:
        error = "torn-version check never ran"
    if error is not None:
        rep["error"] = error
    rep["_records"] = records
    return rep


# ---------------------------------------------------------------------------
# orchestrator
# ---------------------------------------------------------------------------

def shared_fleet_argv(model: PredictModel, device) -> List[str]:
    """The replica argv of :func:`run_chaos`'s shared ``/predict`` fleet:
    the reference's engine arguments (``:1907-1910``), the model's
    arguments, the poison sentinel through the replica's flag (the
    reference sets its environment variable, ``:1914``) and the
    device."""
    from paddle_tpu_torch.device import resolve_device

    return ["--max-batch", "8", "--max-delay-ms", "2.0", "--queue-cap",
            "512", "--deadline-ms", "30000"] + model.argv + [
        "--poison-value", str(POISON),
        "--device", resolve_device(device).type]


def run_chaos(replicas: int = 3, qps: float = 40.0,
              duration_s: float = 6.0,
              scenarios=DEFAULT_SCENARIOS,
              availability_pct: float = 99.0,
              feat: int = 8, hidden: int = 32, depth: int = 1,
              liveness_timeout_ms: float = 1500.0,
              forward_timeout_ms: float = 800.0,
              poison_every: int = 5,
              slow_delay_ms: int = 40, slow_prob: float = 0.25,
              timeout_s: float = 15.0,
              workdir: Optional[str] = None,
              log=print, device=None,
              model: Optional[PredictModel] = None,
              gen_model: Optional[dict] = None,
              gen_engine: Optional[dict] = None,
              disagg_argv=None, disagg_env: Optional[dict] = None
              ) -> dict:
    """Spawn a fleet + router, run every scenario, and return the
    availability report (``report["ok"]`` is the harness verdict).

    Beyond the reference's arguments (:1886-1897): ``device`` (the card
    unless ``"cpu"``; no GPU and no explicit CPU raises) for every fleet
    and in-process engine; ``model`` (a :class:`PredictModel`), what
    the shared, ``hot_swap`` and ``noisy_neighbor`` fleets serve (None:
    the reference's synthetic MLPs, ``feat`` x ``hidden`` x ``depth``
    for the shared fleet, ``feat`` x 16 x 1 for the other two, the
    hot-swap one with a generator); ``gen_model`` / ``gen_engine``,
    the model and the engine arguments of ``poison_paged`` and
    ``spec_storm`` (None: the reference's); ``disagg_argv`` /
    ``disagg_env``, the role-split fleet's replica arguments and
    environment (None: the reference's).  Each scenario's report also
    carries its ``wall_s``."""
    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.serving import FleetSupervisor, Router, \
        RouterServer

    scenarios = tuple(scenarios)
    for name in scenarios:
        if name in NOT_PORTED:
            raise NotImplementedError(f"chaos scenario {name!r}: "
                                      f"{NOT_PORTED[name]}")
    device = resolve_device(device)
    cfg = {"qps": qps, "duration_s": duration_s, "feat": feat,
           "poison_every": poison_every, "slow_delay_ms": slow_delay_ms,
           "slow_prob": slow_prob, "timeout_s": timeout_s,
           "liveness_timeout_ms": liveness_timeout_ms,
           "forward_timeout_ms": forward_timeout_ms, "device": device,
           "model": model or synthetic_model(feat, hidden, depth, device),
           "swap_model": model or synthetic_model(
               feat, 16, 1, device, gen_argv=SYNTHETIC_GEN_ARGV),
           "neighbor_model": model or synthetic_model(feat, 16, 1, device),
           "gen_model": gen_model, "gen_engine": gen_engine,
           "disagg_argv": disagg_argv, "disagg_env": disagg_env}
    argv = shared_fleet_argv(cfg["model"], device)
    t_setup0 = time.monotonic()
    sup = FleetSupervisor(
        replicas=replicas, replica_argv=argv,
        max_restarts=8, backoff_ms=100.0,
        liveness_timeout_ms=liveness_timeout_ms, workdir=workdir)
    server = None
    per_scenario = {}
    all_records: List[dict] = []
    fault_records: List[dict] = []
    try:
        urls = sup.wait_ready(timeout_s=300)
        # burn-rate windows scaled to scenario time: fast ~ a quarter
        # scenario (clears quickly after recovery), slow ~ most of one
        # (a single bad scrape cannot page).  Alert threshold stays the
        # flag default — the chaos faults burn budget at 10-30x
        fast_s = max(1.0, duration_s / 4.0)
        slow_s = max(fast_s * 2.0, duration_s * 0.75)
        router = Router(urls, poll_interval_ms=100.0, stale_ms=1500.0,
                        eject_after=2,
                        forward_timeout_ms=forward_timeout_ms,
                        slo_fast_s=fast_s, slo_slow_s=slow_s)
        server = RouterServer(router).start()
        router.poll_once()
        log(f"chaos: fleet of {replicas} ready in "
            f"{time.monotonic() - t_setup0:.1f}s; running "
            f"{','.join(scenarios)} at {qps} qps x {duration_s}s each")
        for name in scenarios:
            t_scenario = time.monotonic()
            if name == "poison_paged":
                # in-process paged-generation containment: needs no
                # fleet traffic, but runs inside the same harness so
                # its counters fold into the same hard-zero contract
                rep = _scenario_poison_paged(cfg)
            elif name == "spec_storm":
                # speculative-decoding storm: poison + mid-verify
                # decode_step faults against concurrent speculating
                # slots; in-process like poison_paged so the rollback
                # and leak counters fold into the same hard-zero gates
                rep = _scenario_spec_storm(cfg)
            elif name == "disagg_crash":
                # role-split generation fleet with its own router —
                # spawned fresh so the kills cannot bleed into the
                # shared /predict fleet's attribution
                rep = _scenario_disagg_crash(cfg, log=log)
            elif name == "hot_swap":
                # rolling weight swap + mid-swap SIGKILL against its
                # own fleet (direct per-replica traffic so the torn-
                # version check keeps exact attribution)
                rep = _scenario_hot_swap(cfg, log=log)
            elif name == "noisy_neighbor":
                # multi-tenant usage forensics against its own fleet:
                # a hog tenant floods, background tenants trickle, one
                # replica dies mid-storm — attribution, per-tenant
                # latency, and conservation must survive the respawn
                rep = _scenario_noisy_neighbor(cfg, log=log)
            else:
                rep = _scenario(name, sup, router, server.url, cfg)
            _release(device)
            rep["wall_s"] = round(time.monotonic() - t_scenario, 3)
            records = rep.pop("_records")
            all_records.extend(records)
            if name in ("crash", "hang", "disagg_crash", "hot_swap",
                        "noisy_neighbor"):
                fault_records.extend(records)
            per_scenario[name] = rep
            al = rep.get("alerts") or {}
            log(f"chaos: {name}: {rep['requests']} requests, "
                f"{rep['ok']} ok, {rep['shed']} shed, "
                f"{rep['injected_failures']} injected, "
                f"{rep['collateral_failures']} collateral"
                + (f", recovery {rep['recovery_s']}s"
                   if "recovery_s" in rep else "")
                + (f", alerts fired {al['fired_in_window']} "
                   f"cleared={al['cleared']}"
                   if "fired_in_window" in al else "")
                + (f" ERROR: {rep['error']}" if "error" in rep else ""))
            # let the fleet settle (router re-admits the recovered
            # replica) before the next scenario's attribution starts
            time.sleep(0.5)
            router.poll_once()
    finally:
        if server is not None:
            server.close()
        sup.close()

    # aggregate counts + availability over every record; the
    # injected/collateral attribution needs each scenario's own fault
    # window, so those three fold by summation instead
    totals = classify(all_records, [])
    for k in ("injected_failures", "collateral_failures",
              "poison_leaks"):
        totals[k] = sum(r[k] for r in per_scenario.values())
    # alert-contract verdicts: missed fires, missed clears, and false
    # positives all land in scenario errors; this count gives the gate
    # (and the bench leg) a single number to hard-zero
    totals["alert_errors"] = sum(
        1 for r in per_scenario.values()
        if "error" in r and "burn-rate alert" in r["error"])
    # disagg page-pool leak verdict (None when the scenario didn't
    # run): perf_gate hard-zeroes it like collateral/leaks
    if any("leaked_pages" in r for r in per_scenario.values()):
        totals["leaked_pages"] = sum(
            r.get("leaked_pages") or 0 for r in per_scenario.values())
    # hot-swap torn-version verdict (None when the scenario didn't
    # run): a single torn response breaks the rollout contract, so
    # perf_gate hard-zeroes the sum
    if any("torn_responses" in r for r in per_scenario.values()):
        totals["torn_responses"] = sum(
            r.get("torn_responses") or 0 for r in per_scenario.values())
    # embedding-tier pin-leak verdict (None when the scenario didn't
    # run): a row still pinned after the storm means a lookup lost its
    # unpin — perf_gate hard-zeroes the sum like leaked_pages
    if any("leaked_rows" in r for r in per_scenario.values()):
        totals["leaked_rows"] = sum(
            r.get("leaked_rows") or 0 for r in per_scenario.values())
    # usage-observatory verdicts (None when noisy_neighbor didn't run,
    # or when it ran but could not measure — perf_gate treats a
    # present-but-None value as a failed rule, never a pass):
    # conservation delta hard-zeroes, the hog attribution ratio has a
    # floor, and the sketch bound violation count hard-zeroes
    if any("usage_conservation_delta" in r
           for r in per_scenario.values()):
        vals = [r["usage_conservation_delta"]
                for r in per_scenario.values()
                if "usage_conservation_delta" in r]
        totals["usage_conservation_delta"] = \
            None if any(v is None for v in vals) else max(vals)
    if any("hog_attribution_ratio" in r
           for r in per_scenario.values()):
        vals = [r["hog_attribution_ratio"]
                for r in per_scenario.values()
                if "hog_attribution_ratio" in r]
        totals["hog_attribution_ratio"] = \
            None if any(v is None for v in vals) else min(vals)
    if any("sketch_violations" in r for r in per_scenario.values()):
        vals = [r["sketch_violations"] for r in per_scenario.values()
                if "sketch_violations" in r]
        totals["sketch_violations"] = \
            None if any(v is None for v in vals) else sum(vals)
    # crash-forensics verdict: every induced death must be harvested
    # AND explained.  A per-scenario None means a death was never even
    # booked — that vacuousness propagates to the total (perf_gate
    # treats present-but-None as a failed rule, not a pass)
    pm_scens = [r for r in per_scenario.values()
                if "unexplained_deaths" in r]
    if pm_scens:
        totals["unexplained_deaths"] = None \
            if any(r["unexplained_deaths"] is None for r in pm_scens) \
            else sum(r["unexplained_deaths"] for r in pm_scens)
    fault_ok_ms = sorted(r["ms"] for r in fault_records
                         if r["outcome"] == "ok")
    p99_under_fault = round(
        fault_ok_ms[min(len(fault_ok_ms) - 1,
                        int(np.ceil(0.99 * len(fault_ok_ms))) - 1)], 3) \
        if fault_ok_ms else None
    errors = {n: r["error"] for n, r in per_scenario.items()
              if "error" in r}
    ok = (not errors
          and totals["collateral_failures"] == 0
          and totals["poison_leaks"] == 0
          and totals.get("unexplained_deaths", 0) == 0
          and totals["availability_pct"] >= availability_pct)
    return {
        "ok": ok,
        "availability_pct": totals["availability_pct"],
        "availability_floor": availability_pct,
        "p99_under_fault_ms": p99_under_fault,
        "totals": {k: v for k, v in totals.items() if k != "p99_ms"},
        "scenarios": per_scenario,
        "errors": errors,
        "config": {"replicas": replicas, "qps": qps,
                   "duration_s": duration_s,
                   "scenarios": list(scenarios),
                   "feat": feat, "hidden": hidden, "depth": depth,
                   "liveness_timeout_ms": liveness_timeout_ms,
                   "forward_timeout_ms": forward_timeout_ms,
                   "poison_every": poison_every,
                   "device": device.type,
                   "model_argv": cfg["model"].argv},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--qps", type=float, default=40.0)
    ap.add_argument("--duration", type=float, default=6.0,
                    help="seconds of traffic per scenario")
    ap.add_argument("--scenarios",
                    default=",".join(DEFAULT_SCENARIOS),
                    help="comma-separated subset of "
                         "baseline,crash,hang,slow,poison,poison_paged,"
                         "spec_storm,disagg_crash,hot_swap,"
                         "noisy_neighbor (embedding_shard_crash is not "
                         "ported yet: ROADMAP.md queue 1 item 8)")
    ap.add_argument("--availability-pct", type=float, default=99.0)
    ap.add_argument("--feat", type=int, default=8)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--depth", type=int, default=1)
    ap.add_argument("--liveness-timeout-ms", type=float, default=1500.0)
    ap.add_argument("--forward-timeout-ms", type=float, default=800.0)
    ap.add_argument("--poison-every", type=int, default=5)
    ap.add_argument("--out", help="write the JSON report here")
    # the one flag the reference lacks: the port's fleets run on the
    # card unless the caller asks for the CPU
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the fleets and the in-process engines "
                         "run: 'cuda' (cuda:0, the default) or 'cpu'; "
                         "with no GPU and no --device cpu the run "
                         "raises")
    args = ap.parse_args(argv)

    scenarios = tuple(s for s in args.scenarios.split(",") if s)
    bad = sorted(set(scenarios) - set(DEFAULT_SCENARIOS)
                 - set(NOT_PORTED))
    if bad:
        ap.error(f"unknown scenario(s) {bad}; "
                 f"known: {','.join(DEFAULT_SCENARIOS)}")
    report = run_chaos(
        replicas=args.replicas, qps=args.qps,
        duration_s=args.duration, scenarios=scenarios,
        availability_pct=args.availability_pct, feat=args.feat,
        hidden=args.hidden, depth=args.depth,
        liveness_timeout_ms=args.liveness_timeout_ms,
        forward_timeout_ms=args.forward_timeout_ms,
        poison_every=args.poison_every, device=args.device)
    text = json.dumps(report, indent=1, sort_keys=True)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(text + "\n")
    print(text)
    print(f"CHAOS {'PASSED' if report['ok'] else 'FAILED'}: "
          f"availability {report['availability_pct']}% "
          f"(budget {args.availability_pct}%), "
          f"{report['totals']['collateral_failures']} collateral, "
          f"{report['totals']['poison_leaks']} leaks")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
