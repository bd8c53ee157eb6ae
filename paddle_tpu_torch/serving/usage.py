"""Per-tenant usage attribution — the fleet's cost observatory.

The port's copy of ``paddle_tpu/serving/usage.py``, which is free of jax
(the port imports nothing of the JAX package); its Prometheus families
keep the reference's names, so one scraper reads both packages'
replicas.  The embedding tier's ``hot_row_hits`` field is not here: the
port has no embedding tier to book it.

Every request entering the serving tier carries a **tenant** (the
``X-PaddleTPU-Tenant`` header, or ``submit(tenant=...)`` in process;
``FLAGS_usage_default_tenant`` when absent), and the replica books a
**cost vector** against it as the request moves through admission, the
batcher, the decode grid, and the caches:

========================  ==================================================
field                     meaning
========================  ==================================================
``requests``              admitted requests (one per submit/adopt/predict)
``served``                requests resolved with a real answer
``tokens_in``             prompt tokens actually prefilled (one-shot
                          predict books its feed rows here)
``tokens_out``            generated tokens (incl. the prefill's first)
``prefill_steps``         prefill program executions (whole + chunks)
``decode_steps``          decode-grid step *participations* — one per
                          active slot per grid step (a shared step books
                          one unit to every sequence riding it, so the
                          per-tenant sum counts sequence-steps, not grid
                          dispatches)
``flops``                 flops, priced from the costmodel manifests
                          of the executables the request actually ran
                          (grid-step flops split integer-exactly across
                          the step's riders; 0 where the backend exposes
                          no cost analysis)
``page_us``               KV **page-microseconds**: the integral of paged
                          KV pages held over wall time, accumulated at
                          every block-table change and booked at release
``prefix_hits``           prefix-cache hits (prefill pages served from
                          the shared-prefix index)
``sheds``                 admission/pickup sheds (queue_full, deadline,
                          draining, injected)
``failures``              failed requests (batch failures, poison
                          isolation, decode failures)
========================  ==================================================

Every field is an **integer** and every booking updates the tenant's
vector and the ledger totals under one lock, so the conservation
contract — ``sum over tenants (incl. ~other) == ledger totals`` — holds
at tolerance **0** by construction, and the totals themselves are booked
from the exact code paths that bump the pre-existing global counters
(``serving_requests``, ``serving_generated_tokens``, ...), so the
cross-check against those counters is tolerance 0 too.

Cardinality is bounded by a **space-saving heavy-hitter sketch**
(Metwally et al.): at most ``FLAGS_usage_top_k`` tenants are tracked
exactly at once; when a new tenant arrives into a full sketch, the
tracked tenant with the smallest space-saving *weight* is demoted — its
entire vector folds into the ``~other`` aggregate — and the newcomer
inherits the demoted weight as its rank (classic space-saving: any
tenant whose request share exceeds ``1/top_k`` of traffic is guaranteed
a slot) with the inherited weight recorded as its ``err`` overestimate
bound.  Memory is hard-capped at ``top_k + 1`` cost vectors per replica
no matter how many tenant ids traffic invents.  Bookings for an
untracked tenant that are *not* new requests (a sequence demoted
mid-flight still finishing tokens) go straight to ``~other`` —
conserved, never dropped.

Per-tenant latency histograms and per-tenant ``SloSpec`` burn monitors
ride the existing TSDB/BurnRateMonitor machinery (series
``serving_tenant_request_ms[<tenant>]``); replicas expose ``/usagez``
and a ``usage`` block on ``/statusz``, append labeled
``paddle_tpu_serving_tenant_*{tenant="..."}`` families to ``/metrics``
(each with an unlabeled all-tenant total sample), and the fleet Router
federates them into reset-aware ``fleet_tenant_*`` rollups on
``/fleetz``.

``FLAGS_usage=0`` is the zero-work contract: every request-path call
site guards on :func:`enabled` (one flag-dict lookup, the blackbox
discipline), the ledger singleton is never constructed, and no
per-request allocation happens.
"""
from __future__ import annotations

import re
import threading
import time
from typing import Dict, List, Optional, Sequence

from ..flags import flag_value

__all__ = ["COST_FIELDS", "OTHER_TENANT", "TENANT_RE", "UsageLedger",
           "enabled", "default_tenant", "normalize_tenant", "ledger",
           "peek_ledger", "reset_ledger", "split_ints", "slo_p99_ms"]

COST_FIELDS = ("requests", "served", "tokens_in", "tokens_out",
               "prefill_steps", "decode_steps", "flops", "page_us",
               "prefix_hits", "sheds", "failures")

#: the sketch's demoted-tenant aggregate; reserved (a client claiming it
#: is remapped to the default tenant so conservation semantics survive)
OTHER_TENANT = "~other"

#: tenant ids are short, log-safe tokens — the same shape as trace ids,
#: plus ``.``/``:``/``~`` for org-style names and the built-in defaults
TENANT_RE = re.compile(r"^[A-Za-z0-9._:~-]{1,64}$")


#: the latency SLO (ms) the burn-rate monitors hold p99 to when
#: ``FLAGS_slo_p99_ms`` is 0
DEFAULT_SLO_P99_MS = 250.0


def slo_p99_ms() -> float:
    """``FLAGS_slo_p99_ms``, or :data:`DEFAULT_SLO_P99_MS` when it is 0."""
    return float(flag_value("FLAGS_slo_p99_ms") or 0.0) \
        or DEFAULT_SLO_P99_MS


def enabled() -> bool:
    """The zero-work gate: one flag-dict lookup, nothing else.  Every
    request-path booking site checks this BEFORE building arguments."""
    return bool(flag_value("FLAGS_usage"))


def default_tenant() -> str:
    return str(flag_value("FLAGS_usage_default_tenant") or "~default")


def normalize_tenant(tenant) -> str:
    """Map an optional/untrusted tenant id onto the ledger's key space:
    ``None``/empty → the default tenant; a malformed id or a claim on
    the reserved ``~other`` bucket → the default tenant too (a garbage
    header must not mint unbounded keys or corrupt the aggregate)."""
    if not tenant:
        return default_tenant()
    t = str(tenant).strip()
    if t == OTHER_TENANT or not TENANT_RE.match(t):
        return default_tenant()
    return t


def split_ints(total: int, weights: Sequence[int]) -> List[int]:
    """Split integer ``total`` across ``weights`` proportionally with
    the largest-remainder method — deterministic, and the shares sum to
    EXACTLY ``total`` (the property every shared-cost attribution here
    leans on: a grid step's flops across its riders, a batch's flops
    across its requests).  Zero/empty weights split evenly."""
    n = len(weights)
    if n == 0:
        return []
    total = int(total)
    w = [max(0, int(x)) for x in weights]
    wsum = sum(w)
    if wsum == 0:
        w = [1] * n
        wsum = n
    shares = [total * x // wsum for x in w]
    rem = total - sum(shares)
    if rem:
        # hand out the remainder by largest fractional part, index
        # order breaking ties — stable under permutation of equals
        order = sorted(range(n),
                       key=lambda i: (-(total * w[i] % wsum), i))
        for i in order[:rem]:
            shares[i] += 1
    return shares


class _TenantSlot:
    __slots__ = ("vector", "weight", "err", "admitted")

    def __init__(self, err: int = 0, weight: int = 0):
        self.vector: Dict[str, int] = dict.fromkeys(COST_FIELDS, 0)
        self.weight = int(weight)   # space-saving rank (requests + err)
        self.err = int(err)         # overestimate bound at admission
        self.admitted = time.monotonic()


class UsageLedger:
    """Lock-disciplined per-tenant cost ledger + heavy-hitter sketch.

    One instance per process (see :func:`ledger`); tests build their
    own.  All counter state is integer; all mutation happens under one
    lock so the conservation invariant can never be observed broken."""

    def __init__(self, top_k: Optional[int] = None):
        self.top_k = max(1, int(top_k if top_k is not None
                                else flag_value("FLAGS_usage_top_k")
                                or 32))
        self._lock = threading.Lock()
        self._tenants: Dict[str, _TenantSlot] = {}
        self._other = dict.fromkeys(COST_FIELDS, 0)
        self._totals = dict.fromkeys(COST_FIELDS, 0)
        self._demotions = 0
        self._started = time.time()
        # per-tenant latency: bounded local histograms (tracked tenants
        # + one ~other), tsdb raw-sample series, lazy burn-rate specs
        self._hists: Dict[str, object] = {}
        self._slo_monitor = None
        self._slo_specs: set = set()

    # -- booking ------------------------------------------------------------
    def book(self, tenant: Optional[str], **fields) -> str:
        """Add ``fields`` (int amounts) to ``tenant``'s vector and the
        ledger totals atomically.  Returns the key actually booked
        (the tenant, or ``~other`` for an untracked non-request
        booking into a full sketch)."""
        t = normalize_tenant(tenant)
        with self._lock:
            vec = self._slot_locked(t, admits=fields.get("requests", 0))
            key = t if vec is not self._other else OTHER_TENANT
            for k, v in fields.items():
                v = int(v)
                vec[k] += v
                self._totals[k] += v
            if key != OTHER_TENANT and fields.get("requests"):
                self._tenants[t].weight += int(fields["requests"])
            return key

    def _slot_locked(self, t: str, admits: int) -> Dict[str, int]:
        slot = self._tenants.get(t)
        if slot is not None:
            return slot.vector
        if len(self._tenants) < self.top_k:
            slot = _TenantSlot()
            self._tenants[t] = slot
            return slot.vector
        if not admits:
            # not a new request: a demoted tenant's trailing costs
            # (tokens still decoding, pages still held) aggregate —
            # conserved in ~other rather than re-churning the sketch
            return self._other
        # space-saving replacement: demote the minimum-weight tenant
        # (deterministic tie-break: lexicographically smallest name),
        # fold its exact vector into ~other, and admit the newcomer
        # with the demoted weight inherited as rank and recorded as
        # its overestimate bound
        victim = min(self._tenants,
                     key=lambda k: (self._tenants[k].weight, k))
        vslot = self._tenants.pop(victim)
        for k, v in vslot.vector.items():
            self._other[k] += v
        self._demotions += 1
        self._hists.pop(victim, None)
        slot = _TenantSlot(err=vslot.weight, weight=vslot.weight)
        self._tenants[t] = slot
        return slot.vector

    # -- latency / SLO ------------------------------------------------------
    def observe_latency(self, tenant: Optional[str], ms: float):
        """Per-tenant request latency: local histogram summary (the
        ``/usagez`` view) + raw samples into the default TSDB (the
        burn monitor's evidence; series
        ``serving_tenant_request_ms[<tenant>]``) + a lazily-added
        per-tenant latency ``SloSpec``.  Telemetry off → no series, no
        specs (the counter ledger still books)."""
        from .. import telemetry, tsdb

        t = normalize_tenant(tenant)
        with self._lock:
            if t not in self._tenants:
                t = OTHER_TENANT
            h = self._hists.get(t)
            if h is None:
                h = telemetry.Histogram(f"serving_tenant_request_ms"
                                        f"[{t}]")
                self._hists[t] = h
        h.observe(ms)
        if not (telemetry.enabled() and tsdb.enabled()):
            return
        tsdb.default().record(f"serving_tenant_request_ms[{t}]", ms,
                              cap=1024)
        if t != OTHER_TENANT:
            self._ensure_slo_spec(t)

    def _ensure_slo_spec(self, tenant: str):
        from .. import tsdb

        with self._lock:
            if tenant in self._slo_specs:
                return
            self._slo_specs.add(tenant)
            if self._slo_monitor is None:
                self._slo_monitor = tsdb.BurnRateMonitor(
                    tsdb.default(), [], publish=False)
            mon = self._slo_monitor
        slo_ms = slo_p99_ms()
        mon.add_spec(tsdb.SloSpec(
            f"tenant_p99:{tenant}", "latency",
            latency_series=f"serving_tenant_request_ms[{tenant}]",
            threshold_ms=slo_ms, objective_pct=99.0))

    def slo_state(self) -> Optional[dict]:
        with self._lock:
            mon = self._slo_monitor
        return mon.evaluate() if mon is not None else None

    # -- introspection ------------------------------------------------------
    def snapshot(self) -> dict:
        """Tenant → vector copy (plus ``~other`` and ``~totals``)."""
        with self._lock:
            out = {t: dict(s.vector) for t, s in self._tenants.items()}
            out[OTHER_TENANT] = dict(self._other)
            return {"tenants": out, "totals": dict(self._totals)}

    def conservation(self) -> dict:
        """The contract, live: per-field sum over tenants (incl.
        ``~other``) minus the ledger total — every delta is 0 by
        construction, and a non-zero here is a booking bug."""
        with self._lock:
            sums = dict.fromkeys(COST_FIELDS, 0)
            for s in self._tenants.values():
                for k, v in s.vector.items():
                    sums[k] += v
            for k, v in self._other.items():
                sums[k] += v
            return {k: {"tenant_sum": sums[k],
                        "total": self._totals[k],
                        "delta": sums[k] - self._totals[k]}
                    for k in COST_FIELDS}

    def sketch_stats(self) -> dict:
        with self._lock:
            tracked = len(self._tenants)
            errs = {t: s.err for t, s in self._tenants.items() if s.err}
            return {
                "top_k": self.top_k,
                "tracked": tracked,
                "capacity_vectors": self.top_k + 1,
                "demotions": self._demotions,
                "errs": errs,
                # the hard bound a perf gate asserts: vectors held can
                # never exceed capacity no matter the tenant cardinality
                "within_bound": tracked <= self.top_k,
            }

    def usagez(self) -> dict:
        """The ``/usagez`` payload: per-tenant vectors + latency
        summaries, the ``~other`` aggregate, totals, sketch occupancy,
        the live conservation check, and per-tenant SLO burn state."""
        with self._lock:
            tenants = {}
            for t, s in sorted(self._tenants.items(),
                               key=lambda kv: (-kv[1].weight, kv[0])):
                h = self._hists.get(t)
                tenants[t] = {"vector": dict(s.vector),
                              "weight": s.weight, "err": s.err,
                              "page_seconds": round(
                                  s.vector["page_us"] / 1e6, 6),
                              "request_ms": h.summary()
                              if h is not None else None}
            other_h = self._hists.get(OTHER_TENANT)
            other = {"vector": dict(self._other),
                     "page_seconds": round(
                         self._other["page_us"] / 1e6, 6),
                     "request_ms": other_h.summary()
                     if other_h is not None else None}
            totals = dict(self._totals)
        return {
            "enabled": enabled(),
            "default_tenant": default_tenant(),
            "started": self._started,
            "tenants": tenants,
            "other": other,
            "totals": totals,
            "sketch": self.sketch_stats(),
            "conservation": self.conservation(),
            "slo": self.slo_state(),
        }

    def prometheus_text(self) -> str:
        """Labeled per-tenant exposition, appended to the replica's
        ``/metrics`` after the flat registry render: one counter family
        per cost field (``paddle_tpu_serving_tenant_<field>``), one
        ``{tenant="..."}`` sample per tracked tenant plus ``~other``,
        plus the unlabeled all-tenant total (so a label-blind scraper
        still sees a well-formed counter), and a tracked-tenant gauge.
        Strict-format: parses under ``promtext.parse_exposition(
        strict=True)`` — the router's federation scraper feeds on
        exactly this text."""
        with self._lock:
            rows = [(t, dict(s.vector))
                    for t, s in sorted(self._tenants.items())]
            rows.append((OTHER_TENANT, dict(self._other)))
            totals = dict(self._totals)
            tracked = len(self._tenants)
        lines = []
        for f in COST_FIELDS:
            pn = f"paddle_tpu_serving_tenant_{f}"
            lines.append(f"# HELP {pn} paddle_tpu counter "
                         f"serving_tenant_{f} per tenant "
                         f"(see README stat catalog)")
            lines.append(f"# TYPE {pn} counter")
            for t, vec in rows:
                label = t.replace("\\", "\\\\").replace('"', '\\"')
                lines.append(f'{pn}{{tenant="{label}"}} {vec[f]}')
            lines.append(f"{pn} {totals[f]}")
        pn = "paddle_tpu_serving_tenant_tracked"
        lines.append(f"# HELP {pn} paddle_tpu gauge "
                     f"serving_tenant_tracked "
                     f"(see README stat catalog)")
        lines.append(f"# TYPE {pn} gauge")
        lines.append(f"{pn} {tracked}")
        return "\n".join(lines) + "\n"


# -- process singleton -------------------------------------------------------
_ledger: Optional[UsageLedger] = None
_ledger_lock = threading.Lock()


def ledger() -> UsageLedger:
    """The process ledger, built on first use.  Callers on the request
    path MUST gate on :func:`enabled` first — reaching here implies
    usage attribution is on."""
    global _ledger
    if _ledger is None:
        with _ledger_lock:
            if _ledger is None:
                _ledger = UsageLedger()
    return _ledger


def peek_ledger() -> Optional[UsageLedger]:
    """The singleton if it exists — None when nothing ever booked (the
    zero-work test's witness, and the /usagez 'nothing yet' path)."""
    return _ledger


def reset_ledger():
    """Testing hook: drop the process ledger (flag changes re-build it
    with the new top_k on next use)."""
    global _ledger
    with _ledger_lock:
        _ledger = None
