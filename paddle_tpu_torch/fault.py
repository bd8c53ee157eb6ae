"""Deterministic fault injection for robustness testing.

The reference framework's production story (auto-checkpoint/resume, RPC
deadlines-with-retry, ``FLAGS_check_nan_inf``) is only trustworthy if the
recovery paths are *exercised*; this module makes faults first-class:
seeded, FLAGS-controlled, and observable through the :mod:`monitor`
registry, so CI can assert both the fault and the recovery.

Spec grammar (``FLAGS_fault_inject``)::

    spec    := entry (',' entry)*
    entry   := site ':' kind trigger
    trigger := '@' N        fire on the Nth hit of the site (1-based)
             | '@' N '+'    fire on the Nth and every later hit
             | '~' P        fire with probability P per hit, seeded by
                            FLAGS_fault_seed (deterministic across reruns)

Kinds may carry a parameter after a second colon — ``delay:250``
sleeps 250 ms at the site (a *slow* fault: nothing raises, latency
grows), and ``hang`` sleeps :data:`HANG_MS` (an effective wedge —
what the stuck-worker watchdog, router forward timeouts, and the
fleet liveness deadline exist to contain).  Instrumented sites apply
them through :func:`maybe_delay`.

Sites are names agreed between the injector and the instrumented code.
This is the port's copy of ``paddle_tpu/fault.py`` (importing the JAX
package's module would import jax); the sites wired in the port so far:

    ================  ================================  ===================
    site              instrumented in                   kinds understood
    ================  ================================  ===================
    prefill           serving/generation.py _prefill    fail | delay:ms | hang
    decode_step       serving/generation.py decode      fail | delay:ms | hang
    ================  ================================  ===================

Every fired fault bumps ``faults_injected`` plus a per-site/kind
``fault_<site>_<kind>`` counter.
"""
from __future__ import annotations

import random
import threading
import time
from typing import List, Optional

from .flags import flag_value
from .monitor import stat_add

__all__ = ["InjectedFault", "FaultInjector", "configure", "fire",
           "reset", "delay_ms_of", "maybe_delay", "HANG_MS"]

# what "hang" means in wall time: long enough that every watchdog /
# timeout under test fires first, short enough that a leaked daemon
# thread unwinds within a test session
HANG_MS = 60_000.0


class InjectedFault(OSError):
    """Raised by ``raise``-kind faults.  Subclasses OSError so retry paths
    treat it exactly like a transient I/O error."""


class _Rule:
    __slots__ = ("site", "kind", "n", "sticky", "prob")

    def __init__(self, site: str, kind: str, n: Optional[int],
                 sticky: bool, prob: Optional[float]):
        self.site, self.kind = site, kind
        self.n, self.sticky, self.prob = n, sticky, prob

    def __repr__(self):
        trig = f"~{self.prob}" if self.prob is not None else \
            f"@{self.n}{'+' if self.sticky else ''}"
        return f"{self.site}:{self.kind}{trig}"


def _parse(spec: str) -> List[_Rule]:
    rules = []
    for entry in (e.strip() for e in spec.replace(";", ",").split(",")):
        if not entry:
            continue
        try:
            site, rest = entry.split(":", 1)
            if "@" in rest:
                kind, n = rest.split("@", 1)
                sticky = n.endswith("+")
                rules.append(_Rule(site, kind, int(n.rstrip("+")),
                                   sticky, None))
            elif "~" in rest:
                kind, p = rest.split("~", 1)
                rules.append(_Rule(site, kind, None, False, float(p)))
            else:
                raise ValueError("missing '@N' or '~p' trigger")
        except ValueError as e:
            raise ValueError(
                f"bad FLAGS_fault_inject entry {entry!r}: {e}") from None
    return rules


class FaultInjector:
    """Per-process injector: counts hits per site and fires the matching
    rule deterministically (occurrence-based or seeded-probability)."""

    def __init__(self, spec: Optional[str] = None,
                 seed: Optional[int] = None):
        if spec is None:
            spec = flag_value("FLAGS_fault_inject") or ""
        if seed is None:
            seed = int(flag_value("FLAGS_fault_seed") or 0)
        self._rules = _parse(spec)
        self._rng = random.Random(seed)
        self._hits = {}
        self._lock = threading.Lock()

    def fire(self, site: str) -> Optional[str]:
        """Record one hit of `site`; return the fault kind to inject (or
        None).  At most one rule fires per hit (first match wins)."""
        with self._lock:
            self._hits[site] = hits = self._hits.get(site, 0) + 1
            for r in self._rules:
                if r.site != site:
                    continue
                if r.prob is not None:
                    hit = self._rng.random() < r.prob
                elif r.sticky:
                    hit = hits >= r.n
                else:
                    hit = hits == r.n
                if hit:
                    stat_add("faults_injected")
                    stat_add(f"fault_{site}_{r.kind}")
                    return r.kind
        return None

    def hits(self, site: str) -> int:
        with self._lock:
            return self._hits.get(site, 0)


_injector: Optional[FaultInjector] = None
_injector_lock = threading.Lock()


def _get() -> FaultInjector:
    global _injector
    if _injector is None:
        with _injector_lock:
            if _injector is None:
                _injector = FaultInjector()
    return _injector


def configure(spec: Optional[str] = None,
              seed: Optional[int] = None) -> FaultInjector:
    """(Re)build the process-wide injector — from an explicit spec, or by
    re-reading FLAGS_fault_inject/FLAGS_fault_seed (use after set_flags)."""
    global _injector
    with _injector_lock:
        _injector = FaultInjector(spec, seed)
        return _injector


def reset():
    """Drop the injector; the next fire() re-reads the FLAGS."""
    global _injector
    with _injector_lock:
        _injector = None


def fire(site: str) -> Optional[str]:
    """Module-level shorthand for the process-wide injector's fire()."""
    return _get().fire(site)


def delay_ms_of(kind: Optional[str]) -> Optional[float]:
    """The sleep a fired kind encodes: ``delay:250`` -> 250.0,
    ``hang`` -> :data:`HANG_MS`, anything else (incl. None) -> None."""
    if not kind:
        return None
    if kind == "hang":
        return HANG_MS
    if kind.startswith("delay:"):
        try:
            return float(kind.split(":", 1)[1])
        except ValueError:
            return None
    return None


def maybe_delay(kind: Optional[str]) -> bool:
    """Apply a fired slow/hang fault at the call site: sleeps the
    encoded duration for ``delay:ms`` / ``hang`` kinds and returns
    True; returns False (no sleep) for every other kind so the caller
    can go on to interpret e.g. ``fail``."""
    ms = delay_ms_of(kind)
    if ms is None:
        return False
    time.sleep(ms / 1e3)
    return True
