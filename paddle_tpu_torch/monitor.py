"""Runtime stat monitor (reference platform/monitor.h StatRegistry /
STAT_ADD macros).

StatRegistry: named thread-safe counters any subsystem bumps;
`publish()` snapshots (optionally resetting) for logging/metrics export.

The port's copy of ``paddle_tpu/monitor.py``'s registry (importing the
JAX package's module would import jax), with the process epoch that
every uptime the serving surfaces report is measured from
(``process_start_time`` / ``process_uptime_s``) and the per-device
stat siblings (``stat_add_per_device``); the graphviz program dump is
left out.
The port's executor books the reference's stat names:
``executor_run_steps``, ``executor_jit_builds`` (builds of a
compiled-step entry), ``host_syncs`` (every device->host fence the
executor pays: a numpy fetch, a guard resolution, ``sync``; an async
50-step run books O(1), not O(steps)), ``guard_resolutions`` (batched
resolutions of the deferred non-finite guard's verdicts) and
``skipped_nonfinite_steps``.  The generation engine
(serving/generation.py) books ``serving_generate_requests``,
``serving_generate_shed``, ``requests_shed_deadline``,
``serving_prefills``, ``serving_prefill_tokens``,
``serving_decode_steps``, ``serving_decode_failures``,
``serving_generated_tokens`` and ``serving_slot_reclaims``; fault.py
books ``faults_injected`` and ``fault_<site>_<kind>``.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Tuple

__all__ = ["StatValue", "StatRegistry", "monitor", "stat_add", "stat_get",
           "stat_add_per_device", "process_start_time", "process_uptime_s"]

# one process-wide epoch for every "uptime" the system reports: the
# telemetry heartbeat, serving /healthz and /statusz agree on it
_PROCESS_START = time.time()


def process_start_time() -> float:
    """Wall-clock time this module was imported (the shared epoch for
    uptime reporting across the telemetry and serving surfaces)."""
    return _PROCESS_START


def process_uptime_s() -> float:
    return round(time.time() - _PROCESS_START, 3)


class StatValue:
    """One named int64 stat (reference platform/monitor.h StatValue)."""

    def __init__(self, name: str):
        self.name = name
        self._v = 0
        self._lock = threading.Lock()

    def increase(self, n: int = 1) -> int:
        with self._lock:
            self._v += n
            return self._v

    def decrease(self, n: int = 1) -> int:
        return self.increase(-n)

    def reset(self) -> int:
        with self._lock:
            old, self._v = self._v, 0
            return old

    def get(self) -> int:
        with self._lock:
            return self._v


class StatRegistry:
    """Thread-safe name -> StatValue registry
    (reference StatRegistry::Instance)."""

    _instance = None
    _instance_lock = threading.Lock()

    def __init__(self):
        self._stats: Dict[str, StatValue] = {}
        self._lock = threading.Lock()

    @classmethod
    def instance(cls) -> "StatRegistry":
        # double-checked under a class lock: the unlocked check-then-set
        # could hand two racing importers two registries, silently
        # splitting the counters between them
        if cls._instance is None:
            with cls._instance_lock:
                if cls._instance is None:
                    cls._instance = cls()
        return cls._instance

    def get(self, name: str) -> StatValue:
        with self._lock:
            s = self._stats.get(name)
            if s is None:
                s = self._stats[name] = StatValue(name)
            return s

    def publish(self, reset: bool = False) -> List[Tuple[str, int]]:
        """Point-in-time snapshot of every stat, optionally resetting.

        Atomic: all per-stat locks are acquired (in name order) before
        any value is read, so writers racing the publish land either
        entirely before the snapshot or entirely after it — a
        ``reset=True`` publish can no longer tear across stats or lose
        increments from cached StatValue handles that bypass the
        registry."""
        with self._lock:
            stats = sorted(self._stats.items())
            for _, s in stats:
                s._lock.acquire()
            try:
                out = [(name, s._v) for name, s in stats]
                if reset:
                    for _, s in stats:
                        s._v = 0
            finally:
                for _, s in stats:
                    s._lock.release()
        return out


monitor = StatRegistry.instance()


def stat_add(name: str, n: int = 1) -> int:
    """reference STAT_ADD(name, n) macro."""
    return monitor.get(name).increase(n)


def stat_get(name: str) -> int:
    return monitor.get(name).get()


def stat_add_per_device(name: str, n_devices: int, n: int = 1):
    """Bump ``<name>_dev<i>`` for each participating device index, beside
    the caller's own aggregate ``stat_add(name, ...)``: the per-device
    series of a stat that every device of a group books."""
    for i in range(max(int(n_devices), 0)):
        monitor.get(f"{name}_dev{i}").increase(n)
