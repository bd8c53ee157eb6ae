"""Serving errors and futures shared by the serving engines.

The port's copy of the request-level half of
``paddle_tpu/serving/engine.py`` (importing the JAX package's module would
import jax): the error classes, the poison-sentinel check and the
completion future that ``GenerationEngine`` (serving/generation.py)
hands back.  The dynamic-batching ``ServingEngine`` itself is not ported
yet (ROADMAP.md queue 1 item 6).
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np

__all__ = ["ServingError", "OverloadedError", "RequestFailed",
           "PoisonedInput", "ServingFuture", "poison_sentinel_matches"]


class ServingError(RuntimeError):
    """Base class for request-level serving failures."""


class OverloadedError(ServingError):
    """Explicit shed: the engine refused (or dropped) the request rather
    than queue unbounded latency.  ``reason`` is one of ``queue_full``,
    ``deadline``, ``draining``."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"serving overloaded ({reason})"
                         + (f": {detail}" if detail else ""))
        self.reason = reason


class RequestFailed(ServingError):
    """The step this request rode in raised during execution."""


class PoisonedInput(RuntimeError):
    """A request contained a feed value equal to the
    ``FLAGS_serving_poison_value`` sentinel — the deterministic stand-in
    for an input that crashes the model.  Deliberately NOT a
    ServingError: it surfaces to the engine exactly like a real
    execution crash and is contained by the same path."""


def poison_sentinel_matches(a: np.ndarray, v: float) -> bool:
    """True when array ``a`` contains the poison sentinel ``v`` exactly.
    A sentinel unrepresentable in the array's dtype (OverflowError) or
    saturating there (float16 casts 1e30 to inf) never matches, so a
    legitimate inf/extreme value cannot be misclassified as poison."""
    try:
        target = a.dtype.type(v)
    except (OverflowError, ValueError):
        return False
    if np.isfinite(v) and not np.isfinite(target):
        return False
    return bool(np.any(a == target))


class ServingFuture:
    """Completion handle returned by ``submit``."""

    __slots__ = ("_event", "_outputs", "_error")

    def __init__(self):
        self._event = threading.Event()
        self._outputs = None
        self._error: Optional[Exception] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        """Block for the outputs; raises the request's error
        (OverloadedError / RequestFailed) if it was shed or failed."""
        if not self._event.wait(timeout):
            raise TimeoutError("serving request still pending")
        if self._error is not None:
            raise self._error
        return self._outputs

    def exception(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("serving request still pending")
        return self._error

    def _resolve(self, outputs=None, error=None):
        self._outputs, self._error = outputs, error
        self._event.set()
