"""Runtime lock-order sanitizer (``FLAGS_debug_lock_order=1``).

The port's copy of ``paddle_tpu/locksan.py`` (importing the JAX
package's module would import jax), installed the same way: at
``paddle_tpu_torch`` import, before any module builds its locks.

The static lock-order pass (``tools/graftcheck``, rule ``lock-order``)
proves ordering over the acquisitions it can see; this module checks
the orders that actually *happen*.  While enabled, every
``threading.Lock()`` / ``threading.RLock()`` constructed (and every
``threading.Condition()``, whose default RLock comes from the patched
factory) returns a thin wrapper that:

* records, per thread, the stack of wrapped locks currently held;
* on each acquisition that nests inside another held lock, inserts an
  edge *held-site -> acquired-site* into a global acquisition-order
  graph keyed by **creation site** (``file:line`` of the ``Lock()``
  call), so an A→B in one thread and B→A in another are detected even
  across different *instances* of A and B.  Known limitation: two
  locks from the SAME creation site (two instances of one class)
  nesting in opposite orders are NOT flagged — same-site nesting is
  skipped because instance-ordered nesting (e.g. address-ordered)
  is a legitimate pattern the site key cannot distinguish; the
  static ``lock-order`` pass flags same-lock self-nesting instead;
* asserts the graph stays acyclic: an edge that closes a cycle is a
  **lock-order violation**, recorded in :func:`violations` and (by
  default) raised as :class:`LockOrderError` at the offending
  ``acquire`` — while the thread still holds the evidence;
* at release time, asserts the released lock is actually held: a
  plain ``Lock`` released by a different thread (the legal
  handoff/token pattern) unwinds the acquiring thread's entry, while
  a release no thread can account for is reported (once per creation
  site) — the "release side" assertion.

Overhead: one thread-local list append/remove per acquire/release
plus, on *nested* acquires only, a dict insert and a DFS over the
(site-keyed, therefore tiny) order graph.  Meant for tests and
debugging legs, not the serving hot path; with the flag off nothing
is patched and the cost is zero.

Usage::

    from paddle_tpu_torch import locksan
    locksan.enable()            # or FLAGS_debug_lock_order=1 at import
    ... construct engines, run traffic ...
    assert locksan.violations() == []
    locksan.disable()

``enable()`` only wraps locks constructed *after* it; enable before
building the objects under test.  Locks created while enabled keep
working (as plain pass-throughs) after ``disable()``.
"""
from __future__ import annotations

import os
import sys
import threading
from typing import Dict, List, Optional, Set, Tuple

__all__ = ["enable", "disable", "enabled", "violations",
           "clear_violations", "LockOrderError", "install_from_flag"]

_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock

# internal bookkeeping lock: a REAL lock (never wrapped, never part of
# the analyzed graph)
_meta = _REAL_LOCK()

_active = False
_raise_on_violation = True
_edges: Dict[str, Set[str]] = {}            # site -> sites acquired inside
_edge_site: Dict[Tuple[str, str], str] = {}  # edge -> "file:line" of acquire
_violations: List[str] = []
# per-thread held stacks, keyed by thread ident and guarded by _meta —
# global (not thread-local) so a legal cross-thread Lock.release()
# (handoff/token pattern) can unwind the ACQUIRING thread's entry
# instead of leaving a stale one that corrupts later order analysis
_held: Dict[int, list] = {}


class LockOrderError(AssertionError):
    """A lock acquisition closed a cycle in the observed order graph
    (or a wrapped lock was released by a thread not holding it)."""


def _held_stack() -> list:
    """This thread's held stack.  Caller must hold ``_meta``."""
    return _held.setdefault(threading.get_ident(), [])


def _caller_site() -> str:
    """file:line of the frame constructing the lock (first frame
    outside this module and threading.py).  Keeps the last two path
    components: a bare basename would merge e.g. every package's
    ``__init__.py:N`` into one graph node and manufacture false
    cycles."""
    # the frames are walked from this one up: traceback.walk_stack(None)
    # starts a fixed number of frames above its caller on Python >= 3.11,
    # which skips the constructing frame (every lock of a test then
    # shares one site) or runs off a shallow stack ("<unknown>")
    frame = sys._getframe(1)
    while frame is not None:
        fn = frame.f_code.co_filename
        if not fn.endswith(("locksan.py", "threading.py")):
            short = "/".join(fn.replace("\\", "/").rsplit("/", 2)[-2:])
            return f"{short}:{frame.f_lineno}"
        frame = frame.f_back
    return "<unknown>"


def _reaches(src: str, dst: str) -> bool:
    seen: Set[str] = set()
    stack = [src]
    while stack:
        n = stack.pop()
        if n == dst:
            return True
        if n in seen:
            continue
        seen.add(n)
        stack.extend(_edges.get(n, ()))
    return False


# release-side misuse is reported once per creation site, not per
# occurrence (unbounded growth in a long-running replica otherwise)
_release_reported: Set[str] = set()


class _SanLock:
    """Order-recording wrapper around one real Lock/RLock.  Exposes
    the full lock protocol plus the private hooks
    ``threading.Condition`` delegates to (``_release_save`` /
    ``_acquire_restore`` / ``_is_owned``), so a Condition built on a
    wrapped lock keeps exact RLock semantics across ``wait()``."""

    __slots__ = ("_inner", "_site", "_reentrant")

    def __init__(self, inner, site: str, reentrant: bool):
        self._inner = inner
        self._site = site
        self._reentrant = reentrant

    # -- bookkeeping --------------------------------------------------------
    def _on_acquired(self) -> Optional[str]:
        """Returns a violation message when this acquisition closes a
        cycle (the caller un-acquires and raises); None when clean.

        The held-stack bookkeeping runs even while the sanitizer is
        disabled (wrapped locks outlive enable/disable cycles, and a
        lock acquired while disabled must still be release-matchable
        after a re-enable); only the order-graph analysis is gated."""
        with _meta:
            held = _held_stack()
            if not _active:
                held.append(self)
                return None
            msg = None
            if held and not (self._reentrant
                             and any(h is self for h in held)):
                top = held[-1]
                if top is not self and top._site != self._site:
                    a, b = top._site, self._site
                    new_edge = b not in _edges.get(a, ())
                    if new_edge and _reaches(b, a):
                        back = _edge_site.get(
                            (b, a), "via intermediate locks")
                        msg = (f"lock-order inversion: acquiring "
                               f"{b} while holding {a}, but the "
                               f"opposite order was observed "
                               f"({back}) — deadlock potential")
                        _violations.append(msg)
                    # the edge is recorded either way: a hot-path
                    # inversion in record mode must report ONCE, not
                    # append an identical violation per request
                    _edges.setdefault(a, set()).add(b)
                    _edge_site.setdefault((a, b), _caller_site())
            if msg is not None and _raise_on_violation:
                return msg
            held.append(self)
            return None

    def _on_released(self):
        with _meta:
            held = _held_stack()
            for i in range(len(held) - 1, -1, -1):
                if held[i] is self:
                    del held[i]
                    if not held:  # don't accrete dead-thread entries
                        _held.pop(threading.get_ident(), None)
                    return
            # not held by THIS thread: a plain Lock may legally be
            # released by another thread (handoff pattern) — unwind
            # the acquirer's entry instead of flagging correct code
            if not self._reentrant:
                for stack in _held.values():
                    for i in range(len(stack) - 1, -1, -1):
                        if stack[i] is self:
                            del stack[i]
                            return
            if _active and self._site not in _release_reported:
                _release_reported.add(self._site)
                _violations.append(
                    f"lock {self._site} released by a thread that "
                    f"does not hold it")

    # -- lock protocol ------------------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._inner.acquire(blocking, timeout)
        if got:
            msg = self._on_acquired()
            if msg is not None:
                # a violating acquire FAILS: give the real lock back
                # so the raise leaves no lock silently held
                self._inner.release()
                raise LockOrderError(msg)
        return got

    def release(self):
        self._on_released()
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._inner.locked()

    # -- Condition integration ---------------------------------------------
    def _release_save(self):
        # full release for Condition.wait(): drop every held entry of
        # self (RLock recursion depth included)
        with _meta:
            held = _held_stack()
            n_held = sum(1 for h in held if h is self)
            held[:] = [h for h in held if h is not self]
        if hasattr(self._inner, "_release_save"):
            state = self._inner._release_save()
        else:
            self._inner.release()
            state = None
        return (state, n_held)

    def _acquire_restore(self, saved):
        state, n_held = saved
        if hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(state)
        else:
            self._inner.acquire()
        with _meta:
            _held_stack().extend([self] * max(1, n_held))

    def _is_owned(self):
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        # plain Lock fallback mirroring threading.Condition's own
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def _at_fork_reinit(self):
        # the stdlib (logging handlers, threading internals) calls
        # this in the forked child to unwedge locks held by threads
        # that did not survive the fork; the child is single-threaded
        # here, so mutating bookkeeping without _meta is safe
        if hasattr(self._inner, "_at_fork_reinit"):
            self._inner._at_fork_reinit()
        else:
            self._inner = (_REAL_RLOCK() if self._reentrant
                           else _REAL_LOCK())
        for stack in _held.values():
            stack[:] = [h for h in stack if h is not self]

    def __repr__(self):
        return f"<SanLock {self._site} {self._inner!r}>"


def _reinit_after_fork():
    """Forked child: only the forking thread survives — replace the
    bookkeeping lock (it may have been held at fork time) and drop
    every dead thread's held stack."""
    global _meta
    _meta = _REAL_LOCK()
    tid = threading.get_ident()
    for dead in [t for t in _held if t != tid]:
        del _held[dead]


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_reinit_after_fork)


def _lock_factory():
    return _SanLock(_REAL_LOCK(), _caller_site(), reentrant=False)


def _rlock_factory():
    return _SanLock(_REAL_RLOCK(), _caller_site(), reentrant=True)


def enable(raise_on_violation: bool = True):
    """Patch ``threading.Lock``/``threading.RLock`` so every lock
    constructed from here on is order-sanitized.  Idempotent."""
    global _active, _raise_on_violation
    with _meta:
        _raise_on_violation = raise_on_violation
        _active = True
    threading.Lock = _lock_factory
    threading.RLock = _rlock_factory


def disable():
    """Restore the real factories and stop recording.  Wrapped locks
    already constructed keep working as pass-throughs."""
    global _active
    threading.Lock = _REAL_LOCK
    threading.RLock = _REAL_RLOCK
    with _meta:
        _active = False


def enabled() -> bool:
    return _active


def violations() -> List[str]:
    with _meta:
        return list(_violations)


def clear_violations():
    """Reset recorded violations AND the observed-order graph (a new
    test leg starts from a clean slate)."""
    with _meta:
        _violations.clear()
        _edges.clear()
        _edge_site.clear()
        _release_reported.clear()


def install_from_flag():
    """Called at ``paddle_tpu_torch`` import: enables the sanitizer when the
    ``FLAGS_debug_lock_order`` env/flag is set, so subprocess replicas
    and test legs opt in without code changes.  Never raises by
    default in flag mode — violations are recorded for the harness to
    assert on (a serving replica should degrade loudly, not crash on
    the recording thread)."""
    from .flags import flag_value

    if flag_value("FLAGS_debug_lock_order"):
        enable(raise_on_violation=False)
