"""Inference engine: ``Predictor`` over a saved or in-memory program.

Counterpart of ``paddle_tpu/inference.py``.  ``Predictor(dirname)`` loads
a ``save_inference_model`` export (from either package) into its own
scope; ``Predictor(program, feed_names, fetch_vars, scope)`` serves an
in-memory program.  The weights move to the predictor's device once, at
construction.  Each feed signature gets its own compiled step, as the
reference's ``_compiled_for`` gives each its own executable: the
executor's ``CompiledStep``, which runs its first request eagerly and, on
the card, captures the second as a CUDA graph and replays it for every
request after that.  It keeps up to ``MAX_CACHED_STEPS`` signatures (least
recently used first out, closed, which frees a graph's memory pool;
``max_cached`` raises the bound for one predictor).  ``warmup`` builds
and captures signatures ahead of traffic.  ``run`` is thread-safe: an
entry's static buffers are held under its lock from the feed copy until
the outputs are copied out, and no two threads run an eager first run or
a capture at once (``CompiledStep``).

``clone()`` shares the scope (the same weight tensors) and has a cache
of compiled steps of its own: its own graphs, pools and feed buffers.
``swap_weights`` hot-swaps the weights under the live compiled steps.
A captured graph reads its weights at fixed addresses, so the swap
copies the new values into the live storage (every ``data_ptr`` kept,
nothing recaptured) instead of rebinding the scope: it exchanges the
contents of each live tensor with the incoming one, chunk by chunk
through a small scratch buffer (:func:`exchange_weights`), so that the
incoming buffers end up holding the old weights.  They are what
``revert_weights`` exchanges back, and no third copy of the weights is
ever made.  The structure is validated before anything moves
(:class:`SwapMismatch`); a failure part way (the ``weight_swap`` fault
site fires once a weight) exchanges back what had moved.
``export_stablehlo`` / ``export_portable`` have no port (they belong
to ``jax.export``; ROADMAP.md).
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from .device import resolve_device
from .framework.core import Program, dtype_to_torch
from .framework.executor import (MAX_CACHED_STEPS, CompiledStep, Scope,
                                 _prepare_feed, analyze_block,
                                 fetch_to_numpy, to_tensor)

__all__ = ["Predictor", "SwapMismatch", "weights_structure_fingerprint",
           "weights_doc", "check_swap", "exchange_weights"]

# elements of the scratch buffer a swap exchanges contents through
EXCHANGE_CHUNK = 1 << 24


class SwapMismatch(ValueError):
    """A hot-swap checkpoint is structurally incompatible with the live
    weights (missing parameter, shape or dtype drift).  Rejected before
    anything moves: the old weights keep serving.  The HTTP ``/swap``
    endpoint maps this to 409."""


def weights_structure_fingerprint(doc: Dict[str, tuple]) -> str:
    """sha256 fingerprint of a ``name -> (shape, dtype)`` weight table:
    equal fingerprints mean a checkpoint's arrays drop into the live
    compiled steps as they are."""
    payload = {n: [list(int(d) for d in shape), str(dtype)]
               for n, (shape, dtype) in doc.items()}
    return hashlib.sha256(
        json.dumps(payload, sort_keys=True).encode()).hexdigest()[:24]


def _dtype_name(v) -> str:
    if isinstance(v, torch.Tensor):
        return str(v.dtype).split(".")[-1]
    dt = getattr(v, "dtype", None)
    return str(np.dtype(dt if dt is not None else np.asarray(v).dtype))


def weights_doc(named_values: Iterable) -> Dict[str, tuple]:
    """``name -> (shape, dtype name)`` of tensors or arrays, read from
    their metadata (nothing is copied)."""
    return {n: (tuple(int(d) for d in np.shape(v)) if not isinstance(
        v, torch.Tensor) else tuple(v.shape), _dtype_name(v))
        for n, v in named_values}


def check_swap(live_doc: Dict[str, tuple], new: Dict[str, object]):
    """Raise :class:`SwapMismatch` unless `new` holds every name of
    `live_doc` with its shape and dtype (extra names are ignored)."""
    problems = []
    for n, (shape, dtype) in live_doc.items():
        if n not in new:
            problems.append(f"{n}: missing from checkpoint")
            continue
        (got_shape, got_dtype), = weights_doc([(n, new[n])]).values()
        if got_shape != shape:
            problems.append(f"{n}: shape {got_shape} != live {shape}")
        elif got_dtype != dtype:
            problems.append(f"{n}: dtype {got_dtype} != live {dtype}")
    if problems:
        new_doc = weights_doc([(n, v) for n, v in new.items()
                               if n in live_doc])
        raise SwapMismatch(
            f"checkpoint structure {weights_structure_fingerprint(new_doc)}"
            f" != live {weights_structure_fingerprint(live_doc)}: "
            + "; ".join(problems[:4])
            + (f" (+{len(problems) - 4} more)" if len(problems) > 4
               else ""))


def _exchangeable(v) -> torch.Tensor:
    """An incoming weight as a contiguous tensor whose storage the
    exchange may write: a tensor as it is (contiguous), a numpy array
    shared when writable, else copied."""
    if isinstance(v, torch.Tensor):
        return v if v.is_contiguous() else v.contiguous()
    a = np.asarray(v)
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = np.array(a)
    return torch.from_numpy(a)


def exchange_weights(live: Dict[str, torch.Tensor],
                     new: Dict[str, object]) -> Dict[str, torch.Tensor]:
    """Exchange the contents of each live tensor with the incoming value
    of the same name, in place, chunk by chunk through one scratch
    buffer of at most ``EXCHANGE_CHUNK`` elements on the live tensors'
    device.  Returns ``{name: the incoming buffer}``, which now holds the
    old weights (an exchange with it is the revert).  The live tensors
    keep their storage (``data_ptr``).  The ``weight_swap`` fault site
    fires before each weight; on any failure the weights already
    exchanged are exchanged back before the error propagates."""
    from . import fault

    names = list(live)
    if not names:
        return {}
    device = live[names[0]].device
    if device.type == "cuda":
        torch.cuda.synchronize(device)  # no replay reads them mid-swap
    scratch = None
    done: Dict[str, torch.Tensor] = {}

    def swap(a: torch.Tensor, b: torch.Tensor):
        nonlocal scratch
        fa, fb = a.view(-1), b.view(-1)
        n = fa.numel()
        step = min(n, EXCHANGE_CHUNK)
        if scratch is None or scratch.numel() < step \
                or scratch.dtype != a.dtype:
            scratch = torch.empty(step, dtype=a.dtype, device=device)
        for i in range(0, n, step):
            m = min(step, n - i)
            tmp = scratch[:m]
            tmp.copy_(fa[i:i + m])
            fa[i:i + m].copy_(fb[i:i + m])
            fb[i:i + m].copy_(tmp)

    try:
        for n in names:
            kind = fault.fire("weight_swap")
            fault.maybe_delay(kind)
            if kind == "fail":
                raise fault.InjectedFault(
                    f"injected weight_swap failure at {n!r}")
            other = _exchangeable(new[n])
            swap(live[n], other)
            done[n] = other
    except BaseException:
        for n, other in reversed(list(done.items())):
            swap(live[n], other)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        raise
    if device.type == "cuda":
        torch.cuda.synchronize(device)  # the host buffers are complete
    return done


class Predictor:
    def __init__(self, model_dir_or_program, feed_names=None,
                 fetch_vars=None, scope: Optional[Scope] = None,
                 model_filename=None, params_filename=None, device=None):
        from . import io

        self.device = resolve_device(device)
        if isinstance(model_dir_or_program, Program):
            program = model_dir_or_program
            if feed_names is None or fetch_vars is None:
                raise ValueError("program-based Predictor needs feed_names "
                                 "and fetch_vars")
            source = scope or Scope()
            values = {n: source.find_var(n)
                      for n in source.local_var_names()}
        else:
            dirname = model_dir_or_program
            program, meta = io._load_model_payload(dirname, model_filename)
            params_path = os.path.join(dirname,
                                       params_filename or "__params__")
            values = (io._read(params_path)
                      if os.path.exists(params_path) else {})
            feed_names = meta["feeds"]
            fetch_vars = meta["fetches"]
        # serving owns a private scope whose tensors already live on the
        # device: one host->device copy per weight, here, never per run
        self.scope = Scope()
        for name, val in values.items():
            if val is not None:
                self.scope.set_var(name, to_tensor(val, self.device))
        self.program = program
        self.feed_names = list(feed_names)
        self.fetch_names = [getattr(v, "name", v) for v in fetch_vars]
        self._init_cache()

    def _init_cache(self):
        self._block = self.program.global_block()
        # signature -> (CompiledStep, the lock over its static buffers),
        # least recently used first
        self._cache: OrderedDict = OrderedDict()
        self._lock = threading.RLock()  # guards _cache
        self.max_cached = MAX_CACHED_STEPS
        self._state_in: Optional[List[str]] = None
        self._prev_weights: Dict[str, torch.Tensor] = {}

    def get_input_names(self) -> List[str]:
        return list(self.feed_names)

    def get_output_names(self) -> List[str]:
        return list(self.fetch_names)

    def _prepare(self, feed):
        if not isinstance(feed, dict):
            feed = dict(zip(self.feed_names, feed))
        missing = [n for n in self.feed_names if n not in feed]
        if missing:
            raise KeyError(f"predictor: missing feeds {missing}")
        feeds = _prepare_feed(self._block,
                              {n: feed[n] for n in self.feed_names})
        sig = tuple((tuple(t.shape), str(t.dtype)) for t in feeds.values())
        return feeds, sig

    def _compiled_for(self, sig, feed_names):
        """The signature's entry and its lock, built on first use (under
        the predictor's lock, so two racing threads build one); the least
        recently used entry beyond ``MAX_CACHED_STEPS`` is closed once no
        run holds it."""
        with self._lock:
            hit = self._cache.get(sig)
            if hit is not None:
                self._cache.move_to_end(sig)
                return hit
            entry = CompiledStep(self.program, feed_names, self.fetch_names,
                                 self.device, is_test=True, sig=sig)
            missing = [n for n in entry.state_in
                       if self.scope.find_var(n) is None]
            if missing:
                raise RuntimeError(
                    f"predictor: no value for {missing[:5]}; was the "
                    f"model saved with parameters?")
            hit = self._cache[sig] = (entry, threading.Lock())
            while len(self._cache) > self.max_cached:
                old, old_lock = self._cache.popitem(last=False)[1]
                with old_lock:
                    old.close()
            return hit

    def run(self, feed, return_numpy: bool = True):
        """feed: dict name->array, or list aligned with get_input_names."""
        feeds, sig = self._prepare(feed)
        entry, lock = self._compiled_for(sig, list(feeds))
        with lock:
            outs, _ = entry.run(feeds, self.scope)
            if return_numpy:
                return fetch_to_numpy(outs)
        return outs

    def warmup(self, feed_shapes) -> int:
        """Build each given feed signature and, on the card, capture it
        (two runs on zero feeds, results discarded), so one-time costs
        (kernel build, allocator growth, the capture) stay off the
        request path.  ``feed_shapes`` is one ``{feed_name: shape}`` dict
        or a list of them.  Returns the number of signatures not warmed
        before."""
        if isinstance(feed_shapes, dict):
            feed_shapes = [feed_shapes]
        warmed = 0
        for shapes in feed_shapes:
            feeds, sig = self._prepare({n: torch.zeros(
                tuple(shapes[n]),
                dtype=dtype_to_torch(self._block.var(n).dtype))
                for n in self.feed_names})
            entry, lock = self._compiled_for(sig, list(feeds))
            if entry.ready:
                continue
            with lock:
                while not entry.ready:
                    entry.run(feeds, self.scope)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            warmed += 1
        return warmed

    def close(self):
        """Free every signature's CUDA graph and memory pool."""
        with self._lock:
            for entry, lock in self._cache.values():
                with lock:
                    entry.close()
            self._cache.clear()

    def cache_info(self) -> dict:
        """Compiled-step inventory for live introspection: the signatures
        and, for each, the device memory its CUDA graph's capture reserved
        (``manifests``: bytes; None before a capture) and its cost
        manifest (``costs``: costmodel.step_manifest's flops, bytes and
        peak).  Non-blocking: on contention it reports ``busy: True``
        instead of waiting behind a build."""
        from .costmodel import manifest_summary, step_manifest

        if not self._lock.acquire(timeout=0.05):
            return {"compiled": None, "busy": True}
        try:
            entries = sorted(((str(s), e) for s, (e, _) in
                              self._cache.items()), key=lambda x: x[0])
        finally:
            self._lock.release()
        return {"compiled": len(entries),
                "signatures": [s for s, _ in entries],
                "manifests": {s: e.pool_bytes for s, e in entries},
                "costs": {s: manifest_summary(step_manifest(e))
                          for s, e in entries}}

    # -- clone and in-place weight hot-swap ---------------------------------
    def clone(self) -> "Predictor":
        """A predictor over the same program and the same scope (the
        weight tensors are shared, nothing is copied) with a cache of
        compiled steps of its own: its own graphs, pools and feed
        buffers."""
        p = object.__new__(type(self))
        p.device, p.scope, p.program = self.device, self.scope, self.program
        p.feed_names = list(self.feed_names)
        p.fetch_names = list(self.fetch_names)
        p._init_cache()
        p.max_cached = self.max_cached
        return p

    def _weight_names(self) -> List[str]:
        with self._lock:
            if self._state_in is None:
                self._state_in, _ = analyze_block(self._block,
                                                  self.feed_names)
            return list(self._state_in)

    def weights_doc(self) -> Dict[str, tuple]:
        """``name -> (shape, dtype)`` of the live weights: the structure
        a swap checkpoint must match."""
        pairs = []
        for n in self._weight_names():
            v = self.scope.find_var(n)
            if v is None:
                raise RuntimeError(f"predictor: no value for {n!r}; was "
                                   "the model saved with parameters?")
            pairs.append((n, v))
        return weights_doc(pairs)

    def weights_fingerprint(self) -> str:
        """Structural sha256 of the live weight table."""
        return weights_structure_fingerprint(self.weights_doc())

    def swap_weights(self, checkpoint, *, params_filename=None) -> dict:
        """Hot-swap the weights under the live compiled steps: no step is
        rebuilt or recaptured, every weight keeps its ``data_ptr``.

        ``checkpoint``: a ``save_inference_model`` directory (its
        ``__params__``) or a ``name -> array or tensor`` dict.  Every
        weight must be present with its live shape and dtype, else
        :class:`SwapMismatch` and nothing moves.  The contents are
        exchanged (:func:`exchange_weights`): a tensor or writable array
        handed in ends up holding the old weights, which
        :meth:`revert_weights` exchanges back.  Callers quiesce first
        (no run in flight): ``ServingEngine`` swaps at a drained-batch
        boundary."""
        from . import io

        if isinstance(checkpoint, str):
            path = os.path.join(checkpoint, params_filename or "__params__")
            if not os.path.exists(path):
                raise SwapMismatch(f"swap checkpoint {checkpoint!r} has no "
                                   f"{params_filename or '__params__'}")
            new = io._read(path)
        else:
            new = dict(checkpoint)
        live_doc = self.weights_doc()
        check_swap(live_doc, new)
        names = self._weight_names()
        with self._lock:
            self._prev_weights = exchange_weights(
                {n: self.scope.find_var(n) for n in names},
                {n: new[n] for n in names})
        return {"replaced": len(names),
                "fingerprint": weights_structure_fingerprint(live_doc)}

    def revert_weights(self) -> dict:
        """Exchange back the weights the last successful swap (or revert)
        replaced.  Raises :class:`SwapMismatch` when there is none."""
        if not self._prev_weights:
            raise SwapMismatch("nothing to revert: no prior successful "
                               "swap retained its replaced weights")
        return self.swap_weights(self._prev_weights)

