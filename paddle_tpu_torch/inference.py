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
recently used first out, closed, which frees a graph's memory pool).
``warmup`` builds and captures signatures ahead of traffic.  ``run`` is
thread-safe: an entry's static buffers are held under its lock from the
feed copy until the outputs are copied out, and no two threads run an
eager first run or a capture at once (``CompiledStep``).

Hot-swap, clone and export wait for later slices.
"""
from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import List, Optional

import torch

from .device import resolve_device
from .framework.core import Program, dtype_to_torch
from .framework.executor import (MAX_CACHED_STEPS, CompiledStep, Scope,
                                 _prepare_feed, fetch_to_numpy, to_tensor)

__all__ = ["Predictor"]


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
        self._block = program.global_block()
        # signature -> (CompiledStep, the lock over its static buffers),
        # least recently used first
        self._cache: OrderedDict = OrderedDict()
        self._lock = threading.RLock()  # guards _cache

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
            while len(self._cache) > MAX_CACHED_STEPS:
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
        (bytes; None before a capture).  Non-blocking: on contention it
        reports ``busy: True`` instead of waiting behind a build."""
        if not self._lock.acquire(timeout=0.05):
            return {"compiled": None, "busy": True}
        try:
            entries = [(s, e.pool_bytes) for s, (e, _) in self._cache.items()]
        finally:
            self._lock.release()
        return {"compiled": len(entries),
                "signatures": sorted(str(s) for s, _ in entries),
                "manifests": {str(s): m for s, m in
                              sorted(entries, key=lambda x: str(x[0]))}}
