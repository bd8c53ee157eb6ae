"""Slot-based continuous batching for autoregressive decode, dense KV cache.

Counterpart of ``paddle_tpu/serving/generation.py`` with ``paged=False``.
One request is a *prefill* (one causal pass over the prompt) followed by
decode steps (one token each over a KV cache):

* **Fixed slot grid** — ``num_slots`` decode slots share per-layer KV
  caches ``[slots, n_kv, max_seq_len, D]`` held as persistable state in
  the engine's scope, one distinct tensor per cache on the engine's
  device.  The decode program writes each slot's fresh K/V at its own
  offset in place (``kv_cache_write``), so no step copies a cache; the
  prefill program inserts a prompt's K/V into its slot the same way
  (``kv_cache_insert``).
* **Compiled steps** — the decode step runs through one executor and
  each prefill bucket through an executor of its own, so the buckets
  never evict one another from an executor's ``MAX_CACHED_STEPS``
  entries.  On the card each program is captured once as a CUDA graph
  (its second run) and replayed after that (framework/executor.py);
  ``warmup()`` runs each program twice, which brings it there.
* **Prefill/decode split** — prompts pad up to shape buckets; decode
  steps run the whole slot grid every iteration.  Idle slots compute
  rows that no live slot reads.
* **Continuous batching** — a finished sequence (EOS / max tokens /
  max_seq_len) frees its slot at once; the scheduler claims the next
  queued request into it between decode steps while the other slots
  keep generating.  ``continuous=False`` claims only into a fully
  drained grid (FIFO head-run static batching), the baseline.
* **Admission control** — a bounded queue: ``queue_full`` at submit,
  ``deadline`` when a request outlives its budget before claiming a
  slot, ``draining`` during shutdown (``OverloadedError``).

Fault containment: a *prefill* failure (a prompt carrying the
``FLAGS_serving_poison_value`` sentinel token, an injected ``prefill``
fault, a real crash) fails exactly that request while the grid keeps
decoding; a *decode-step* failure fails the requests active in the grid
(their cache state is unknowable after a mid-step crash) but never the
scheduler.

Cached decode logits equal the uncached ``build_llama_forward(...,
attn_impl="xla")`` at ``max_seq_len`` bit for bit on the CPU, with
ragged prompts decoding concurrently (``tests/test_torch_generation.py``).

Not ported yet, each raising NotImplementedError where asked for
(ROADMAP.md queue 1 item 2): the block-paged cache, prefix reuse,
chunked prefill, speculative decoding, the prefill / decode roles and
``adopt``, mesh-sharded serving and ``swap_weights``.  The reference's
telemetry spans and timelines, flight recorder, usage ledger and cost
manifest are left out until those modules are ported (ROADMAP.md queue 1
item 6).

Stats (``monitor``): counters ``serving_generate_requests``,
``serving_generate_shed``, ``requests_shed_deadline``,
``serving_prefills``, ``serving_prefill_tokens``,
``serving_decode_steps``, ``serving_decode_failures``,
``serving_generated_tokens``, ``serving_slot_reclaims``; ``stats()``
adds the engine's own counters and latency summaries (generate,
prefill, decode step, TTFT, inter-token).
"""
from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import fault
from ..device import resolve_device
from ..flags import flag_value
from ..framework.core import Program, program_guard
from ..framework.executor import Executor, Scope
from ..models.llama import build_llama_decode, build_llama_prefill
from ..monitor import stat_add
from . import batcher
from .engine import (OverloadedError, PoisonedInput, RequestFailed,
                     ServingFuture, poison_sentinel_matches)

__all__ = ["GenerationEngine", "GenRequest"]

logger = logging.getLogger("paddle_tpu_torch.serving.generation")

_ROADMAP = "not ported yet (ROADMAP.md queue 1 item 2)"


class _Latency:
    """Latency summary over the most recent 4096 observations (count,
    mean, min, max, p50 / p95 / p99), in place of the reference's
    telemetry histograms."""

    def __init__(self):
        self._v: collections.deque = collections.deque(maxlen=4096)
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, ms: float):
        with self._lock:
            self._v.append(float(ms))
            self._count += 1

    def summary(self) -> dict:
        with self._lock:
            v = np.asarray(self._v)
            count = self._count
        if not v.size:
            return {"count": 0}
        out = {"count": count, "mean": round(float(v.mean()), 4),
               "min": round(float(v.min()), 4),
               "max": round(float(v.max()), 4)}
        for p in (50, 95, 99):
            out[f"p{p}"] = round(float(np.percentile(v, p)), 4)
        return out


class GenRequest:
    """One queued generation request."""

    __slots__ = ("prompt", "max_new_tokens", "future", "t_submit",
                 "t_claimed", "t_deadline", "prefill_ms", "on_token",
                 "t_first", "t_last")

    def __init__(self, prompt: np.ndarray, max_new_tokens: int):
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.future = ServingFuture()
        self.t_submit = time.monotonic()
        self.t_claimed: Optional[float] = None
        self.t_deadline: float = float("inf")  # set at admission
        self.prefill_ms: float = 0.0
        self.on_token = None  # callable(token_id, monotonic_ts)
        self.t_first: Optional[float] = None
        self.t_last: Optional[float] = None


class _Slot:
    """Per-slot decode state: cache offset, step count, tokens."""

    __slots__ = ("idx", "req", "position", "steps", "tokens", "logits",
                 "decoding")

    def __init__(self, idx: int):
        self.idx = idx
        self.req: Optional[GenRequest] = None
        self.position = 0     # pre-step sequence length = cache offset
        self.steps = 0        # decode steps taken for this request
        self.tokens: List[int] = []
        self.logits: List[np.ndarray] = []  # keep_logits only
        self.decoding = False  # prefill complete, in the grid

    @property
    def active(self) -> bool:
        return self.req is not None


class GenerationEngine:
    """KV-cached generation over a fixed decode-slot grid.

    ``model``: dict of llama size kwargs (``vocab_size``, ``hidden``,
    ``num_layers``, ``num_heads``, ``num_kv_heads``, ``intermediate``).
    ``scope``: optional initialised Scope whose weights use the same
    ``name`` prefix (the engine shares them); omitted, the engine runs
    the decode program's startup with random weights from ``seed``.
    ``device``: None for the card (``cuda:0``), ``"cpu"`` /
    ``CPUPlace()`` for the CPU.

    In-process API: :meth:`submit` (future) / :meth:`generate`
    (blocking), :meth:`warmup`, :meth:`drain`, :meth:`close`,
    :meth:`stats`, :meth:`introspect`.
    """

    def __init__(self, model: Dict, scope=None, *, num_slots=None,
                 max_seq_len=None, prefill_buckets=None, eos_id=-1,
                 max_new_tokens=None, queue_cap=None, deadline_ms=None,
                 continuous=True, autostart=True, name="llama",
                 attn_impl="auto", seed=0, keep_logits=False, mesh=None,
                 paged=None, prefill_chunk=None, prefix_reuse=None,
                 role=None, speculate=None, device=None):
        if paged if paged is not None else flag_value("FLAGS_serving_paged"):
            raise NotImplementedError(f"paged KV cache: {_ROADMAP}")
        if prefix_reuse:
            raise NotImplementedError(f"prefix reuse: {_ROADMAP}")
        if int(prefill_chunk if prefill_chunk is not None
               else flag_value("FLAGS_serving_prefill_chunk")) > 0:
            raise NotImplementedError(f"chunked prefill: {_ROADMAP}")
        if speculate if speculate is not None \
                else flag_value("FLAGS_serving_speculate"):
            raise NotImplementedError(f"speculative decoding: {_ROADMAP}")
        role = role if role is not None else flag_value("FLAGS_serving_role")
        if role != "both":
            raise NotImplementedError(
                f"role={role!r} (disaggregated prefill / decode): "
                f"{_ROADMAP}")
        if mesh is not None:
            raise NotImplementedError(
                "mesh-sharded generation is not ported yet (ROADMAP.md "
                "queue 1 item 9)")

        self.model = dict(model)
        self.name = name
        self.attn_impl = attn_impl
        self.continuous = bool(continuous)
        # keep_logits: fetch and keep every step's next-token logits on
        # the result (the bit-exactness tests compare them with the
        # uncached forward); one more [slots, V] fetch a step
        self.keep_logits = bool(keep_logits)
        self.eos_id = int(eos_id)
        self.num_slots = int(num_slots if num_slots is not None
                             else flag_value("FLAGS_serving_decode_slots"))
        self.max_seq_len = int(
            max_seq_len if max_seq_len is not None
            else flag_value("FLAGS_serving_max_seq_len"))
        self.max_new_tokens = int(
            max_new_tokens if max_new_tokens is not None
            else flag_value("FLAGS_serving_max_new_tokens"))
        self.queue_cap = int(queue_cap if queue_cap is not None
                             else flag_value("FLAGS_serving_queue_cap"))
        dl = (deadline_ms if deadline_ms is not None
              else flag_value("FLAGS_serving_deadline_ms"))
        self._deadline_s = float(dl) / 1e3
        if prefill_buckets is None:
            spec = str(flag_value("FLAGS_serving_prefill_buckets") or "")
            prefill_buckets = [int(b) for b in spec.split(",") if b] \
                if spec else None
        self.prefill_buckets = batcher.prompt_buckets(
            self.max_seq_len, buckets=prefill_buckets)
        self.max_prompt_len = min(self.prefill_buckets[-1],
                                  self.max_seq_len - 1)
        if self.num_slots < 1:
            raise ValueError("GenerationEngine needs at least one slot")

        heads = self.model["num_heads"]
        self._n_kv = self.model.get("num_kv_heads") or heads
        self._head_dim = self.model["hidden"] // heads
        self._seed = seed
        self.device = resolve_device(device)
        self.scope = scope if scope is not None else Scope()
        # the decode step's executor; one executor a prefill bucket
        self._decode_exe = Executor(self.device)
        self._prefill_exes: Dict[int, Executor] = {}
        self._prefill_progs: Dict[int, tuple] = {}  # bucket -> (prog, fetches)
        self._build_decode(scope_ready=scope is not None)
        self._init_caches()

        # scheduler state
        self._queue: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._slots = [_Slot(i) for i in range(self.num_slots)]
        self._draining = False
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        self._n = {"requests": 0, "shed": 0, "served": 0, "prefills": 0,
                   "decode_steps": 0, "generated_tokens": 0,
                   "prefill_tokens": 0, "slot_reclaims": 0, "failed": 0}
        self._n_lock = threading.Lock()
        self._h_gen = _Latency()
        self._h_prefill = _Latency()
        self._h_step = _Latency()
        self._h_ttft = _Latency()
        self._h_itl = _Latency()
        self._t_prefill_total = 0.0
        self._t_decode_total = 0.0
        if autostart:
            self.start()

    # -- build --------------------------------------------------------------
    def _program(self, build):
        """(main program, startup program, what `build` returned), built
        under fresh programs seeded with the engine's seed."""
        main, startup = Program(), Program()
        startup._is_startup = True
        startup.random_seed = main.random_seed = self._seed
        with program_guard(main, startup):
            out = build()
        return main, startup, out

    def _build_decode(self, scope_ready: bool):
        main, startup, (_feeds, fetches, cache_names) = self._program(
            lambda: build_llama_decode(self.num_slots, self.max_seq_len,
                                       name=self.name, **self.model))
        self._decode_prog = main
        self._decode_fetches = fetches
        self.cache_names = cache_names
        if not scope_ready:
            # engine-owned weights: the decode program reads every
            # parameter, so its startup initialises the full set
            exe = Executor(self.device)
            exe.run(startup, scope=self.scope)
            exe.close()

    def _init_caches(self):
        shape = (self.num_slots, self._n_kv, self.max_seq_len,
                 self._head_dim)
        for n in self.cache_names:
            # one distinct zero tensor per cache: each is state its
            # steps update in place
            self.scope.set_var(n, torch.zeros(shape, dtype=torch.float32,
                                              device=self.device))
        self.kv_cache_bytes = len(self.cache_names) * int(np.prod(shape)) * 4

    def _prefill_prog_for(self, bucket: int):
        entry = self._prefill_progs.get(bucket)
        if entry is None:
            main, _startup, (_feeds, fetches) = self._program(
                lambda: build_llama_prefill(
                    1, bucket, name=self.name, attn_impl=self.attn_impl,
                    cache_slots=self.num_slots,
                    max_seq_len=self.max_seq_len, **self.model))
            entry = self._prefill_progs[bucket] = (main, fetches)
            self._prefill_exes[bucket] = Executor(self.device)
        return entry

    def warmup(self) -> int:
        """Build every prefill bucket and the decode step now, off the
        request path, running each twice: the first run builds its
        kernels, the second (on the card) captures its CUDA graph.
        Returns the number of programs warmed.  The runs write slot 0's
        cache and every slot's position 0, which no request reads
        before writing them itself."""
        warmed = 0
        for b in self.prefill_buckets:
            for _ in range(2):
                self._run_prefill_program(np.zeros((1,), "int64"), b, 0)
            warmed += 1
        for _ in range(2):
            self._run_decode_program(
                np.zeros((self.num_slots, 1), "int64"),
                np.zeros((self.num_slots,), "int32"))
        return warmed + 1

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop,
                                            name="generation-scheduler",
                                            daemon=True)
            self._thread.start()

    def drain(self, timeout: Optional[float] = None):
        with self._cv:
            self._draining = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)

    def close(self, drain: bool = True, timeout: Optional[float] = None):
        """Stop admissions; with `drain` finish every queued request,
        else shed them (``draining``); then free the executors' graphs."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._draining = True
            shed = []
            if not drain:
                shed, self._queue = list(self._queue), collections.deque()
            self._cv.notify_all()
        for req in shed:
            self._shed(req, "draining")
        if self._thread is not None:
            self._thread.join(timeout)
        if self._thread is None or not self._thread.is_alive():
            for exe in [self._decode_exe, *self._prefill_exes.values()]:
                exe.close()

    # -- admission ----------------------------------------------------------
    def submit(self, prompt: Sequence[int],
               max_new_tokens: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               on_token=None) -> ServingFuture:
        """Admit one generation request.  ``prompt``: 1-D int token ids
        (1 <= len <= the largest prefill bucket, and below
        ``max_seq_len``).  Returns a future whose ``result()`` is
        ``{"tokens", "prompt_len", "steps", "finish", "queue_wait_ms",
        "prefill_ms", "ttft_ms", "total_ms", "logits"?}``.  A budget
        larger than the cache capacity left after the prompt is honoured
        until the slot's cache fills, finishing ``"cache_full"``.  Sheds
        with :class:`OverloadedError` (``queue_full`` / ``draining`` /
        ``deadline``; ``deadline_ms`` is the request's remaining budget,
        a spent one sheds here).

        ``on_token(token_id, monotonic_ts)`` runs on the scheduler
        thread as each token is booked (exceptions are contained and
        logged)."""
        ids = np.asarray(prompt)
        if ids.ndim != 1 or ids.size < 1:
            raise ValueError(f"prompt must be a non-empty 1-D token id "
                             f"sequence, got shape {ids.shape}")
        if not np.issubdtype(ids.dtype, np.integer):
            raise ValueError(f"prompt must be integer token ids, got "
                             f"dtype {ids.dtype}")
        if ids.size > self.max_prompt_len:
            raise ValueError(
                f"prompt of {ids.size} tokens exceeds max prompt length "
                f"{self.max_prompt_len} (largest prefill bucket, with "
                f"one decode slot of max_seq_len={self.max_seq_len} "
                f"reserved)")
        mnt = max(1, int(max_new_tokens if max_new_tokens is not None
                         else self.max_new_tokens))
        req = GenRequest(ids.astype("int64"), mnt)
        req.on_token = on_token
        budget_s = self._deadline_s
        if deadline_ms is not None:
            budget_s = min(budget_s, float(deadline_ms) / 1e3)
        req.t_deadline = req.t_submit + budget_s
        self._count("requests")
        stat_add("serving_generate_requests")
        with self._cv:
            if self._draining:
                raise self._shed_err("draining")
            if budget_s <= 0:
                raise self._shed_err("deadline", "budget exhausted upstream")
            if len(self._queue) >= self.queue_cap:
                raise self._shed_err(
                    "queue_full",
                    f"{len(self._queue)}/{self.queue_cap} queued")
            self._queue.append(req)
            self._cv.notify_all()
        return req.future

    def generate(self, prompt, max_new_tokens=None,
                 timeout: Optional[float] = None) -> dict:
        """Blocking one-shot: ``submit(...).result(timeout)``."""
        return self.submit(prompt, max_new_tokens).result(timeout)

    def adopt(self, segment, max_new_tokens=None):
        raise NotImplementedError(
            f"adopting a KV segment (disaggregated decode): {_ROADMAP}")

    def swap_weights(self, checkpoint, **kwargs):
        raise NotImplementedError(
            "in-place weight hot-swap is not ported yet (ROADMAP.md queue "
            "1 item 6)")

    def _shed_err(self, reason: str, detail: str = "") -> OverloadedError:
        self._count("shed")
        stat_add("serving_generate_shed")
        if reason == "deadline":
            stat_add("requests_shed_deadline")
        return OverloadedError(reason, detail)

    def _shed(self, req: GenRequest, reason: str):
        req.future._resolve(error=self._shed_err(reason))

    # -- scheduler ----------------------------------------------------------
    def _count(self, key: str, n: int = 1):
        with self._n_lock:
            self._n[key] += n

    def _active(self) -> List[_Slot]:
        return [s for s in self._slots if s.active]

    def _can_claim_locked(self) -> bool:
        """Continuous batching claims a free slot the moment one exists;
        static (FIFO head-run) batching only claims into a fully drained
        grid."""
        if self.continuous:
            return any(not s.active for s in self._slots)
        return all(not s.active for s in self._slots)

    def _claim_locked(self) -> List[tuple]:
        claimed = []
        if not self._can_claim_locked():
            return claimed
        now = time.monotonic()
        busy_before = sum(1 for s in self._slots if s.active)
        for slot in self._slots:
            if slot.active or not self._queue:
                continue
            req = None
            while self._queue:
                cand = self._queue.popleft()
                if now > cand.t_deadline:
                    self._shed(cand, "deadline")
                    continue
                req = cand
                break
            if req is None:
                break
            req.t_claimed = now
            slot.req = req
            slot.position = 0
            slot.steps = 0
            slot.tokens = []
            slot.decoding = False
            claimed.append((slot, req))
            if busy_before:
                # the continuous-batching event: a new sequence enters a
                # grid other sequences are still decoding in
                self._count("slot_reclaims")
                stat_add("serving_slot_reclaims")
        return claimed

    def _decoding_slots(self) -> List[_Slot]:
        return [s for s in self._slots if s.active and s.decoding]

    def _loop(self):
        while True:
            with self._cv:
                while True:
                    if self._queue and self._can_claim_locked():
                        break
                    if self._active():
                        break
                    if self._draining and not self._queue:
                        return
                    self._cv.wait(0.02)
                claimed = self._claim_locked()
            for slot, req in claimed:
                try:
                    self._prefill(slot, req)
                    if slot.active:
                        slot.decoding = True
                except Exception as e:  # noqa: BLE001 — a prefill failure
                    # must not kill the scheduler: exactly this request
                    # errors, the grid keeps decoding
                    self._fail_request(slot, req, "prefill", e)
            if self._decoding_slots():
                try:
                    self._decode_step()
                except Exception as e:  # noqa: BLE001 — a decode-step
                    # failure fails the ACTIVE requests (their cache state
                    # is unknowable) but never the scheduler
                    self._decode_failed(e)

    def _fail_request(self, slot: _Slot, req: GenRequest, phase: str,
                      e: Exception):
        self._count("failed")
        logger.warning("%s failed: %s", phase, e)
        req.future._resolve(error=RequestFailed(
            f"{phase} failed: {type(e).__name__}: {e}"))
        slot.req = None
        slot.decoding = False
        slot.logits = []

    def _decode_failed(self, e: Exception):
        active = self._active()
        self._count("failed", len(active))
        stat_add("serving_decode_failures")
        logger.warning("decode step failed; failing %d active "
                       "request(s): %s", len(active), e)
        err = RequestFailed(f"decode step failed: {type(e).__name__}: {e}")
        for s in active:
            req, s.req, s.logits = s.req, None, []
            s.decoding = False
            req.future._resolve(error=err)

    # -- prefill ------------------------------------------------------------
    def _run_prefill_program(self, ids: np.ndarray, bucket: int,
                             slot: int):
        """One causal pass over the padded prompt; the per-layer K/V land
        in the slot's caches in-graph, in place."""
        prog, fetches = self._prefill_prog_for(bucket)
        fetch = [fetches["next_token"]]
        if self.keep_logits:
            fetch.append(fetches["logits"])
        return self._prefill_exes[bucket].run(
            prog,
            feed={"input_ids": batcher.pad_prompt(ids, bucket)[None],
                  "last_pos": np.asarray([ids.size - 1], "int64"),
                  "slot": np.asarray([slot], "int32")},
            fetch_list=fetch, scope=self.scope, return_numpy=False)

    def _poison_check(self, prompt: np.ndarray):
        """A prompt carrying the ``FLAGS_serving_poison_value`` sentinel
        token crashes its prefill: exactly that request fails."""
        pv = flag_value("FLAGS_serving_poison_value")
        if pv and poison_sentinel_matches(prompt, float(pv)):
            raise PoisonedInput(
                f"prompt contains poisoned token (sentinel {pv})")

    def _prefill(self, slot: _Slot, req: GenRequest):
        t0 = time.monotonic()
        kind = fault.fire("prefill")
        fault.maybe_delay(kind)
        if kind == "fail":
            raise fault.InjectedFault("injected prefill failure")
        self._poison_check(req.prompt)
        bucket = batcher.prompt_bucket_for(req.prompt.size,
                                           self.prefill_buckets)
        outs = self._run_prefill_program(req.prompt, bucket, slot.idx)
        first = int(np.asarray(outs[0].numpy())[0])
        slot.logits = [np.asarray(outs[1].numpy())[0]] \
            if self.keep_logits else []
        now = time.monotonic()
        ms = (now - t0) * 1e3
        req.prefill_ms = ms
        self._t_prefill_total += ms
        self._h_prefill.observe(ms)
        self._count("prefills")
        self._count("prefill_tokens", int(req.prompt.size))
        stat_add("serving_prefills")
        stat_add("serving_prefill_tokens", int(req.prompt.size))
        slot.position = int(req.prompt.size)
        slot.tokens = [first]
        self._book_token(slot, first, now)

    # -- decode -------------------------------------------------------------
    def _run_decode_program(self, tokens: np.ndarray, positions: np.ndarray):
        fetch = [self._decode_fetches["next_token"]]
        if self.keep_logits:
            fetch.append(self._decode_fetches["logits"])
        outs = self._decode_exe.run(
            self._decode_prog, feed={"tokens": tokens,
                                     "positions": positions},
            fetch_list=fetch, scope=self.scope, return_numpy=False)
        next_tokens = np.asarray(outs[0].numpy())
        logits = np.asarray(outs[1].numpy()) if self.keep_logits else None
        return next_tokens, logits

    def _decode_step(self):
        t0 = time.monotonic()
        kind = fault.fire("decode_step")
        fault.maybe_delay(kind)
        if kind == "fail":
            raise fault.InjectedFault("injected decode_step failure")
        active = self._decoding_slots()
        tokens = np.zeros((self.num_slots, 1), "int64")
        positions = np.zeros((self.num_slots,), "int32")
        for s in active:
            tokens[s.idx, 0] = s.tokens[-1]
            positions[s.idx] = s.position
        next_tokens, logits = self._run_decode_program(tokens, positions)
        t1 = time.monotonic()
        ms = (t1 - t0) * 1e3
        self._t_decode_total += ms
        self._h_step.observe(ms)
        self._count("decode_steps")
        stat_add("serving_decode_steps")
        for s in active:
            tok = int(next_tokens[s.idx])
            s.position += 1
            s.steps += 1
            s.tokens.append(tok)
            if logits is not None:
                s.logits.append(logits[s.idx])
            # one timestamp for the whole grid step
            self._book_token(s, tok, t1)

    def _book_token(self, slot: _Slot, tok: int, now: float):
        """Account one generated token and finish the slot on EOS / token
        budget / cache exhaustion, freeing it for the next queued request
        at the next scheduler iteration."""
        self._count("generated_tokens")
        stat_add("serving_generated_tokens")
        req = slot.req
        if req.t_first is None:
            req.t_first = now
            self._h_ttft.observe((now - req.t_submit) * 1e3)
        else:
            self._h_itl.observe((now - req.t_last) * 1e3)
        req.t_last = now
        if req.on_token is not None:
            try:
                req.on_token(tok, now)
            except Exception as e:  # noqa: BLE001 — a broken consumer
                # must not take down the scheduler or the grid
                logger.warning("on_token callback failed (token dropped "
                               "from stream): %s", e)
                req.on_token = None
        finish = None
        if tok == self.eos_id:
            finish = "eos"
        elif len(slot.tokens) >= req.max_new_tokens:
            finish = "length"
        elif slot.position >= self.max_seq_len:
            # the next decode step would write at index max_seq_len, past
            # the cache, where the write would clamp onto the last row:
            # finishing here is the out-of-bounds guard
            finish = "cache_full"
        if finish is not None:
            self._finish(slot, finish)

    def _finish(self, slot: _Slot, finish: str):
        req = slot.req
        now = time.monotonic()
        total_ms = (now - req.t_submit) * 1e3
        self._count("served")
        self._h_gen.observe(total_ms)
        result = {
            "tokens": [int(t) for t in slot.tokens],
            "prompt_len": int(req.prompt.size),
            "steps": slot.steps,
            "finish": finish,
            "queue_wait_ms": round(
                ((req.t_claimed or now) - req.t_submit) * 1e3, 3),
            "prefill_ms": round(req.prefill_ms, 3),
            "ttft_ms": round((req.t_first - req.t_submit) * 1e3, 3)
            if req.t_first is not None else None,
            "total_ms": round(total_ms, 3),
        }
        if self.keep_logits:
            result["logits"] = slot.logits
            slot.logits = []
        slot.req = None
        slot.decoding = False
        req.future._resolve(outputs=result)

    # -- introspection ------------------------------------------------------
    def stats(self) -> dict:
        with self._n_lock:
            n = dict(self._n)
        with self._cv:
            depth = len(self._queue)
            active = len(self._active())
            draining = self._draining
        return {
            "queue_depth": depth,
            "queue_cap": self.queue_cap,
            "slots": self.num_slots,
            "slots_active": active,
            "slot_occupancy": round(active / self.num_slots, 4),
            "continuous": self.continuous,
            "max_seq_len": self.max_seq_len,
            "prefill_buckets": list(self.prefill_buckets),
            "kv_cache_bytes": self.kv_cache_bytes,
            "draining": draining,
            "counters": n,
            "tokens_per_request": round(
                n["generated_tokens"] / max(n["served"], 1), 2),
            "prefill_decode_ms_ratio": round(
                self._t_prefill_total / max(self._t_decode_total, 1e-9), 4),
            "generate_ms": self._h_gen.summary(),
            "prefill_ms": self._h_prefill.summary(),
            "decode_step_ms": self._h_step.summary(),
            "ttft_ms": self._h_ttft.summary(),
            "inter_token_ms": self._h_itl.summary(),
        }

    def introspect(self) -> dict:
        """Stats plus the compiled-step inventories of the decode step's
        executor and each prefill bucket's (``cache_info``: signature,
        whether captured, graph pool bytes) and the CUDA graph captures
        of each program (``captures``: "decode" and each bucket)."""
        prefill = sorted(self._prefill_exes.items())
        captures = {"decode": self._decode_exe.captures()}
        captures.update({b: exe.captures() for b, exe in prefill})
        return {
            "stats": self.stats(),
            "decode_executables": self._decode_exe.cache_info(),
            "prefill_executables": {b: exe.cache_info()
                                    for b, exe in prefill},
            "captures": captures,
        }
