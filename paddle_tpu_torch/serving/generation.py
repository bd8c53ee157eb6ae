"""Slot-based continuous batching for autoregressive decode over a dense or
block-paged KV cache.

Counterpart of ``paddle_tpu/serving/generation.py``.  One request is a
*prefill* (one causal pass over the prompt) followed by decode steps (one
token each over a KV cache):

* **Fixed slot grid** — ``num_slots`` decode slots share per-layer KV
  caches ``[slots, n_kv, max_seq_len, D]`` held as persistable state in
  the engine's scope, one distinct tensor per cache on the engine's
  device.  The decode program writes each slot's fresh K/V at its own
  offset in place (``kv_cache_write``), so no step copies a cache; the
  prefill program inserts a prompt's K/V into its slot the same way
  (``kv_cache_insert``).
* **Block-paged cache** (``paged=True``) — per-layer pools ``[num_pages,
  n_kv, page_tokens, D]`` replace the per-slot reservation; each slot
  maps logical pages to physical ones through a block table the host
  feeds every step (``PagePool``: refcounts, a free list, page 0 the
  trash page that garbage rows are written to).  The programs write the
  pools in place (``kv_pool_write``) and attend over the gathered dense
  view (``kv_pool_gather``), so paged logits equal dense ones bit for
  bit.  A pool with no free page evicts an index-only prefix page, else
  a decoding slot finishes ``cache_full`` and a prefilling request goes
  back to the queue head while other slots hold pages.
* **Prefix reuse** (``prefix_reuse``, on by default with paging) — a
  prompt's fully covered pages are published under their exact token
  prefix (``PrefixIndex``); a later prompt with the same page-aligned
  prefix maps those pages (refcounted, never written again: the shared
  pages' bytes stay as they are) and prefills only its tail through the
  chunk program.
* **Chunked prefill** (``prefill_chunk`` > 0) — a prompt goes through
  the chunk program in slices of that many tokens, one slice a scheduler
  iteration, decode steps of the other slots in between.
* **Compiled steps** — the decode step runs through one executor and
  each prefill (or chunk) bucket through an executor of its own, so the
  buckets never evict one another from an executor's ``MAX_CACHED_STEPS``
  entries.  The block tables reach a captured step through its static
  feed buffers.  On the card each program is captured once as a CUDA graph
  (its second run) and replayed after that (framework/executor.py);
  ``warmup()`` runs each program twice, which brings it there.
* **Speculative decoding** (``speculate``, paged only) — a prompt-lookup
  drafter (:func:`ngram_draft`: the longest suffix n-gram of the
  sequence's own prompt and tokens matched against an earlier
  occurrence) proposes up to ``spec_tokens`` tokens a slot an
  iteration; the verify program (``build_llama_verify``, one executor a
  bucket) scores ``[pending, draft...]`` against the slot's pages in one
  chunk-shaped run, and the longest prefix agreeing with its argmax
  rows, plus the token the next row gives, is booked.  A verify row is
  the decode step's forward at that position, so the streams and every
  step's logits equal the plain engine's bit for bit.  A rejected row's
  K/V stays in the pages past the committed position, outside every
  later step's validity mask until a real write replaces it: rollback
  is page accounting only.  A slot with no draft, or a request submitted
  with ``speculate=False``, rides the plain grid step.
* **Disaggregated roles** (``role``, paged only) — a ``"prefill"``
  engine prefills and exports each prompt's pages as a
  :class:`~paddle_tpu_torch.serving.disagg.KVSegment` (an ``index_select``
  of the slot's pages on the scheduler thread's stream, after the prefill
  run that wrote them) instead of decoding; a ``"decode"`` engine takes
  segments through :meth:`GenerationEngine.adopt` and scatters them into
  its own pages with ``index_copy_`` on the pool tensors (their
  ``data_ptr`` kept for the captured graphs), on its scheduler thread's
  stream, which the next decode replay is launched on.  Adopted
  sequences decode the colocated engine's streams bit for bit
  (serving/disagg.py).
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
decoding, as does an *adopt* failure; a *decode-step* failure (a verify
included: it writes the same pools) fails the requests active in the
grid (their cache state is unknowable after a mid-step crash) but never
the scheduler.

Cached decode logits equal the uncached ``build_llama_forward(...,
attn_impl="xla")`` at ``max_seq_len`` bit for bit, with ragged prompts
decoding concurrently, on the CPU (``tests/test_torch_generation.py``)
and on the card (its products run a kernel whose rows do not depend on
M, ops/cuda/gemm.py); paged equals dense the same way
(``tests/test_torch_paged_generation.py``), speculative equals plain
(``tests/test_torch_spec_decode.py``) and disaggregated equals colocated
(``tests/test_torch_disagg.py``).

**Traces, timelines, tenants** — every request carries a trace id (the
caller's, e.g. an HTTP hop's, or a fresh one while telemetry is on), a
``generation/sequence`` span from claim to finish with its prefill,
chunk, segment export and adopt spans under it, and (``timeline``,
default on with telemetry) a per-sequence record of its phases and
every token's time, kept for ``tracez`` (recent ring and slowest
tail).  The TTFT / inter-token / generate / prefill / decode-step
latencies also feed telemetry histograms whose exemplars name trace ids.
With ``FLAGS_usage`` each request books its cost vector to its tenant
(requests, tokens in and out, prefill and decode steps, prefix hits,
sheds, failures, and the KV page-seconds its slot held, booked as the
pages are released); the flight recorder holds each request's last
words.

**Weight hot-swap** — :meth:`GenerationEngine.swap_weights` validates a
checkpoint against the live weights (every parameter; the caches and
pools are not weights) and hands it to the scheduler thread, which
applies it between grid steps: the contents of the live weight tensors
are exchanged in place with the incoming ones (the captured graphs keep
their addresses; inference.exchange_weights), the caches untouched, so
in-flight sequences keep their pages and decode their next token under
the new weights.  :meth:`revert_weights` exchanges back.

Not ported yet: mesh-sharded serving (ROADMAP.md queue 1 item 9),
raising NotImplementedError where asked for.

Stats (``monitor``): counters ``serving_generate_requests``,
``serving_generate_shed``, ``requests_shed_deadline``,
``serving_prefills``, ``serving_prefill_tokens``,
``serving_decode_steps``, ``serving_decode_failures``,
``serving_generated_tokens``, ``serving_slot_reclaims``; paged:
``serving_prefix_hits``, ``serving_prefix_tokens_saved``,
``serving_prefill_chunks``, ``serving_kv_page_evictions``,
``serving_kv_pool_stalls``; speculative: ``serving_spec_drafts``,
``serving_spec_tokens_proposed``, ``serving_spec_tokens_accepted``,
``serving_spec_rollbacks``; roles: ``serving_segments_exported``,
``serving_segments_adopted``, ``serving_segment_export_bytes``,
``serving_segment_adopt_bytes``, ``serving_adopt_rejects``.  ``stats()``
adds the engine's own counters, the pool's state (``"paged"``), the
drafts' (``"speculate"``) and latency summaries (generate, prefill,
decode step, verify, TTFT, inter-token, segment export and adopt).
"""
from __future__ import annotations

import collections
import contextlib
import logging
import os
import threading
import time
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import blackbox, fault, observatory, telemetry
from ..device import resolve_device
from ..flags import flag_value, register_flag
from ..framework.core import Program, program_guard
from ..framework.executor import Executor, Scope
from ..models.llama import (build_llama_decode, build_llama_prefill,
                            build_llama_prefill_chunk, build_llama_verify)
from ..monitor import stat_add
from . import batcher, usage
from .disagg import KVSegment, SegmentMismatch, config_fingerprint, wait_ready
from .engine import (QUIESCE_S, OverloadedError, PoisonedInput,
                     RequestFailed, ServingFuture, poison_sentinel_matches)

__all__ = ["GenerationEngine", "GenRequest", "PagePool", "PrefixIndex",
           "PoolExhausted", "ngram_draft"]

logger = logging.getLogger("paddle_tpu_torch.serving.generation")

register_flag("FLAGS_serving_kv_page_tokens", 16,
              "paged KV cache: tokens per page (power of two dividing "
              "FLAGS_serving_max_seq_len); smaller pages waste less on "
              "short sequences but deepen the per-slot block table")
register_flag("FLAGS_serving_kv_pages", 0,
              "paged KV cache: physical pages in the per-layer pool "
              "(page 0 is the reserved trash page garbage writes are "
              "redirected to); 0 = auto-size to the dense capacity "
              "(slots * max_seq_len / page_tokens + 1) — the pool "
              "footprint is pages * layers * 2 * n_kv_heads * "
              "page_tokens * head_dim * 4 bytes")
register_flag("FLAGS_serving_prefix_reuse", True,
              "paged generation: index page-aligned prompt-prefix chunks "
              "(system prompts, few-shot headers) and map index hits "
              "into new slots copy-on-write — their prefill is skipped "
              "and the pages are shared refcounted until every "
              "referencing slot finishes; 0 disables the prefix index")
register_flag("FLAGS_serving_spec_tokens", 4,
              "speculative decoding: maximum draft tokens proposed per "
              "slot per verify (the verify chunk scores draft+1 rows); "
              "larger drafts amortize more grid steps on repetitive "
              "text but waste verify compute when acceptance is low")
register_flag("FLAGS_serving_spec_ngram", 3,
              "speculative decoding: longest n-gram suffix the prompt-"
              "lookup drafter matches against the sequence history "
              "(falls back to shorter n-grams down to 1; a slot with "
              "no match this iteration takes the plain one-token grid "
              "step)")


class _Latency:
    """Latency summary over the most recent 4096 observations (count,
    mean, min, max and exact p50 / p95 / p99), beside an engine-local
    telemetry histogram of the same name that keeps the exemplars
    (the slowest observations' trace ids) and the process-wide one that
    ``/metrics`` exports."""

    def __init__(self, name: str):
        self.name = name
        self._v: collections.deque = collections.deque(maxlen=4096)
        self._count = 0
        self._lock = threading.Lock()
        self._hist = telemetry.Histogram(name)

    def observe(self, ms: float, trace_id: Optional[str] = None):
        with self._lock:
            self._v.append(float(ms))
            self._count += 1
        if telemetry.enabled():
            self._hist.observe(ms, trace_id=trace_id)
            telemetry.histogram_observe(self.name, ms, trace_id=trace_id)

    def exemplars(self) -> List[dict]:
        return self._hist.exemplars()

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
        ex = self.exemplars()
        if ex:
            out["exemplars"] = ex
        return out


class PoolExhausted(Exception):
    """The paged KV pool has no free page and nothing evictable."""


def ngram_draft(history: np.ndarray, k: int, max_ngram: int) -> List[int]:
    """Prompt-lookup drafter: up to ``k`` tokens proposed by matching the
    longest suffix n-gram of ``history`` (``max_ngram`` down to 1)
    against an earlier occurrence in ``history`` itself and reading off
    the tokens that followed it (self-speculation, no second model).
    The last earlier occurrence wins.  ``[]`` on a miss: the slot takes
    the plain one-token step, so a bad draft costs a verify, never
    correctness."""
    h = np.asarray(history).ravel()
    n = int(h.size)
    k = int(k)
    if k < 1 or n < 2:
        return []
    for g in range(min(int(max_ngram), n - 1), 0, -1):
        suffix = h[n - g:]
        # an earlier occurrence must end before the last token, so that
        # at least one token follows it
        for start in range(n - g - 1, -1, -1):
            if np.array_equal(h[start:start + g], suffix):
                follow = h[start + g:start + g + k]
                if follow.size:
                    return [int(t) for t in follow]
    return []


class PagePool:
    """Host-side allocator of the paged KV cache's physical pages.

    Page 0 is the reserved trash page (idle slots' and pad tails' rows
    are written there in-graph) and is never handed out.  Pages are
    refcounted: a slot holds one reference a mapped page, the prefix
    index one a registered page; a page goes back to the free list when
    its count reaches 0.  Not thread-safe: the engine touches it only
    from the scheduler thread."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError(f"paged KV pool needs >= 2 pages (one is "
                             f"the reserved trash page), got {num_pages}")
        self.num_pages = int(num_pages)
        self._free: collections.deque = collections.deque(
            range(1, num_pages))
        self._ref = [0] * num_pages

    def alloc(self) -> Optional[int]:
        """One free page at refcount 1, or None when none is free."""
        if not self._free:
            return None
        p = self._free.popleft()
        self._ref[p] = 1
        return p

    def incref(self, pages: Sequence[int]):
        for p in pages:
            self._ref[p] += 1

    def decref(self, pages: Sequence[int]):
        for p in pages:
            self._ref[p] -= 1
            if self._ref[p] < 0:
                raise AssertionError(f"page {p} refcount underflow")
            if self._ref[p] == 0:
                self._free.append(p)

    def refcount(self, page: int) -> int:
        return self._ref[page]

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def live_pages(self) -> int:
        return (self.num_pages - 1) - len(self._free)


class PrefixIndex:
    """Page-aligned prompt prefix -> the physical page holding its K/V.

    Keys are the exact token bytes of a prompt's first ``(i + 1) *
    page_tokens`` tokens, so a hit is an exact prefix match chained from
    position 0 (no hash collisions, no partial pages).  A lookup stops
    one token short of the whole prompt: at least one token must
    prefill to give the first next-token logits.  Each entry holds one
    pool reference; ``evict_one`` drops the least recently used entry
    whose page only the index still holds (a page mapped into a live
    slot is never evicted)."""

    def __init__(self, pool: PagePool, page_tokens: int):
        self._pool = pool
        self._pt = int(page_tokens)
        self._entries: "collections.OrderedDict[bytes, int]" = \
            collections.OrderedDict()

    def lookup(self, prompt: np.ndarray) -> List[int]:
        """The longest indexed page chain prefixing ``prompt`` (shorter
        than the prompt); hits move to the recent end."""
        max_pages = max(0, (int(prompt.size) - 1) // self._pt)
        pages = []
        for i in range(max_pages):
            key = prompt[:(i + 1) * self._pt].tobytes()
            p = self._entries.get(key)
            if p is None:
                break
            self._entries.move_to_end(key)
            pages.append(p)
        return pages

    def register(self, prompt: np.ndarray, pages: Sequence[int]):
        """Publish a prefilled prompt's fully covered pages.  A key
        another slot registered first keeps its page (this slot's copy
        stays private and frees with the slot)."""
        for i, p in enumerate(pages):
            key = prompt[:(i + 1) * self._pt].tobytes()
            if key in self._entries:
                self._entries.move_to_end(key)
                continue
            self._entries[key] = p
            self._pool.incref([p])

    def evict_one(self) -> bool:
        """Free the least recently used page only the index holds; False
        when every indexed page is mapped into a live slot."""
        for key, p in list(self._entries.items()):
            if self._pool.refcount(p) == 1:
                del self._entries[key]
                self._pool.decref([p])
                return True
        return False

    def flush(self) -> int:
        """Drop every entry (and its page reference); returns how many.
        After a decode step fails midway, no indexed page's K/V can be
        trusted."""
        n = len(self._entries)
        for p in self._entries.values():
            self._pool.decref([p])
        self._entries.clear()
        return n

    def __len__(self) -> int:
        return len(self._entries)


class GenRequest:
    """One queued generation request."""

    __slots__ = ("prompt", "max_new_tokens", "future", "t_submit",
                 "t_claimed", "t_deadline", "prefill_ms", "on_token",
                 "t_first", "t_last", "segment", "speculate", "trace_id",
                 "record_timeline", "events", "t_tokens", "bb", "tenant")

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
        self.segment: Optional[KVSegment] = None  # adopt(): decode role
        self.speculate: Optional[bool] = None  # False opts out of drafts
        self.trace_id: Optional[str] = None
        # the timeline (record_timeline off: no per-token appends)
        self.record_timeline = False
        self.events: List[tuple] = []  # (label, monotonic ts, extra)
        self.t_tokens: List[float] = []  # each generated token's time
        self.bb: Optional[int] = None  # flight-recorder last-words token
        self.tenant: Optional[str] = None  # usage ledger key (FLAGS_usage)

    def note(self, label: str, ts: float, extra=None):
        if self.record_timeline:
            self.events.append((label, ts, extra))


def _phase(req: GenRequest) -> str:
    """The phase a failure before decoding names: "adopt" or "prefill"."""
    return "adopt" if req.segment is not None else "prefill"


def _block_tensor(blk, pool: torch.Tensor) -> torch.Tensor:
    """A segment's block as a tensor on `pool`'s device and dtype (a host
    array is read in place: ``from_bytes`` gives read-only views, and
    nothing writes through this one)."""
    if not isinstance(blk, torch.Tensor):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            blk = torch.from_numpy(np.asarray(blk))
    return blk.to(pool.device, pool.dtype)


class _Slot:
    """Per-slot decode state: cache offset, step count, tokens; paged:
    the block table, the next position to prefill, the prefix hit."""

    __slots__ = ("idx", "req", "position", "steps", "tokens", "logits",
                 "decoding", "pages", "prefill_pos", "hit_tokens", "span",
                 "page_us", "page_t", "page_tenant", "weights_version")

    def __init__(self, idx: int):
        self.idx = idx
        self.req: Optional[GenRequest] = None
        self.position = 0     # pre-step sequence length = cache offset
        self.steps = 0        # decode steps taken for this request
        self.tokens: List[int] = []
        self.logits: List[np.ndarray] = []  # keep_logits only
        self.decoding = False  # prefill complete, in the grid
        self.pages: List[int] = []  # paged: block table, logical order
        self.prefill_pos = 0        # paged: next position to prefill
        self.hit_tokens = 0         # paged: tokens the prefix index gave
        self.span = None  # the generation/sequence span (telemetry on)
        # KV page-seconds (us x pages held) booked to page_tenant when
        # the pages are released; page_t the last integration instant
        self.page_us = 0
        self.page_t = 0.0
        self.page_tenant: Optional[str] = None
        # the weights the sequence's prompt began under: its pages go to
        # the prefix index only if no swap came in between
        self.weights_version = 0

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
    ``CPUPlace()`` for the CPU.  ``paged``, ``page_tokens``,
    ``num_pages``, ``prefill_chunk`` and ``prefix_reuse`` (None: their
    ``FLAGS_serving_*``) configure the block-paged cache; the last three
    are read only with ``paged``.  ``speculate`` / ``spec_tokens`` /
    ``spec_ngram`` and ``role`` ("both", "prefill", "decode") need the
    paged cache.

    In-process API: :meth:`submit` (future) / :meth:`generate`
    (blocking), :meth:`adopt` (decode role), :meth:`warmup`,
    :meth:`drain`, :meth:`close`, :meth:`stats`, :meth:`introspect`,
    :meth:`fingerprint`.
    """

    def __init__(self, model: Dict, scope=None, *, num_slots=None,
                 max_seq_len=None, prefill_buckets=None, eos_id=-1,
                 max_new_tokens=None, queue_cap=None, deadline_ms=None,
                 continuous=True, autostart=True, name="llama",
                 attn_impl="auto", seed=0, keep_logits=False, mesh=None,
                 paged=None, page_tokens=None, num_pages=None,
                 prefill_chunk=None, prefix_reuse=None, role=None,
                 speculate=None, spec_tokens=None, spec_ngram=None,
                 device=None):
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
        self._configure_pages(paged, page_tokens, num_pages, prefill_chunk,
                              prefix_reuse)
        self._configure_roles(role, speculate, spec_tokens, spec_ngram)
        self.device = resolve_device(device)
        self.scope = scope if scope is not None else Scope()
        # one executor for the decode step and one for each prefill or
        # chunk bucket: key -> (program, fetches, executor)
        self._decode_exe = Executor(self.device)
        self._progs: Dict[tuple, tuple] = {}
        self._prefill_rr = 0  # chunked-prefill round-robin cursor
        self._build_decode(scope_ready=scope is not None)
        self._init_caches()

        # scheduler state
        self._queue: collections.deque = collections.deque()
        self._cv = threading.Condition()
        # profiler starts and stops in flight (``quiesced``) and whether
        # the scheduler is parked at a step boundary for them
        self._holds = 0
        self._parked = False
        self._slots = [_Slot(i) for i in range(self.num_slots)]
        self._draining = False
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        self._n = {"requests": 0, "shed": 0, "served": 0, "prefills": 0,
                   "decode_steps": 0, "generated_tokens": 0,
                   "prefill_tokens": 0, "slot_reclaims": 0, "failed": 0,
                   "prefix_hits": 0, "prefix_tokens_saved": 0,
                   "prefill_chunks": 0, "page_evictions": 0,
                   "pool_stalls": 0, "segments_exported": 0,
                   "segments_adopted": 0, "adopt_rejects": 0,
                   "spec_drafts": 0, "spec_tokens_proposed": 0,
                   "spec_tokens_accepted": 0, "spec_rollbacks": 0}
        self._n_lock = threading.Lock()
        self._h_gen = _Latency("serving_generate_ms")
        self._h_prefill = _Latency("serving_prefill_ms")
        self._h_step = _Latency("serving_decode_step_ms")
        self._h_verify = _Latency("serving_spec_verify_ms")
        self._h_ttft = _Latency("serving_ttft_ms")
        self._h_itl = _Latency("serving_inter_token_ms")
        self._h_export = _Latency("serving_segment_export_ms")
        self._h_adopt = _Latency("serving_segment_adopt_ms")
        self._t_prefill_total = 0.0
        self._t_decode_total = 0.0
        # weight hot-swap: a validated swap waits here for the scheduler
        # thread's next grid-step boundary (arrays, Event, result box)
        self._pending_swap = None
        self._prev_weights: Dict[str, torch.Tensor] = {}
        self.weights_version = 1
        # finished-sequence timelines for tracez: recent ring + slowest
        self._timeline_lock = threading.Lock()
        self._timelines_recent: collections.deque = collections.deque(
            maxlen=max(1, int(flag_value("FLAGS_tracez_recent") or 32)))
        self._timelines_slow: List[dict] = []
        self._tail_keep = max(0, int(
            flag_value("FLAGS_trace_tail_keep") or 0))
        if autostart:
            self.start()

    def _configure_pages(self, paged, page_tokens, num_pages, prefill_chunk,
                         prefix_reuse):
        """The paged cache's configuration (None: the flag's value):
        ``page_tokens`` a power of two dividing ``max_seq_len`` (the
        gathered view must be exactly max_seq_len wide, the dense
        contraction length), ``num_pages`` 0 / None for slots x
        pages_per_slot + 1 (the trash page)."""
        self.paged = bool(flag_value("FLAGS_serving_paged")
                          if paged is None else paged)
        self.page_tokens = self.num_pages = self.pages_per_slot = 0
        self.prefill_chunk = 0
        self.prefix_reuse = False
        self._pool: Optional[PagePool] = None
        self._prefix: Optional[PrefixIndex] = None
        if not self.paged:
            return
        pt = int(page_tokens if page_tokens is not None
                 else flag_value("FLAGS_serving_kv_page_tokens"))
        if pt < 1 or (pt & (pt - 1)):
            raise ValueError(f"FLAGS_serving_kv_page_tokens must be a "
                             f"power of two, got {pt}")
        if self.max_seq_len % pt:
            raise ValueError(f"max_seq_len {self.max_seq_len} is not a "
                             f"multiple of page_tokens {pt}")
        self.page_tokens = pt
        self.pages_per_slot = self.max_seq_len // pt
        auto = self.num_slots * self.pages_per_slot + 1
        self.num_pages = int(num_pages if num_pages is not None
                             else (flag_value("FLAGS_serving_kv_pages")
                                   or auto))
        self.prefill_chunk = int(
            prefill_chunk if prefill_chunk is not None
            else flag_value("FLAGS_serving_prefill_chunk"))
        self.prefix_reuse = bool(
            prefix_reuse if prefix_reuse is not None
            else flag_value("FLAGS_serving_prefix_reuse"))
        self._pool = PagePool(self.num_pages)
        if self.prefix_reuse:
            self._prefix = PrefixIndex(self._pool, pt)

    def _configure_roles(self, role, speculate, spec_tokens, spec_ngram):
        """The disaggregated role ("both": prefill and decode here;
        "prefill": export each prompt's pages as a KVSegment instead of
        decoding; "decode": take segments through adopt(), never
        prefill) and speculative decoding; both need the paged cache
        (None: the flag's value)."""
        self.role = str(role if role is not None
                        else flag_value("FLAGS_serving_role") or "both")
        if self.role not in ("both", "prefill", "decode"):
            raise ValueError(f"role must be both|prefill|decode, got "
                             f"{self.role!r}")
        if self.role != "both" and not self.paged:
            raise ValueError(
                f"role={self.role!r} requires the paged KV cache "
                f"(paged=True / FLAGS_serving_paged=1): the KV-segment "
                f"handoff is page-block-based")
        self.speculate = bool(flag_value("FLAGS_serving_speculate")
                              if speculate is None else speculate)
        self.spec_tokens = int(spec_tokens if spec_tokens is not None
                               else flag_value("FLAGS_serving_spec_tokens"))
        self.spec_ngram = int(spec_ngram if spec_ngram is not None
                              else flag_value("FLAGS_serving_spec_ngram"))
        if self.speculate:
            if not self.paged:
                raise ValueError(
                    "speculate=True requires the paged KV cache "
                    "(paged=True / FLAGS_serving_paged=1): the verify "
                    "chunk scores drafts against the slot's pages and "
                    "rejected tokens roll back through the page pool")
            if self.spec_tokens < 1:
                raise ValueError(f"spec_tokens must be >= 1, got "
                                 f"{self.spec_tokens}")
            if self.spec_ngram < 1:
                raise ValueError(f"spec_ngram must be >= 1, got "
                                 f"{self.spec_ngram}")
        self._fingerprint: Optional[str] = None

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
            lambda: build_llama_decode(
                self.num_slots, self.max_seq_len, name=self.name,
                paged=self.paged, num_pages=self.num_pages or None,
                page_tokens=self.page_tokens or None, **self.model))
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
        if self.paged:
            shape = (self.num_pages, self._n_kv, self.page_tokens,
                     self._head_dim)
        else:
            shape = (self.num_slots, self._n_kv, self.max_seq_len,
                     self._head_dim)
        for n in self.cache_names:
            # one distinct zero tensor per cache or pool: each is state
            # its steps update in place
            self.scope.set_var(n, torch.zeros(shape, dtype=torch.float32,
                                              device=self.device))
        # the bytes allocated: the pools when paged, else the caches
        self.kv_cache_bytes = len(self.cache_names) * int(np.prod(shape)) * 4
        # one page across every layer's K and V pools
        self.page_bytes = (len(self.cache_names) * self._n_kv
                           * self.page_tokens * self._head_dim * 4)

    @property
    def kv_live_bytes(self) -> int:
        """Bytes of the pages live sequences or the prefix index hold now
        (the dense cache: all of it, always)."""
        if self._pool is None:
            return self.kv_cache_bytes
        return self._pool.live_pages * self.page_bytes

    def _prog_for(self, kind: str, bucket: int):
        """(program, fetches, executor) of a prefill bucket (``kind``
        "prefill": dense or paged with the engine), a chunk bucket
        ("chunk") or a verify bucket ("verify"), each with an executor of
        its own."""
        entry = self._progs.get((kind, bucket))
        if entry is not None:
            return entry
        common = dict(name=self.name, **self.model)
        if kind in ("chunk", "verify"):
            build_fn = build_llama_prefill_chunk if kind == "chunk" \
                else build_llama_verify

            def build():
                return build_fn(bucket, self.max_seq_len, self.num_pages,
                                self.page_tokens, **common)[:2]
        else:
            def build():
                return build_llama_prefill(
                    1, bucket, attn_impl=self.attn_impl,
                    cache_slots=self.num_slots,
                    max_seq_len=self.max_seq_len, paged=self.paged,
                    num_pages=self.num_pages or None,
                    page_tokens=self.page_tokens or None, **common)
        main, _startup, (_feeds, fetches) = self._program(build)
        entry = self._progs[(kind, bucket)] = (main, fetches,
                                               Executor(self.device))
        return entry

    def _chunk_buckets(self) -> List[int]:
        """The buckets the chunk program can be asked for: with chunking
        on, every slice (prefix-hit tails too) is at most the chunk, so
        only the buckets up to its own; with it off, a prefix-hit tail
        can be any prefill bucket."""
        if self.prefill_chunk > 0:
            cap = batcher.prompt_bucket_for(
                min(self.prefill_chunk, self.max_prompt_len),
                self.prefill_buckets)
            return [b for b in self.prefill_buckets if b <= cap]
        return list(self.prefill_buckets)

    def _verify_buckets(self) -> List[int]:
        """The buckets the verify program can be asked for: its chunk
        ``[pending, draft...]`` has at most ``spec_tokens + 1`` rows, so
        the buckets up to that length's own (one with the default 4)."""
        cap = batcher.prompt_bucket_for(
            min(self.spec_tokens + 1, self.max_prompt_len),
            self.prefill_buckets)
        return [b for b in self.prefill_buckets if b <= cap]

    def warmup(self) -> int:
        """Build every program the engine can run now, off the request
        path, running each twice: the first run builds its kernels, the
        second (on the card) captures its CUDA graph.  Returns the number
        of programs warmed.  Dense: the runs write slot 0's cache and
        every slot's position 0, which no request reads before writing
        it itself; paged: all-zero block tables and lengths send every
        write to the trash page.  A decode-role engine runs no prefill
        program and a prefill-role engine no decode or verify program."""
        runs = []
        if self.role != "decode":
            if not self.paged or self.prefill_chunk <= 0:
                runs += [("prefill", b) for b in self.prefill_buckets]
            if self.paged and (self.prefill_chunk > 0 or self.prefix_reuse):
                runs += [("chunk", b) for b in self._chunk_buckets()]
        if self.role != "prefill" and self.speculate:
            runs += [("verify", b) for b in self._verify_buckets()]
        zeros = np.zeros((1,), "int64")
        no_pages = np.zeros((self.pages_per_slot,), "int32")
        for kind, b in runs:
            for _ in range(2):
                if kind == "chunk":
                    self._run_chunk_program(zeros, b, 0, 0, no_pages)
                elif kind == "verify":
                    self._run_verify_program(zeros, b, 0, 0, no_pages)
                elif self.paged:
                    self._run_paged_prefill_program(zeros, b, 0, no_pages)
                else:
                    self._run_prefill_program(zeros, b, 0)
        if self.role == "prefill":
            return len(runs)
        for _ in range(2):
            self._run_decode_program(
                np.zeros((self.num_slots, 1), "int64"),
                np.zeros((self.num_slots,), "int32"))
        return len(runs) + 1

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop,
                                            name="generation-scheduler",
                                            daemon=True)
            self._thread.start()
            observatory.add_quiescer(self.quiesced)

    @contextlib.contextmanager
    def quiesced(self, timeout_s: float = QUIESCE_S):
        """Hold the scheduler between grid steps while the block runs
        (requests keep queueing; sequences in flight keep their pages and
        decode on after it): the block starts once the scheduler is
        parked, or after `timeout_s`.  A profiler capture starts and
        stops inside it (``observatory.quiesced``)."""
        with self._cv:
            self._holds += 1
            self._cv.notify_all()
            deadline = time.monotonic() + timeout_s
            while (self._thread is not None and self._thread.is_alive()
                   and not self._parked and time.monotonic() < deadline):
                self._cv.wait(0.01)
        try:
            yield
        finally:
            with self._cv:
                self._holds -= 1
                self._cv.notify_all()

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
        observatory.remove_quiescer(self.quiesced)
        for req in shed:
            self._shed(req, "draining")
        if self._thread is not None:
            self._thread.join(timeout)
        if self._thread is None or not self._thread.is_alive():
            self._decode_exe.close()
            for _prog, _fetches, exe in self._progs.values():
                exe.close()

    # -- admission ----------------------------------------------------------
    def submit(self, prompt: Sequence[int],
               max_new_tokens: Optional[int] = None,
               trace_id: Optional[str] = None,
               deadline_ms: Optional[float] = None,
               on_token=None,
               timeline: Optional[bool] = None,
               speculate: Optional[bool] = None,
               tenant: Optional[str] = None) -> ServingFuture:
        """Admit one generation request.  ``prompt``: 1-D int token ids
        (1 <= len <= the largest prefill bucket, and below
        ``max_seq_len``).  Returns a future whose ``result()`` is
        ``{"tokens", "prompt_len", "steps", "finish", "trace_id",
        "queue_wait_ms", "prefill_ms", "ttft_ms", "total_ms",
        "timeline"?, "logits"?, "prefix_hit_tokens"?}`` (the last where a
        prefix hit served part of the prompt).  A budget
        larger than the cache capacity left after the prompt is honoured
        until the slot's cache fills, finishing ``"cache_full"``.  Sheds
        with :class:`OverloadedError` (``queue_full`` / ``draining`` /
        ``deadline``; ``deadline_ms`` is the request's remaining budget,
        a spent one sheds here).

        ``trace_id`` adopts a caller's trace identity (an HTTP hop's
        header); with telemetry on a fresh one is minted otherwise.
        ``timeline`` forces the per-sequence timeline record on or off
        (None: on with telemetry).  ``tenant`` books the request's cost
        vector with ``FLAGS_usage`` (None: the default tenant).
        ``on_token(token_id, monotonic_ts)`` runs on the scheduler
        thread as each token is booked (exceptions are contained and
        logged).  ``speculate=False`` keeps this request out of the
        drafts of a speculating engine (it rides the plain grid step:
        the same stream either way); True or None follow the engine.
        A prefill-role engine resolves the request with
        ``finish="exported"`` and its ``segment``; a decode-role engine
        takes no prompts (:meth:`adopt`)."""
        if self.role == "decode":
            raise ValueError("decode-role engine accepts KV segments "
                             "via adopt(), not prompts (role=decode)")
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
        req.speculate = speculate
        return self._admit(req, deadline_ms, on_token, trace_id, timeline,
                           tenant)

    def _admit(self, req: GenRequest, deadline_ms, on_token, trace_id,
               timeline, tenant) -> ServingFuture:
        """Queue `req` (a prompt or a segment to adopt), or shed it."""
        req.on_token = on_token
        budget_s = self._deadline_s
        if deadline_ms is not None:
            budget_s = min(budget_s, float(deadline_ms) / 1e3)
        req.t_deadline = req.t_submit + budget_s
        if telemetry.enabled():
            req.trace_id = trace_id or telemetry.new_trace_id()
        else:
            req.trace_id = trace_id
        req.record_timeline = bool(telemetry.enabled() if timeline is None
                                   else timeline)
        req.note("admit", req.t_submit)
        kind = "adopt" if req.segment is not None else "generate"
        fields = {"prompt_len": int(req.prompt.size)}
        if usage.enabled():
            req.tenant = usage.normalize_tenant(tenant)
            fields["tenant"] = req.tenant
        req.bb = blackbox.request_begin(req.trace_id, kind, **fields)
        self._count("requests")
        stat_add("serving_generate_requests")
        if req.tenant is not None:
            # booked where the global counter is: per-tenant sums stay
            # equal to it at tolerance 0 (an adopted prompt's tokens were
            # booked by the prefill side)
            usage.ledger().book(req.tenant, requests=1, tokens_in=0
                                if req.segment is not None
                                else int(req.prompt.size))
        with self._cv:
            if self._draining:
                raise self._shed_err("draining", req=req)
            if budget_s <= 0:
                raise self._shed_err("deadline", "budget exhausted upstream",
                                     req=req)
            if len(self._queue) >= self.queue_cap:
                raise self._shed_err(
                    "queue_full",
                    f"{len(self._queue)}/{self.queue_cap} queued", req=req)
            self._queue.append(req)
            self._cv.notify_all()
        return req.future

    def generate(self, prompt, max_new_tokens=None,
                 timeout: Optional[float] = None) -> dict:
        """Blocking one-shot: ``submit(...).result(timeout)``."""
        return self.submit(prompt, max_new_tokens).result(timeout)

    def retry_after_s(self) -> float:
        """Backoff hint for 503 sheds (the ``Retry-After`` header): the
        queued requests over the slot grid at the measured per-request
        p50 generation time, bounded to [0.5, 30] s."""
        with self._cv:
            depth = len(self._queue)
        per_req_s = (self._h_gen.summary().get("p50") or 250.0) / 1e3
        est = (depth / max(1, self.num_slots) + 1) * per_req_s
        return min(30.0, max(0.5, est))

    # -- disaggregated handoff (KV segments) --------------------------------
    def fingerprint(self) -> str:
        """The segment-compatibility fingerprint (model sizes, page
        geometry, name prefix, weight seed): equal fingerprints mean a
        segment exported here adopts bit for bit there."""
        if self._fingerprint is None:
            self._fingerprint = config_fingerprint(
                self.model, self.page_tokens, self.max_seq_len, self.name,
                self._seed)
        return self._fingerprint

    def _reject(self, msg: str) -> SegmentMismatch:
        self._count("adopt_rejects")
        stat_add("serving_adopt_rejects")
        return SegmentMismatch(msg)

    def _check_segment(self, seg: KVSegment):
        """adopt()'s structure and fingerprint check: a segment that
        fails it could only decode garbage (other weights, other page
        geometry, a truncated payload)."""
        if seg.fingerprint != self.fingerprint():
            raise self._reject(
                f"segment fingerprint {seg.fingerprint} != engine "
                f"{self.fingerprint()} (model/page-geometry/seed drift)")
        n_layers = len(self.cache_names) // 2
        needed = -(-seg.position // self.page_tokens)
        if (seg.page_tokens != self.page_tokens
                or seg.n_layers != n_layers
                or seg.n_pages != needed
                or not seg.tokens
                or seg.position < 1
                or seg.position > self.max_seq_len
                # prompt_len sizes a host allocation and the result: a
                # crafted header must not exhaust the host's memory
                or seg.prompt_len < 1
                or seg.prompt_len > seg.position):
            raise self._reject(
                f"segment structure invalid: page_tokens="
                f"{seg.page_tokens}/{self.page_tokens}, layers="
                f"{seg.n_layers}/{n_layers}, pages={seg.n_pages} "
                f"(need {needed} for position {seg.position}), "
                f"tokens={len(seg.tokens)}")

    def adopt(self, segment: KVSegment,
              max_new_tokens: Optional[int] = None,
              trace_id: Optional[str] = None,
              deadline_ms: Optional[float] = None,
              on_token=None,
              timeline: Optional[bool] = None,
              tenant: Optional[str] = None) -> ServingFuture:
        """Adopt an exported :class:`~paddle_tpu_torch.serving.disagg.
        KVSegment` into this engine's pool and decode it to the end: the
        decode half of the disaggregated pipeline.

        Admission as :meth:`submit` (the same sheds); the pages are taken
        at claim time (evicting idle prefix pages, or back to the queue
        head while other slots hold pages, as a local prefill).  A
        fingerprint or structure mismatch raises :class:`~paddle_tpu_torch.
        serving.disagg.SegmentMismatch` here and is never queued.  The
        result's ``tokens`` are the whole stream: the segment's tokens
        (replayed through ``on_token``), then every token decoded
        here."""
        if self.role == "prefill":
            raise ValueError("prefill-role engine cannot adopt "
                             "segments (it has no decode grid)")
        if not self.paged:
            raise ValueError("adopt() requires the paged KV cache")
        self._check_segment(segment)
        mnt = max(1, int(max_new_tokens if max_new_tokens is not None
                         else self.max_new_tokens))
        # the zero prompt only carries the length into the result: the
        # segment's pages hold the K/V
        req = GenRequest(np.zeros((segment.prompt_len,), "int64"), mnt)
        req.segment = segment
        return self._admit(req, deadline_ms, on_token,
                           trace_id or segment.trace_id, timeline, tenant)

    # -- in-place weight hot-swap -------------------------------------------
    def _weight_names(self) -> List[str]:
        """Every parameter the programs read: the decode program's
        persistable vars other than the caches (which hold live sequence
        state and ride through a swap untouched)."""
        caches = set(self.cache_names)
        return sorted(v.name for v in self._decode_prog.list_vars()
                      if v.persistable and v.name not in caches)

    def swap_weights(self, checkpoint, *,
                     timeout_s: Optional[float] = None) -> dict:
        """Hot-swap the weights in place at a decode-grid-step boundary.

        ``checkpoint``: a directory with ``__params__`` or a ``{name:
        array or tensor}`` dict.  Validated here, on the caller's thread,
        against the live weights (a missing name, a shape or a dtype
        drift raises :class:`~paddle_tpu_torch.inference.SwapMismatch`
        before anything moves); then the scheduler thread exchanges the
        contents between grid steps (``inference.exchange_weights``: the
        incoming buffers end up holding the old weights, the live tensors
        keep their ``data_ptr``, the captured graphs replay on), so
        in-flight sequences keep their pages and token streams and decode
        their next token under the new weights.  The prefix index is
        flushed, and a prompt begun before the swap publishes no pages, so
        no later request reads K/V of the replaced weights.  A failed
        exchange rolls back.  Bounded by ``FLAGS_swap_timeout_s``."""
        from ..inference import SwapMismatch, check_swap, weights_doc

        if timeout_s is None:
            timeout_s = float(flag_value("FLAGS_swap_timeout_s") or 30.0)
        if isinstance(checkpoint, dict):
            new = dict(checkpoint)
        else:
            path = os.path.join(str(checkpoint), "__params__")
            if not os.path.exists(path):
                raise SwapMismatch(f"swap checkpoint {str(checkpoint)!r} "
                                   f"has no __params__")
            from .. import io
            new = io._read(path)
        names = self._weight_names()
        check_swap(weights_doc((n, self.scope.find_var(n)) for n in names),
                   new)
        arrays = {n: new[n] for n in names}
        if self._thread is None:
            # no scheduler running: every instant is a step boundary
            return self._commit_swap(arrays)
        ev = threading.Event()
        box: Dict[str, object] = {}
        with self._cv:
            if self._draining or self._closed:
                raise SwapMismatch("no weight swap during drain")
            if self._pending_swap is not None:
                raise SwapMismatch("another weight swap is mid-flight")
            self._pending_swap = (arrays, ev, box)
            self._cv.notify_all()
        if not ev.wait(timeout_s):
            with self._cv:
                if self._pending_swap is not None \
                        and self._pending_swap[1] is ev:
                    self._pending_swap = None  # withdrawn: never applied
                    raise SwapMismatch(
                        f"swap not committed within {timeout_s}s "
                        f"(the scheduler never reached a step boundary)")
            ev.wait()  # it started in the meantime: wait for its end
        if "error" in box:
            raise box["error"]
        return box["result"]

    def _apply_pending_swap(self):
        """Scheduler-thread half: commit the handed-off swap at the
        grid-step boundary and wake the caller."""
        with self._cv:
            pending = self._pending_swap
        if pending is None:
            return
        arrays, ev, box = pending
        try:
            box["result"] = self._commit_swap(arrays)
        except BaseException as e:  # noqa: BLE001 — hand the caller the
            # failure; the scheduler itself keeps decoding
            box["error"] = e
        finally:
            with self._cv:
                self._pending_swap = None
            ev.set()

    def _commit_swap(self, arrays: Dict[str, object]) -> dict:
        """Exchange every weight's contents with `arrays` (validated
        upstream); atomic: a failure exchanges back what had moved."""
        from ..inference import exchange_weights

        t0 = time.monotonic()
        try:
            retained = exchange_weights(
                {n: self.scope.find_var(n) for n in arrays}, arrays)
        except BaseException:
            stat_add("serving_weight_swap_failures")
            raise
        self._prev_weights = retained
        self.weights_version += 1
        stat_add("serving_weight_swaps")
        if self._prefix is not None:
            # indexed pages hold K/V of the weights just replaced: a later
            # prompt must not read them under the new ones
            self._prefix.flush()
        ms = round((time.monotonic() - t0) * 1e3, 3)
        telemetry.log_event("generation_weight_swap",
                            version=self.weights_version, swap_ms=ms,
                            replaced=len(arrays))
        return {"weights_version": self.weights_version, "swap_ms": ms,
                "replaced": len(arrays)}

    def revert_weights(self) -> dict:
        """Exchange back the weights the last successful swap replaced
        (held in the buffers it was handed)."""
        from ..inference import SwapMismatch

        if not self._prev_weights:
            raise SwapMismatch("no previous weights retained (nothing "
                               "swapped yet)")
        return self.swap_weights(self._prev_weights)

    def _shed_err(self, reason: str, detail: str = "",
                  req: Optional[GenRequest] = None) -> OverloadedError:
        self._count("shed")
        stat_add("serving_generate_shed")
        if reason == "deadline":
            stat_add("requests_shed_deadline")
        err = OverloadedError(reason, detail)
        if req is not None:
            if req.tenant is not None:
                usage.ledger().book(req.tenant, sheds=1)
            blackbox.request_end(req.bb)
            req.bb = None
            err.trace_id = req.trace_id
        return err

    def _shed(self, req: GenRequest, reason: str):
        req.future._resolve(error=self._shed_err(reason, req=req))

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
            req.note("claim", now, {"slot": slot.idx})
            slot.req = req
            slot.position = 0
            slot.steps = 0
            slot.tokens = []
            slot.decoding = False
            slot.pages = []
            slot.prefill_pos = 0
            slot.hit_tokens = 0
            slot.page_us, slot.page_t = 0, now
            slot.page_tenant = req.tenant
            if telemetry.enabled() and req.trace_id is not None:
                # the sequence's span: claim to finish, its prefill and
                # handoff spans under it
                slot.span = telemetry.span_begin(
                    "generation/sequence", detached=True,
                    trace_id=req.trace_id, slot=slot.idx,
                    prompt_len=int(req.prompt.size))
            blackbox.request_phase(req.bb, "claimed", slot=slot.idx)
            claimed.append((slot, req))
            if busy_before:
                # the continuous-batching event: a new sequence enters a
                # grid other sequences are still decoding in
                self._count("slot_reclaims")
                stat_add("serving_slot_reclaims")
        return claimed

    def _decoding_slots(self) -> List[_Slot]:
        return [s for s in self._slots if s.active and s.decoding]

    def _prefilling_slots(self) -> List[_Slot]:
        return [s for s in self._slots if s.active and not s.decoding]

    def _loop(self):
        try:
            self._schedule()
        except BaseException as e:
            # the scheduler thread itself is dying (each request's own
            # failure is contained below): leave the flight recorder's
            # dump behind
            blackbox.dump_exception("generation_scheduler", e)
            raise

    def _schedule(self):
        while True:
            # a pending weight swap commits here, between grid steps
            self._apply_pending_swap()
            with self._cv:
                # a profiler start or stop holds the grid here
                while self._holds and self._pending_swap is None:
                    self._parked = True
                    self._cv.notify_all()
                    self._cv.wait(0.01)
                self._parked = False
                while True:
                    if self._pending_swap is not None or self._holds:
                        break
                    if self._queue and self._can_claim_locked():
                        break
                    if self._active():
                        break
                    if self._draining and not self._queue:
                        return
                    self._cv.wait(0.02)
                if self._pending_swap is not None or self._holds:
                    continue
                claimed = self._claim_locked()
            for slot, req in claimed:
                try:
                    self._begin(slot, req)
                except PoolExhausted as e:
                    # an adopted segment takes its pages at claim time:
                    # the same transient a prefill meets
                    self._requeue_or_fail(slot, e)
                except Exception as e:  # noqa: BLE001 — a prefill or
                    # adopt failure must not kill the scheduler: exactly
                    # this request errors, the grid keeps decoding
                    self._fail_request(slot, req, _phase(req), e)
            # paged: advance ONE pending prefill slice an iteration
            # (round-robin over the prefilling slots), so a long prompt
            # pays out between decode steps instead of stalling the grid
            pending = self._prefilling_slots()
            if pending:
                slot = pending[self._prefill_rr % len(pending)]
                self._prefill_rr += 1
                try:
                    self._prefill_advance(slot)
                except PoolExhausted as e:
                    # transient while other sequences hold pages: back to
                    # the queue head (its deadline still bounds the wait)
                    self._requeue_or_fail(slot, e)
                except Exception as e:  # noqa: BLE001 — this request only
                    self._fail_request(slot, slot.req, "prefill", e)
            # the speculative round first: a slot whose draft was
            # verified this iteration has advanced (often by several
            # tokens) and skips the grid step; the others ride it
            served = frozenset()
            if self.speculate and self._decoding_slots():
                try:
                    served = self._speculate_round()
                except Exception as e:  # noqa: BLE001 — a verify writes
                    # the pools the grid step writes: contained the same
                    self._decode_failed(e)
            if self._decoding_slots():
                try:
                    self._decode_step(skip=served)
                except Exception as e:  # noqa: BLE001 — a decode-step
                    # failure fails the ACTIVE requests (their cache state
                    # is unknowable) but never the scheduler
                    self._decode_failed(e)

    def _begin(self, slot: _Slot, req: GenRequest):
        """After the claim.  An adopted segment: its pages, here and now.
        Dense: the whole prefill, here and now.  Paged: the fault and
        poison checks and the prefix lookup only; the prompt pays out
        through ``_prefill_advance``, one slice a scheduler iteration."""
        slot.weights_version = self.weights_version
        if req.segment is not None:
            self._adopt_begin(slot, req)
            return
        if not self.paged:
            self._prefill(slot, req)
            return
        kind = fault.fire("prefill")
        fault.maybe_delay(kind)
        if kind == "fail":
            raise fault.InjectedFault("injected prefill failure")
        # poison fails the request before any page is mapped, so it never
        # touches the pages other slots share
        self._poison_check(req.prompt)
        if self._prefix is not None:
            hit = self._prefix.lookup(req.prompt)
            if hit:
                self._pool.incref(hit)
                self._mark_pages(slot)
                slot.pages = list(hit)
                slot.hit_tokens = len(hit) * self.page_tokens
                self._count("prefix_hits")
                stat_add("serving_prefix_hits")
                req.note("prefix_hit", time.monotonic(),
                         {"tokens": slot.hit_tokens})
                if req.tenant is not None:
                    usage.ledger().book(req.tenant, prefix_hits=1)
                self._count("prefix_tokens_saved", slot.hit_tokens)
                stat_add("serving_prefix_tokens_saved", slot.hit_tokens)
        slot.prefill_pos = slot.hit_tokens

    def _requeue_or_fail(self, slot: _Slot, e: Exception):
        """The pool ran out mid-prefill.  With other sequences live that
        is transient: release this slot's pages and put the request back
        at the queue head.  With the grid otherwise empty the pool cannot
        hold the prompt at all: fail it."""
        req = slot.req
        if not [s for s in self._slots if s.active and s is not slot]:
            self._fail_request(slot, req, _phase(req), e)
            return
        self._count("pool_stalls")
        stat_add("serving_kv_pool_stalls")
        self._end_span(slot, "requeued")
        req.note("requeue", time.monotonic())
        self._release_pages(slot)
        slot.req = None
        slot.decoding = False
        slot.logits = []
        with self._cv:
            self._queue.appendleft(req)
            self._cv.notify_all()

    def _end_span(self, slot: _Slot, outcome: str):
        """Close the slot's generation/sequence span (none with telemetry
        off)."""
        if slot.span is not None:
            slot.span.attrs["outcome"] = outcome
            slot.span.attrs["steps"] = slot.steps
            telemetry.span_end(slot.span)
            slot.span = None

    def _fail_request(self, slot: _Slot, req: GenRequest, phase: str,
                      e: Exception):
        self._count("failed")
        if req.tenant is not None:
            usage.ledger().book(req.tenant, failures=1)
        logger.warning("%s failed: %s", phase, e)
        self._end_span(slot, f"failed:{phase}")
        self._release_pages(slot)
        blackbox.request_end(req.bb)
        req.future._resolve(error=RequestFailed(
            f"{phase} failed: {type(e).__name__}: {e}"))
        slot.req = None
        slot.decoding = False
        slot.logits = []

    def _decode_failed(self, e: Exception):
        # every active slot fails, mid-prefill ones too: the step wrote
        # the pools a chunked prefill also writes
        active = self._active()
        self._count("failed", len(active))
        stat_add("serving_decode_failures")
        logger.warning("decode step failed; failing %d active "
                       "request(s): %s", len(active), e)
        err = RequestFailed(f"decode step failed: {type(e).__name__}: {e}")
        for s in active:
            req = s.req
            if req.tenant is not None:
                usage.ledger().book(req.tenant, failures=1)
            self._end_span(s, "failed:decode")
            s.req, s.logits = None, []
            s.decoding = False
            self._release_pages(s)
            blackbox.request_end(req.bb)
            req.future._resolve(error=err)
        if self._prefix is not None:
            # no indexed page's K/V can be trusted after a failed step
            dropped = self._prefix.flush()
            if dropped:
                logger.warning("flushed %d prefix-index entries after a "
                               "decode-step failure", dropped)

    # -- prefill ------------------------------------------------------------
    def _run_prefill_program(self, ids: np.ndarray, bucket: int,
                             slot: int):
        """Dense: one causal pass over the padded prompt; the per-layer
        K/V land in the slot's caches in-graph, in place."""
        prog, fetches, exe = self._prog_for("prefill", bucket)
        return exe.run(
            prog,
            feed={"input_ids": batcher.pad_prompt(ids, bucket)[None],
                  "last_pos": np.asarray([ids.size - 1], "int64"),
                  "slot": np.asarray([slot], "int32")},
            fetch_list=self._fetch(fetches), scope=self.scope,
            return_numpy=False)

    def _run_paged_prefill_program(self, ids: np.ndarray, bucket: int,
                                   prompt_len: int, block_table: np.ndarray):
        """Paged: the dense prefill's forward, its K/V written to the
        slot's pages from position 0 (rows at or past `prompt_len` to the
        trash page)."""
        prog, fetches, exe = self._prog_for("prefill", bucket)
        return exe.run(
            prog,
            feed={"input_ids": batcher.pad_prompt(ids, bucket)[None],
                  "last_pos": np.asarray([ids.size - 1], "int64"),
                  "block_table": block_table[None],
                  "prompt_len": np.asarray([prompt_len], "int32")},
            fetch_list=self._fetch(fetches), scope=self.scope,
            return_numpy=False)

    def _run_chunk_program(self, ids: np.ndarray, bucket: int, base: int,
                           n: int, block_table: np.ndarray):
        """`n` prompt tokens from logical position `base` (padded to
        `bucket`) attend the slot's pages and themselves causally; their
        K/V go to the pages."""
        prog, fetches, exe = self._prog_for("chunk", bucket)
        return exe.run(
            prog,
            feed={"chunk_ids": batcher.pad_prompt(ids, bucket)[None],
                  "base": np.asarray([base], "int32"),
                  "block_table": block_table[None],
                  "chunk_len": np.asarray([n], "int32"),
                  "last_off": np.asarray([max(n - 1, 0)], "int64")},
            fetch_list=self._fetch(fetches), scope=self.scope,
            return_numpy=False)

    def _run_verify_program(self, ids: np.ndarray, bucket: int, base: int,
                            n: int, block_table: np.ndarray):
        """`n` chunk rows (the pending token, then the draft) from logical
        position `base`, padded to `bucket`, through the verify program:
        every row's argmax (and logits with keep_logits)."""
        prog, fetches, exe = self._prog_for("verify", bucket)
        return exe.run(
            prog,
            feed={"chunk_ids": batcher.pad_prompt(ids, bucket)[None],
                  "base": np.asarray([base], "int32"),
                  "block_table": block_table[None],
                  "chunk_len": np.asarray([n], "int32")},
            fetch_list=[fetches["tokens"]] + (
                [fetches["logits"]] if self.keep_logits else []),
            scope=self.scope, return_numpy=False)

    def _fetch(self, fetches) -> list:
        return [fetches["next_token"]] + (
            [fetches["logits"]] if self.keep_logits else [])

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
        with self._span(slot, "generation/prefill", bucket=bucket):
            outs = self._run_prefill_program(req.prompt, bucket, slot.idx)
        self._complete_prefill(slot, req, outs, t0)

    def _span(self, slot: _Slot, name: str, **attrs):
        """A span under the slot's sequence span (a plain span when it has
        none; nothing with telemetry off)."""
        parent = slot.span.context() if slot.span is not None else None
        return telemetry.trace_span(name, parent=parent, **attrs)

    # -- paged prefill ------------------------------------------------------
    def _mark_pages(self, slot: _Slot):
        """Advance the slot's KV page-second integral (us x pages held) to
        now: called before every change of its block table, so the
        integral prices what the pool held.  Nothing when the slot
        books no tenant (usage off)."""
        if slot.page_tenant is None:
            return
        t = time.monotonic()
        if slot.pages and slot.page_t:
            slot.page_us += int((t - slot.page_t) * 1e6) * len(slot.pages)
        slot.page_t = t

    def _release_pages(self, slot: _Slot):
        """Drop the slot's references on its pages (shared prefix pages
        fall back to the index's; private ones free) and book the
        sequence's KV page-seconds to its tenant: every path that lets
        go of a slot's pages (finish, failure, requeue, export, a failed
        step) comes through here."""
        if self._pool is not None and slot.pages:
            self._mark_pages(slot)
            self._pool.decref(slot.pages)
        if slot.page_tenant is not None:
            if slot.page_us:
                usage.ledger().book(slot.page_tenant, page_us=slot.page_us)
            slot.page_tenant = None
        slot.page_us = 0
        slot.page_t = 0.0
        slot.pages = []
        slot.hit_tokens = 0
        slot.prefill_pos = 0

    def _ensure_pages(self, slot: _Slot, n_tokens: int):
        """Grow the slot's block table to cover `n_tokens` logical
        tokens, evicting index-only prefix pages when no page is free.
        Raises PoolExhausted when nothing is left to evict."""
        needed = -(-int(n_tokens) // self.page_tokens)
        if len(slot.pages) < needed:
            self._mark_pages(slot)
        while len(slot.pages) < needed:
            p = self._pool.alloc()
            if p is None:
                if self._prefix is not None and self._prefix.evict_one():
                    self._count("page_evictions")
                    stat_add("serving_kv_page_evictions")
                    continue
                raise PoolExhausted(
                    f"kv page pool exhausted ({self._pool.live_pages}/"
                    f"{self.num_pages - 1} pages live, nothing evictable)")
            slot.pages.append(p)

    def _slot_block_table(self, slot: _Slot) -> np.ndarray:
        bt = np.zeros((self.pages_per_slot,), "int32")
        bt[:len(slot.pages)] = slot.pages
        return bt

    def _acquire_draft_pages(self, slot: _Slot, n_tokens: int) -> int:
        """Grow the slot's block table to hold a draft's verify rows.
        Returns the page count to keep on rollback (the table's length
        before the draft).  On exhaustion the partial growth is rolled
        back here and PoolExhausted raised again: the table is as it
        was."""
        keep = len(slot.pages)
        try:
            self._ensure_pages(slot, n_tokens)
        except PoolExhausted:
            self._rollback_draft_pages(slot, keep)
            raise
        return keep

    def _rollback_draft_pages(self, slot: _Slot, keep_pages: int) -> int:
        """Drop the slot's references on pages past ``keep_pages``: the
        accounting half of a rejected draft.  Its rows' K/V needs no undo
        on the device: they lie past the committed position, outside
        every later step's validity mask (``j <= base + t``), and the
        next real write there replaces them."""
        dropped = slot.pages[keep_pages:]
        if dropped:
            self._mark_pages(slot)
            self._pool.decref(dropped)
            del slot.pages[keep_pages:]
        return len(dropped)

    def _prefill_advance(self, slot: _Slot):
        """One prefill slice of one paged slot: the whole prompt through
        the paged prefill program (chunking off, no prefix hit: the path
        bit-equal to dense), or the next ``prefill_chunk`` tokens (or the
        whole prefix-hit tail) through the chunk program.  The last slice
        gives the first token and puts the slot into the decode grid."""
        req = slot.req
        prompt = req.prompt
        t0 = time.monotonic()
        n_prompt = int(prompt.size)
        if slot.prefill_pos == 0 and self.prefill_chunk <= 0:
            bucket = batcher.prompt_bucket_for(n_prompt,
                                               self.prefill_buckets)
            self._ensure_pages(slot, n_prompt)
            with self._span(slot, "generation/prefill", bucket=bucket):
                outs = self._run_paged_prefill_program(
                    prompt, bucket, n_prompt, self._slot_block_table(slot))
            self._complete_prefill(slot, req, outs, t0)
            return
        # the first span still to prefill; later spans run on later
        # iterations, decode steps between them
        start, end = batcher.chunk_spans(slot.prefill_pos, n_prompt,
                                         self.prefill_chunk)[0]
        n = end - start
        bucket = batcher.prompt_bucket_for(n, self.prefill_buckets)
        self._ensure_pages(slot, end)
        with self._span(slot, "generation/prefill_chunk", bucket=bucket,
                        start=start, tokens=n):
            outs = self._run_chunk_program(prompt[start:end], bucket, start,
                                           n, self._slot_block_table(slot))
        self._count("prefill_chunks")
        stat_add("serving_prefill_chunks")
        req.note("prefill_chunk", time.monotonic(),
                 {"start": start, "tokens": n})
        slot.prefill_pos = end
        if end >= n_prompt:
            self._complete_prefill(slot, req, outs, t0)
        else:  # the launch only: the last chunk's read waits for the rest
            req.prefill_ms += (time.monotonic() - t0) * 1e3

    def _complete_prefill(self, slot: _Slot, req: GenRequest, outs,
                          t0: float):
        """Every prefill path's tail: read the first token (which waits
        for the program; `t0` is when its run began), book it, publish the
        prompt's fully covered pages to the prefix index (paged), and
        enter the decode grid."""
        first = int(np.asarray(outs[0].numpy())[0])
        slot.logits = [np.asarray(outs[1].numpy())[0]] \
            if self.keep_logits else []
        now = time.monotonic()
        req.prefill_ms += (now - t0) * 1e3
        n_prompt = int(req.prompt.size)
        self._t_prefill_total += req.prefill_ms
        self._h_prefill.observe(req.prefill_ms, trace_id=req.trace_id)
        req.note("prefill", now, {"ms": round(req.prefill_ms, 3)})
        if req.tenant is not None:
            usage.ledger().book(req.tenant, prefill_steps=1)
        self._count("prefills")
        # tokens a prefix hit served never ran a prefill
        self._count("prefill_tokens", n_prompt - slot.hit_tokens)
        stat_add("serving_prefills")
        stat_add("serving_prefill_tokens", n_prompt - slot.hit_tokens)
        if self._prefix is not None \
                and slot.weights_version == self.weights_version:
            full = n_prompt // self.page_tokens
            if full:
                self._prefix.register(req.prompt, slot.pages[:full])
        slot.prefill_pos = n_prompt
        slot.position = n_prompt
        slot.tokens = [first]
        if self.role == "prefill":
            # disaggregated: the pages leave as a segment and the slot
            # frees for the next prompt instead of decoding
            self._export_segment(slot, req)
            return
        slot.decoding = True
        blackbox.request_phase(req.bb, "decoding")
        self._book_token(slot, first, time.monotonic())

    # -- segments -----------------------------------------------------------
    def _pool_pair(self, layer: int):
        return (self.scope.find_var(f"{self.name}.pool_k_{layer}"),
                self.scope.find_var(f"{self.name}.pool_v_{layer}"))

    def _export_segment(self, slot: _Slot, req: GenRequest):
        """Gather the slot's populated pages into a detached KVSegment
        (``index_select``: new tensors, on this thread's stream, after
        the prefill run that wrote the pages) and resolve the request
        with it (``finish="exported"``).  The gather copies, so the
        slot's pages release at once; shared prefix pages fall back to
        the index's reference."""
        t0 = time.monotonic()
        n_prompt = slot.position
        needed = -(-n_prompt // self.page_tokens)
        idx = torch.tensor(slot.pages[:needed], dtype=torch.long,
                           device=self.device)
        with self._span(slot, "generation/segment_export", pages=needed):
            layers = [tuple(pool.index_select(0, idx)
                            for pool in self._pool_pair(i))
                      for i in range(len(self.cache_names) // 2)]
        ready = None
        if self.device.type == "cuda":
            # readers on other threads wait on this before the blocks
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        seg = KVSegment(self.fingerprint(), n_prompt, n_prompt,
                        list(slot.tokens), self.page_tokens, layers,
                        logits=np.stack(slot.logits)
                        if self.keep_logits and slot.logits else None,
                        trace_id=req.trace_id, ready=ready)
        now = time.monotonic()
        # the prefill's first token was generated here; the adopter
        # replays it
        self._count("generated_tokens")
        stat_add("serving_generated_tokens")
        self._count("segments_exported")
        stat_add("serving_segments_exported")
        stat_add("serving_segment_export_bytes", seg.nbytes)
        self._h_export.observe((now - t0) * 1e3, trace_id=req.trace_id)
        total_ms = (now - req.t_submit) * 1e3
        self._count("served")
        self._h_gen.observe(total_ms, trace_id=req.trace_id)
        req.note("export", now, {"bytes": seg.nbytes})
        if req.tenant is not None:
            led = usage.ledger()
            led.book(req.tenant, tokens_out=1, served=1)
            led.observe_latency(req.tenant, total_ms)
        result = {
            "tokens": [int(t) for t in slot.tokens],
            "prompt_len": n_prompt,
            "steps": 0,
            "finish": "exported",
            "trace_id": req.trace_id,
            "queue_wait_ms": round(
                ((req.t_claimed or now) - req.t_submit) * 1e3, 3),
            "prefill_ms": round(req.prefill_ms, 3),
            "ttft_ms": None,
            "total_ms": round(total_ms, 3),
            "segment": seg,
            "segment_bytes": seg.nbytes,
        }
        if slot.hit_tokens:
            result["prefix_hit_tokens"] = slot.hit_tokens
        if req.record_timeline:
            result["timeline"] = self._timeline_record(req, result)
            self._store_timeline(result)
        self._end_span(slot, "exported")
        slot.req = None
        slot.decoding = False
        slot.logits = []
        self._release_pages(slot)
        blackbox.request_end(req.bb)
        req.future._resolve(outputs=result)

    def _adopt_begin(self, slot: _Slot, req: GenRequest):
        """Put an adopted segment into this pool: take the pages (as a
        local prefill would: evicting, or PoolExhausted for the
        scheduler's requeue), scatter the segment's blocks into them in
        place, replay its tokens, and enter the decode grid at its
        position.

        The scatter is ``index_copy_`` on each pool tensor, so no pool
        changes its ``data_ptr`` (the captured graphs hold them).  It
        runs on this thread's current stream, after the segment's
        ``ready`` event; the next decode replay is launched on the same
        stream, so it reads the pages after the scatter wrote them."""
        seg = req.segment
        t0 = time.monotonic()
        kind = fault.fire("adopt")
        fault.maybe_delay(kind)
        if kind == "fail":
            raise fault.InjectedFault("injected adopt failure")
        self._ensure_pages(slot, seg.position)  # may raise PoolExhausted
        idx = torch.tensor(slot.pages[:seg.n_pages], dtype=torch.long,
                           device=self.device)
        wait_ready(seg)
        with self._span(slot, "generation/segment_adopt",
                        pages=seg.n_pages):
            for i, blocks in enumerate(seg.layers):
                for pool, blk in zip(self._pool_pair(i), blocks):
                    pool.index_copy_(0, idx, _block_tensor(blk, pool))
        slot.position = seg.position
        slot.prefill_pos = seg.position
        slot.tokens = list(seg.tokens)
        slot.steps = 0
        slot.logits = list(np.array(seg.logits, dtype=np.float32)) \
            if self.keep_logits and seg.logits is not None else []
        slot.decoding = True
        now = time.monotonic()
        self._count("segments_adopted")
        stat_add("serving_segments_adopted")
        stat_add("serving_segment_adopt_bytes", seg.nbytes)
        self._h_adopt.observe((now - t0) * 1e3, trace_id=req.trace_id)
        req.note("adopt", now, {"tokens": len(seg.tokens),
                                "position": seg.position,
                                "bytes": seg.nbytes})
        blackbox.request_phase(req.bb, "decoding")
        # replay the tokens generated elsewhere: a stream consumer sees
        # one sequence, and TTFT is adopt admission to the first token
        for tok in seg.tokens:
            if req.record_timeline:
                req.t_tokens.append(now)
            if req.t_first is None:
                req.t_first = now
                self._h_ttft.observe((now - req.t_submit) * 1e3,
                                     trace_id=req.trace_id)
            if req.on_token is not None:
                try:
                    req.on_token(tok, now)
                except Exception as e:  # noqa: BLE001 — as _book_token
                    logger.warning("on_token callback failed (token "
                                   "dropped from stream): %s", e)
                    req.on_token = None
        req.t_last = now
        # a segment may arrive finished (EOS at prefill, or a budget the
        # replay meets): eos before length before cache_full
        if slot.tokens[-1] == self.eos_id:
            self._finish(slot, "eos")
        elif len(slot.tokens) >= req.max_new_tokens:
            self._finish(slot, "length")
        elif slot.position >= self.max_seq_len:
            self._finish(slot, "cache_full")

    # -- decode -------------------------------------------------------------
    def _run_decode_program(self, tokens: np.ndarray, positions: np.ndarray,
                            block_tables: Optional[np.ndarray] = None,
                            live: Optional[np.ndarray] = None):
        feed = {"tokens": tokens, "positions": positions}
        if self.paged:
            feed["block_tables"] = block_tables if block_tables is not None \
                else np.zeros((self.num_slots, self.pages_per_slot), "int32")
            feed["live"] = live if live is not None \
                else np.zeros((self.num_slots,), "int32")
        outs = self._decode_exe.run(
            self._decode_prog, feed=feed,
            fetch_list=self._fetch(self._decode_fetches), scope=self.scope,
            return_numpy=False)
        next_tokens = np.asarray(outs[0].numpy())
        logits = np.asarray(outs[1].numpy()) if self.keep_logits else None
        return next_tokens, logits

    def _speculate_round(self) -> frozenset:
        """One draft and verify for each decoding slot that can take one;
        returns the indices of the slots that advanced (by one token at
        least), which this iteration's grid step skips.  A slot opted out
        (``speculate=False``), with no n-gram match, without room for a
        draft in its budget or cache, or whose draft the pool cannot
        hold, rides the grid step unchanged.

        A slot's verify chunk ``[pending, draft...]`` runs at ``base =
        position`` (row 0 writes the pending token's K/V where the plain
        step would); ``a`` = the longest prefix with ``draft[i] ==
        argmax(row i)``, and rows 0..a book ``a + 1`` tokens in order
        through ``_book_token``.  Draft pages past the new position
        roll back."""
        served = set()
        for slot in list(self._decoding_slots()):
            req = slot.req
            if req.speculate is False:
                continue
            cap = min(self.spec_tokens,
                      req.max_new_tokens - len(slot.tokens) - 1,
                      self.max_seq_len - slot.position - 1)
            if cap < 1:
                continue
            history = np.concatenate(
                [req.prompt, np.asarray(slot.tokens, "int64")])
            draft = ngram_draft(history, cap, self.spec_ngram)
            if not draft:
                continue
            t0 = time.monotonic()
            # the verify writes the pools a grid step writes: it shares
            # the decode_step fault site
            kind = fault.fire("decode_step")
            fault.maybe_delay(kind)
            if kind == "fail":
                raise fault.InjectedFault(
                    "injected decode_step failure (spec verify)")
            c = len(draft) + 1
            try:
                keep = self._acquire_draft_pages(slot, slot.position + c)
            except PoolExhausted:
                # transient: the slot rides the plain step, whose own
                # cache_full path governs a pool that stays full
                continue
            self._count("spec_drafts")
            stat_add("serving_spec_drafts")
            self._count("spec_tokens_proposed", len(draft))
            stat_add("serving_spec_tokens_proposed", len(draft))
            bucket = batcher.prompt_bucket_for(c, self.prefill_buckets)
            chunk = np.asarray([slot.tokens[-1]] + draft, "int64")
            outs = self._run_verify_program(chunk, bucket, slot.position, c,
                                            self._slot_block_table(slot))
            m = np.asarray(outs[0].numpy())[0]
            rows = np.asarray(outs[1].numpy())[0] if self.keep_logits \
                else None
            a = 0
            while a < len(draft) and int(draft[a]) == int(m[a]):
                a += 1
            t1 = time.monotonic()
            ms = (t1 - t0) * 1e3
            self._t_decode_total += ms
            self._h_verify.observe(ms)
            self._count("spec_tokens_accepted", a)
            stat_add("serving_spec_tokens_accepted", a)
            if a < len(draft):
                self._count("spec_rollbacks")
                stat_add("serving_spec_rollbacks")
            # row j's argmax is what a plain step emits after the chunk's
            # first j + 1 tokens: the plain stream, several steps at once,
            # booked with one timestamp
            for j in range(a + 1):
                tok = int(m[j])
                slot.position += 1
                slot.steps += 1
                slot.tokens.append(tok)
                if rows is not None:
                    slot.logits.append(rows[j])
                self._book_token(slot, tok, t1)
                if slot.req is None:
                    break  # finished mid-burst; _finish freed the pages
            if slot.req is not None:
                self._rollback_draft_pages(
                    slot, max(keep, -(-slot.position // self.page_tokens)))
            served.add(slot.idx)
        return frozenset(served)

    def _decode_step(self, skip: frozenset = frozenset()):
        """One grid step for the decoding slots not in `skip` (the slots
        the speculative round advanced this iteration)."""
        t0 = time.monotonic()
        kind = fault.fire("decode_step")
        fault.maybe_delay(kind)
        if kind == "fail":
            raise fault.InjectedFault("injected decode_step failure")
        if self.paged:
            # a slot about to write into an unmapped page gets one before
            # the step; one the pool cannot serve, even after evicting,
            # finishes cache_full with what it generated so far
            for s in self._decoding_slots():
                if s.idx in skip:
                    continue
                try:
                    self._ensure_pages(s, s.position + 1)
                except PoolExhausted:
                    self._finish(s, "cache_full")
        active = [s for s in self._decoding_slots() if s.idx not in skip]
        if not active:
            return
        tokens = np.zeros((self.num_slots, 1), "int64")
        positions = np.zeros((self.num_slots,), "int32")
        bt = live = None
        if self.paged:
            bt = np.zeros((self.num_slots, self.pages_per_slot), "int32")
            live = np.zeros((self.num_slots,), "int32")
        for s in active:
            tokens[s.idx, 0] = s.tokens[-1]
            positions[s.idx] = s.position
            if self.paged:
                bt[s.idx] = self._slot_block_table(s)
                live[s.idx] = 1
        next_tokens, logits = self._run_decode_program(tokens, positions,
                                                       bt, live)
        t1 = time.monotonic()
        ms = (t1 - t0) * 1e3
        self._t_decode_total += ms
        self._h_step.observe(ms)
        self._count("decode_steps")
        stat_add("serving_decode_steps")
        if usage.enabled():
            led = usage.ledger()
            for s in active:
                if s.req.tenant is not None:
                    led.book(s.req.tenant, decode_steps=1)
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
        if req.tenant is not None:
            usage.ledger().book(req.tenant, tokens_out=1)
        if req.record_timeline:
            req.t_tokens.append(now)
        if req.t_first is None:
            req.t_first = now
            self._h_ttft.observe((now - req.t_submit) * 1e3,
                                 trace_id=req.trace_id)
        else:
            self._h_itl.observe((now - req.t_last) * 1e3,
                                trace_id=req.trace_id)
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
        req.note("finish", now, {"reason": finish})
        self._count("served")
        self._h_gen.observe(total_ms, trace_id=req.trace_id)
        if req.tenant is not None:
            led = usage.ledger()
            led.book(req.tenant, served=1)
            led.observe_latency(req.tenant, total_ms)
        result = {
            "tokens": [int(t) for t in slot.tokens],
            "prompt_len": int(req.prompt.size),
            "steps": slot.steps,
            "finish": finish,
            "trace_id": req.trace_id,
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
        if slot.hit_tokens:
            result["prefix_hit_tokens"] = slot.hit_tokens
        if req.record_timeline:
            result["timeline"] = self._timeline_record(req, result)
            self._store_timeline(result)
        self._end_span(slot, finish)
        slot.req = None
        slot.decoding = False
        self._release_pages(slot)
        blackbox.request_end(req.bb)
        req.future._resolve(outputs=result)

    def _timeline_record(self, req: GenRequest, result: dict) -> dict:
        """The sequence's timeline in ms from admission: every phase
        boundary (claim, prefix hit, prefill slices, export or adopt,
        finish) and every token, as the caller's clock saw them."""
        t0 = req.t_submit

        def rel(t):
            return round((t - t0) * 1e3, 3)

        events = []
        for label, t, extra in req.events:
            ev = {"at_ms": rel(t), "event": label}
            if extra:
                ev.update(extra)
            events.append(ev)
        token_ms = [rel(t) for t in req.t_tokens]
        tl = {"trace_id": req.trace_id, "events": events,
              "token_ms": token_ms, "ttft_ms": result.get("ttft_ms")}
        if len(token_ms) >= 2:
            gaps = sorted(round(b - a, 3)
                          for a, b in zip(token_ms, token_ms[1:]))
            tl["inter_token_ms"] = {"p50": gaps[len(gaps) // 2],
                                    "max": gaps[-1],
                                    "mean": round(sum(gaps) / len(gaps), 3)}
        return tl

    def _store_timeline(self, result: dict):
        """The bounded finished-sequence store behind ``tracez``: recent
        ring and the slowest ``FLAGS_trace_tail_keep`` by total time."""
        rec = {k: result[k] for k in ("trace_id", "finish", "steps",
                                      "prompt_len", "queue_wait_ms",
                                      "prefill_ms", "ttft_ms", "total_ms")
               if k in result}
        rec["timeline"] = result.get("timeline")
        with self._timeline_lock:
            self._timelines_recent.append(rec)
            if self._tail_keep:
                self._timelines_slow.append(rec)
                self._timelines_slow.sort(
                    key=lambda r: -(r.get("total_ms") or 0.0))
                del self._timelines_slow[self._tail_keep:]

    def tracez(self) -> dict:
        """The ``/tracez`` ``generation`` block: recent finished sequence
        timelines (newest first), the slowest tail, and the TTFT /
        inter-token exemplars (whose trace ids resolve here)."""
        with self._timeline_lock:
            recent = list(self._timelines_recent)
            slow = list(self._timelines_slow)
        return {"recent": recent[::-1], "slowest": slow,
                "ttft_exemplars": self._h_ttft.exemplars(),
                "inter_token_exemplars": self._h_itl.exemplars()}

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
            "role": self.role,
            "slots": self.num_slots,
            "slots_active": active,
            "slot_occupancy": round(active / self.num_slots, 4),
            "continuous": self.continuous,
            "max_seq_len": self.max_seq_len,
            "prefill_buckets": list(self.prefill_buckets),
            "kv_cache_bytes": self.kv_cache_bytes,
            "kv_live_bytes": self.kv_live_bytes,
            "paged": None if not self.paged else {
                "page_tokens": self.page_tokens,
                "num_pages": self.num_pages,
                "pages_per_slot": self.pages_per_slot,
                "pages_free": self._pool.free_pages,
                "pages_live": self._pool.live_pages,
                "page_bytes": self.page_bytes,
                "prefill_chunk": self.prefill_chunk,
                "prefix_reuse": self.prefix_reuse,
                "prefix_index_entries":
                    len(self._prefix) if self._prefix else 0,
                "prefix_hit_rate": round(
                    n["prefix_hits"] / max(n["prefills"], 1), 4),
            },
            "speculate": None if not self.speculate else {
                "spec_tokens": self.spec_tokens,
                "spec_ngram": self.spec_ngram,
                "drafts": n["spec_drafts"],
                "tokens_proposed": n["spec_tokens_proposed"],
                "tokens_accepted": n["spec_tokens_accepted"],
                "rollbacks": n["spec_rollbacks"],
                "acceptance_rate": round(
                    n["spec_tokens_accepted"]
                    / max(n["spec_tokens_proposed"], 1), 4),
            },
            "draining": draining,
            "weights_version": self.weights_version,
            "counters": n,
            "tokens_per_request": round(
                n["generated_tokens"] / max(n["served"], 1), 2),
            "prefill_decode_ms_ratio": round(
                self._t_prefill_total / max(self._t_decode_total, 1e-9), 4),
            "generate_ms": self._h_gen.summary(),
            "prefill_ms": self._h_prefill.summary(),
            "decode_step_ms": self._h_step.summary(),
            "spec_verify_ms": self._h_verify.summary(),
            "ttft_ms": self._h_ttft.summary(),
            "inter_token_ms": self._h_itl.summary(),
            "segment_export_ms": self._h_export.summary(),
            "segment_adopt_ms": self._h_adopt.summary(),
        }

    def introspect(self) -> dict:
        """Stats, the decode step's cost manifest, plus the compiled-step
        inventories of the decode step's executor and each prefill, chunk
        and verify bucket's
        (``cache_info``: signature, whether captured, graph pool bytes)
        and the CUDA graph captures of each program (``captures``:
        "decode", each prefill bucket by its length, each chunk bucket as
        "chunk<length>", each verify bucket as "verify<length>")."""
        def label(kind, b):
            return b if kind == "prefill" else f"{kind}{b}"

        progs = sorted(self._progs.items())
        captures = {"decode": self._decode_exe.captures()}
        captures.update({label(*key): exe.captures()
                         for key, (_p, _f, exe) in progs})
        from ..costmodel import step_manifest

        decode = list(self._decode_exe._cache.values())
        return {
            "stats": self.stats(),
            # the decode step's cost manifest (flops, bytes, graph pool)
            "decode_manifest": step_manifest(decode[-1]) if decode else None,
            "decode_executables": self._decode_exe.cache_info(),
            "prefill_executables": {label(*key): exe.cache_info()
                                    for key, (_p, _f, exe) in progs},
            "captures": captures,
        }
