"""Disaggregated prefill / decode serving: the KV-segment handoff.

Counterpart of ``paddle_tpu/serving/disagg.py`` (the port's own copy:
importing the JAX package's module would import jax).

* A **prefill-role** :class:`~paddle_tpu_torch.serving.generation.
  GenerationEngine` runs the paged prefill (chunked prefill and prefix
  reuse included), then *exports* the sequence's populated pages as a
  :class:`KVSegment` (per-layer page blocks in logical order, the
  lengths, the tokens generated so far, a model / config
  **fingerprint**) and frees the slot for the next prompt.
* A **decode-role** engine *adopts* a segment: it takes pages from its
  own ``PagePool`` (pool exhaustion evicts idle prefix pages or requeues
  as a local prefill does), scatters the segment's blocks into them in
  place, and the sequence enters the decode grid at its recorded
  position.  ``kv_pool_gather`` rebuilds the same dense view from any
  physical placement, so the adopted sequence decodes the colocated
  engine's tokens and logits bit for bit.

**Transports.**  :class:`SegmentTransport` is the seam:

* :class:`DeviceTransport` copies the page blocks into new tensors on
  the device (``tensor.to(device, copy=True)``: on one card ``to`` alone
  would hand back the exporter's own tensor), with no round trip through
  host memory.
* :class:`HostBytesTransport` serialises through the wire format:
  :meth:`KVSegment.to_bytes` / :meth:`KVSegment.from_bytes` frame a
  little-endian float32 payload behind a JSON header (magic, version,
  fingerprint), byte for byte the JAX package's, so a segment either
  package writes decodes in the other.

**Ordering on the card.**  The exporter gathers the pages on its
scheduler thread's current stream, the stream its prefill replays are
launched on, and records ``KVSegment.ready`` there; every reader of the
blocks (a transport, ``to_bytes``, the adopter's scatter) first makes its
own current stream wait on that event.  A transport that makes new
tensors records a new event.  No reader synchronises the whole device.

**Fingerprint.**  ``config_fingerprint`` hashes the model sizes, the page
geometry, the parameter ``name`` prefix and the weight seed; adoption
refuses a segment whose fingerprint differs (:class:`SegmentMismatch`).

:class:`DisaggPair` chains a prefill-role and a decode-role engine behind
one ``submit()``: a pump thread hands each finished prefill's segment
through the transport to ``decode.adopt`` without blocking on any one
future.  Across processes the same handoff runs through the HTTP
``POST /adopt`` hop (serving/server.py) and the router's prefill ->
``/adopt`` -> decode pipeline (serving/router.py) over a role-split
fleet (serving/fleet.py).

Stats: ``serving_segments_exported``, ``serving_segments_adopted``,
``serving_segment_export_bytes``, ``serving_segment_adopt_bytes``,
``serving_adopt_rejects`` (counted by the engines).
"""
from __future__ import annotations

import hashlib
import json
import struct
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..flags import flag_value, register_flag
from .engine import ServingFuture

__all__ = ["KVSegment", "SegmentMismatch", "SegmentTransport",
           "DeviceTransport", "HostBytesTransport", "DisaggPair",
           "config_fingerprint", "default_transport", "SEGMENT_VERSION",
           "SEGMENT_MAGIC", "SEGMENT_CONTENT_TYPE"]

SEGMENT_VERSION = 1
SEGMENT_MAGIC = b"PTKVSEG1"
# HTTP content type of a serialized segment (a prefill-role server's
# /generate reply, a decode-role server's /adopt body)
SEGMENT_CONTENT_TYPE = "application/x-paddletpu-kvsegment"

register_flag("FLAGS_disagg_transport", "device",
              "in-process KV-segment handoff transport (DisaggPair "
              "default): 'device' = the page blocks copied into new "
              "tensors on the device, no host copy; 'bytes' = serialize "
              "through the KVSegment wire codec — the exact bytes POST "
              "/adopt carries, i.e. what a cross-host transport pays")


class SegmentMismatch(ValueError):
    """A segment whose fingerprint or page geometry does not match the
    adopting engine: adopting it would decode garbage."""


def config_fingerprint(model: dict, page_tokens: int, max_seq_len: int,
                       name: str, seed: int) -> str:
    """Fingerprint of what must agree between the exporting and the
    adopting engine for a segment's K/V to mean the same thing: model
    sizes, page geometry, the parameter name prefix and the weight
    seed.  The JAX package's function gives the same string."""
    doc = {"model": {k: model[k] for k in sorted(model)},
           "page_tokens": int(page_tokens),
           "max_seq_len": int(max_seq_len),
           "name": str(name), "seed": int(seed),
           "version": SEGMENT_VERSION}
    blob = json.dumps(doc, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:24]


def wait_ready(segment: "KVSegment"):
    """Make the current stream wait until the segment's blocks are
    written (a no-op for a segment without an event)."""
    if segment.ready is not None:
        segment.ready.wait()


def _record_ready() -> torch.cuda.Event:
    ev = torch.cuda.Event()
    ev.record()
    return ev


def _host(a) -> np.ndarray:
    """A numpy view of a block (a CUDA tensor is copied to the host)."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu").numpy()
    return np.asarray(a)


class KVSegment:
    """One sequence's populated KV pages, detached from any pool.

    ``layers``: one ``(k_pages, v_pages)`` pair a layer, each ``[n_pages,
    n_kv, page_tokens, D]`` float32 in logical page order (block j holds
    tokens ``[j * page_tokens, (j + 1) * page_tokens)``); the source
    pool's physical page ids are not part of the segment.  ``tokens``:
    every token generated so far (at least the prefill's first);
    ``position``: the logical length in the pages (``prompt_len`` for a
    fresh export).  Blocks are numpy arrays or torch tensors;
    ``ready`` is the CUDA event after which tensor blocks on the card
    may be read (None otherwise)."""

    __slots__ = ("version", "fingerprint", "prompt_len", "position",
                 "tokens", "page_tokens", "layers", "logits",
                 "trace_id", "ready")

    def __init__(self, fingerprint: str, prompt_len: int, position: int,
                 tokens: Sequence[int], page_tokens: int,
                 layers: List[Tuple], logits=None,
                 trace_id: Optional[str] = None,
                 version: int = SEGMENT_VERSION, ready=None):
        self.version = int(version)
        self.fingerprint = str(fingerprint)
        self.prompt_len = int(prompt_len)
        self.position = int(position)
        self.tokens = [int(t) for t in tokens]
        self.page_tokens = int(page_tokens)
        self.layers = layers
        self.logits = logits  # [n_tokens, V] float32, keep_logits only
        self.trace_id = trace_id
        self.ready = ready

    @property
    def n_layers(self) -> int:
        return len(self.layers)

    @property
    def n_pages(self) -> int:
        return int(self.layers[0][0].shape[0]) if self.layers else 0

    @property
    def nbytes(self) -> int:
        """Payload bytes (K/V blocks and the logits, if any): what a
        transport moves."""
        total = sum(int(np.prod(tuple(k.shape))) * 4
                    + int(np.prod(tuple(v.shape))) * 4
                    for k, v in self.layers)
        if self.logits is not None:
            total += int(np.prod(tuple(self.logits.shape))) * 4
        return total

    # -- serialisation (the host-bytes / cross-host path) -------------------
    def to_bytes(self) -> bytes:
        """``MAGIC | u32 header_len | header JSON | payload``: every
        layer's K then V block as little-endian float32 in C order, then
        the logits, if any.  :meth:`from_bytes` needs nothing else."""
        wait_ready(self)
        k0 = _host(self.layers[0][0])
        n_pages, n_kv, pt, d = k0.shape
        logits = None if self.logits is None \
            else np.ascontiguousarray(np.asarray(_host(self.logits), "<f4"))
        header = {
            "version": self.version, "fingerprint": self.fingerprint,
            "prompt_len": self.prompt_len, "position": self.position,
            "tokens": self.tokens, "page_tokens": self.page_tokens,
            "n_layers": self.n_layers, "n_pages": int(n_pages),
            "n_kv": int(n_kv), "head_dim": int(d),
            "trace_id": self.trace_id,
            "logits_shape": list(logits.shape)
            if logits is not None else None,
        }
        hb = json.dumps(header, sort_keys=True).encode()
        parts = [SEGMENT_MAGIC, struct.pack("<I", len(hb)), hb]
        for k, v in self.layers:
            parts.append(np.ascontiguousarray(
                np.asarray(_host(k), "<f4")).tobytes())
            parts.append(np.ascontiguousarray(
                np.asarray(_host(v), "<f4")).tobytes())
        if logits is not None:
            parts.append(logits.tobytes())
        return b"".join(parts)

    @classmethod
    def from_bytes(cls, buf: bytes) -> "KVSegment":
        """The segment `buf` frames; its blocks are read-only numpy views
        of `buf`."""
        if len(buf) < len(SEGMENT_MAGIC) + 4 \
                or buf[:len(SEGMENT_MAGIC)] != SEGMENT_MAGIC:
            raise ValueError("not a KV segment (bad magic)")
        off = len(SEGMENT_MAGIC)
        (hlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        try:
            header = json.loads(buf[off:off + hlen])
        except ValueError as e:
            raise ValueError(f"corrupt KV segment header: {e}") from e
        off += hlen
        if header.get("version") != SEGMENT_VERSION:
            raise ValueError(f"unsupported KV segment version "
                             f"{header.get('version')} (this build "
                             f"speaks {SEGMENT_VERSION})")
        shape = (header["n_pages"], header["n_kv"],
                 header["page_tokens"], header["head_dim"])
        block = int(np.prod(shape)) * 4
        expect = off + header["n_layers"] * 2 * block
        if header.get("logits_shape"):
            expect += int(np.prod(header["logits_shape"])) * 4
        if expect != len(buf):
            raise ValueError(f"KV segment length mismatch: header "
                             f"promises {expect} bytes, got {len(buf)}")
        layers = []
        for _ in range(header["n_layers"]):
            k = np.frombuffer(buf, "<f4", count=block // 4,
                              offset=off).reshape(shape)
            off += block
            v = np.frombuffer(buf, "<f4", count=block // 4,
                              offset=off).reshape(shape)
            off += block
            layers.append((k, v))
        logits = None
        if header.get("logits_shape"):
            lshape = tuple(header["logits_shape"])
            logits = np.frombuffer(buf, "<f4", count=int(np.prod(lshape)),
                                   offset=off).reshape(lshape)
        return cls(header["fingerprint"], header["prompt_len"],
                   header["position"], header["tokens"],
                   header["page_tokens"], layers, logits=logits,
                   trace_id=header.get("trace_id"),
                   version=header["version"])


# ---------------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------------

class SegmentTransport:
    """The handoff seam: ``send`` delivers a segment to where the
    adopting engine reads it.  The payload must come out bit for bit as
    it went in."""

    def send(self, segment: KVSegment) -> KVSegment:
        raise NotImplementedError


class DeviceTransport(SegmentTransport):
    """The page blocks copied into new tensors on ``device`` (None: the
    device they are on; a numpy block goes to the CPU), without a round
    trip through host memory when both ends are on the card."""

    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)
        self.segments = 0
        self.bytes_moved = 0

    def _copy(self, a) -> torch.Tensor:
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.array(a, "<f4"))
        dst = self.device or a.device
        out = a.to(dst, copy=True)
        if a.is_cuda:
            # read on this thread's stream: the allocator must not hand
            # the source's memory out again before the copy has read it
            a.record_stream(torch.cuda.current_stream(a.device))
        return out

    def send(self, segment: KVSegment) -> KVSegment:
        wait_ready(segment)
        layers = [(self._copy(k), self._copy(v)) for k, v in segment.layers]
        on_card = any(k.is_cuda for k, _ in layers)
        self.segments += 1
        self.bytes_moved += segment.nbytes
        return KVSegment(segment.fingerprint, segment.prompt_len,
                         segment.position, segment.tokens,
                         segment.page_tokens, layers,
                         logits=segment.logits, trace_id=segment.trace_id,
                         version=segment.version,
                         ready=_record_ready() if on_card else None)


class HostBytesTransport(SegmentTransport):
    """Serialise, then deserialise, through the wire format: the bytes
    ``POST /adopt`` carries."""

    def __init__(self):
        self.segments = 0
        self.bytes_moved = 0

    def send(self, segment: KVSegment) -> KVSegment:
        buf = segment.to_bytes()
        self.segments += 1
        self.bytes_moved += len(buf)
        return KVSegment.from_bytes(buf)


def default_transport() -> SegmentTransport:
    """The transport ``FLAGS_disagg_transport`` names: ``device`` or
    ``bytes``."""
    kind = str(flag_value("FLAGS_disagg_transport") or "device")
    if kind == "bytes":
        return HostBytesTransport()
    if kind == "device":
        return DeviceTransport()
    raise ValueError(f"FLAGS_disagg_transport={kind!r} (want 'device' "
                     f"or 'bytes')")


# ---------------------------------------------------------------------------
# in-process orchestrator
# ---------------------------------------------------------------------------

class DisaggPair:
    """A prefill-role engine and a decode-role engine behind one
    ``submit()``.

    One pump thread polls the outstanding prefill futures; as one
    resolves, its segment goes through ``transport.send`` into
    ``decode.adopt`` and the pump moves on, so handoffs overlap both
    engines' scheduling.  A failure at any stage resolves the caller's
    future with that stage's error (sheds stay OverloadedError)."""

    def __init__(self, prefill, decode,
                 transport: Optional[SegmentTransport] = None):
        if getattr(prefill, "role", "both") != "prefill":
            raise ValueError("DisaggPair needs a prefill-role engine "
                             f"first (got role={prefill.role!r})")
        if getattr(decode, "role", "both") not in ("decode", "both"):
            raise ValueError("DisaggPair needs a decode-capable engine "
                             f"second (got role={decode.role!r})")
        if prefill.fingerprint() != decode.fingerprint():
            raise SegmentMismatch(
                "prefill/decode engine fingerprints differ "
                f"({prefill.fingerprint()} vs {decode.fingerprint()}): "
                "segments would be rejected at adoption")
        self.prefill = prefill
        self.decode = decode
        self.transport = transport or default_transport()
        self._lock = threading.Lock()
        self._pending_prefill: List[tuple] = []
        self._pending_decode: List[tuple] = []
        self._n = {"handoffs": 0, "failures": 0}
        self._handoff_ms: List[float] = []
        self._closed = threading.Event()
        self._pump = threading.Thread(target=self._pump_loop,
                                      name="disagg-pump", daemon=True)
        self._pump.start()

    # -- API ----------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               on_token=None) -> ServingFuture:
        """``GenerationEngine.submit``'s contract: the result is the
        decode engine's record (the whole token stream: the prefill's
        first token replayed, then every decoded one) plus
        ``handoff_ms``, ``segment_bytes`` and the prefill hop's
        timings."""
        out = ServingFuture()
        pf = self.prefill.submit(prompt, max_new_tokens,
                                 deadline_ms=deadline_ms)
        with self._lock:
            self._pending_prefill.append(
                (pf, out, {"max_new_tokens": max_new_tokens,
                           "deadline_ms": deadline_ms,
                           "on_token": on_token, "t0": time.monotonic()}))
        return out

    def generate(self, prompt, max_new_tokens=None,
                 timeout: Optional[float] = None) -> dict:
        return self.submit(prompt, max_new_tokens).result(timeout)

    def stats(self) -> dict:
        with self._lock:
            n = dict(self._n)
            hand = sorted(self._handoff_ms)
        return {
            "handoffs": n["handoffs"],
            "handoff_failures": n["failures"],
            "handoff_ms_p50": hand[len(hand) // 2] if hand else None,
            "handoff_ms_max": hand[-1] if hand else None,
            "transport": type(self.transport).__name__,
            "transport_bytes": getattr(self.transport, "bytes_moved",
                                       None),
            "prefill": self.prefill.stats(),
            "decode": self.decode.stats(),
        }

    def close(self, drain: bool = True, timeout: Optional[float] = None):
        self.prefill.close(drain=drain, timeout=timeout)
        if drain:
            # every prefill future has resolved: hand the finished
            # segments to the decode engine before it drains, or the
            # handoff tail would shed as 'draining'
            deadline = None if timeout is None \
                else time.monotonic() + timeout
            while True:
                with self._lock:
                    if not self._pending_prefill:
                        break
                if deadline is not None and time.monotonic() > deadline:
                    break
                time.sleep(0.002)
        self.decode.close(drain=drain, timeout=timeout)
        self._closed.set()
        self._pump.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False

    # -- pump ---------------------------------------------------------------
    def _pump_loop(self):
        while True:
            moved = self._pump_once()
            with self._lock:
                idle = not (self._pending_prefill or self._pending_decode)
            if self._closed.is_set() and idle:
                return
            if not moved:
                time.sleep(0.002)

    def _pump_once(self) -> bool:
        moved = False
        with self._lock:
            ready_p = [t for t in self._pending_prefill if t[0].done()]
            self._pending_prefill = [
                t for t in self._pending_prefill if not t[0].done()]
        for pf, out, params in ready_p:
            moved = True
            self._handoff(pf, out, params)
        with self._lock:
            ready_d = [t for t in self._pending_decode if t[0].done()]
            self._pending_decode = [
                t for t in self._pending_decode if not t[0].done()]
        for df, out, meta in ready_d:
            moved = True
            try:
                res = dict(df.result(0))
                res.update(meta)
                out._resolve(outputs=res)
            except Exception as e:  # noqa: BLE001 — relay the decode
                # stage's own error (OverloadedError / RequestFailed)
                with self._lock:
                    self._n["failures"] += 1
                out._resolve(error=e)
        return moved

    def _handoff(self, pf, out, params):
        t_h0 = time.monotonic()
        try:
            pres = pf.result(0)
            seg = self.transport.send(pres["segment"])
            df = self.decode.adopt(
                seg, max_new_tokens=params["max_new_tokens"],
                deadline_ms=self._remaining_ms(params),
                on_token=params["on_token"])
        except Exception as e:  # noqa: BLE001 — a prefill shed or
            # failure, or a refusal at adoption: the caller gets it
            with self._lock:
                self._n["failures"] += 1
            out._resolve(error=e)
            return
        ms = (time.monotonic() - t_h0) * 1e3
        with self._lock:
            self._n["handoffs"] += 1
            self._handoff_ms.append(ms)
            if len(self._handoff_ms) > 4096:
                del self._handoff_ms[:2048]
        meta = {"handoff_ms": round(ms, 3),
                "segment_bytes": seg.nbytes,
                "prefill_ms": pres.get("prefill_ms"),
                "prefill_queue_wait_ms": pres.get("queue_wait_ms")}
        with self._lock:
            self._pending_decode.append((df, out, meta))

    @staticmethod
    def _remaining_ms(params) -> Optional[float]:
        if params["deadline_ms"] is None:
            return None
        spent = (time.monotonic() - params["t0"]) * 1e3
        return max(1.0, params["deadline_ms"] - spent)
