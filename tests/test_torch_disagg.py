"""The port's disaggregated prefill / decode roles on the CPU: the twins of
``tests/test_disagg.py``'s handoff contracts inside the port, then the
port's KV-segment codec against the JAX package's.

* **Disaggregated ≡ colocated at tolerance 0** — export, transport,
  adopt, decode gives the colocated engine's tokens and every step's
  logits (``np.array_equal``) at page - 1 / page / page + 1 prompt
  lengths through both transports, with prefix reuse and chunked
  prefill on the prefill side, and over two child scopes of one weights
  scope (each engine its own pools).
* **Refcounts** — both pools drain to 0 live pages after adopt, finish
  and failure; a pool that cannot hold a segment fails that request.
* **Fingerprint** — a mismatched segment is refused at adoption
  (``SegmentMismatch``), never queued.
* **Against the JAX package** — ``to_bytes`` gives the same bytes for
  the same segment, each package's ``from_bytes`` reads the other's,
  and ``config_fingerprint`` gives the same string.
* **Through the router** — the port's router runs the prefill ->
  ``/adopt`` -> decode pipeline across in-process port servers (plain
  and streamed, the colocated engine's tokens), fails a lost decode
  replica with ``affinity_lost`` and re-prefills only under
  ``FLAGS_disagg_reprefill``.
"""
import json
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tpt
from paddle_tpu_torch import fault
from paddle_tpu_torch.ops.registry import reset_op_seed
from paddle_tpu_torch.serving import (DeviceTransport, DisaggPair,
                                      GenerationEngine, HostBytesTransport,
                                      KVSegment, RequestFailed,
                                      SegmentMismatch)
from paddle_tpu_torch.serving.disagg import (config_fingerprint,
                                             default_transport)

MODEL = dict(vocab_size=64, hidden=32, num_layers=2, num_heads=4,
             num_kv_heads=2, intermediate=64)
KW = dict(num_slots=2, max_seq_len=32, max_new_tokens=8, attn_impl="xla",
          seed=0, queue_cap=64, deadline_ms=600000.0, paged=True,
          page_tokens=8, prefill_chunk=0, prefix_reuse=False, device="cpu")


def _build(role="both", **over):
    """An engine whose weights equal every other _build's: the op-seed
    counter restarts, so each startup draws the same values."""
    reset_op_seed()
    return GenerationEngine(MODEL, role=role, **dict(KW, **over))


@pytest.fixture(scope="module")
def colocated():
    eng = _build(keep_logits=True)
    yield eng
    eng.close()


@pytest.fixture(scope="module")
def pair():
    p = DisaggPair(_build("prefill", keep_logits=True),
                   _build("decode", keep_logits=True),
                   transport=HostBytesTransport())
    yield p
    p.close()


def _segment(rng, n_pages=3):
    layers = [(rng.rand(n_pages, 2, 8, 8).astype("<f4"),
               rng.rand(n_pages, 2, 8, 8).astype("<f4")) for _ in range(2)]
    return KVSegment("fp" * 12, 17, 17, [41], 8, layers,
                     logits=rng.rand(1, 64).astype("<f4"), trace_id="t-1")


# ---------------------------------------------------------------------------
# the segment codec
# ---------------------------------------------------------------------------

def test_segment_codec_roundtrip_and_rejects():
    seg = _segment(np.random.RandomState(0))
    buf = seg.to_bytes()
    back = KVSegment.from_bytes(buf)
    assert back.fingerprint == seg.fingerprint
    assert back.prompt_len == 17 and back.position == 17
    assert back.tokens == [41] and back.page_tokens == 8
    assert back.trace_id == "t-1"
    for (k0, v0), (k1, v1) in zip(seg.layers, back.layers):
        assert np.array_equal(k0, k1) and np.array_equal(v0, v1)
    assert np.array_equal(back.logits, seg.logits)
    assert back.nbytes == seg.nbytes
    # torch blocks frame the same bytes as numpy ones
    as_torch = KVSegment(seg.fingerprint, 17, 17, [41], 8,
                         [(torch.from_numpy(k), torch.from_numpy(v))
                          for k, v in seg.layers],
                         logits=seg.logits, trace_id="t-1")
    assert as_torch.to_bytes() == buf and as_torch.nbytes == seg.nbytes
    with pytest.raises(ValueError, match="magic"):
        KVSegment.from_bytes(b"NOTASEG0" + buf[8:])
    with pytest.raises(ValueError, match="length mismatch"):
        KVSegment.from_bytes(buf[:-4])


def test_transports_copy_the_blocks():
    """Both transports hand over a segment of its own: DeviceTransport's
    blocks are new tensors (never the exporter's), HostBytesTransport's
    come through the wire format; the values are the same bits."""
    seg = _segment(np.random.RandomState(1))
    seg = KVSegment(seg.fingerprint, 17, 17, [41], 8,
                    [(torch.from_numpy(k), torch.from_numpy(v))
                     for k, v in seg.layers], logits=seg.logits)
    for tr in (DeviceTransport(), HostBytesTransport()):
        out = tr.send(seg)
        assert tr.segments == 1 and tr.bytes_moved >= seg.nbytes
        for (k0, v0), (k1, v1) in zip(seg.layers, out.layers):
            assert np.array_equal(np.asarray(k1), k0.numpy())
            assert np.array_equal(np.asarray(v1), v0.numpy())
            if isinstance(k1, torch.Tensor):
                assert k1.data_ptr() != k0.data_ptr()
    saved = tpt.get_flags("FLAGS_disagg_transport")["FLAGS_disagg_transport"]
    assert saved == "device"
    try:
        assert isinstance(default_transport(), DeviceTransport)
        tpt.set_flags({"FLAGS_disagg_transport": "bytes"})
        assert isinstance(default_transport(), HostBytesTransport)
        tpt.set_flags({"FLAGS_disagg_transport": "rdma"})
        with pytest.raises(ValueError, match="rdma"):
            default_transport()
    finally:
        tpt.set_flags({"FLAGS_disagg_transport": saved})


# ---------------------------------------------------------------------------
# export -> adopt, tolerance 0
# ---------------------------------------------------------------------------

def _assert_same(want, got, what):
    assert got["tokens"] == want["tokens"], (what, got, want)
    wl, gl = np.stack(want["logits"]), np.stack(got["logits"])
    assert wl.shape == gl.shape
    assert np.array_equal(wl, gl), \
        f"{what}: logits drift {np.abs(wl - gl).max()}"


@pytest.mark.parametrize("transport", [HostBytesTransport, DeviceTransport])
def test_export_adopt_bitexact_at_page_boundaries(colocated, pair,
                                                  transport):
    """Tokens and logits equal (tolerance 0) through export, transport,
    adopt and decode, at prompt lengths page - 1 / page / page + 1 (pages
    of 8 tokens)."""
    pair.transport = transport()
    rng = np.random.RandomState(1)
    for n in (7, 8, 9, 15, 16, 17):
        prompt = rng.randint(1, 64, size=n).tolist()
        want = colocated.generate(prompt, 6, timeout=120)
        got = pair.generate(prompt, 6, timeout=120)
        _assert_same(want, got, f"prompt length {n}")
        assert got["handoff_ms"] is not None
        assert got["segment_bytes"] > 0
    assert pair.transport.segments == 6


def test_export_adopt_with_prefix_reuse_and_chunked_prefill(colocated):
    """The prefill side runs chunked prefill and prefix reuse; its
    segments still decode bit for bit, and the index did serve the
    shared header."""
    pre = _build("prefill", keep_logits=True, prefill_chunk=8,
                 prefix_reuse=True, num_pages=17)
    p = DisaggPair(pre, _build("decode", keep_logits=True),
                   transport=HostBytesTransport())
    rng = np.random.RandomState(2)
    header = rng.randint(1, 64, size=16).tolist()   # two whole pages
    try:
        for i in range(3):
            prompt = header + rng.randint(1, 64, size=5 + i).tolist()
            _assert_same(colocated.generate(prompt, 5, timeout=120),
                         p.generate(prompt, 5, timeout=120), i)
        st = pre.stats()
        assert st["counters"]["prefix_hits"] >= 1
        assert st["counters"]["prefill_chunks"] >= 1
        assert st["counters"]["segments_exported"] == 3
        assert p.decode.stats()["counters"]["segments_adopted"] == 3
    finally:
        p.close()


def test_pair_over_child_scopes_of_one_weights_scope(colocated):
    """Two engines over child scopes of one weights scope (one copy of
    the weights, a pool set each): the colocated engine's streams, and
    the weights scope holds no pool."""
    weights = colocated.scope
    pre = GenerationEngine(MODEL, scope=tpt.Scope(parent=weights),
                           role="prefill", **dict(KW, keep_logits=True))
    dec = GenerationEngine(MODEL, scope=tpt.Scope(parent=weights),
                           role="decode", **dict(KW, keep_logits=True))
    assert pre.scope.find_var(pre.cache_names[0]) is not \
        dec.scope.find_var(dec.cache_names[0])
    assert pre.scope.find_var("llama.embed") is \
        dec.scope.find_var("llama.embed")
    p = DisaggPair(pre, dec, transport=DeviceTransport())
    rng = np.random.RandomState(5)
    try:
        prompts = [rng.randint(1, 64, size=n).tolist() for n in (9, 20)]
        futs = [p.submit(q, 6) for q in prompts]
        for q, f in zip(prompts, futs):
            _assert_same(colocated.generate(q, 6, timeout=120),
                         f.result(120), len(q))
    finally:
        p.close()
    assert pre._pool.live_pages == dec._pool.live_pages == 0


# ---------------------------------------------------------------------------
# refcounts and failures
# ---------------------------------------------------------------------------

def test_refcounts_balance_after_adopt_finish_and_failure(pair):
    pre, dec = pair.prefill, pair.decode
    rng = np.random.RandomState(3)
    for _ in range(3):
        pair.generate(rng.randint(1, 64, size=9).tolist(), 4, timeout=120)
    assert pre.stats()["paged"]["pages_live"] == 0
    assert dec.stats()["paged"]["pages_live"] == 0
    # an injected adopt fault releases the pages and fails exactly that
    # request
    res = pre.generate(rng.randint(1, 64, size=9).tolist(), 4, timeout=120)
    seg = KVSegment.from_bytes(res["segment"].to_bytes())
    fault.configure("adopt:fail@1")
    try:
        with pytest.raises(RequestFailed, match="adopt failed"):
            dec.adopt(seg).result(60)
    finally:
        fault.reset()
    assert dec.stats()["paged"]["pages_live"] == 0
    # the same segment adopts cleanly afterwards: the failure consumed
    # nothing
    out = dec.adopt(seg).result(60)
    assert out["tokens"][0] == res["tokens"][0]
    assert dec.stats()["paged"]["pages_live"] == 0


def test_fingerprint_mismatch_rejected_at_adoption(pair):
    seg = pair.prefill.generate([5, 6, 7, 8, 9], 4, timeout=120)["segment"]
    bad = KVSegment("0" * 24, seg.prompt_len, seg.position, seg.tokens,
                    seg.page_tokens, list(seg.layers))
    before = pair.decode.stats()["counters"]["adopt_rejects"]
    with pytest.raises(SegmentMismatch, match="fingerprint"):
        pair.decode.adopt(bad)
    assert pair.decode.stats()["counters"]["adopt_rejects"] == before + 1
    # a wrong page geometry is refused too
    with pytest.raises(SegmentMismatch, match="structure"):
        pair.decode.adopt(KVSegment(
            pair.decode.fingerprint(), seg.prompt_len, seg.position,
            seg.tokens, 4, list(seg.layers)))
    # a crafted prompt_len is refused before anything is sized by it
    with pytest.raises(SegmentMismatch, match="structure"):
        pair.decode.adopt(KVSegment(
            pair.decode.fingerprint(), 10 ** 12, seg.position, seg.tokens,
            seg.page_tokens, list(seg.layers)))


def test_role_guards_and_pool_too_small():
    pre = _build("prefill")
    with pytest.raises(ValueError, match="adopt"):
        pre.adopt(object())
    seg = pre.generate([1] * 17, 2, timeout=120)["segment"]   # 3 pages
    tiny = _build("decode", num_pages=3)  # 2 usable pages = 16 tokens
    try:
        with pytest.raises(ValueError, match="adopt"):
            tiny.submit([1, 2, 3])
        # a pool that cannot hold the segment even when idle fails
        # exactly that request (a requeue could never succeed)
        with pytest.raises(RequestFailed, match="adopt failed"):
            tiny.adopt(seg).result(60)
        assert tiny.stats()["paged"]["pages_live"] == 0
    finally:
        tiny.close()
        pre.close()
    with pytest.raises(ValueError, match="paged"):
        _build("prefill", paged=False)
    with pytest.raises(ValueError, match="both|prefill|decode"):
        _build("router")


def test_roles_warm_only_their_programs():
    """A prefill-role engine warms its prefill buckets and no decode
    step; a decode-role engine the decode step (and, speculating, the
    verify bucket) and no prefill bucket."""
    pre = _build("prefill", autostart=False)
    dec = _build("decode", autostart=False, speculate=True)
    try:
        assert pre.warmup() == len(pre.prefill_buckets)
        assert pre.introspect()["captures"]["decode"] == []
        assert dec.warmup() == 2
        assert set(dec.introspect()["captures"]) == {"decode", "verify8"}
        assert pre.stats()["role"] == "prefill"
        assert dec.stats()["role"] == "decode"
    finally:
        pre.close()
        dec.close()


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def test_segment_bytes_match_the_jax_package():
    """The same numpy segment gives the same bytes in both packages, and
    each package's from_bytes reads the other's."""
    from paddle_tpu.serving import disagg as jdisagg

    seg = _segment(np.random.RandomState(7))
    jseg = jdisagg.KVSegment(seg.fingerprint, 17, 17, [41], 8, seg.layers,
                             logits=seg.logits, trace_id="t-1")
    buf = seg.to_bytes()
    assert jseg.to_bytes() == buf
    for back in (jdisagg.KVSegment.from_bytes(buf),
                 KVSegment.from_bytes(jseg.to_bytes())):
        assert (back.fingerprint, back.prompt_len, back.position,
                back.tokens, back.page_tokens, back.trace_id) == \
            (seg.fingerprint, 17, 17, [41], 8, "t-1")
        for (k0, v0), (k1, v1) in zip(seg.layers, back.layers):
            assert np.array_equal(k0, np.asarray(k1))
            assert np.array_equal(v0, np.asarray(v1))
        assert np.array_equal(np.asarray(back.logits), seg.logits)


def test_config_fingerprint_matches_the_jax_package():
    from paddle_tpu.serving import disagg as jdisagg

    for model, pt, sl, name, seed in (
            (MODEL, 8, 32, "llama", 0),
            (dict(MODEL, num_kv_heads=None), 16, 1024, "gen", 31)):
        assert config_fingerprint(model, pt, sl, name, seed) == \
            jdisagg.config_fingerprint(model, pt, sl, name, seed)
    eng = _build(autostart=False)
    try:
        assert eng.fingerprint() == jdisagg.config_fingerprint(
            MODEL, 8, 32, "llama", 0)
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# the router's prefill -> /adopt -> decode pipeline (twins of the router
# tests of tests/test_disagg.py)
# ---------------------------------------------------------------------------

def _mlp_predictor():
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.inference import Predictor

    main, startup = tpt.Program(), tpt.Program()
    startup._is_startup = True
    startup.random_seed = main.random_seed = 0
    with tpt.program_guard(main, startup):
        x = layers.data("x", [4])
        out = layers.fc(x, 4, name="dis_f")
    scope = tpt.Scope()
    tpt.Executor(tpt.CPUPlace()).run(startup, scope=scope)
    return Predictor(main, ["x"], [out], scope=scope, device="cpu")


def _replica(role, **over):
    from paddle_tpu_torch.serving import ServingEngine, serve

    gen = _build(role, **over)
    gen.warmup()
    eng = ServingEngine(_mlp_predictor(), workers=1)
    eng.attach_generator(gen)
    return serve(eng), gen


class _DyingDecodeStub(BaseHTTPRequestHandler):
    """Reports itself as a ready decode replica with zero load, then
    drops every /adopt connection after reading the body — the
    signature of the cache-holding replica dying mid-generation."""
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    def do_GET(self):
        body = json.dumps({
            "status": "ok", "ready": True, "role": "decode",
            "generation": {"paged": {"pages_live": 0}},
            "serving": {"queue_depth": 0, "inflight_rows": 0}}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0) or 0)
        self.rfile.read(n)
        self.connection.close()


def _stub_server():
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _DyingDecodeStub)
    httpd.daemon_threads = True
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _generate(url, prompt, n, stream=False):
    body = {"prompt": prompt, "max_new_tokens": n}
    if stream:
        body["stream"] = True
    req = urllib.request.Request(url + "/generate",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=120)


def test_router_disagg_pipeline_and_unrelated_ejection(colocated):
    """Through a live port router: plain and streamed /generate ride
    prefill -> adopt and equal the colocated engine's tokens (tolerance
    0); ejecting an UNRELATED replica mid-stream never disturbs the
    pinned decode, and no affinity_lost is counted."""
    from paddle_tpu_torch.serving import Router, RouterServer

    s_pre, _g_pre = _replica("prefill")
    s_dec, _g_dec = _replica("decode", max_new_tokens=24)
    s_other, _g_other = _replica("decode")
    router = Router([s_pre.url, s_dec.url, s_other.url],
                    poll_interval_ms=100.0, autostart=False)
    server = RouterServer(router).start()
    try:
        router.poll_once()
        assert router.disagg_active()
        hz = router.healthz()[1]
        assert hz["disagg"] and hz["roles"].get("prefill") == 1
        prompt = [3, 5, 7, 11, 13]
        want = colocated.generate(prompt, 6)
        with _generate(server.url, prompt, 6) as r:
            doc = json.loads(r.read())
        assert doc["tokens"] == want["tokens"]
        other_rep = router._replicas[s_other.url]
        toks, done = [], None
        with _generate(server.url, prompt, 6, stream=True) as r:
            for line in r:
                d = json.loads(line)
                if d.get("done"):
                    done = d
                else:
                    toks.append(d["token"])
                    with router._lock:
                        other_rep.ejected = True
        assert toks == want["tokens"], (toks, want["tokens"])
        assert done and done.get("error") is None
        assert done["tokens"] == want["tokens"]
        st = router.stats()["counters"]
        assert st["affinity_lost"] == 0
        assert st["disagg_generations"] == 2
    finally:
        server.close()
        router.close()
        for s in (s_pre, s_dec, s_other):
            s.close()


def test_affinity_lost_taxonomy_and_reprefill_flag(colocated):
    """The cache-holding decode replica dying mid-generation fails the
    request 502 ``affinity_lost``; with ``FLAGS_disagg_reprefill=1`` the
    router restarts the pipeline once on a surviving decode replica and
    the tokens stay the colocated engine's."""
    from paddle_tpu_torch.serving import Router, RouterServer

    s_pre, _g = _replica("prefill")
    stub_httpd, stub_url = _stub_server()
    prompt = [3, 5, 7, 11]
    want = colocated.generate(prompt, 4)
    router = Router([s_pre.url, stub_url], poll_interval_ms=100.0,
                    autostart=False)
    server = RouterServer(router).start()
    try:
        router.poll_once()
        with pytest.raises(urllib.error.HTTPError) as ei:
            _generate(server.url, prompt, 4)
        doc = json.loads(ei.value.read())
        assert ei.value.code == 502
        assert doc["reason"] == "affinity_lost"
        assert doc["error"] == "affinity_lost"
        st = router.stats()["counters"]
        assert st["affinity_lost"] == 1 and st["reprefills"] == 0
    finally:
        server.close()
        router.close()

    s_dec, _g2 = _replica("decode")
    old = tpt.get_flags("FLAGS_disagg_reprefill")["FLAGS_disagg_reprefill"]
    tpt.set_flags({"FLAGS_disagg_reprefill": "1"})
    router2 = Router([s_pre.url, stub_url, s_dec.url],
                     poll_interval_ms=100.0, autostart=False)
    server2 = RouterServer(router2).start()
    try:
        router2.poll_once()
        hit_stub = False
        for _ in range(4):
            with _generate(server2.url, prompt, 4) as r:
                doc = json.loads(r.read())
            assert doc["tokens"] == want["tokens"]
            if router2.stats()["counters"]["reprefills"]:
                hit_stub = True
                break
        assert hit_stub, "no request ever landed on the dying stub"
        assert router2.stats()["counters"]["affinity_lost"] >= 1
    finally:
        tpt.set_flags({"FLAGS_disagg_reprefill": old})
        server2.close()
        router2.close()
        s_pre.close()
        s_dec.close()
        stub_httpd.shutdown()


def test_decode_hop_requires_adopt_capability():
    """A dense 'both' replica never wins the adopt hop (its /adopt
    would 404): pick() filters on the paged generation block."""
    from paddle_tpu_torch.serving.router import _Replica

    r = _Replica("http://x:1")
    r.health = {"status": "ok", "ready": True, "role": "both",
                "generation": {"paged": None}}
    r.health_ts = time.monotonic()
    assert r.serves(None) and r.serves("prefill")
    assert not r.serves("decode")
    r.health["generation"] = {"paged": {"pages_live": 0}}
    assert r.serves("decode")
    r.health["role"] = "decode"
    assert r.serves("decode") and not r.serves("prefill")


def test_fleet_roles_validation():
    from paddle_tpu_torch.serving import FleetSupervisor

    with pytest.raises(ValueError, match="roles has"):
        FleetSupervisor(replicas=3, roles=["prefill"], autostart=False)
    with pytest.raises(ValueError, match="unknown role"):
        FleetSupervisor(roles=["prefill", "router"], autostart=False)
    with pytest.raises(NotImplementedError, match="item 8"):
        FleetSupervisor(roles=["embedding", "both"], autostart=False)
    sup = FleetSupervisor(roles=["prefill", "decode"], autostart=False)
    assert sup.n == 2
    assert [r.role for r in sup._replicas] == ["prefill", "decode"]
