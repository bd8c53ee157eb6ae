"""The port's block-paged KV cache on the CPU: the twins of
``tests/test_paged_generation.py``'s contracts inside the port, then the
port's paged engine against the JAX package's.

* **Paged ≡ dense at tolerance 0** — with chunking and prefix reuse off,
  the paged engine's token streams and every step's logits equal the
  dense engine's (``np.array_equal``) on ragged concurrent prompts across
  page boundaries (page - 1, page, page + 1 tokens).
* **Copy-on-write isolation** — borrowers of a shared header skip its
  prefill, decode the dense engine's streams, and leave the shared
  pages' bytes as they were.
* **Refcounts** — a finished slot returns its private pages; the prefix
  index's references stay until evicted.
* **Chunked prefill** — a long prompt pays out one chunk an iteration
  while a rider keeps decoding, both streams equal to the dense engine's.
* **Pool exhaustion** — ``cache_full`` with exactly ``usable_pages *
  page_tokens - prompt_len + 1`` tokens; a prefill that finds the pool
  full while another sequence holds pages goes back to the queue and
  succeeds later, with no failed request.
* **Against the JAX package** — the port's paged engine on the JAX paged
  engine's weights gives the same greedy streams, logits within atol
  1e-5 (the two sum their products in other orders).
"""
import time

import numpy as np
import pytest

from paddle_tpu_torch.interop import scope_from_arrays
from paddle_tpu_torch.ops.registry import reset_op_seed
from paddle_tpu_torch.serving import GenerationEngine, batcher
from paddle_tpu_torch.serving.generation import PagePool, PrefixIndex

# the reference test's GQA config (kv_heads < heads: the gathered view is
# read through the grouped queries)
MODEL = dict(vocab_size=61, hidden=32, num_layers=2, num_heads=4,
             num_kv_heads=2, intermediate=64)
PAGE = 16
BASE = dict(num_slots=3, max_seq_len=96, max_new_tokens=8,
            keep_logits=True, attn_impl="xla", seed=0, queue_cap=64,
            deadline_ms=600000.0, device="cpu")


@pytest.fixture(scope="module")
def dense_ref():
    """The dense engine; paged engines share its scope, so both sides
    bind the same weights."""
    reset_op_seed()
    eng = GenerationEngine(MODEL, paged=False, **BASE)
    yield eng
    eng.close()


def _paged(dense, **kw):
    args = dict(BASE, paged=True, page_tokens=PAGE, prefill_chunk=0,
                prefix_reuse=False)
    args.update(kw)
    return GenerationEngine(MODEL, scope=dense.scope, **args)


@pytest.fixture(scope="module")
def paged_ref(dense_ref):
    """A paged engine with prefix reuse on and chunking off, shared by
    the tests below; those that count pages drain the index first."""
    eng = _paged(dense_ref, prefix_reuse=True)
    yield eng
    eng.close()


def _drain_index(eng):
    while eng._prefix is not None and eng._prefix.evict_one():
        pass
    assert eng._pool.live_pages == 0


def _prompts(lens, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, MODEL["vocab_size"], size=n).tolist()
            for n in lens]


def test_chunk_spans():
    assert batcher.chunk_spans(0, 20, 8) == [(0, 8), (8, 16), (16, 20)]
    assert batcher.chunk_spans(32, 40, 8) == [(32, 40)]
    assert batcher.chunk_spans(5, 5, 8) == []
    assert batcher.chunk_spans(0, 20, 0) == [(0, 20)]


def test_page_pool_refcounts():
    pool = PagePool(5)  # pages 1..4 usable
    a, b = pool.alloc(), pool.alloc()
    assert {a, b} == {1, 2} and pool.free_pages == 2
    pool.incref([a])          # a shared (slot + index)
    pool.decref([a, b])       # the slot releases both
    assert pool.free_pages == 3 and pool.refcount(a) == 1
    pool.decref([a])          # the index releases a
    assert pool.free_pages == 4 and pool.live_pages == 0
    assert pool.alloc() is not None
    with pytest.raises(AssertionError, match="underflow"):
        PagePool(3).decref([1])
    with pytest.raises(ValueError):
        PagePool(1)           # no room beyond the trash page


def test_prefix_index_lookup_register_evict():
    pool = PagePool(8)
    idx = PrefixIndex(pool, 4)
    prompt = np.arange(1, 11, dtype="int64")     # 10 tokens, 2 full pages
    p0, p1 = pool.alloc(), pool.alloc()
    idx.register(prompt, [p0, p1])
    assert pool.refcount(p0) == 2 and pool.refcount(p1) == 2
    assert idx.lookup(np.arange(1, 14, dtype="int64")) == [p0, p1]
    other = np.arange(1, 14, dtype="int64")
    other[2] = 55
    assert idx.lookup(other) == []
    # at least one token must be left to prefill
    assert idx.lookup(np.arange(1, 6, dtype="int64")) == [p0]
    assert idx.lookup(np.arange(1, 5, dtype="int64")) == []
    pool.decref([p0, p1])     # the registering slot finishes
    assert pool.free_pages == 5
    assert idx.evict_one() and pool.free_pages == 6
    assert idx.evict_one() and pool.free_pages == 7
    assert not idx.evict_one()
    q0, q1 = pool.alloc(), pool.alloc()
    idx.register(prompt, [q0, q1])
    pool.decref([q0, q1])
    assert idx.flush() == 2 and len(idx) == 0
    assert pool.free_pages == 7 and pool.live_pages == 0


def test_paged_bitexact_concurrent_ragged(dense_ref, paged_ref):
    """page - 1 / page / page + 1 token prompts decode concurrently in
    the paged grid: every token and every step's logits equal the dense
    engine's."""
    eng = paged_ref
    prompts = _prompts((PAGE - 1, PAGE, PAGE + 1), seed=7)
    steps = [6, 5, 7]
    rd = [f.result(120) for f in
          [dense_ref.submit(p, n) for p, n in zip(prompts, steps)]]
    rp = [f.result(120) for f in
          [eng.submit(p, n) for p, n in zip(prompts, steps)]]
    for a, b in zip(rd, rp):
        assert a["tokens"] == b["tokens"]
        assert a["finish"] == b["finish"] == "length"
        for i, (la, lb) in enumerate(zip(a["logits"], b["logits"])):
            assert np.array_equal(la, lb), \
                f"step {i}: paged logits drifted (max |d| = " \
                f"{np.abs(la - lb).max()})"
    st = eng.stats()["paged"]
    assert st["pages_live"] == st["prefix_index_entries"]
    _drain_index(eng)


@pytest.mark.parametrize("lens", [(2, 31, 47), (64, 9, 80)],
                         ids=["short_mid_long", "long_short_longest"])
def test_paged_bitexact_three_page_spans(dense_ref, lens):
    """More ragged prompts, some crossing several pages, with long
    budgets that grow the block tables during decode: paged equals
    dense bit for bit, and every page goes back at the end."""
    eng = _paged(dense_ref)
    try:
        prompts = _prompts(lens, seed=sum(lens))
        rd = [f.result(120) for f in
              [dense_ref.submit(p, 12) for p in prompts]]
        rp = [f.result(120) for f in [eng.submit(p, 12) for p in prompts]]
        for a, b in zip(rd, rp):
            assert a["tokens"] == b["tokens"]
            assert all(np.array_equal(x, y)
                       for x, y in zip(a["logits"], b["logits"]))
        assert eng._pool.live_pages == 0
    finally:
        eng.close()


def test_prefix_reuse_cow_isolation(dense_ref, paged_ref):
    """Requests sharing a page-aligned header reuse its pages: the
    borrowers skip the header's prefill, decode the dense streams
    concurrently, and leave the shared pages' bytes unchanged."""
    eng = paged_ref
    _drain_index(eng)
    hits0 = eng.stats()["counters"]["prefix_hits"]
    header = _prompts((2 * PAGE,), seed=11)[0]
    tails = _prompts((7, 7, 7), seed=12)
    ra = eng.generate(header + tails[0], 6)
    refs = [dense_ref.generate(header + t, 6) for t in tails]
    assert ra["tokens"] == refs[0]["tokens"]
    assert eng.stats()["counters"]["prefix_hits"] == hits0
    idx_pages = sorted(p for p in range(1, eng.num_pages)
                       if eng._pool.refcount(p) > 0)
    assert len(idx_pages) == 2
    shared_before = eng.scope.find_var("llama.pool_k_0")[idx_pages].clone()
    tokens0 = eng.stats()["counters"]["prefill_tokens"]
    results = [f.result(120) for f in
               [eng.submit(header + t, 6) for t in tails[1:]]]
    for res, ref in zip(results, refs[1:]):
        assert res["tokens"] == ref["tokens"], \
            "a borrower's stream drifted: shared pages corrupted?"
        assert res["prefix_hit_tokens"] == 2 * PAGE
    st = eng.stats()["counters"]
    assert st["prefix_hits"] == hits0 + 2
    # only the tails were prefilled
    assert st["prefill_tokens"] - tokens0 == 2 * 7
    assert np.array_equal(
        eng.scope.find_var("llama.pool_k_0")[idx_pages].numpy(),
        shared_before.numpy()), \
        "a borrower's write reached a shared prefix page"


def test_refcount_release_on_reclaim(dense_ref, paged_ref):
    """Finished slots return every private page; only the index's
    references stay, and eviction releases those too."""
    eng = paged_ref
    _drain_index(eng)
    header = _prompts((PAGE,), seed=13)[0]
    for tail in _prompts((5, 5, 5), seed=14):
        eng.generate(header + tail, 4)
    st = eng.stats()["paged"]
    assert st["prefix_index_entries"] == 1
    assert st["pages_live"] == 1
    assert st["pages_free"] == eng.num_pages - 2
    assert eng.kv_live_bytes == eng.page_bytes
    _drain_index(eng)


def test_chunked_prefill_interleaves_decode(dense_ref):
    """A long prompt pays out in chunks while a rider keeps decoding:
    decode steps run between chunks, and both streams equal the dense
    engine's bit for bit (the rider's logits too)."""
    eng = _paged(dense_ref, prefill_chunk=8, max_new_tokens=64)
    try:
        rider_prompt, long_prompt = _prompts((4, 40), seed=17)
        rider_fut = eng.submit(rider_prompt, 36)
        deadline = time.monotonic() + 60
        while eng.stats()["counters"]["decode_steps"] < 3:
            assert time.monotonic() < deadline, "the rider never decoded"
            time.sleep(0.01)
        s0 = eng.stats()["counters"]
        long_res = eng.submit(long_prompt, 4).result(120)
        s1 = eng.stats()["counters"]
        chunks = s1["prefill_chunks"] - s0["prefill_chunks"]
        assert chunks == 5  # ceil(40 / 8)
        assert s1["decode_steps"] - s0["decode_steps"] >= chunks - 1
        rider_res = rider_fut.result(120)
        ref_long = dense_ref.generate(long_prompt, 4)
        rider_ref = dense_ref.generate(rider_prompt, 36)
        assert long_res["tokens"] == ref_long["tokens"]
        assert rider_res["tokens"] == rider_ref["tokens"], \
            "the rider's stream changed under interleaved chunks"
        assert all(np.array_equal(a, b) for a, b in
                   zip(rider_res["logits"], rider_ref["logits"]))
    finally:
        eng.close()


def test_pool_exhaustion_cache_full(dense_ref):
    """A budget beyond the pool finishes cache_full with exactly
    usable_pages * page_tokens - prompt_len + 1 tokens, and the freed
    pages serve the next request the same way."""
    eng = GenerationEngine(MODEL, scope=dense_ref.scope,
                           **dict(BASE, num_slots=1, keep_logits=False,
                                  paged=True, page_tokens=8, num_pages=5,
                                  prefill_chunk=0, prefix_reuse=False))
    try:
        prompt = list(range(1, 11))                      # 10 tokens
        capacity = (eng.num_pages - 1) * eng.page_tokens  # 32
        res = eng.generate(prompt, 500)
        assert res["finish"] == "cache_full"
        assert len(res["tokens"]) == capacity - len(prompt) + 1
        assert eng._pool.live_pages == 0
        res2 = eng.generate(prompt, 500)
        assert res2["finish"] == "cache_full"
        assert res2["tokens"] == res["tokens"]
    finally:
        eng.close()


def test_pool_stall_requeues_until_pages_free(dense_ref):
    """A prefill that finds the pool full while another sequence holds
    the pages goes back to the queue head (``pool_stalls``) and
    succeeds once that sequence finishes: no failed request."""
    eng = GenerationEngine(MODEL, scope=dense_ref.scope,
                           **dict(BASE, num_slots=2, max_seq_len=64,
                                  keep_logits=False, paged=True,
                                  page_tokens=8, num_pages=6,
                                  prefill_chunk=0, prefix_reuse=False,
                                  autostart=False))
    try:
        a_prompt, b_prompt = _prompts((10, 30), seed=19)
        fa = eng.submit(a_prompt, 24)
        fb = eng.submit(b_prompt, 4)
        eng.start()
        ra, rb = fa.result(120), fb.result(120)
        assert ra["finish"] == "length" and rb["finish"] == "length"
        assert rb["tokens"] == dense_ref.generate(b_prompt, 4)["tokens"]
        n = eng.stats()["counters"]
        assert n["pool_stalls"] >= 1
        assert n["failed"] == 0
    finally:
        eng.close()


def test_pool_that_cannot_hold_the_prompt_fails_it(dense_ref):
    """With the grid otherwise empty, a prompt the whole pool cannot
    hold fails (a retry could never succeed) and frees its pages."""
    eng = GenerationEngine(MODEL, scope=dense_ref.scope,
                           **dict(BASE, num_slots=1, keep_logits=False,
                                  paged=True, page_tokens=8, num_pages=3,
                                  prefill_chunk=0, prefix_reuse=False))
    try:
        with pytest.raises(Exception, match="exhausted"):
            eng.generate(list(range(1, 31)), 2, timeout=60)
        assert eng._pool.live_pages == 0
        assert eng.generate([1, 2, 3], 2, timeout=60)["finish"] == "length"
    finally:
        eng.close()


def test_paged_warmup_and_captures(dense_ref):
    """warmup() runs the decode step and every paged prefill bucket
    (chunking off) or chunk bucket (prefix reuse or chunking on) twice,
    writing only the trash page; introspect lists each program."""
    eng = _paged(dense_ref, prefix_reuse=True, prefill_chunk=16,
                 autostart=False)
    try:
        pool0 = eng.scope.find_var("llama.pool_k_0")
        before = pool0[1:].clone()
        chunk_buckets = [b for b in eng.prefill_buckets if b <= 16]
        assert eng.warmup() == len(chunk_buckets) + 1
        assert set(eng.introspect()["captures"]) == \
            {"decode"} | {f"chunk{b}" for b in chunk_buckets}
        assert np.array_equal(pool0[1:].numpy(), before.numpy())
        assert eng.scope.find_var("llama.pool_k_0") is pool0
        assert eng.stats()["counters"]["prefills"] == 0
    finally:
        eng.close()


def test_paged_config_validation():
    with pytest.raises(ValueError, match="power of two"):
        GenerationEngine(MODEL, num_slots=1, max_seq_len=96,
                         autostart=False, paged=True, page_tokens=12,
                         device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        GenerationEngine(MODEL, num_slots=1, max_seq_len=100,
                         autostart=False, paged=True, page_tokens=16,
                         device="cpu")
    with pytest.raises(ValueError, match="trash page"):
        GenerationEngine(MODEL, num_slots=1, max_seq_len=96,
                         autostart=False, paged=True, page_tokens=16,
                         num_pages=1, device="cpu")
    eng = GenerationEngine(MODEL, num_slots=2, max_seq_len=96,
                           autostart=False, paged=True, page_tokens=16,
                           device="cpu")
    try:
        st = eng.stats()["paged"]
        # num_pages auto: slots x pages_per_slot + the trash page; the
        # reference's flag defaults: prefix reuse on, chunking off
        assert st["num_pages"] == 2 * (96 // 16) + 1
        assert st["prefix_reuse"] is True and st["prefill_chunk"] == 0
        assert eng.kv_cache_bytes == st["num_pages"] * st["page_bytes"]
    finally:
        eng.close()


def test_paged_greedy_streams_match_the_jax_engine():
    """The JAX paged engine and the port's on its weights, three
    concurrent ragged requests across page boundaries: the same greedy
    streams, every step's logits within atol 1e-5."""
    import paddle_tpu.serving as jserving

    kw = dict(num_slots=3, max_seq_len=96, max_new_tokens=8,
              keep_logits=True, attn_impl="xla", seed=0, queue_cap=64,
              deadline_ms=600000.0, paged=True, page_tokens=PAGE,
              prefill_chunk=0, prefix_reuse=False)
    j_eng = jserving.GenerationEngine(MODEL, **kw)
    prompts = _prompts((PAGE - 1, PAGE + 1, 2 * PAGE + 3), seed=23)
    steps = [6, 4, 7]
    try:
        want = [f.result(300) for f in
                [j_eng.submit(p, n) for p, n in zip(prompts, steps)]]
        arrays = {n: np.asarray(j_eng.scope.find_var(n))
                  for n in j_eng.scope.local_var_names()
                  if n not in j_eng.cache_names}
    finally:
        j_eng.close()
    eng = GenerationEngine(MODEL, scope=scope_from_arrays(arrays, "cpu"),
                           device="cpu", **kw)
    try:
        got = [f.result(120) for f in
               [eng.submit(p, n) for p, n in zip(prompts, steps)]]
    finally:
        eng.close()
    for g, w in zip(got, want):
        assert g["tokens"] == w["tokens"] and g["finish"] == w["finish"]
        for gl, wl in zip(g["logits"], w["logits"]):
            np.testing.assert_allclose(gl, np.asarray(wl), rtol=0,
                                       atol=1e-5)


def test_paged_flags_configure_the_engine():
    """FLAGS_serving_paged / _kv_page_tokens / _kv_pages / _prefix_reuse /
    _prefill_chunk, with the reference's defaults (off, 16, 0 = auto, on,
    0), configure an engine built without the arguments."""
    import paddle_tpu_torch as tpt

    names = ["FLAGS_serving_paged", "FLAGS_serving_kv_page_tokens",
             "FLAGS_serving_kv_pages", "FLAGS_serving_prefix_reuse",
             "FLAGS_serving_prefill_chunk"]
    saved = tpt.get_flags(names)
    assert saved == dict(zip(names, [False, 16, 0, True, 0]))
    try:
        tpt.set_flags({"FLAGS_serving_paged": True,
                       "FLAGS_serving_kv_page_tokens": 8,
                       "FLAGS_serving_kv_pages": 7,
                       "FLAGS_serving_prefix_reuse": False,
                       "FLAGS_serving_prefill_chunk": 16})
        eng = GenerationEngine(MODEL, num_slots=1, max_seq_len=32,
                               autostart=False, device="cpu")
        st = eng.stats()["paged"]
        eng.close()
        assert (st["page_tokens"], st["num_pages"], st["prefix_reuse"],
                st["prefill_chunk"]) == (8, 7, False, 16)
    finally:
        tpt.set_flags(saved)
