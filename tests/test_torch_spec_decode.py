"""The port's speculative decoding on the CPU: the twins of
``tests/test_spec_decode.py``'s contracts inside the port, then the port
against the JAX package.

* **Speculative ≡ plain at tolerance 0** — a speculating paged engine's
  token streams and every step's logits equal the port's dense engine's
  (``np.array_equal``; paged ≡ dense holds in the port) at page - 1 /
  page / page + 1 prompt lengths, with speculating and opted-out slots
  in one grid, and through prefix-index hits.  The reference fails its
  own bit-exact speculative tests on the CPU (XLA's CPU GEMM tiles by
  shape), so the port holds this against itself.
* **Drafter** — the longest suffix n-gram wins, the last earlier
  occurrence wins, a miss or a degenerate history proposes nothing.
* **Rollback accounting** — rejected drafts give their pages back; the
  pool drains to 0 live pages, also when it runs out mid-draft.
* **Opt-out** — ``submit(..., speculate=False)`` drafts nothing.
* **Verify rows ≡ decode rows** — every op of the verify program, row t,
  equals the paged decode step's row at ``base + t`` at tolerance 0
  (``probe_decode_rows.verify_rows``, the CPU twin of its card run).
* **Against the JAX package** — ``ngram_draft`` gives the reference's
  drafts on 200 seeded histories; the port's speculating engine on the
  JAX paged engine's weights gives the JAX plain paged engine's greedy
  streams, logits within atol 1e-5 (the two sum their products in other
  orders).

Engines share the dense reference's scope, so both sides bind the same
weights; two paged engines sharing a scope share its pools, so they run
one after the other, never at once.  The ``cuda``-marked twins run the
three bit-exact tests on the card and skip here.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from paddle_tpu_torch.interop import scope_from_arrays
from paddle_tpu_torch.ops.registry import reset_op_seed
from paddle_tpu_torch.serving import GenerationEngine
from paddle_tpu_torch.serving.generation import ngram_draft

MODEL = dict(vocab_size=61, hidden=32, num_layers=2, num_heads=4,
             num_kv_heads=2, intermediate=64)
PAGE = 8
BASE = dict(num_slots=3, max_seq_len=96, max_new_tokens=8, keep_logits=True,
            attn_impl="xla", seed=0, queue_cap=64, deadline_ms=600000.0)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _device(request):
    """The CPU, or the card for the cuda-marked twins (which skip
    without one)."""
    if request.node.get_closest_marker("cuda") is None:
        return "cpu"
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


@pytest.fixture
def dense_ref(request):
    """The dense, non-speculating engine; speculating engines share its
    scope."""
    reset_op_seed()
    eng = GenerationEngine(MODEL, paged=False, device=_device(request),
                           **BASE)
    yield eng
    eng.close()


def _spec(dense, **kw):
    args = dict(BASE, paged=True, page_tokens=PAGE, prefill_chunk=0,
                prefix_reuse=False, speculate=True, spec_tokens=4,
                spec_ngram=3, device=dense.device)
    args.update(kw)
    return GenerationEngine(MODEL, scope=dense.scope, **args)


def _repetitive(rng, n, period=4):
    """A prompt of period `period`: every suffix n-gram occurred before,
    so the drafter proposes every round."""
    pattern = rng.randint(1, MODEL["vocab_size"], size=period).tolist()
    return (pattern * (n // period + 1))[:n]


# ---------------------------------------------------------------------------
# the drafter
# ---------------------------------------------------------------------------

def test_ngram_draft_hit():
    # suffix [2, 3] occurred at index 1; what followed it is the draft
    assert ngram_draft([1, 2, 3, 4, 2, 3], 3, 3) == [4, 2, 3]
    assert ngram_draft([1, 2, 3, 4, 2, 3], 1, 3) == [4]


def test_ngram_draft_last_occurrence_wins():
    # [1, 2] at 0 (then 9) and at 3 (then 7): the later one wins
    assert ngram_draft([1, 2, 9, 1, 2, 7, 1, 2], 1, 2) == [7]


def test_ngram_draft_longest_ngram_first():
    # the trigram [9, 1, 2] at index 2 beats the later bigram match
    h = [5, 9, 1, 2, 8, 1, 2, 6, 9, 1, 2]
    assert ngram_draft(h, 1, 3) == [8]


def test_ngram_draft_miss_and_guards():
    assert ngram_draft([1, 2, 3], 3, 3) == []     # no recurrence
    assert ngram_draft([1, 2, 3, 4], 0, 3) == []  # k < 1
    assert ngram_draft([7], 3, 3) == []           # history too short
    assert ngram_draft([], 3, 3) == []


def test_ngram_draft_degenerate_repetition():
    # [5, 5, 5, 5]: the suffix trigram matches at 0 and one token
    # follows it: a short draft, not a self-match without end
    assert ngram_draft([5, 5, 5, 5], 4, 3) == [5]


# ---------------------------------------------------------------------------
# speculative ≡ plain, tolerance 0
# ---------------------------------------------------------------------------

def _assert_streams_equal(ref_results, got_results):
    for a, b in zip(ref_results, got_results):
        assert a["tokens"] == b["tokens"]
        assert a["finish"] == b["finish"]
        assert len(a["logits"]) == len(b["logits"])
        for i, (la, lb) in enumerate(zip(a["logits"], b["logits"])):
            assert np.array_equal(la, lb), \
                f"step {i}: speculative logits drifted (max |d|=" \
                f"{np.abs(la - lb).max()})"


def _concurrent_ragged(dense_ref):
    rng = np.random.RandomState(11)
    prompts = [_repetitive(rng, n) for n in (PAGE - 1, PAGE, PAGE + 1)]
    steps = [6, 5, 7]
    rd = [f.result(120) for f in
          [dense_ref.submit(p, n) for p, n in zip(prompts, steps)]]
    eng = _spec(dense_ref)
    try:
        rs = [f.result(120) for f in
              [eng.submit(p, n) for p, n in zip(prompts, steps)]]
        _assert_streams_equal(rd, rs)
        sp = eng.stats()["speculate"]
        assert sp["drafts"] > 0 and sp["tokens_proposed"] > 0
        assert sp["tokens_accepted"] <= sp["tokens_proposed"]
        assert eng._pool.live_pages == 0
    finally:
        eng.close()


def _mixed_slots(dense_ref):
    rng = np.random.RandomState(13)
    prompts = [_repetitive(rng, n) for n in (PAGE - 1, PAGE + 1, 12)]
    steps = [7, 6, 7]
    flags = [None, False, None]  # slot 1 opts out, in the same grid
    rd = [f.result(120) for f in
          [dense_ref.submit(p, n) for p, n in zip(prompts, steps)]]
    eng = _spec(dense_ref)
    try:
        rs = [f.result(120) for f in
              [eng.submit(p, n, speculate=sp)
               for p, n, sp in zip(prompts, steps, flags)]]
        _assert_streams_equal(rd, rs)
        assert eng.stats()["speculate"]["drafts"] > 0
    finally:
        eng.close()


def _prefix_hits(dense_ref):
    rng = np.random.RandomState(17)
    header = _repetitive(rng, 2 * PAGE)  # two whole shared pages
    prompts = [header + _repetitive(rng, 5) for _ in range(3)]
    steps = [6, 6, 6]
    rd = [dense_ref.generate(p, n, timeout=120)
          for p, n in zip(prompts, steps)]

    def run(speculate):
        eng = _spec(dense_ref, prefix_reuse=True, speculate=speculate)
        try:
            # one at a time: a prompt registers its pages when its
            # prefill completes, so the later ones hit the index
            out = [eng.generate(p, n, timeout=120)
                   for p, n in zip(prompts, steps)]
            return out, eng.stats()
        finally:
            eng.close()

    plain, st_plain = run(False)
    spec, st_spec = run(True)
    _assert_streams_equal(rd, plain)
    _assert_streams_equal(rd, spec)
    assert st_plain["counters"]["prefix_hits"] > 0
    assert st_spec["counters"]["prefix_hits"] > 0
    assert st_spec["speculate"]["drafts"] > 0


def test_spec_bitexact_concurrent_ragged(dense_ref):
    """Repetitive prompts of page - 1 / page / page + 1 tokens decode
    together with speculation on: every stream and every step's logits
    bit-equal to the dense engine's, the drafter fired, the pool
    drained."""
    _concurrent_ragged(dense_ref)


def test_spec_bitexact_mixed_slots(dense_ref):
    """Speculating and opted-out slots decode in one grid (the grid step
    skips the slots the round advanced): every stream equals the dense
    engine's."""
    _mixed_slots(dense_ref)


def test_spec_bitexact_prefix_hits(dense_ref):
    """Streams riding prefix-index hits (shared pages, the tail through
    the chunk program) speculate bit for bit: the plain paged engine and
    the speculating one both give the dense engine's tokens and
    logits."""
    _prefix_hits(dense_ref)


@pytest.mark.cuda
def test_spec_bitexact_concurrent_ragged_cuda(dense_ref):
    """test_spec_bitexact_concurrent_ragged on the card: the product and
    RMSNorm kernels keep the verify rows equal to the decode rows."""
    _concurrent_ragged(dense_ref)


@pytest.mark.cuda
def test_spec_bitexact_mixed_slots_cuda(dense_ref):
    _mixed_slots(dense_ref)


@pytest.mark.cuda
def test_spec_bitexact_prefix_hits_cuda(dense_ref):
    _prefix_hits(dense_ref)


# ---------------------------------------------------------------------------
# rollback accounting
# ---------------------------------------------------------------------------

def test_spec_rollback_refcount_balance(dense_ref):
    """Rejected drafts give their pages back: rollbacks fire (random
    prompts over 3 token ids: n-grams recur, their continuations seldom
    do), accepted <= proposed, and the pool drains to 0 live pages."""
    rng = np.random.RandomState(19)
    eng = _spec(dense_ref)
    try:
        for n in (PAGE - 1, PAGE, PAGE + 1, 12):
            eng.generate(_repetitive(rng, n), 8, timeout=120)
            eng.generate(rng.randint(1, 4, size=n).tolist(), 8,
                         timeout=120)
        sp = eng.stats()["speculate"]
        assert sp["drafts"] > 0
        assert 1 <= sp["rollbacks"] <= sp["drafts"]
        assert sp["tokens_accepted"] <= sp["tokens_proposed"]
        assert 0.0 <= sp["acceptance_rate"] <= 1.0
        assert eng._pool.live_pages == 0
    finally:
        eng.close()


def test_spec_pool_exhaustion_mid_draft(dense_ref):
    """A draft that cannot get pages rides the plain step, which finishes
    the sequence ``cache_full`` at exactly the plain engine's point with
    its tokens; the freed pages then serve the next request."""
    def run(speculate):
        eng = GenerationEngine(
            MODEL, scope=dense_ref.scope, num_slots=1, max_seq_len=96,
            attn_impl="xla", seed=0, queue_cap=64, deadline_ms=600000.0,
            paged=True, page_tokens=PAGE, num_pages=5, prefill_chunk=0,
            prefix_reuse=False, speculate=speculate, spec_tokens=4,
            spec_ngram=3, device="cpu")
        try:
            prompt = _repetitive(np.random.RandomState(23), 10)
            res = eng.generate(prompt, 500, timeout=120)
            live = eng._pool.live_pages
            res2 = eng.generate(prompt, 500, timeout=120)
            return res, live, res2, eng.stats()["speculate"]
        finally:
            eng.close()

    res_p, live_p, res2_p, _ = run(False)
    res_s, live_s, res2_s, sp = run(True)
    capacity = 4 * PAGE  # num_pages - 1 usable: page 0 is the trash page
    assert res_p["finish"] == res_s["finish"] == "cache_full"
    assert len(res_p["tokens"]) == capacity - 10 + 1
    assert res_s["tokens"] == res_p["tokens"]
    assert live_p == live_s == 0
    assert res2_s["tokens"] == res2_p["tokens"] == res_p["tokens"]
    assert sp["drafts"] > 0  # speculation ran before the pool ran dry


def test_spec_per_request_opt_out(dense_ref):
    """speculate=False on a speculating engine: no draft, the dense
    engine's stream."""
    prompt = _repetitive(np.random.RandomState(29), PAGE + 2)
    ref = dense_ref.generate(prompt, 7, timeout=120)
    eng = _spec(dense_ref)
    try:
        res = eng.submit(prompt, 7, speculate=False).result(120)
        assert res["tokens"] == ref["tokens"]
        sp = eng.stats()["speculate"]
        assert sp["drafts"] == 0 and sp["tokens_proposed"] == 0
    finally:
        eng.close()


def test_spec_warmup_captures_and_config():
    """warmup() builds the verify bucket (one, "verify8", at the default
    four draft tokens) beside the paged programs; speculation needs the
    paged cache and positive draft sizes."""
    reset_op_seed()
    eng = GenerationEngine(MODEL, autostart=False, device="cpu",
                           **dict(BASE, paged=True, page_tokens=PAGE,
                                  prefill_chunk=0, prefix_reuse=False,
                                  speculate=True))
    try:
        assert eng._verify_buckets() == [8]
        assert eng.warmup() == len(eng.prefill_buckets) + 2
        assert "verify8" in eng.introspect()["captures"]
        st = eng.stats()["speculate"]
        assert (st["spec_tokens"], st["spec_ngram"]) == (4, 3)
    finally:
        eng.close()
    with pytest.raises(ValueError, match="paged"):
        GenerationEngine(MODEL, autostart=False, device="cpu",
                         **dict(BASE, paged=False, speculate=True))
    for kw in (dict(spec_tokens=0), dict(spec_ngram=0)):
        with pytest.raises(ValueError, match="must be >= 1"):
            GenerationEngine(MODEL, autostart=False, device="cpu",
                             **dict(BASE, paged=True, page_tokens=PAGE,
                                    speculate=True, **kw))


def test_verify_rows_equal_decode_rows():
    """Every op of the verify program, row t, equals the paged decode
    step's row at base + t at tolerance 0 (GQA at rep 2: a decode step's
    grouped products have 2 rows, the verify's 16)."""
    spec = importlib.util.spec_from_file_location(
        "probe_decode_rows", os.path.join(REPO, "probe_decode_rows.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    report = probe.verify_rows(MODEL, torch.device("cpu"))
    ops = {r["op"] for r in report}
    assert {"rope", "cached_attention", "kv_pool_gather", "mul",
            "rms_norm"} <= ops
    assert {r["row"] for r in report} == set(range(probe.VERIFY_ROWS))
    bad = [r for r in report if r["max_abs_diff"] != 0]
    assert not bad, bad[:3]


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def test_ngram_draft_matches_the_jax_package():
    from paddle_tpu.serving.generation import ngram_draft as jax_draft

    rng = np.random.RandomState(41)
    for _ in range(200):
        n = int(rng.randint(0, 40))
        h = rng.randint(1, int(rng.randint(2, 8)), size=n)
        k, g = int(rng.randint(0, 6)), int(rng.randint(1, 5))
        assert ngram_draft(h, k, g) == jax_draft(h, k, g), (h, k, g)


def test_spec_greedy_streams_match_the_jax_plain_engine():
    """The JAX plain paged engine and the port's speculating engine on its
    weights, three concurrent repetitive requests: the same greedy
    streams, every step's logits within atol 1e-5."""
    import paddle_tpu.serving as jserving

    kw = dict(BASE, paged=True, page_tokens=PAGE, prefill_chunk=0,
              prefix_reuse=False)
    j_eng = jserving.GenerationEngine(MODEL, **kw)
    rng = np.random.RandomState(43)
    prompts = [_repetitive(rng, n) for n in (PAGE - 1, PAGE + 1, 2 * PAGE)]
    steps = [6, 7, 8]
    try:
        want = [f.result(300) for f in
                [j_eng.submit(p, n) for p, n in zip(prompts, steps)]]
        arrays = {n: np.asarray(j_eng.scope.find_var(n))
                  for n in j_eng.scope.local_var_names()
                  if n not in j_eng.cache_names}
    finally:
        j_eng.close()
    eng = GenerationEngine(MODEL, scope=scope_from_arrays(arrays, "cpu"),
                           device="cpu", speculate=True, spec_tokens=4,
                           spec_ngram=3, **kw)
    try:
        got = [f.result(120) for f in
               [eng.submit(p, n) for p, n in zip(prompts, steps)]]
        assert eng.stats()["speculate"]["drafts"] > 0
    finally:
        eng.close()
    for g, w in zip(got, want):
        assert g["tokens"] == w["tokens"] and g["finish"] == w["finish"]
        assert len(g["logits"]) == len(w["logits"])
        for gl, wl in zip(g["logits"], w["logits"]):
            np.testing.assert_allclose(gl, np.asarray(wl), rtol=0,
                                       atol=1e-5)
