"""The port's generation serving (``paddle_tpu_torch.serving``) on the CPU:
the twins of ``tests/test_generation.py``'s contracts inside the port,
then the port against the JAX package's engine.

* **Tolerance 0 inside the port** — cached decode logits equal the
  uncached ``build_llama_forward(..., attn_impl="xla")`` at
  ``max_seq_len``, step for step (``np.array_equal``), with three ragged
  prompts decoding concurrently, and at one slot (where the decode step's
  products have one row).
* The finishes (``eos``, ``length``, ``cache_full`` with exactly
  ``max_seq_len - len(prompt) + 1`` tokens), prompt validation, the
  ``queue_full`` / ``draining`` / ``deadline`` sheds, prefill and
  decode-step failure containment, and continuous against static
  batching counted in decode steps (not wall time).
* **Against the JAX package** — the port's engine on the JAX engine's
  weights (copied with ``interop.scope_from_arrays``) gives the same
  greedy token streams and logits within atol 1e-5 (the reference's own
  cached decode drifts ~4.5e-7 from its uncached forward on the CPU).
"""
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tpt
from paddle_tpu_torch import fault
from paddle_tpu_torch.interop import scope_from_arrays
from paddle_tpu_torch.models.llama import build_llama_forward
from paddle_tpu_torch.ops.registry import reset_op_seed
from paddle_tpu_torch.serving import (GenerationEngine, OverloadedError,
                                      RequestFailed, batcher)

# tiny GQA config, as tests/test_generation.py's (kv_heads < heads so the
# grouped cache reads are under test, not just MHA)
MODEL = dict(vocab_size=61, hidden=32, num_layers=2, num_heads=4,
             num_kv_heads=2, intermediate=64)
ENGINE = dict(max_seq_len=48, max_new_tokens=8, keep_logits=True,
              attn_impl="xla", seed=0, queue_cap=64, deadline_ms=600000.0,
              device="cpu")


def _engine(**kw):
    return GenerationEngine(MODEL, **dict(ENGINE, **kw))


@pytest.fixture(scope="module")
def gen_engine():
    """Shared engine: 3 slots, keep_logits, the einsum attention; its
    weights drawn after an op-seed reset, whatever ran before."""
    reset_op_seed()
    eng = _engine(num_slots=3)
    yield eng
    eng.close()


def _reference_logits(eng, token_ids):
    """The uncached forward over ``token_ids``, right-padded to the
    engine's max_seq_len, on the engine's weights: [S, V] logits."""
    S = eng.max_seq_len
    main, startup = tpt.Program(), tpt.Program()
    startup._is_startup = True
    with tpt.program_guard(main, startup):
        _feeds, fetches = build_llama_forward(
            1, S, name=eng.name, attn_impl="xla", **MODEL)
    padded = np.zeros((S,), "int64")
    padded[:len(token_ids)] = token_ids
    return tpt.Executor(tpt.CPUPlace()).run(
        main, feed={"input_ids": padded[None]},
        fetch_list=[fetches["logits"]], scope=eng.scope)[0][0]


def _prompts(lens, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, MODEL["vocab_size"], size=n).tolist()
            for n in lens]


def _assert_bitexact(eng, prompt, res):
    ref = _reference_logits(eng, prompt + res["tokens"][:-1])
    for i, got in enumerate(res["logits"]):
        want = ref[len(prompt) - 1 + i]
        assert np.array_equal(got, want), \
            f"step {i}: cached decode drifted from the uncached forward " \
            f"(max |d| = {np.abs(got - want).max()})"
    assert res["tokens"] == [int(np.argmax(ref[len(prompt) - 1 + i]))
                             for i in range(len(res["tokens"]))]


# ---------------------------------------------------------------------------
# batcher (the port's copy)
# ---------------------------------------------------------------------------

def test_prompt_bucket_policy():
    assert batcher.prompt_buckets(64) == (8, 16, 32, 64)
    assert batcher.prompt_buckets(48) == (8, 16, 32, 48)
    assert batcher.prompt_buckets(64, buckets=[16, 64]) == (16, 64)
    assert batcher.prompt_bucket_for(9, (8, 16, 32)) == 16
    assert batcher.prompt_bucket_for(8, (8, 16, 32)) == 8
    with pytest.raises(ValueError):
        batcher.prompt_bucket_for(33, (8, 16, 32))
    with pytest.raises(ValueError):
        batcher.prompt_buckets(64, buckets=[16, 128])  # > max_len


def test_pad_prompt_and_split_rows():
    ids = np.arange(1, 6)
    padded = batcher.pad_prompt(ids, 8)
    assert padded.shape == (8,) and padded.dtype == np.int64
    assert np.array_equal(padded[:5], ids) and np.all(padded[5:] == 0)
    with pytest.raises(ValueError):
        batcher.pad_prompt(np.arange(9), 8)
    reqs = [(batcher.pad_prompt(np.arange(1, n + 1), 16)[None]
             .repeat(rows, 0),) for n, rows in ((3, 1), (9, 3), (14, 2))]
    stacked, real = batcher.pad_stack(reqs, 8)
    assert real == 6 and np.array_equal(stacked[0][6], stacked[0][0])
    split = batcher.split_rows([stacked[0] * 2], [1, 3, 2])
    for req, got in zip(reqs, split):
        assert np.array_equal(got[0], req[0] * 2)


# ---------------------------------------------------------------------------
# tolerance 0: cached decode == uncached forward
# ---------------------------------------------------------------------------

def test_cached_decode_bitexact_concurrent_ragged(gen_engine):
    """Three prompts of ragged lengths (buckets 8, 16, 16) decode
    concurrently, each slot at its own position every step, and every
    step's logits equal the request's own uncached forward bit for bit."""
    eng = gen_engine
    prompts = _prompts((3, 9, 14), seed=7)
    steps = [6, 4, 7]
    futs = [eng.submit(p, n) for p, n in zip(prompts, steps)]
    results = [f.result(120) for f in futs]
    for prompt, n, res in zip(prompts, steps, results):
        assert res["finish"] == "length" and res["steps"] == n - 1
        assert len(res["tokens"]) == n == len(res["logits"])
        _assert_bitexact(eng, prompt, res)


def test_cached_decode_bitexact_one_slot():
    """One slot: the decode step's products have one row, which the port
    computes as the first of two (the GEMM rows of the uncached
    forward); two requests queue through the slot in turn."""
    eng = _engine(num_slots=1)
    try:
        prompts = _prompts((5, 12), seed=9)
        futs = [eng.submit(p, 6) for p in prompts]
        for prompt, f in zip(prompts, futs):
            res = f.result(120)
            assert res["finish"] == "length" and len(res["tokens"]) == 6
            _assert_bitexact(eng, prompt, res)
    finally:
        eng.close()


def test_cache_writes_stay_in_place(gen_engine):
    """Prefill and decode write the scope's own cache tensors: each keeps
    its object and data_ptr across requests."""
    eng = gen_engine
    before = {n: eng.scope.find_var(n) for n in eng.cache_names}
    ptrs = {n: t.data_ptr() for n, t in before.items()}
    eng.generate([4, 8, 15, 16, 23], 5)
    for n, t in before.items():
        assert eng.scope.find_var(n) is t and t.data_ptr() == ptrs[n]


def test_eos_frees_slot(gen_engine):
    """EOS finish: a known stream re-run with eos_id set to its first
    token after the first that has not come before stops there with
    finish 'eos', and the slot serves the next request."""
    eng = gen_engine
    prompt = [5, 11, 2, 9]
    base = eng.generate(prompt, 8)
    assert base["finish"] == "length"
    toks = base["tokens"]
    i = next(i for i in range(1, len(toks)) if toks[i] not in toks[:i])
    old = eng.eos_id
    try:
        eng.eos_id = toks[i]
        res = eng.generate(prompt, 8)
    finally:
        eng.eos_id = old
    assert res["finish"] == "eos"
    assert res["tokens"] == toks[:i + 1]
    assert eng.generate(prompt, 8)["tokens"] == toks


def test_cache_full_finish(gen_engine):
    """A budget beyond the cache decodes until the slot's cache fills:
    exactly max_seq_len - len(prompt) + 1 tokens, the last step's cache
    row at max_seq_len - 1 (the guard fires before a write could clamp
    onto the last row), and that step's logits still bit-exact."""
    eng = gen_engine
    prompt = [5, 11, 2]
    res = eng.generate(prompt, eng.max_seq_len * 2)
    assert res["finish"] == "cache_full"
    assert len(res["tokens"]) == eng.max_seq_len - len(prompt) + 1
    ref = _reference_logits(eng, prompt + res["tokens"][:-1])
    assert np.array_equal(res["logits"][-1],
                          ref[len(prompt) - 1 + len(res["tokens"]) - 1])


def test_prompt_validation(gen_engine):
    with pytest.raises(ValueError):
        gen_engine.submit([])
    with pytest.raises(ValueError):
        gen_engine.submit([[1, 2], [3, 4]])
    with pytest.raises(ValueError):
        gen_engine.submit([0.5, 1.5])
    with pytest.raises(ValueError):  # beyond the largest prefill bucket
        gen_engine.submit(list(range(1, gen_engine.max_prompt_len + 2)))


def test_introspection(gen_engine):
    eng = gen_engine
    eng.generate([1, 2, 3], 3)
    s = eng.stats()
    assert s["slots"] == 3 and s["queue_cap"] == 64
    assert s["counters"]["served"] >= 1
    assert s["counters"]["decode_steps"] > 0
    assert s["decode_step_ms"]["count"] == s["counters"]["decode_steps"]
    head_dim = MODEL["hidden"] // MODEL["num_heads"]
    want = (3 * MODEL["num_kv_heads"] * 48 * head_dim * 4
            * 2 * MODEL["num_layers"])
    assert eng.kv_cache_bytes == want == s["kv_cache_bytes"]
    intro = eng.introspect()
    assert intro["decode_executables"]["entries"]
    assert set(intro["captures"]) >= {"decode", 8}
    # on the CPU nothing is captured
    assert all(c == [0] for c in intro["captures"].values())


def test_warmup_runs_every_program_twice():
    eng = _engine(num_slots=2, autostart=False)
    try:
        assert eng.warmup() == len(eng.prefill_buckets) + 1
        assert eng.stats()["counters"]["prefills"] == 0  # not requests
        assert set(eng.introspect()["prefill_executables"]) == \
            set(eng.prefill_buckets)
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# continuous against static batching, in decode steps
# ---------------------------------------------------------------------------

def _run_workload(continuous):
    """Three short sequences and one long per claim group of four, all
    queued before the scheduler starts, so the claim order (and the
    static grouping) is exact.  The op-seed counter is reset first, so
    both engines draw the same weights."""
    reset_op_seed()
    eng = _engine(num_slots=4, max_seq_len=96, max_new_tokens=88,
                  continuous=continuous, autostart=False, keep_logits=False)
    prompts, lens = [], []
    rng = np.random.RandomState(3)
    for _g in range(4):
        for n in (2, 2, 2, 88):
            prompts.append(rng.randint(1, MODEL["vocab_size"],
                                       size=4).tolist())
            lens.append(n)
    futs = [eng.submit(p, n) for p, n in zip(prompts, lens)]
    eng.start()
    results = [f.result(300) for f in futs]
    stats = eng.stats()
    eng.close()
    assert sum(len(r["tokens"]) for r in results) == sum(lens)
    return [r["tokens"] for r in results], stats


def test_continuous_over_static_in_decode_steps():
    """Static batching pays the longest sequence of each group of four;
    continuous batching reclaims the short ones' slots: over 2x fewer
    decode steps for the same tokens (the same streams, since each
    slot's rows are independent of the others')."""
    static_tokens, st_static = _run_workload(False)
    cont_tokens, st_cont = _run_workload(True)
    steps_static = st_static["counters"]["decode_steps"]
    steps_cont = st_cont["counters"]["decode_steps"]
    assert steps_static >= 2 * steps_cont, (steps_static, steps_cont)
    assert st_cont["counters"]["slot_reclaims"] > 0
    assert st_static["counters"]["slot_reclaims"] == 0
    assert cont_tokens == static_tokens


# ---------------------------------------------------------------------------
# admission control, sheds and failure containment
# ---------------------------------------------------------------------------

def test_queue_full_and_draining_shed():
    eng = _engine(num_slots=1, queue_cap=2, autostart=False)
    f1 = eng.submit([1, 2, 3])
    f2 = eng.submit([4, 5])
    with pytest.raises(OverloadedError) as ei:
        eng.submit([6])
    assert ei.value.reason == "queue_full"
    eng.close(drain=False)
    for f in (f1, f2):
        with pytest.raises(OverloadedError) as ei:
            f.result(5)
        assert ei.value.reason == "draining"
    with pytest.raises(OverloadedError) as ei:
        eng.submit([7])
    assert ei.value.reason == "draining"
    # queue_full + two queued futures shed at close + the post-close
    # submit = 4 sheds
    assert eng.stats()["counters"]["shed"] == 4


def test_deadline_shed_before_claim():
    eng = _engine(num_slots=1, queue_cap=8, autostart=False, deadline_ms=1.0)
    futs = [eng.submit([1, 2, 3]), eng.submit([4, 5])]
    time.sleep(0.05)  # both requests outlive the 1 ms deadline queued
    eng.start()
    for f in futs:
        with pytest.raises(OverloadedError) as ei:
            f.result(30)
        assert ei.value.reason == "deadline"
    with pytest.raises(OverloadedError) as ei:
        eng.submit([1], deadline_ms=0.0)  # a spent upstream budget
    assert ei.value.reason == "deadline"
    eng.close()


def test_prefill_failure_fails_only_that_request():
    """An injected prefill fault and a poisoned prompt each fail exactly
    their request; the next request is served."""
    eng = _engine(num_slots=2)
    try:
        fault.configure("prefill:fail@1")
        with pytest.raises(RequestFailed, match="injected prefill"):
            eng.generate([1, 2, 3], 3, timeout=60)
        tpt.set_flags({"FLAGS_serving_poison_value": "7"})
        with pytest.raises(RequestFailed, match="poisoned"):
            eng.generate([1, 7, 3], 3, timeout=60)
        tpt.set_flags({"FLAGS_serving_poison_value": ""})
        assert eng.generate([1, 2, 3], 3, timeout=60)["finish"] == "length"
        assert eng.stats()["counters"]["failed"] == 2
    finally:
        tpt.set_flags({"FLAGS_serving_poison_value": ""})
        fault.reset()
        eng.close()


def test_decode_step_failure_fails_the_active_requests():
    """A decode-step fault fails the requests in the grid, not the
    scheduler: the next request is served."""
    eng = _engine(num_slots=2, autostart=False)
    try:
        fault.configure("decode_step:fail@2")
        futs = [eng.submit([1, 2, 3], 5), eng.submit([4, 5], 5)]
        eng.start()
        for f in futs:
            with pytest.raises(RequestFailed, match="decode step failed"):
                f.result(60)
        assert eng.generate([6, 7], 4, timeout=60)["finish"] == "length"
    finally:
        fault.reset()
        eng.close()


@pytest.mark.parametrize("kw", [dict(mesh="mesh")], ids=["mesh"])
def test_options_not_ported_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _engine(num_slots=1, autostart=False, **kw)


@pytest.mark.parametrize("option", ["speculate", "role"])
def test_spec_and_role_options_generate(gen_engine, option):
    """Speculative decoding and the prefill / decode roles, which raised
    before they were ported, now generate gen_engine's streams, each
    step's logits bit-equal to the uncached forward's
    (tests/test_torch_spec_decode.py and tests/test_torch_disagg.py hold
    the rest)."""
    from paddle_tpu_torch.serving import DisaggPair, HostBytesTransport

    paged = dict(num_slots=2, page_tokens=16, paged=True, prefill_chunk=0,
                 prefix_reuse=False)
    if option == "speculate":
        eng = _engine(scope=gen_engine.scope, speculate=True, **paged)
    else:
        eng = DisaggPair(
            _engine(scope=tpt.Scope(parent=gen_engine.scope),
                    role="prefill", **paged),
            _engine(scope=tpt.Scope(parent=gen_engine.scope),
                    role="decode", **paged),
            transport=HostBytesTransport())
    rng = np.random.RandomState(37)
    pattern = rng.randint(1, MODEL["vocab_size"], size=3).tolist()
    prompts = [(pattern * 7)[:20], _prompts((5,), seed=31)[0]]
    try:
        got = [f.result(120) for f in [eng.submit(p, 6) for p in prompts]]
        stats = eng.stats()
    finally:
        eng.close()
    if option == "speculate":
        assert stats["speculate"]["drafts"] > 0
    else:
        assert stats["handoffs"] == 2
    for prompt, res in zip(prompts, got):
        assert res["finish"] == "length"
        assert res["tokens"] == gen_engine.generate(prompt, 6)["tokens"]
        _assert_bitexact(gen_engine, prompt, res)


@pytest.mark.parametrize("kw", [
    dict(paged=True), dict(paged=True, prefill_chunk=16),
    dict(paged=True, prefix_reuse=True)],
    ids=["paged", "prefill_chunk", "prefix_reuse"])
def test_paged_options_generate(gen_engine, kw):
    """The paged cache, chunked prefill and prefix reuse, which raised
    before they were ported, now generate: on gen_engine's weights, the
    same streams as the dense engine, each step's logits bit-equal to
    the uncached forward's (tests/test_torch_paged_generation.py holds
    the rest)."""
    eng = _engine(num_slots=2, scope=gen_engine.scope, page_tokens=16,
                  **kw)
    try:
        prompts = _prompts((20, 5), seed=31)
        got = [f.result(120) for f in [eng.submit(p, 5) for p in prompts]]
        assert eng.stats()["paged"]["page_tokens"] == 16
    finally:
        eng.close()
    for prompt, res in zip(prompts, got):
        assert res["finish"] == "length"
        assert res["tokens"] == gen_engine.generate(prompt, 5)["tokens"]
        _assert_bitexact(eng, prompt, res)


def test_adopt_and_swap_weights_raise(gen_engine):
    # adopt is ported; a dense engine has no pages to adopt into
    with pytest.raises(ValueError, match="requires the paged KV cache"):
        gen_engine.adopt(None)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gen_engine.swap_weights({})


def test_engine_without_cuda_and_without_cpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GenerationEngine(MODEL, num_slots=1, max_seq_len=16,
                         autostart=False)


# ---------------------------------------------------------------------------
# against the JAX package's engine
# ---------------------------------------------------------------------------

def test_greedy_streams_match_the_jax_engine():
    """The JAX engine and the port's engine on its weights, the same
    three concurrent ragged requests: the same greedy token streams, and
    every step's logits within atol 1e-5."""
    import paddle_tpu.serving as jserving

    j_eng = jserving.GenerationEngine(
        MODEL, num_slots=3, max_seq_len=48, max_new_tokens=8,
        keep_logits=True, attn_impl="xla", seed=0, queue_cap=64,
        deadline_ms=600000.0)
    prompts = _prompts((3, 9, 14), seed=11)
    steps = [6, 4, 7]
    try:
        want = [f.result(300) for f in
                [j_eng.submit(p, n) for p, n in zip(prompts, steps)]]
        arrays = {n: np.asarray(j_eng.scope.find_var(n))
                  for n in j_eng.scope.local_var_names()
                  if n not in j_eng.cache_names}
    finally:
        j_eng.close()
    eng = _engine(num_slots=3, scope=scope_from_arrays(arrays, "cpu"))
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
