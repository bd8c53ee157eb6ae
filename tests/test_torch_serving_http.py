"""The port's HTTP front end (``paddle_tpu_torch.serving.server``) over a
ServingEngine with a tiny GQA Llama attached, dense and paged, on the
CPU; and the generation engine's traces, timelines, tenants and weight
hot-swap.

* ``/predict``, ``/generate`` plain and streamed (NDJSON, with and
  without ``"speculate"``), ``/adopt`` carrying a prefill-role server's
  ``KVSegment`` bytes, ``/swap`` (200, 409 on a drifted structure, the
  revert), ``/healthz`` (503 after close), ``/statusz``, ``/tracez``,
  ``/metrics`` (strict Prometheus text), the ``X-PaddleTPU-Deadline-Ms``
  and ``X-PaddleTPU-Weights-Version`` headers and the access log.
* Every token stream over HTTP equals the in-process engine's for the
  same prompt on the same weights (greedy decode: tolerance 0), plain,
  streamed, speculating, and handed over prefill -> ``/adopt``.
* ``GenerationEngine.swap_weights`` validates before anything moves,
  exchanges the weights in place between grid steps (every ``data_ptr``
  and every compiled entry kept), leaves in-flight sequences their pages,
  rolls back on an injected failure, and ``revert_weights`` brings the
  old streams back.
"""
import json
import os
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tpt
from paddle_tpu_torch import fault, layers, telemetry
from paddle_tpu_torch.inference import Predictor, SwapMismatch
from paddle_tpu_torch.ops.registry import reset_op_seed
from paddle_tpu_torch.serving import (GenerationEngine, KVSegment,
                                      ServingEngine, serve, usage)
from paddle_tpu_torch.serving.disagg import SEGMENT_CONTENT_TYPE
from paddle_tpu_torch.serving.server import (DEADLINE_HEADER,
                                             VERSION_HEADER)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = dict(vocab_size=64, hidden=32, num_layers=2, num_heads=4,
             num_kv_heads=2, intermediate=64)
KW = dict(num_slots=2, max_seq_len=32, max_new_tokens=8, attn_impl="xla",
          seed=0, queue_cap=64, deadline_ms=600000.0, device="cpu")
PAGED = dict(paged=True, page_tokens=8, prefill_chunk=0,
             prefix_reuse=False)
SPEC = dict(speculate=True, spec_tokens=3, spec_ngram=2)
TIMEOUT = 60


@pytest.fixture(autouse=True)
def _reset():
    fault.reset()
    yield
    fault.reset()
    tpt.set_flags({"FLAGS_fault_inject": "", "FLAGS_telemetry": True,
                   "FLAGS_serving_access_log": "", "FLAGS_metrics_dir": "",
                   "FLAGS_usage": True})


def _gen(role="both", **over):
    """An engine whose weights equal every other _gen's of the same seed:
    the op-seed counter restarts before each build."""
    reset_op_seed()
    return GenerationEngine(MODEL, role=role, **dict(KW, **over))


def _mlp():
    main, startup = tpt.Program(), tpt.Program()
    startup._is_startup = True
    with tpt.program_guard(main, startup):
        x = layers.data("x", [6])
        out = layers.fc(layers.fc(x, 8, act="gelu", name="http_fc"), 3,
                        name="http_head")
    scope = tpt.Scope()
    tpt.Executor(tpt.CPUPlace()).run(startup, scope=scope)
    return Predictor(main, ["x"], [out], scope=scope, device="cpu")


def _prompts(lens, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, MODEL["vocab_size"], size=n).tolist()
            for n in lens]


@pytest.fixture(scope="module", params=["dense", "paged"])
def stack(request):
    paged = request.param == "paged"
    gen = _gen(**(dict(PAGED, **SPEC) if paged else {}))
    ref = _gen(**(PAGED if paged else {}))
    eng = ServingEngine(_mlp(), workers=1, max_batch=4, max_delay_ms=1.0,
                        deadline_ms=60000)
    eng.attach_generator(gen)
    srv = serve(eng)
    yield SimpleNamespace(paged=paged, gen=gen, ref=ref, eng=eng, srv=srv)
    srv.close(timeout=TIMEOUT)
    ref.close()


def _post(url, payload, headers=None, timeout=TIMEOUT):
    data = payload if isinstance(payload, bytes) else \
        json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers=dict(
        {"Content-Type": "application/json"}, **(headers or {})))
    with urllib.request.urlopen(req, timeout=timeout) as r:
        body = r.read()
        ctype = r.headers.get("Content-Type", "")
        doc = json.loads(body) if "json" in ctype and \
            "ndjson" not in ctype else body
        return r.status, doc, dict(r.headers)


def _get(url, timeout=TIMEOUT):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        body = r.read()
        ctype = r.headers.get("Content-Type", "")
        return r.status, (json.loads(body) if "json" in ctype else
                          body.decode())


def _http_error(fn, *a, **kw):
    with pytest.raises(urllib.error.HTTPError) as ei:
        fn(*a, **kw)
    return ei.value.code, json.loads(ei.value.read())


def _stream(url, payload, timeout=TIMEOUT):
    """POST a streamed request; returns (token lines, the final line)."""
    status, body, headers = _post(url, payload, timeout=timeout)
    assert status == 200
    assert headers["Content-Type"] == "application/x-ndjson"
    lines = [json.loads(x) for x in body.decode().splitlines() if x]
    assert lines[-1]["done"] is True
    toks = [x["token"] for x in lines[:-1]]
    assert [x["i"] for x in lines[:-1]] == list(range(1, len(toks) + 1))
    return toks, lines[-1]


# ---------------------------------------------------------------------------
# /predict beside the generator
# ---------------------------------------------------------------------------

def test_predict_answers_with_the_weights_version(stack):
    xs = np.random.RandomState(0).rand(2, 6).astype("float32")
    status, doc, headers = _post(stack.srv.url + "/predict",
                                 {"inputs": {"x": xs.tolist()}})
    assert status == 200
    want = stack.eng._base.run({"x": xs})[0]
    assert np.array_equal(np.asarray(doc["outputs"][0], "float32"), want)
    assert headers[VERSION_HEADER] == str(stack.eng.weights_version)
    assert doc["trace_id"]


# ---------------------------------------------------------------------------
# /generate
# ---------------------------------------------------------------------------

def test_generate_plain_and_streamed_equal_in_process(stack):
    prompts = _prompts((3, 9, 17), seed=11)
    want = [stack.ref.generate(p, 6)["tokens"] for p in prompts]
    for p, w in zip(prompts, want):
        status, doc, headers = _post(stack.srv.url + "/generate",
                                     {"prompt": p, "max_new_tokens": 6,
                                      "speculate": False})
        assert status == 200 and doc["tokens"] == w
        assert doc["finish"] == "length" and doc["trace_id"]
        assert "logits" not in doc and headers[VERSION_HEADER]
        toks, final = _stream(stack.srv.url + "/generate",
                              {"prompt": p, "max_new_tokens": 6,
                               "stream": True})
        assert toks == w and final["tokens"] == w
        assert final["streamed_tokens"] == len(w)
        assert final["timeline"]["token_ms"]  # telemetry on: a timeline


def test_generate_speculating_gives_the_same_tokens(stack):
    """A repetitive prompt makes the drafter fire on the speculating
    (paged) engine; the tokens equal plain decode's, plain and
    streamed.  On the dense engine the field is accepted and ignored."""
    base = [5, 9, 13, 17]
    prompt = base * 4
    want = stack.ref.generate(prompt, 8)["tokens"]
    before = stack.gen.stats()["counters"]["spec_drafts"]
    status, doc, _ = _post(stack.srv.url + "/generate",
                           {"prompt": prompt, "max_new_tokens": 8,
                            "speculate": True})
    assert status == 200 and doc["tokens"] == want
    toks, _ = _stream(stack.srv.url + "/generate",
                      {"prompt": prompt, "max_new_tokens": 8,
                       "stream": True, "speculate": True})
    assert toks == want
    if stack.paged:
        assert stack.gen.stats()["counters"]["spec_drafts"] > before


def test_generate_errors(stack):
    url = stack.srv.url + "/generate"
    code, doc = _http_error(_post, url, {"prompt": "nope"})
    assert code == 400
    code, doc = _http_error(_post, url, {"prompt": [1, 2],
                                         "speculate": "yes"})
    assert code == 400 and "speculate" in doc["detail"]
    code, doc = _http_error(_post, url, {"prompt": list(range(1, 40))})
    assert code == 400 and "exceeds max prompt length" in doc["detail"]
    code, doc = _http_error(_post, url, {"prompt": [1, 2]},
                            headers={DEADLINE_HEADER: "0"})
    assert code == 503 and doc["reason"] == "deadline"
    # a garbage budget is dropped, not adopted
    status, doc, _ = _post(url, {"prompt": [1, 2], "max_new_tokens": 2},
                           headers={DEADLINE_HEADER: "soon"})
    assert status == 200


def test_generate_without_a_generator_is_404():
    eng = ServingEngine(_mlp(), workers=1, max_batch=2)
    srv = serve(eng)
    try:
        code, _ = _http_error(_post, srv.url + "/generate",
                              {"prompt": [1, 2]})
        assert code == 404
        code, _ = _http_error(_post, srv.url + "/adopt", b"xx")
        assert code == 404
        code, _ = _http_error(_post, srv.url + "/swap",
                              {"revert": True, "target": "generate"})
        assert code == 404
    finally:
        srv.close(timeout=TIMEOUT)


def test_predict_deadline_header_sheds(stack):
    code, doc = _http_error(_post, stack.srv.url + "/predict",
                            {"inputs": {"x": [[0.0] * 6]}},
                            headers={DEADLINE_HEADER: "0"})
    assert code == 503 and doc["reason"] == "deadline"
    status, _, _ = _post(stack.srv.url + "/predict",
                         {"inputs": {"x": [[0.0] * 6]}},
                         headers={DEADLINE_HEADER: "30000"})
    assert status == 200


# ---------------------------------------------------------------------------
# /adopt: a prefill-role server's segment into the attached engine
# ---------------------------------------------------------------------------

def test_adopt_over_http_equals_colocated(stack):
    url = stack.srv.url + "/adopt"
    if not stack.paged:
        code, doc = _http_error(_post, url, b"\x00" * 16)
        assert code == 404
        return
    pre = _gen("prefill", **PAGED)
    pre_eng = ServingEngine(_mlp(), workers=1, max_batch=2)
    pre_eng.attach_generator(pre)
    pre_srv = serve(pre_eng)
    try:
        for p in _prompts((5, 8, 13), seed=3):
            want = stack.ref.generate(p, 7)["tokens"]
            status, seg_bytes, headers = _post(
                pre_srv.url + "/generate", {"prompt": p,
                                            "max_new_tokens": 7})
            assert status == 200
            assert headers["Content-Type"] == SEGMENT_CONTENT_TYPE
            meta = json.loads(headers["X-PaddleTPU-Segment-Meta"])
            assert meta["prompt_len"] == len(p)
            status, doc, _ = _post(url + "?max_new_tokens=7", seg_bytes,
                                   headers={"Content-Type":
                                            SEGMENT_CONTENT_TYPE})
            assert status == 200 and doc["tokens"] == want
            assert doc["trace_id"] == meta["trace_id"]
            toks, final = _stream(url + "?max_new_tokens=7&stream=1",
                                  seg_bytes)
            assert toks == want and final["tokens"] == want
        # a streamed /generate at a prefill-role server is refused
        code, _ = _http_error(_post, pre_srv.url + "/generate",
                              {"prompt": [1, 2], "stream": True})
        assert code == 400
        code, doc = _http_error(_post, url, b"garbage" * 4)
        assert code == 400 and "segment" in doc["detail"]
        seg = KVSegment.from_bytes(seg_bytes)
        bad = KVSegment("0" * 24, seg.prompt_len, seg.position,
                        seg.tokens, seg.page_tokens, seg.layers)
        code, doc = _http_error(_post, url, bad.to_bytes())
        assert code == 409 and doc["error"] == "segment_mismatch"
        assert stack.gen.stats()["paged"]["pages_live"] == 0
    finally:
        pre_srv.close(timeout=TIMEOUT)


# ---------------------------------------------------------------------------
# /swap
# ---------------------------------------------------------------------------

def _save_weights(engine, dirname, **drift):
    from paddle_tpu_torch import io

    arrays = {n: engine.scope.find_var(n).numpy().copy()
              for n in engine._weight_names()}
    for n, v in drift.items():
        if v is None:
            del arrays[n]
        else:
            arrays[n] = v
    io._write(os.path.join(dirname, "__params__"), arrays)
    return arrays


def test_swap_generate_200_409_and_revert(stack, tmp_path):
    """/swap {"dir", "target": "generate"} swaps the attached engine in
    place (its streams become a fresh engine's on those weights), a
    drifted checkpoint gets 409 with the old weights still serving, and
    {"revert": true} brings the first streams back bit for bit."""
    donor = _gen(seed=5, **(PAGED if stack.paged else {}))
    try:
        good = str(tmp_path / "good")
        _save_weights(donor, good)
        name = donor._weight_names()[0]
        drift = str(tmp_path / "drift")
        _save_weights(donor, drift, **{name: np.zeros((3, 3), "float32")})
        missing = str(tmp_path / "missing")
        _save_weights(donor, missing, **{name: None})
        prompts = _prompts((4, 11), seed=21)
        before = [stack.ref.generate(p, 6)["tokens"] for p in prompts]
        want = [donor.generate(p, 6)["tokens"] for p in prompts]
        assert before != want
        gen = stack.gen
        ptrs = {n: gen.scope.find_var(n).data_ptr()
                for n in gen._weight_names()}
        version = gen.weights_version
        url = stack.srv.url
        for bad in (drift, missing):
            code, doc = _http_error(_post, url + "/swap",
                                    {"dir": bad, "target": "generate"})
            assert code == 409 and doc["error"] == "swap_mismatch"
        assert gen.weights_version == version
        status, doc, _ = _post(url + "/swap", {"dir": good,
                                               "target": "generate"})
        assert status == 200 and doc["weights_version"] == version + 1
        assert doc["target"] == "generate" and doc["swap_ms"] >= 0
        for p, w in zip(prompts, want):
            _, got, _ = _post(url + "/generate", {"prompt": p,
                                                  "max_new_tokens": 6})
            assert got["tokens"] == w
        status, doc, _ = _post(url + "/swap", {"revert": True,
                                               "target": "generate"})
        assert status == 200 and doc["weights_version"] == version + 2
        for p, w in zip(prompts, before):
            toks, _ = _stream(url + "/generate",
                              {"prompt": p, "max_new_tokens": 6,
                               "stream": True})
            assert toks == w
        assert {n: gen.scope.find_var(n).data_ptr() for n in ptrs} == ptrs
        code, _ = _http_error(_post, url + "/swap", {"target": "x",
                                                     "revert": True})
        assert code == 400
        code, _ = _http_error(_post, url + "/swap", {})
        assert code == 400
    finally:
        donor.close()


def test_swap_predict_flips_the_version_header(stack, tmp_path):
    from paddle_tpu_torch import io

    base = stack.eng._base
    arrays = {n: (base.scope.find_var(n) * 0.5).numpy()
              for n in base._weight_names()}
    io._write(str(tmp_path / "__params__"), arrays)
    xs = [[0.25] * 6]
    _, first, h0 = _post(stack.srv.url + "/predict", {"inputs": {"x": xs}})
    status, doc, _ = _post(stack.srv.url + "/swap", {"dir": str(tmp_path)})
    assert status == 200 and doc["target"] == "predict"
    _, second, h1 = _post(stack.srv.url + "/predict",
                          {"inputs": {"x": xs}})
    assert int(h1[VERSION_HEADER]) == int(h0[VERSION_HEADER]) + 1
    assert second["outputs"] != first["outputs"]
    status, doc, _ = _post(stack.srv.url + "/swap", {"revert": True})
    assert status == 200
    _, third, h2 = _post(stack.srv.url + "/predict", {"inputs": {"x": xs}})
    assert third["outputs"] == first["outputs"]
    assert int(h2[VERSION_HEADER]) == int(h0[VERSION_HEADER]) + 2


# ---------------------------------------------------------------------------
# the introspection plane
# ---------------------------------------------------------------------------

def test_healthz_statusz_tracez_metrics(stack):
    stack.gen.generate([3, 4, 5], 4)
    status, hz = _get(stack.srv.url + "/healthz")
    assert status == 200 and hz["status"] == "ok"
    assert hz["generation"]["counters"]["served"] >= 1
    assert hz["role"] == "both"
    status, st = _get(stack.srv.url + "/statusz")
    assert status == 200
    gen = st["engine"]["generator"]
    assert gen["decode_manifest"]["flops"] > 0
    assert gen["stats"]["weights_version"] >= 1
    assert st["device"]["peaks"]["peak_flops"] is None  # no card here
    assert st["flags"]["FLAGS_serving_max_batch"] == 8
    status, tz = _get(stack.srv.url + "/tracez")
    assert status == 200
    recent = tz["generation"]["recent"]
    assert recent and recent[0]["timeline"]["events"][0]["event"] == "admit"
    ex = tz["generation"]["ttft_exemplars"]
    ids = {r["trace_id"] for r in recent + tz["generation"]["slowest"]}
    assert ex and ex[0]["trace_id"]
    status, text = _get(stack.srv.url + "/metrics")
    assert status == 200
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "check_stat_catalog_http", os.path.join(REPO, "tools",
                                                "check_stat_catalog.py"))
    csc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(csc)
    assert csc.validate_exposition(text) == []
    for fam in ("serving_generate_requests", "serving_decode_steps",
                "serving_ttft_ms_count", "serving_http_requests"):
        assert f"paddle_tpu_{fam}" in text, fam
    assert ids  # the timeline store holds trace ids


def test_access_log_and_healthz_after_close(tmp_path):
    log = tmp_path / "access.jsonl"
    tpt.set_flags({"FLAGS_serving_access_log": str(log)})
    gen = _gen()
    eng = ServingEngine(_mlp(), workers=1, max_batch=2, deadline_ms=60000)
    eng.attach_generator(gen)
    srv = serve(eng)
    try:
        _post(srv.url + "/predict", {"inputs": {"x": [[0.5] * 6]}})
        _post(srv.url + "/generate", {"prompt": [1, 2, 3],
                                      "max_new_tokens": 3})
        _stream(srv.url + "/generate", {"prompt": [1, 2, 3],
                                        "max_new_tokens": 3,
                                        "stream": True})
        _http_error(_post, srv.url + "/predict", {"bad": 1})
        # a handler writes its line after its reply has gone out
        deadline = time.monotonic() + TIMEOUT
        while len(log.read_text().splitlines()) < 4:
            assert time.monotonic() < deadline, log.read_text()
            time.sleep(0.01)
        lines = [json.loads(x) for x in log.read_text().splitlines()]
        assert [(r["path"], r["status"]) for r in lines] == [
            ("/predict", 200), ("/generate", 200), ("/generate", 200),
            ("/predict", 400)]
        assert all(r["trace_id"] for r in lines[:3])
        assert lines[0]["phases"]["queue_wait_ms"] is not None
        eng.close(timeout=TIMEOUT)
        code, hz = _http_error(_get, srv.url + "/healthz")
        assert code == 503 and hz["status"] == "closed"
        assert not gen._thread.is_alive()
    finally:
        srv.close(timeout=TIMEOUT)


# ---------------------------------------------------------------------------
# the generation engine: traces, timelines, tenants, hot-swap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True])
def test_submit_trace_timeline_and_tenant(paged):
    usage.reset_ledger()
    gen = _gen(**(PAGED if paged else {}))
    try:
        res = gen.submit([1, 2, 3, 4, 5], 5, trace_id="hop-1",
                         tenant="acme").result(TIMEOUT)
        assert res["trace_id"] == "hop-1"
        tl = res["timeline"]
        events = [e["event"] for e in tl["events"]]
        assert events[0] == "admit" and events[-1] == "finish"
        assert "claim" in events and "prefill" in events
        assert len(tl["token_ms"]) == len(res["tokens"]) == 5
        quiet = gen.submit([1, 2], 2, timeline=False).result(TIMEOUT)
        assert "timeline" not in quiet and quiet["trace_id"]
        spans = [s for s in telemetry.get_spans()
                 if s.trace_id == "hop-1"]
        names = {s.name for s in spans}
        assert {"generation/sequence", "generation/prefill"} <= names
        snap = usage.peek_ledger().snapshot()["tenants"]["acme"]
        assert snap["requests"] == 1 and snap["served"] == 1
        assert snap["tokens_in"] == 5 and snap["tokens_out"] == 5
        assert snap["prefill_steps"] == 1 and snap["decode_steps"] == 4
        assert (snap["page_us"] > 0) == paged
        assert 0.5 <= gen.retry_after_s() <= 30.0
        tz = gen.tracez()
        assert tz["recent"][0]["trace_id"] == quiet["trace_id"] or \
            any(r["trace_id"] == "hop-1" for r in tz["recent"])
        cons = usage.peek_ledger().conservation()
        assert all(c["delta"] == 0 for c in cons.values())
    finally:
        gen.close()
        usage.reset_ledger()


def test_generation_swap_mismatch_and_rollback():
    gen = _gen(**PAGED)
    try:
        names = gen._weight_names()
        assert not [n for n in names if n in gen.cache_names]
        live = {n: gen.scope.find_var(n).clone() for n in names}
        want = gen.generate([7, 8, 9], 5)["tokens"]
        with pytest.raises(SwapMismatch, match="missing from checkpoint"):
            gen.swap_weights({n: live[n].numpy() for n in names[1:]})
        fault.configure("weight_swap:fail@2")
        new = {n: (t * 0.5).numpy() for n, t in live.items()}
        with pytest.raises(fault.InjectedFault):
            gen.swap_weights(new)
        assert gen.weights_version == 1
        for n, t in live.items():
            assert torch.equal(gen.scope.find_var(n), t), n
        assert gen.generate([7, 8, 9], 5)["tokens"] == want
        with pytest.raises(SwapMismatch, match="nothing swapped"):
            gen.revert_weights()
    finally:
        gen.close()


def test_generation_swap_keeps_in_flight_pages_and_entries():
    """A swap committed while two sequences decode: it applies between
    grid steps, each live slot keeps the pages it held (its block table
    only grows), both sequences run to their full length, the compiled
    entries and every weight's storage stay as they were, and the pool
    drains to 0 live pages."""
    gen = _gen(**dict(PAGED, max_new_tokens=20))
    donor = _gen(seed=5, **PAGED)
    try:
        gen.generate([1, 2, 3], 2)  # builds the programs
        entries = {k: dict(exe._cache) for k, (_p, _f, exe)
                   in gen._progs.items()}
        decode_entries = dict(gen._decode_exe._cache)
        ptrs = {n: gen.scope.find_var(n).data_ptr()
                for n in gen._weight_names()}
        started = threading.Event()
        futs = [gen.submit(p, 20, on_token=lambda t, ts: started.set())
                for p in _prompts((6, 9), seed=4)]
        assert started.wait(TIMEOUT)
        held = {s.idx: list(s.pages) for s in gen._slots if s.active}
        new = {n: donor.scope.find_var(n).numpy().copy()
               for n in donor._weight_names()}
        res = gen.swap_weights(new)
        assert res["weights_version"] == 2
        for s in gen._slots:
            if s.active and s.idx in held:
                assert s.pages[:len(held[s.idx])] == held[s.idx]
        for f in futs:
            r = f.result(TIMEOUT)
            assert r["finish"] == "length" and len(r["tokens"]) == 20
        assert gen.stats()["paged"]["pages_live"] == 0
        assert {n: gen.scope.find_var(n).data_ptr() for n in ptrs} == ptrs
        for k, before in entries.items():
            cache = gen._progs[k][2]._cache
            assert all(cache[s] is e for s, e in before.items())
        assert all(gen._decode_exe._cache[s] is e
                   for s, e in decode_entries.items())
        # the new weights serve the donor's streams; the revert the old
        p = [11, 12, 13, 14]
        assert gen.generate(p, 6)["tokens"] == donor.generate(p, 6)[
            "tokens"]
        gen.revert_weights()
        ref = _gen(**PAGED)
        try:
            assert gen.generate(p, 6)["tokens"] == ref.generate(p, 6)[
                "tokens"]
        finally:
            ref.close()
    finally:
        gen.close()
        donor.close()


def _uncached_logits(eng, token_ids):
    """The uncached forward over ``token_ids``, right-padded to the
    engine's max_seq_len, on the engine's live weights: [S, V] logits."""
    from paddle_tpu_torch.models.llama import build_llama_forward

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


def test_generation_swap_flushes_the_prefix_index():
    """A prompt whose pages the prefix index holds, then a swap: the same
    prompt afterwards prefills whole under the new weights (no hit on the
    old K/V) and its logits equal the uncached forward's on them at
    tolerance 0; the revert flushes the index again and brings the first
    stream back bit for bit."""
    gen = _gen(**dict(PAGED, prefix_reuse=True, keep_logits=True))
    donor = _gen(seed=5, **PAGED)
    try:
        p = _prompts((20,), seed=8)[0]
        first = gen.generate(p, 4)
        again = gen.generate(p, 4)
        hits = gen.stats()["counters"]["prefix_hits"]
        assert hits == 1 and again["tokens"] == first["tokens"]
        assert gen.stats()["paged"]["prefix_index_entries"] == 2
        gen.swap_weights({n: donor.scope.find_var(n).numpy().copy()
                          for n in donor._weight_names()})
        assert gen.stats()["paged"]["prefix_index_entries"] == 0
        res = gen.generate(p, 4)
        assert gen.stats()["counters"]["prefix_hits"] == hits
        ref = _uncached_logits(gen, p + res["tokens"][:-1])
        for i, got in enumerate(res["logits"]):
            assert np.array_equal(got, ref[len(p) - 1 + i]), i
        assert not np.array_equal(res["logits"][0], first["logits"][0])
        assert gen.stats()["paged"]["prefix_index_entries"] == 2
        gen.revert_weights()
        assert gen.stats()["paged"]["prefix_index_entries"] == 0
        back = gen.generate(p, 4)
        assert back["tokens"] == first["tokens"]
        assert all(np.array_equal(a, b)
                   for a, b in zip(back["logits"], first["logits"]))
    finally:
        gen.close()
        donor.close()


def test_generation_swap_unpublishes_a_prompt_begun_before_it():
    """A chunked prefill that a swap lands in the middle of: its pages
    mix both weights' K/V, so the prompt publishes none of them."""
    gen = _gen(**dict(PAGED, prefix_reuse=True, prefill_chunk=8,
                      autostart=False))
    donor = _gen(seed=5, **PAGED)
    try:
        new = {n: donor.scope.find_var(n).numpy().copy()
               for n in donor._weight_names()}
        fut = gen.submit(_prompts((20,), seed=8)[0], 2)
        with gen._cv:  # one scheduler iteration's claim and first chunk
            [(slot, req)] = gen._claim_locked()
        gen._begin(slot, req)
        gen._prefill_advance(slot)
        assert 0 < slot.prefill_pos < 20
        gen.swap_weights(new)  # no scheduler: commits here, mid-prompt
        gen.start()
        assert fut.result(TIMEOUT)["finish"] == "length"
        assert gen.stats()["paged"]["prefix_index_entries"] == 0
    finally:
        gen.close()
        donor.close()


def test_generation_swap_refused_while_draining():
    gen = _gen()
    names = gen._weight_names()
    arrays = {n: gen.scope.find_var(n).numpy().copy() for n in names}
    gen.drain(timeout=TIMEOUT)
    t0 = time.monotonic()
    with pytest.raises(SwapMismatch, match="drain"):
        gen.swap_weights(arrays)
    assert time.monotonic() - t0 < TIMEOUT
    gen.close()
