"""chip_smoke.py's phase 2 reads ptxas's report and cuobjdump's SASS by
kernel name: every instantiation it checks (CHECKED_KERNELS: the bf16 and
fp16 tensor-core kernels, the fp32 forward and the fp32 backward) must come
back from ``kernel_label`` under the name the check looks up, or the spill
check fails on the card with "ptxas printed no spill line".  The mangled names
here follow the Itanium C++ ABI as nvcc emits it for the kernels in
paddle_tpu_torch/csrc/ (anonymous namespace, then namespace tc or f32)."""
import importlib.util
import json
import math
import os
import re

import numpy as np
import torch
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)


# the 16-bit element types of the tensor-core kernels, as mangled
_TYPES = {"bf16": "13__nv_bfloat16", "f16": "6__half"}


def _mangle(label):
    """The mangled name of the kernel `label` names: 'fa_dq_tc_kernel<bf16,
    128>' is namespace tc's fa_dq_tc_kernel<__nv_bfloat16, 128> ('f16':
    <__half, 128>), 'fa_dkv_f32_kernel<64, 4>' namespace f32's
    fa_dkv_f32_kernel<64, 4>; parameters as the kernels take them (TMA
    maps for tc, float pointers for f32)."""
    name, args = re.fullmatch(r"(\w+)<(.*)>", label).groups()
    args = [a.strip() for a in args.split(",")]
    if args[0] in _TYPES:
        ns, ints, params = "tc", args[1:], "N6hopper7TmaMapsILi4EEEPKfS6_"
    else:
        ns, ints, params = "f32", args, "PKfS3_S3_S3_S3_S3_S3_PfS4_S4_"
    targs = _TYPES.get(args[0], "") + "".join(f"Li{a}E" for a in ints)
    return (f"_ZN12_GLOBAL__N_1{len(ns)}{ns}{len(name)}{name}I{targs}EEv"
            f"{params}NS_8BwdShapeE")


def test_the_checked_kernels_cover_every_kernel_family():
    names = {re.match(r"\w+", k).group(0) for k in smoke.CHECKED_KERNELS}
    assert names == {"fa_fwd_tc_kernel", "fa_dq_tc_kernel",
                     "fa_dkv_tc_kernel", "fa_fwd_f32_kernel",
                     "fa_dkv_f32_kernel", "fa_dq_f32_kernel"}
    assert len(set(smoke.CHECKED_KERNELS)) == len(smoke.CHECKED_KERNELS)


@pytest.mark.parametrize("label", smoke.CHECKED_KERNELS)
def test_kernel_label_names_every_checked_instantiation(label):
    assert smoke.kernel_label(_mangle(label)) == label


@pytest.mark.parametrize("label", smoke.CHECKED_KERNELS)
def test_ptxas_report_finds_every_checked_instantiation(label):
    """ptxas's -v lines for one kernel, as nvcc prints them, land under
    the label check_build looks up, spill line included."""
    mangled = _mangle(label)

    class FakeBuild:
        build_logs = {"lib": "\n".join([
            f"ptxas info    : Compiling entry function '{mangled}' for "
            f"'sm_90a'",
            f"ptxas info    : Function properties for {mangled}",
            "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
            "loads",
            "ptxas info    : Used 200 registers, used 1 barriers"])}

    report = smoke.ptxas_report(FakeBuild)
    assert list(report) == [label]
    assert any("0 bytes spill stores" in line for line in report[label])


def test_profiled_launches_are_held_to_the_replay_aware_counts():
    """A profiled replay passes when the profiler's launches of each kernel
    family (mangled or demangled names) equal the counters' deltas, packed
    plus unpacked wrapper, and fails on any other count."""
    import collections

    row = collections.namedtuple("row", "key count")
    kernels = [row("void (anonymous namespace)::f32::fa_fwd_f32_kernel"
                   "<64, 2>(float const*)", 12),
               row(_mangle("fa_dkv_tc_kernel<bf16, 128>"), 4),
               row(_mangle("fa_dq_tc_kernel<bf16, 128>"), 4),
               row("sm90_xmma_gemm_bf16bf16_bf16f32", 40)]
    before = ((1, 2, 3, 4, 5, 6), 0, 0)
    after = ((13, 2, 3, 4, 9, 10), 0, 0)
    smoke.check_profiled_launches(kernels, before, after, "a replay")
    with pytest.raises(AssertionError, match="the counters added"):
        smoke.check_profiled_launches(kernels[1:], before, after, "a replay")
    with pytest.raises(AssertionError, match="the counters added"):
        smoke.check_profiled_launches(kernels, before, before, "a replay")


@pytest.mark.parametrize("readings,gated", [
    ([(60, (12, 0, 0), (12, 0, 0))], 0),
    # the first profile lost records: it is excused by one with more
    ([(58, (10, 0, 0), (12, 0, 0)), (60, (12, 0, 0), (12, 0, 0))], 1),
    # a short count in a profile with as many records as any: the program
    ([(60, (10, 0, 0), (12, 0, 0)), (60, (12, 0, 0), (12, 0, 0))], None),
    ([(60, (10, 0, 0), (12, 0, 0))] * 3, None),
    # the profile that agrees has fewer records than one that does not
    ([(60, (10, 0, 0), (12, 0, 0)), (58, (12, 0, 0), (12, 0, 0))], None)],
    ids=["agrees", "records_lost", "same_records", "never_agrees",
         "fewer_records_agree"])
def test_gated_profile_excuses_only_profiles_that_lost_records(readings,
                                                               gated):
    """A mismatch is put down to the profiler only where another profile
    of the same replay holds more kernel records; the gate holds the
    profile with the most."""
    if gated is None:
        with pytest.raises(AssertionError, match="lost no records"):
            smoke.gated_profile(readings, "a replay")
    else:
        assert smoke.gated_profile(readings, "a replay") == gated


@pytest.mark.parametrize("readings,held", [
    ([(60, (12, 0, 0), (12, 0, 0))], (0, True)),
    ([(58, (10, 0, 0), (12, 0, 0)), (60, (12, 0, 0), (12, 0, 0))], (1, True)),
    # the profile that holds every launch lost other records
    ([(1764, (7, 4, 4), (8, 4, 4)), (1764, (7, 4, 4), (8, 4, 4)),
      (1627, (8, 4, 4), (8, 4, 4))], (2, False)),
    # every profile short: records lost, nothing proved
    ([(1522, (3, 4, 4), (4, 4, 4))] * 3, (None, False)),
    # a launch the counters missed
    ([(60, (13, 0, 0), (12, 0, 0))], None),
    ([(58, (11, 0, 0), (12, 0, 0)), (60, (12, 1, 0), (12, 0, 0))], None)],
    ids=["agrees", "records_lost", "fewer_records_agree", "all_short",
         "over", "short_then_over"])
def test_lenient_profile_holds_a_profile_that_proves_the_counters(readings,
                                                                  held):
    """Phase 15's gate: a profile whose launches equal the counters'
    holds them (its device numbers stand only if it is the fullest);
    every profile short is not measured; a profile that saw more
    launches than the counters added fails."""
    if held is None:
        with pytest.raises(AssertionError, match="more launches"):
            smoke.lenient_profile(readings, "a replay")
    else:
        assert smoke.lenient_profile(readings, "a replay") == held


# ---------------------------------------------------------------------------
# phase 10: generation serving
# ---------------------------------------------------------------------------

def test_generation_phase_runs_llama_2_7b_at_the_card_configuration():
    """The flagship engine: Llama-2-7B's widths at 8 of its 32 layers
    (the run's depth cut), 4 slots of 1024 positions, buckets 64-512; 8
    prompts of 20-500 tokens that land in every bucket, each with its 64
    new tokens inside the cache (so every request ends 'length'); the
    parity config keeps the widths."""
    assert smoke.GEN == dict(vocab_size=32000, hidden=4096, num_heads=32,
                             intermediate=11008, num_layers=8)
    eng = smoke.GEN_ENGINE
    assert (eng["num_slots"], eng["max_seq_len"]) == (4, 1024)
    assert eng["prefill_buckets"] == (64, 128, 256, 512)
    prompts = smoke.GEN_PROMPTS
    assert len(prompts) == 8 and min(prompts) == 20 and max(prompts) == 500
    buckets = {min(b for b in eng["prefill_buckets"] if b >= n)
               for n in prompts}
    assert buckets == set(eng["prefill_buckets"])
    assert max(prompts) + smoke.GEN_NEW_TOKENS <= eng["max_seq_len"]
    assert {k: v for k, v in smoke.GEN_PARITY.items()
            if k != "num_layers"} == smoke.LLAMA
    par = smoke.GEN_PARITY_ENGINE
    assert max(smoke.GEN_PARITY_PROMPTS) <= max(par["prefill_buckets"])
    assert max(smoke.GEN_PARITY_PROMPTS) + smoke.GEN_PARITY_NEW_TOKENS \
        <= par["max_seq_len"]


def test_gen_prompts_are_seeded_token_ids():
    a = smoke.gen_prompts((3, 7), 50, seed=1)
    b = smoke.gen_prompts((3, 7), 50, seed=1)
    assert [p.size for p in a] == [3, 7] and all(p.dtype == np.int64
                                                 for p in a)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert all(1 <= p.min() and p.max() < 50 for p in a)


def test_stream_errors_reads_every_step_against_the_uncached_logits():
    """The worst |cached - uncached| over every step of every request, and
    whether each greedy token is the uncached logits' argmax."""
    V = 5
    ref = np.zeros((16, V), "float32")
    ref[2:6, :] = np.eye(V, dtype="float32")[[1, 3, 0, 2]]
    prompt = [4, 4, 4]  # step i reads row len(prompt) - 1 + i
    logits = [ref[2 + i].copy() for i in range(4)]
    logits[1][0] += 0.25
    res = {"tokens": [1, 3, 0, 2], "logits": logits}
    err, greedy = smoke.stream_errors([res], [prompt], lambda seq: ref)
    assert err == 0.25 and greedy
    res["tokens"] = [1, 3, 0, 4]
    assert smoke.stream_errors([res], [prompt], lambda seq: ref)[1] is False


def _fake_profile(events):
    import json as _json

    class Prof:
        def export_chrome_trace(self, path):
            with open(path, "w") as f:
                _json.dump({"traceEvents": events}, f)
    return Prof()


def test_memcpy_report_fails_a_cache_sized_copy():
    events = [{"name": "Memcpy DtoD (Device -> Device)",
               "args": {"bytes": 32}},
              {"name": "Memcpy HtoD (Pageable -> Device)",
               "args": {"bytes": 1 << 30}},
              {"name": "fa_fwd_f32_kernel", "args": {}}]
    assert smoke.memcpy_report(_fake_profile(events), 1 << 20) == (1, 32, 32)
    events.append({"name": "Memcpy DtoD (Device -> Device)",
                   "args": {"bytes": 1 << 20}})
    with pytest.raises(AssertionError, match="not written in place"):
        smoke.memcpy_report(_fake_profile(events), 1 << 20)


# the product and RMSNorm kernels' functions as nvcc names them (a
# file-specific anonymous namespace), and what phase 2's spill check calls
# them: PR 11's launches, then the redesigned ones (skinny <rows, columns
# a lane, n-major, 16-byte>; tiled <n-major, 16-byte>, and an earlier
# tiled <rows, columns, n-major, 16-byte>)
GEMM_NAMES = {
    "_ZN44_GLOBAL__N__e3653ecc_11_gemm_f32_cu_f20cb11418gemm_skinny_kernel"
    "ILi16ELb1ELb0EEEvPKfS2_PfiiiNS_7StridesExxx":
        "gemm_skinny_kernel<16, 1, 0>",
    "_ZN44_GLOBAL__N__e3653ecc_11_gemm_f32_cu_f20cb11417gemm_tiled_kernel"
    "ILi128ELi64ELi8ELi4ELb1EEEvPKfS2_PfiiiNS_7StridesE":
        "gemm_tiled_kernel<128, 64, 8, 4, 1>",
    "_ZN44_GLOBAL__N__e3653ecc_11_gemm_f32_cu_f20cb11416gemm_fold_kernel"
    "EPKfPfiiiixx": "gemm_fold_kernel",
    "_ZN12_GLOBAL__N_13f3217fa_fwd_f32_kernelILi64ELi2EEEvPKfS3_": None,
    "_ZN44_GLOBAL__N__e3653ecc_11_gemm_f32_cu_f20cb11418gemm_skinny_kernel"
    "ILi4ELi4ELb1ELb1EEEvPKfS2_PfiiiNS_7StridesE":
        "gemm_skinny_kernel<4, 4, 1, 1>",
    "_ZN44_GLOBAL__N__e3653ecc_11_gemm_f32_cu_f20cb11417gemm_tiled_kernel"
    "ILi128ELi128ELb0ELb1EEEvPKfS2_PfS3_iiiiNS_7StridesE":
        "gemm_tiled_kernel<128, 128, 0, 1>",
    "_ZN44_GLOBAL__N__e3653ecc_11_gemm_f32_cu_f20cb11417gemm_tiled_kernel"
    "ILb1ELb0EEEvPKfS2_PfS3_iiiiNS_7StridesE": "gemm_tiled_kernel<1, 0>",
    "_ZN45_GLOBAL__N__0b5f2e1a_15_rms_norm_f32_cu_5c1d2e3f20rms_norm_rows"
    "_kernelILi16EEEvPKfS2_Pfif": "rms_norm_rows_kernel<16>",
    "_ZN45_GLOBAL__N__0b5f2e1a_15_rms_norm_f32_cu_5c1d2e3f25rms_norm_rows"
    "_loop_kernelEPKfS1_Pfif": "rms_norm_rows_loop_kernel",
}


@pytest.mark.parametrize("mangled", sorted(GEMM_NAMES))
def test_gemm_label(mangled):
    assert smoke.gemm_label(mangled) == GEMM_NAMES[mangled]


def test_gemm_bound_by_bytes_at_decode_and_by_operations_at_prefill():
    ms, by = smoke.gemm_bound(4, 12288, 4096)
    assert by == "bytes"
    assert ms == pytest.approx(4 * (4 * 4096 + 4096 * 12288 + 4 * 12288)
                               / 3.35e12 * 1e3)
    ms, by = smoke.gemm_bound(512, 12288, 4096)
    assert by == "operations"
    assert ms == pytest.approx(2 * 512 * 12288 * 4096 / 67e12 * 1e3)


def test_gemm_bound_of_batched_attention_counts_every_batch():
    """Decode attention's P V (128 slot-heads, M 1, 1024 keys, D 128):
    the values are read once, 128 x 1024 x 128 floats."""
    ms, by = smoke.gemm_bound(1, 128, 1024, batch=128)
    assert by == "bytes"
    assert ms == pytest.approx(
        4 * 128 * (1024 + 1024 * 128 + 128) / 3.35e12 * 1e3)
    assert smoke.gemm_bound(4, 12288, 4096, batch=1) == \
        smoke.gemm_bound(4, 12288, 4096)


class _Engine:
    def __init__(self, paged, chunk, layers=2):
        self.paged, self.prefill_chunk = paged, chunk
        self.model = {"num_layers": layers}


@pytest.mark.parametrize("paged,chunk,n,whole,gemm", [
    # dense: 2 prefills, 10 steps; L = 2: a step 13 products, a prefill 9
    (False, 0, dict(prefills=2, prefill_chunks=0, decode_steps=10), 2,
     10 * 13 + 2 * 9),
    # paged, a prefix hit's tail as one chunk: 3 prefills, 1 of them hit
    (True, 0, dict(prefills=3, prefill_chunks=1, decode_steps=7), 2,
     (7 + 1) * 13 + 2 * 9),
    # chunking on: no whole prefill at all
    (True, 16, dict(prefills=2, prefill_chunks=6, decode_steps=5), 0,
     (5 + 6) * 13)],
    ids=["dense", "paged_prefix_hit", "chunked"])
def test_generation_launch_counts(paged, chunk, n, whole, gemm):
    eng = _Engine(paged, chunk)
    assert smoke.whole_prefills(eng, n) == whole
    assert smoke.gemm_launches(eng, n, xla_prefill=False) == gemm
    # every program run: 2 L + 1 = 5 norms
    assert smoke.rms_norm_launches(eng, n) == 5 * (
        n["decode_steps"] + n["prefill_chunks"] + whole)
    # an "xla" prefill adds its attention's 2 L products
    assert smoke.gemm_launches(eng, n, xla_prefill=True) == gemm + 4 * whole


def test_read_counts_carries_the_product_kernel():
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import gemm

    from paddle_tpu_torch.ops.cuda import rms_norm

    smoke.reset_counts(fa)
    gemm.matmul.launches = 5
    rms_norm.rms_norm_rows.launches = 3
    counts, plain, realigned = smoke.read_counts(fa)
    assert counts == (0, 0, 0, 0, 0, 0) and counts.gemm == 5
    assert counts.rms_norm == 3
    assert plain == realigned == 0
    gemm.matmul_reference(torch.zeros(2, 3), torch.zeros(3, 2))
    assert smoke.read_counts(fa)[1] == 1  # the plain version is a gate
    rms_norm.rms_norm_rows_reference(torch.ones(2, 3), None, 1e-6)
    assert smoke.read_counts(fa)[1] == 2
    smoke.reset_counts(fa)
    assert gemm.matmul.launches == 0 and gemm.matmul_reference.calls == 0
    assert rms_norm.rms_norm_rows.launches == 0


def test_generation_launch_counts_with_verifies():
    """A verify runs as a chunk does: 6 L + 1 products and 2 L + 1 norms
    (L = 2: 13 and 5)."""
    eng = _Engine(True, 0)
    n = dict(prefills=2, prefill_chunks=0, decode_steps=5, spec_drafts=3)
    assert smoke.cached_runs(n) == 8
    assert smoke.gemm_launches(eng, n, xla_prefill=False) == 8 * 13 + 2 * 9
    assert smoke.rms_norm_launches(eng, n) == 5 * (8 + 2)


def test_spec_phase_configuration():
    """Phase 10c: bucket 8 below the flagship's buckets, so that a verify
    of spec_tokens + 1 rows runs 8 rows; four prompts repeating one
    8-token pattern and four of GEN_PROMPTS (10b's ids), one of each kind
    opted out; every request fits its 64 tokens in the cache."""
    eng = smoke.GEN_SPEC_ENGINE
    assert eng["prefill_buckets"] == (8,) + smoke.GEN_ENGINE["prefill_buckets"]
    assert smoke.GEN_SPEC["spec_tokens"] + 1 <= 8
    prompts = smoke.spec_prompts()
    assert [p.size for p in prompts] == list(smoke.GEN_SPEC_REPEATS) + \
        list(smoke.GEN_PROMPTS[:4])
    for p in prompts[:4]:
        assert np.array_equal(p[8:], p[:-8])  # period 8
    assert all(np.array_equal(a, b) for a, b in zip(
        prompts[4:], smoke.gen_prompts(smoke.GEN_PROMPTS, 32000, 32)))
    assert sorted(i // 4 for i in smoke.GEN_SPEC_OPT_OUT) == [0, 1]
    assert max(p.size for p in prompts) + smoke.GEN_NEW_TOKENS \
        <= eng["max_seq_len"]


def test_streams_equal_is_bit_equality():
    a = [{"tokens": [1, 2], "logits": [np.zeros(3, "float32"),
                                       np.ones(3, "float32")]}]
    b = [{"tokens": [1, 2], "logits": [np.zeros(3, "float32"),
                                       np.ones(3, "float32")]}]
    assert smoke.streams_equal(a, b)
    b[0]["logits"][1] = np.nextafter(np.ones(3, "float32"), 2)
    assert not smoke.streams_equal(a, b)
    assert not smoke.streams_equal(a, [{"tokens": [1, 3],
                                        "logits": a[0]["logits"]}])
    assert not smoke.streams_equal(a, [])


class _Counted:
    def __init__(self, layers, **counters):
        self.paged, self.prefill_chunk = True, 0
        self.model = {"num_layers": layers}
        self._counters = dict(dict(prefills=0, prefill_chunks=0,
                                   decode_steps=0, spec_drafts=0),
                              **counters)

    def stats(self):
        return {"counters": self._counters}


def test_check_engine_counts_sums_a_pair():
    """A DisaggPair's two engines launched together: the wants add up
    (the prefill role's whole prefills, the decode role's steps)."""
    pre, dec = _Counted(2, prefills=3), _Counted(2, decode_steps=7)
    counts = smoke.Launches((0, 0, 0, 3 * 2, 0, 0))
    counts.gemm, counts.rms_norm = 3 * 9 + 7 * 13, 5 * (3 + 7)
    smoke.check_engine_counts((pre, dec), counts, 0, 0, "pair", False)
    counts.gemm -= 1
    with pytest.raises(AssertionError):
        smoke.check_engine_counts((pre, dec), counts, 0, 0, "pair", False)


@pytest.mark.parametrize("given", [None, "/elsewhere/pycache"])
def test_bytecode_cache_reaches_every_process_the_run_starts(
        given, monkeypatch, tmp_path):
    """The run's bytecode cache lies under the checkout's ignored
    _build directory; it is set for this interpreter and, through the
    environment that spawn_process copies, for every child, with the
    writing of bytecode allowed (into the prefix only) where the
    environment forbade it; a prefix the caller set is kept."""
    import sys

    from paddle_tpu_torch.distributed import launch

    assert smoke.BYTECODE_CACHE.startswith(
        os.path.join(smoke.HERE, "paddle_tpu_torch", "_build") + os.sep)
    # set first, so that the undo also removes what the call sets
    monkeypatch.setenv("PYTHONPYCACHEPREFIX", given or "")
    if given is None:
        monkeypatch.delenv("PYTHONPYCACHEPREFIX")
    monkeypatch.setenv("PYTHONDONTWRITEBYTECODE", "1")
    monkeypatch.setattr(sys, "pycache_prefix", None)
    monkeypatch.setattr(sys, "dont_write_bytecode", True)
    smoke.use_bytecode_cache()
    want = given or smoke.BYTECODE_CACHE
    assert sys.pycache_prefix == want and not sys.dont_write_bytecode
    assert os.environ["PYTHONPYCACHEPREFIX"] == want
    assert "PYTHONDONTWRITEBYTECODE" not in os.environ
    log = tmp_path / "child.log"
    proc = launch.spawn_process(
        [sys.executable, "-c", "import sys; print(sys.pycache_prefix, "
         "sys.flags.dont_write_bytecode)"], log_path=str(log))
    assert proc.wait(60) == 0
    assert log.read_text().split() == [want, "0"]


def test_serving_phase_configuration():
    """Phase 11: BERT-base at its published widths behind an engine at
    the reference's serving defaults (max batch 8, max delay 5 ms), 64
    requests of 1-3 rows from a seed whose ids stay below the poison
    sentinel, and the /adopt prompts among 10b's."""
    assert smoke.SERVE_BERT == dict(smoke.BERT_BASE, seq_len=128)
    assert smoke.SERVE_ENGINE["max_batch"] == 8
    assert smoke.SERVE_ENGINE["max_delay_ms"] == 5.0
    assert (smoke.SERVE_REQUESTS, smoke.SERVE_CLIENTS) == (64, 16)
    assert smoke.SERVE_POISON_ID == smoke.SERVE_BERT["vocab_size"] - 1
    feeds = smoke.serving_feeds(smoke.SERVE_REQUESTS, seed=1100)
    again = smoke.serving_feeds(smoke.SERVE_REQUESTS, seed=1100)
    assert all(smoke.same_outputs(list(a.values()), list(b.values()))
               for a, b in zip(feeds, again))
    rows = [f["input_ids"].shape[0] for f in feeds]
    assert set(rows) == {1, 2, 3}
    for f in feeds:
        assert f["input_ids"].max() < smoke.SERVE_POISON_ID
        assert f["input_ids"].shape[1] == smoke.SERVE_BERT["seq_len"]
        assert (f["attn_mask"][:, 0] == 1).all()
    assert all(i < len(smoke.GEN_PROMPTS) for i in smoke.SERVE_ADOPT)


def test_same_outputs_needs_equal_bits_and_dtypes():
    a = [np.arange(4, dtype="float32"), np.arange(2)]
    assert smoke.same_outputs(a, [x.copy() for x in a])
    assert not smoke.same_outputs(a, [a[0].astype("float64"), a[1]])
    b = a[0].copy()
    b[1] = np.nextafter(b[1], 2)
    assert not smoke.same_outputs(a, [b, a[1]])
    assert not smoke.same_outputs(a, a[:1])


class _Ev:
    def __init__(self, start, end, cuda=True):
        self.device_type = (torch.autograd.DeviceType.CUDA if cuda
                            else torch.autograd.DeviceType.CPU)
        self.time_range = type("R", (), {"start": start, "end": end})()


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


@pytest.mark.parametrize("spans,busy", [
    ([(0, 10), (5, 15), (20, 30)], 25.0),   # two streams overlapping
    ([(0, 10), (10, 20)], 20.0),             # back to back
    ([(0, 100), (10, 20), (30, 40)], 100.0),  # nested
    ([], 0.0)])
def test_device_busy_union_counts_overlaps_once(spans, busy):
    events = [_Ev(a, b) for a, b in spans] + [_Ev(0, 1000, cuda=False)]
    assert smoke.device_busy_union(_Prof(events)) == busy


def test_prom_line_reads_the_ports_metrics_text():
    from paddle_tpu_torch import telemetry

    telemetry.metrics.gauge("smoke_gauge").set(1.5)
    telemetry.metrics.histogram("smoke_hist_ms").observe(2.0)
    lines = [x for x in telemetry.prometheus_text().splitlines()
             if x and not x.startswith("#")]
    assert lines and all(smoke.PROM_LINE.match(x) for x in lines)
    assert not smoke.PROM_LINE.match("bad line with spaces 1")


# ---------------------------------------------------------------------------
# phase 12: the fleet
# ---------------------------------------------------------------------------

def _argv_value(argv, flag):
    return argv[list(argv).index(flag) + 1]


def test_fleet_generation_replicas_run_llama_2_7b_at_the_card_config():
    """Phase 12b's replicas: Llama-2-7B's widths at GEN's 8 layers, MHA, 4
    slots of 1024 positions, the paged cache of 257 pages of 16 (phase
    10's pools), phase 10's buckets, 64 new tokens, on the card; the
    replica's own parser accepts the argv."""
    from paddle_tpu_torch.serving import replica

    argv = smoke.FLEET_GEN_ARGV
    widths = {"--gen-vocab": "vocab_size", "--gen-hidden": "hidden",
              "--gen-layers": "num_layers", "--gen-heads": "num_heads",
              "--gen-intermediate": "intermediate"}
    for flag, key in widths.items():
        assert int(_argv_value(argv, flag)) == smoke.GEN[key]
    assert "--gen-kv-heads" not in argv  # MHA
    assert int(_argv_value(argv, "--gen-slots")) == \
        smoke.GEN_ENGINE["num_slots"]
    assert int(_argv_value(argv, "--gen-max-seq")) == \
        smoke.GEN_ENGINE["max_seq_len"]
    assert int(_argv_value(argv, "--gen-max-new")) == smoke.GEN_NEW_TOKENS
    assert int(_argv_value(argv, "--gen-page-tokens")) == smoke.GEN_PAGE
    slots, seq = smoke.GEN_ENGINE["num_slots"], \
        smoke.GEN_ENGINE["max_seq_len"]
    assert int(_argv_value(argv, "--gen-pages")) == \
        slots * seq // smoke.GEN_PAGE + 1
    assert "--gen-paged" in argv and _argv_value(argv, "--device") == "cuda"
    assert smoke.FLEET_GEN_ENV["FLAGS_serving_prefill_buckets"] == \
        ",".join(str(b) for b in smoke.GEN_ENGINE["prefill_buckets"])
    assert _argv_value(smoke.FLEET_SERVE_ARGV, "--device") == "cuda"
    assert int(_argv_value(smoke.FLEET_SERVE_ARGV, "--max-batch")) == \
        smoke.SERVE_ENGINE["max_batch"]
    with pytest.raises(SystemExit) as e:
        replica.main(list(argv) + ["--help"])
    assert e.value.code == 0


def test_fleet_phase_runs_two_fleets_with_roles():
    """12b's colocated reference is a one-replica fleet in role "both",
    its pair a prefill- and a decode-role replica (the supervisor pins
    the roles); the pair's gate wants every plain and every streamed
    generation disaggregated and none losing its decode replica."""
    from paddle_tpu_torch.serving import FleetSupervisor

    roles = smoke.FLEET_GEN_ROLES
    assert roles == {"colocated": ("both",), "pair": ("prefill", "decode")}
    for key in roles:
        sup = FleetSupervisor(roles=list(roles[key]), autostart=False)
        assert [r.role for r in sup._replicas] == list(roles[key])
    n = len(smoke.GEN_PROMPTS)
    ok = {"disagg_generations": 2 * n, "affinity_lost": 0}
    assert smoke.disagg_counters_ok(ok, n)
    assert not smoke.disagg_counters_ok(dict(ok, disagg_generations=n), n)
    assert not smoke.disagg_counters_ok(dict(ok, affinity_lost=1), n)


SAMPLE_TRACE = [
    {"ph": "X", "cat": "kernel", "name": "void (anonymous namespace)::f32"
     "::fa_fwd_f32_kernel<64, 4>(float const*, float const*, float "
     "const*, float const*, float*, float*, FwdShape)"},
    {"ph": "X", "cat": "kernel", "name": "void gemm_skinny_kernel<4, 4, "
     "true, true>(float const*, float const*, float*, int, int, int, "
     "int, int, Strides)"},
    {"ph": "X", "cat": "kernel", "name": "void gemm_tiled_kernel<false, "
     "true>(float const*, float const*, float*, float*, int, int, int, "
     "int, Strides)"},
    {"ph": "X", "cat": "kernel", "name": "void rms_norm_rows_kernel<256>("
     "float const*, float const*, float*, int, int, float)"},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch"},
    {"ph": "X", "cat": "cpu_op", "name": "fa_fwd_f32_kernel"},
    {"ph": "X", "cat": "kernel", "name": "void at::native::elementwise"},
]


def test_trace_records_count_kernel_events_by_family():
    rec = smoke.trace_records(SAMPLE_TRACE)
    assert rec == {"fa_fwd_f32": 1, "gemm_f32": 2, "rms_norm_f32": 1,
                   "other_attention": 0, "other_product": 0}
    tc = dict(SAMPLE_TRACE[0], name="void tc::fa_fwd_tc_kernel<128>()")
    assert smoke.trace_records([tc])["other_attention"] == 1
    sdpa = dict(SAMPLE_TRACE[0], name="fmha_cutlassF_f32_aligned_64x64")
    assert smoke.trace_records([sdpa])["other_attention"] == 1
    for lib in ("ampere_sgemm_128x64_tn", "nvjet_tst_128x64_64x4_1x1",
                "sm90_xmma_gemm_f32f32_f32f32_f32_tn_n", "gemv2T_kernel"):
        rec = smoke.trace_records([dict(SAMPLE_TRACE[1], name=lib)])
        assert rec["other_product"] == 1 and rec["gemm_f32"] == 0, lib


def _replay(corr, ts, fa=12, gemm=50, norms=0, extra=()):
    """A cudaGraphLaunch call and the kernel records of its replay."""
    names = (["fa_fwd_f32_kernel<64, 4>"] * fa
             + ["gemm_tiled_kernel<false, true>"] * gemm
             + ["rms_norm_rows_kernel<256>"] * norms + list(extra))
    return ([{"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
              "ts": ts, "args": {"correlation": corr}}]
            + [{"ph": "X", "cat": "kernel", "name": n, "ts": ts + 1 + i,
                "args": {"correlation": corr}} for i, n in enumerate(names)])


def test_trace_dispatches_group_kernels_by_their_graph_launch():
    """A replay's kernels carry its cudaGraphLaunch's correlation id:
    records are grouped by launch, in launch order; kernels of a launch
    made before the trace began (no launch call in it) and eager ones are
    left out, and so is a launch none of whose kernels was recorded."""
    events = (_replay(7, 300.0, fa=12, gemm=87) + _replay(3, 100.0, gemm=50)
              + _replay(5, 500.0, fa=0, gemm=0)
              + [{"ph": "X", "cat": "kernel", "name": "fa_fwd_f32_kernel",
                  "args": {"correlation": 1}},
                 {"ph": "X", "cat": "kernel", "name": "gemm_fold_kernel",
                  "args": {"correlation": 9}},
                 {"ph": "X", "cat": "cuda_runtime",
                  "name": "cudaLaunchKernel", "args": {"correlation": 9}}])
    got = smoke.trace_dispatches(events)
    assert [(d["fa_fwd_f32"], d["gemm_f32"]) for d in got] == [(12, 50),
                                                               (12, 87)]


@pytest.mark.parametrize("case,ok", [
    ("whole", True), ("last_cut", True), ("short_attention", False),
    ("few_products", False), ("library_product", False),
    ("sdpa_attention", False), ("one_replay", False),
    ("prefill_norms", True), ("prefill_missing_norm", False)])
def test_dispatch_gate_holds_every_replay_but_the_last(case, ok):
    """The per-dispatch gate of phase 12's traces: every graph replay but
    the last holds one batch's (12a: 12 forward records, 48 products at
    least, no RMSNorm) or one prefill's (12b: 32, 128, 65), and no other
    attention or product kernel; two replays at least."""
    path = "fleet_generation" if case.startswith("prefill") \
        else "fleet_serving"
    want = smoke.FLEET_DISPATCH[path]
    kw = dict(fa=want["fa_fwd_f32"], gemm=want["gemm_f32"] + 2,
              norms=want["rms_norm_f32"])
    middle = dict(kw)
    last = dict(kw)
    if case == "last_cut":
        last.update(fa=3, gemm=10)
    elif case == "short_attention":
        middle["fa"] -= 1
    elif case == "few_products":
        middle["gemm"] = want["gemm_f32"] - 1
    elif case == "library_product":
        middle["extra"] = ("ampere_sgemm_128x64_tn",)
    elif case == "sdpa_attention":
        middle["extra"] = ("pytorch_flash::flash_fwd_kernel",)
    elif case == "prefill_missing_norm":
        middle["norms"] -= 1
    events = _replay(1, 0.0, **kw) + _replay(2, 10.0, **middle) \
        + _replay(3, 20.0, **last)
    if case == "one_replay":
        events = _replay(1, 0.0, **kw)
    if ok:
        assert len(smoke.dispatch_gate(events, path, case)) == 3
    else:
        with pytest.raises(AssertionError, match="graph replays"):
            smoke.dispatch_gate(events, path, case)


def test_trace_launches_put_the_records_on_their_kernel():
    rec = {"fa_fwd_f32": 24, "gemm_f32": 100, "rms_norm_f32": 0,
           "other_attention": 0}
    serving = smoke.trace_launches(rec, 0)
    assert tuple(serving) == (24, 0, 0, 0, 0, 0)
    assert (serving.gemm, serving.rms_norm) == (100, 0)
    generation = smoke.trace_launches(dict(rec, rms_norm_f32=65), 3)
    assert tuple(generation) == (0, 0, 0, 24, 0, 0)
    assert generation.rms_norm == 65
    assert set(smoke.TRACE_PATHS) == {"fleet_serving", "fleet_generation",
                                      "chaos_fleet"}


def test_closed_rows_holds_routed_answers_to_tolerance_0():
    want = [np.arange(6, dtype="float32").reshape(1, 2, 3) / 7,
            np.arange(2, dtype="int64").reshape(1, 2)]
    got = [w.tolist() for w in want]
    assert smoke.closed_rows(got, want)
    bumped = want[0].copy()
    bumped[0, 0, 1] = np.nextafter(bumped[0, 0, 1], 1)
    assert not smoke.closed_rows([bumped.tolist(), got[1]], want)
    assert not smoke.closed_rows(got[:1], want)
    recs = [{"status": 200, "equal": True}, {"status": 503, "equal": False}]
    assert smoke.traffic_gate(recs, "x") == 1
    with pytest.raises(AssertionError):
        smoke.traffic_gate(recs + [{"status": 500, "equal": False}], "x")


# ---------------------------------------------------------------------------
# phase 13: the port's load generator and chaos harness
# ---------------------------------------------------------------------------

def _probe(rate=300.0, p99=120.0, startup=(11.0, 11.5, 12.0)):
    return {"requests_per_s": rate, "latency_ms": {"p99": p99},
            "startup_s": dict(enumerate(startup))}


@pytest.mark.parametrize("rate,p99,respawn,want", [
    (300.0, 120.0, 14.0, dict(qps=150.0, forward_timeout_ms=1000.0,
                              duration_s=23.0)),
    (180.0, 400.0, 12.4, dict(qps=90.0, forward_timeout_ms=1600.0,
                              duration_s=20.0)),
    (500.0, 249.0, 15.0, dict(qps=250.0, forward_timeout_ms=1000.0,
                              duration_s=24.0))])
def test_chaos_settings_derive_from_the_probe_and_the_respawn(rate, p99,
                                                              respawn,
                                                              want):
    """13b's harness settings: half the rate the probed fleet sustained,
    a forward timeout above the probe's p99 (4x, at least 1 s), the
    liveness deadline at the flag's default, and scenarios long enough
    that a SIGKILL a quarter of the way in respawns before the end."""
    from paddle_tpu_torch.flags import flag_value

    got = smoke.chaos_settings(_probe(rate, p99), respawn)
    assert {k: got[k] for k in want} == want
    assert got["forward_timeout_ms"] > p99
    assert got["liveness_timeout_ms"] == \
        flag_value("FLAGS_fleet_liveness_timeout_ms") == 5000.0
    assert 0.25 * got["duration_s"] + respawn <= got["duration_s"]
    # a probe fleet slower to start than 12a's respawn sets the duration
    slow = smoke.chaos_settings(_probe(rate, p99, (16.1, 17.0, 15.0)),
                                respawn)
    assert slow["duration_s"] == math.ceil(1.6 * max(17.0, respawn))


def _chaos_report():
    """A passing run_chaos report, as the harness shapes it."""
    scen = {
        "crash": {"recovery_s": 13.0, "notes": {"postmortem": {
            "attribution": "signal:SIGKILL"}}},
        "hang": {"recovery_s": 19.0, "notes": {"hung_kills_before": 0,
                                               "hung_kills_after": 1}},
        "poison": {"notes": {"bisections": 3, "poison_rows": 3}},
        "spec_storm": {"notes": {"spec": {"drafts": 20, "rollbacks": 0},
                                 "fault_victims": 2}}}
    return {"ok": True, "errors": {}, "availability_pct": 99.8,
            "scenarios": scen,
            "totals": {"collateral_failures": 0, "poison_leaks": 0,
                       "leaked_pages": 0, "torn_responses": 0}}


def _set(report, path, value):
    doc = report
    for k in path[:-1]:
        doc = doc[k]
    doc[path[-1]] = value


@pytest.mark.parametrize("path,value,gate", [
    (("totals", "collateral_failures"), 1, "collateral_failures"),
    (("totals", "poison_leaks"), 1, "poison_leaks"),
    (("totals", "leaked_pages"), 2, "leaked_pages"),
    (("totals", "leaked_pages"), None, "leaked_pages"),
    (("totals", "torn_responses"), 1, "torn_responses"),
    (("availability_pct",), 98.99, "availability"),
    (("errors",), {"hot_swap": "did not converge"}, "errors"),
    (("ok",), False, "ok"),
    (("scenarios", "crash", "recovery_s"), None, "crash respawn"),
    (("scenarios", "crash", "notes", "postmortem"),
     {"attribution": "unexplained"}, "crash respawn"),
    (("scenarios", "hang", "notes", "hung_kills_after"), 0,
     "hang liveness kill"),
    (("scenarios", "poison", "notes", "bisections"), 0,
     "poison bisection"),
    (("scenarios", "spec_storm", "notes", "spec", "drafts"), 0,
     "spec_storm speculated through the fault"),
    (("scenarios", "spec_storm", "notes", "fault_victims"), 0,
     "spec_storm speculated through the fault")])
def test_chaos_gate_fails_each_broken_verdict(path, value, gate):
    assert smoke.chaos_gate(_chaos_report()) == []
    report = _chaos_report()
    _set(report, path, value)
    assert smoke.chaos_gate(report) == [gate]


def test_chaos_gate_needs_every_recovery_scenario():
    report = _chaos_report()
    del report["scenarios"]["spec_storm"]
    assert smoke.chaos_gate(report) == [
        "spec_storm speculated through the fault"]


def test_chaos_fleet_configuration():
    """13b's /predict fleet: the shared fleet's argv the harness builds
    (the model's arguments, 1 worker, max batch 8, a 10 ms batch window
    over the harness's 2 ms, the poison sentinel through --poison-value,
    on the card); 1-row BERT requests below the
    poison id; the poison body's attn_mask carries the sentinel, which
    the engine's check finds after its dtype cast."""
    from paddle_tpu_torch.serving.engine import poison_sentinel_matches
    from paddle_tpu_torch.tools import chaos

    model = chaos.PredictModel(["--model-dir", "d"]
                               + smoke.bert_shape_args()
                               + list(smoke.CHAOS_ENGINE), None, b"")
    argv = chaos.shared_fleet_argv(model, "cpu")
    assert _argv_value(argv, "--model-dir") == "d"
    assert _argv_value(argv, "--workers") == "1"
    assert int(_argv_value(argv, "--max-batch")) == 8
    # the model's engine arguments come after the harness's: they win
    last = len(argv) - 1 - argv[::-1].index("--max-delay-ms")
    assert float(argv[last + 1]) == 10.0 > float(
        _argv_value(argv, "--max-delay-ms"))
    assert float(_argv_value(argv, "--poison-value")) == chaos.POISON
    assert _argv_value(argv, "--device") == "cpu"
    S = smoke.SERVE_BERT["seq_len"]
    assert smoke.bert_shape_args() == [
        "--shape", f"input_ids={S}", "--shape", f"token_type_ids={S}",
        "--shape", f"attn_mask={S}"]
    feeds = smoke.chaos_feeds(0)
    assert len(feeds) == 16
    for f in feeds:
        assert f["input_ids"].shape == (1, S)
        assert f["input_ids"].max() < smoke.SERVE_POISON_ID
        assert not poison_sentinel_matches(f["attn_mask"], chaos.POISON)
    assert [smoke.json_body(f) for f in smoke.chaos_feeds(0)] == \
        [smoke.json_body(f) for f in feeds]
    poison = smoke.chaos_feeds(7, 1)[0]
    poison["attn_mask"][0, 0] = chaos.POISON
    doc = json.loads(smoke.json_body(poison))["inputs"]
    mask = np.asarray(doc["attn_mask"]).astype("float32")
    assert poison_sentinel_matches(mask, chaos.POISON)
    ids = np.asarray(doc["input_ids"]).astype("int64")
    assert not poison_sentinel_matches(ids, chaos.POISON)
    assert smoke.CHAOS_REPLICAS == 3
    assert smoke.CHAOS_LIVENESS_MS == 5000.0


def test_chaos_generation_configuration():
    """13b's generation: poison_paged and spec_storm on GEN (Llama-2-7B's
    widths at 8 layers) in pages of 16 with phase 10c's buckets (bucket
    8 for the verify); disagg_crash on four replicas of Llama-2-7B's
    widths at 4 layers, their prompts (4-48 tokens) inside the 64-token
    bucket; the replica's parser accepts the argv."""
    from paddle_tpu_torch.serving import replica

    assert smoke.GEN["num_layers"] == 8
    eng = smoke.CHAOS_GEN_ENGINE
    assert eng["prefill_buckets"] == smoke.GEN_SPEC_ENGINE["prefill_buckets"]
    assert eng["num_slots"] == smoke.GEN_SPEC_ENGINE["num_slots"]
    assert eng["max_seq_len"] == smoke.GEN_SPEC_ENGINE["max_seq_len"]
    assert eng["page_tokens"] == smoke.GEN_PAGE
    argv = smoke.CHAOS_DISAGG_ARGV
    widths = {"--gen-vocab": "vocab_size", "--gen-hidden": "hidden",
              "--gen-heads": "num_heads",
              "--gen-intermediate": "intermediate"}
    for flag, key in widths.items():
        assert int(_argv_value(argv, flag)) == smoke.GEN[key]
    assert int(_argv_value(argv, "--gen-layers")) == \
        smoke.CHAOS_DISAGG_LAYERS == 4
    assert int(smoke.CHAOS_DISAGG_ENV["FLAGS_serving_prefill_buckets"]) \
        >= 48 + 1
    assert int(_argv_value(argv, "--gen-max-seq")) >= 48 + 8
    with pytest.raises(SystemExit) as e:
        replica.main(list(argv) + ["--help"])
    assert e.value.code == 0


def test_loadgen_generate_leg_sends_64_new_tokens_each():
    """13a's generation leg: 8 requests at 4 clients, prompts of 20-500
    tokens from the 7B vocab, every request's output clamped to 64 (an
    output-length mean far above the clamp)."""
    from paddle_tpu_torch.tools import serving_loadgen as lg

    argv = smoke.LOADGEN_GEN
    assert "--gen-stream" in argv and "--generate" in argv
    assert (_argv_value(argv, "--requests"),
            _argv_value(argv, "--concurrency")) == ("8", "4")
    mk = lg.prompt_maker(int(_argv_value(argv, "--gen-vocab")),
                         int(_argv_value(argv, "--gen-prompt-min")),
                         int(_argv_value(argv, "--gen-prompt-max")),
                         float(_argv_value(argv, "--gen-out-mean")),
                         int(_argv_value(argv, "--gen-out-max")))
    reqs = [mk(i) for i in range(8)]
    assert all(n == 64 for _, n in reqs)
    assert all(20 <= p.size <= 500 and p.max() < 32000 for p, _ in reqs)
    assert smoke.GEN_ENGINE["max_seq_len"] >= 500 + 64
    assert max(smoke.GEN_ENGINE["prefill_buckets"]) >= 500


def test_loadgen_main_keeps_its_report_off_stdout(tmp_path, capsys):
    """loadgen_main runs the tool in this process and returns its exit
    code and report; the report is not printed on chip_smoke's standard
    output (whose last lines the driver reads)."""
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch.serving import ServingEngine, ServingServer
    from paddle_tpu_torch.tools import serving_loadgen as lg

    pred, shapes = lg.build_synthetic(4, 8, 1, device="cpu")
    eng = ServingEngine(pred, workers=1, max_batch=2, max_delay_ms=1.0)
    eng.warmup(shapes)
    srv = ServingServer(eng).start()
    try:
        rc, rep = smoke.loadgen_main(
            ["--url", srv.url, "--feat", "4", "--mode", "closed",
             "--requests", "4", "--concurrency", "2"],
            str(tmp_path / "r.json"))
    finally:
        srv.close()
        tpt.set_flags({"FLAGS_telemetry": True})
    assert rc == 0 and rep["ok"] == 4
    assert capsys.readouterr().out == ""


# ---------------------------------------------------------------------------
# phase 14: BERT-base training under TrainGuard
# ---------------------------------------------------------------------------

def test_guard_phase_runs_the_flagship_configuration():
    """Phase 14 trains bench.py's flagship step (BERT-base, seq 512, batch
    8, 77 predictions) through a NaN at the third step and a SIGTERM at
    the sixth, 12 steps a life, checkpoints every 4 runs."""
    assert smoke.FLAGSHIP == dict(smoke.BERT_BASE, batch_size=8,
                                  seq_len=512, max_predictions=77)
    assert (smoke.GUARD_STEPS, smoke.GUARD_INTERVAL, smoke.GUARD_KEEP) == \
        (12, 4, 2)
    assert smoke.GUARD_NAN == "loss:nan@3"
    assert smoke.GUARD_SIGTERM == "step:sigterm@6"
    assert smoke.GUARD_INTERVAL < 6 < smoke.GUARD_STEPS


def test_guard_phase_rehearses_on_the_cpu(monkeypatch):
    """train_guard_flagship on the CPU at a tiny BERT: the three lives, the
    resume bit-equal to the uninterrupted life, the trace, trace_export,
    the telemetry on / off replays and profiler.py's table (no kernel
    counts on the CPU: the counters are read as 0 and the table must name
    host ops instead of the card's kernels)."""
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch import device, memory
    from paddle_tpu_torch.framework import executor
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    cpu = torch.device("cpu")
    for mod in (device, executor):
        monkeypatch.setattr(mod, "resolve_device", lambda place=None: cpu)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    peaks = [100, 10]
    monkeypatch.setattr(memory, "max_memory_allocated",
                        lambda device=None: peaks[0])
    monkeypatch.setattr(memory, "reset_peak",
                        lambda device=None: peaks.pop(0))
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a: peaks[0])
    monkeypatch.setattr(smoke, "FLAGSHIP", dict(
        vocab_size=97, hidden=128, num_layers=2, num_heads=2,
        intermediate=256, batch_size=2, seq_len=32, max_predictions=5))
    monkeypatch.setattr(smoke, "read_counts",
                        lambda fa: (smoke.Launches((0,) * 6), 0, 0))
    monkeypatch.setattr(smoke, "per_step_launches", lambda main: (0,) * 6)
    monkeypatch.setattr(smoke, "TC_KERNELS", ("aten::",))
    monkeypatch.setattr(smoke, "GUARD", {})
    monkeypatch.setattr(smoke, "log", lambda msg: None)
    try:
        launches = smoke.train_guard_flagship(tpt, fa)
    finally:
        tpt.set_flags({"FLAGS_metrics_dir": "", "FLAGS_telemetry": True})
    g = smoke.GUARD
    assert tuple(launches) == (0,) * 6
    assert g["checkpoint_writes"] == 5   # A: 4, 8, 12; B: 4 and its final
    assert g["checkpoint_bytes"] > 0 and g["trace_events"] > 0
    assert g["sigterm_to_exit_ms"] >= 0 and g["train_guard_resume_ms"] > 0
    assert g["replay_ms_telemetry_on"] > 0 and g["peak_after_reset_gib"] < \
        g["peak_gib"]


# phase 15: recompute and Llama-2's recipe
TINY_BERT = dict(vocab_size=97, hidden=128, num_layers=3, num_heads=2,
                 intermediate=256, batch_size=2, seq_len=32,
                 max_predictions=5)
TINY_LLAMA = dict(vocab_size=97, hidden=64, num_heads=4, num_kv_heads=2,
                  intermediate=128, num_layers=3, batch_size=2, seq_len=32)


def _built(build):
    import paddle_tpu_torch as tpt
    with tpt.program_guard(tpt.Program(), tpt.Program()):
        return build()


def test_recompute_phase_runs_the_published_configurations():
    """15a is bench.py's flagship step; 15b Llama-2-7B's widths at 4 of
    its layers, batch 2 at Llama-2's 4096 context, under Llama-2's
    recipe (AdamW beta2 0.95, eps 1e-5, weight decay 0.1, warmup then
    cosine, global-norm clip 1.0)."""
    assert smoke.LLAMA_RECIPE == dict(smoke.LLAMA, num_layers=4,
                                      batch_size=2, seq_len=4096)
    assert smoke.LLAMA["hidden"] == 4096 and smoke.LLAMA["num_heads"] == 32
    r = smoke.RECIPE
    assert (r["beta1"], r["beta2"], r["epsilon"], r["weight_decay"],
            r["clip_norm"]) == (0.9, 0.95, 1e-5, 0.1, 1.0)
    assert smoke.RECOMPUTE_ATTN == (1, 32, 4096, 128)
    assert smoke.RECOMPUTE_SAVING == 3 * 2 ** 30


def test_checkpoint_finders_pick_each_layer_output():
    """bert_checkpoints: each encoder layer's output (its second
    layer_norm); llama_checkpoints: each block's input and the final
    norm's; both walk a built program."""
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch.models import build_bert_pretrain, build_llama_train

    tpt.reset_unique_name()
    _, outs = _built(lambda: build_bert_pretrain(dropout=0.1, **TINY_BERT))
    main = outs["loss"].block.program
    cks = smoke.bert_checkpoints(main)
    assert len(cks) == TINY_BERT["num_layers"]
    ops = main.global_block().ops
    writer = {n: op for op in ops for n in op.output_arg_names()}
    norms = [op.output("Y")[0] for op in ops if op.type == "layer_norm"]
    # the embeddings' norm, then two a layer: the layers' second ones
    assert cks == norms[2:2 * TINY_BERT["num_layers"] + 1:2]
    for name in cks:
        add = writer[writer[name].input("X")[0]]
        assert add.type == "elementwise_add"

    tpt.reset_unique_name()
    _, outs = _built(lambda: build_llama_train(**TINY_LLAMA))
    main = outs["loss"].block.program
    cks = smoke.llama_checkpoints(main)
    assert len(cks) == TINY_LLAMA["num_layers"] + 1
    ops = main.global_block().ops
    writer = {n: op for op in ops for n in op.output_arg_names()}
    assert writer[cks[0]].type == "lookup_table_v2"
    assert all(writer[n].type == "elementwise_add" for n in cks[1:])


def test_recipe_lrs_follow_the_schedule_on_the_cpu():
    """The host formula against the port's warmup-over-cosine program,
    run on the CPU: warmup 0 then 1.5e-4, then the cosine from its third
    step, within RECIPE_LR_ATOL."""
    import paddle_tpu_torch as tpt

    r = smoke.RECIPE
    main, startup = tpt.Program(), tpt.Program()
    startup._is_startup = True
    with tpt.program_guard(main, startup):
        lr = tpt.layers.linear_lr_warmup(
            tpt.layers.cosine_decay(r["peak_lr"], r["step_each_epoch"],
                                    r["epochs"]),
            r["warmup_steps"], 0.0, r["peak_lr"])
    exe, scope = tpt.Executor(tpt.CPUPlace()), tpt.Scope()
    exe.run(startup, scope=scope)
    got = [float(np.ravel(exe.run(main, fetch_list=[lr], scope=scope)[0])[0])
           for _ in range(8)]
    want = smoke.recipe_lrs(8)
    assert want[0] == 0.0 and abs(want[1] - 1.5e-4) < 1e-12
    assert abs(want[2] - 0.5 * r["peak_lr"] * (1 + math.cos(math.pi / 3))) \
        < 1e-10
    np.testing.assert_allclose(got, want, rtol=0, atol=smoke.RECIPE_LR_ATOL)
    assert got[:2] == [0.0, float(want[1])]


def test_recompute_phase_rehearses_on_the_cpu(monkeypatch):
    """recompute_flagship on the CPU at tiny widths: 15a and 15b each run
    plain then recompute from their startup state and must come out bit
    for bit equal (dropout 0.1 in 15a), the LRs follow the host formula;
    the kernel counts, the profile, the capture and the card's memory
    are stubbed (no card here)."""
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch import device
    from paddle_tpu_torch.framework import executor
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    cpu = torch.device("cpu")
    for mod in (device, executor):
        monkeypatch.setattr(mod, "resolve_device", lambda place=None: cpu)
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a: 0)

    class Props:
        total_memory = 80 * 10 ** 9
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda *a: Props)
    info = executor.Executor.cache_info

    def captured(self):
        out = info(self)
        for e in out["entries"]:
            e["aot"] = True
        return out
    monkeypatch.setattr(executor.Executor, "cache_info", captured)
    monkeypatch.setattr(smoke, "FLAGSHIP", TINY_BERT)
    monkeypatch.setattr(smoke, "LLAMA_RECIPE", TINY_LLAMA)
    monkeypatch.setattr(smoke, "RECOMPUTE_SAVING", 0)
    monkeypatch.setattr(smoke, "read_counts",
                        lambda fa: (smoke.Launches((0,) * 6), 0, 0))
    wants = []
    real_want = smoke.per_step_launches

    def want(main):
        wants.append(real_want(main))
        return (0,) * 6
    monkeypatch.setattr(smoke, "per_step_launches", want)
    monkeypatch.setattr(smoke, "profiled_launches",
                        lambda call, fa, what, key, strict: smoke.PROFILES
                        .__setitem__(key, dict(idle=None, call=call())))
    monkeypatch.setattr(smoke, "RECOMPUTE", {})
    monkeypatch.setattr(smoke, "log", lambda msg: None)
    paths = smoke.recompute_flagship(tpt, fa, cpu)
    assert sorted(paths) == ["recompute_bert", "recompute_bert_plain",
                             "recompute_llama", "recompute_llama_plain"]
    nb, nl = TINY_BERT["num_layers"], TINY_LLAMA["num_layers"]
    assert wants == [(nb, nb, nb, 0, 0, 0), (2 * nb, nb, nb, 0, 0, 0),
                     (0, 0, 0, nl, nl, nl), (0, 0, 0, 2 * nl, nl, nl)]
    r = smoke.RECOMPUTE
    assert r["bert"]["plain"]["losses"] == r["bert"]["recompute"]["losses"]
    assert r["llama"]["lrs"] == pytest.approx(
        [float(x) for x in smoke.recipe_lrs(smoke.RECOMPUTE_STEPS)],
        abs=smoke.RECIPE_LR_ATOL)
    assert r["llama"]["deepest_layers_recompute"] > 0


def test_lenient_profile_reports_lost_records_as_not_measured(monkeypatch):
    """profiled_launches(..., strict=False): where every profile's
    launches fall short of the counters' (records lost), the device
    numbers are not measured and nothing raises; strict, it raises."""
    counts = iter(range(100))
    monkeypatch.setattr(smoke, "read_counts", lambda fa: (
        smoke.Launches((next(counts),) + (0,) * 5), 0, 0))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(smoke, "log", lambda msg: None)
    monkeypatch.setattr(smoke, "PROFILES", {})

    def call():
        a = torch.randn(64, 64)
        return a @ a

    smoke.profiled_launches(call, None, "a replay", "lost", strict=False)
    p = smoke.PROFILES["lost"]
    assert p["idle"] is None and p["busy_ms"] is None
    assert len(p["lost_records"]) == smoke.PROFILE_TRIES
    with pytest.raises(AssertionError, match="differ from the counters"):
        smoke.profiled_launches(call, None, "a replay", "lost")


@pytest.mark.parametrize("strict", [False, True])
def test_lenient_profile_when_the_fullest_profile_lost_a_launch(
        monkeypatch, strict):
    """Three profiles of one replay: two of 1764 kernel records without a
    forward launch, one of 1627 with every launch (so no profile is
    whole).  Lenient, the device numbers are not measured; strict, the
    fullest profile's disagreement raises; a replay whose fullest profile
    agrees is measured either way."""
    readings = iter([(1764, (7, 4, 4)), (1764, (7, 4, 4)),
                     (1627, (8, 4, 4)), (1764, (8, 4, 4))])

    class Row:
        def __init__(self, count):
            self.count, self.key = count, "k"

    def report(prof, wall_us, what, key=None):
        total, seen = next(readings)
        smoke.PROFILES[key] = dict(busy_ms=1.0, idle=0.1, seen=seen)
        return [Row(total)], 1.0

    monkeypatch.setattr(smoke, "report_profile", report)
    monkeypatch.setattr(smoke, "launch_deltas", lambda kernels, b, a: (
        smoke.PROFILES["r"]["seen"], (8, 4, 4)))
    monkeypatch.setattr(smoke, "check_profiled_launches",
                        lambda kernels, b, a, what: None)
    monkeypatch.setattr(smoke, "read_counts", lambda fa: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(smoke, "log", lambda msg: None)
    monkeypatch.setattr(smoke, "PROFILES", {})
    if strict:
        with pytest.raises(AssertionError, match="differ from the counters"):
            smoke.profiled_launches(lambda: None, None, "a replay", "r")
    else:
        smoke.profiled_launches(lambda: None, None, "a replay", "r",
                                strict=False)
        p = smoke.PROFILES["r"]
        assert p["busy_ms"] is None and len(p["lost_records"]) == 3
    smoke.profiled_launches(lambda: None, None, "a replay", "r",
                            strict=strict)
    assert smoke.PROFILES["r"]["busy_ms"] == 1.0


# phase 16: float16 AMP with dynamic loss scaling
def test_loss_scale_machine_follows_update_loss_scaling():
    """The host's state machine of 16a': halve at every bad step with
    decr 1 (never below 1e-8), double after incr good steps, counters
    reset as the op resets them."""
    m = smoke.loss_scale_machine([True] * 3 + [False] * 3 + [True],
                                 2.0 ** 18, incr_n=2, decr_n=1)
    assert m == [(2.0 ** 17, 0, 0), (2.0 ** 16, 0, 0), (2.0 ** 15, 0, 0),
                 (2.0 ** 15, 1, 0), (2.0 ** 16, 0, 0), (2.0 ** 16, 1, 0),
                 (2.0 ** 15, 0, 0)]
    assert smoke.loss_scale_machine([True, True, False], 1000.0, 1000,
                                    2) == [(1000.0, 0, 1), (500.0, 0, 0),
                                           (500.0, 1, 0)]
    assert smoke.loss_scale_machine([True], 1.5e-8, 2, 1)[0][0] == \
        pytest.approx(1e-8)


def test_attention_types_read_the_profiled_kernels_names():
    class Row:
        def __init__(self, key):
            self.key = key
    rows = [Row("void (anonymous namespace)::tc::fa_fwd_tc_kernel<__half, "
                "64>(hopper::TmaMaps<3>, float const*, __half*, float*)"),
            Row("void (anonymous namespace)::tc::fa_dq_tc_kernel<__half, 64>"
                "(hopper::TmaMaps<4>)"),
            Row("ampere_fp16_s16816gemm_fp16_128x128_ldg8_f2f_nn")]
    assert smoke.attention_types(rows) == ["__half"]
    rows.append(Row("void (anonymous namespace)::f32::fa_dkv_f32_kernel<64, "
                    "4>(float const*)"))
    assert smoke.attention_types(rows) == ["__half", "float"]


def test_fp16_phase_rehearses_on_the_cpu(monkeypatch):
    """Phase 9 then phase 16 on the CPU at tiny widths: 16a's flagship,
    its dropout-0 life against fp32 (and the bf16 control outside the
    fp16 limit), the overflow life (captured against
    eager, bit for bit; the scale state against the host machine) and
    16b against the bf16 life's losses; the kernel counts, the profile,
    the capture and the card's memory are stubbed (no card here)."""
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch import device
    from paddle_tpu_torch.framework import executor
    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    cpu = torch.device("cpu")
    for mod in (device, executor):
        monkeypatch.setattr(mod, "resolve_device", lambda place=None: cpu)
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    for name in ("max_memory_allocated", "memory_allocated",
                 "memory_reserved"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: 0)
    info = executor.Executor.cache_info

    def captured(self):
        out = info(self)
        for e in out["entries"]:
            e["aot"] = True
            e["manifest"] = 0
        return out
    monkeypatch.setattr(executor.Executor, "cache_info", captured)
    monkeypatch.setattr(smoke, "FLAGSHIP", TINY_BERT)
    monkeypatch.setattr(smoke, "LLAMA_FLAGSHIP", TINY_LLAMA)
    monkeypatch.setattr(smoke, "ASYNC_STEPS", 2)
    monkeypatch.setattr(smoke, "read_counts",
                        lambda fa: (smoke.Launches((0,) * 6), 0, 0))
    wants = []
    real_want = smoke.per_step_launches

    def want(main):
        wants.append(real_want(main))
        return (0,) * 6
    monkeypatch.setattr(smoke, "per_step_launches", want)
    monkeypatch.setattr(smoke, "profiled_launches",
                        lambda call, fa, what, key, strict=True: smoke
                        .PROFILES.__setitem__(key, dict(busy_ms=None,
                                                        call=call())))
    monkeypatch.setattr(smoke, "FP16", {})
    monkeypatch.setattr(smoke, "second_signature", lambda *a: None)
    monkeypatch.setattr(smoke, "log", lambda msg: None)
    seed = registry._OP_SEED[0]
    _, bf16_losses = smoke.llama_flagship(tpt, fa)
    after = registry._OP_SEED[0]
    paths = smoke.fp16_flagship(tpt, fa, seed, bf16_losses)
    assert registry._OP_SEED[0] == after  # put back for phase 10
    assert sorted(paths) == ["llama_fp16", "training_fp16"]
    nb, nl = TINY_BERT["num_layers"], TINY_LLAMA["num_layers"]
    # 16a, its fp32, fp16 and bf16 lives at dropout 0, 16a', 16b
    assert wants[1:] == [(nb, nb, nb, 0, 0, 0)] * 5 + [(0, 0, 0, nl, nl, nl)]
    r = smoke.FP16
    assert max(r["bert_vs_fp32"]["rel"]) <= smoke.FP16_FP32_LOSS_RTOL
    assert max(r["bert_vs_fp32"]["bf16_rel"]) > smoke.FP16_FP32_LOSS_RTOL
    assert max(r["llama"]["rel"]) <= smoke.FP16_BF16_LOSS_RTOL
    steps = r["overflow"]["steps"]
    assert r["overflow"]["captured_eq_eager"]
    assert [s["scale"] for s in steps[:3]] == [2.0 ** 17, 2.0 ** 16,
                                               2.0 ** 15]
    assert not steps[3]["found"] and steps[4]["scale"] == 2.0 ** 16


# phase 17: MiniLM-L12-H384 and bench.py's seq-128 step
def test_minilm_phase_runs_the_published_configurations():
    """MiniLM-L12-H384's published widths (12 layers, hidden 384, 12
    heads of 32, intermediate 1536, vocab 30522), no cut; its training at
    bench.py's seq-512 recipe with 77 predictions; bench.py's seq-128 leg
    at BERT-base, batch 192, 19 predictions; the timed attention shapes.
    BERT's builder takes the unpacked flash_attention op at these widths,
    one a layer, so a served request launches the D-32 forward 12 times."""
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch.models import build_bert_pretrain

    m = smoke.MINILM
    assert (m["num_layers"], m["hidden"], m["num_heads"],
            m["intermediate"], m["vocab_size"]) == (12, 384, 12, 1536, 30522)
    assert m["hidden"] // m["num_heads"] == 32
    assert smoke.MINILM_TRAIN["seq_len"] == 512
    assert smoke.MINILM_TRAIN["max_predictions"] == 77
    assert smoke.MINILM_TRAIN_ATTN == (smoke.MINILM_TRAIN["batch_size"], 12,
                                       512, 32)
    assert smoke.MINILM_SERVE_ATTN == (4, 12, smoke.MINILM_SERVE_SEQ, 32)
    s = smoke.SEQ128
    assert (s["batch_size"], s["seq_len"], s["max_predictions"]) == \
        (192, 128, 19)
    assert all(s[k] == smoke.BERT_BASE[k] for k in smoke.BERT_BASE)
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        build_bert_pretrain(is_test=True, seq_len=smoke.MINILM_SERVE_SEQ,
                            **m)
    assert smoke.serving_launches(main) == (0, 0, 0, 12, 0, 0)
    assert smoke.forward_products(main) == 12 * 4 + 2  # 4 fc a layer, head
    for use_flash, want in ((False, (0,) * 6), ("xla", (0,) * 6),
                            (True, (12, 0, 0, 0, 0, 0))):
        main = tpt.Program()
        with tpt.program_guard(main, tpt.Program()):
            build_bert_pretrain(is_test=True, use_flash=use_flash,
                                **smoke.SERVE_BERT)
        assert smoke.serving_launches(main) == want


def test_d32_build_report_reads_every_d32_instantiation(monkeypatch):
    """Phase 17a's look at phase 2's build: the nine D-32 instantiations
    (three tensor-core kernels in bf16 and fp16, the fp32 forward's
    64-row tile, the fp32 dK/dV and dQ), each with HGMMA and UTMALDG where
    it is a tensor-core kernel and no spill; a spill fails."""
    labels = [k for k in smoke.CHECKED_KERNELS
              if re.search(r"<(?:\w+, )?32[,>]", k)]
    assert len(labels) == 9
    ok = ["0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
          "ptxas info    : Used 120 registers, used 1 barriers"]
    report = {"sass": {k: (6, 3) if "_tc_" in k else (0, 0)
                       for k in smoke.CHECKED_KERNELS},
              "ptxas": {k: ok for k in smoke.CHECKED_KERNELS}}
    monkeypatch.setattr(smoke, "BUILD_REPORT", report)
    monkeypatch.setattr(smoke, "log", lambda msg: None)
    rows = smoke.d32_build_report()
    assert sorted(rows) == sorted(labels)
    assert all(r["registers"] == 120 and r["spill_bytes"] == 0
               for r in rows.values())
    report["ptxas"]["fa_fwd_f32_kernel<32, 8>"] = [
        "8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads"]
    with pytest.raises(AssertionError, match="fa_fwd_f32_kernel<32, 8>"):
        smoke.d32_build_report()


def test_attention_kernels_read_names_and_template_arguments():
    class Row:
        def __init__(self, key):
            self.key = key
    rows = [Row("void (anonymous namespace)::tc::fa_fwd_tc_kernel<"
                "__nv_bfloat16, 32>(hopper::TmaMaps<3>, float const*)"),
            Row("void (anonymous namespace)::tc::fa_dkv_tc_kernel<"
                "__nv_bfloat16, 32>(hopper::TmaMaps<4>)"),
            Row("void (anonymous namespace)::f32::fa_dq_f32_kernel<32, 4>"
                "(float const*)"),
            Row("void gemm_tiled_kernel<64>(float const*)")]
    assert smoke.attention_kernels(rows) == [
        "fa_dkv_tc_kernel<__nv_bfloat16, 32>", "fa_dq_f32_kernel<32, 4>",
        "fa_fwd_tc_kernel<__nv_bfloat16, 32>"]


TINY_MINILM = dict(vocab_size=97, hidden=64, num_layers=2, num_heads=2,
                   intermediate=128)


def test_minilm_phase_rehearses_on_the_cpu(monkeypatch):
    """Phase 17b-d on the CPU at tiny widths (head_dim 32 for MiniLM, 64
    for the seq-128 step): MiniLM serving (batched = single at tolerance
    0, against a second CPU Predictor), its parity and training lives,
    the seq-128 unfused step captured against eager bit for bit with
    dropout 0.1, the three branches' control lives within their limit,
    and BERT serving unfused; 17a (CUDA kernels) is stubbed, and so are
    the kernel counts, the profile, the capture and the card's memory
    (no card here)."""
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch import device, inference
    from paddle_tpu_torch.framework import executor
    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    cpu = torch.device("cpu")
    for mod in (device, executor, inference):
        if hasattr(mod, "resolve_device"):
            monkeypatch.setattr(mod, "resolve_device",
                                lambda place=None: cpu)
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    info = executor.Executor.cache_info

    def captured(self):
        out = info(self)
        for e in out["entries"]:
            e["aot"] = True
            e["manifest"] = 0
        return out
    monkeypatch.setattr(executor.Executor, "cache_info", captured)
    monkeypatch.setattr(smoke, "MINILM", TINY_MINILM)
    monkeypatch.setattr(smoke, "MINILM_SERVE_SEQ", 32)
    monkeypatch.setattr(smoke, "MINILM_PARITY", dict(
        TINY_MINILM, batch_size=2, seq_len=32, max_predictions=5))
    monkeypatch.setattr(smoke, "MINILM_TRAIN", dict(
        TINY_MINILM, batch_size=2, seq_len=32, max_predictions=5))
    monkeypatch.setattr(smoke, "SEQ128", dict(TINY_BERT, num_layers=2))
    monkeypatch.setattr(smoke, "SERVE_BERT", dict(
        vocab_size=97, hidden=128, num_layers=2, num_heads=2,
        intermediate=256, seq_len=32))
    monkeypatch.setattr(smoke, "BERT", dict(smoke.BERT, seq_len=32,
                                            vocab_size=97))
    monkeypatch.setattr(smoke, "ASYNC_STEPS", 2)
    monkeypatch.setattr(smoke, "MINILM_STEPS", 3)
    monkeypatch.setattr(smoke, "SEQ128_STEPS", 3)
    monkeypatch.setattr(smoke, "read_counts",
                        lambda fa: (smoke.Launches((0,) * 6), 0, 0))
    wants, serving = [], []
    real_want, real_serving = smoke.per_step_launches, smoke.serving_launches

    def want(main):
        wants.append(real_want(main))
        return (0,) * 6

    def served(main):
        serving.append(real_serving(main))
        return (0,) * 6
    monkeypatch.setattr(smoke, "per_step_launches", want)
    monkeypatch.setattr(smoke, "serving_launches", served)
    monkeypatch.setattr(smoke, "forward_products", lambda main: 0)
    monkeypatch.setattr(smoke, "profiled_launches",
                        lambda call, fa, what, key, strict=True: smoke
                        .PROFILES.__setitem__(key, dict(
                            busy_ms=None, call=call(),
                            attention_kernels=[
                                f"fa_{k}_tc_kernel<__nv_bfloat16, 32>"
                                for k in ("dkv", "dq", "fwd")])))
    monkeypatch.setattr(smoke, "minilm_kernels", lambda fa, device: {})
    monkeypatch.setattr(smoke, "second_signature", lambda *a: None)
    monkeypatch.setattr(smoke, "MINILM_RUN", {})
    monkeypatch.setattr(smoke, "SEQ128_RUN", {})
    monkeypatch.setattr(smoke, "log", lambda msg: None)
    seed = registry._OP_SEED[0]
    paths, rows = smoke.minilm_flagship(tpt, fa, cpu, "a card")
    assert registry._OP_SEED[0] == seed  # put back for phase 10
    assert rows == {}
    assert sorted(paths) == ["minilm_flagship", "minilm_parity",
                             "minilm_serving", "seq128_serving",
                             "seq128_unfused"]
    n = TINY_MINILM["num_layers"]
    # MiniLM parity and training, the seq-128 step, its three lives
    assert wants == [(0, 0, 0, n, n, n)] * 2 + [(0,) * 6] * 3 + [
        (n, n, n, 0, 0, 0)]
    assert serving == [(0, 0, 0, n, 0, 0), (0,) * 6]
    r, q = smoke.MINILM_RUN, smoke.SEQ128_RUN
    assert len(r["losses"]) == 3 and np.isfinite(r["losses"]).all()
    assert r["serving"]["card_vs_cpu"] == 0.0
    assert q["captured_bit_equal"]
    assert sorted(q["control_rel"]) == ["einsum", "packed_flash"]
    assert max(q["control_rel"].values()) <= smoke.SEQ128_LOSS_RTOL
    assert q["serving"]["card_vs_cpu"] == 0.0


def test_a_failed_fleet_phase_prints_its_dead_replicas_logs(monkeypatch):
    """fleet_workdir: a failure inside prints the end of each replica log
    that shows a death (a second life, a bind error, a traceback), not a
    healthy one's, then the failure goes on up and the directory goes."""
    from paddle_tpu_torch.serving.fleet import BIND_ERROR

    lines = []
    monkeypatch.setattr(smoke, "log", lines.append)
    life = "replica 0 listening on http://127.0.0.1:20001 (restart 0)\n"
    logs = {"replica-0": life + life.replace("restart 0", "restart 1"),
            "replica-1": life + f"{BIND_ERROR}: pid 7 port 20002 errno 98 "
            f"(EADDRINUSE): Address already in use\n",
            "replica-2": life + "replica 2 ready (buckets primed)\n"}
    with pytest.raises(AssertionError, match="scenario failed"):
        with smoke.fleet_workdir("chip_smoke_test_", "13b") as fd:
            for name, text in logs.items():
                os.makedirs(os.path.join(fd, "fleet", name))
                with open(os.path.join(fd, "fleet", name, "replica.log"),
                          "w") as f:
                    f.write(text)
            raise AssertionError("scenario failed")
    assert not os.path.exists(fd)
    shown = "\n".join(lines)
    assert "replica-0/replica.log" in shown and "restart 1" in shown
    assert "replica-1/replica.log" in shown and "EADDRINUSE" in shown
    assert "replica-2" not in shown
    assert lines[-1].endswith("2 replica log(s) showed a death")


def test_wide_deep_phase_runs_the_criteo_layout():
    """Phase 18 runs wide_deep_net's defaults (the Criteo layout) at batch
    4096, uncut, with Adam 1e-3 over 6 steps."""
    assert smoke.WIDE_DEEP == dict(num_sparse=26, num_dense=13,
                                   vocab_size=1000001, embed_dim=10,
                                   hidden=(400, 400, 400))
    assert (smoke.WIDE_DEEP_BATCH, smoke.WIDE_DEEP_LR,
            smoke.WIDE_DEEP_STEPS, smoke.WIDE_DEEP_ZIPF) == (4096, 1e-3, 6,
                                                             1.1)
    assert smoke.WIDE_DEEP_SERVE_BATCHES == (1, 64)


def test_zipf_ids_are_seeded_skewed_and_in_range():
    vocab = 1000001
    draw = lambda: smoke.zipf_ids(np.random.RandomState(3), 106496, vocab,
                                  np.random.RandomState(4).permutation(
                                      vocab))
    a, b = draw(), draw()
    assert a.dtype == np.int64 and a.shape == (106496,)
    np.testing.assert_array_equal(a, b)
    assert a.min() >= 0 and a.max() < vocab
    # Zipf(1.1): the hottest id takes ~1/8 of the draws
    assert np.bincount(a).max() > 10000
    feeds = smoke.wide_deep_feeds(smoke.WIDE_DEEP, 8, 2, 5)
    assert feeds[0]["sparse_ids"].shape == (8, 26)
    assert feeds[0]["dense_x"].shape == (8, 13)
    assert set(np.unique(feeds[1]["label"])) <= {0.0, 1.0}


def test_untouched_rows_are_the_ids_no_feed_looks_up():
    feeds = [{"sparse_ids": np.array([[0, 3], [3, 5]])},
             {"sparse_ids": np.array([[7, 0]])}]
    np.testing.assert_array_equal(smoke.untouched_rows(feeds, 9),
                                  [1, 2, 4, 6, 8])


@pytest.mark.parametrize("is_sparse,clip,want", [
    (False, None, 0), (True, None, 2), (True, "by_norm", 4),
    (True, "global_norm", 4)])
def test_merge_launches_reckon_each_selected_rows_reader(is_sparse, clip,
                                                          want):
    """Adam merges each sparse table's gradient once; a by-norm clip
    merges it and Adam merges the clipped one; a global-norm clip
    densifies each table's gradient at its square (once for both
    operands) and at its scaling, and Adam gets a dense one.  The
    reckoning is held to a CPU step's plain merges."""
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch.models import wide_deep_net

    tpt.reset_unique_name()
    main, startup = tpt.Program(), tpt.Program()
    clips = {"by_norm": lambda: tpt.clip.GradientClipByNorm(1.0),
             "global_norm": lambda: tpt.clip.GradientClipByGlobalNorm(1.0)}
    with tpt.program_guard(main, startup):
        net = wide_deep_net(num_sparse=3, vocab_size=50, embed_dim=2,
                            hidden=(4,), is_sparse=is_sparse)
        tpt.optimizer.AdamOptimizer(
            1e-3, grad_clip=clips[clip]() if clip else None).minimize(
                net["loss"])
    assert smoke.merge_launches(main) == want
    assert smoke.merge_launches(main, ["deep_embedding_w@GRAD"]) == \
        want + is_sparse
    from paddle_tpu_torch.ops.cuda import selected_rows

    exe, scope = tpt.Executor(tpt.CPUPlace()), tpt.Scope()
    exe.run(startup, scope=scope)
    feed = smoke.wide_deep_feeds(dict(num_sparse=3, num_dense=13,
                                      vocab_size=50), 8, 1, 3)[0]
    calls = selected_rows.merge_rows_reference.calls
    exe.run(main, feed=feed, fetch_list=[net["loss"]], scope=scope)
    assert selected_rows.merge_rows_reference.calls - calls == want


def _count_merges(tpt):
    """A CPU run's plain merges, read as the kernel's launches."""
    from paddle_tpu_torch.ops.cuda import selected_rows

    def read(fa):
        counts = smoke.Launches((0,) * 6)
        counts.merge = selected_rows.merge_rows_reference.calls
        return counts, 0, 0

    def reset(fa):
        selected_rows.merge_rows_reference.calls = 0
    return read, reset


def test_wide_deep_phase_rehearses_on_the_cpu(monkeypatch):
    """Phase 18 on the CPU at a tiny width (4 slots, 1000 ids, embed 4,
    hidden (16, 16), batch 64, 3 steps): the dense, sparse and lazy lives
    (their merges, here the plain version's, counted against the
    reckoning), sparse against dense, the CPU life, the second lazy life
    and the eager one bit for bit, untouched rows, and serving at batches
    1 and 2; the card, the capture and the profile are stubbed."""
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch import device, inference
    from paddle_tpu_torch.framework import executor
    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    cpu = torch.device("cpu")
    for mod in (device, executor, inference):
        if hasattr(mod, "resolve_device"):
            monkeypatch.setattr(mod, "resolve_device",
                                lambda place=None: cpu)
    for name in ("synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    info = executor.Executor.cache_info

    def captured(self):
        out = info(self)
        for e in out["entries"]:
            e["aot"] = True
        return out
    monkeypatch.setattr(executor.Executor, "cache_info", captured)
    monkeypatch.setattr(smoke, "WIDE_DEEP", dict(
        num_sparse=4, num_dense=13, vocab_size=1000, embed_dim=4,
        hidden=(16, 16)))
    monkeypatch.setattr(smoke, "WIDE_DEEP_BATCH", 64)
    monkeypatch.setattr(smoke, "WIDE_DEEP_STEPS", 3)
    monkeypatch.setattr(smoke, "WIDE_DEEP_SERVE_BATCHES", (1, 2))
    read, reset = _count_merges(tpt)
    monkeypatch.setattr(smoke, "read_counts", read)
    monkeypatch.setattr(smoke, "reset_counts", reset)
    monkeypatch.setattr(smoke, "forward_products", lambda main: 0)
    profiled = []
    monkeypatch.setattr(smoke, "profile_wide_deep",
                        lambda *a: profiled.append(a[-1]))
    monkeypatch.setattr(smoke, "WIDE_DEEP_RUN", {})
    monkeypatch.setattr(smoke, "log", lambda msg: None)
    seed = registry._OP_SEED[0]
    paths = smoke.wide_deep_flagship(tpt, fa, "a card")
    assert registry._OP_SEED[0] == seed
    assert sorted(paths) == ["wide_deep_dense", "wide_deep_lazy",
                             "wide_deep_serving", "wide_deep_sparse"]
    # two tables: one merge each a step where they are sparse
    assert [paths[f"wide_deep_{k}"].merge
            for k in ("dense", "sparse", "lazy")] == [0, 6, 6]
    r = smoke.WIDE_DEEP_RUN
    assert r["merge_launches_a_step"] == dict(dense=0, sparse=2, lazy=2)
    assert r["sparse_vs_dense"]["loss_rel"] <= smoke.WIDE_DEEP_LOSS_RTOL
    assert r["card_vs_cpu"]["loss_rel"] == 0.0
    assert r["serving"]["batched_equals_single"]
    assert sorted(r["replay_ms"]) == ["dense", "lazy", "sparse"]
    assert profiled == ["wide_deep_lazy"]
