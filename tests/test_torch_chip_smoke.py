"""chip_smoke.py's phase 2 reads ptxas's report and cuobjdump's SASS by
kernel name: every instantiation it checks (CHECKED_KERNELS: the bf16
tensor-core kernels, the fp32 forward and the fp32 backward) must come back
from ``kernel_label`` under the name the check looks up, or the spill check
fails on the card with "ptxas printed no spill line".  The mangled names
here follow the Itanium C++ ABI as nvcc emits it for the kernels in
paddle_tpu_torch/csrc/ (anonymous namespace, then namespace tc or f32)."""
import importlib.util
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


def _mangle(label):
    """The mangled name of the kernel `label` names: 'fa_dq_tc_kernel<bf16,
    128>' is namespace tc's fa_dq_tc_kernel<128>, 'fa_dkv_f32_kernel<64,
    4>' namespace f32's fa_dkv_f32_kernel<64, 4>; parameters as the
    kernels take them (TMA maps for tc, float pointers for f32)."""
    name, args = re.fullmatch(r"(\w+)<(.*)>", label).groups()
    args = [a.strip() for a in args.split(",")]
    if args[0] == "bf16":
        ns, ints, params = "tc", args[1:], "N6hopper7TmaMapsILi4EEEPKfS6_"
    else:
        ns, ints, params = "f32", args, "PKfS3_S3_S3_S3_S3_S3_PfS4_S4_"
    targs = "".join(f"Li{a}E" for a in ints)
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


# ---------------------------------------------------------------------------
# phase 10: generation serving
# ---------------------------------------------------------------------------

def test_generation_phase_runs_llama_2_7b_at_the_card_configuration():
    """The flagship engine: Llama-2-7B's widths and 32 layers, 4 slots of
    1024 positions, buckets 64-512; 8 prompts of 20-500 tokens that land
    in every bucket, each with its 64 new tokens inside the cache (so
    every request ends 'length'); the parity config keeps the widths."""
    assert smoke.GEN == dict(vocab_size=32000, hidden=4096, num_heads=32,
                             intermediate=11008, num_layers=32)
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
