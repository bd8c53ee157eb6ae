"""chip_smoke.py's phase 2 reads ptxas's report and cuobjdump's SASS by
kernel name: every instantiation it checks (CHECKED_KERNELS: the bf16
tensor-core kernels, the fp32 forward and the fp32 backward) must come back
from ``kernel_label`` under the name the check looks up, or the spill check
fails on the card with "ptxas printed no spill line".  The mangled names
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


# ---------------------------------------------------------------------------
# phase 12: the fleet
# ---------------------------------------------------------------------------

def _argv_value(argv, flag):
    return argv[list(argv).index(flag) + 1]


def test_fleet_generation_replicas_run_llama_2_7b_at_the_card_config():
    """Phase 12b's replicas: Llama-2-7B's widths and 32 layers, MHA, 4
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
    """13b's generation: poison_paged and spec_storm on Llama-2-7B at 32
    layers in pages of 16 with phase 10c's buckets (bucket 8 for the
    verify); disagg_crash on four replicas of Llama-2-7B's widths at 4
    layers (the one depth cut), their prompts (4-48 tokens) inside the
    64-token bucket; the replica's parser accepts the argv."""
    from paddle_tpu_torch.serving import replica

    assert smoke.GEN["num_layers"] == 32
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
