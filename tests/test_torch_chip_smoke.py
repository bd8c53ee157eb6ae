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
