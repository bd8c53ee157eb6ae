#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 off for matmuls and cuDNN.
2. build: every CUDA source under paddle_tpu_torch/csrc/ with nvcc for
   sm_90a (one nvcc per source, started together; anew, even where a
   library is already built, since the checks read ptxas's report),
   timed, then loaded;
   ptxas's registers and spills per kernel, and per kernel function the
   count of HGMMA (wgmma) and UTMALDG (TMA load) instructions in
   cuobjdump's SASS.  Each bfloat16 tensor-core kernel (fa_fwd_tc_kernel,
   fa_dq_tc_kernel, fa_dkv_tc_kernel, at D 64 and 128) must show HGMMA in
   its own code, the proof that the tensor cores run, and spill nothing;
   nor may the fp32 forward (fa_fwd_f32_kernel at D 64 and 128, 16- and
   64-row q tiles) or the fp32 backward (fa_dkv_f32_kernel and
   fa_dq_f32_kernel, 8-warp blocks of 128 rows at D 64 and 64 at D 128);
   a ptxas warning
   C7508 (setmaxnreg ignored) or C7512 (wgmmas serialised for want of
   registers) fails the phase.
   Each source picks its kernel by dtype: bfloat16 runs the tensor-core
   kernels, float32 the CUDA-core ones (fa_fwd_f32_kernel,
   fa_dkv_f32_kernel, fa_dq_f32_kernel: exact fp32 FMAs, no TF32).  So the
   bf16 cases of phases 3 and 7 and the bf16 training phases 6 and 9 run
   the tensor-core kernels, while the fp32 gates (phases 4, 5, 8) run the
   CUDA-core ones.
3. packed kernels: each against its plain PyTorch version on the card,
   at BERT-base's serving shape (B=4, S=128, H=768, 12 heads), at the
   flagship training shape (B=8, S=512, H=768, 12 heads: 8 kv and 8 q
   tiles), at H=256/2 heads (head_dim 128) and at a ragged S=100; with
   and without bias, causal and not, one all-padding bias row; fp32 and
   bf16 (bf16 against the fp32 plain version on the same bf16-rounded
   inputs).
   * forward: fp32 out atol 2e-5, lse atol 1e-5; bf16 out atol 2e-2
     (a causal row's first keys give outputs up to ~3, and the bf16
     output rounds them by 2**-9 relative).
     The all-padding row's scores sit near -1e4, where one fp32 ulp is
     2**-10, so that row is held to half an ulp (out) and one ulp (lse).
   * backward (dK/dV and dQ kernels): fp32 dqkv atol 1e-4 (sums of up to
     S=512 O(1) products in another order: ~sqrt(512) * 2**-24 relative
     on values up to ~10); bf16 dqkv atol 5e-2 (the kernels round their
     output to bf16: 2**-8 relative on values up to ~10); dbias atol
     1e-4, float32 on both sides.  In the all-padding row p = exp(s -
     lse) has s and lse near -1e4, good to ~2**-9 relative, so that row
     is held to 2**-6.
   * bf16 out, dq, dk and dv also relative to their own size: per (batch,
     head, block of 128 rows) ||got - ref|| / ||ref|| <= 1e-2 over the
     live batch rows.  A row over n keys has values near sqrt(e / n),
     which at S 512-2048 are as small as the absolute limits; the
     tensor-core kernels round P (forward), dS (dQ) or P^T and dS^T
     (dK/dV) to bf16 before the second product (~2**-9 relative a term)
     and the output again: ~4e-3.
   Then times: the fp32 forward at BERT-base serving's batch 1, 4 and 8,
   at the flagship training shape and at the Llama shape (causal), the
   bf16 forward at the flagship training shape, the backward kernels at
   the flagship shape (bf16, and fp32), each beside its plain version and
   a PyTorch yardstick: scaled_dot_product_attention (forward) and its
   backward through torch.autograd.grad (backward).  Kernel and yardstick
   each get two times: CUDA events around back-to-back calls (cuda_ms),
   which include the host's work between launches and so read the host's
   pace for a call of ~20 us, and the device's own time (device_ms: the
   kernels' self device time under torch.profiler over the calls).  The
   timed calls' results are held to the same tolerances.
4. serving at full width: BERT-base built as __graft_entry__.entry()
   configures it (hidden 768, 12 layers, 12 heads, intermediate 3072,
   vocab 30522, seq 128, random weights from the startup program), saved
   with io.save_inference_model, loaded by inference.Predictor on the
   card, answering batch 1, 4 and 8 at seq 128 with padding in
   attn_mask.  Every kernel count is set to 0 just before and read just
   after: each request must launch the forward kernel exactly 12 times,
   no backward kernel, and never call a plain version.  The batch-4
   request runs again through Predictor(dir, device="cpu"): logits max
   abs diff <= 1e-3 and loss rel diff <= 1e-4 (fp32, TF32 off).
5. training parity at full width: BERT-base (seq 128, batch 2,
   max_predictions 19), fp32 with TF32 off, dropout 0, bench.py's Adam
   and global-norm clip with a short warmup (lr 0, 5e-4, 1e-3) so the
   weights move; 3 Executor.run steps on the card and 3 on the port's
   CPU path from one startup scope, copied.  Loss rel diff <= 1e-4 at
   every step; step-1 gradients max abs diff <= 1e-3 of their largest
   value; parameters after step 3 within 2 * (sum of the LRs) everywhere
   (Adam moves an element with a near-zero gradient by ~lr whatever its
   sign) and within 1e-5 on 99.9% of all elements.  Each card step
   launches 24 forward kernels (12 forward, 12 recomputed in the grad
   ops), 12 dK/dV and 12 dQ.  Then one fp32 step at bench.py's seq-512
   shape (BERT-base, batch 8, max_predictions 77, no AMP, dropout 0, the
   phase's optimizer), after one warm step, under torch.profiler and not
   counted in the path's launches: device busy and idle share, the fp32
   backward kernels' device time and share of the step, and exactly 24 /
   12 / 12 launches.
6. flagship training: bench.py's seq-512 leg through Executor.run:
   BERT-base, seq 512, batch 8, max_predictions 77, bf16 AMP with the
   bench's extra white list, dropout 0.1, warmup 1e-4 over 10000 steps;
   6 steps.  Each step's host time (ending in the loss fetch), a finite
   loss at every step, peak device memory, exactly 24 / 12 / 12 kernel
   launches per step and no call of a plain version; then a
   torch.profiler view of one more step (not counted).
7. unpacked kernels (the flash_attention op's forward, dK/dV and dQ),
   each against its plain version on the card: at Llama-2-7B's attention
   shape (B 1, 32 heads, S 2048, D 128, causal), at D 64, a ragged S 100,
   Sq != Sk both ways (128 / 384), with and without a bias holding one
   all-padding row, on contiguous tensors and on the [B, H, S, D] views of
   [B, S, H, D] buffers that transpose2 and rope leave; fp32 and bf16.
   Tolerances as in phase 3 and for the same reasons: fp32 out 2e-5, lse
   1e-5, grads 1e-4; bf16 out 2e-2, grads 5e-2 (output rounding) and
   1e-2 relative per 128-row block; dbias 1e-4; the all-padding row half /
   one fp32 ulp at 1e4 (out / lse) and 2**-6 (grads).  Then times
   (events and device, as in phase 3) at the Llama shape (causal), in
   bf16 and in fp32: the three kernels, their plain versions, and
   scaled_dot_product_attention(is_causal=True) forward and its backward
   through torch.autograd.grad as the yardstick; the timed results are
   held to the same tolerances.
8. Llama training parity at full width: Llama-2-7B's widths (vocab 32000,
   hidden 4096, 32 heads, intermediate 11008) at 1 layer, seq 128, batch
   2, fp32 with TF32 off, AdamW(1e-3, weight_decay 0.01); 3 Executor.run
   steps on the card and 3 on the port's CPU path from one startup scope,
   copied.  Loss rel diff <= 1e-4 at every step, step-1 gradients within
   1e-3 of their largest value, parameters after step 3 within 2 * (sum
   of the LRs) everywhere and 1e-5 on 99.9% of all elements (as phase
   5).  Each card step launches the unpacked forward kernel twice (the
   forward and its recomputation in flash_attention_grad), dK/dV and dQ
   once, and no packed kernel.
9. Llama flagship training: build_llama_train at Llama-2-7B's widths, 4
   layers (all 32 would need ~108 GB of fp32 weights, grads and AdamW
   moments), batch 1, seq 2048, bf16 AMP, AdamW(1e-4, weight_decay 0.01)
   as __graft_entry__.py builds it, random token ids from a numpy seed;
   6 steps.  Each step's host time (ending in the loss fetch) and
   tokens/s, a finite loss at every step, within 1e-3 (relative) of the
   losses the CUDA-core kernels gave on the same seeds before the
   tensor-core ones replaced them (LLAMA_LOSSES_CUDA_CORES; bf16 rounds at
   other places in the new kernels), peak device memory,
   exactly 8 / 4 / 4 launches of the unpacked kernels per step, none of the
   packed ones, no call of a plain version; then a profiled step.

On every path (phases 4, 5, 6, 8, 9) no bfloat16 operand is copied to
meet TMA's 16-byte alignment: the launching wrappers' ".realigned"
counts stay 0.

The "launches" of each kernel in the kernels line is its count on its
slice's main path: phase 6 (BERT training) for the packed kernels,
phase 9 (Llama training) for the unpacked ones.  "launches_by_path" has
beside it the count of every path, each read from 0: serving (phase 4),
training_parity (phase 5, card steps), training_flagship (phase 6),
llama_parity (phase 8, card steps) and llama_flagship (phase 9).  The
four backward entries also carry "f32": their fp32 kernel's device_ms,
ms, bound_ms and SDPA's fp32 backward's library_device_ms at the same
shape (BERT's training shape for the packed, the Llama shape for the
unpacked ones).  The last lines are the card's name and power limit, one
{"kernels": ...} JSON line, and {"ok": true, "device": {...}}.
"""
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, at the card's 700 W power limit): HBM3
# bandwidth, the fp32 rate outside the tensor cores and the dense bf16
# tensor-core rate.  A kernel's bound uses the peak for its inputs' type.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"float32": 67e12, "bfloat16": 989e12}

BERT = dict(batch_size=4, seq_len=128, vocab_size=30522, hidden=768,
            num_layers=12, num_heads=12, intermediate=3072)
FP32_OUT_ATOL, FP32_LSE_ATOL, BF16_OUT_ATOL = 2e-5, 1e-5, 2e-2
DEAD_OUT_ATOL, DEAD_LSE_ATOL = 2.0 ** -11, 2.0 ** -10
FP32_DQKV_ATOL, BF16_DQKV_ATOL, DBIAS_ATOL = 1e-4, 5e-2, 1e-4
DEAD_GRAD_ATOL = 2.0 ** -6
# bf16 out and grads also held relative to their own size, per (batch,
# head, block of REL_BLOCK rows): ||got - ref|| / ||ref||.  The absolute
# limits are set by a causal row's first keys, where values are O(1); a
# row over n keys has values near sqrt(e / n), 0.035-0.05 at S 2048, as
# small as the limits themselves.  Rounding P (forward), dS (dQ) or P^T and
# dS^T (dK/dV) to bf16 costs ~2**-9 relative a term and the bf16 output
# another 2**-9: ~4e-3 together, inside 1e-2.
BF16_REL_LIMIT, REL_BLOCK = 1e-2, 128
REL_NAMES = ("out", "dq", "dk", "dv")
LOGITS_ATOL, LOSS_RTOL = 1e-3, 1e-4

# bench.py's training step (_run_config_once) and its BENCH_BF16_STREAM
# white list
EXTRA_WHITE = ["lookup_table", "lookup_table_v2", "layer_norm",
               "elementwise_add", "elementwise_mul", "dropout", "gelu",
               "relu", "scale", "transpose2", "reshape2", "gather_nd",
               "squeeze2", "unsqueeze2", "flash_attention",
               "flash_attention_qkv", "softmax"]
BERT_BASE = dict(vocab_size=30522, hidden=768, num_layers=12, num_heads=12,
                 intermediate=3072)
PARITY = dict(BERT_BASE, batch_size=2, seq_len=128, max_predictions=19)
PARITY_LR = dict(learning_rate=1e-3, warmup_steps=2, start_lr=0.0,
                 end_lr=1e-3)
PARITY_LRS = (0.0, 5e-4, 1e-3)
PARITY_GRAD_RTOL, PARITY_PARAM_ATOL = 1e-3, 1e-5
FLAGSHIP = dict(BERT_BASE, batch_size=8, seq_len=512,
                max_predictions=int(round(0.15 * 512)))
FLAGSHIP_LR = dict(learning_rate=1e-4, warmup_steps=10000, start_lr=0.0,
                   end_lr=1e-4)
FLAGSHIP_STEPS = 6

# Llama-2-7B's widths (BASELINE.json's "Llama-2-7B", models/llama.py's
# defaults): head_dim 128, multi-head (num_kv_heads = num_heads)
LLAMA = dict(vocab_size=32000, hidden=4096, num_heads=32,
             intermediate=11008)
LLAMA_PARITY = dict(LLAMA, num_layers=1, batch_size=2, seq_len=128)
LLAMA_PARITY_LR = 1e-3
LLAMA_FLAGSHIP = dict(LLAMA, num_layers=4, batch_size=1, seq_len=2048)
LLAMA_FLAGSHIP_LR = 1e-4
# phase 9's six losses with the attention kernels on the CUDA cores
# throughout (before the bf16 forward and dQ moved to the tensor cores), on
# one H100 80GB HBM3 at 700 W: the yardstick of the tensor-core kernels'
# losses on the same seeds.  Those read 10.49628, 10.48460, 10.48037,
# 9.89261, 9.86534, 9.88588 in every run on that card, at most 4.71e-5
# relative from these; the limit is about 20 times that.
LLAMA_LOSSES_CUDA_CORES = (10.49620, 10.48460, 10.48037, 9.89279, 9.86580,
                           9.88604)
LLAMA_LOSS_RTOL = 1e-3
# the unpacked kernels' grads in fp32 and bf16 (as the packed ones')
FP32_GRAD_ATOL, BF16_GRAD_ATOL = 1e-4, 5e-2
# the bf16 tensor-core kernels, each built at D 64 and 128
TC_KERNELS = ("fa_fwd_tc_kernel", "fa_dq_tc_kernel", "fa_dkv_tc_kernel")
# the fp32 forward (template <D, warps a block>), built at D 64 and 128
# with 16-row (2 warps of 8 rows) and 64-row (8 warps) q tiles
F32_FWD_KERNELS = tuple(f"fa_fwd_f32_kernel<{D}, {w}>" for D in (64, 128)
                        for w in (2, 8))
# the fp32 backward (template <D, row groups a warp>), 8-warp blocks built
# at D 64 with 4 row groups (128 keys for dK/dV, 128 q rows for dQ) and at
# D 128 with 2 (64 keys, 64 q rows)
F32_BWD_KERNELS = tuple(f"{k}<{D}, {rg}>" for k in ("fa_dkv_f32_kernel",
                                                   "fa_dq_f32_kernel")
                        for D, rg in ((64, 4), (128, 2)))
# every kernel instantiation phase 2 holds to its checks, by kernel_label
TC_LABELS = tuple(f"{kernel}<bf16, {D}>" for kernel in TC_KERNELS
                  for D in (64, 128))
CHECKED_KERNELS = TC_LABELS + F32_FWD_KERNELS + F32_BWD_KERNELS


def log(msg):
    print(msg, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()


def cuda_ms(fn, iters, warmup=10):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters, warmup=3, names=None):
    """Device time per call of `fn`: torch.profiler's self device time of
    each kernel that `iters` back-to-back calls launched, as its mean time
    a launch times its launches a call (count / iters, rounded: a session
    now and then drops some of its records), summed over the kernels.
    The host's work between the launches (wrapper, allocation, ctypes) is
    not in it, as it is in cuda_ms's event time wherever the host, not the
    kernel, sets the pace.  A list given as `names` gets (kernel name, us a
    call) of each kernel, longest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a session now and then records nothing at all
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        per_call = sorted(
            ((e.key, e.self_device_time_total / e.count
              * max(1, round(e.count / iters)))
             for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and e.count > 0), key=lambda x: -x[1])
        us = sum(t for _, t in per_call)
        if us > 0:
            if names is not None:
                names[:] = per_call
            return us / 1e3
    raise AssertionError("the profiler saw no device time in three tries")


def timed(fn, iters, warmup=3, device_iters=None, names=None):
    """(event ms, device ms) per call of `fn`: cuda_ms over `iters`
    back-to-back calls and device_ms over `device_iters` (default
    iters; `names` as device_ms takes it)."""
    return (cuda_ms(fn, iters, warmup),
            device_ms(fn, device_iters or iters, warmup, names))


def log_kernels(what, names, top=3):
    """One line: the longest kernels of a timed call, with us a call."""
    log(f"  {what} runs: " + "; ".join(
        f"{name[:110]} {us:.1f} us" for name, us in names[:top]))


def block_rel_err(got, want):
    """max over (batch, head, block of REL_BLOCK rows) of ||got - want|| /
    ||want|| for [B, H, S, D] tensors: inf where want is 0 and got is not,
    0 where both are."""
    import torch
    import torch.nn.functional as F

    B, H, S, D = want.shape
    pad = -S % REL_BLOCK
    diff, ref = (F.pad(t, (0, 0, 0, pad)).reshape(B, H, -1, REL_BLOCK * D)
                 for t in (got.float() - want.float(), want.float()))
    num, den = diff.norm(dim=-1), ref.norm(dim=-1)
    return torch.where(num == 0, torch.zeros_like(num), num / den).max().item()


def packed_rel_errs(got, want, nh, H):
    """block_rel_err of each H-wide column block of packed [B, S, n * H]
    tensors (out; or the q, k and v blocks of d(qkv)), heads split out."""
    def heads(x):
        B, S, _ = x.shape
        return x.reshape(B, S, nh, H // nh).transpose(1, 2)

    return [block_rel_err(heads(got[..., j:j + H]), heads(want[..., j:j + H]))
            for j in range(0, got.shape[-1], H)]


def kernel_cases():
    """(name, B, S, H, nh, causal, bias kind, dtype)"""
    cases = []
    for dtype in ("float32", "bfloat16"):
        for B, S, H, nh in ((4, 128, 768, 12), (8, 512, 768, 12),
                            (2, 128, 256, 2), (3, 100, 768, 12),
                            (2, 100, 256, 2)):
            for causal in (False, True):
                for bias in ("none", "pad_dead_row"):
                    cases.append((f"{dtype}_B{B}_S{S}_H{H}_nh{nh}_"
                                  f"{'causal' if causal else 'full'}_{bias}",
                                  B, S, H, nh, causal, bias, dtype))
    return cases


def make_inputs(B, S, H, bias_kind, seed, device, dtype):
    import torch

    rng = np.random.RandomState(seed)
    qkv = torch.from_numpy(rng.randn(B, S, 3 * H).astype("float32"))
    qkv = qkv.to(device=device, dtype=getattr(torch, dtype)).contiguous()
    bias = None
    if bias_kind != "none":
        mask = (rng.rand(B, S) > 0.2).astype("float32")
        mask[:, 0] = 1.0
        mask[-1] = 0.0  # the last batch row is all padding
        bias = torch.from_numpy(mask * 1e4 - 1e4).to(device)
    return qkv, bias


def check_kernel(fa, device):
    import torch

    for i, (name, B, S, H, nh, causal, bias_kind, dtype) in enumerate(
            kernel_cases()):
        qkv, bias = make_inputs(B, S, H, bias_kind, 100 + i, device, dtype)
        out, lse = fa.flash_attention_packed(qkv, bias, nh, causal)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_packed_reference(
            qkv.float(), bias, nh, causal)
        err = (out.float() - ref_out).abs()
        lerr = (lse - ref_lse).abs()
        live = slice(0, B - 1) if bias is not None else slice(0, B)
        out_live = err[live].max().item()
        lse_live = lerr[live].max().item()
        tol = FP32_OUT_ATOL if dtype == "float32" else BF16_OUT_ATOL
        ok = out_live <= tol and lse_live <= FP32_LSE_ATOL
        msg = (f"  {name}: out max|err| {out_live:.3e} (atol {tol:g}), "
               f"lse {lse_live:.3e} (atol {FP32_LSE_ATOL:g})")
        if dtype == "bfloat16":
            rel, = packed_rel_errs(out[live], ref_out[live], nh, H)
            ok = ok and rel <= BF16_REL_LIMIT
            msg += f", out rel {rel:.3e} (limit {BF16_REL_LIMIT:g})"
        if bias is not None:
            out_dead = err[B - 1].max().item()
            lse_dead = lerr[B - 1].max().item()
            dead_tol = DEAD_OUT_ATOL if dtype == "float32" else BF16_OUT_ATOL
            ok = ok and out_dead <= dead_tol and lse_dead <= DEAD_LSE_ATOL
            msg += (f"; all-padding row out {out_dead:.3e} (atol "
                    f"{dead_tol:g}), lse {lse_dead:.3e} (atol "
                    f"{DEAD_LSE_ATOL:g})")
        if not (torch.isfinite(out.float()).all() and
                torch.isfinite(lse).all()):
            ok = False
            msg += "; NON-FINITE"
        log(msg)
        if not ok:
            raise AssertionError(f"kernel disagrees with its plain version: "
                                 f"{name}")


# The fp32 forward's timed shapes: (name, B, heads, S, D, causal, packed,
# event iterations): BERT-base serving at batch 1, 4 and 8 (packed, seq
# 128, padding bias), BERT's training shape (B 8, S 512) and the Llama
# shape (unpacked, causal, [B, H, S, D] views of [B, S, H, D] buffers).
FWD_F32_SHAPES = (("serving_B1", 1, 12, 128, 64, False, True, 200),
                  ("serving_B4", 4, 12, 128, 64, False, True, 200),
                  ("serving_B8", 8, 12, 128, 64, False, True, 200),
                  ("training", 8, 12, 512, 64, False, True, 20),
                  ("llama", 1, 32, 2048, 128, True, False, 5))


def time_forward_f32(fa, device):
    """The fp32 forward kernel at FWD_F32_SHAPES, beside its plain version
    and scaled_dot_product_attention in fp32 (a float mask from the bias,
    or is_causal): event ms of back-to-back calls and device ms
    (device_ms) of the kernel and of SDPA; the bound from this run's
    inputs.  Each timed result is held to the plain version (out 2e-5, lse
    1e-5).  Returns {shape name: row}."""
    import torch
    import torch.nn.functional as F

    rows = {}
    for name, B, nh, S, D, causal, packed, iters in FWD_F32_SHAPES:
        H = nh * D
        if packed:
            qkv, bias = make_inputs(B, S, H, "pad_dead_row", 7, device,
                                    "float32")
            bias[-1] = 0.0  # the main path's shape, not its dead-row case
            x = qkv.view(B, S, 3, nh, D)
            q, k, v = (x[:, :, j].transpose(1, 2) for j in range(3))

            def call():
                return fa.flash_attention_packed(qkv, bias, nh)

            def plain():
                return fa.flash_attention_packed_reference(qkv, bias, nh)

            def lib():
                return F.scaled_dot_product_attention(
                    q, k, v, attn_mask=bias[:, None, None, :])

            nbytes = (qkv.numel() + bias.numel() + B * S * H
                      + B * nh * S) * 4
            flops = 4.0 * B * nh * S * S * D
        else:
            q, k, v, _, _ = unpacked_inputs(B, nh, S, S, D, "none", True, 17,
                                            device, "float32")

            def call():
                return fa.flash_attention_unpacked(q, k, v, None, causal)

            def plain():
                return fa.flash_attention_reference(q, k, v, None, causal)

            def lib():
                return F.scaled_dot_product_attention(q, k, v,
                                                      is_causal=causal)

            nbytes = 4 * B * nh * S * D * 4 + B * nh * S * 4
            flops = 4.0 * B * nh * D * S * (S + 1) / 2  # live pairs
        ms, dev = timed(call, iters, device_iters=max(5, iters // 4))
        plain_ms = cuda_ms(plain, max(2, iters // 4), warmup=1)
        lib_ms, lib_dev = timed(lib, iters, device_iters=max(5, iters // 4))
        out, lse = call()
        ref_out, ref_lse = plain()
        lib_out = lib()
        if packed:
            lib_out = lib_out.transpose(1, 2).reshape(B, S, H)
        err = (out - ref_out).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        lib_err = (lib_out - ref_out).abs().max().item()
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOP_PER_S["float32"] * 1e3
        rows[name] = dict(ms=ms, device_ms=dev, plain_ms=plain_ms,
                          library_ms=lib_ms, library_device_ms=lib_dev,
                          bound_ms=max(t_bytes, t_ops),
                          bound_by="bytes" if t_bytes >= t_ops
                          else "operations", max_abs_err=max(err, lse_err))
        log(f"  fp32 forward {name} (B={B} S={S} heads={nh} D={D}"
            f"{' causal' if causal else ', bias'}): kernel {ms:.5f} ms "
            f"events / {dev:.5f} ms device, sdpa {lib_ms:.5f} / "
            f"{lib_dev:.5f} ms, plain {plain_ms:.5f} ms, bound "
            f"{max(t_bytes, t_ops):.5f} ms ({rows[name]['bound_by']}: "
            f"{flops:.4g} flop, {nbytes} bytes); out max|err| {err:.3e}, "
            f"lse {lse_err:.3e} (sdpa vs plain {lib_err:.3e})")
        if not (err <= FP32_OUT_ATOL and lse_err <= FP32_LSE_ATOL):
            raise AssertionError(f"fp32 forward kernel disagrees with its "
                                 f"plain version at {name}")
        del out, lse, ref_out, ref_lse, lib_out, q, k, v
    torch.cuda.empty_cache()
    log("  (events: back-to-back calls, wrapper and host work included; "
        "device: the kernels' own time under torch.profiler)")
    return rows


def backward_inputs(fa, qkv, bias, nh, causal, seed):
    """The forward's out (in qkv's dtype) and lse from the plain version,
    and a random cotangent dout."""
    import torch

    out, lse = fa.flash_attention_packed_reference(qkv.float(), bias, nh,
                                                   causal)
    B, S, H3 = qkv.shape
    rng = np.random.RandomState(seed)
    dout = torch.from_numpy(rng.randn(B, S, H3 // 3).astype("float32"))
    return out.to(qkv.dtype), lse, dout.to(qkv.device, qkv.dtype)


def check_backward(fa, device):
    import torch

    for i, (name, B, S, H, nh, causal, bias_kind, dtype) in enumerate(
            kernel_cases()):
        qkv, bias = make_inputs(B, S, H, bias_kind, 300 + i, device, dtype)
        out, lse, dout = backward_inputs(fa, qkv, bias, nh, causal, 400 + i)
        dqkv, dbias = fa.flash_attention_packed_backward(
            qkv, bias, out, lse, dout, nh, causal)
        torch.cuda.synchronize()
        ref, ref_db = fa.flash_attention_packed_backward_reference(
            qkv.float(), bias, out.float(), lse, dout.float(), nh, causal)
        err = (dqkv.float() - ref).abs()
        live = slice(0, B - 1) if bias is not None else slice(0, B)
        tol = FP32_DQKV_ATOL if dtype == "float32" else BF16_DQKV_ATOL
        live_err = err[live].max().item()
        ok = live_err <= tol and bool(torch.isfinite(dqkv.float()).all())
        msg = f"  {name}: dqkv max|err| {live_err:.3e} (atol {tol:g})"
        if dtype == "bfloat16":
            rel = packed_rel_errs(dqkv[live], ref[live], nh, H)
            ok = ok and max(rel) <= BF16_REL_LIMIT
            msg += (", rel dq {:.3e}, dk {:.3e}, dv {:.3e}".format(*rel) +
                    f" (limit {BF16_REL_LIMIT:g})")
        if bias is not None:
            db_err = (dbias - ref_db)[live].abs().max().item()
            dead = max(err[B - 1].max().item(),
                       (dbias - ref_db)[B - 1].abs().max().item())
            ok = ok and db_err <= DBIAS_ATOL and \
                dead <= max(tol, DEAD_GRAD_ATOL)
            msg += (f", dbias {db_err:.3e} (atol {DBIAS_ATOL:g}); "
                    f"all-padding row {dead:.3e} (atol "
                    f"{max(tol, DEAD_GRAD_ATOL):g})")
        log(msg)
        if not ok:
            raise AssertionError(f"backward kernels disagree with their "
                                 f"plain version: {name}")


def time_backward(fa, device, dtype, library_kernels=None):
    """Times of the dK/dV and dQ kernels at the flagship training shape
    (B=8, S=512, 12 heads, padding bias, bias grad on, as the training
    step asks for it), the plain backward, and the backward of
    scaled_dot_product_attention (torch.autograd.grad with retain_graph
    over one forward, grads of q, k and v) as a yardstick; a list given as
    `library_kernels` gets the latter's kernels (device_ms's names)."""
    import torch
    import torch.nn.functional as F

    B, S, H, nh = FLAGSHIP["batch_size"], FLAGSHIP["seq_len"], 768, 12
    D = H // nh
    qkv, bias = make_inputs(B, S, H, "pad_dead_row", 17, device, dtype)
    bias[-1] = 0.0
    out, lse, dout = backward_inputs(fa, qkv, bias, nh, False, 18)
    scale = 1.0 / math.sqrt(D)
    fa.check_backward_inputs(qkv, bias, out, lse, dout, nh)
    delta = fa.backward_delta(out, dout, nh)
    dqkv = torch.empty_like(qkv)
    db_heads = torch.empty((B, nh, S), dtype=torch.float32, device=device)
    dkv_ms, dkv_dev = timed(lambda: fa.flash_attention_packed_dkv(
        qkv, bias, dout, lse, delta, dqkv, db_heads, nh, False, scale),
        iters=20, device_iters=5)
    dq_ms, dq_dev = timed(lambda: fa.flash_attention_packed_dq(
        qkv, bias, dout, lse, delta, dqkv, nh, False, scale),
        iters=20, device_iters=5)
    plain_ms = cuda_ms(lambda: fa.flash_attention_packed_backward_reference(
        qkv, bias, out, lse, dout, nh), iters=5, warmup=2)

    x = qkv.view(B, S, 3, nh, D)
    q, k, v = (x[:, :, j].transpose(1, 2).detach().requires_grad_(True)
               for j in range(3))
    lib_out = F.scaled_dot_product_attention(
        q, k, v, attn_mask=bias[:, None, None, :].to(qkv.dtype))
    g = dout.view(B, S, nh, D).transpose(1, 2)
    lib_kernels = [] if library_kernels is None else library_kernels
    library_ms, library_dev = timed(lambda: torch.autograd.grad(
        lib_out, (q, k, v), g, retain_graph=True), iters=20, device_iters=5,
        names=lib_kernels)
    log_kernels(f"sdpa's {dtype} backward", lib_kernels)

    dqkv, dbias = fa.flash_attention_packed_backward(qkv, bias, out, lse,
                                                     dout, nh)
    ref, ref_db = fa.flash_attention_packed_backward_reference(
        qkv.float(), bias, out.float(), lse, dout.float(), nh)
    err = (dqkv.float() - ref).abs()
    db_err = (dbias - ref_db).abs().max().item()
    tol = FP32_DQKV_ATOL if dtype == "float32" else BF16_DQKV_ATOL
    if dtype == "bfloat16":
        rel = packed_rel_errs(dqkv, ref, nh, H)
        log("  rel dq {:.3e}, dk {:.3e}, dv {:.3e}".format(*rel) +
            f" (limit {BF16_REL_LIMIT:g})")
        if not max(rel) <= BF16_REL_LIMIT:
            raise AssertionError("backward kernels disagree with their plain "
                                 "version at the flagship shape (relative)")
    elem = qkv.element_size()
    io = (qkv.numel() * elem + dout.numel() * elem + 2 * lse.numel() * 4
          + bias.numel() * 4)
    work = float(B * nh * S * S * D)
    rows = {}
    for name, flops, nbytes, ms, dev, e in (
            ("dkv", 8 * work, io + 2 * B * S * H * elem + db_heads.numel() * 4,
             dkv_ms, dkv_dev, max(err[..., H:].max().item(), db_err)),
            ("dq", 6 * work, io + B * S * H * elem, dq_ms, dq_dev,
             err[..., :H].max().item())):
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOP_PER_S[dtype] * 1e3
        rows[name] = dict(ms=ms, device_ms=dev, plain_ms=plain_ms,
                          library_ms=library_ms,
                          library_device_ms=library_dev,
                          bound_ms=max(t_bytes, t_ops),
                          bound_by="bytes" if t_bytes >= t_ops
                          else "operations", max_abs_err=e)
        log(f"  {name} at B={B} S={S} H={H} nh={nh} {dtype} with bias: "
            f"kernel {ms:.5f} ms events / {dev:.5f} ms device, bound "
            f"{max(t_bytes, t_ops):.5f} ms "
            f"({rows[name]['bound_by']}: {flops:.4g} flop, {nbytes} bytes), "
            f"max|err| {e:.3e} (atol {tol:g})")
        if not e <= tol:
            raise AssertionError(f"{name} kernel disagrees with its plain "
                                 f"version at the flagship shape ({dtype})")
    log(f"  dK/dV + dQ {dkv_ms + dq_ms:.5f} ms events / "
        f"{dkv_dev + dq_dev:.5f} ms device beside sdpa's whole backward "
        f"{library_ms:.5f} / {library_dev:.5f} ms "
        f"({(dkv_dev + dq_dev) / library_dev:.2f}x on the device)")
    log(f"  dbias max|err| {db_err:.3e} (atol {DBIAS_ATOL:g})")
    if not db_err <= DBIAS_ATOL:
        raise AssertionError(f"dK/dV kernel's bias gradient disagrees with "
                             f"its plain version at the flagship shape "
                             f"({dtype})")
    log(f"  plain backward (dq, dk, dv, dbias in one call) {plain_ms:.5f} "
        f"ms; sdpa backward (dq, dk, dv) {library_ms:.5f} ms events / "
        f"{library_dev:.5f} ms device ({dtype})")
    return rows


def time_forward_flagship(fa, device):
    """The forward kernel at the flagship training shape in bf16, timed
    and held against its plain version (its line in the kernels JSON
    stays at the serving shape)."""
    import torch.nn.functional as F

    B, S, H, nh = FLAGSHIP["batch_size"], FLAGSHIP["seq_len"], 768, 12
    D = H // nh
    qkv, bias = make_inputs(B, S, H, "pad_dead_row", 19, device, "bfloat16")
    bias[-1] = 0.0
    ms, dev = timed(lambda: fa.flash_attention_packed(qkv, bias, nh),
                    iters=20, device_iters=10)
    x = qkv.view(B, S, 3, nh, D)
    q, k, v = (x[:, :, j].transpose(1, 2) for j in range(3))
    lib_ms, lib_dev = timed(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=bias[:, None, None, :].to(qkv.dtype)), iters=20,
        device_iters=10)
    flops = 4.0 * B * nh * S * S * D
    out, lse = fa.flash_attention_packed(qkv, bias, nh)
    ref_out, ref_lse = fa.flash_attention_packed_reference(qkv.float(), bias,
                                                           nh)
    out_err = (out.float() - ref_out).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    rel, = packed_rel_errs(out, ref_out, nh, H)
    log(f"  forward at B={B} S={S} H={H} nh={nh} bfloat16 with bias: kernel "
        f"{ms:.5f} ms events / {dev:.5f} ms device, sdpa {lib_ms:.5f} / "
        f"{lib_dev:.5f} ms, bound "
        f"{flops / PEAK_FLOP_PER_S['bfloat16'] * 1e3:.5f} ms (operations); "
        f"out max|err| {out_err:.3e} (atol {BF16_OUT_ATOL:g}), rel "
        f"{rel:.3e} (limit {BF16_REL_LIMIT:g}), lse {lse_err:.3e} (atol "
        f"{FP32_LSE_ATOL:g})")
    if not (out_err <= BF16_OUT_ATOL and lse_err <= FP32_LSE_ATOL and
            rel <= BF16_REL_LIMIT):
        raise AssertionError("forward kernel disagrees with its plain "
                             "version at the flagship shape")


def unpacked_cases():
    """(name, B, H, Sq, Sk, D, causal, bias kind, views, dtype): the Llama
    attention shape, D 64, ragged S 100, Sq != Sk both ways, bias or not,
    views of [B, S, H, D] buffers or contiguous tensors."""
    shapes = [(1, 32, 2048, 2048, 128, True, "none", True),
              (2, 4, 128, 128, 64, True, "none", True),
              (2, 4, 128, 128, 64, False, "pad_dead_row", False),
              (2, 2, 100, 100, 128, True, "pad_dead_row", True),
              (3, 2, 100, 100, 64, False, "none", False),
              (2, 2, 128, 384, 64, True, "pad_dead_row", True),
              (2, 2, 384, 128, 128, False, "none", True),
              (2, 2, 128, 384, 128, False, "pad_dead_row", False)]
    return [(f"{dtype}_B{B}_H{H}_Sq{Sq}_Sk{Sk}_D{D}_"
             f"{'causal' if causal else 'full'}_{bias}_"
             f"{'views' if views else 'contiguous'}",
             B, H, Sq, Sk, D, causal, bias, views, dtype)
            for dtype in ("float32", "bfloat16")
            for B, H, Sq, Sk, D, causal, bias, views in shapes]


def unpacked_inputs(B, H, Sq, Sk, D, bias_kind, views, seed, device, dtype):
    """q, k, v and a cotangent dout, as [B, H, S, D] views of [B, S, H, D]
    buffers (what transpose2 and rope leave) or contiguous; a bias whose
    last batch row is all padding."""
    import torch

    rng = np.random.RandomState(seed)

    def heads(S):
        x = torch.from_numpy(rng.randn(B, S, H, D).astype("float32"))
        x = x.to(device=device, dtype=getattr(torch, dtype)).transpose(1, 2)
        return x if views else x.contiguous()

    q, k, v, dout = heads(Sq), heads(Sk), heads(Sk), heads(Sq)
    bias = None
    if bias_kind != "none":
        mask = (rng.rand(B, Sk) > 0.2).astype("float32")
        mask[:, 0] = 1.0
        mask[-1] = 0.0  # the last batch row is all padding
        bias = torch.from_numpy(mask * 1e4 - 1e4).to(device)
    return q, k, v, bias, dout


def unpacked_errors(fa, q, k, v, bias, dout, causal, out, lse, grads):
    """Max abs errors of (out, lse, dq, dk, dv, dbias) against the plain
    versions on the same (rounded) inputs in float32, over the live batch
    rows and over the all-padding row (None without a bias); in bf16 also
    the block_rel_err of (out, dq, dk, dv) over the live rows (else
    None)."""
    f = [t.float() for t in (q, k, v)]
    ref_out, ref_lse = fa.flash_attention_reference(*f, bias, causal)
    ref = fa.flash_attention_backward_reference(
        *f, bias, out.float(), lse, dout.float(), causal)
    import torch

    pairs = [(out, ref_out), (lse, ref_lse)] + list(zip(grads, ref))
    B = q.shape[0]
    live = slice(0, B - 1) if bias is not None else slice(0, B)
    errs_live, errs_dead = [], []
    for got, want in pairs:
        if got is None:
            errs_live.append(0.0)
            errs_dead.append(0.0)
            continue
        e = (got.float() - want.float()).abs()
        if not bool(torch.isfinite(got.float()).all()):
            raise AssertionError("a kernel output is not finite")
        errs_live.append(e[live].max().item())
        errs_dead.append(e[B - 1].max().item() if bias is not None else 0.0)
    rel = None
    if q.dtype == torch.bfloat16:
        rel = [block_rel_err(got[live], want[live])
               for got, want in [pairs[0]] + pairs[2:5]]
    return errs_live, (errs_dead if bias is not None else None), rel


def unpacked_limits(dtype):
    """(out, lse, dq, dk, dv, dbias) tolerances on live rows and on the
    all-padding row, as the docstring states them."""
    fp32 = dtype == "float32"
    out = FP32_OUT_ATOL if fp32 else BF16_OUT_ATOL
    grad = FP32_GRAD_ATOL if fp32 else BF16_GRAD_ATOL
    live = [out, FP32_LSE_ATOL, grad, grad, grad, DBIAS_ATOL]
    dead = [DEAD_OUT_ATOL if fp32 else BF16_OUT_ATOL, DEAD_LSE_ATOL] + [
        max(grad, DEAD_GRAD_ATOL)] * 3 + [max(DBIAS_ATOL, DEAD_GRAD_ATOL)]
    return live, dead


def check_unpacked(fa, device):
    import torch

    names = ("out", "lse", "dq", "dk", "dv", "dbias")
    for i, (name, B, H, Sq, Sk, D, causal, bias_kind, views, dtype) in \
            enumerate(unpacked_cases()):
        q, k, v, bias, dout = unpacked_inputs(B, H, Sq, Sk, D, bias_kind,
                                              views, 900 + i, device, dtype)
        out, lse = fa.flash_attention_unpacked(q, k, v, bias, causal)
        grads = fa.flash_attention_unpacked_backward(q, k, v, bias, out, lse,
                                                     dout, causal)
        torch.cuda.synchronize()
        live, dead, rel = unpacked_errors(fa, q, k, v, bias, dout, causal,
                                          out, lse, grads)
        lim_live, lim_dead = unpacked_limits(dtype)
        ok = all(e <= t for e, t in zip(live, lim_live))
        msg = "  " + name + ": " + ", ".join(
            f"{n} {e:.3e}" for n, e in zip(names, live))
        if rel is not None:
            ok = ok and max(rel) <= BF16_REL_LIMIT
            msg += "; rel " + ", ".join(
                f"{n} {e:.3e}" for n, e in zip(REL_NAMES, rel))
        if dead is not None:
            ok = ok and all(e <= t for e, t in zip(dead, lim_dead))
            msg += "; all-padding row " + ", ".join(
                f"{n} {e:.3e}" for n, e in zip(names, dead))
        log(msg)
        if not ok:
            raise AssertionError(f"unpacked kernels disagree with their "
                                 f"plain versions: {name} (limits "
                                 f"{lim_live}, all-padding row {lim_dead}, "
                                 f"bf16 rel {BF16_REL_LIMIT:g})")
        del q, k, v, dout, out, lse, grads
    torch.cuda.empty_cache()


def time_unpacked(fa, device, dtype, library_kernels=None):
    """Times of the three unpacked kernels at the Llama flagship's
    attention shape (B 1, 32 heads, S 2048, D 128, causal, views of
    [B, S, H, D] buffers as rope leaves them) in `dtype`, beside their
    plain versions and scaled_dot_product_attention(is_causal=True)
    forward and backward (torch.autograd.grad over one forward, grads of
    q, k, v): event ms of back-to-back calls and device ms.  The timed
    results are held to the phase's tolerances.  The work is what the
    causal mask leaves: S (S + 1) / 2 live (q, k) pairs.  A list given as
    `library_kernels` gets SDPA's backward kernels (device_ms's names)."""
    import torch
    import torch.nn.functional as F

    B, H, S, D = (LLAMA_FLAGSHIP["batch_size"], LLAMA["num_heads"],
                  LLAMA_FLAGSHIP["seq_len"],
                  LLAMA["hidden"] // LLAMA["num_heads"])
    q, k, v, _, dout = unpacked_inputs(B, H, S, S, D, "none", True, 17,
                                       device, dtype)
    scale = 1.0 / math.sqrt(D)
    fwd_ms, fwd_dev = timed(
        lambda: fa.flash_attention_unpacked(q, k, v, None, True), iters=10,
        device_iters=5)
    fwd_plain_ms = cuda_ms(
        lambda: fa.flash_attention_reference(q, k, v, None, True), iters=3,
        warmup=1)
    fwd_lib_ms, fwd_lib_dev = timed(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), iters=10, device_iters=5)

    out, lse = fa.flash_attention_unpacked(q, k, v, None, True)
    fa.check_unpacked_backward_inputs(q, k, v, None, out, lse, dout)
    delta = (dout.float() * out.float()).sum(-1).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dkv_ms, dkv_dev = timed(lambda: fa.flash_attention_unpacked_dkv(
        q, k, v, None, dout, lse, delta, dk, dv, None, True, scale),
        iters=10, device_iters=5)
    dq_ms, dq_dev = timed(lambda: fa.flash_attention_unpacked_dq(
        q, k, v, None, dout, lse, delta, dq, True, scale), iters=10,
        device_iters=5)
    bwd_plain_ms = cuda_ms(lambda: fa.flash_attention_backward_reference(
        q, k, v, None, out, lse, dout, True), iters=3, warmup=1)
    ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    lib_kernels = [] if library_kernels is None else library_kernels
    bwd_lib_ms, bwd_lib_dev = timed(lambda: torch.autograd.grad(
        lib_out, (ql, kl, vl), dout, retain_graph=True), iters=10,
        device_iters=5, names=lib_kernels)
    log_kernels(f"sdpa's {dtype} backward", lib_kernels)
    del lib_out, ql, kl, vl

    live, _, rel = unpacked_errors(fa, q, k, v, None, dout, True, out, lse,
                                   (dq, dk, dv, None))
    lim, _ = unpacked_limits(dtype)
    if rel is not None:
        log("  timed results: rel " + ", ".join(
            f"{n} {e:.3e}" for n, e in zip(REL_NAMES, rel)) +
            f" (limit {BF16_REL_LIMIT:g})")
    if not (all(e <= t for e, t in zip(live, lim)) and
            (rel is None or max(rel) <= BF16_REL_LIMIT)):
        raise AssertionError(f"unpacked kernels disagree with their plain "
                             f"versions in the timed calls: {live}, rel "
                             f"{rel}")
    elem = q.element_size()
    tile = B * H * S * D * elem                  # one [B, H, S, D] tensor
    rows = B * H * S * 4                         # one [B, H, S] f32 row set
    pairs = B * H * D * S * (S + 1) / 2.0        # live multiply-adds / 2
    rows_out = {}
    for name, flops, nbytes, ms, dev, plain_ms, lib_ms, lib_dev, err in (
            ("fwd", 4 * pairs, 4 * tile + rows, fwd_ms, fwd_dev, fwd_plain_ms,
             fwd_lib_ms, fwd_lib_dev, max(live[:2])),
            ("dkv", 8 * pairs, 6 * tile + 2 * rows, dkv_ms, dkv_dev,
             bwd_plain_ms, bwd_lib_ms, bwd_lib_dev, max(live[3:5])),
            ("dq", 6 * pairs, 5 * tile + 2 * rows, dq_ms, dq_dev,
             bwd_plain_ms, bwd_lib_ms, bwd_lib_dev, live[2])):
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOP_PER_S[dtype] * 1e3
        rows_out[name] = dict(
            ms=ms, device_ms=dev, plain_ms=plain_ms, library_ms=lib_ms,
            library_device_ms=lib_dev, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            max_abs_err=err)
        log(f"  {name} at B={B} H={H} S={S} D={D} causal {dtype}: kernel "
            f"{ms:.5f} ms events / {dev:.5f} ms device, plain "
            f"{plain_ms:.5f} ms, sdpa {lib_ms:.5f} / {lib_dev:.5f} ms, "
            f"bound {max(t_bytes, t_ops):.5f} ms "
            f"({rows_out[name]['bound_by']}: {flops:.4g} flop, {nbytes} "
            f"bytes), max|err| {err:.3e}")
    log("  (plain and sdpa backward times each cover dq, dk and dv in one "
        "call)")
    log(f"  dK/dV + dQ {dkv_ms + dq_ms:.5f} ms events / "
        f"{dkv_dev + dq_dev:.5f} ms device beside sdpa's whole backward "
        f"{bwd_lib_ms:.5f} / {bwd_lib_dev:.5f} ms "
        f"({(dkv_dev + dq_dev) / bwd_lib_dev:.2f}x on the device)")
    del q, k, v, dout, out, lse, delta, dq, dk, dv
    torch.cuda.empty_cache()
    return rows_out


def bert_feed(batch, seed):
    rng = np.random.RandomState(seed)
    S, V = BERT["seq_len"], BERT["vocab_size"]
    mask = np.ones((batch, S), "float32")
    for b in range(batch):
        mask[b, S - (b * 13) % 60:] = 0.0  # some padding, row 0 full
    return {
        "input_ids": rng.randint(0, V, (batch, S)).astype("int64"),
        "token_type_ids": (rng.rand(batch, S) > 0.5).astype("int64"),
        "attn_mask": mask,
        "mlm_mask": (rng.rand(batch, S) < 0.15).astype("float32"),
        "mlm_labels": rng.randint(0, V, (batch, S)).astype("int64"),
    }


def kernel_wrappers(fa):
    """The six kernels' wrappers, in the kernels line's order: packed
    forward, dK/dV, dQ; unpacked forward, dK/dV, dQ."""
    return (fa.flash_attention_packed, fa.flash_attention_packed_dkv,
            fa.flash_attention_packed_dq, fa.flash_attention_unpacked,
            fa.flash_attention_unpacked_dkv, fa.flash_attention_unpacked_dq)


def plain_versions(fa):
    return (fa.flash_attention_packed_reference,
            fa.flash_attention_packed_backward_reference,
            fa.flash_attention_reference,
            fa.flash_attention_backward_reference)


def tma_wrappers(fa):
    """The wrappers that launch a bfloat16 TMA kernel and count the
    operands they had to copy to meet its alignment (``.realigned``): all
    six."""
    return kernel_wrappers(fa)


def reset_counts(fa):
    for w in kernel_wrappers(fa):
        w.launches = 0
    for w in tma_wrappers(fa):
        w.realigned = 0
    for p in plain_versions(fa):
        p.calls = 0


def read_counts(fa):
    """(launches of the six kernels, plain-version calls, operands
    realigned for TMA): a path must leave the last two at 0."""
    return (tuple(w.launches for w in kernel_wrappers(fa)),
            sum(p.calls for p in plain_versions(fa)),
            sum(w.realigned for w in tma_wrappers(fa)))


def serve(tpt, fa, workdir):
    import torch
    from paddle_tpu_torch.models import build_bert_pretrain

    t0 = time.perf_counter()
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        feeds, outs = build_bert_pretrain(is_test=True, **BERT)
    logits = [op for op in main.global_block().ops
              if op.type == "softmax_with_cross_entropy"][0].input("Logits")[0]
    loss = outs["loss"].name
    n_attn = sum(op.type == "flash_attention_qkv"
                 for op in main.global_block().ops)
    exe = tpt.Executor()  # the card
    scope = tpt.Scope()
    with tpt.scope_guard(scope):
        exe.run(startup)
        n_params = sum(scope.find_var(n).numel()
                       for n in scope.local_var_names())
        tpt.io.save_inference_model(workdir, feeds, [logits, loss], exe,
                                    main_program=main)
    del scope
    torch.cuda.empty_cache()
    log(f"  built, initialised on {exe.device} and saved BERT-base: "
        f"{n_params} parameters, {n_attn} flash_attention_qkv ops "
        f"({time.perf_counter() - t0:.2f} s)")

    t0 = time.perf_counter()
    pred = tpt.inference.Predictor(workdir)
    torch.cuda.synchronize()
    log(f"  Predictor on {pred.device} loaded in "
        f"{time.perf_counter() - t0:.2f} s")

    requests = [(b, s) for b in (1, 4, 8) for s in range(3)]
    reset_counts(fa)
    results, lat = {}, {}
    for b, s in requests:
        before = fa.flash_attention_packed.launches
        feed = bert_feed(b, seed=10 * b + s)
        t = time.perf_counter()
        out = pred.run(feed)  # numpy fetches: ends in a device sync
        lat.setdefault(b, []).append((time.perf_counter() - t) * 1e3)
        launched = fa.flash_attention_packed.launches - before
        if launched != n_attn:
            raise AssertionError(f"batch {b}: {launched} kernel launches, "
                                 f"expected {n_attn}")
        if out[0].shape != (b, BERT["seq_len"], BERT["vocab_size"]) or \
                not (np.isfinite(out[0]).all() and np.isfinite(out[1]).all()):
            raise AssertionError(f"batch {b}: bad output {out[0].shape}")
        results[(b, s)] = out
    counts, plain_calls, realigned = read_counts(fa)
    launches = counts[0]
    if plain_calls:
        raise AssertionError(f"a plain version ran {plain_calls} times on "
                             f"the serving path")
    if realigned:
        raise AssertionError(f"{realigned} operands were realigned for TMA "
                             f"on the serving path")
    if counts != (n_attn * len(requests), 0, 0, 0, 0, 0):
        raise AssertionError(f"launches {counts} for {len(requests)} "
                             f"requests, want {n_attn * len(requests)} of "
                             f"the packed forward only")
    for b, ms in lat.items():
        log(f"  batch {b} x seq {BERT['seq_len']}: request latency on the "
            f"card {', '.join(f'{x:.3f}' for x in ms)} ms (first includes "
            f"one-time set-up)")
    log(f"  serving: {len(requests)} requests, {launches} kernel launches "
        f"({n_attn} per request), plain version called {plain_calls} times, "
        f"operands realigned {realigned}")

    t0 = time.perf_counter()
    cpu = tpt.inference.Predictor(workdir, device="cpu")
    want = cpu.run(bert_feed(4, seed=40))
    got = results[(4, 0)]
    logit_diff = float(np.abs(got[0] - want[0]).max())
    loss_rel = float(abs(got[1][0] - want[1][0]) / abs(want[1][0]))
    log(f"  card vs CPU at batch 4 ({time.perf_counter() - t0:.2f} s on the "
        f"CPU): logits max|diff| {logit_diff:.3e} (limit {LOGITS_ATOL:g}), "
        f"loss {got[1][0]:.7f} vs {want[1][0]:.7f} rel diff {loss_rel:.3e} "
        f"(limit {LOSS_RTOL:g})")
    if not (logit_diff <= LOGITS_ATOL and loss_rel <= LOSS_RTOL):
        raise AssertionError("card and CPU disagree")
    profile_request(pred, bert_feed(4, seed=41))
    return counts


def profile_request(pred, feed):
    """Where one batch-4 request's time goes: torch.profiler's device
    time by kernel against the request's wall time (after the counted
    run, so these launches are not in the main path's counts)."""
    from torch.profiler import ProfilerActivity, profile

    pred.run(feed)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        pred.run(feed)
        wall_us = (time.perf_counter() - t) * 1e6
    report_profile(prof, wall_us, "one batch-4 request")


def report_profile(prof, wall_us, what):
    """Logs device busy and idle share of `wall_us`, the top kernels and
    host ops; returns the device kernels' key_averages rows and their busy
    us (0 where the profiler saw no kernel)."""
    import torch

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us <= 0:
        log(f"  profile: {what} {wall_us:.0f} us wall; device time not "
            f"measured (the profiler saw no kernels)")
        return kernels, 0.0
    log(f"  profile of {what}: {wall_us:.0f} us wall, "
        f"{busy_us:.0f} us device busy ({len(kernels)} kernel names, "
        f"{sum(e.count for e in kernels)} launches), device idle "
        f"{100 * (1 - busy_us / wall_us):.1f}% of the wall time")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"    {e.self_device_time_total:9.1f} us "
            f"{100 * e.self_device_time_total / busy_us:5.1f}%  "
            f"x{e.count:<5d} {e.key[:90]}")
    host = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CPU]
    log(f"  host ops by self CPU time ({sum(e.count for e in host)} calls, "
        f"{sum(e.self_cpu_time_total for e in host):.0f} us):")
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:8]:
        log(f"    {e.self_cpu_time_total:9.1f} us x{e.count:<6d} "
            f"{e.key[:60]}")
    return kernels, busy_us


def build_train(tpt, cfg, lr_args, amp, dropout):
    """bench.py's training step: build_bert_pretrain, linear LR warmup,
    Adam with global-norm clip 1.0, optionally bf16 AMP with the bench's
    white list; minimize."""
    from paddle_tpu_torch import clip, optimizer
    from paddle_tpu_torch.contrib import mixed_precision
    from paddle_tpu_torch.models import build_bert_pretrain

    tpt.reset_unique_name()  # names as the JAX package gives them
    main, startup = tpt.Program(), tpt.Program()
    startup._is_startup = True
    with tpt.program_guard(main, startup), warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the flash path's dropout note
        feeds, outs = build_bert_pretrain(dropout=dropout, **cfg)
        lr = tpt.layers.linear_lr_warmup(**lr_args)
        opt = optimizer.AdamOptimizer(
            learning_rate=lr, grad_clip=clip.GradientClipByGlobalNorm(1.0))
        if amp:
            opt = mixed_precision.decorate(
                opt, dtype="bfloat16",
                amp_lists=mixed_precision.AutoMixedPrecisionLists(
                    custom_white_list=EXTRA_WHITE))
        opt.minimize(outs["loss"])
    return main, startup, outs["loss"].name


def train_batch(cfg, seed, padding):
    """A masked-gather MLM batch as bench.py makes them (sorted distinct
    positions, full weights), optionally with padding in attn_mask."""
    rng = np.random.RandomState(seed)
    B, S, V = cfg["batch_size"], cfg["seq_len"], cfg["vocab_size"]
    P = cfg["max_predictions"]
    mask = np.ones((B, S), "float32")
    if padding:
        for b in range(B):
            mask[b, S - (b * 29) % (S // 2):] = 0.0
    return {
        "input_ids": rng.randint(0, V, (B, S)).astype("int64"),
        "token_type_ids": np.zeros((B, S), "int64"),
        "attn_mask": mask,
        "mlm_positions": np.sort(np.stack(
            [rng.choice(S, P, replace=False) for _ in range(B)]),
            axis=1).astype("int64"),
        "mlm_labels": rng.randint(0, V, (B, P)).astype("int64"),
        "mlm_weights": np.ones((B, P), "float32"),
    }


def build_llama(tpt, cfg, lr, amp):
    """The Llama training step: build_llama_train, AdamW(lr,
    weight_decay=0.01) as __graft_entry__.py builds it, optionally bf16
    AMP with the default lists (mul and flash_attention in bf16);
    minimize."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.contrib import mixed_precision
    from paddle_tpu_torch.models import build_llama_train

    tpt.reset_unique_name()
    main, startup = tpt.Program(), tpt.Program()
    startup._is_startup = True
    with tpt.program_guard(main, startup):
        feeds, outs = build_llama_train(**cfg)
        opt = optimizer.AdamW(learning_rate=lr, weight_decay=0.01)
        if amp:
            opt = mixed_precision.decorate(opt, dtype="bfloat16")
        opt.minimize(outs["loss"])
    return main, startup, outs["loss"].name


def llama_batch(cfg, seed):
    """Random token ids and next-token labels from a numpy seed."""
    rng = np.random.RandomState(seed)
    B, S, V = cfg["batch_size"], cfg["seq_len"], cfg["vocab_size"]
    return {"input_ids": rng.randint(0, V, (B, S)).astype("int64"),
            "labels": rng.randint(0, V, (B, S)).astype("int64")}


def per_step_launches(main):
    """Launches of the six kernels one training step makes: each attention
    op's forward, and its recomputation inside the auto-derived grad op,
    then dK/dV and dQ once."""
    ops = main.global_block().ops
    packed = sum(op.type == "flash_attention_qkv" for op in ops)
    unpacked = sum(op.type == "flash_attention" for op in ops)
    return (2 * packed, packed, packed, 2 * unpacked, unpacked, unpacked)


def train_parity(tpt, fa, what, main, startup, loss, batches, grads, lrs):
    """Steps on the card against the port's CPU path from one startup
    scope, copied (fp32, TF32 off): the loss at every step, the step-1
    `grads`, the parameters after the last step (bounded by 2 * the sum
    of the per-step `lrs`), and each card step's kernel launches.
    Returns the card steps' launches of the six kernels."""
    import torch

    want = per_step_launches(main)
    card = tpt.Executor()
    scope = tpt.Scope()
    card.run(startup, scope=scope)
    cpu_scope = tpt.Scope()
    for n in scope.local_var_names():
        cpu_scope.set_var(n, scope.find_var(n).cpu())
    cpu = tpt.Executor(tpt.CPUPlace())
    params = [p.name for p in main.all_parameters()]
    n_params = sum(scope.find_var(n).numel() for n in params)
    log(f"  built {what} training ({len(main.global_block().ops)} ops, "
        f"{len(params)} parameters, {n_params} elements) and initialised "
        f"it on the card")
    launches = [0] * 6
    for step, feed in enumerate(batches):
        fetch = [loss] + (grads if step == 0 else [])
        reset_counts(fa)
        t = time.perf_counter()
        got = card.run(main, feed=feed, fetch_list=fetch, scope=scope)
        card_s = time.perf_counter() - t
        counts, plain, realigned = read_counts(fa)
        if (counts, plain, realigned) != (want, 0, 0):
            raise AssertionError(f"{what} parity step {step + 1}: launches "
                                 f"{counts}, {plain} plain calls and "
                                 f"{realigned} realigned operands, want "
                                 f"{want}, 0, 0")
        launches = [a + b for a, b in zip(launches, counts)]
        t = time.perf_counter()
        want_out = cpu.run(main, feed=feed, fetch_list=fetch,
                           scope=cpu_scope)
        cpu_s = time.perf_counter() - t
        # BERT's loss is [1], Llama's a 0-d mean
        lg, lw = float(np.ravel(got[0])[0]), float(np.ravel(want_out[0])[0])
        rel = abs(lg - lw) / abs(lw)
        log(f"  step {step + 1}: loss card {lg:.7f} cpu {lw:.7f} rel diff "
            f"{rel:.3e} (limit "
            f"{LOSS_RTOL:g}); card {card_s:.3f} s, cpu {cpu_s:.2f} s")
        if not (np.isfinite(got[0]).all() and rel <= LOSS_RTOL):
            raise AssertionError(f"{what} parity step {step + 1}: loss "
                                 f"disagrees")
        for name, g, w in zip(fetch[1:], got[1:], want_out[1:]):
            diff = float(np.abs(g - w).max())
            top = float(np.abs(w).max())
            log(f"    {name}: max|diff| {diff:.3e}, max|grad| {top:.3e} "
                f"(limit {PARITY_GRAD_RTOL:g} of it)")
            if not (top > 0 and diff <= PARITY_GRAD_RTOL * top):
                raise AssertionError(f"{what} parity: {name} disagrees")
    bound = 2 * sum(lrs)
    worst, close, total = 0.0, 0, 0
    for n in params:
        d = (scope.find_var(n).cpu() - cpu_scope.find_var(n)).abs()
        worst = max(worst, d.max().item())
        close += int((d <= PARITY_PARAM_ATOL).sum())
        total += d.numel()
    log(f"  parameters after step {len(batches)}: max|diff| {worst:.3e} "
        f"(limit {bound:g}), {100 * close / total:.4f}% within "
        f"{PARITY_PARAM_ATOL:g} (limit 99.9%)")
    if not (worst <= bound and close >= 0.999 * total):
        raise AssertionError(f"{what} parity: parameters disagree after "
                             f"{len(batches)} steps")
    del scope, cpu_scope
    torch.cuda.empty_cache()
    return tuple(launches)


def train_flagship(tpt, fa, what, main, startup, loss, batches, steps,
                   tokens):
    """`steps` steps on the card (cycling over `batches`): each step's
    host time, ending in the loss fetch, and tokens/s; a finite loss;
    exactly the expected kernel launches every step and no plain call;
    peak device memory; then one profiled step.  Returns the launches of
    the six kernels over the counted steps."""
    import torch

    t0 = time.perf_counter()
    want = per_step_launches(main)
    exe = tpt.Executor()
    scope = tpt.Scope()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in
                   (scope.find_var(v.name) for v in main.all_parameters()))
    log(f"  built and initialised {what} ({len(main.global_block().ops)} "
        f"ops, {n_params} parameters; {time.perf_counter() - t0:.2f} s)")
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa)
    losses, times = [], []
    for step in range(steps):
        before = read_counts(fa)
        t = time.perf_counter()
        out = exe.run(main, feed=batches[step % len(batches)],
                      fetch_list=[loss], scope=scope)
        times.append((time.perf_counter() - t) * 1e3)
        after = read_counts(fa)
        losses.append(float(np.ravel(out[0])[0]))
        got = (tuple(a - b for a, b in zip(after[0], before[0])),
               after[1] - before[1], after[2] - before[2])
        if got != (want, 0, 0):
            raise AssertionError(f"{what} step {step + 1}: (launches, plain "
                                 f"calls, realigned operands) {got}, want "
                                 f"{want}, 0, 0")
        if not np.isfinite(out[0]).all():
            raise AssertionError(f"{what} step {step + 1}: loss {out[0]}")
    counts, plain, realigned = read_counts(fa)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  {steps} steps: losses {', '.join(f'{x:.5f}' for x in losses)}")
    log(f"  step time on the card (host clock, ends in the loss fetch): "
        f"{', '.join(f'{x:.1f}' for x in times)} ms (first includes "
        f"one-time set-up); tokens/s "
        f"{', '.join(f'{tokens * 1e3 / x:.0f}' for x in times)}; peak "
        f"device memory {peak:.2f} GiB")
    log(f"  launches of the six kernels {counts} ({want} per step); plain "
        f"versions called {plain} times; operands realigned {realigned}")
    profile_step(exe, main, scope, batches[0], loss)
    del scope
    torch.cuda.empty_cache()
    return counts, losses


def bert_parity(tpt, fa):
    main, startup, loss = build_train(tpt, PARITY, PARITY_LR, amp=False,
                                      dropout=0.0)
    params = [p.name for p in main.all_parameters()]
    grads = ["fc_0.w_0@GRAD", "fc_0.tmp_1@GRAD", "layer_norm_0.w_0@GRAD",
             "embedding_0.w_0@GRAD", f"{params[-2]}@GRAD"]
    batches = [train_batch(PARITY, seed=500 + step, padding=True)
               for step in range(3)]
    return train_parity(tpt, fa, "BERT-base", main, startup, loss, batches,
                        grads, PARITY_LRS)


def bert_fp32_profile(tpt, fa):
    """One fp32 training step at bench.py's seq-512 shape (BERT-base,
    batch 8, max_predictions 77; no AMP, dropout 0, the parity phase's
    Adam, clip and warmup) under torch.profiler, after one warm step; not
    counted in any path's launches.  Logs device busy and idle share, the
    fp32 backward kernels' device time and share of the busy time, and
    holds the step to 24 / 12 / 12 launches, no plain call and no
    realigned operand."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.ops import registry

    # building a program advances the global op-seed counter, which seeds
    # the later phases' weights (phase 9's losses are held to values taken
    # on those seeds): put it back afterwards
    op_seed = registry._OP_SEED[0]
    main, startup, loss = build_train(tpt, FLAGSHIP, PARITY_LR, amp=False,
                                      dropout=0.0)
    registry.reset_op_seed(op_seed)
    want = per_step_launches(main)
    exe = tpt.Executor()
    scope = tpt.Scope()
    exe.run(startup, scope=scope)
    feed = train_batch(FLAGSHIP, seed=650, padding=True)
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)  # warm
    torch.cuda.synchronize()
    reset_counts(fa)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        wall_us = (time.perf_counter() - t) * 1e6
    got = read_counts(fa)
    if got != (want, 0, 0) or not np.isfinite(out[0]).all():
        raise AssertionError(f"fp32 seq-512 step: (launches, plain calls, "
                             f"realigned operands) {got}, want {want}, 0, "
                             f"0; loss {out[0]}")
    kernels, busy_us = report_profile(
        prof, wall_us, f"one fp32 step at seq {FLAGSHIP['seq_len']} (batch "
        f"{FLAGSHIP['batch_size']})")
    if busy_us <= 0:
        raise AssertionError("the profiler saw no device time in the fp32 "
                             "step")
    parts = []
    for name in ("fa_dkv_f32_kernel", "fa_dq_f32_kernel",
                 "fa_fwd_f32_kernel"):
        rows = [e for e in kernels if name in e.key]
        us = sum(e.self_device_time_total for e in rows)
        n = sum(e.count for e in rows)
        parts.append(us)
        log(f"  {name}: {us:.1f} us device in {n} launches "
            f"({100 * us / busy_us:.1f}% of the step's device time)")
    log(f"  fp32 backward kernels: {parts[0] + parts[1]:.1f} us, "
        f"{100 * (parts[0] + parts[1]) / busy_us:.1f}% of {busy_us:.0f} us "
        f"device busy; launches {got[0][:3]} (want {want[:3]}); loss "
        f"{float(np.ravel(out[0])[0]):.5f}")
    del scope
    torch.cuda.empty_cache()


def bert_flagship(tpt, fa):
    main, startup, loss = build_train(tpt, FLAGSHIP, FLAGSHIP_LR, amp=True,
                                      dropout=0.1)
    batches = [train_batch(FLAGSHIP, seed=600 + i, padding=False)
               for i in range(4)]
    return train_flagship(
        tpt, fa, "bench.py's seq-512 step (bf16 AMP, dropout 0.1)", main,
        startup, loss, batches, FLAGSHIP_STEPS,
        FLAGSHIP["batch_size"] * FLAGSHIP["seq_len"])


def llama_parity(tpt, fa):
    main, startup, loss = build_llama(tpt, LLAMA_PARITY, LLAMA_PARITY_LR,
                                      amp=False)
    # qkv and ln1 of the layer, the first attention's Q input (through
    # the backward kernels), the embedding (the end of the chain)
    grads = ["fc_0.w_0@GRAD", "rms_norm_0.w_0@GRAD", "rope_0.tmp_0@GRAD",
             "embedding_0.w_0@GRAD"]
    batches = [llama_batch(LLAMA_PARITY, seed=700 + step)
               for step in range(3)]
    return train_parity(tpt, fa, "Llama-2-7B-width (1 layer)", main,
                        startup, loss, batches, grads,
                        [LLAMA_PARITY_LR] * len(batches))


def llama_flagship(tpt, fa):
    main, startup, loss = build_llama(tpt, LLAMA_FLAGSHIP, LLAMA_FLAGSHIP_LR,
                                      amp=True)
    batches = [llama_batch(LLAMA_FLAGSHIP, seed=800 + i) for i in range(3)]
    return train_flagship(
        tpt, fa, "Llama-2-7B-width training (4 layers, bf16 AMP)", main,
        startup, loss, batches, FLAGSHIP_STEPS,
        LLAMA_FLAGSHIP["batch_size"] * LLAMA_FLAGSHIP["seq_len"])


def compare_losses(losses):
    """Phase 9's losses beside the CUDA-core kernels' on the same seeds:
    within LLAMA_LOSS_RTOL relative at every step."""
    want = LLAMA_LOSSES_CUDA_CORES
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, want)]
    log("  losses beside the CUDA-core kernels': " + ", ".join(
        f"{a:.5f} / {b:.5f} ({r:.2e})" for a, b, r in zip(losses, want, rel))
        + f" (limit {LLAMA_LOSS_RTOL:g} relative)")
    if len(losses) != len(want) or \
            not all(r <= LLAMA_LOSS_RTOL for r in rel):
        raise AssertionError("Llama flagship losses do not track the "
                             "CUDA-core kernels'")


def kernel_label(mangled):
    """'fa_dkv_tc_kernel<bf16, 128>' for a kernel's mangled name (the
    tensor-core kernels are bf16 only and templated on D alone),
    'fa_fwd_f32_kernel<64, 2>' for the fp32 forward (templated on D and
    its warps a block), None for anything else."""
    m = re.search(r"(fa_\w*?kernel)I(\w*?)Li(\d+)E((?:Li\d+E)*)", mangled)
    if m is None:
        return None
    name, dtype, D, more = m.groups()
    if more:
        params = [D] + re.findall(r"Li(\d+)E", more)
        return f"{name}<{', '.join(params)}>"
    return f"{name}<{'float' if dtype == 'f' else 'bf16'}, {D}>"


def sass_counts(build):
    """Per kernel function: (HGMMA, UTMALDG) instructions in its SASS, from
    the toolkit's cuobjdump beside nvcc (each function's code follows its
    'Function : <mangled name>' line)."""
    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    counts = {}
    for name in build.sources():
        sass = subprocess.run(
            [cuobjdump, "--dump-sass", build.library_path(name)],
            check=True, capture_output=True, text=True, timeout=120).stdout
        for chunk in re.split(r"Function : ", sass)[1:]:
            label = kernel_label(chunk.split(None, 1)[0])
            if label is not None:
                counts[label] = (chunk.count("HGMMA"), chunk.count("UTMALDG"))
    return counts


def ptxas_report(build):
    """Per kernel: ptxas's register and spill lines from the builds'
    -Xptxas -v output."""
    rows = {}
    for text in build.build_logs.values():
        label = None
        for line in text.splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?(\w+)", line)
            if m:
                label = kernel_label(m.group(1))
            elif label and ("registers" in line or "spill" in line):
                rows.setdefault(label, []).append(line.strip())
    return rows


def check_build(build):
    """Phase 2's checks on what nvcc made: every tensor-core kernel shows
    HGMMA (wgmma) in its own SASS at D 64 and 128; neither it nor any
    instantiation of the fp32 forward or backward (CHECKED_KERNELS)
    spills registers;
    ptxas neither ignored a setmaxnreg (warning C7508) nor serialised a
    kernel's wgmmas for want of registers (C7512)."""
    logs = "\n".join(build.build_logs.values())
    for line in logs.splitlines():
        if "warning" in line.lower() or "C75" in line:
            log(f"  ptxas: {line.strip()}")
    if "C7508" in logs or "setmaxnreg ignored" in logs:
        raise AssertionError("ptxas ignored a setmaxnreg (C7508)")
    if "C7512" in logs:
        raise AssertionError("ptxas serialised wgmmas for want of "
                             "registers (C7512)")
    report = ptxas_report(build)
    for label, lines in sorted(report.items()):
        log(f"  ptxas {label}: " + "; ".join(lines))
    counts = sass_counts(build)
    for label, (hgmma, utmaldg) in sorted(counts.items()):
        log(f"  SASS {label}: {hgmma} HGMMA, {utmaldg} UTMALDG")
    for label in TC_LABELS:
        if counts.get(label, (0, 0))[0] == 0:
            raise AssertionError(f"no wgmma (HGMMA) in {label}'s SASS: it "
                                 f"does not use the tensor cores")
    for label in CHECKED_KERNELS:
        spills = [int(x) for line in report.get(label, ())
                  for x in re.findall(r"(\d+) bytes spill", line)]
        if not spills or any(spills):
            raise AssertionError(f"{label} spills registers (or ptxas "
                                 f"printed no spill line): "
                                 f"{report.get(label)}")


def profile_step(exe, main, scope, feed, loss):
    """Where one flagship step's time goes: torch.profiler's device time
    by kernel against the step's wall time (after the counted steps)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        wall_us = (time.perf_counter() - t) * 1e6
    report_profile(prof, wall_us, "one flagship training step")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch.ops.cuda import build
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    pkg_dir = os.path.dirname(os.path.abspath(tpt.__file__))
    if pkg_dir != os.path.join(HERE, "paddle_tpu_torch"):
        raise RuntimeError(f"paddle_tpu_torch imported from {pkg_dir}, not "
                           f"from this checkout")

    t_start = time.perf_counter()
    card = card_line()
    log(f"[1/9] device: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    t0 = time.perf_counter()
    # phase 2 reads ptxas's report, which only a build prints: build anew
    for name in build.sources():
        if os.path.exists(build.library_path(name)):
            os.remove(build.library_path(name))
    built = build.build_all()
    fa._lib()
    fa._bwd_lib()
    log(f"[2/9] built {sorted(built)} in {time.perf_counter() - t0:.2f} s")
    check_build(build)

    log("[3/9] packed kernels against their plain versions")
    check_kernel(fa, device)
    check_backward(fa, device)
    fwd_f32 = time_forward_f32(fa, device)
    time_forward_flagship(fa, device)
    bwd_timing = time_backward(fa, device, "bfloat16")
    bwd_f32 = time_backward(fa, device, "float32")
    log(f"  ({time.perf_counter() - t_start:.1f} s so far)")

    # each path's launches of the six kernels, each read from 0
    by_path = {}
    log("[4/9] BERT-base serving through Predictor on the card")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        by_path["serving"] = serve(tpt, fa, workdir)
    log(f"  ({time.perf_counter() - t_start:.1f} s so far)")

    log("[5/9] BERT-base training, card against the CPU (fp32)")
    by_path["training_parity"] = bert_parity(tpt, fa)
    bert_fp32_profile(tpt, fa)
    log(f"  ({time.perf_counter() - t_start:.1f} s so far)")

    log("[6/9] bench.py's seq-512 training step on the card (bf16 AMP)")
    by_path["training_flagship"], _ = bert_flagship(tpt, fa)
    log(f"  ({time.perf_counter() - t_start:.1f} s so far)")

    log("[7/9] unpacked kernels against their plain versions")
    check_unpacked(fa, device)
    unpacked_timing = time_unpacked(fa, device, "bfloat16")
    unpacked_f32 = time_unpacked(fa, device, "float32")
    log(f"  ({time.perf_counter() - t_start:.1f} s so far)")

    log("[8/9] Llama-2-7B-width training, card against the CPU (fp32)")
    by_path["llama_parity"] = llama_parity(tpt, fa)
    log(f"  ({time.perf_counter() - t_start:.1f} s so far)")

    log("[9/9] Llama-2-7B-width training on the card (4 layers, bf16 AMP)")
    by_path["llama_flagship"], losses = llama_flagship(tpt, fa)
    compare_losses(losses)
    log(f"  ({time.perf_counter() - t_start:.1f} s in all)")

    src = "paddle_tpu_torch/csrc/"
    tpu = "paddle_tpu/ops/pallas/flash_attention.py:"
    kernels = [
        dict(name="flash_attention_packed_fwd", route="cuda",
             source=src + "flash_attention_fwd.cu", replaces=tpu + "513",
             main_path="training_flagship", **fwd_f32["serving_B4"]),
        dict(name="flash_attention_packed_dkv", route="cuda",
             source=src + "flash_attention_bwd.cu", replaces=tpu + "611",
             main_path="training_flagship", **bwd_timing["dkv"]),
        dict(name="flash_attention_packed_dq", route="cuda",
             source=src + "flash_attention_bwd.cu", replaces=tpu + "686",
             main_path="training_flagship", **bwd_timing["dq"]),
        dict(name="flash_attention_fwd", route="cuda",
             source=src + "flash_attention_fwd.cu", replaces=tpu + "120",
             main_path="llama_flagship", **unpacked_timing["fwd"]),
        dict(name="flash_attention_dkv", route="cuda",
             source=src + "flash_attention_bwd.cu", replaces=tpu + "226",
             main_path="llama_flagship", **unpacked_timing["dkv"]),
        dict(name="flash_attention_dq", route="cuda",
             source=src + "flash_attention_bwd.cu", replaces=tpu + "292",
             main_path="llama_flagship", **unpacked_timing["dq"])]
    # the fp32 kernels of the four backward entries, at the same shapes
    f32_rows = {1: bwd_f32["dkv"], 2: bwd_f32["dq"], 4: unpacked_f32["dkv"],
                5: unpacked_f32["dq"]}
    for i, row in f32_rows.items():
        kernels[i]["f32"] = {x: row[x] for x in (
            "device_ms", "ms", "bound_ms", "library_device_ms")}
    for i, k in enumerate(kernels):
        k["launches"] = by_path[k.pop("main_path")][i]
        k["launches_by_path"] = {p: n[i] for p, n in by_path.items()}
        if not all(math.isfinite(x) for x in
                   [k[x] for x in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms")]
                   + list(k.get("f32", {}).values())):
            raise AssertionError(f"non-finite measurement in {k}")
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} never launched on the path")
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
