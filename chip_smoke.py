#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 off for matmuls and cuDNN.
2. build: every CUDA source under paddle_tpu_torch/csrc/ with nvcc for
   sm_90a (one nvcc per source, started together), timed, then loaded.
3. kernels: each kernel against its plain PyTorch version on the card,
   at BERT-base's serving shape (B=4, S=128, H=768, 12 heads), at the
   flagship training shape (B=8, S=512, H=768, 12 heads: 8 kv and 8 q
   tiles), at H=256/2 heads (head_dim 128) and at a ragged S=100; with
   and without bias, causal and not, one all-padding bias row; fp32 and
   bf16 (bf16 against the fp32 plain version on the same bf16-rounded
   inputs).
   * forward: fp32 out atol 2e-5, lse atol 1e-5; bf16 out atol 2e-2.
     The all-padding row's scores sit near -1e4, where one fp32 ulp is
     2**-10, so that row is held to half an ulp (out) and one ulp (lse).
   * backward (dK/dV and dQ kernels): fp32 dqkv atol 1e-4 (sums of up to
     S=512 O(1) products in another order: ~sqrt(512) * 2**-24 relative
     on values up to ~10); bf16 dqkv atol 5e-2 (the kernels round their
     output to bf16: 2**-8 relative on values up to ~10); dbias atol
     1e-4, float32 on both sides.  In the all-padding row p = exp(s -
     lse) has s and lse near -1e4, good to ~2**-9 relative, so that row
     is held to 2**-6.
   Then times with CUDA events: the forward at BERT-base's serving shape
   (fp32) and at the flagship training shape (bf16), the backward
   kernels at the flagship shape (bf16, and fp32), each beside its plain
   version and a PyTorch yardstick: scaled_dot_product_attention
   (forward) and its backward through torch.autograd.grad (backward).
   The timed calls' results are held to the same tolerances.
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
   ops), 12 dK/dV and 12 dQ.
6. flagship training: bench.py's seq-512 leg through Executor.run:
   BERT-base, seq 512, batch 8, max_predictions 77, bf16 AMP with the
   bench's extra white list, dropout 0.1, warmup 1e-4 over 10000 steps;
   6 steps.  Each step's host time (ending in the loss fetch), a finite
   loss at every step, peak device memory, exactly 24 / 12 / 12 kernel
   launches per step and no call of a plain version; then a
   torch.profiler view of one more step (not counted).

The "launches" of each kernel in the kernels line is its count in the
run of phase 6, this slice's main path; "launches_by_path" has beside it
the count of each path, each read from 0: serving (phase 4), training
parity (phase 5, card steps) and flagship training (phase 6).  The last lines are the
card's name and power limit, one {"kernels": ...} JSON line, and
{"ok": true, "device": {...}}.
"""
import json
import math
import os
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


def time_kernel(fa, device):
    """Times at the main path's shape: BERT-base batch 4, fp32, padding
    bias, not causal."""
    import torch
    import torch.nn.functional as F

    B, S, H, nh = 4, 128, 768, 12
    D = H // nh
    qkv, bias = make_inputs(B, S, H, "pad_dead_row", 7, device, "float32")
    bias[-1] = 0.0  # the main path's shape, not its dead-row stress case
    kernel_ms = cuda_ms(lambda: fa.flash_attention_packed(qkv, bias, nh),
                        iters=200)
    plain_ms = cuda_ms(
        lambda: fa.flash_attention_packed_reference(qkv, bias, nh),
        iters=50)
    x = qkv.view(B, S, 3, nh, D)
    q, k, v = (x[:, :, j].transpose(1, 2) for j in range(3))
    mask = bias[:, None, None, :]
    library_ms = cuda_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
        iters=200)
    out, lse = fa.flash_attention_packed(qkv, bias, nh)
    ref_out, _ = fa.flash_attention_packed_reference(qkv, bias, nh)
    lib_out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    lib_err = (lib_out.transpose(1, 2).reshape(B, S, H) - ref_out).abs()
    nbytes = (qkv.numel() * qkv.element_size() + bias.numel() * 4
              + out.numel() * out.element_size() + lse.numel() * 4)
    flops = 4.0 * B * nh * S * S * D
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOP_PER_S["float32"] * 1e3
    log(f"  timed at B={B} S={S} H={H} nh={nh} fp32 with bias: kernel "
        f"{kernel_ms:.5f} ms, plain {plain_ms:.5f} ms, sdpa "
        f"{library_ms:.5f} ms (sdpa vs plain max|err| "
        f"{lib_err.max().item():.3e}); {nbytes} bytes, {flops:.0f} flop")
    err = (out - ref_out).abs().max().item()
    if not err <= FP32_OUT_ATOL:
        raise AssertionError(f"forward kernel disagrees with its plain "
                             f"version at the serving shape: {err:.3e}")
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                max_abs_err=err)


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


def time_backward(fa, device, dtype):
    """Times of the dK/dV and dQ kernels at the flagship training shape
    (B=8, S=512, 12 heads, padding bias, bias grad on, as the training
    step asks for it), the plain backward, and the backward of
    scaled_dot_product_attention (torch.autograd.grad with retain_graph
    over one forward, grads of q, k and v) as a yardstick."""
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
    dkv_ms = cuda_ms(lambda: fa.flash_attention_packed_dkv(
        qkv, bias, dout, lse, delta, dqkv, db_heads, nh, False, scale),
        iters=20, warmup=3)
    dq_ms = cuda_ms(lambda: fa.flash_attention_packed_dq(
        qkv, bias, dout, lse, delta, dqkv, nh, False, scale),
        iters=20, warmup=3)
    plain_ms = cuda_ms(lambda: fa.flash_attention_packed_backward_reference(
        qkv, bias, out, lse, dout, nh), iters=5, warmup=2)

    x = qkv.view(B, S, 3, nh, D)
    q, k, v = (x[:, :, j].transpose(1, 2).detach().requires_grad_(True)
               for j in range(3))
    lib_out = F.scaled_dot_product_attention(
        q, k, v, attn_mask=bias[:, None, None, :].to(qkv.dtype))
    g = dout.view(B, S, nh, D).transpose(1, 2)
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        lib_out, (q, k, v), g, retain_graph=True), iters=20, warmup=3)

    dqkv, dbias = fa.flash_attention_packed_backward(qkv, bias, out, lse,
                                                     dout, nh)
    ref, ref_db = fa.flash_attention_packed_backward_reference(
        qkv.float(), bias, out.float(), lse, dout.float(), nh)
    err = (dqkv.float() - ref).abs()
    db_err = (dbias - ref_db).abs().max().item()
    tol = FP32_DQKV_ATOL if dtype == "float32" else BF16_DQKV_ATOL
    elem = qkv.element_size()
    io = (qkv.numel() * elem + dout.numel() * elem + 2 * lse.numel() * 4
          + bias.numel() * 4)
    work = float(B * nh * S * S * D)
    rows = {}
    for name, flops, nbytes, ms, e in (
            ("dkv", 8 * work, io + 2 * B * S * H * elem + db_heads.numel() * 4,
             dkv_ms, max(err[..., H:].max().item(), db_err)),
            ("dq", 6 * work, io + B * S * H * elem, dq_ms,
             err[..., :H].max().item())):
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOP_PER_S[dtype] * 1e3
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=max(t_bytes, t_ops),
                          bound_by="bytes" if t_bytes >= t_ops
                          else "operations", max_abs_err=e)
        log(f"  {name} at B={B} S={S} H={H} nh={nh} {dtype} with bias: "
            f"kernel {ms:.5f} ms, bound {max(t_bytes, t_ops):.5f} ms "
            f"({rows[name]['bound_by']}: {flops:.4g} flop, {nbytes} bytes), "
            f"max|err| {e:.3e} (atol {tol:g})")
        if not e <= tol:
            raise AssertionError(f"{name} kernel disagrees with its plain "
                                 f"version at the flagship shape ({dtype})")
    log(f"  dbias max|err| {db_err:.3e} (atol {DBIAS_ATOL:g})")
    if not db_err <= DBIAS_ATOL:
        raise AssertionError(f"dK/dV kernel's bias gradient disagrees with "
                             f"its plain version at the flagship shape "
                             f"({dtype})")
    log(f"  plain backward (dq, dk, dv, dbias in one call) {plain_ms:.5f} "
        f"ms; sdpa backward (dq, dk, dv) {library_ms:.5f} ms")
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
    ms = cuda_ms(lambda: fa.flash_attention_packed(qkv, bias, nh), iters=20,
                 warmup=3)
    x = qkv.view(B, S, 3, nh, D)
    q, k, v = (x[:, :, j].transpose(1, 2) for j in range(3))
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=bias[:, None, None, :].to(qkv.dtype)), iters=20,
        warmup=3)
    flops = 4.0 * B * nh * S * S * D
    out, lse = fa.flash_attention_packed(qkv, bias, nh)
    ref_out, ref_lse = fa.flash_attention_packed_reference(qkv.float(), bias,
                                                           nh)
    out_err = (out.float() - ref_out).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    log(f"  forward at B={B} S={S} H={H} nh={nh} bfloat16 with bias: kernel "
        f"{ms:.5f} ms, sdpa {lib_ms:.5f} ms, bound "
        f"{flops / PEAK_FLOP_PER_S['bfloat16'] * 1e3:.5f} ms (operations); "
        f"out max|err| {out_err:.3e} (atol {BF16_OUT_ATOL:g}), lse "
        f"{lse_err:.3e} (atol {FP32_LSE_ATOL:g})")
    if not (out_err <= BF16_OUT_ATOL and lse_err <= FP32_LSE_ATOL):
        raise AssertionError("forward kernel disagrees with its plain "
                             "version at the flagship shape")


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


def reset_counts(fa):
    fa.flash_attention_packed.launches = 0
    fa.flash_attention_packed_dkv.launches = 0
    fa.flash_attention_packed_dq.launches = 0
    fa.flash_attention_packed_reference.calls = 0
    fa.flash_attention_packed_backward_reference.calls = 0


def read_counts(fa):
    """(forward launches, (dK/dV, dQ) launches, plain-version calls)"""
    return (fa.flash_attention_packed.launches,
            (fa.flash_attention_packed_dkv.launches,
             fa.flash_attention_packed_dq.launches),
            fa.flash_attention_packed_reference.calls
            + fa.flash_attention_packed_backward_reference.calls)


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
    launches, bwd_launches, plain_calls = read_counts(fa)
    if plain_calls:
        raise AssertionError(f"a plain version ran {plain_calls} times on "
                             f"the serving path")
    if launches != n_attn * len(requests) or any(bwd_launches):
        raise AssertionError(f"{launches} forward and {bwd_launches} "
                             f"backward launches for {len(requests)} "
                             f"requests")
    for b, ms in lat.items():
        log(f"  batch {b} x seq {BERT['seq_len']}: request latency on the "
            f"card {', '.join(f'{x:.3f}' for x in ms)} ms (first includes "
            f"one-time set-up)")
    log(f"  serving: {len(requests)} requests, {launches} kernel launches "
        f"({n_attn} per request), plain version called {plain_calls} times")

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
    return launches


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
    import torch

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us <= 0:
        log(f"  profile: {what} {wall_us:.0f} us wall; device time not "
            f"measured (the profiler saw no kernels)")
        return
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


def per_step_launches(main):
    n_attn = sum(op.type == "flash_attention_qkv"
                 for op in main.global_block().ops)
    # the forward, and its recomputation inside each auto-derived grad op
    return 2 * n_attn, (n_attn, n_attn)


def train_parity(tpt, fa):
    import torch

    t0 = time.perf_counter()
    main, startup, loss = build_train(tpt, PARITY, PARITY_LR, amp=False,
                                      dropout=0.0)
    fwd_want, bwd_want = per_step_launches(main)
    card = tpt.Executor()
    scope = tpt.Scope()
    card.run(startup, scope=scope)
    cpu_scope = tpt.Scope()
    for n in scope.local_var_names():
        cpu_scope.set_var(n, scope.find_var(n).cpu())
    cpu = tpt.Executor(tpt.CPUPlace())
    params = [p.name for p in main.all_parameters()]
    grads = ["fc_0.w_0@GRAD", "fc_0.tmp_1@GRAD", "layer_norm_0.w_0@GRAD",
             "embedding_0.w_0@GRAD", f"{params[-2]}@GRAD"]
    log(f"  built BERT-base training ({len(main.global_block().ops)} ops, "
        f"{len(params)} parameters) and initialised it on the card "
        f"({time.perf_counter() - t0:.2f} s)")
    launches = [0, 0, 0]
    for step in range(3):
        feed = train_batch(PARITY, seed=500 + step, padding=True)
        fetch = [loss] + (grads if step == 0 else [])
        reset_counts(fa)
        t = time.perf_counter()
        got = card.run(main, feed=feed, fetch_list=fetch, scope=scope)
        card_s = time.perf_counter() - t
        fwd, bwd, plain = read_counts(fa)
        if (fwd, bwd, plain) != (fwd_want, bwd_want, 0):
            raise AssertionError(f"parity step {step}: launches {fwd}, "
                                 f"{bwd} and {plain} plain calls, want "
                                 f"{fwd_want}, {bwd_want}, 0")
        launches = [launches[0] + fwd, launches[1] + bwd[0],
                    launches[2] + bwd[1]]
        t = time.perf_counter()
        want = cpu.run(main, feed=feed, fetch_list=fetch, scope=cpu_scope)
        cpu_s = time.perf_counter() - t
        rel = float(abs(got[0][0] - want[0][0]) / abs(want[0][0]))
        log(f"  step {step + 1}: loss card {got[0][0]:.7f} cpu "
            f"{want[0][0]:.7f} rel diff {rel:.3e} (limit {LOSS_RTOL:g}); "
            f"card {card_s:.3f} s, cpu {cpu_s:.2f} s")
        if not (np.isfinite(got[0]).all() and rel <= LOSS_RTOL):
            raise AssertionError(f"parity step {step}: loss disagrees")
        for name, g, w in zip(fetch[1:], got[1:], want[1:]):
            diff = float(np.abs(g - w).max())
            top = float(np.abs(w).max())
            log(f"    {name}: max|diff| {diff:.3e}, max|grad| {top:.3e} "
                f"(limit {PARITY_GRAD_RTOL:g} of it)")
            if not (top > 0 and diff <= PARITY_GRAD_RTOL * top):
                raise AssertionError(f"parity: {name} disagrees")
    bound = 2 * sum(PARITY_LRS)
    diffs = []
    for n in params:
        d = (scope.find_var(n).cpu() - cpu_scope.find_var(n)).abs()
        diffs.append(d.flatten())
    diffs = torch.cat(diffs)
    close = float((diffs <= PARITY_PARAM_ATOL).float().mean())
    log(f"  parameters after step 3: max|diff| {diffs.max().item():.3e} "
        f"(limit {bound:g}), {100 * close:.4f}% within "
        f"{PARITY_PARAM_ATOL:g} (limit 99.9%)")
    if not (diffs.max().item() <= bound and close >= 0.999):
        raise AssertionError("parity: parameters disagree after 3 steps")
    del scope, cpu_scope
    torch.cuda.empty_cache()
    return launches[0], (launches[1], launches[2])


def train_flagship(tpt, fa):
    import torch

    t0 = time.perf_counter()
    main, startup, loss = build_train(tpt, FLAGSHIP, FLAGSHIP_LR, amp=True,
                                      dropout=0.1)
    fwd_want, bwd_want = per_step_launches(main)
    exe = tpt.Executor()
    scope = tpt.Scope()
    exe.run(startup, scope=scope)
    batches = [train_batch(FLAGSHIP, seed=600 + i, padding=False)
               for i in range(4)]
    torch.cuda.synchronize()
    log(f"  built and initialised bench.py's seq-512 step "
        f"({len(main.global_block().ops)} ops; "
        f"{time.perf_counter() - t0:.2f} s)")
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa)
    losses, times = [], []
    for step in range(FLAGSHIP_STEPS):
        before = read_counts(fa)
        t = time.perf_counter()
        out = exe.run(main, feed=batches[step % 4], fetch_list=[loss],
                      scope=scope)
        times.append((time.perf_counter() - t) * 1e3)
        after = read_counts(fa)
        losses.append(float(out[0][0]))
        got = (after[0] - before[0],
               tuple(a - b for a, b in zip(after[1], before[1])),
               after[2] - before[2])
        if got != (fwd_want, bwd_want, 0):
            raise AssertionError(f"flagship step {step + 1}: launches "
                                 f"{got}, want {fwd_want}, {bwd_want}, 0")
        if not np.isfinite(out[0]).all():
            raise AssertionError(f"flagship step {step + 1}: loss {out[0]}")
    fwd, bwd, plain = read_counts(fa)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  {FLAGSHIP_STEPS} steps at batch {FLAGSHIP['batch_size']} x seq "
        f"{FLAGSHIP['seq_len']}, bf16 AMP, dropout 0.1: losses "
        f"{', '.join(f'{x:.5f}' for x in losses)}")
    log(f"  step time on the card (host clock, ends in the loss fetch): "
        f"{', '.join(f'{x:.1f}' for x in times)} ms (first includes "
        f"one-time set-up); peak device memory {peak:.2f} GiB")
    log(f"  launches: {fwd} forward, {bwd[0]} dK/dV, {bwd[1]} dQ "
        f"({fwd_want} / {bwd_want[0]} / {bwd_want[1]} per step); plain "
        f"versions called {plain} times")
    profile_step(exe, main, scope, batches[0], loss)
    return fwd, bwd


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
    log(f"[1/6] device: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    t0 = time.perf_counter()
    built = build.build_all()
    fa._lib()
    fa._bwd_lib()
    log(f"[2/6] built {sorted(built)} in {time.perf_counter() - t0:.2f} s")
    for name, text in build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    log("[3/6] kernels against their plain versions")
    check_kernel(fa, device)
    check_backward(fa, device)
    timing = time_kernel(fa, device)
    time_forward_flagship(fa, device)
    bwd_timing = time_backward(fa, device, "bfloat16")
    time_backward(fa, device, "float32")
    log(f"  ({time.perf_counter() - t_start:.1f} s so far)")

    # each path's launches of (forward, dK/dV, dQ), each read from 0
    by_path = {}
    log("[4/6] BERT-base serving through Predictor on the card")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        by_path["serving"] = (serve(tpt, fa, workdir), 0, 0)
    log(f"  ({time.perf_counter() - t_start:.1f} s so far)")

    log("[5/6] BERT-base training, card against the CPU (fp32)")
    fwd, (dkv, dq) = train_parity(tpt, fa)
    by_path["training_parity"] = (fwd, dkv, dq)
    log(f"  ({time.perf_counter() - t_start:.1f} s so far)")

    log("[6/6] bench.py's seq-512 training step on the card (bf16 AMP)")
    fwd, (dkv, dq) = train_flagship(tpt, fa)
    by_path["training_flagship"] = (fwd, dkv, dq)
    log(f"  ({time.perf_counter() - t_start:.1f} s in all)")

    src = "paddle_tpu_torch/csrc/"
    tpu = "paddle_tpu/ops/pallas/flash_attention.py:"
    kernels = [
        dict(name="flash_attention_packed_fwd", route="cuda",
             source=src + "flash_attention_packed_fwd.cu",
             replaces=tpu + "513", **timing),
        dict(name="flash_attention_packed_dkv", route="cuda",
             source=src + "flash_attention_packed_bwd.cu",
             replaces=tpu + "611", **bwd_timing["dkv"]),
        dict(name="flash_attention_packed_dq", route="cuda",
             source=src + "flash_attention_packed_bwd.cu",
             replaces=tpu + "686", **bwd_timing["dq"])]
    for i, k in enumerate(kernels):
        k["launches"] = by_path["training_flagship"][i]
        k["launches_by_path"] = {p: n[i] for p, n in by_path.items()}
        if not all(math.isfinite(k[x]) for x in
                   ("max_abs_err", "ms", "plain_ms", "bound_ms")):
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
