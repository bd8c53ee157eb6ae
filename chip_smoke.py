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
   cuobjdump's SASS.  Each tensor-core kernel (fa_fwd_tc_kernel,
   fa_dq_tc_kernel, fa_dkv_tc_kernel; bfloat16 and float16, at D 32, 64
   and 128) must show HGMMA and UTMALDG in its own code, the proof that
   the tensor cores run on TMA-loaded tiles, and spill nothing;
   nor may the fp32 forward (fa_fwd_f32_kernel at D 32 with 64-row q
   tiles, at D 64 and 128 with 16- and
   64-row q tiles) or the fp32 backward (fa_dkv_f32_kernel and
   fa_dq_f32_kernel, 8-warp blocks of 128 rows at D 32 and 64 and of 64
   at D 128);
   a ptxas warning
   C7508 (setmaxnreg ignored) or C7512 (wgmmas serialised for want of
   registers) fails the phase.
   Then the fp32 product kernel whose rows do not depend on M
   (csrc/gemm_f32.cu, ops/cuda/gemm.py; every forward-only fp32 product
   on the card): no function of it or of the RMSNorm source spills; at
   Llama-2-7B's decode and
   prefill shapes (K x N = 4096 x 12288, 4096 x 4096, 4096 x 22016, 11008
   x 4096, 4096 x 32000) and BERT's 768 x 2304, every row of an M-row
   product (M 1, 2, 3, 4, 7, 16, 17, 64, 128, 500, 1024) bit-equal to the
   same row of the 1024-row product and of a row-permuted one, and the
   same for decode attention's batched Q K^T (K^T read from the cache,
   and from a copy of it one float off 16-byte alignment) and P V; each
   within gemm.tolerance of its plain version (|d| <= 8
   sqrt(K) 2**-24 sqrt((x x) @ (w w)): eight spreads of a K-term fp32
   sum's rounding error), which two controls must fail at every shape:
   torch.matmul with TF32 allowed, and the exact product of operands
   rounded to bf16; then its event and device time beside torch.matmul's
   and its bound at M 4 (decode) and 512 (prefill) and at decode
   attention's two products (M 1, 128 slot-heads), with the sha256 of
   each output on inputs from fixed seeds (time_fp32.py --what gemm
   prints the same rows for another checkout: equal hashes, equal bits).
   Then
   the fp32 RMSNorm kernel whose rows do not depend on the row count
   (csrc/rms_norm_f32.cu, ops/cuda/rms_norm.py: every forward-only fp32
   rms_norm on the card): at width 4096, every row of an M-row norm (M 1
   to 1024) bit-equal to the same row of the 1024-row one and of a
   row-permuted one, within 2e-6 (relative to the largest output) of
   the op's PyTorch formulation, and its times and output hashes at 4
   and 512 rows.  Then the SelectedRows merge kernel
   (csrc/selected_rows.cu, ops/cuda/selected_rows.py: every merge of a
   sparse gradient on the card) builds with no spill and, at Wide&Deep's
   K (4096 x 26 Zipf(1.1) ids over 1,000,001 rows) for 10 columns and 1,
   gives the bits of its plain version run on the CPU on the same inputs
   and the same bits on a second launch; its wrapper's and kernel's
   times beside the plain version's, torch's index_add_ of the same sums
   and the bound.
   Each source picks its kernel by dtype: bfloat16 and float16 run the
   tensor-core kernels (one template on the 16-bit type), float32 the
   CUDA-core ones (fa_fwd_f32_kernel, fa_dkv_f32_kernel,
   fa_dq_f32_kernel: exact fp32 FMAs, no TF32).  So the bf16 and fp16
   cases of phases 3 and 7, the bf16 training phases 6 and 9 and the fp16
   training phase 16 run the tensor-core kernels, while the fp32 gates
   (phases 4, 5, 8) run the CUDA-core ones.
3. packed kernels: each against its plain PyTorch version on the card,
   at BERT-base's serving shape (B=4, S=128, H=768, 12 heads), at the
   flagship training shape (B=8, S=512, H=768, 12 heads: 8 kv and 8 q
   tiles), at H=256/2 heads (head_dim 128) and at a ragged S=100; with
   and without bias, causal and not, one all-padding bias row; fp32, bf16
   and fp16 (bf16 and fp16 against the fp32 plain version on the same
   rounded inputs).
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
   * fp16: the same values rounded to 2**-11 instead of 2**-8, eight
     times finer; the absolute limits are a quarter of bf16's, a factor
     2 of room over that ratio: out 5e-3, grads 1.25e-2; per 128-row
     block 1e-3, between fp16's largest reading (3.4e-4; bf16's ~4e-3
     scales to ~5e-4) and bf16's smallest (1.8e-3).  lse keeps its fp32
     limit; the all-padding row's out is held to the dtype's out limit,
     as bf16's is (the kernels round its P and output as a live row's;
     fp16 readings up to 9.9e-4), its grads to the larger of the dtype's
     and 2**-6.  The fp16 dQ and dK/dV kernels round dS * scale (the
     softmax scale folded in before the rounding), so a dS of a large
     loss scale passes 65504 only where dq and dk would.
   * fp16 overflow (check_fp16_overflow): an inf planted in v reaches
     out, an inf planted in dO reaches dq, dk and dv, wherever the plain
     version has inf or NaN the kernel has too; dO at 60000 on one head
     gives dv past 65504, inf exactly where the plain version's float32
     dv is past 65520 (1e-3 relative either side excused), the other
     batch row finite.
   Then times: the fp32 forward at BERT-base serving's batch 1, 4 and 8,
   at the flagship training shape, at the Llama shape (causal) and at
   generation's largest prefill bucket ([1, 32, 512, 128] causal), the
   bf16 and fp16 forward at the flagship training shape, the backward
   kernels at the flagship shape (bf16, fp32 and fp16), each beside its
   plain version and
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
   card, warmed (each signature built and captured as a CUDA graph),
   answering batch 1, 4 and 8 at seq 128 with padding in attn_mask, each
   request a replay.  Every kernel count is set to 0 just before and
   read just after (replay-aware counters): each request must launch the
   forward kernel exactly 12 times and the product kernel once a mul op,
   no backward kernel, and never call a plain version.  Then 40 batch-4
   requests whose caller keeps every response against 40 that drop it,
   in turns: the median ms of each and of each turn (printed), no pinned
   host memory allocated while keeping them (where PyTorch reports it),
   every kept response unchanged.  The batch-4 request runs again
   through Predictor(dir, device="cpu"): logits max abs diff <= 1e-3 and
   loss rel diff <= 1e-4 (fp32, TF32 off).
5. training parity at full width: BERT-base (seq 128, batch 2,
   max_predictions 19), fp32 with TF32 off, dropout 0, bench.py's Adam
   and global-norm clip with a short warmup (lr 0, 5e-4, 1e-3) so the
   weights move; 3 Executor.run steps on the card and 3 on the port's
   CPU path from one startup scope, copied.  Loss rel diff <= 1e-4 at
   every step; step-1 gradients max abs diff <= 1e-3 of their largest
   value; parameters after step 3 within 2 * (sum of the LRs) everywhere
   (Adam moves an element with a near-zero gradient by ~lr whatever its
   sign) and within 1e-5 on 99.9% of all elements.  Each card step
   launches 12 forward kernels (once per attention op: the grad ops
   differentiate the graph the forward kept), 12 dK/dV and 12 dQ, read
   through the replay-aware counters.  Then, on the same program:
   captured = eager, 3 steps through the compiled step (eager, capture +
   replay, replay) against 3 through FLAGS_check_nan_inf's eager debug
   run from one startup scope copied, losses and every parameter
   expected bit-equal and held to the parity limits; the guard, a
   replayed guarded step on a NaN feed leaves every persistable
   bit-unchanged and fires its callback with that step's id; dropout
   0.5 on [1024, 1024] under replay, each run at its keep rate within 5
   sigma with its grad on its own mask, no two consecutive masks equal.
   Then one fp32 step at bench.py's seq-512 shape (BERT-base, batch 8,
   max_predictions 77, no AMP, dropout 0, the phase's optimizer), after
   two warm steps (eager, capture), replayed under torch.profiler and not
   counted in the path's launches: wall, device busy and idle share, host
   launches, the fp32 backward kernels' device time and share of the
   step, and exactly 12 / 12 / 12 launches.
6. flagship training: bench.py's seq-512 leg through Executor.run:
   BERT-base, seq 512, batch 8, max_predictions 77, bf16 AMP with the
   bench's extra white list, dropout 0.1, warmup 1e-4 over 10000 steps;
   6 steps (step 1 eager, step 2 captures the CUDA graph and replays
   it, the rest replay).  Each step's host time (ending in the loss
   fetch), a finite loss at every step, peak device memory, exactly 12 /
   12 / 12 kernel launches per step and no call of a plain version; then
   a window of 20 steps through run_async fenced once at its end (no
   host sync inside it): ms/step and tokens/s; then a torch.profiler view
   of one more step (not counted): wall, device busy, idle share and
   host launches (cudaLaunchKernel, cudaGraphLaunch).
7. unpacked kernels (the flash_attention op's forward, dK/dV and dQ),
   each against its plain version on the card: at Llama-2-7B's attention
   shape (B 1, 32 heads, S 2048, D 128, causal), at D 64, a ragged S 100,
   Sq != Sk both ways (128 / 384), with and without a bias holding one
   all-padding row, on contiguous tensors and on the [B, H, S, D] views of
   [B, S, H, D] buffers that transpose2 and rope leave; fp32, bf16 and
   fp16.  Tolerances as in phase 3 and for the same reasons: fp32 out
   2e-5, lse 1e-5, grads 1e-4; bf16 out 2e-2, grads 5e-2 (output
   rounding) and 1e-2 relative per 128-row block; fp16 a quarter of
   bf16's; dbias 1e-4; the all-padding row half / one fp32 ulp at 1e4
   (out / lse; a 16-bit out its dtype's limit) and 2**-6 (grads).  Then the fp16 overflow checks on
   [2, 4, 128, 128] views, and times (events and device, as in phase 3)
   at the Llama shape (causal), in bf16, fp32 and fp16: the three
   kernels, their plain versions, and
   scaled_dot_product_attention(is_causal=True) forward and its backward
   through torch.autograd.grad as the yardstick; the timed results are
   held to the same tolerances.  Then the same in bf16 at phase 15b's
   attention shape, [1, 32, 4096, 128] causal (here, not in phase 15:
   late in the run, after phase 14, torch.profiler sessions of eager
   kernel calls have seen no device time on one H100).
8. Llama training parity at full width: Llama-2-7B's widths (vocab 32000,
   hidden 4096, 32 heads, intermediate 11008) at 1 layer, seq 128, batch
   2, fp32 with TF32 off, AdamW(1e-3, weight_decay 0.01); 3 Executor.run
   steps on the card and 3 on the port's CPU path from one startup scope,
   copied.  Loss rel diff <= 1e-4 at every step, step-1 gradients within
   1e-3 of their largest value, parameters after step 3 within 2 * (sum
   of the LRs) everywhere and 1e-5 on 99.9% of all elements (as phase
   5).  Each card step launches the unpacked forward kernel, dK/dV and dQ
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
   exactly 4 / 4 / 4 launches of the unpacked kernels per step, none of the
   packed ones, no call of a plain version; the run_async window and the
   profiled step as in phase 6.  Then a second captured entry of the same
   step (one more one-element fetch makes a second key): the device
   memory reserved with one captured entry and with two, each graph
   pool and the peak allocated.
10. generation serving (serving.GenerationEngine, dense KV cache, greedy):
   a. parity at 2 layers of Llama-2-7B's widths (2 slots, 128 positions,
      buckets 32 / 64, two concurrent requests of 20 and 50 prompt
      tokens, 24 new tokens each, keep_logits), no warmup, so prefill
      runs eagerly and decode is captured at its second step:
      (a) attn_impl "auto" (prefill on the fp32 forward kernel, num_layers
      launches a prefill, decode through cached_attention) against the
      port's uncached forward on the CPU over the card's own tokens
      (teacher-forced, attn_impl "xla"): every step's logits within 1e-3
      (fp32, TF32 off, as phase 4), every greedy token equal; (b) the same
      requests with attn_impl "xla" against the card's own uncached "xla"
      forward at max_seq_len: max |d| exactly 0 (every product on the
      product kernel), printed beside cuBLAS's row consistency (x[:2] @ W
      against the first rows of x[:128] @ W at the block's and the head's
      shapes); (c) a paged engine (page 16, prefix reuse and chunking
      off) on the same weights: tokens and every step's logits bit-equal
      to (a)'s; (d) a shared-prefix batch (a donor, then two borrowers
      of its 32-token header) and (e) a chunked batch (chunk 16), each
      against the card's uncached forward within 1e-3 with greedy tokens
      equal, (d) with prefix hits and the shared pages' bytes unchanged.
      Each engine: kernel #4 num_layers times a whole-prompt prefill, the
      product kernel once a product of its programs (6 L + 1 a decode
      step or chunk, 4 L + 1 a prefill on kernel #4) and the RMSNorm
      kernel 2 L + 1 times a program's run, read through the
      replay-aware counters.
   b. the flagship: Llama-2-7B's widths at 8 of its 32 layers (GEN: the
      depth cut of phases 10b-d, 11b, 12b and 13; fp32 weights from the
      startup program, 1.88 B parameters), 4 slots x 1024 positions (1 GiB of
      caches), buckets 64 / 128 / 256 / 512, attn_impl "auto"; warmup
      runs each program twice (eager, then captured) and each must be
      captured exactly once; then 8 requests of 20-500 prompt tokens
      (every bucket), 64 new tokens each, queued before the scheduler
      starts (continuous batching).  Gates: kernel #4 launched num_layers
      times a prefill (the replay-aware counts), no other kernel, no
      plain call, nothing realigned; every request ends 'length' with
      its 64 tokens; the caches keep their data_ptr and every program
      its one capture; one profiled decode replay and one prefill replay
      each show 0 cudaLaunchKernel and 1 cudaGraphLaunch and no
      device-to-device copy of a cache's size (the trace's memcpy
      bytes).  Printed: tokens/s, TTFT, inter-token and decode-step
      times, the decode step's bound (weights and caches read once at
      the card's HBM rate), each profiled replay's busy / idle, peak and
      reserved memory, the captures per program ("generation:" JSON
      line).  Then the dense engine closes and its caches go, and two
      paged engines share its weights (page 16, pools auto-sized to 257
      pages): (i) the same 8 requests with prefix reuse on (the prompts
      distinct) and chunking off: the dense run's tokens, the launches
      as above, each program captured once, the pools keep their
      data_ptr, one profiled paged decode replay with 0 cudaLaunchKernel,
      1 cudaGraphLaunch and no copy of a pool's size; (ii) 8 requests
      sharing a 256-token header (16 pages), tails of 20-200 tokens, 64
      new tokens each, prefill_chunk 128: every request 'length', at
      least one prefix hit; printed: hits, TTFT p50 and inter-token p99
      against the dense run's.
   c. speculative decoding at full width, on the same weights: a plain
      paged engine, then a speculating one (spec_tokens 4, spec_ngram 3),
      one after the other, each page 16, 257 pages, 4 slots x 1024,
      buckets 8 / 64 / 128 / 256 / 512 (bucket 8 so that a verify of at
      most 5 rows runs 8 rows, not 64), prefix reuse and chunking off,
      keep_logits; 8 requests of 64 new tokens: four prompts repeating
      one 8-token pattern (64, 100, 200, 300 tokens) and the first four
      of 10b's, one of each kind submitted with speculate=False.  Gates:
      every token and every step's logits bit-equal (torch.equal on the
      stacked logits; a verify row is the decode step's forward, every
      product and norm on the kernels whose rows do not depend on M);
      drafts > 0 and accepted <= proposed; the pool back to 0 live
      pages; each program (verify8 among them) captured once; the pools
      keep their data_ptr; the launches as in (b), a verify counted as a
      chunk (6 L + 1 products, 2 L + 1 norms).  Printed: tokens/s of
      both, acceptance, verify ms p50 / p99 beside the decode step's
      p50, one profiled verify replay (busy, idle, 1 cudaGraphLaunch, 0
      cudaLaunchKernel), the ms of a verify run at bucket 8 and at 64,
      and the first repetitive request alone in the grid (one slot live),
      plain against speculating.  No speed gate: the reference verifies
      one slot a replay, so at 4 slots speculation may well be slower.
   d. the prefill / decode roles at full width: a colocated paged engine
      (page 16, buckets 64-512, prefix reuse and chunking off,
      keep_logits) runs 10b's 8 requests; then a DisaggPair of a
      prefill-role and a decode-role engine, each over a child scope of
      the weights' scope (its own pools of 257 pages, one copy of the
      7.01 GiB of weights), runs them through HostBytesTransport (each
      segment through host memory: 16 MiB a page, a 500-token prompt's
      512 MiB) and then through DeviceTransport (a copy on the card).
      Gates: tokens and every step's logits bit-equal to the colocated
      run's, through each transport; 8 segments exported and 8 adopted
      a run; both pools back to 0 live pages and keeping their data_ptr
      (the adopt scatter is index_copy_ into the pool); each program
      captured once; the launches summed over both engines; a segment
      whose fingerprint is changed refused with SegmentMismatch.
      Printed: handoff ms p50 / p99 (and the send alone) and adopt ms by
      transport, segment bytes, tokens/s, TTFT p50 (submit to the first
      token, which the decode engine replays at adoption) beside the
      colocated run's.
11. the serving stack (the phase's seconds and the run's are printed):
   a. BERT-base at its published widths (seq 128, fp32), saved with
      row-shaped fetches (models.build_bert_serving: the last encoder
      layer's output and the MLM head's argmax), served by ServingEngine
      (max batch 8, buckets 1 / 2 / 4 / 8, max delay 5 ms; warmup
      captures every bucket on every worker): 64 requests of 1-3 rows from
      a seed, 16 client threads in a closed loop, at 1 and at 2 workers.
      Gates (tolerance 0): every answer equals the same rows run alone
      through Predictor.run; kernel #1 12 times and the product kernel
      once a mul a dispatched batch, no plain call, nothing realigned;
      serve_batch:fail's batch bisected with every rider bit-equal; under
      the poison sentinel only the poisoned request fails and its
      batchmates are bit-equal; a full queue sheds queue_full; a swap to
      a second seed's weights (an in-memory dict) answers as a fresh
      Predictor on them, with no capture and every data_ptr kept, and
      the revert brings the first answers back.  Printed: requests/s and
      rows/s at 1 and 2 workers, latency p50 / p99, batch fill, bucket
      hit rate, the device idle share of one profiled window, swap_ms.
   b. a ServingServer on 127.0.0.1 over a's engine with a paged,
      speculating Llama-2-7B engine attached (GEN's 8 layers, fp32, 4 slots x
      1024, phase 10's weights).  Gates (tolerance 0): /predict at batch
      1 equals the in-process answer; /healthz, /statusz (cost manifests,
      the H100's peaks), /tracez and /metrics (Prometheus text lines)
      answer; /generate for the 8 GEN_PROMPTS, plain and streamed, gives
      phase 10b's tokens, and a repetitive prompt with "speculate": true
      (drafts fire) gives the engine's plain stream for it;
      /adopt of a prefill-role server's segments gives them too; the
      launches of check_engine_counts over both engines; /swap "target":
      "generate" to a second set of weights (a checkpoint written to
      disk, 7.01 GiB, kept for phase 12b): every live weight then
      equals the second set, and
      a prompt's stream equals a fresh engine's over the swapped storage
      and differs from the first weights'; the revert, the streams after
      it bit-equal, no weight moved, nothing recaptured; a drifted /swap
      gets 409;
      close(drain=True) answers every queued request and leaves no
      worker or scheduler thread.  Printed: TTFT and inter-token p50 /
      p99 as the client reads the stream beside the server's, the
      /adopt handoff, the generation swap_ms.  The "serving:" JSON line
      holds a's and b's numbers.
12. the fleet (python -m paddle_tpu_torch.serving.replica processes on
   the card under serving.FleetSupervisor, behind serving.Router and
   RouterServer on 127.0.0.1; the phase's seconds and the run's are
   printed).  First phases 10 and 11 are released in this process (the
   weights' scope, the engines, their graphs and pools; the memory still
   reserved is printed).
   a. 11a's saved BERT-base (and its second seed's weights, saved beside
      it) served by two replicas (--workers 1 --max-batch 8
      --max-delay-ms 5): 11a's 64 requests through the router's
      /predict, 16 closed-loop clients, three rounds.  Gates (tolerance
      0): every answer equals Predictor.run of its rows alone; every
      replica's /statusz names the card; a /profilez trace of a replica
      during traffic holds the fp32 forward's (kernel #1) and the product
      kernel's device records and no other attention or product kernel's,
      and every graph replay in it but the last holds one batch's: 12
      of kernel #1, 48 products at least (FLEET_DISPATCH); SIGKILL
      of a replica mid-traffic: respawned at the same URL, ejected and
      recovered by the router, attributed signal:SIGKILL, no request
      failed except by shedding, every answer bit-equal; a rolling
      restart under traffic: every exit code 0, every successor ready,
      no non-shed failure; a hot swap to the second weights: converged,
      every replica on the new weights_version, the answers (routed and
      each replica's) equal a fresh Predictor on them; every replica
      exits 0 at close.  Printed: requests/s and rows/s beside 11a's 2
      in-process workers, client and replica latency p50 / p99 and the
      router hop between them, the mean reply's MiB and its parse ms;
      16 requests one at a time, straight to a replica and through the
      router: the replica's own ms, what the reply adds (its JSON and
      the socket) and what the router adds; spawn-to-ready, respawn,
      rolling-restart
      and hot-swap seconds, the longest /healthz gap while replicas start
      and during the swap.
   b. Llama-2-7B's widths (GEN's 8 layers, MHA, fp32, 4 slots x 1024, 257 pages of 16,
      phase 10's buckets, random weights from the replica's --seed): a
      one-replica fleet in role "both" answers the 8 GEN_PROMPTS through
      the router's /generate, 64 new tokens each (the colocated
      reference); FleetSupervisor.hot_swap(target="generate") swaps it
      to 11b's second weights, /healthz polled every 100 ms meanwhile
      (swapped in place: no restart fallback, no liveness kill, the
      generation weights_version 2; the first prompt's 16 tokens through
      the router equal 11b's fresh engine's on those weights, tolerance
      0); it closes.  Then a prefill-role and a decode-role
      replica: the same prompts, plain then streamed, through the
      router's prefill -> /adopt -> decode pipeline.  Gates (tolerance
      0): every token equals the colocated run's; disagg_generations 16,
      affinity_lost 0; a /profilez trace of the prefill replica during
      prefills holds the fp32 forward's (kernel #4), the product and
      RMSNorm kernels' records and no other attention or product
      kernel's, every graph replay in it but the last one prefill's: 32
      of kernel #4, 128 products at least, 65 RMSNorms; every replica
      exits 0 at close.  Printed: tokens/s, client TTFT and inter-token
      p50 / p99 beside the decode replica's own, the export and adopt
      ms, spawn-to-ready seconds of the both / prefill / decode
      replicas, the swap's seconds and its longest /healthz gap.  The
      "fleet:" JSON line holds a's and b's numbers.
13. the port's load generator and chaos harness
   (paddle_tpu_torch/tools/serving_loadgen.py and chaos.py; the phase's
   seconds and the run's are printed).
   a. serving_loadgen.main in this process on 11a's saved BERT-base
      (--model-dir, --device cuda, 11a's engine: 1 worker, max batch 8,
      5 ms): a closed loop of 64 one-row requests at 16 clients, then an
      open loop at half 11a's 1-worker requests/s for 5 s.  Gates: no
      failure, 64 closed answers, the report's engine.batch_fill_pct;
      the counts read from 0 around the two loops: kernel #1 12 times and
      the product kernel once a mul a dispatched batch, no plain call,
      nothing realigned.  During phase 12a, through its router at half
      12a's requests/s: a burst-shaped open loop (--traffic burst
      --traffic-amplitude 1.0, 10 s) under generous budgets (rc 0, per-
      phase reports, no failure); --slo-p99-ms 0.001 (rc 1, violations
      labelled by phase, the router's /debugz bundle saved); --tenants 4
      with --slo-tenant-p99-ms through the router (its /fleetz tenant
      families; a router has no /usagez, so the bound is unmeasured and
      violates: rc 1) and straight to a replica (its /usagez, every
      tenant's p99 measured: rc 0).  During phase 12b, --generate --url
      --gen-stream at the colocated replica: 8 requests at 4 clients,
      prompts of 20-500 tokens, 64 new tokens each; gates: every request
      answered with 64 tokens, client TTFT and inter-token measured
      (printed beside the replica's own).
   b. chaos.run_chaos with every port scenario (baseline, crash, hang,
      slow, poison, poison_paged, spec_storm, disagg_crash, hot_swap,
      noisy_neighbor).  Its /predict fleets: three replicas of BERT-base
      (seq 128, fp32, 1 worker, max batch 8) serving the encoder output's
      first position [B, 768] (built with the slice op), 1-row requests,
      the poison sentinel 1e30 in attn_mask through --poison-value.  A
      probe first: such a fleet behind the router, a closed loop of 256
      requests at 32 clients (the rate it sustains and its p99), a
      /profilez trace of one replica under traffic held as 12a's
      (dispatch_gate; no library product or attention kernel); the
      harness then runs at half the probe's rate, a forward timeout of 4x
      its p99 (at least 1 s), the 5 s liveness default and scenarios of
      1.6x 12a's SIGKILL respawn.  poison_paged and spec_storm run in
      this process on GEN (8 layers; paged, pages of 16, 10c's
      buckets; spec_storm speculating); disagg_crash on four replicas of
      Llama-2-7B's widths at 4 layers (four 25.10 GiB
      replicas do not fit in 80 GB); hot_swap and noisy_neighbor spawn
      their own BERT-base fleets (hot_swap writes two more weight sets
      and swaps to them; a quarter of its reference storm is /generate,
      which a /predict-only fleet does not serve).  Gates: no scenario
      error, no collateral failure, no poison leak, no leaked page, no
      torn version, availability >= 99%, the report's ok; a respawn
      after crash (attributed SIGKILL), a liveness kill after hang, a
      bisection in a replica after poison, drafts verified and slots
      failed by the fault in spec_storm (its rejected-draft rollbacks
      are printed: the seed-0 7B accepts every draft of its periodic
      prompts); in this process (the 7B engines, hot_swap's fresh
      predictor) the prefill, product and RMSNorm kernels launched, no
      plain call, nothing realigned.  The "loadgen:" and "chaos:" JSON
      lines hold a's and b's numbers.
14. training under TrainGuard (train_guard.py, checkpoint.py, the
   executor's spans; the phase's seconds and the run's are printed):
   phase 6's step (BERT-base, seq 512, batch 8, 77 predictions, bf16
   AMP with the bench's white list, dropout 0.1, Adam with global-norm
   clip and linear warmup) in three lives, each a fresh Executor and a
   copy of one startup scope, telemetry on into a temporary
   FLAGS_metrics_dir.  A: TrainGuard(checkpoint_dir, interval 4, keep 2)
   with loss:nan@3, 12 step_async runs with the loss read: one skip, its
   callback at run 3, every persistable bit-unchanged by that step,
   checkpoints at runs 4, 8 and 12.  B: the same with step:sigterm@6: a
   real SIGTERM, TrainingInterrupted with code 0 at run 6, a final
   checkpoint validate_checkpoint accepts (sigterm_to_exit_ms printed).
   C: a fresh executor and scope resume B's checkpoint (run 6;
   train_guard_resume_ms printed) and run to 12.  Gates (tolerance 0):
   C's losses at runs 7-12 equal A's, and every persistable equals A's
   (randomness is keyed by the run count, so the resumed run draws A's
   dropout masks); every step of every life launches 12 / 12 / 12 of
   kernels #1-#3 in bf16 (the replay-aware counters), no plain call,
   nothing realigned.  Then: 20 guarded replays with FLAGS_telemetry on
   and 20 off, in turns (median ms of each); 3 replays between
   profiler.start_profiler and stop_profiler("ave"), whose table must
   name the three kernels; the metrics dir's trace.json holds the
   executor/step, dispatch (each under a step), compile and fetch spans,
   ckpt/write, ckpt/publish and train_guard/resume, heartbeat.json a
   positive examples_per_sec, and python -m
   paddle_tpu_torch.tools.trace_export merges the dir; memory.py's
   max_memory_allocated equals torch.cuda's and drops after reset_peak.
   Printed: the checkpoint's bytes (its manifest), checkpoint_write_ms
   (the sha256 pass included), the resume and SIGTERM ms, the replay ms.
   The "train_guard:" JSON line holds the numbers.
15. recompute (append_backward(checkpoints=...) through
   optimizer.RecomputeOptimizer; the phase's seconds and the run's are
   printed).  Each path is a pair of lives, plain then recompute, each a
   fresh Executor and Scope running its program's startup (the same
   weights: the startup's draws are keyed by the seed and the run count),
   the first closed before the second starts, 6 steps (eager, capture and
   replay, replays), then 5 timed replays and one profiled.
   a. bench.py's step (BERT-base, seq 512, batch 8, 77 predictions, bf16
      AMP with the bench's white list, dropout 0.1), checkpointed at each
      encoder layer's output (bert_checkpoints: the layer_norm after the
      FFN's residual add).
   b. Llama-2-7B's widths at 4 of its 32 layers, batch 2 at Llama-2's
      4096 context, bf16 AMP, under Llama-2's recipe (RECIPE: AdamW
      beta1 0.9, beta2 0.95, eps 1e-5, weight decay 0.1;
      linear_lr_warmup(cosine_decay(3e-4, 1, 6), 2, 0, 3e-4);
      GradientClipByGlobalNorm(1.0); Fluid's cosine decays to 0 where
      Llama-2's stops at 10% of the peak), seeded token batches,
      checkpointed at the residual stream entering each block and at the
      final norm's input (llama_checkpoints).
   Gates (tolerance 0): every fetch of every step (b: the loss and the
   LR) and every persistable after the 6 steps bit-equal between the
   lives; every step launches per_step_launches(main) (a: 12 / 12 / 12 of
   #1-#3 plain, 24 / 12 / 12 with recompute; b: 4 / 4 / 4 of #4-#6
   plain, 8 / 4 / 4), no plain call, nothing realigned; b's LRs equal to
   recipe_lrs, the schedule on the host in float32, within 1e-6 of the
   peak (the card's cos against numpy's); b's recompute eager peak at
   least 3 GiB below plain's.  Printed a life: the eager step's peak
   (torch.cuda.max_memory_allocated after reset_peak_memory_stats), the
   graph pool's bytes, the median replay ms, the profiled replay's idle
   share; and the deepest stack of b's widths whose eager step fits in
   the card's memory, plain and with recompute, reckoned from b's peaks
   (deepest_stack).  The profiled replays are held leniently (see
   below): where no profile both holds every launch and has the most
   records, the replay's device numbers are logged as not measured.
   b's attention shape is timed in phase 7.  The "recompute:" JSON line
   holds the numbers.

16. float16 AMP with dynamic loss scaling (run right after phase 9,
   where torch.profiler still sees the card; the op-seed counter is put
   back afterwards, so phases 10-15 draw what they drew before):
   a. bench.py's seq-512 step (phase 6's: BERT-base, batch 8,
      max_predictions 77, Adam, global-norm clip 1.0, the linear warmup,
      the bench's extra white list, dropout 0.1) with
      decorate(dtype="float16") at its defaults (init 2**15, incr 1000,
      decr 2), through train_flagship as phase 6: 12 / 12 / 12 launches
      a step, no plain call, nothing realigned, finite losses, the
      run_async window and a profiled replay whose attention kernels are
      the float16 (__half) instantiations alone.  Then a life at dropout
      0 from the startup state of an fp32 life of the same step on the
      same feeds: its losses within 2e-4 relative of the fp32 life's
      (FP16_FP32_LOSS_RTOL), and the first step's last layer_norm
      output within FP16_FP32_ACT_RTOL of the fp32 life's, where a bf16
      life's (the control) lies outside it.
   a'. the same step (dropout 0) from init_loss_scaling 2**18, past
      float16's range (incr 2, decr 1), 8 steps, a captured life and an
      eager one (every run a fresh uncached entry): each step fetches
      the loss, loss_scaling_0, its good and bad counters, the overflow
      flag and the first attention layer's d(out) and d(qkv), printed
      with their largest magnitude against 65504.  The scale state
      follows the host's state machine (loss_scale_machine) over the
      flags exactly, falls until a step is finite and then doubles; the
      attention's grads are float16; the two lives bit-equal in every
      fetch and every persistable.  Under the bench's white list
      elementwise_mul runs in float16, so the scaled loss's gradient is
      the scale itself in float16: a scale of 65536 or more is inf
      whatever the data.
   b. phase 9's Llama step (Llama-2-7B's widths, 4 layers, seq 2048,
      AdamW) with decorate(dtype="float16") at its defaults, from phase
      9's op seed (its weights) on its feeds, through train_flagship: 4
      / 4 / 4 launches a step, finite losses within 1e-3 relative of
      phase 9's bf16 ones (FP16_BF16_LOSS_RTOL), a profiled replay on
      the float16 kernels.
   The "fp16:" JSON line holds the numbers and the phase's seconds, and
   the seconds of phases 3 and 7's fp16 cases, times and overflow
   checks.
17. MiniLM-L12-H384 and bench.py's seq-128 step (run right after phase
   7: right after phase 16 the profiler saw no device time in any
   session, even of one elementwise kernel, for 40 s of tries).  MiniLM-L12-H384 (Wang
   et al. 2020; microsoft/MiniLM-L12-H384-uncased: 12 layers, hidden
   384, 12 heads of 32, intermediate 1536, vocab 30522) at its published
   widths, no cut: BERT's builder sends head_dim 32 through the
   unpacked flash_attention op, kernels #4-#6 at D 32 (64-byte-swizzled
   16-bit tiles).
   a. the unpacked kernels at D 32 against their plain versions over
      unpacked_cases(32) (phase 7's grid at D 32) in fp32, bf16 and
      fp16 at phase 7's limits; fp16's overflow check at [2, 4, 128,
      32]; every D-32 instantiation's HGMMA / UTMALDG (16-bit) and
      spills from phase 2's build (none may spill); then each kernel's
      event and device times at MiniLM's training shape [32, 12, 512,
      32] (bf16 and fp16) and its serving shape [4, 12, 128, 32] (fp32),
      not causal, a padding bias, beside its plain version, SDPA with
      the bias as its mask and the bound: the largest of the bytes, the
      products and the exponentials (B*nh*S^2 of them at ~3.9e12 a
      second, PEAK_EXP_PER_S; they bound every D-32 kernel).
   b. MiniLM serving: build_bert_pretrain(is_test=True) at seq 128,
      fp32, saved and served by a Predictor on the card, batches 1, 4
      and 8, two requests each: 12 launches of #4 and one product kernel
      launch a forward product a request, no plain call, no realigned
      operand; each row of a batch-4 request equal to the row served
      alone (tolerance 0); batch 4 against a CPU Predictor at phase 4's
      limits (logits 1e-3, loss rel 1e-4).
   c. MiniLM training: card against the CPU in fp32 at 2 layers, seq
      128, batch 2 (phase 5's gates); then bench.py's recipe at seq 512,
      batch 32, 77 predictions, bf16 AMP, dropout 0.1 through
      train_flagship: 6 steps of 12 / 12 / 12 launches of #4-#6, the
      run_async window and a profiled replay whose attention kernels are
      exactly fa_{fwd,dkv,dq}_tc_kernel<__nv_bfloat16, 32>.
   d. bench.py's default leg, BENCH_SEQ=128, at BERT-base: batch 192, 19
      predictions, bf16 AMP, dropout 0.1, attention unfused as
      _attn_for(128) picks it (matmul, softmax, probability dropout):
      train_flagship (no attention kernel and no plain call a step, the
      run_async window, a profiled replay); the same 6 steps captured
      against FLAGS_check_nan_inf's eager debug run at the same run
      counts, bit for bit, dropout masks included; at dropout 0 the
      unfused, einsum ("xla") and packed-flash lives (3 steps each, the
      unfused life's weights copied into the other two; the first two
      launch no attention kernel, the packed one 12 / 12 / 12 of #1-#3
      a step) give losses within SEQ128_LOSS_RTOL = 1e-2 relative of
      the unfused life's (bf16 rounds at other places in each); then
      BERT-base serving with use_flash=False at seq 128 as in b (no
      attention kernel; the 24 matmuls on the product kernel).
   The "minilm:" and "seq128:" JSON lines hold the numbers and seconds.
18. Wide&Deep (run right after phase 17, where the profiler still sees
   the card).  wide_deep_net's defaults, the Criteo layout of Cheng et
   al. 2016 (26 slots hashed into 1,000,001 ids, 13 dense features,
   embed 10, a 400-400-400 MLP), batch 4096, Adam 1e-3, fp32, no cut;
   ids Zipf(1.1) over a seeded permutation of the vocabulary, labels 1
   at a rate of 0.25; lives of 6 steps from one startup seed:
   a. dense tables (is_sparse=False);
   b. sparse tables, lazy_mode off: (a)'s losses within 1e-5 relative
      and every persistable within 1e-4 of its norm (a parameter's worst
      element within 2 lr a step);
   c. sparse, lazy_mode on: the same program on the CPU from the card's
      startup values within the same limits, and every row no step
      looked up at its startup bits in both tables and both moments;
   d. (c) again in a fresh executor and scope, and (c) with every step
      eager (an uncached entry a run): both bit-equal to (c) in every
      loss and persistable;
   e. wide_deep_serving_net (the embedding tier's dense remainder),
      random weights, fed rows gathered from (c)'s tables, saved and
      served by a Predictor at batches 1 and 64: each row served alone
      gives its row of the batch bit for bit, batch 64 within 1e-5 of a
      CPU Predictor, one product-kernel launch a forward product.
   Each card life counts the merge kernel's launches from 0 against the
   reckoning from its program (merge_launches: 2 a step sparse, 0
   dense) with no plain call and no realigned operand; a profiled
   replay of the lazy step gives its device busy and idle share and top
   kernels.  The "wide_deep:" JSON line holds the numbers.

Every profiled replay (phases 4, 5, 6, 9, 15, 16 and 17) also holds the
profiler's launches of the forward, dK/dV and dQ kernels against what the
replay-aware counters added over it: a replay runs no wrapper, so this
is what shows that the counts the per-step gates read are the
kernels that ran.  torch.profiler now and then loses kernel records;
while the two disagree the replay is profiled again, up to 3 in all,
each profile's kernel records and launches logged.  A disagreement is
put down to lost records only in a profile with fewer kernel records
than another of the same replay; the profile with the most records
must agree (phases 4, 5, 6, 9, 16 and 17).  Phase 15's replays, late in the
run, are held leniently: a profile whose launches equal the counters'
proves them (its device numbers stand only if it is the fullest), a
profile that saw more launches than the counters added fails, and where
every profile falls short the device numbers are not measured.

On every path (phases 4, 5, 6, 8, 9, 10, 15, 16, 17) no 16-bit operand is copied to
meet TMA's 16-byte alignment: the launching wrappers' ".realigned"
counts stay 0.

The "launches" of each kernel in the kernels line is its count on its
slice's main path: phase 6 (BERT training) for the packed kernels, phase
9 (Llama training) for the unpacked ones. "launches_by_path" has beside
it the count of every path, each read from 0: serving (phase 4),
training_parity (phase 5, card steps), training_flagship (phase 6),
llama_parity (phase 8, card steps), llama_flagship (phase 9),
generation_parity (phase 10a, card requests), generation (phase 10b's
dense traffic), generation_paged and generation_shared_prefix (its two
paged runs), generation_spec (10c's speculating run) and
generation_disagg (10d's pair, both transports), serving_engine (11a's
2-worker traffic), serving_http (11b's generation traffic), loadgen
(13a in process), chaos (13b in this process), train_guard (phase
14's three lives), recompute_bert_plain, recompute_bert,
recompute_llama_plain and recompute_llama (phase 15's lives),
training_fp16 and llama_fp16 (16a's and 16b's flagships),
minilm_serving, minilm_parity (card steps) and minilm_flagship (17b,
17c), seq128_unfused and seq128_serving (17d), wide_deep_dense,
wide_deep_sparse, wide_deep_lazy and wide_deep_serving (18a-c, 18e); and
fleet_serving,
fleet_generation and chaos_fleet (12a, 12b, 13b's probe fleet), which
count kernel records in a replica's /profilez trace instead (the
replicas' counters live in their processes): each kernel's
"trace_record_paths" names them. Kernel #4's entry also carries "f32_prefill": the fp32
forward at the largest prefill bucket, [1, 32, 512, 128] causal; #4-#6
carry "seq4096": their bf16 rows at phase 15b's [1, 32, 4096, 128]; all
six carry "f16": their fp16 kernel's device_ms, ms, bound_ms,
max_abs_err and SDPA's fp16 library_device_ms, at BERT's training shape
[8, 512, 2304] (packed) and the Llama shape (unpacked). Entries 7-9
are #4-#6 at D 32 (flash_attention_{fwd,dkv,dq}_d32): their bf16 rows at
MiniLM's training shape [32, 12, 512, 32] with "bound_quantity" (which
of bytes, products and exponentials sets the bound), "launches" phase
17c's flagship's, "f16" their fp16 rows at the same shape and "f32"
their fp32 rows at MiniLM's serving shape ("f32_shape"). The
four backward entries also carry "f32": their fp32 kernel's device_ms,
ms, bound_ms and SDPA's fp32 backward's library_device_ms at the same
shape (BERT's training shape for the packed, the Llama shape for the
unpacked ones). The tenth entry is the product kernel (gemm_f32): its
row the decode step's qkv product (M 4, K 4096, N 12288), its "launches"
phase 10b's dense traffic's, "tolerance_ratio" the largest |kernel -
plain| / gemm.tolerance of phase 2 and the smallest of its TF32 and bf16
controls, "shapes" every shape phase 2 timed (decode attention's
products among them); the eleventh the RMSNorm
kernel (rms_norm_f32): its row the decode step's [4, 4096], "library_ms"
torch.nn.functional.rms_norm's; the twelfth the SelectedRows merge
kernel (selected_rows_merge): its row the deep table's [106496, 10]
merge (the wrapper's time: sort, scan and kernel; "kernel_device_ms" the
kernel alone), "library_ms" torch's index_add_ of the same sums,
"launches" phase 18c's lazy life's, "shapes" both tables' widths. The
last lines are the card's name and
power limit, one {"kernels": ...} JSON line, and {"ok": true, "device":
{...}}. Before them, one "compiled step:" JSON line holds each profiled
path's wall ms, device busy ms, idle share and host launches
(serving_b4, bert_fp32, bert_flagship, llama_flagship, bert_fp16,
llama_fp16, minilm_flagship, seq128_unfused) and the attention kernels'
element types and instantiations each ran, the run_async
windows' ms/step and tokens/s, whether captured = eager came out
bit-equal and the memory with two captured Llama entries
(llama_two_signatures), and phase 10's profiled replays
(generation_decode, generation_prefill, generation_paged_decode,
generation_verify).  The "generation:" JSON line holds phase 10's
numbers, 10c's under "spec" and 10d's under "disagg".

Every phase runs through the executor's compiled step (Executor.run /
run_async and Predictor.run on the card: the first run of a signature
eager, the second captured as one CUDA graph, the rest replays), and
closes its executor (graphs and pools) before the next.
"""
import contextlib
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
# the bytecode of every module this run imports, beside the built kernels
BYTECODE_CACHE = os.path.join(HERE, "paddle_tpu_torch", "_build", "pycache")

# H100 SXM peaks (NVIDIA data sheet, at the card's 700 W power limit): HBM3
# bandwidth, the fp32 rate outside the tensor cores and the dense bf16
# tensor-core rate.  A kernel's bound uses the peak for its inputs' type.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}
# the exponentials of the special-function units, ~3.9e12 a second on an
# H100 SXM (Shah et al. 2024, FlashAttention-3, section 1): at head_dim 32
# an attention kernel's B*nh*Sq*Sk exponentials take longer than its
# products (4*B*nh*Sq*Sk*D flop forward)
PEAK_EXP_PER_S = 3.9e12

BERT = dict(batch_size=4, seq_len=128, vocab_size=30522, hidden=768,
            num_layers=12, num_heads=12, intermediate=3072)
FP32_OUT_ATOL, FP32_LSE_ATOL, BF16_OUT_ATOL = 2e-5, 1e-5, 2e-2
DEAD_OUT_ATOL, DEAD_LSE_ATOL = 2.0 ** -11, 2.0 ** -10
DBIAS_ATOL = 1e-4
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
# float16 rounds the same values (P, dS, P^T, dS^T and the outputs) to
# 2**-11 where bfloat16 rounds them to 2**-8, eight times finer.  Its
# absolute limits are a quarter of bf16's (a factor 2 of room over the
# ratio): out 5e-3, grads 1.25e-2.  Per 128-row block: bf16's ~4e-3 (two
# roundings of 2**-9) scales to ~5e-4, and the limit, 1e-3, lies between
# the largest fp16 block reading on an H100 (3.4e-4) and the smallest
# bf16 one (1.8e-3), so a kernel that rounded to bf16 would fail it.
# lse keeps its fp32 limits.  The all-padding row's out is held to the
# dtype's out limit, as bf16's is: the 16-bit kernels round its P and
# its output as they round a live row's (fp16 readings up to 9.9e-4,
# above 2**-11); its grads to the larger of the dtype's and
# DEAD_GRAD_ATOL.
FP16_OUT_ATOL, FP16_GRAD_ATOL, FP16_REL_LIMIT = 5e-3, 1.25e-2, 1e-3
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
# the run_async window of phases 6 and 9, fenced once at its end
ASYNC_STEPS = 20

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
# phase 10: greedy generation at Llama-2-7B's widths, fp32 weights, a
# dense KV cache of 4 slots x 1024 positions, prefill buckets 64-512, 8
# requests of 20-500 prompt tokens and 64 new tokens each.  Depth cut to
# 8 of its 32 layers (phases 10b-d, 11b, 12b, 13's engines and
# replicas), so the whole run stays within its 1200 s (PERF.md section 4)
GEN = dict(LLAMA, num_layers=8)
GEN_ENGINE = dict(num_slots=4, max_seq_len=1024,
                  prefill_buckets=(64, 128, 256, 512), max_new_tokens=64,
                  deadline_ms=600000.0)
GEN_PROMPTS = (20, 100, 500, 64, 200, 300, 130, 450)
GEN_NEW_TOKENS = 64
# phase 10b (ii): a 256-token header (16 pages) shared by 8 requests, each
# with its own tail
GEN_SHARED_HEADER = 256
GEN_SHARED_TAILS = (20, 45, 70, 95, 120, 150, 175, 200)
# gates (a) and (b) at 2 layers of the same widths: 2 slots, 128
# positions, two concurrent requests
GEN_PARITY = dict(LLAMA, num_layers=2)
GEN_PARITY_ENGINE = dict(num_slots=2, max_seq_len=128,
                         prefill_buckets=(32, 64), keep_logits=True,
                         deadline_ms=600000.0)
GEN_PARITY_PROMPTS = (20, 50)
GEN_PARITY_NEW_TOKENS = 24
# the paged cache's page (FLAGS_serving_kv_page_tokens' default)
GEN_PAGE = 16
# phase 10c: speculative decoding at full width.  Bucket 8 first, so that
# a verify ([pending, draft...], at most spec_tokens + 1 = 5 rows) runs 8
# rows, not 64; 8 requests: four prompts repeating an 8-token pattern,
# four of GEN_PROMPTS, two of the eight (one of each kind) opted out
GEN_SPEC_ENGINE = dict(GEN_ENGINE, prefill_buckets=(8, 64, 128, 256, 512),
                       keep_logits=True)
GEN_SPEC = dict(spec_tokens=4, spec_ngram=3)
GEN_SPEC_PATTERN = 8
GEN_SPEC_REPEATS = (64, 100, 200, 300)
GEN_SPEC_OPT_OUT = (1, 5)
# phase 17: MiniLM-L12-H384 (Wang et al. 2020; the config of
# microsoft/MiniLM-L12-H384-uncased): 12 layers, hidden 384, 12 heads of
# 32, intermediate 1536, vocab 30522, 512 positions, 2 token types: the
# repo's bert_encoder at these widths, no cut.  BERT's builder sends head
# dim 32 through the unpacked flash_attention op (kernels #4-#6 at D 32).
MINILM = dict(vocab_size=30522, hidden=384, num_layers=12, num_heads=12,
              intermediate=1536)
MINILM_SERVE_SEQ = 128
# 17c: card against the CPU at 2 layers, then bench.py's recipe at seq 512
MINILM_PARITY = dict(MINILM, num_layers=2, batch_size=2, seq_len=128,
                     max_predictions=19)
MINILM_TRAIN = dict(MINILM, batch_size=32, seq_len=512,
                    max_predictions=int(round(0.15 * 512)))
MINILM_STEPS = 6
# 17a's timed attention shapes (B, heads, S, D): MiniLM's training step
# and a batch-4 serving request
MINILM_TRAIN_ATTN = (32, 12, 512, 32)
MINILM_SERVE_ATTN = (4, 12, 128, 32)
# 17d: bench.py's default leg, BENCH_SEQ=128 (bench.py run_config:
# batch 192 below seq 512, max_predictions round(0.15 * seq) = 19,
# dropout 0.1, bf16 AMP), with _attn_for(128)'s unfused attention
SEQ128 = dict(BERT_BASE, batch_size=192, seq_len=128, max_predictions=19)
SEQ128_STEPS = 6
# the control lives at dropout 0 (unfused, einsum, packed flash) and the
# limit on their losses' spread: each rounds to bf16 at other places (P
# in the flash kernels, scores and probabilities in the other two), a
# loss near ln(30522) of random weights
SEQ128_CONTROL_STEPS = 3
SEQ128_LOSS_RTOL = 1e-2
MINILM_RUN = {}
SEQ128_RUN = {}
# phase 11: the serving stack.  11a: BERT-base at its published widths,
# seq 128, fp32, saved with row-shaped fetches; ServingEngine at max batch
# 8 (buckets 1 / 2 / 4 / 8), max delay 5 ms; 64 requests of 1-3 rows from
# a seed, 16 client threads in a closed loop, at 1 and at 2 workers; the
# weights of the first seed, then the second's by hot-swap
SERVE_BERT = dict(BERT_BASE, seq_len=128)
SERVE_ENGINE = dict(max_batch=8, max_delay_ms=5.0, queue_cap=256,
                    deadline_ms=600000.0)
SERVE_REQUESTS = 64
SERVE_ROWS = (1, 3)
SERVE_CLIENTS = 16
SERVE_SEEDS = (41, 42)
# the poison sentinel: the last token id, which no other request holds
SERVE_POISON_ID = 30521
SERVE_SWAP_REQUESTS = 16
# the closed loop runs the 64 requests this many times a worker count
# (every round gated; the median round's rates reported)
SERVE_ROUNDS = 3
SERVE_PROFILE_REQUESTS = 32
# 11b: the GEN_PROMPTS handed from a prefill-role server to /adopt
SERVE_ADOPT = (0, 3, 1)
# phase 11's numbers, for the "serving:" line
SERVING = {}
# the backward kernels' grads (dqkv; dq, dk, dv) in fp32 and bf16
FP32_GRAD_ATOL, BF16_GRAD_ATOL = 1e-4, 5e-2
# each dtype's limits: out, grads (dqkv; dq, dk, dv), per-block relative
OUT_ATOL = {"float32": FP32_OUT_ATOL, "bfloat16": BF16_OUT_ATOL,
            "float16": FP16_OUT_ATOL}
GRAD_ATOL = {"float32": FP32_GRAD_ATOL, "bfloat16": BF16_GRAD_ATOL,
             "float16": FP16_GRAD_ATOL}
REL_LIMIT = {"bfloat16": BF16_REL_LIMIT, "float16": FP16_REL_LIMIT}
# the 16-bit tensor-core kernels, each built for bf16 and fp16 at D 32, 64
# and 128 (D 32 in 64-byte-swizzled tiles, since PR 20)
TC_KERNELS = ("fa_fwd_tc_kernel", "fa_dq_tc_kernel", "fa_dkv_tc_kernel")
HEAD_DIMS = (32, 64, 128)
# the fp32 forward (template <D, warps a block>), built at D 64 and 128
# with 16-row (2 warps of 8 rows) and 64-row (8 warps) q tiles, at D 32
# with 64-row ones
F32_FWD_KERNELS = ("fa_fwd_f32_kernel<32, 8>",) + tuple(
    f"fa_fwd_f32_kernel<{D}, {w}>" for D in (64, 128) for w in (2, 8))
# the fp32 backward (template <D, row groups a warp>), 8-warp blocks built
# at D 32 and 64 with 4 row groups (128 keys for dK/dV, 128 q rows for dQ)
# and at D 128 with 2 (64 keys, 64 q rows)
F32_BWD_KERNELS = tuple(f"{k}<{D}, {rg}>" for k in ("fa_dkv_f32_kernel",
                                                   "fa_dq_f32_kernel")
                        for D, rg in ((32, 4), (64, 4), (128, 2)))
# every kernel instantiation phase 2 holds to its checks, by kernel_label
TC_LABELS = tuple(f"{kernel}<{t}, {D}>" for kernel in TC_KERNELS
                  for t in ("bf16", "f16") for D in HEAD_DIMS)
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


DEVICE_MS_TRIES = 6


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
    for attempt in range(DEVICE_MS_TRIES):
        # a session now and then records nothing at all (three in a row
        # once, in phase 7): try again after a pause
        if attempt:
            time.sleep(0.5)
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
    raise AssertionError(f"the profiler saw no device time in "
                         f"{DEVICE_MS_TRIES} tries")


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


# seconds each dtype's cases took in phases 3 and 7 (count_seconds)
CASE_SECONDS = {}


def count_seconds(dtype, t0):
    CASE_SECONDS[dtype] = CASE_SECONDS.get(dtype, 0.0) + \
        time.perf_counter() - t0


def kernel_cases():
    """(name, B, S, H, nh, causal, bias kind, dtype)"""
    cases = []
    for dtype in ("float32", "bfloat16", "float16"):
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
        t = time.perf_counter()
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
        tol = OUT_ATOL[dtype]
        ok = out_live <= tol and lse_live <= FP32_LSE_ATOL
        msg = (f"  {name}: out max|err| {out_live:.3e} (atol {tol:g}), "
               f"lse {lse_live:.3e} (atol {FP32_LSE_ATOL:g})")
        if dtype != "float32":
            rel, = packed_rel_errs(out[live], ref_out[live], nh, H)
            ok = ok and rel <= REL_LIMIT[dtype]
            msg += f", out rel {rel:.3e} (limit {REL_LIMIT[dtype]:g})"
        if bias is not None:
            out_dead = err[B - 1].max().item()
            lse_dead = lerr[B - 1].max().item()
            dead_tol = max(DEAD_OUT_ATOL, tol)
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
        count_seconds(dtype, t)


def nonfinite_kept(got, want, what):
    """Every value the plain version (`want`) leaves inf or NaN is inf or
    NaN in the kernel's `got` too: an overflow is never clamped or
    masked away.  Returns how many there are."""
    import torch

    bad_want = ~torch.isfinite(want.float())
    kept = bool((~torch.isfinite(got.float()) | ~bad_want).all())
    n = int(bad_want.sum())
    log(f"  {what}: {n} non-finite values in the plain version, "
        f"{int((~torch.isfinite(got.float())).sum())} in the kernel's"
        f"{'' if kept else ' (NOT all of the plain version)'}")
    if not kept or n == 0:
        raise AssertionError(f"{what}: an overflow did not reach the "
                             f"kernel's output")
    return n


def check_fp16_overflow(fa, device, unpacked, D=128):
    """float16 inputs that overflow give inf or NaN where the plain
    version does, never a finite value (nonfinite_kept): an inf planted
    in one v value (batch 0, key 5, head 0) reaches out; an inf planted in
    dO (batch 0, row 3, head 0) reaches dq, dk and dv; and dO near
    float16's top (60000 on head 0) gives dv = P^T dO past 65504, which
    rounds to inf exactly where the plain version's float32 dv is past
    float16's rounding threshold of 65520 (values within 1e-3 relative of
    it excused: the two sum in other orders); the rest of the batch stays
    finite.  Packed [2, 128, 3 x 768] (12 heads of 64), or unpacked
    [2, 4, 128, D] views."""
    import torch

    inf = float("inf")
    if unpacked:
        q, k, v, _, dout = unpacked_inputs(2, 4, 128, 128, D, "none", True,
                                           41, device, "float16")

        def fwd():
            return fa.flash_attention_unpacked(q, k, v)

        def bwd(out, lse, g):
            return fa.flash_attention_unpacked_backward(q, k, v, None, out,
                                                        lse, g)

        def ref_fwd():
            return fa.flash_attention_reference(q.float(), k.float(),
                                                v.float())

        def ref_bwd(out, lse, g):
            return fa.flash_attention_backward_reference(
                q.float(), k.float(), v.float(), None, out.float(), lse,
                g.float())

        v_at, do_at, hot = (0, 0, 5, 0), (0, 0, 3, 0), (0, 0)
        what = f"unpacked fp16 [2, 4, 128, {D}]"

        def dv_of(g):
            return g[2][0, 0]

        def rest(g):  # batch 1's grads
            return [t[1] for t in g[:3]]
    else:
        B, S, H, nh = 2, 128, 768, 12
        qkv, _ = make_inputs(B, S, H, "none", 41, device, "float16")
        v = qkv[..., 2 * H:]

        def fwd():
            return fa.flash_attention_packed(qkv, None, nh)

        def bwd(out, lse, g):
            return fa.flash_attention_packed_backward(qkv, None, out, lse, g,
                                                      nh)

        def ref_fwd():
            return fa.flash_attention_packed_reference(qkv.float(), None, nh)

        def ref_bwd(out, lse, g):
            return fa.flash_attention_packed_backward_reference(
                qkv.float(), None, out.float(), lse, g.float(), nh)

        v_at, do_at, hot = (0, 5, 0), (0, 3, 0), (0, slice(None),
                                                  slice(0, 64))
        what = "packed fp16 [2, 128, 2304]"

        def dv_of(g):  # batch 0's dv of head 0
            return g[0][0, :, 2 * H:2 * H + 64]

        def rest(g):  # batch 1's dqkv
            return [g[0][1]]
        dout = torch.from_numpy(np.random.RandomState(42).randn(
            B, S, H).astype("float32")).to(device, torch.float16)
    # forward: an inf in v
    saved = v[v_at].clone()
    v[v_at] = inf
    out, lse = fwd()
    torch.cuda.synchronize()
    ref_out, _ = ref_fwd()
    nonfinite_kept(out, ref_out, f"{what} forward, inf in v")
    v[v_at] = saved
    # backward: an inf in dO, then dO at 60000 on batch 0's head 0
    out, lse = fwd()
    for name, g in (("inf in dO", None), ("dO 60000 on head 0", 60000.0)):
        g_in = dout.clone()
        if g is None:
            g_in[do_at] = inf
        else:
            g_in[hot] = g
        grads = bwd(out, lse, g_in)
        torch.cuda.synchronize()
        ref = ref_bwd(out, lse, g_in)
        if g is None:
            for j, (a, b) in enumerate(zip(grads, ref)):
                if a is not None:
                    nonfinite_kept(a, b, f"{what} backward, {name}, "
                                   f"output {j}")
            continue
        got_dv, want_dv = dv_of(grads), dv_of(ref).float()
        over = want_dv.abs() > 65520.0 * (1 + 1e-3)
        under = want_dv.abs() < 65520.0 * (1 - 1e-3)
        inf_got = torch.isinf(got_dv.float())
        log(f"  {what} backward, {name}: plain dv max "
            f"{want_dv.abs().max().item():.1f}; {int(over.sum())} values "
            f"past 65520 (the kernel's inf there: "
            f"{int((inf_got & over).sum())}), "
            f"{int((inf_got & under).sum())} infs below it")
        if not over.any() or not bool(inf_got[over].all()) or \
                bool(inf_got[under].any()) or \
                not all(bool(torch.isfinite(t.float()).all())
                        for t in rest(grads)):
            raise AssertionError(f"{what}: dv past float16's range does not "
                                 f"round to inf where the plain version's "
                                 f"does")


# The fp32 forward's timed shapes: (name, B, heads, S, D, causal, packed,
# event iterations): BERT-base serving at batch 1, 4 and 8 (packed, seq
# 128, padding bias), BERT's training shape (B 8, S 512) and the Llama
# shape (unpacked, causal, [B, H, S, D] views of [B, S, H, D] buffers).
FWD_F32_SHAPES = (("serving_B1", 1, 12, 128, 64, False, True, 200),
                  ("serving_B4", 4, 12, 128, 64, False, True, 200),
                  ("serving_B8", 8, 12, 128, 64, False, True, 200),
                  ("training", 8, 12, 512, 64, False, True, 20),
                  ("llama", 1, 32, 2048, 128, True, False, 5),
                  ("prefill", 1, 32, 512, 128, True, False, 20))


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
        t = time.perf_counter()
        qkv, bias = make_inputs(B, S, H, bias_kind, 300 + i, device, dtype)
        out, lse, dout = backward_inputs(fa, qkv, bias, nh, causal, 400 + i)
        dqkv, dbias = fa.flash_attention_packed_backward(
            qkv, bias, out, lse, dout, nh, causal)
        torch.cuda.synchronize()
        ref, ref_db = fa.flash_attention_packed_backward_reference(
            qkv.float(), bias, out.float(), lse, dout.float(), nh, causal)
        err = (dqkv.float() - ref).abs()
        live = slice(0, B - 1) if bias is not None else slice(0, B)
        tol = GRAD_ATOL[dtype]
        live_err = err[live].max().item()
        ok = live_err <= tol and bool(torch.isfinite(dqkv.float()).all())
        msg = f"  {name}: dqkv max|err| {live_err:.3e} (atol {tol:g})"
        if dtype != "float32":
            rel = packed_rel_errs(dqkv[live], ref[live], nh, H)
            ok = ok and max(rel) <= REL_LIMIT[dtype]
            msg += (", rel dq {:.3e}, dk {:.3e}, dv {:.3e}".format(*rel) +
                    f" (limit {REL_LIMIT[dtype]:g})")
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
        count_seconds(dtype, t)


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
    tol = GRAD_ATOL[dtype]
    if dtype != "float32":
        rel = packed_rel_errs(dqkv, ref, nh, H)
        log("  rel dq {:.3e}, dk {:.3e}, dv {:.3e}".format(*rel) +
            f" (limit {REL_LIMIT[dtype]:g})")
        if not max(rel) <= REL_LIMIT[dtype]:
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


def time_forward_flagship(fa, device, dtype):
    """The forward kernel at the flagship training shape in `dtype` (bf16
    or fp16), timed beside its plain version and SDPA, and held against
    its plain version; returns its row (the packed forward's line in the
    kernels JSON stays at the serving shape; its "f16" entry is this
    row in fp16)."""
    import torch.nn.functional as F

    B, S, H, nh = FLAGSHIP["batch_size"], FLAGSHIP["seq_len"], 768, 12
    D = H // nh
    qkv, bias = make_inputs(B, S, H, "pad_dead_row", 19, device, dtype)
    bias[-1] = 0.0
    ms, dev = timed(lambda: fa.flash_attention_packed(qkv, bias, nh),
                    iters=20, device_iters=10)
    plain_ms = cuda_ms(lambda: fa.flash_attention_packed_reference(
        qkv, bias, nh), iters=3, warmup=1)
    x = qkv.view(B, S, 3, nh, D)
    q, k, v = (x[:, :, j].transpose(1, 2) for j in range(3))
    lib_ms, lib_dev = timed(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=bias[:, None, None, :].to(qkv.dtype)), iters=20,
        device_iters=10)
    flops = 4.0 * B * nh * S * S * D
    nbytes = (qkv.numel() + B * S * H) * qkv.element_size() + \
        (bias.numel() + B * nh * S) * 4
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOP_PER_S[dtype] * 1e3
    out, lse = fa.flash_attention_packed(qkv, bias, nh)
    ref_out, ref_lse = fa.flash_attention_packed_reference(qkv.float(), bias,
                                                           nh)
    out_err = (out.float() - ref_out).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    rel, = packed_rel_errs(out, ref_out, nh, H)
    tol, rel_tol = OUT_ATOL[dtype], REL_LIMIT[dtype]
    row = dict(ms=ms, device_ms=dev, plain_ms=plain_ms, library_ms=lib_ms,
               library_device_ms=lib_dev, bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               max_abs_err=max(out_err, lse_err))
    log(f"  forward at B={B} S={S} H={H} nh={nh} {dtype} with bias: kernel "
        f"{ms:.5f} ms events / {dev:.5f} ms device, plain {plain_ms:.5f} "
        f"ms, sdpa {lib_ms:.5f} / {lib_dev:.5f} ms, bound "
        f"{row['bound_ms']:.5f} ms ({row['bound_by']}: {flops:.4g} flop, "
        f"{nbytes} bytes); out max|err| {out_err:.3e} (atol {tol:g}), rel "
        f"{rel:.3e} (limit {rel_tol:g}), lse {lse_err:.3e} (atol "
        f"{FP32_LSE_ATOL:g})")
    if not (out_err <= tol and lse_err <= FP32_LSE_ATOL and
            rel <= rel_tol):
        raise AssertionError(f"forward kernel disagrees with its plain "
                             f"version at the flagship shape ({dtype})")
    return row


def unpacked_cases(D=None):
    """(name, B, H, Sq, Sk, D, causal, bias kind, views, dtype): the Llama
    attention shape, D 64, ragged S 100, Sq != Sk both ways, bias or not,
    views of [B, S, H, D] buffers or contiguous tensors; with `D`, the
    same grid at that head_dim (phase 17a's D 32)."""
    shapes = [(1, 32, 2048, 2048, 128, True, "none", True),
              (2, 4, 128, 128, 64, True, "none", True),
              (2, 4, 128, 128, 64, False, "pad_dead_row", False),
              (2, 2, 100, 100, 128, True, "pad_dead_row", True),
              (3, 2, 100, 100, 64, False, "none", False),
              (2, 2, 128, 384, 64, True, "pad_dead_row", True),
              (2, 2, 384, 128, 128, False, "none", True),
              (2, 2, 128, 384, 128, False, "pad_dead_row", False)]
    if D is not None:
        shapes = [(B, H, Sq, Sk, D, *rest)
                  for B, H, Sq, Sk, _, *rest in shapes]
    return [(f"{dtype}_B{B}_H{H}_Sq{Sq}_Sk{Sk}_D{D}_"
             f"{'causal' if causal else 'full'}_{bias}_"
             f"{'views' if views else 'contiguous'}",
             B, H, Sq, Sk, D, causal, bias, views, dtype)
            for dtype in ("float32", "bfloat16", "float16")
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
    rows and over the all-padding row (None without a bias); in bf16 and
    fp16 also the block_rel_err of (out, dq, dk, dv) over the live rows
    (else None)."""
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
    if q.dtype != torch.float32:
        rel = [block_rel_err(got[live], want[live])
               for got, want in [pairs[0]] + pairs[2:5]]
    return errs_live, (errs_dead if bias is not None else None), rel


def unpacked_limits(dtype):
    """(out, lse, dq, dk, dv, dbias) tolerances on live rows and on the
    all-padding row, as the docstring states them."""
    out, grad = OUT_ATOL[dtype], GRAD_ATOL[dtype]
    live = [out, FP32_LSE_ATOL, grad, grad, grad, DBIAS_ATOL]
    dead = [max(DEAD_OUT_ATOL, out), DEAD_LSE_ATOL] + [
        max(grad, DEAD_GRAD_ATOL)] * 3 + [max(DBIAS_ATOL, DEAD_GRAD_ATOL)]
    return live, dead


def check_unpacked(fa, device, cases=None, seed=900):
    """Each of `cases` (unpacked_cases()'s) through the unpacked kernels
    against their plain versions, at the phase's limits."""
    import torch

    names = ("out", "lse", "dq", "dk", "dv", "dbias")
    for i, (name, B, H, Sq, Sk, D, causal, bias_kind, views, dtype) in \
            enumerate(unpacked_cases() if cases is None else cases):
        t = time.perf_counter()
        q, k, v, bias, dout = unpacked_inputs(B, H, Sq, Sk, D, bias_kind,
                                              views, seed + i, device, dtype)
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
            ok = ok and max(rel) <= REL_LIMIT[dtype]
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
                                 f"rel {REL_LIMIT.get(dtype)})")
        count_seconds(dtype, t)
        del q, k, v, dout, out, lse, grads
    torch.cuda.empty_cache()


def time_unpacked(fa, device, dtype, library_kernels=None, shape=None,
                  causal=True, bias_kind="none"):
    """Times of the three unpacked kernels at the Llama flagship's
    attention shape (B 1, 32 heads, S 2048, D 128, causal, views of
    [B, S, H, D] buffers as rope leaves them), or `shape` (B, H, S, D),
    in `dtype`, causal or not, with a padding bias (`bias_kind`
    "pad_dead_row", as unpacked_inputs makes it) or none, beside their
    plain versions and scaled_dot_product_attention (is_causal, or the
    bias as its additive mask) forward and backward (torch.autograd.grad
    over one forward, grads of q, k, v): event ms of back-to-back calls
    and device ms.  The timed results are held to the phase's tolerances.
    The work is what the causal mask leaves: S (S + 1) / 2 live (q, k)
    pairs, else S**2.  Each bound is the largest of the bytes, the
    products and the exponentials (one a live pair in every kernel:
    PEAK_EXP_PER_S), its quantity in `bound_quantity`.  A list given as
    `library_kernels` gets SDPA's backward kernels (device_ms's names)."""
    import torch
    import torch.nn.functional as F

    B, H, S, D = shape or (LLAMA_FLAGSHIP["batch_size"], LLAMA["num_heads"],
                           LLAMA_FLAGSHIP["seq_len"],
                           LLAMA["hidden"] // LLAMA["num_heads"])
    q, k, v, bias, dout = unpacked_inputs(B, H, S, S, D, bias_kind, True, 17,
                                          device, dtype)
    scale = 1.0 / math.sqrt(D)
    lib_kw = dict(is_causal=True) if causal else dict(
        attn_mask=None if bias is None else
        bias[:, None, None, :].to(q.dtype))
    fwd_ms, fwd_dev = timed(
        lambda: fa.flash_attention_unpacked(q, k, v, bias, causal), iters=10,
        device_iters=5)
    fwd_plain_ms = cuda_ms(
        lambda: fa.flash_attention_reference(q, k, v, bias, causal), iters=3,
        warmup=1)
    fwd_lib_ms, fwd_lib_dev = timed(lambda: F.scaled_dot_product_attention(
        q, k, v, **lib_kw), iters=10, device_iters=5)

    out, lse = fa.flash_attention_unpacked(q, k, v, bias, causal)
    fa.check_unpacked_backward_inputs(q, k, v, bias, out, lse, dout)
    delta = (dout.float() * out.float()).sum(-1).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dbias_heads = None if bias is None else torch.empty(
        (B, H, S), dtype=torch.float32, device=device)
    dkv_ms, dkv_dev = timed(lambda: fa.flash_attention_unpacked_dkv(
        q, k, v, bias, dout, lse, delta, dk, dv, dbias_heads, causal, scale),
        iters=10, device_iters=5)
    dq_ms, dq_dev = timed(lambda: fa.flash_attention_unpacked_dq(
        q, k, v, bias, dout, lse, delta, dq, causal, scale), iters=10,
        device_iters=5)
    bwd_plain_ms = cuda_ms(lambda: fa.flash_attention_backward_reference(
        q, k, v, bias, out, lse, dout, causal), iters=3, warmup=1)
    ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, **lib_kw)
    lib_kernels = [] if library_kernels is None else library_kernels
    bwd_lib_ms, bwd_lib_dev = timed(lambda: torch.autograd.grad(
        lib_out, (ql, kl, vl), dout, retain_graph=True), iters=10,
        device_iters=5, names=lib_kernels)
    log_kernels(f"sdpa's {dtype} backward", lib_kernels)
    del lib_out, ql, kl, vl

    dbias = None if bias is None else dbias_heads.sum(1)
    live, dead, rel = unpacked_errors(fa, q, k, v, bias, dout, causal, out,
                                      lse, (dq, dk, dv, dbias))
    lim, lim_dead = unpacked_limits(dtype)
    if rel is not None:
        log("  timed results: rel " + ", ".join(
            f"{n} {e:.3e}" for n, e in zip(REL_NAMES, rel)) +
            f" (limit {REL_LIMIT[dtype]:g})")
    if not (all(e <= t for e, t in zip(live, lim)) and
            (dead is None or all(e <= t for e, t in zip(dead, lim_dead)))
            and (rel is None or max(rel) <= REL_LIMIT[dtype])):
        raise AssertionError(f"unpacked kernels disagree with their plain "
                             f"versions in the timed calls: {live}, "
                             f"all-padding row {dead}, rel {rel}")
    elem = q.element_size()
    tile = B * H * S * D * elem                  # one [B, H, S, D] tensor
    rows = B * H * S * 4                         # one [B, H, S] f32 row set
    keys = 0 if bias is None else B * S * 4      # the bias row set
    live_pairs = B * H * (S * (S + 1) / 2.0 if causal else float(S * S))
    pairs = live_pairs * D                       # live multiply-adds / 2
    rows_out = {}
    for name, flops, nbytes, ms, dev, plain_ms, lib_ms, lib_dev, err in (
            ("fwd", 4 * pairs, 4 * tile + rows + keys, fwd_ms, fwd_dev,
             fwd_plain_ms, fwd_lib_ms, fwd_lib_dev, max(live[:2])),
            ("dkv", 8 * pairs, 6 * tile + 2 * rows + keys * (1 + H), dkv_ms,
             dkv_dev, bwd_plain_ms, bwd_lib_ms, bwd_lib_dev,
             max(live[3:5])),
            ("dq", 6 * pairs, 5 * tile + 2 * rows + keys, dq_ms, dq_dev,
             bwd_plain_ms, bwd_lib_ms, bwd_lib_dev, live[2])):
        times = {"bytes": nbytes / PEAK_BYTES_PER_S * 1e3,
                 "products": flops / PEAK_FLOP_PER_S[dtype] * 1e3,
                 "exponentials": live_pairs / PEAK_EXP_PER_S * 1e3}
        quantity = max(times, key=times.get)
        rows_out[name] = dict(
            ms=ms, device_ms=dev, plain_ms=plain_ms, library_ms=lib_ms,
            library_device_ms=lib_dev, bound_ms=times[quantity],
            bound_by="bytes" if quantity == "bytes" else "operations",
            bound_quantity=quantity, max_abs_err=err)
        log(f"  {name} at B={B} H={H} S={S} D={D} "
            f"{'causal' if causal else 'full'}"
            f"{'' if bias is None else ', padding bias'} {dtype}: kernel "
            f"{ms:.5f} ms events / {dev:.5f} ms device, plain "
            f"{plain_ms:.5f} ms, sdpa {lib_ms:.5f} / {lib_dev:.5f} ms, "
            f"bound {times[quantity]:.5f} ms ({quantity}: "
            f"{live_pairs:.4g} exponentials, {flops:.4g} flop, {nbytes} "
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
    from paddle_tpu_torch.ops.cuda import gemm, rms_norm, selected_rows

    return (fa.flash_attention_packed_reference,
            fa.flash_attention_packed_backward_reference,
            fa.flash_attention_reference,
            fa.flash_attention_backward_reference, gemm.matmul_reference,
            rms_norm.rms_norm_rows_reference,
            selected_rows.merge_rows_reference)


def tma_wrappers(fa):
    """The wrappers that launch a bfloat16 TMA kernel and count the
    operands they had to copy to meet its alignment (``.realigned``): all
    six."""
    return kernel_wrappers(fa)


class Launches(tuple):
    """The six attention kernels' launches (a tuple, as the gates compare
    it), with the product kernel's, the RMSNorm kernel's and the
    SelectedRows merge kernel's beside them in ``.gemm``, ``.rms_norm``
    and ``.merge``."""
    gemm = 0
    rms_norm = 0
    merge = 0


def reset_counts(fa):
    from paddle_tpu_torch.ops.cuda import gemm, rms_norm, selected_rows

    for w in kernel_wrappers(fa) + (gemm.matmul, rms_norm.rms_norm_rows,
                                    selected_rows.merge_rows):
        w.launches = 0
    for w in tma_wrappers(fa):
        w.realigned = 0
    for p in plain_versions(fa):
        p.calls = 0


def read_counts(fa):
    """(launches of the six kernels, with the product kernel's in
    ``.gemm``, the RMSNorm kernel's in ``.rms_norm`` and the merge
    kernel's in ``.merge``; plain-version calls; operands realigned for
    TMA): a path must leave the last two at 0."""
    from paddle_tpu_torch.ops.cuda import gemm, rms_norm, selected_rows

    counts = Launches(w.launches for w in kernel_wrappers(fa))
    counts.gemm = gemm.matmul.launches
    counts.rms_norm = rms_norm.rms_norm_rows.launches
    counts.merge = selected_rows.merge_rows.launches
    return (counts, sum(p.calls for p in plain_versions(fa)),
            sum(w.realigned for w in tma_wrappers(fa)))


def count_delta(before, after):
    """What happened between two read_counts: (launches of the six
    kernels, plain-version calls, realigned operands)."""
    return (tuple(a - b for a, b in zip(after[0], before[0])),
            after[1] - before[1], after[2] - before[2])


def pinned_host_allocs():
    """Pinned host allocations made so far (PyTorch's caching host
    allocator), or None where this PyTorch does not report them."""
    import torch

    stats = getattr(torch.cuda, "host_memory_stats", None)
    if stats is None:
        return None
    return stats().get("num_host_alloc")


def kept_vs_dropped(pred, feed, n=20):
    """Batch-4 requests whose caller keeps every response against ones
    whose caller drops it, in turns of n (dropped, kept, kept, dropped):
    the median ms of each kind and ("turns") of each turn, so that two
    turns of one kind show the run-to-run noise; the pinned host
    allocations the kept ones made; whether every kept response still
    equals its first fetch."""
    first = pred.run(feed)
    times = {"kept": [], "dropped": []}
    turns = []
    kept = []
    allocs = None
    for turn in ("dropped", "kept", "kept", "dropped"):
        before = pinned_host_allocs()
        ms = []
        for _ in range(n):
            t = time.perf_counter()
            out = pred.run(feed)
            ms.append((time.perf_counter() - t) * 1e3)
            if turn == "kept":
                kept.append(out)
        after = pinned_host_allocs()
        if turn == "kept" and before is not None:
            allocs = (allocs or 0) + after - before
        times[turn] += ms
        turns.append(float(np.median(ms)))
    equal = all(np.array_equal(o[0], first[0]) for o in kept)
    return (dict({k: float(np.median(v)) for k, v in times.items()},
                 turns=turns), allocs, equal)


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
    n_mul = sum(op.type == "mul" for op in main.global_block().ops)
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

    t0 = time.perf_counter()
    warmed = pred.warmup([{n: a.shape for n, a in bert_feed(b, 0).items()}
                          for b in (1, 4, 8)])
    info = pred.cache_info()
    pools = [m for m in info["manifests"].values()]
    log(f"  warmup built and captured {warmed} signatures in "
        f"{time.perf_counter() - t0:.2f} s; graph pools "
        f"{', '.join(f'{m / 2 ** 20:.1f}' for m in pools if m is not None)} "
        f"MiB")
    if warmed != 3 or info["compiled"] != 3 or None in pools:
        raise AssertionError(f"warmup did not capture batch 1, 4 and 8: "
                             f"{warmed} warmed, cache_info {info}")

    requests = [(b, s) for b in (1, 4, 8) for s in range(3)]
    reset_counts(fa)
    results, lat = {}, {}
    for b, s in requests:
        before = read_counts(fa)[0]
        feed = bert_feed(b, seed=10 * b + s)
        t = time.perf_counter()
        out = pred.run(feed)  # numpy fetches: ends in a device sync
        lat.setdefault(b, []).append((time.perf_counter() - t) * 1e3)
        after = read_counts(fa)[0]
        launched = after[0] - before[0]
        if launched != n_attn or after.gemm - before.gemm != n_mul:
            raise AssertionError(f"batch {b}: {launched} attention and "
                                 f"{after.gemm - before.gemm} product "
                                 f"kernel launches, expected {n_attn} and "
                                 f"{n_mul}")
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
            f"card {', '.join(f'{x:.3f}' for x in ms)} ms (replays of the "
            f"captured signature, numpy fetches included)")
    log(f"  serving: {len(requests)} requests, {launches} kernel launches "
        f"({n_attn} per request), {counts.gemm} of the product kernel (every "
        f"one of the {n_mul} mul ops a request), plain versions called "
        f"{plain_calls} times, operands realigned {realigned}")
    medians, allocs, equal = kept_vs_dropped(pred, bert_feed(4, seed=42))
    FETCH.update(medians, pinned_allocs_kept=allocs, kept_equal=equal)
    log(f"  batch-4 requests, caller keeps every response: "
        f"{medians['kept']:.3f} ms (median of 40), drops it: "
        f"{medians['dropped']:.3f} ms (turns dropped, kept, kept, dropped: "
        f"{', '.join(f'{x:.3f}' for x in medians['turns'])}); pinned host "
        f"allocations while "
        f"keeping: {'not measured' if allocs is None else allocs}; kept "
        f"responses unchanged: {equal}")
    if not equal or allocs:
        raise AssertionError(f"kept fetches: unchanged {equal}, pinned "
                             f"allocations {allocs}")

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
    profile_request(pred, fa, bert_feed(4, seed=41))
    pred.close()
    del pred
    torch.cuda.empty_cache()
    return counts


# phase 4's kept / dropped batch-4 requests, for the summary line
FETCH = {}


def profile_request(pred, fa, feed):
    """Where one batch-4 request's time goes: torch.profiler's device
    time by kernel against the request's wall time (a replay of the
    captured signature, after the counted runs, so these launches are not
    in the main path's counts), and the profiler's kernel launches held
    against the replay-aware counts."""
    pred.run(feed)
    profiled_launches(lambda: pred.run(feed), fa, "one batch-4 request",
                      "serving_b4")


# profiles of one replay taken at most, while the profiler's launches
# differ from the counters'; the pause before each profiled call
PROFILE_TRIES = 3
PROFILE_SETTLE_S = 0.05


def profiled_launches(call, fa, what, key, strict=True):
    """One profiled call of `call` (a replay): report_profile's numbers,
    and the profiler's launches held to the replay-aware counts
    (check_profiled_launches).  torch.profiler now and then loses kernel
    records; so while the two disagree the replay is profiled again, up
    to PROFILE_TRIES in all, each reading logged, and gated_profile
    decides which profile the gate holds.  Each profile waits for the
    device and a moment before the call.  Not `strict` (phase 15, late
    in the run, where profiles lose records), lenient_profile decides
    instead."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    readings, runs = [], []
    for attempt in range(1, PROFILE_TRIES + 1):
        before = read_counts(fa)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            time.sleep(PROFILE_SETTLE_S)
            t = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t) * 1e6
        kernels, _ = report_profile(prof, wall_us, what, key=key)
        after = read_counts(fa)
        total = sum(e.count for e in kernels)
        seen, want = launch_deltas(kernels, before, after)
        log(f"  {what}, profile {attempt}: {total} kernel records; the "
            f"profiler saw {seen} launches of the forward, dK/dV and dQ "
            f"kernels, the counters added {want}")
        readings.append((total, seen, want))
        runs.append((kernels, before, after, dict(PROFILES[key])))
        if seen == want:
            break
    if strict:
        i, measured = gated_profile(readings, what), True
    else:
        i, measured = lenient_profile(readings, what)
    if i is None:
        PROFILES[key] = dict(PROFILES[key], busy_ms=None, idle=None,
                             lost_records=readings)
        log(f"  {what}: every profile lost launch records; its device "
            f"busy and idle share: not measured")
        return
    kernels, before, after, PROFILES[key] = runs[i]
    check_profiled_launches(kernels, before, after, what)
    if not measured:
        PROFILES[key] = dict(PROFILES[key], busy_ms=None, idle=None,
                             lost_records=readings)
        log(f"  {what}: the profile that holds every launch is not the "
            f"fullest, so records were lost from it too; its device busy "
            f"and idle share: not measured")


def lenient_profile(readings, what):
    """(which profile the launch gate holds, whether its device numbers
    stand) for phase 15's replays, whose profiles late in a long run
    lose kernel records: a profile never holds a launch that did not
    happen, so one whose launches equal the counters' proves them.  The
    gate holds the last such profile; its device numbers stand only
    where it has the most kernel records (else it lost records too: once
    15b's recompute replay gave two profiles of 1764 records without a
    forward launch, and one of 1627 with all of them).  Where every
    profile falls short of the counters, (None, False): records lost,
    nothing proved (every profile of 15b's plain replay once lost the
    same forward launch).  A profile that saw more launches of a kernel
    than the counters added fails: the counters missed a launch."""
    over = [r for r in readings if any(s > w for s, w in zip(r[1], r[2]))]
    if over:
        raise AssertionError(
            f"{what}: a profile saw more launches than the counters added "
            f"(records, profiler, counters): {over}")
    agree = [i for i, (_, seen, want) in enumerate(readings) if seen == want]
    if not agree:
        return None, False
    top = max(total for total, _, _ in readings)
    return agree[-1], readings[agree[-1]][0] == top


def gated_profile(readings, what):
    """Which of one replay's profiles, readings (kernel records in all,
    the profiler's launches, the counters'), the launch gate holds: the
    one with the most kernel records.  The replay launches the same
    graph every time, so a profile with fewer records than another lost
    some, and its launches may fall short of the counters'; any profile
    with the most records whose launches differ fails here."""
    top = max(total for total, _, _ in readings)
    if any(total == top and seen != want
           for total, seen, want in readings):
        raise AssertionError(
            f"{what}: the profiler's launches differ from the counters' in "
            f"a profile that lost no records (the most kernel records, "
            f"{top}); every profile's (records, profiler, counters): "
            f"{readings}")
    return max(i for i, r in enumerate(readings) if r[0] == top)


# the kernels each pair of wrappers (packed, unpacked) launches, by the
# part of the name they share: forward, dK/dV, dQ
KERNEL_FAMILIES = ("fa_fwd_", "fa_dkv_", "fa_dq_")


def launch_deltas(kernels, before, after):
    """(the profiler's launches of each kernel family in `kernels`, the
    counters' deltas of each family, packed plus unpacked wrapper,
    between `before` and `after`)."""
    d = [a - b for a, b in zip(after[0], before[0])]
    return (tuple(sum(e.count for e in kernels if fam in e.key)
                  for fam in KERNEL_FAMILIES),
            tuple(d[i] + d[i + 3] for i in range(3)))


def check_profiled_launches(kernels, before, after, what):
    """A replay runs no wrapper, so the counts it adds are its capture's.
    Hold them against what the profiler saw launched in the replay: for
    each kernel family, the profiler's launches equal the counters'
    deltas (packed plus unpacked wrapper) between `before` and
    `after`."""
    seen, want = launch_deltas(kernels, before, after)
    log(f"  {what}: the profiler saw {seen} launches of the forward, "
        f"dK/dV and dQ kernels; the replay-aware counters added {want}")
    if seen != want:
        raise AssertionError(f"{what}: the profiler saw {seen} kernel "
                             f"launches, the counters added {want}")


HOST_KERNEL_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                        "cuLaunchKernel", "cuLaunchKernelEx")
# each profiled path's numbers, for the summary before the last lines
PROFILES = {}
# the same paths run eagerly, op by op, by the executor before the
# compiled step (one NVIDIA H100 80GB HBM3 at 700 W, PERF.md section 5):
# wall ms, device busy ms, idle share, host kernel launches
EAGER_PROFILES = {"serving_b4": ("32.8", "10.63", "67.6%", "396"),
                  "bert_fp32": ("209.2", "104.5", "50.1%", "5666"),
                  "bert_flagship": ("142-308", "40.4", "91%", "~7550"),
                  "llama_flagship": ("108.7-112.9", "96.5", "22%", "~1650")}


def report_profile(prof, wall_us, what, key=None):
    """Logs device busy and idle share of `wall_us`, the host's launches
    (kernels: cudaLaunchKernel and its variants; CUDA graphs:
    cudaGraphLaunch), the top kernels and host ops; returns the device
    kernels' key_averages rows and their busy us (0 where the profiler
    saw no kernel).  With `key`, PROFILES[key] keeps the numbers."""
    import torch

    rows = prof.key_averages()
    kernels = [e for e in rows
               if e.device_type == torch.autograd.DeviceType.CUDA]
    host = [e for e in rows
            if e.device_type == torch.autograd.DeviceType.CPU]
    kernel_launches = sum(e.count for e in host
                          if e.key in HOST_KERNEL_LAUNCHES)
    graph_launches = sum(e.count for e in host
                         if e.key == "cudaGraphLaunch")
    busy_us = sum(e.self_device_time_total for e in kernels)
    if key is not None:
        PROFILES[key] = dict(
            wall_ms=wall_us / 1e3, busy_ms=busy_us / 1e3,
            idle=1 - busy_us / wall_us if busy_us > 0 else None,
            kernel_launches=kernel_launches, graph_launches=graph_launches,
            device_launches=sum(e.count for e in kernels),
            attention_types=attention_types(kernels),
            attention_kernels=attention_kernels(kernels))
    if busy_us <= 0:
        log(f"  profile: {what} {wall_us:.0f} us wall; device time not "
            f"measured (the profiler saw no kernels)")
        return kernels, 0.0
    log(f"  profile of {what}: {wall_us:.0f} us wall, "
        f"{busy_us:.0f} us device busy ({len(kernels)} kernel names, "
        f"{sum(e.count for e in kernels)} kernels ran), device idle "
        f"{100 * (1 - busy_us / wall_us):.1f}% of the wall time; host "
        f"launches: {kernel_launches} cudaLaunchKernel, {graph_launches} "
        f"cudaGraphLaunch")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"    {e.self_device_time_total:9.1f} us "
            f"{100 * e.self_device_time_total / busy_us:5.1f}%  "
            f"x{e.count:<5d} {e.key[:90]}")
    log(f"  host ops by self CPU time ({sum(e.count for e in host)} calls, "
        f"{sum(e.self_cpu_time_total for e in host):.0f} us):")
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:8]:
        log(f"    {e.self_cpu_time_total:9.1f} us x{e.count:<6d} "
            f"{e.key[:60]}")
    return kernels, busy_us


def attention_types(kernels):
    """The element types of the attention kernels among profiled kernel
    rows, from their demangled names: "__half" or "__nv_bfloat16" for a
    tensor-core kernel, "float" for a CUDA-core one."""
    types = set()
    for e in kernels:
        if any(f in e.key for f in KERNEL_FAMILIES):
            types.add(next((t for t in ("__half", "__nv_bfloat16")
                            if t in e.key), "float"))
    return sorted(types)


def attention_kernels(kernels):
    """The attention kernels among profiled kernel rows, each as its
    name and template arguments ('fa_fwd_tc_kernel<__nv_bfloat16, 32>')
    from the demangled names."""
    found = set()
    for e in kernels:
        m = re.search(r"(fa_\w+?_kernel)<([^>]*)>", e.key)
        if m and any(f in m.group(1) for f in KERNEL_FAMILIES):
            found.add(f"{m.group(1)}<{m.group(2)}>")
    return sorted(found)


def build_train(tpt, cfg, lr_args, amp, dropout, recompute=False,
                amp_args=None):
    """bench.py's training step: build_bert_pretrain, linear LR warmup,
    Adam with global-norm clip 1.0, optionally AMP with the bench's white
    list (decorate's keywords `amp_args`, bf16 by default); minimize.
    With `recompute`, the Adam is wrapped in a RecomputeOptimizer
    checkpointed at each encoder layer's output (bert_checkpoints)."""
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
        if recompute:
            opt = optimizer.RecomputeOptimizer(opt)
            opt._set_checkpoints(bert_checkpoints(main))
        if amp:
            opt = mixed_precision.decorate(
                opt, amp_lists=mixed_precision.AutoMixedPrecisionLists(
                    custom_white_list=EXTRA_WHITE),
                **(amp_args or dict(dtype="bfloat16")))
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


def build_llama(tpt, cfg, lr, amp, amp_args=None):
    """The Llama training step: build_llama_train, AdamW(lr,
    weight_decay=0.01) as __graft_entry__.py builds it, optionally AMP
    with the default lists (mul and flash_attention in bf16, or as
    decorate's keywords `amp_args` say); minimize."""
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
            opt = mixed_precision.decorate(
                opt, **(amp_args or dict(dtype="bfloat16")))
        opt.minimize(outs["loss"])
    return main, startup, outs["loss"].name


def llama_batch(cfg, seed):
    """Random token ids and next-token labels from a numpy seed."""
    rng = np.random.RandomState(seed)
    B, S, V = cfg["batch_size"], cfg["seq_len"], cfg["vocab_size"]
    return {"input_ids": rng.randint(0, V, (B, S)).astype("int64"),
            "labels": rng.randint(0, V, (B, S)).astype("int64")}


def per_step_launches(main):
    """Launches of the six kernels one training step makes: the forward
    once an attention op (a recompute program's re-emitted copies
    included: a grad op differentiates the graph its forward kept), dK/dV
    and dQ once a grad op; the einsum formulation (impl "xla") none."""
    ops = [op for op in main.global_block().ops
           if op.attr("impl", "auto") != "xla"]  # the einsum: no kernel
    n = {t: sum(op.type == t for op in ops) for t in (
        "flash_attention_qkv", "flash_attention_qkv_grad", "flash_attention",
        "flash_attention_grad")}
    return (n["flash_attention_qkv"], n["flash_attention_qkv_grad"],
            n["flash_attention_qkv_grad"], n["flash_attention"],
            n["flash_attention_grad"], n["flash_attention_grad"])


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
        # a copy even where the card path runs on the CPU: both scopes
        # are updated in place
        cpu_scope.set_var(n, scope.find_var(n).to("cpu", copy=True))
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
    card.close()
    del scope, cpu_scope
    torch.cuda.empty_cache()
    return tuple(launches)


def captured_vs_eager(tpt, main, startup, loss, batches, lrs):
    """The same steps through the compiled step (eager, then capture and
    replay, then replay) and through FLAGS_check_nan_inf's eager debug
    run, from one startup scope copied, at the same run counts (fp32 at
    dropout 0 in phase 5; bf16 at dropout 0.1 in phase 17d).  Both
    run the same kernels on the same shapes, so the losses and every
    parameter are expected bit-equal; otherwise the largest differences
    are logged and held to the parity limits (loss rel LOSS_RTOL,
    parameters 2 * (sum of the LRs) and PARITY_PARAM_ATOL on 99.9%)."""
    import torch

    exe, dbg = tpt.Executor(), tpt.Executor()
    scope, dscope = tpt.Scope(), tpt.Scope()
    exe.run(startup, scope=scope)
    # the debug executor runs the startup too (into a scope thrown away):
    # each run's dropout masks are keyed by the executor's run count
    dbg.run(startup, scope=tpt.Scope())
    for n in scope.local_var_names():
        dscope.set_var(n, scope.find_var(n).clone())
    got, want = [], []
    for feed in batches:
        got.append(exe.run(main, feed=feed, fetch_list=[loss],
                           scope=scope)[0])
        tpt.set_flags({"FLAGS_check_nan_inf": True})
        try:
            want.append(dbg.run(main, feed=feed, fetch_list=[loss],
                                scope=dscope)[0])
        finally:
            tpt.set_flags({"FLAGS_check_nan_inf": False})
    if not exe.cache_info()["entries"][-1]["aot"]:
        raise AssertionError("the captured path never captured its step")
    loss_rel = max(float(np.abs(g - w).max() / np.abs(w).max())
                   for g, w in zip(got, want))
    worst, close, total, unequal = 0.0, 0, 0, 0
    for p in main.all_parameters():
        d = (scope.find_var(p.name) - dscope.find_var(p.name)).abs()
        worst = max(worst, d.max().item())
        close += int((d <= PARITY_PARAM_ATOL).sum())
        total += d.numel()
        unequal += int((d != 0).sum())
    exact = loss_rel == 0 and unequal == 0
    log(f"  captured vs eager debug run, {len(batches)} steps: losses "
        f"{', '.join(f'{float(np.ravel(g)[0]):.7f}' for g in got)} vs "
        f"{', '.join(f'{float(np.ravel(w)[0]):.7f}' for w in want)}, "
        f"largest loss rel diff {loss_rel:.3e}; parameters: "
        f"{unequal} of {total} elements differ, max|diff| {worst:.3e} "
        f"({'bit-equal' if exact else 'NOT bit-equal'})")
    if not (loss_rel <= LOSS_RTOL and worst <= 2 * sum(lrs)
            and close >= 0.999 * total):
        raise AssertionError("the captured step and the eager debug run "
                             "disagree beyond the parity limits")
    exe.close()
    dbg.close()
    del scope, dscope
    torch.cuda.empty_cache()
    return exact


def guard_on_nan(tpt, main, startup, loss, batches):
    """The non-finite guard on the card: two finite steps (eager, then
    capture and replay), then a replayed step whose mlm_weights are NaN
    (so is its loss).  Every persistable must stay bit-unchanged and the
    callback must fire with that step's id; a finite step after it must
    train on."""
    import torch

    exe, scope, seen = tpt.Executor(), tpt.Scope(), []
    exe.run(startup, scope=scope)
    exe.set_nonfinite_guard(loss, seen.append, program=main)
    for feed in batches[:2]:
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    persist = [v.name for v in main.list_vars() if v.persistable]
    before = {n: scope.find_var(n).clone() for n in persist}
    bad = dict(batches[2])
    bad["mlm_weights"] = np.full_like(bad["mlm_weights"], np.nan)
    out = exe.run(main, feed=bad, fetch_list=[loss], scope=scope)
    changed = [n for n in persist
               if not torch.equal(scope.find_var(n), before[n])]
    log(f"  guarded step {exe._step} on a NaN feed (a replay: "
        f"{exe.cache_info()['entries'][-1]['aot']}): loss "
        f"{float(np.ravel(out[0])[0])}, {len(changed)} of {len(persist)} "
        f"persistables changed, callback saw {seen}")
    if np.isfinite(out[0]).all() or changed or seen != [exe._step] or \
            not exe.cache_info()["entries"][-1]["aot"]:
        raise AssertionError(f"the guard let a NaN step through: changed "
                             f"{changed[:5]}, callback {seen}")
    out = exe.run(main, feed=batches[0], fetch_list=[loss], scope=scope)
    moved = sum(not torch.equal(scope.find_var(n), before[n])
                for n in persist)
    if not np.isfinite(out[0]).all() or moved == 0:
        raise AssertionError("training did not go on after the guard")
    exe.close()
    del scope, before
    torch.cuda.empty_cache()


def dropout_replay(tpt):
    """Dropout at rate 0.5 under replay: a [1024, 1024] dropout + sum step
    with x@GRAD fetched runs eagerly, then is captured and replayed three
    times.  Each run keeps 1 - round(0.5 * 256) / 256 of the elements
    within 5 sigma, scales them by 2, and its grad is exactly 2 where the
    mask kept (the grad reads the forward's mask); the replays draw
    different masks."""
    from paddle_tpu_torch.framework.backward import append_backward
    from paddle_tpu_torch.ops import registry

    op_seed = registry._OP_SEED[0]  # see bert_fp32_profile
    main = tpt.Program()
    block = main.global_block()
    block.create_var(name="x", shape=[1024, 1024], dtype="float32",
                     is_data=True, stop_gradient=False)
    with tpt.program_guard(main, tpt.Program()):
        block.append_op("dropout", inputs={"X": ["x"]},
                        outputs={"Out": ["o"]},
                        attrs={"dropout_prob": 0.5, "is_test": False,
                               "seed": 0,
                               "dropout_implementation": "upscale_in_train"})
        block.append_op("reduce_sum", inputs={"X": ["o"]},
                        outputs={"Out": ["loss"]},
                        attrs={"dim": [0], "reduce_all": True,
                               "keep_dim": False})
        append_backward(block.var("loss"))
    registry.reset_op_seed(op_seed)
    exe = tpt.Executor()
    x = np.ones((1024, 1024), "float32")
    keep_rate = 1.0 - round(256 * 0.5) / 256.0
    tol = 5 * np.sqrt(keep_rate * (1 - keep_rate) / x.size)
    masks = []
    for run in range(4):
        o, g = exe.run(main, feed={"x": x}, fetch_list=["o", "x@GRAD"],
                       scope=tpt.Scope())
        kept = o != 0
        rate = float(kept.mean())
        if abs(rate - keep_rate) > tol or not np.all(o[kept] == 2.0) or \
                not np.array_equal(g, np.where(kept, 2.0, 0.0)):
            raise AssertionError(f"dropout run {run + 1}: keep rate {rate} "
                                 f"(want {keep_rate} +- {tol:.2g}) or its "
                                 f"grad does not follow its mask")
        masks.append(kept)
    same = [int(np.array_equal(a, b)) for a, b in zip(masks, masks[1:])]
    log(f"  dropout 0.5 on [1024, 1024]: keep rates "
        f"{', '.join(f'{float(m.mean()):.5f}' for m in masks)} (want "
        f"{keep_rate} +- {tol:.2g}); consecutive masks equal: {same}; "
        f"captured: {exe.cache_info()['entries'][-1]['aot']}")
    if any(same) or not exe.cache_info()["entries"][-1]["aot"]:
        raise AssertionError("replays of the dropout step repeated a mask")
    exe.close()


def train_flagship(tpt, fa, what, main, startup, loss, batches, steps,
                   tokens, key):
    """`steps` steps on the card (cycling over `batches`): each step's
    host time, ending in the loss fetch, and tokens/s (step 1 runs
    eagerly, step 2 captures the step as a CUDA graph and replays it, the
    rest replay); a finite loss; exactly the expected kernel launches
    every step and no plain call; peak device memory.  Then a window of
    ASYNC_STEPS steps through run_async with one fence at its end (no
    host sync inside it), as bench.py times its window: ms/step and
    tokens/s.  Then one profiled step.  Returns the launches of the six
    kernels over the counted steps, and the losses."""
    import torch
    from paddle_tpu_torch import monitor

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
        got = count_delta(before, after)
        if got != (want, 0, 0):
            raise AssertionError(f"{what} step {step + 1}: (launches, plain "
                                 f"calls, realigned operands) {got}, want "
                                 f"{want}, 0, 0")
        if not np.isfinite(out[0]).all():
            raise AssertionError(f"{what} step {step + 1}: loss {out[0]}")
    counts, plain, realigned = read_counts(fa)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    info = exe.cache_info()["entries"][-1]
    log(f"  {steps} steps: losses {', '.join(f'{x:.5f}' for x in losses)}")
    log(f"  step time on the card (host clock, ends in the loss fetch): "
        f"{', '.join(f'{x:.1f}' for x in times)} ms (step 1 eager, step 2 "
        f"captures and replays); tokens/s "
        f"{', '.join(f'{tokens * 1e3 / x:.0f}' for x in times)}; peak "
        f"device memory {peak:.2f} GiB (graph pool "
        f"{(info['manifest'] or 0) / 2 ** 30:.2f} GiB, captured: "
        f"{info['aot']})")
    log(f"  launches of the six kernels {counts} ({want} per step); plain "
        f"versions called {plain} times; operands realigned {realigned}")
    if not info["aot"]:
        raise AssertionError(f"{what}: the step was never captured")

    before = read_counts(fa)
    syncs = monitor.stat_get("host_syncs")
    torch.cuda.synchronize()
    t = time.perf_counter()
    for step in range(ASYNC_STEPS):
        res = exe.run_async(main, feed=batches[step % len(batches)],
                            fetch_list=[loss], scope=scope)
    inside = monitor.stat_get("host_syncs") - syncs
    last = res.sync()
    ms = (time.perf_counter() - t) * 1e3 / ASYNC_STEPS
    after = read_counts(fa)
    got = count_delta(before, after)
    PROFILES[key + "_async"] = dict(ms_per_step=ms,
                                    tokens_per_s=tokens * 1e3 / ms)
    log(f"  {ASYNC_STEPS} steps through run_async, one fence at the end: "
        f"{ms:.3f} ms/step, {tokens * 1e3 / ms:.0f} tokens/s; host syncs "
        f"inside the window {inside}; last loss "
        f"{float(np.ravel(last[0])[0]):.5f}; launches {got[0]}")
    if inside or got != (tuple(ASYNC_STEPS * w for w in want), 0, 0) or \
            not np.isfinite(last[0]).all():
        raise AssertionError(f"{what}: the run_async window synced {inside} "
                             f"times or launched {got}")
    profile_step(exe, fa, main, scope, batches[0], loss, key)
    if key == "llama_flagship":
        second_signature(exe, main, scope, batches[0], loss)
    exe.close()
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
    launches = train_parity(tpt, fa, "BERT-base", main, startup, loss,
                            batches, grads, PARITY_LRS)
    PROFILES["captured_vs_eager"] = dict(bit_equal=captured_vs_eager(
        tpt, main, startup, loss, batches, PARITY_LRS))
    guard_on_nan(tpt, main, startup, loss, batches)
    dropout_replay(tpt)
    return launches


def bert_fp32_profile(tpt, fa):
    """One fp32 training step at bench.py's seq-512 shape (BERT-base,
    batch 8, max_predictions 77; no AMP, dropout 0, the parity phase's
    Adam, clip and warmup), a replay of its CUDA graph under
    torch.profiler after two warm steps (eager, capture); not counted in
    any path's launches.  Logs wall, device busy and idle share, host
    launches, the fp32 backward kernels' device time and share of the
    busy time, and holds the step to 12 / 12 / 12 launches, no plain call
    and no realigned operand."""
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
    for _ in range(2):  # warm: the eager first run, then the capture
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    torch.cuda.synchronize()
    reset_counts(fa)
    before = read_counts(fa)
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
        f"{FLAGSHIP['batch_size']}), a replay", key="bert_fp32")
    if busy_us <= 0:
        raise AssertionError("the profiler saw no device time in the fp32 "
                             "step")
    check_profiled_launches(kernels, before, got, "the fp32 step")
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
    exe.close()
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
        FLAGSHIP["batch_size"] * FLAGSHIP["seq_len"], "bert_flagship")


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
        LLAMA_FLAGSHIP["batch_size"] * LLAMA_FLAGSHIP["seq_len"],
        "llama_flagship")


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
    """'fa_dkv_tc_kernel<bf16, 128>' or 'fa_dkv_tc_kernel<f16, 128>' for
    a tensor-core kernel's mangled name (templated on the 16-bit type,
    __nv_bfloat16 or __half, and D), 'fa_fwd_f32_kernel<64, 2>' for the
    fp32 forward (templated on D and its warps a block), None for
    anything else."""
    m = re.search(r"(fa_\w*?kernel)I(\w*?)Li(\d+)E((?:Li\d+E)*)", mangled)
    if m is None:
        return None
    name, dtype, D, more = m.groups()
    if more and not dtype:
        params = [D] + re.findall(r"Li(\d+)E", more)
        return f"{name}<{', '.join(params)}>"
    return f"{name}<{'f16' if dtype.endswith('__half') else 'bf16'}, {D}>"


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
    HGMMA (wgmma) and UTMALDG (TMA loads) in its own SASS, in bf16 and
    fp16 at D 64 and 128; neither it nor any
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
    BUILD_REPORT.update(sass=counts, ptxas=report)
    for label, (hgmma, utmaldg) in sorted(counts.items()):
        log(f"  SASS {label}: {hgmma} HGMMA, {utmaldg} UTMALDG")
    for label in TC_LABELS:
        hgmma, utmaldg = counts.get(label, (0, 0))
        if hgmma == 0 or utmaldg == 0:
            raise AssertionError(f"{hgmma} wgmma (HGMMA) and {utmaldg} TMA "
                                 f"loads (UTMALDG) in {label}'s SASS: it "
                                 f"does not run on the tensor cores with "
                                 f"TMA loads")
    for label in CHECKED_KERNELS:
        spills = [int(x) for line in report.get(label, ())
                  for x in re.findall(r"(\d+) bytes spill", line)]
        if not spills or any(spills):
            raise AssertionError(f"{label} spills registers (or ptxas "
                                 f"printed no spill line): "
                                 f"{report.get(label)}")


# phase 2's SASS counts and ptxas lines by kernel label, for phase 17a
BUILD_REPORT = {}


# the product kernel (csrc/gemm_f32.cu): the decode and prefill shapes K x
# N of Llama-2-7B's products (qkv, attn_out, gate_up, ffn_out, head) and
# BERT-base's qkv, each row held bit-equal across these M
GEMM_SHAPES = ((4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096),
               (4096, 32000), (768, 2304))
GEMM_MS = (1, 2, 3, 4, 7, 16, 17, 64, 128, 500, 1024)
# decode attention's batched products (4 slots x 32 heads over 1024 keys,
# D 128): Q K^T with K^T read from the cache [.., keys, D], and P V
GEMM_ATTN = (("qk", 128, 128, 1024), ("pv", 128, 1024, 128))
# timed at the decode step's M (4 slots) and a prefill bucket's (512);
# decode attention's products at the decode step's M, one query row a
# (slot, head)
GEMM_TIME_MS = (4, 512)
GEMM_ATTN_M = 1


def gemm_label(mangled):
    """'gemm_skinny_kernel<4, 4, 1, 1>' for a product, RMSNorm or merge
    kernel's mangled name (its template arguments in order), None for anything
    else."""
    m = re.search(r"((?:gemm_(?:skinny|tiled|fold)|rms_norm_rows(?:_loop)?|"
                  r"merge_rows)_kernel)(I\w*?E)?E", mangled)
    if m is None:
        return None
    params = re.findall(r"L[ib](\d+)E", m.group(2) or "")
    return f"{m.group(1)}<{', '.join(params)}>" if params else m.group(1)


def gemm_bound(M, N, K, batch=1):
    """(bound ms, 'bytes' or 'operations') of `batch` M x K @ K x N fp32
    products: each operand read once and the output written once at the
    HBM peak, against 2 M N K a product at the fp32 peak."""
    t_bytes = 4.0 * batch * (M * K + K * N + M * N) / PEAK_BYTES_PER_S * 1e3
    t_ops = 2.0 * batch * M * N * K / PEAK_FLOP_PER_S["float32"] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_own_kernel_spills(build):
    """ptxas's report of the product, RMSNorm and SelectedRows merge
    sources: every function of each is in it, and none spills."""
    lines = []
    for text in build.build_logs.values():
        label = None
        for line in text.splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?(\w+)", line)
            if m:
                label = gemm_label(m.group(1))
            elif label and "spill" in line:
                lines.append((label, line.strip()))
    labels = sorted({label for label, _ in lines})
    log(f"  product, RMSNorm and merge kernel functions: {len(labels)} "
        f"({', '.join(labels)})")
    for prefix in ("gemm_tiled", "gemm_skinny", "gemm_fold", "rms_norm_rows",
                   "merge_rows"):
        if not any(label.startswith(prefix) for label in labels):
            raise AssertionError(f"no ptxas report of {prefix}*: {labels}")
    for label, line in lines:
        if re.search(r"[1-9]\d* bytes spill", line):
            raise AssertionError(f"{label} spills registers: {line}")


def seeded(shape, seed, device):
    """A standard normal float32 tensor on `device` from its own seed, the
    same in every checkout and run."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(*shape, device=device, generator=g)


def sha256(t):
    """sha256 of a tensor's bytes, whatever its dtype (bf16 too)."""
    import hashlib

    import torch

    t = t.detach().contiguous().cpu().reshape(-1)
    return hashlib.sha256(t.view(torch.uint8).numpy().tobytes()).hexdigest()


def gemm_cases(device):
    """(name, x, w) of every timed product from fixed seeds: each
    GEMM_SHAPES K x N at each GEMM_TIME_MS, and decode attention's
    GEMM_ATTN at GEMM_ATTN_M rows (Q K^T's w a transposed view of a
    [batch, keys, D] cache)."""
    seed = 100
    for K, N in GEMM_SHAPES:
        w = seeded((K, N), seed, device)
        for M in GEMM_TIME_MS:
            yield f"M{M}_K{K}_N{N}", seeded((M, K), seed + M, device), w
        seed += 1000
    for what, batch, K, N in GEMM_ATTN:
        x = seeded((batch, GEMM_ATTN_M, K), seed, device)
        if what == "qk":
            w = seeded((batch, N, K), seed + 1, device).transpose(1, 2)
        else:
            w = seeded((batch, K, N), seed + 1, device)
        yield f"attn_{what}_B{batch}_M{GEMM_ATTN_M}_K{K}_N{N}", x, w
        seed += 1000


def time_gemm(gemm, device):
    """The product kernel's event and device time at every gemm_cases
    product beside torch.matmul's (the library call, TF32 off), the plain
    version's and the bound; its max |d| to the plain version and the
    sha256 of its output (the same in every checkout whose kernel keeps
    the arithmetic).  Returns {case: row}."""
    import torch

    rows = {}
    for name, x, w in gemm_cases(device):
        batch = x.shape[0] if x.dim() == 3 else 1
        M, K, N = x.shape[-2], x.shape[-1], w.shape[-1]
        iters = 20 if M <= 16 else 5
        ms, dev = timed(lambda: gemm.matmul(x, w), iters)
        lib_ms, lib_dev = timed(lambda: torch.matmul(x, w), iters)
        plain_ms = cuda_ms(lambda: gemm.matmul_reference(x, w), 3, warmup=1)
        bound, by = gemm_bound(M, N, K, batch)
        got = gemm.matmul(x, w)
        err = float((got - gemm.matmul_reference(x, w)).abs().max())
        rows[name] = dict(
            ms=ms, device_ms=dev, plain_ms=plain_ms, library_ms=lib_ms,
            library_device_ms=lib_dev, bound_ms=bound, bound_by=by,
            max_abs_err=err, sha256=sha256(got))
        log(f"  gemm {name}: kernel {ms:.4f} ms events / {dev:.4f} ms "
            f"device, torch.matmul {lib_ms:.4f} / {lib_dev:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by}): "
            f"{100 * bound / dev:.1f}% of it; sha256 {rows[name]['sha256']}")
        del x, w, got
    torch.cuda.empty_cache()
    return rows


def check_gemm(gemm, build, device):
    """The product kernel: no spill in ptxas's report for any function of
    it or of the RMSNorm source; at each GEMM_SHAPES K x N, every row of
    an M-row product (GEMM_MS) bit-equal to the same row of the 1024-row
    product and of a row-permuted one; the same for decode attention's
    batched products (GEMM_ATTN, M 1-16 against 1024 rows, and Q K^T
    through a misaligned view of the cache as through an aligned one);
    each product at M 4 and 512 within gemm.tolerance of the plain
    version's (chunk partials by torch.matmul, folded in the same order),
    and two controls over it at each shape (torch.matmul with TF32
    allowed; the exact product of operands rounded to bf16), so the limit
    is shown to catch reduced precision.  Then time_gemm.  Returns its
    rows and the largest |got - plain| / tolerance of the kernel and the
    smallest of each control."""
    import torch

    check_own_kernel_spills(build)
    g = torch.Generator(device=device).manual_seed(3)
    # the largest |got - plain| / gemm.tolerance of the kernel and of each
    # control: the kernel's must stay <= 1, each control's must pass 1
    ratios = {"kernel": 0.0, "tf32": math.inf, "bf16": math.inf}

    def err_ratio(x, w, got):
        """(max |got - plain|, the largest |got - plain| / tolerance)."""
        d = (got - gemm.matmul_reference(x, w)).abs()
        return float(d.max()), float((d / gemm.tolerance(x, w)).max())

    def controls(x, w, what):
        """The two controls' ratios at x @ w; each must exceed 1."""
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = torch.matmul(x, w)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        bf16 = gemm.matmul_reference(x.bfloat16().float(),
                                     w.bfloat16().float())
        for name, got in (("tf32", tf32), ("bf16", bf16)):
            r = err_ratio(x, w, got)[1]
            ratios[name] = min(ratios[name], r)
            if not r > 1:
                raise AssertionError(f"gemm {what}: the {name} control is "
                                     f"within the tolerance ({r:.3g} of "
                                     f"it): the limit cannot catch {name}")

    worst = 0.0
    for K, N in GEMM_SHAPES:
        x = torch.randn(max(GEMM_MS), K, device=device, generator=g)
        w = torch.randn(K, N, device=device, generator=g)
        full = gemm.matmul(x, w)
        perm = torch.randperm(x.shape[0], device=device, generator=g)
        if not torch.equal(gemm.matmul(x[perm], w), full[perm]):
            raise AssertionError(f"gemm {K}x{N}: a row-permuted product's "
                                 f"rows differ")
        for M in GEMM_MS:
            if not torch.equal(gemm.matmul(x[:M], w), full[:M]):
                raise AssertionError(f"gemm {K}x{N}: rows of M={M} differ "
                                     f"from the same rows of M=1024")
        for M in (4, 512):
            err, ratio = err_ratio(x[:M], w, full[:M])
            worst = max(worst, err)
            ratios["kernel"] = max(ratios["kernel"], ratio)
            if ratio > 1:
                raise AssertionError(f"gemm {K}x{N} M={M}: max|err| {err} "
                                     f"is {ratio:.3g} of the tolerance")
            controls(x[:M], w, f"{K}x{N} M={M}")
        log(f"  gemm {K} x {N}: rows bit-equal across M {GEMM_MS} and a "
            f"permutation; within the tolerance of the plain version, "
            f"the TF32 and bf16 controls over it")
        del x, w, full
    for what, batch, K, N in GEMM_ATTN:
        x = torch.randn(batch, 1024, K, device=device, generator=g)
        if what == "qk":  # the cache [.., keys, D] read as K^T
            w = torch.randn(batch, N, K, device=device,
                            generator=g).transpose(1, 2)
        else:
            w = torch.randn(batch, K, N, device=device, generator=g)
        full = gemm.matmul(x, w)
        for M in (1, 2, 4, 16, 17, 128):
            if not torch.equal(gemm.matmul(x[:, :M], w), full[:, :M]):
                raise AssertionError(f"gemm attention {what}: rows of M={M} "
                                     f"differ from M=1024")
        if what == "qk":  # the same cache one float off 16-byte alignment
            off = torch.empty(batch * N * K + 1, device=device)[1:]
            wm = off.view(batch, N, K).copy_(w.transpose(1, 2))
            for M in (1, 4, 128):
                if not torch.equal(gemm.matmul(x[:, :M], wm.transpose(1, 2)),
                                   full[:, :M]):
                    raise AssertionError(f"gemm attention qk: rows of M={M} "
                                         f"through a misaligned cache differ")
            del off, wm
        err, ratio = err_ratio(x[:, :4], w, full[:, :4])
        ratios["kernel"] = max(ratios["kernel"], ratio)
        if ratio > 1:
            raise AssertionError(f"gemm attention {what}: max|err| {err} is "
                                 f"{ratio:.3g} of the tolerance")
        controls(x[:, :4], w, f"attention {what}")
        log(f"  gemm attention {what} [{batch}] x {K} x {N}: rows bit-equal "
            f"across M 1-1024; max|err| vs plain {err:.3e}")
        del x, w, full
    log(f"  gemm against its plain version: max|err| {worst:.3e}, at most "
        f"{ratios['kernel']:.4f} of gemm.tolerance; the controls at least "
        f"{ratios['tf32']:.2f} (TF32) and {ratios['bf16']:.2f} (bf16) of it")
    return time_gemm(gemm, device), ratios


# the RMSNorm kernel (csrc/rms_norm_f32.cu): Llama-2-7B's hidden width,
# rows held bit-equal across these row counts
NORM_WIDTH = 4096
NORM_ROWS = (1, 2, 3, 4, 16, 128, 500, 1024)
# its shapes on the main path, (rows, width): the decode step's 4 slots
# and a 512-token prefill's rows
NORM_SHAPES = ((4, 4096), (512, 4096))
# against the op's PyTorch formulation: each output within 2e-6 relative
# to the largest (a few float32 ulps of the mean of squares over 4096
# terms summed in another order, then one sqrt and one division)
NORM_RTOL = 2e-6


def time_rms_norm(rms_norm, device):
    """The RMSNorm kernel's event and device time at NORM_SHAPES (inputs
    from fixed seeds) beside the plain version's, its bound (x read and y
    written once at the HBM peak) and torch.nn.functional.rms_norm's (the
    library call); its max |d| to the plain version and the sha256 of its
    output.  Returns {shape: row}."""
    import torch

    eps = 1e-6
    scale = seeded((NORM_WIDTH,), 7, device).abs() + 0.5
    rows = {}
    for n_rows, n in NORM_SHAPES:
        xs = seeded((n_rows, n), 8 + n_rows, device) * 3
        ms, dev = timed(lambda: rms_norm.rms_norm_rows(xs, scale, eps), 20)
        plain_ms, plain_dev = timed(
            lambda: rms_norm.rms_norm_rows_reference(xs, scale, eps), 20)
        lib_ms, lib_dev = timed(lambda: torch.nn.functional.rms_norm(
            xs, (n,), weight=scale, eps=eps), 20)
        got = rms_norm.rms_norm_rows(xs, scale, eps)
        e = float((got - rms_norm.rms_norm_rows_reference(xs, scale, eps)
                   ).abs().max())
        bound = (8.0 * n_rows * n + 4.0 * n) / PEAK_BYTES_PER_S * 1e3
        rows[f"rows{n_rows}_n{n}"] = dict(
            ms=ms, device_ms=dev, plain_ms=plain_ms,
            plain_device_ms=plain_dev, library_ms=lib_ms,
            library_device_ms=lib_dev, bound_ms=bound, bound_by="bytes",
            max_abs_err=e, sha256=sha256(got))
        log(f"  RMSNorm [{n_rows}, {n}]: kernel {ms:.4f} ms events / "
            f"{dev:.4f} ms device, plain (PyTorch ops) {plain_ms:.4f} / "
            f"{plain_dev:.4f} ms, F.rms_norm {lib_ms:.4f} / {lib_dev:.4f} "
            f"ms, bound {bound:.5f} ms (bytes); max|err| {e:.3e}; sha256 "
            f"{rows[f'rows{n_rows}_n{n}']['sha256']}")
    return rows


def check_rms_norm(rms_norm, device):
    """The RMSNorm kernel: every row of an M-row norm (NORM_ROWS) bit-equal
    to the same row of the 1024-row one and of a row-permuted one; within
    NORM_RTOL of its plain version (the op's PyTorch formulation); then
    time_rms_norm.  Returns its rows."""
    import torch

    g = torch.Generator(device=device).manual_seed(9)
    x = torch.randn(max(NORM_ROWS), NORM_WIDTH, device=device,
                    generator=g) * 3
    scale = torch.rand(NORM_WIDTH, device=device, generator=g) + 0.5
    eps = 1e-6
    full = rms_norm.rms_norm_rows(x, scale, eps)
    perm = torch.randperm(x.shape[0], device=device, generator=g)
    if not torch.equal(rms_norm.rms_norm_rows(x[perm], scale, eps),
                       full[perm]):
        raise AssertionError("RMSNorm: a row-permuted norm's rows differ")
    for M in NORM_ROWS:
        if not torch.equal(rms_norm.rms_norm_rows(x[:M], scale, eps),
                           full[:M]):
            raise AssertionError(f"RMSNorm: rows of M={M} differ from the "
                                 f"same rows of M=1024")
    ref = rms_norm.rms_norm_rows_reference(x, scale, eps)
    err = float((full - ref).abs().max() / ref.abs().max())
    log(f"  RMSNorm kernel: rows bit-equal across M {NORM_ROWS} and a "
        f"permutation; max|err| vs plain {err:.3e} of the largest (limit "
        f"{NORM_RTOL:g})")
    if err > NORM_RTOL:
        raise AssertionError(f"RMSNorm kernel vs plain: {err}")
    return time_rms_norm(rms_norm, device)


def profile_step(exe, fa, main, scope, feed, loss, key):
    """Where one flagship step's time goes: torch.profiler's device time
    by kernel against the step's wall time (a replay, after the counted
    steps), and the profiler's kernel launches held against the
    replay-aware counts."""
    profiled_launches(lambda: exe.run(main, feed=feed, fetch_list=[loss],
                                      scope=scope),
                      fa, "one flagship training step", key)


def second_signature(exe, main, scope, feed, loss):
    """Device memory with two captured entries of one step: the same step
    with one more (one-element) fetch is a second key, so a second graph
    with its own pool.  Logs the memory the card holds (reserved) with
    one captured entry and with two, each entry's pool and the peak
    allocated; both entries then replay once more."""
    import torch

    block = main.global_block()
    read = {n for op in block.ops for n in op.input_arg_names()}
    extra = next(v.name for v in main.list_vars() if v.name in read
                 and v.persistable and int(np.prod(v.shape)) == 1)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    one = torch.cuda.memory_reserved()
    for _ in range(3):  # eager, capture and replay, replay
        out = exe.run(main, feed=feed, fetch_list=[loss, extra],
                      scope=scope)
    out0 = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    two = torch.cuda.memory_reserved()
    info = exe.cache_info()["entries"]
    captured = [e for e in info if e["aot"]]
    PROFILES["llama_two_signatures"] = dict(
        reserved_one_gib=one / 2 ** 30, reserved_two_gib=two / 2 ** 30,
        pools_gib=[e["manifest"] / 2 ** 30 for e in captured],
        peak_allocated_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    pools = ", ".join(f"{e['manifest'] / 2 ** 30:.2f}" for e in captured)
    log(f"  two captured entries of the step (fetch [loss] and [loss, "
        f"{extra}]): the card holds {two / 2 ** 30:.2f} GiB reserved "
        f"(one entry: {one / 2 ** 30:.2f} GiB); pools {pools} GiB; peak "
        f"allocated "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    if len(captured) != 2 or not (np.isfinite(out[0]).all()
                                  and np.isfinite(out0[0]).all()):
        raise AssertionError(f"second signature: {len(captured)} captured "
                             f"entries, losses {out[0]}, {out0[0]}")


def gen_prompts(lens, vocab, seed):
    """Prompts of the given lengths: random token ids from a numpy
    seed."""
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, size=n).astype("int64") for n in lens]


def uncached_logits(tpt, scope, model, max_seq_len, tokens, place,
                    attn_impl):
    """The uncached forward (build_llama_forward at max_seq_len, batch 1)
    over `tokens`, right-padded, on `place` with `scope`'s weights:
    [max_seq_len, vocab] logits."""
    from paddle_tpu_torch.models import build_llama_forward

    main, startup = tpt.Program(), tpt.Program()
    startup._is_startup = True
    with tpt.program_guard(main, startup):
        _, fetches = build_llama_forward(1, max_seq_len, name="llama",
                                         attn_impl=attn_impl, **model)
    ids = np.zeros((1, max_seq_len), "int64")
    ids[0, :len(tokens)] = tokens
    exe = tpt.Executor(place)
    out = exe.run(main, feed={"input_ids": ids},
                  fetch_list=[fetches["logits"]], scope=scope)[0][0]
    exe.close()
    return out


def stream_errors(results, prompts, reference):
    """(max |cached - uncached| over every step of every request, whether
    every greedy token is the uncached logits' argmax): `reference(seq)`
    gives the uncached logits over a request's prompt and tokens."""
    worst, greedy = 0.0, True
    for prompt, res in zip(prompts, results):
        ref = reference(list(prompt) + res["tokens"][:-1])
        for i, got in enumerate(res["logits"]):
            want = ref[len(prompt) - 1 + i]
            worst = max(worst, float(np.abs(got - want).max()))
            greedy &= res["tokens"][i] == int(np.argmax(want))
    return worst, greedy


def run_requests(eng, prompts, new_tokens, opt_out=()):
    """Submit every prompt (queued before the scheduler starts, so the
    claim order is the submission order; those whose index is in
    `opt_out` with speculate=False), start, and wait: (results, wall
    seconds, each request's token times)."""
    times = [[] for _ in prompts]
    futs = [eng.submit(p, new_tokens,
                       on_token=lambda tok, ts, t=t: t.append(ts),
                       speculate=False if i in opt_out else None)
            for i, (p, t) in enumerate(zip(prompts, times))]
    t0 = time.perf_counter()
    eng.start()
    results = [f.result(600) for f in futs]
    return results, time.perf_counter() - t0, times


def row_consistency(device):
    """max |x[:M] @ W - (x @ W)[:M]| on the card for the decode step's
    products (M = the parity engine's 2 slots against 128 forward rows):
    0 where cuBLAS gives the short product the long one's rows."""
    import torch

    g = torch.Generator(device=device).manual_seed(5)
    H, I, V = LLAMA["hidden"], LLAMA["intermediate"], LLAMA["vocab_size"]
    out = {}
    for what, K, N in (("qkv", H, 3 * H), ("attn_out", H, H),
                       ("gate_up", H, 2 * I), ("ffn_out", I, H),
                       ("head", H, V)):
        x = torch.randn(128, K, device=device, generator=g)
        w = torch.randn(K, N, device=device, generator=g)
        M = GEN_PARITY_ENGINE["num_slots"]
        out[what] = float((torch.matmul(x[:M], w)
                           - torch.matmul(x, w)[:M]).abs().max())
    return out


def cached_runs(counters):
    """Runs of the programs that attend through cached_attention: decode
    steps, prefill chunks and speculative verifies."""
    return (counters["decode_steps"] + counters["prefill_chunks"]
            + counters.get("spec_drafts", 0))


def gemm_launches(eng, counters, xla_prefill):
    """The product kernel's launches a generation engine's traffic must
    show (every product of its programs, nothing else): a decode step, a
    prefill chunk or a verify runs 4 L + 1 mul ops and cached_attention's
    2 L products; a whole prefill 4 L + 1, plus 2 L where its attention
    is the einsum formulation ("xla") rather than kernel #4."""
    L = eng.model["num_layers"]
    whole = whole_prefills(eng, counters)
    return cached_runs(counters) * (6 * L + 1) + whole * (
        4 * L + 1 + (2 * L if xla_prefill else 0))


def whole_prefills(eng, counters):
    """Prefills that ran the whole-prompt program (dense, or paged with
    chunking off and no prefix hit): each launches kernel #4 num_layers
    times.  With chunking off, a request that ran a chunk (a prefix
    hit's tail) ran exactly one."""
    if eng.paged and eng.prefill_chunk > 0:
        return 0
    return counters["prefills"] - counters["prefill_chunks"]


def rms_norm_launches(eng, counters):
    """The RMSNorm kernel's launches a generation engine's traffic must
    show: 2 L + 1 a run of each program (decode step, chunk, verify,
    whole prefill)."""
    return (2 * eng.model["num_layers"] + 1) * (
        cached_runs(counters) + whole_prefills(eng, counters))


def check_engine_counts(eng, counts, plain, realigned, what, xla_prefill):
    """Kernel #4 launched num_layers times a whole prefill and no other
    attention kernel; the product kernel exactly gemm_launches and the
    RMSNorm kernel rms_norm_launches; no plain call; nothing realigned.
    `eng` may be a tuple of engines that ran together (a DisaggPair's
    two): the sums of their wants."""
    engines = eng if isinstance(eng, tuple) else (eng,)
    want = [0, 0, 0, 0, 0, 0]
    want_rows = [0, 0]
    for e in engines:
        n = e.stats()["counters"]
        if not xla_prefill:
            want[3] += whole_prefills(e, n) * e.model["num_layers"]
        want_rows[0] += gemm_launches(e, n, xla_prefill)
        want_rows[1] += rms_norm_launches(e, n)
    want, want_rows = tuple(want), tuple(want_rows)
    log(f"  {what}: launches {counts}, product kernel {counts.gemm}, "
        f"RMSNorm kernel {counts.rms_norm} (want {want}, {want_rows}), "
        f"{plain} plain calls, {realigned} realigned operands")
    if (counts, (counts.gemm, counts.rms_norm), plain, realigned) != \
            (want, want_rows, 0, 0):
        raise AssertionError(f"{what}: launches {counts}, product kernel "
                             f"{counts.gemm}, RMSNorm {counts.rms_norm}, "
                             f"{plain} plain calls, {realigned} realigned, "
                             f"want {want}, {want_rows}, 0, 0")


def shared_pages(eng, pages=None):
    """(`pages`, by default those the prefix index holds now; their
    bytes in every layer's K and V pools)."""
    import torch

    if pages is None:
        pages = [p for p in range(1, eng.num_pages)
                 if eng._pool.refcount(p) > 0]
    idx = torch.tensor(pages, device=eng.device)
    return pages, torch.stack([eng.scope.find_var(n)[idx]
                               for n in eng.cache_names])


def generation_parity(tpt, fa):
    """Gates at 2 layers of Llama-2-7B's widths.  (a) The engine on the
    card (attn_impl "auto": prefill on the fp32 forward kernel, decode
    through cached_attention; the first runs eager, then captured graphs)
    against the port's uncached forward on the CPU over the card's own
    tokens: every step's logits within LOGITS_ATOL (fp32, TF32 off, as
    phase 4), every greedy token equal.  (b) The same requests with
    attn_impl "xla" against the card's own uncached "xla" forward: max
    |d| exactly 0 (every product runs the kernel whose rows do not
    depend on M).  (c) A paged engine (prefix reuse off, chunking off)
    on the same weights: logits bit-equal to (a)'s dense ones.  (d) A
    shared-prefix batch (a 32-token header, two pages) and (e) a chunked
    batch (chunk 16), each against the card's uncached forward within
    LOGITS_ATOL, greedy tokens equal; (d) with prefix hits whose shared
    pages keep their bytes.  Each engine's launches as
    check_engine_counts holds them.  Returns (a)'s launches."""
    import torch
    from paddle_tpu_torch.serving import GenerationEngine

    eng = GenerationEngine(GEN_PARITY, autostart=False, seed=23,
                           attn_impl="auto", **GEN_PARITY_ENGINE)
    prompts = gen_prompts(GEN_PARITY_PROMPTS, GEN_PARITY["vocab_size"], 24)
    reset_counts(fa)
    results, wall, _ = run_requests(eng, prompts, GEN_PARITY_NEW_TOKENS)
    counts, plain, realigned = read_counts(fa)
    log(f"  2 layers: {len(prompts)} requests of {GEN_PARITY_PROMPTS} "
        f"prompt tokens, {GEN_PARITY_NEW_TOKENS} new tokens each, in "
        f"{wall:.2f} s")
    check_engine_counts(eng, counts, plain, realigned, "dense", False)
    eng.close()
    weights = {n: eng.scope.find_var(n).to("cpu", copy=True)
               for n in eng.scope.local_var_names()
               if n not in eng.cache_names}
    cpu_scope = tpt.Scope()
    for n, t in weights.items():
        cpu_scope.set_var(n, t)
    S = GEN_PARITY_ENGINE["max_seq_len"]
    t0 = time.perf_counter()
    err, greedy = stream_errors(results, prompts, lambda seq: uncached_logits(
        tpt, cpu_scope, GEN_PARITY, S, seq, tpt.CPUPlace(), "xla"))
    GENERATION["card_vs_cpu"] = err
    log(f"  (a) card cached decode vs the CPU's uncached forward "
        f"({time.perf_counter() - t0:.1f} s on the CPU): logits max|diff| "
        f"{err:.3e} (limit {LOGITS_ATOL:g}), greedy tokens equal: "
        f"{greedy}")
    if not (err <= LOGITS_ATOL and greedy):
        raise AssertionError("generation parity (a): the card's cached "
                             "decode disagrees with the CPU's uncached "
                             "forward")
    del cpu_scope, weights

    def card_forward(seq):
        return uncached_logits(tpt, eng.scope, GEN_PARITY, S, seq, None,
                               "xla")

    xla = GenerationEngine(GEN_PARITY, eng.scope, autostart=False,
                           attn_impl="xla", **GEN_PARITY_ENGINE)
    reset_counts(fa)
    xla_results, _, _ = run_requests(xla, prompts, GEN_PARITY_NEW_TOKENS)
    check_engine_counts(xla, *read_counts(fa), "xla", True)
    xla.close()
    err, greedy = stream_errors(xla_results, prompts, card_forward)
    rows = row_consistency(torch.device("cuda", 0))
    GENERATION["cached_vs_uncached_card"] = err
    GENERATION["cublas_row_consistency"] = rows
    log(f"  (b) card cached decode vs the card's uncached forward (attn "
        f"'xla' both): logits max|diff| {err:.3e} (limit 0), greedy tokens "
        f"equal: {greedy}; cuBLAS's rows for comparison (M=2 against the "
        f"rows of M=128), max|diff|: "
        + ", ".join(f"{k} {v:.3e}" for k, v in rows.items()))
    if not (err == 0 and greedy):
        raise AssertionError("generation parity (b): the card's cached "
                             "decode is not bit-equal to its uncached "
                             "forward")

    paged = GenerationEngine(GEN_PARITY, eng.scope, autostart=False,
                             attn_impl="auto", paged=True,
                             page_tokens=GEN_PAGE, prefix_reuse=False,
                             prefill_chunk=0, **GEN_PARITY_ENGINE)
    reset_counts(fa)
    paged_results, _, _ = run_requests(paged, prompts, GEN_PARITY_NEW_TOKENS)
    check_engine_counts(paged, *read_counts(fa), "paged", False)
    paged.close()
    same = all(a["tokens"] == b["tokens"] and all(
        np.array_equal(x, y) for x, y in zip(a["logits"], b["logits"]))
        for a, b in zip(results, paged_results))
    GENERATION["paged_equals_dense"] = same
    log(f"  (c) paged (page {GEN_PAGE}, prefix reuse and chunking off) vs "
        f"dense on the card: tokens and every step's logits bit-equal: "
        f"{same}")
    if not same:
        raise AssertionError("generation parity (c): paged logits differ "
                             "from dense ones on the card")
    del paged
    torch.cuda.empty_cache()

    header = gen_prompts((2 * GEN_PAGE,), GEN_PARITY["vocab_size"], 25)[0]
    tails = gen_prompts((7, 30, 12), GEN_PARITY["vocab_size"], 26)
    shared = GenerationEngine(GEN_PARITY, eng.scope, autostart=False,
                              attn_impl="auto", paged=True,
                              page_tokens=GEN_PAGE, prefix_reuse=True,
                              prefill_chunk=0, **GEN_PARITY_ENGINE)
    donor = np.concatenate([header, tails[0]])
    borrowers = [np.concatenate([header, t]) for t in tails[1:]]
    reset_counts(fa)
    donor_res, _, _ = run_requests(shared, [donor], GEN_PARITY_NEW_TOKENS)
    pages, before = shared_pages(shared)
    futs = [shared.submit(p, GEN_PARITY_NEW_TOKENS) for p in borrowers]
    shared_res = donor_res + [f.result(600) for f in futs]
    check_engine_counts(shared, *read_counts(fa), "shared prefix", False)
    shared.close()
    _, after = shared_pages(shared, pages)
    hits = shared.stats()["counters"]["prefix_hits"]
    unchanged = bool(torch.equal(before, after))
    err, greedy = stream_errors(shared_res, [donor] + borrowers,
                                card_forward)
    GENERATION["shared_prefix_parity"] = dict(
        max_abs_diff=err, greedy_equal=greedy, prefix_hits=hits,
        shared_pages=len(pages), shared_bytes_unchanged=unchanged)
    log(f"  (d) shared prefix ({len(header)}-token header, then tails of "
        f"{[len(t) for t in tails]}): {hits} prefix hits over "
        f"{len(pages)} shared pages, their bytes unchanged: {unchanged}; "
        f"vs the card's uncached forward: max|diff| {err:.3e} (limit "
        f"{LOGITS_ATOL:g}), greedy tokens equal: {greedy}")
    if not (hits >= 1 and unchanged and err <= LOGITS_ATOL and greedy):
        raise AssertionError("generation parity (d): shared prefix")
    del shared
    torch.cuda.empty_cache()

    chunked = GenerationEngine(GEN_PARITY, eng.scope, autostart=False,
                               attn_impl="auto", paged=True,
                               page_tokens=GEN_PAGE, prefix_reuse=False,
                               prefill_chunk=16, **GEN_PARITY_ENGINE)
    reset_counts(fa)
    chunk_res, _, _ = run_requests(chunked, prompts, GEN_PARITY_NEW_TOKENS)
    check_engine_counts(chunked, *read_counts(fa), "chunked", False)
    chunked.close()
    n_chunks = chunked.stats()["counters"]["prefill_chunks"]
    err, greedy = stream_errors(chunk_res, prompts, card_forward)
    GENERATION["chunked_parity"] = dict(max_abs_diff=err,
                                        greedy_equal=greedy,
                                        chunks=n_chunks)
    log(f"  (e) chunked prefill (chunk 16): {n_chunks} chunks; vs the "
        f"card's uncached forward: max|diff| {err:.3e} (limit "
        f"{LOGITS_ATOL:g}), greedy tokens equal: {greedy}")
    if not (err <= LOGITS_ATOL and greedy and n_chunks == sum(
            -(-n // 16) for n in GEN_PARITY_PROMPTS)):
        raise AssertionError("generation parity (e): chunked prefill")
    del eng, xla, chunked
    torch.cuda.empty_cache()
    return counts


# phase 10's numbers, for the summary line before the last lines
GENERATION = {}


def memcpy_report(prof, cache_bytes):
    """(device-to-device copies, their bytes, the largest) in a profile,
    read from its trace's memcpy records; raises where one copy moves a
    cache's worth of bytes or more."""
    with tempfile.NamedTemporaryFile(suffix=".json") as f:
        prof.export_chrome_trace(f.name)
        with open(f.name) as g:
            events = json.load(g).get("traceEvents", [])
    sizes = [int((e.get("args") or {}).get("bytes", -1)) for e in events
             if "DtoD" in str(e.get("name", ""))]
    largest = max(sizes, default=0)
    if largest >= cache_bytes:
        raise AssertionError(f"a device-to-device copy of {largest} bytes "
                             f"(a cache is {cache_bytes}): the caches are "
                             f"not written in place")
    return len(sizes), sum(x for x in sizes if x > 0), largest


def profile_generation(fn, what, key, cache_bytes):
    """One profiled call of `fn` (a replay of a captured program): device
    busy / idle, host launches, and the device-to-device copies."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        wall_us = (time.perf_counter() - t) * 1e6
    report_profile(prof, wall_us, what, key=key)
    n, total, largest = memcpy_report(prof, cache_bytes)
    PROFILES[key]["dtod_copies"] = n
    PROFILES[key]["dtod_bytes"] = total
    log(f"  {what}: {n} device-to-device copies, {total} bytes, the "
        f"largest {largest} (a cache is {cache_bytes})")
    if PROFILES[key]["kernel_launches"] != 0 or \
            PROFILES[key]["graph_launches"] != 1:
        raise AssertionError(f"{what}: {PROFILES[key]['kernel_launches']} "
                             f"cudaLaunchKernel and "
                             f"{PROFILES[key]['graph_launches']} "
                             f"cudaGraphLaunch, want 0 and 1 (a replay)")


def generation_flagship(tpt, fa):
    """Greedy generation at Llama-2-7B's widths and depth through
    serving.GenerationEngine on the card: warmup (each prefill bucket and
    the decode step run twice: eager, then captured), then 8 requests
    with continuous batching.  Gates: kernel #4 launched num_layers
    times a prefill, no plain call, nothing realigned; every program
    captured once; the caches keep their storage; every request ends
    'length' with its 64 tokens; a profiled decode replay and prefill
    replay launch no kernel from the host and copy no cache.  Then the
    two paged runs.  Returns the launches of the dense run's traffic,
    {path: launches} of the paged runs' (each as read_counts gives
    them), the weights' scope and the dense run's token streams (phase
    11 serves them)."""
    import torch
    from paddle_tpu_torch.serving import GenerationEngine

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = GenerationEngine(GEN, autostart=False, seed=31, attn_impl="auto",
                           **GEN_ENGINE)
    torch.cuda.synchronize()
    weight_bytes = sum(eng.scope.find_var(n).numel() * 4
                       for n in eng.scope.local_var_names()
                       if n not in eng.cache_names)
    cache_bytes = eng.kv_cache_bytes // len(eng.cache_names)
    log(f"  built and initialised on the card in "
        f"{time.perf_counter() - t0:.1f} s: {weight_bytes / 4} parameters "
        f"({weight_bytes / 2 ** 30:.2f} GiB fp32), KV caches "
        f"{eng.kv_cache_bytes / 2 ** 30:.2f} GiB ({len(eng.cache_names)} "
        f"of {cache_bytes} bytes)")
    ptrs = {n: eng.scope.find_var(n).data_ptr() for n in eng.cache_names}
    t0 = time.perf_counter()
    warmed = eng.warmup()
    torch.cuda.synchronize()
    captures = eng.introspect()["captures"]
    log(f"  warmup: {warmed} programs in {time.perf_counter() - t0:.1f} s; "
        f"captures per program {captures}")
    if warmed != len(GEN_ENGINE["prefill_buckets"]) + 1 or \
            any(c != [1] for c in captures.values()):
        raise AssertionError(f"warmup did not capture every program once: "
                             f"{captures}")

    prompts = gen_prompts(GEN_PROMPTS, GEN["vocab_size"], 32)
    reset_counts(fa)
    results, wall, times = run_requests(eng, prompts, GEN_NEW_TOKENS)
    counts, plain, realigned = read_counts(fa)
    stats = eng.stats()
    prefills = stats["counters"]["prefills"]
    check_engine_counts(eng, counts, plain, realigned,
                        f"{len(prompts)} requests, prompts {GEN_PROMPTS} "
                        f"({prefills} prefills x {GEN['num_layers']} "
                        f"layers of kernel #4)", False)
    if prefills != len(prompts):
        raise AssertionError(f"generation: {prefills} prefills")
    bad = [r for r in results if r["finish"] != "length"
           or len(r["tokens"]) != GEN_NEW_TOKENS
           or not all(0 <= t < GEN["vocab_size"] for t in r["tokens"])]
    if bad:
        raise AssertionError(f"generation: bad results {bad[:2]}")
    moved = [n for n, p in ptrs.items()
             if eng.scope.find_var(n).data_ptr() != p]
    captures = eng.introspect()["captures"]
    if moved or any(c != [1] for c in captures.values()):
        raise AssertionError(f"generation: caches moved {moved[:4]}, "
                             f"captures {captures}")
    tokens = sum(len(r["tokens"]) for r in results)
    gaps = np.concatenate([np.diff(t) for t in times]) * 1e3
    ttft = np.asarray([r["ttft_ms"] for r in results])
    step_ms = stats["decode_step_ms"]
    bound_ms = (weight_bytes + eng.kv_cache_bytes) / PEAK_BYTES_PER_S * 1e3
    GENERATION.update(
        requests=len(results), tokens=tokens, wall_s=wall,
        tokens_per_s=tokens / wall, ttft_ms_p50=float(np.median(ttft)),
        ttft_ms_max=float(ttft.max()),
        prefill_ms={int(n): r["prefill_ms"]
                    for n, r in zip(GEN_PROMPTS, results)},
        inter_token_ms_p50=float(np.median(gaps)),
        inter_token_ms_p99=float(np.percentile(gaps, 99)),
        decode_step_ms_p50=step_ms["p50"], decode_steps=step_ms["count"],
        decode_bound_ms=bound_ms, captures=captures)
    log(f"  {tokens} tokens in {wall:.2f} s: {tokens / wall:.1f} tokens/s; "
        f"TTFT p50 {np.median(ttft):.1f} ms, max {ttft.max():.1f} ms (queue "
        f"wait included); inter-token p50 {np.median(gaps):.2f} ms, p99 "
        f"{np.percentile(gaps, 99):.2f} ms; decode step p50 "
        f"{step_ms['p50']:.2f} ms over {step_ms['count']} steps; the "
        f"step's bound (weights and caches read once, "
        f"{(weight_bytes + eng.kv_cache_bytes) / 1e9:.2f} GB at "
        f"{PEAK_BYTES_PER_S / 1e12:g} TB/s) {bound_ms:.2f} ms; prefill ms "
        f"by prompt length {GENERATION['prefill_ms']}")

    ids = np.zeros((eng.num_slots, 1), "int64")
    pos = np.arange(eng.num_slots, dtype="int32") * 100
    profile_generation(lambda: eng._run_decode_program(ids, pos),
                       "one decode replay (4 slots)", "generation_decode",
                       cache_bytes)
    prompt = prompts[2]
    bucket = max(GEN_ENGINE["prefill_buckets"])
    profile_generation(
        lambda: eng._run_prefill_program(prompt, bucket, 0)[0].numpy(),
        f"one prefill replay ({prompt.size} tokens, bucket {bucket})",
        "generation_prefill", cache_bytes)
    GENERATION["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    GENERATION["reserved_gib"] = torch.cuda.memory_reserved() / 2 ** 30
    log(f"  device memory: peak allocated {GENERATION['peak_gib']:.2f} GiB, "
        f"reserved {GENERATION['reserved_gib']:.2f} GiB")
    eng.close()
    scope, dense_tokens = eng.scope, [r["tokens"] for r in results]
    dense_itl = GENERATION["inter_token_ms_p99"]
    for n in eng.cache_names:  # the dense caches go before the pools come
        scope.set_var(n, None)
    del eng
    torch.cuda.empty_cache()
    return counts, {
        "generation_paged": paged_same_requests(tpt, fa, scope, prompts,
                                                dense_tokens),
        "generation_shared_prefix": paged_shared_prefix(tpt, fa, scope,
                                                        dense_itl),
        "generation_spec": generation_spec(fa, scope),
        "generation_disagg": generation_disagg(tpt, fa, scope)}, \
        scope, dense_tokens


def traffic_numbers(results, wall, times):
    """tokens/s, TTFT p50 and inter-token p50 / p99 of one run."""
    tokens = sum(len(r["tokens"]) for r in results)
    gaps = np.concatenate([np.diff(t) for t in times]) * 1e3
    ttft = np.asarray([r["ttft_ms"] for r in results])
    return dict(tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
                ttft_ms_p50=float(np.median(ttft)),
                inter_token_ms_p50=float(np.median(gaps)),
                inter_token_ms_p99=float(np.percentile(gaps, 99)))


def paged_engine(scope, engine=GEN_ENGINE, **kw):
    """A paged Llama-2-7B engine on `scope`'s weights, warmed: each
    program run twice (eager, capture) and captured exactly once (a
    prefill-role engine has no decode step)."""
    import torch
    from paddle_tpu_torch.serving import GenerationEngine

    eng = GenerationEngine(GEN, scope, autostart=False, attn_impl="auto",
                           paged=True, page_tokens=GEN_PAGE, **kw, **engine)
    t0 = time.perf_counter()
    warmed = eng.warmup()
    torch.cuda.synchronize()
    captures = eng.introspect()["captures"]
    log(f"  paged engine ({kw}): {eng.num_pages} pages of {GEN_PAGE} "
        f"tokens, pools {eng.kv_cache_bytes / 2 ** 30:.2f} GiB; warmup: "
        f"{warmed} programs in {time.perf_counter() - t0:.1f} s, captures "
        f"per program {captures}")
    if eng.role == "prefill" and captures.get("decode") == []:
        captures = {k: c for k, c in captures.items() if k != "decode"}
    if any(c != [1] for c in captures.values()) or \
            warmed != len(captures):
        raise AssertionError(f"paged warmup did not capture every program "
                             f"once: {captures}")
    return eng


def captured_once(eng):
    """Whether every program `eng` runs was captured exactly once (a
    prefill-role engine's decode step never)."""
    return all(c == [1] for k, c in eng.introspect()["captures"].items()
               if not (eng.role == "prefill" and k == "decode"))


def pool_ptrs(eng):
    return {n: eng.scope.find_var(n).data_ptr() for n in eng.cache_names}


def release(eng):
    """Close `eng` and drop its pools from the scope."""
    import torch

    eng.close()
    for n in eng.cache_names:
        eng.scope.set_var(n, None)
    torch.cuda.empty_cache()


def paged_same_requests(tpt, fa, scope, prompts, dense_tokens):
    """Phase 10b (i): the dense run's 8 requests through a paged engine
    (prefix reuse on, the prompts distinct; chunking off).  Gates: the
    dense run's tokens; the launches of check_engine_counts; every
    program captured once; the pools keep their data_ptr; one profiled
    paged decode replay launches no kernel from the host and copies
    nothing of a pool's size.  Returns the traffic's launches, as
    read_counts gives them."""
    eng = paged_engine(scope, prefix_reuse=True, prefill_chunk=0)
    ptrs = pool_ptrs(eng)
    reset_counts(fa)
    results, wall, times = run_requests(eng, prompts, GEN_NEW_TOKENS)
    counts, plain, realigned = read_counts(fa)
    check_engine_counts(eng, counts, plain, realigned, "paged (i)", False)
    same = [r["tokens"] for r in results] == dense_tokens
    moved = [n for n, p in ptrs.items()
             if eng.scope.find_var(n).data_ptr() != p]
    stats = eng.stats()
    GENERATION["paged"] = dict(
        traffic_numbers(results, wall, times), tokens_equal_dense=same,
        decode_step_ms_p50=stats["decode_step_ms"]["p50"],
        prefill_ms={int(len(p)): r["prefill_ms"]
                    for p, r in zip(prompts, results)},
        pages=eng.num_pages, pool_gib=eng.kv_cache_bytes / 2 ** 30)
    log(f"  (i) the same {len(prompts)} requests, paged: tokens equal the "
        f"dense run's: {same}; " + json.dumps(GENERATION["paged"]))
    if not same or moved or not captured_once(eng):
        raise AssertionError(f"paged (i): tokens equal {same}, pools moved "
                             f"{moved[:4]}, captures "
                             f"{eng.introspect()['captures']}")
    pool_bytes = eng.kv_cache_bytes // len(eng.cache_names)
    ids = np.zeros((eng.num_slots, 1), "int64")
    pos = np.arange(eng.num_slots, dtype="int32") * 100
    bt = (1 + np.arange(eng.num_slots * eng.pages_per_slot, dtype="int32")
          ).reshape(eng.num_slots, eng.pages_per_slot)
    live = np.ones((eng.num_slots,), "int32")
    profile_generation(lambda: eng._run_decode_program(ids, pos, bt, live),
                       "one paged decode replay (4 slots)",
                       "generation_paged_decode", pool_bytes)
    release(eng)
    return counts


def paged_shared_prefix(tpt, fa, scope, dense_itl):
    """Phase 10b (ii): 8 requests sharing a 256-token header (16 pages),
    each with its own tail of 20-200 tokens, 64 new tokens each, through
    a paged engine with prefix reuse and prefill_chunk 128.  Gates: the
    launches of check_engine_counts (no whole prefill: kernel #4 never
    runs, every prompt goes through the chunk program); every request
    ends 'length' with 64 valid tokens; at least one prefix hit.
    Returns the traffic's launches, as read_counts gives them."""
    eng = paged_engine(scope, prefix_reuse=True, prefill_chunk=128)
    header = gen_prompts((GEN_SHARED_HEADER,), GEN["vocab_size"], 33)[0]
    prompts = [np.concatenate([header, t]) for t in
               gen_prompts(GEN_SHARED_TAILS, GEN["vocab_size"], 34)]
    reset_counts(fa)
    results, wall, times = run_requests(eng, prompts, GEN_NEW_TOKENS)
    counts, plain, realigned = read_counts(fa)
    check_engine_counts(eng, counts, plain, realigned, "shared prefix (ii)",
                        False)
    n = eng.stats()["counters"]
    bad = [r for r in results if r["finish"] != "length"
           or len(r["tokens"]) != GEN_NEW_TOKENS
           or not all(0 <= t < GEN["vocab_size"] for t in r["tokens"])]
    GENERATION["shared_prefix"] = dict(
        traffic_numbers(results, wall, times), prefix_hits=n["prefix_hits"],
        prefix_tokens_saved=n["prefix_tokens_saved"],
        prefill_chunks=n["prefill_chunks"],
        dense_inter_token_ms_p99=dense_itl)
    log(f"  (ii) {len(prompts)} requests sharing a {GEN_SHARED_HEADER}-token "
        f"header, tails {GEN_SHARED_TAILS}, chunk 128: "
        + json.dumps(GENERATION["shared_prefix"]))
    if bad or n["prefix_hits"] < 1:
        raise AssertionError(f"shared prefix (ii): {n['prefix_hits']} hits, "
                             f"bad results {bad[:2]}")
    release(eng)
    return counts


def streams_equal(want, got):
    """Whether every request's tokens and its stacked per-step logits are
    bit-equal (torch.equal)."""
    import torch

    return len(want) == len(got) and all(
        a["tokens"] == b["tokens"] and len(a["logits"]) == len(b["logits"])
        and torch.equal(torch.from_numpy(np.stack(a["logits"])),
                        torch.from_numpy(np.stack(b["logits"])))
        for a, b in zip(want, got))


def spec_prompts():
    """Phase 10c's 8 prompts: four repeating one 8-token pattern
    (GEN_SPEC_REPEATS long), then the first four of GEN_PROMPTS (10b's
    token ids)."""
    pattern = gen_prompts((GEN_SPEC_PATTERN,), GEN["vocab_size"], 35)[0]
    return ([np.resize(pattern, n) for n in GEN_SPEC_REPEATS]
            + gen_prompts(GEN_PROMPTS, GEN["vocab_size"], 32)[:4])


def time_verify(eng, bucket, chunk, base, table, n=5):
    """Host ms of one verify run at `bucket` (each ending in its tokens'
    fetch), median of `n` after two warm runs (eager, capture)."""
    times = []
    for i in range(n + 2):
        t0 = time.perf_counter()
        eng._run_verify_program(chunk, bucket, base, chunk.size,
                                table)[0].numpy()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times[2:]))


def generation_spec(fa, scope):
    """Phase 10c: speculative decoding at full width.  The 8 requests of
    spec_prompts (two opted out) through a plain paged engine, then a
    speculating one, on `scope`'s weights, one after the other.  Gates:
    every token and every step's logits bit-equal; drafts fired,
    accepted <= proposed; the pool back to 0 live pages; each program
    captured once; the pools keep their data_ptr; the launches of
    check_engine_counts (a verify runs as a chunk does).  Printed:
    tokens/s of both, acceptance, verify ms beside the decode step's, one
    profiled verify replay, a 64-row verify's ms beside the 8-row one's,
    and the first repetitive request alone in the grid, plain against
    speculating.  Returns the speculating run's launches."""
    prompts = spec_prompts()
    runs = {}
    for speculate in (False, True):
        what = "speculating" if speculate else "plain"
        eng = paged_engine(scope, engine=GEN_SPEC_ENGINE,
                           prefix_reuse=False, prefill_chunk=0,
                           speculate=speculate, **GEN_SPEC)
        ptrs = pool_ptrs(eng)
        reset_counts(fa)
        results, wall, times = run_requests(eng, prompts, GEN_NEW_TOKENS,
                                            opt_out=GEN_SPEC_OPT_OUT)
        counts, plain, realigned = read_counts(fa)
        check_engine_counts(eng, counts, plain, realigned, f"10c {what}",
                            False)
        stats = eng.stats()
        moved = [n for n, p in ptrs.items()
                 if eng.scope.find_var(n).data_ptr() != p]
        live = eng._pool.live_pages
        if moved or live or not captured_once(eng) or any(
                r["finish"] != "length" for r in results):
            raise AssertionError(
                f"10c {what}: pools moved {moved[:4]}, {live} live pages, "
                f"captures {eng.introspect()['captures']}, finishes "
                f"{[r['finish'] for r in results]}")
        lone, lone_wall, _ = run_requests(eng, prompts[:1], GEN_NEW_TOKENS)
        run = dict(traffic_numbers(results, wall, times),
                   decode_step_ms_p50=stats["decode_step_ms"]["p50"],
                   decode_steps=stats["decode_step_ms"]["count"],
                   lone_tokens_per_s=len(lone[0]["tokens"]) / lone_wall,
                   lone_ms=lone_wall * 1e3)
        if speculate:
            sp, ver = stats["speculate"], stats["spec_verify_ms"]
            run.update(drafts=sp["drafts"],
                       tokens_proposed=sp["tokens_proposed"],
                       tokens_accepted=sp["tokens_accepted"],
                       rollbacks=sp["rollbacks"],
                       acceptance_rate=sp["acceptance_rate"],
                       verify_ms_p50=ver["p50"], verify_ms_p99=ver["p99"],
                       verifies=ver["count"])
            if not (sp["drafts"] > 0
                    and sp["tokens_accepted"] <= sp["tokens_proposed"]):
                raise AssertionError(f"10c: drafts {sp}")
            table = 1 + np.arange(eng.pages_per_slot, dtype="int32")
            chunk = prompts[0][:GEN_SPEC["spec_tokens"] + 1]
            pool_bytes = eng.kv_cache_bytes // len(eng.cache_names)
            profile_generation(
                lambda: eng._run_verify_program(chunk, 8, 500, chunk.size,
                                                table)[0].numpy(),
                "one verify replay (5 rows, bucket 8)", "generation_verify",
                pool_bytes)
            run["verify_replay_ms"] = {b: time_verify(eng, b, chunk, 500,
                                                      table)
                                       for b in (8, 64)}
            spec_counts = counts
        runs[what] = (results, run)
        release(eng)
    same = streams_equal(runs["plain"][0], runs["speculating"][0])
    GENERATION["spec"] = dict(
        plain=runs["plain"][1], speculating=runs["speculating"][1],
        bit_equal=same, opted_out=list(GEN_SPEC_OPT_OUT))
    log("  10c speculative decoding (plain, then speculating; tokens and "
        f"every step's logits bit-equal: {same}): "
        + json.dumps(GENERATION["spec"]))
    if not same:
        raise AssertionError("10c: the speculating engine's streams are "
                             "not bit-equal to the plain engine's")
    return spec_counts


def run_pair(pair, prompts, new_tokens):
    """run_requests through a DisaggPair (its engines started after every
    prompt is queued): (results, wall seconds, token times, TTFT ms from
    submit to the first token, which the decode engine replays at
    adoption)."""
    times = [[] for _ in prompts]
    t_submit, futs = [], []
    for p, t in zip(prompts, times):
        t_submit.append(time.monotonic())
        futs.append(pair.submit(p, new_tokens,
                                on_token=lambda tok, ts, t=t: t.append(ts)))
    t0 = time.perf_counter()
    pair.prefill.start()
    pair.decode.start()
    results = [f.result(600) for f in futs]
    wall = time.perf_counter() - t0
    return results, wall, times, [(t[0] - s) * 1e3
                                  for t, s in zip(times, t_submit)]


class TimedTransport:
    """A transport whose ``send`` host time is kept (``ms``): the part of
    a handoff that is the transport's."""

    def __init__(self, inner):
        self.inner, self.ms = inner, []

    def send(self, segment):
        t0 = time.perf_counter()
        out = self.inner.send(segment)
        self.ms.append((time.perf_counter() - t0) * 1e3)
        return out


def generation_disagg(tpt, fa, scope):
    """Phase 10d: the prefill and decode roles at full width.  A
    colocated paged engine runs GEN_PROMPTS (64 new tokens each,
    keep_logits); then a DisaggPair of a prefill-role and a decode-role
    engine, each over its own child scope of `scope` (its own pools, one
    copy of the weights), runs the same requests through
    HostBytesTransport, then through DeviceTransport.  Gates: tokens and
    every step's logits bit-equal to the colocated run's, each time; 8
    segments exported and 8 adopted a run; both pools back to 0 live
    pages and keeping their data_ptr; each program captured once; the
    launches of check_engine_counts over both engines; a segment whose
    fingerprint is changed refused with SegmentMismatch.  Printed:
    handoff ms p50 / p99 (the transport's send alone beside them) and
    adopt ms by transport, segment bytes,
    tokens/s, TTFT p50 beside the colocated run's.  Returns the pair's
    launches over both runs."""
    from paddle_tpu_torch.serving import (DeviceTransport, DisaggPair,
                                          HostBytesTransport, KVSegment,
                                          SegmentMismatch)

    prompts = gen_prompts(GEN_PROMPTS, GEN["vocab_size"], 32)
    engine = dict(GEN_ENGINE, keep_logits=True)
    col = paged_engine(scope, engine=engine, prefix_reuse=False,
                       prefill_chunk=0)
    want, wall, times = run_requests(col, prompts, GEN_NEW_TOKENS)
    colocated = traffic_numbers(want, wall, times)
    release(col)
    pre, dec = (paged_engine(tpt.Scope(parent=scope), engine=engine,
                             prefix_reuse=False, prefill_chunk=0, role=role)
                for role in ("prefill", "decode"))
    ptrs = [pool_ptrs(pre), pool_ptrs(dec)]
    pair = DisaggPair(pre, dec)
    out = {"colocated": colocated}
    reset_counts(fa)
    for transport in (HostBytesTransport, DeviceTransport):
        pair.transport = TimedTransport(transport())
        before = (pre.stats()["counters"]["segments_exported"],
                  dec.stats()["counters"]["segments_adopted"],
                  len(dec._h_adopt._v))
        results, wall, times, ttft = run_pair(pair, prompts, GEN_NEW_TOKENS)
        n_exp = pre.stats()["counters"]["segments_exported"] - before[0]
        n_adopt = dec.stats()["counters"]["segments_adopted"] - before[1]
        live = (pre._pool.live_pages, dec._pool.live_pages)
        same = streams_equal(want, results)
        hand = np.asarray([r["handoff_ms"] for r in results])
        adopt_ms = list(dec._h_adopt._v)[before[2]:]
        name = transport.__name__
        out[name] = dict(
            traffic_numbers(results, wall, times),
            ttft_ms_p50=float(np.median(ttft)),
            handoff_ms_p50=float(np.median(hand)),
            handoff_ms_p99=float(np.percentile(hand, 99)),
            send_ms_p50=float(np.median(pair.transport.ms)),
            send_ms_p99=float(np.percentile(pair.transport.ms, 99)),
            adopt_ms_p50=float(np.median(adopt_ms)),
            adopt_ms_max=float(max(adopt_ms)),
            segment_bytes=[int(r["segment_bytes"]) for r in results],
            bit_equal=same, exported=n_exp, adopted=n_adopt)
        log(f"  10d {name}: bit-equal to colocated: {same}; "
            + json.dumps(out[name]))
        if not (same and n_exp == n_adopt == len(prompts)
                and live == (0, 0)):
            raise AssertionError(f"10d {name}: bit-equal {same}, exported "
                                 f"{n_exp}, adopted {n_adopt}, live pages "
                                 f"{live}")
    counts, plain, realigned = read_counts(fa)
    check_engine_counts((pre, dec), counts, plain, realigned,
                        "10d prefill + decode roles", False)
    moved = [n for e, p in zip((pre, dec), ptrs) for n, ptr in p.items()
             if e.scope.find_var(n).data_ptr() != ptr]
    if moved or not (captured_once(pre) and captured_once(dec)):
        raise AssertionError(f"10d: pools moved {moved[:4]}, captures "
                             f"{pre.introspect()['captures']}, "
                             f"{dec.introspect()['captures']}")
    seg = pre.generate(prompts[0], 1, timeout=600)["segment"]
    bad = KVSegment("0" * 24, seg.prompt_len, seg.position, seg.tokens,
                    seg.page_tokens, seg.layers, ready=seg.ready)
    try:
        dec.adopt(bad)
        refused = False
    except SegmentMismatch:
        refused = True
    out["changed_fingerprint_refused"] = refused
    if not refused:
        raise AssertionError("10d: a segment with a changed fingerprint "
                             "was adopted")
    del seg, bad
    pair.close()
    release(pre)
    release(dec)
    GENERATION["disagg"] = out
    log("  10d disaggregated: " + json.dumps(out))
    return counts


# ---------------------------------------------------------------------------
# phase 11: the serving stack at full width
# ---------------------------------------------------------------------------

def closed_loop(eng, feeds, clients=SERVE_CLIENTS):
    """Each of `clients` threads submits the next feed once its last answer
    is back (a closed loop): (the outputs by request, latencies in ms,
    wall seconds).  Any failure raises."""
    import threading

    outs, lat = [None] * len(feeds), [None] * len(feeds)
    nxt, lock, errors = [0], threading.Lock(), []

    def client():
        while True:
            with lock:
                i = nxt[0]
                nxt[0] += 1
            if i >= len(feeds):
                return
            t = time.perf_counter()
            try:
                outs[i] = eng.submit(feeds[i]).result(600)
            except Exception as e:  # noqa: BLE001 — raised below
                errors.append((i, e))
                return
            lat[i] = (time.perf_counter() - t) * 1e3

    threads = [threading.Thread(target=client) for _ in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"closed loop: {errors[:3]}")
    return outs, np.asarray(lat), wall


def serving_feeds(n, seed, rows_range=SERVE_ROWS):
    """`n` BERT serving requests of `rows_range` rows each (from a seed),
    token ids below SERVE_POISON_ID."""
    rng = np.random.RandomState(seed)
    S = SERVE_BERT["seq_len"]
    feeds = []
    for _ in range(n):
        rows = int(rng.randint(rows_range[0], rows_range[1] + 1))
        mask = np.ones((rows, S), "float32")
        for b in range(rows):
            mask[b, S - int(rng.randint(0, S // 2)):] = 0.0
        feeds.append({
            "input_ids": rng.randint(0, SERVE_POISON_ID, (rows, S)
                                     ).astype("int64"),
            "token_type_ids": (rng.rand(rows, S) > 0.5).astype("int64"),
            "attn_mask": mask})
    return feeds


def same_outputs(got, want):
    return len(got) == len(want) and all(
        g.dtype == w.dtype and np.array_equal(g, w)
        for g, w in zip(got, want))


def device_busy_union(prof):
    """Device time the profile's kernels and copies covered, as a union of
    their intervals (two workers' streams overlap), in us."""
    import torch

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def pool_captures(eng):
    return sum(e.captures for p in eng._pool for e, _ in p._cache.values())


def engine_traffic(eng, feeds, want, fa, n_attn, n_mul, what):
    """The closed loop of `feeds` through `eng`, SERVE_ROUNDS times, its
    launches read from 0: every answer equal to `want` (tolerance 0),
    kernel #1 n_attn times and the product kernel n_mul times a
    dispatched batch, no plain call, nothing realigned.  Returns the
    traffic's numbers (the median round's rates, every round's) and
    launches."""
    before = dict(eng.stats()["counters"])
    reset_counts(fa)
    rounds, lats, bad = [], [], []
    for _ in range(SERVE_ROUNDS):
        outs, lat, wall = closed_loop(eng, feeds)
        rounds.append(wall)
        lats.append(lat)
        bad += [i for i, (o, w) in enumerate(zip(outs, want))
                if not same_outputs(o, w)]
    counts, plain, realigned = read_counts(fa)
    stats = eng.stats()
    batches = stats["counters"]["batches"] - before["batches"]
    rows = sum(f["input_ids"].shape[0] for f in feeds)
    lat = np.concatenate(lats)
    wall = float(np.median(rounds))
    fill = stats["batch_fill_pct"]
    out = dict(requests=len(feeds), rows=rows, rounds=SERVE_ROUNDS,
               wall_s=wall, round_walls_s=rounds,
               requests_per_s=len(feeds) / wall, rows_per_s=rows / wall,
               latency_ms_p50=float(np.percentile(lat, 50)),
               latency_ms_p99=float(np.percentile(lat, 99)),
               batches=batches, batch_fill_pct_mean=fill.get("mean"),
               bucket_hit_rate=stats["bucket_hit_rate"])
    log(f"  11a {what}: " + json.dumps(out))
    want_counts = (n_attn * batches, 0, 0, 0, 0, 0)
    if bad or counts != want_counts or counts.gemm != n_mul * batches \
            or plain or realigned:
        raise AssertionError(
            f"11a {what}: requests not bit-equal {bad[:5]}; launches "
            f"{counts} (want {want_counts}), product kernel {counts.gemm} "
            f"(want {n_mul * batches}), plain {plain}, realigned "
            f"{realigned}")
    return out, counts


def serving_engine_flagship(tpt, fa, workdir, second_dir):
    """Phase 11a: BERT-base at its published widths (seq 128, fp32) saved
    with row-shaped fetches (models.build_bert_serving) and served by
    ServingEngine.  Gates (tolerance 0): every response of SERVE_REQUESTS
    requests of 1-3 rows, sent by SERVE_CLIENTS client threads in a closed
    loop at 1 and at 2 workers (every bucket captured on every worker),
    equals the same rows run alone through Predictor.run; kernel #1 12
    times and the product kernel once a mul a dispatched batch, no plain
    call, nothing realigned; a batch failed by serve_batch:fail is
    bisected and every rider served bit-equal; under the poison sentinel
    only the poisoned request fails and its batchmates are bit-equal; a
    full queue sheds queue_full; a swap to a second seed's weights (an
    in-memory dict) answers as a fresh Predictor on them does, with no
    capture and every weight's data_ptr kept, and the revert brings the
    first answers back.  The model is saved to `workdir` and, with the
    second seed's weights, to `second_dir` (phase 12 serves and swaps
    them).  Returns (the 2-worker engine, left running for 11b, its base
    predictor, the feeds, their answers, the first SERVE_SWAP_REQUESTS'
    answers on the second weights, the 2-worker traffic's launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch import fault
    from paddle_tpu_torch.inference import Predictor
    from paddle_tpu_torch.models import build_bert_serving
    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.serving import (OverloadedError, RequestFailed,
                                          ServingEngine)

    t0 = time.perf_counter()
    op_seed = registry._OP_SEED[0]
    main, startup = tpt.Program(), tpt.Program()
    startup._is_startup = True
    with tpt.program_guard(main, startup):
        feed_names, outs = build_bert_serving(**SERVE_BERT)
    registry.reset_op_seed(op_seed)
    ops = [op.type for op in main.global_block().ops]
    n_attn, n_mul = ops.count("flash_attention_qkv"), ops.count("mul")
    exe = tpt.Executor()
    weights = {}
    for seed in (SERVE_SEEDS[1], SERVE_SEEDS[0]):
        scope = tpt.Scope()
        startup.random_seed = seed
        with tpt.scope_guard(scope):
            exe.run(startup)
            tpt.io.save_inference_model(
                workdir if seed == SERVE_SEEDS[0] else second_dir,
                feed_names, [outs["encoder_out"], outs["mlm_argmax"]], exe,
                main_program=main)
        weights[seed] = {n: scope.find_var(n)
                         for n in scope.local_var_names()}
    exe.close()
    pred = Predictor(workdir)
    second = Predictor(workdir)
    for n, t in weights[SERVE_SEEDS[1]].items():
        second.scope.set_var(n, t)
    n_params = sum(t.numel() for t in weights[SERVE_SEEDS[0]].values())
    feeds = serving_feeds(SERVE_REQUESTS, seed=1100)
    want = [pred.run(f) for f in feeds]
    want_second = [second.run(f) for f in feeds[:SERVE_SWAP_REQUESTS]]
    second.close()
    torch.cuda.synchronize()
    log(f"  BERT-base serving model: {n_params} parameters, {n_attn} "
        f"flash_attention_qkv and {n_mul} mul ops, fetches encoder_out "
        f"[B, 128, 768] and mlm_argmax [B, 128]; {len(feeds)} requests "
        f"answered alone ({time.perf_counter() - t0:.1f} s)")
    per_row = {n: (SERVE_BERT["seq_len"],) for n in feed_names}
    numbers = {}
    for workers in (1, 2):
        t0 = time.perf_counter()
        eng = ServingEngine(pred, workers=workers,
                            warmup_shapes=per_row, **SERVE_ENGINE)
        torch.cuda.synchronize()
        caps = pool_captures(eng)
        pools = [m for p in eng._pool
                 for m in p.cache_info()["manifests"].values()]
        log(f"  {workers} worker(s): warmup captured {caps} graphs in "
            f"{time.perf_counter() - t0:.1f} s, pools "
            f"{sum(pools) / 2 ** 20:.1f} MiB "
            f"({', '.join(f'{m / 2 ** 20:.1f}' for m in pools)} MiB)")
        if caps != workers * len(eng.buckets) or None in pools:
            raise AssertionError(f"11a: {caps} captures for {workers} "
                                 f"workers, pools {pools}")
        numbers[f"workers_{workers}"], counts = engine_traffic(
            eng, feeds, want, fa, n_attn, n_mul, f"{workers} worker(s)")
        numbers[f"workers_{workers}"]["pool_mib"] = sum(pools) / 2 ** 20
        if workers == 1:
            eng.close()
    numbers["speedup_2_over_1"] = (
        numbers["workers_2"]["requests_per_s"]
        / numbers["workers_1"]["requests_per_s"])

    # one profiled window of the 2-worker engine's traffic
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        closed_loop(eng, feeds[:SERVE_PROFILE_REQUESTS])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    busy = device_busy_union(prof)
    numbers["profile"] = dict(requests=SERVE_PROFILE_REQUESTS,
                              wall_ms=wall_us / 1e3, busy_ms=busy / 1e3,
                              idle=None if busy <= 0 else 1 - busy / wall_us)
    log(f"  profiled window ({SERVE_PROFILE_REQUESTS} requests, 2 "
        f"workers): {json.dumps(numbers['profile'])}")

    # serve_batch:fail: the first batch (requests queued before a one-
    # worker engine starts, so it has riders) fails, is bisected, and
    # every rider is served bit-equal
    engf = ServingEngine(pred, workers=1, warmup_shapes=per_row,
                         autostart=False, **SERVE_ENGINE)
    try:
        futs = [engf.submit(f) for f in feeds[:6]]
        fault.configure("serve_batch:fail@1")
        engf.start()
        same = all(same_outputs(f.result(600), w)
                   for f, w in zip(futs, want))
        n1 = engf.stats()["counters"]
    finally:
        fault.reset()
        engf.close()
    numbers["serve_batch_fail"] = dict(
        bit_equal=same, bisections=n1["bisections"],
        batch_failures=n1["batch_failures"], batches=n1["batches"])
    log(f"  serve_batch:fail@1: {json.dumps(numbers['serve_batch_fail'])}")
    if not (same and n1["batch_failures"] == 1 and n1["bisections"] == 1):
        raise AssertionError(f"11a serve_batch:fail: "
                             f"{numbers['serve_batch_fail']}")

    # the poison sentinel: only the poisoned request fails; a full queue
    # sheds (a one-worker engine whose queue fills before it starts)
    tpt.set_flags({"FLAGS_serving_poison_value": str(SERVE_POISON_ID)})
    engp = ServingEngine(pred, workers=1, warmup_shapes=per_row,
                         autostart=False,
                         **dict(SERVE_ENGINE, queue_cap=6))
    try:
        bad = {n: a.copy() for n, a in feeds[5].items()}
        bad["input_ids"][0, 7] = SERVE_POISON_ID
        group = [feeds[0], feeds[1], feeds[2], bad, feeds[3], feeds[4]]
        futs = [engp.submit(f) for f in group]
        try:
            engp.submit(feeds[6])
            shed = None
        except OverloadedError as e:
            shed = e.reason
        engp.start()
        poisoned, mates = None, []
        for i, f in enumerate(futs):
            try:
                out = f.result(600)
                mates.append(same_outputs(out, want[[0, 1, 2, None, 3,
                                                     4][i]]))
            except RequestFailed as e:
                poisoned = (i, str(e)[:60])
        n = engp.stats()["counters"]
    finally:
        tpt.set_flags({"FLAGS_serving_poison_value": ""})
        engp.close()
    numbers["poison"] = dict(failed=poisoned, batchmates_bit_equal=all(mates),
                             batchmates=len(mates), queue_full_shed=shed,
                             bisections=n["bisections"],
                             poison_rows=n["poison_rows"])
    log(f"  poison and queue_full: {json.dumps(numbers['poison'])}")
    if not (poisoned is not None and poisoned[0] == 3 and all(mates)
            and len(mates) == 5 and shed == "queue_full"
            and n["bisections"] >= 1):
        raise AssertionError(f"11a poison / shed: {numbers['poison']}")

    # hot-swap to the second seed's weights (an in-memory dict of tensors
    # on the card, exchanged in place: they come back holding the first)
    names = pred._weight_names()
    ptrs = {n: eng._pool[0].scope.find_var(n).data_ptr() for n in names}
    caps = pool_captures(eng)
    res = eng.swap_weights({n: weights[SERVE_SEEDS[1]][n] for n in names})
    outs_s, _, _ = closed_loop(eng, feeds[:SERVE_SWAP_REQUESTS])
    fresh = all(same_outputs(o, w) for o, w in zip(outs_s, want_second))
    res2 = eng.revert_weights()
    outs_r, _, _ = closed_loop(eng, feeds[:SERVE_SWAP_REQUESTS])
    back = all(same_outputs(o, w) for o, w in zip(outs_r, want))
    moved = [n for n in names
             if eng._pool[0].scope.find_var(n).data_ptr() != ptrs[n]]
    numbers["swap"] = dict(swap_ms=res["swap_ms"], revert_ms=res2["swap_ms"],
                           weights_version=res2["weights_version"],
                           equal_to_fresh_predictor=fresh,
                           revert_equal=back,
                           captures_added=pool_captures(eng) - caps,
                           data_ptr_moved=len(moved))
    log(f"  swap: {json.dumps(numbers['swap'])}")
    if not (fresh and back and not moved and pool_captures(eng) == caps):
        raise AssertionError(f"11a swap: {numbers['swap']}")
    del weights
    SERVING["engine"] = numbers
    return eng, pred, feeds, want, want_second, counts


def post(url, payload, headers=None, timeout=600):
    """(status, body bytes, headers) of a POST; a JSON payload unless
    bytes; an HTTP error status is returned, not raised."""
    import urllib.error
    import urllib.request

    data = payload if isinstance(payload, bytes) else \
        json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers=dict(
        {"Content-Type": "application/json"}, **(headers or {})))
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def get(url, timeout=600):
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read()


def stream_tokens(url, payload):
    """POST a streamed /generate (or /adopt): (tokens, the final record,
    the client's clock at the request and at each token line)."""
    import urllib.request

    req = urllib.request.Request(url, data=payload if isinstance(
        payload, bytes) else json.dumps(payload).encode())
    t0 = time.monotonic()
    toks, times, final = [], [], None
    with urllib.request.urlopen(req, timeout=600) as r:
        for line in r:
            rec = json.loads(line)
            if rec.get("done"):
                final = rec
                break
            times.append(time.monotonic())
            toks.append(rec["token"])
    return toks, final, t0, times


PROM_LINE = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? '
                       r'(-?[0-9.eE+-]+|[+-]?Inf|NaN)$')


def concurrently(fn, args):
    """fn(*a) for each a in `args`, each on a thread of its own: the
    results in order."""
    import threading

    out, errors = [None] * len(args), []

    def run(i, a):
        try:
            out[i] = fn(*a)
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append((i, e))

    threads = [threading.Thread(target=run, args=(i, a))
               for i, a in enumerate(args)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"concurrent requests failed: {errors[:2]}")
    return out


def serving_http_flagship(tpt, fa, eng, pred, feeds, want, scope,
                          dense_tokens, gen_second_dir):
    """Phase 11b: a ServingServer on 127.0.0.1 over 11a's engine, with a
    paged, speculating Llama-2-7B engine attached (GEN's 8 layers, fp32, 4
    slots x 1024, on `scope`'s weights).  Gates (tolerance 0): /predict at
    batch 1 equals the in-process answer; /healthz, /statusz (cost
    manifests, the H100's peaks), /tracez and /metrics (Prometheus text)
    answer; /generate for the GEN_PROMPTS, plain and streamed, gives the
    in-process engine's tokens (phase 10b's `dense_tokens`), and so does
    one prompt with "speculate": true; /adopt of a prefill-role server's
    segments gives the colocated tokens; the launches of
    check_engine_counts over both engines; /swap "target": "generate" to a
    second set of weights written as a checkpoint to `gen_second_dir`
    (phase 12b swaps a replica to it): every live weight then
    equals the second set, and a prompt's stream differs from the first
    weights' and equals a fresh engine's over the swapped storage; then
    the revert, with the streams after it bit-equal and no weight moved
    or recaptured; a
    drifted /swap gets 409; close(drain=True) answers every queued
    request and leaves no worker or scheduler thread.  Returns the
    generation traffic's launches and the fresh engine's 16 tokens of the
    first prompt on the second weights."""
    import pickle
    import threading

    import torch
    from paddle_tpu_torch.serving import ServingEngine, serve

    numbers = {}
    prompts = gen_prompts(GEN_PROMPTS, GEN["vocab_size"], 32)
    t0 = time.perf_counter()
    gen = paged_engine(tpt.Scope(parent=scope), engine=dict(
        GEN_SPEC_ENGINE, keep_logits=False), prefix_reuse=False,
        prefill_chunk=0, speculate=True, **GEN_SPEC)
    gen.start()
    eng.attach_generator(gen)
    srv = serve(eng)
    url = srv.url
    log(f"  server at {url}: 11a's engine with a paged, speculating "
        f"Llama-2-7B engine attached ({time.perf_counter() - t0:.1f} s)")

    one = next(i for i, f in enumerate(feeds)
               if f["input_ids"].shape[0] == 1)
    status, body, hdr = post(url + "/predict", {"inputs": {
        n: a.tolist() for n, a in feeds[one].items()}})
    doc = json.loads(body)
    got = [np.asarray(o, dtype=w.dtype).reshape(w.shape)
           for o, w in zip(doc["outputs"], want[one])]
    ok_predict = status == 200 and same_outputs(got, want[one])
    checks = {"predict_bit_equal": ok_predict}
    for path in ("/healthz", "/statusz", "/tracez", "/metrics"):
        status, body = get(url + path)
        checks[path] = status
        if path == "/statusz":
            st = json.loads(body)
            peaks = st["device"]["peaks"]
            costs = [c for ex in st["engine"]["executables"]
                     for c in (ex.get("costs") or {}).values()]
            checks["statusz_peaks"] = peaks
            checks["statusz_costs"] = costs[:1]
            ok_statusz = (peaks["peak_flops"] == 989e12
                          and peaks["peak_bw"] == 3.35e12
                          and costs and all(c["flops"] > 0 for c in costs))
        if path == "/metrics":
            text = body.decode()
            bad_lines = [x for x in text.splitlines()
                         if x and not x.startswith("#")
                         and not PROM_LINE.match(x)]
            checks["metrics_lines"] = len(text.splitlines())
            checks["metrics_bad_lines"] = bad_lines[:3]
    log(f"  /predict and the introspection plane: {json.dumps(checks)}")
    if not (ok_predict and ok_statusz and not checks["metrics_bad_lines"]
            and all(checks[p] == 200 for p in ("/healthz", "/statusz",
                                                "/tracez", "/metrics"))):
        raise AssertionError(f"11b: {checks}")

    # the prefill-role server /adopt will take segments from, warmed
    # before the launches are read from 0 (warmup runs each program twice)
    pre = paged_engine(tpt.Scope(parent=scope), engine=GEN_ENGINE,
                       prefix_reuse=False, prefill_chunk=0, role="prefill")
    pre.start()
    pre_eng = ServingEngine(pred, workers=1, **SERVE_ENGINE)
    pre_eng.attach_generator(pre)
    pre_srv = serve(pre_eng)

    # /generate, plain then streamed, all eight at once (4 slots)
    reset_counts(fa)
    n_new = GEN_NEW_TOKENS

    def plain(p):
        status, body, _ = post(url + "/generate", {
            "prompt": p.tolist(), "max_new_tokens": n_new,
            "speculate": False})
        return status, json.loads(body)

    t = time.perf_counter()
    plain_out = concurrently(plain, [(p,) for p in prompts])
    plain_wall = time.perf_counter() - t
    t = time.perf_counter()
    streamed = concurrently(stream_tokens, [
        (url + "/generate", {"prompt": p.tolist(), "max_new_tokens": n_new,
                             "stream": True, "speculate": False})
        for p in prompts])
    stream_wall = time.perf_counter() - t
    ok_plain = all(s == 200 and d["tokens"] == w
                   for (s, d), w in zip(plain_out, dense_tokens))
    ok_stream = all(toks == w and fin["tokens"] == w
                    for (toks, fin, _, _), w in zip(streamed, dense_tokens))
    ttft = np.asarray([(ts[0] - t0s) * 1e3
                       for _, _, t0s, ts in streamed])
    gaps = np.concatenate([np.diff(ts) for _, _, _, ts in streamed]) * 1e3
    server_ttft = np.asarray([fin["ttft_ms"] for _, fin, _, _ in streamed])
    server_itl = np.concatenate([
        np.diff(fin["timeline"]["token_ms"]) for _, fin, _, _ in streamed])
    # one repetitive prompt (the drafter fires on it) with "speculate":
    # true against the same engine's plain stream for it, in process
    rep = spec_prompts()[0]
    drafts = gen.stats()["counters"]["spec_drafts"]
    plain_rep = gen.submit(rep, n_new, speculate=False).result(600)["tokens"]
    s_status, s_body, _ = post(url + "/generate", {
        "prompt": rep.tolist(), "max_new_tokens": n_new, "speculate": True})
    ok_spec = s_status == 200 and json.loads(s_body)["tokens"] == plain_rep
    drafts = gen.stats()["counters"]["spec_drafts"] - drafts
    numbers["generate"] = dict(
        plain_bit_equal=ok_plain, stream_bit_equal=ok_stream,
        speculate_bit_equal=ok_spec, plain_wall_s=plain_wall,
        stream_wall_s=stream_wall,
        tokens_per_s_stream=len(prompts) * n_new / stream_wall,
        client_ttft_ms_p50=float(np.median(ttft)),
        client_ttft_ms_p99=float(np.percentile(ttft, 99)),
        client_inter_token_ms_p50=float(np.median(gaps)),
        client_inter_token_ms_p99=float(np.percentile(gaps, 99)),
        server_ttft_ms_p50=float(np.median(server_ttft)),
        server_ttft_ms_p99=float(np.percentile(server_ttft, 99)),
        server_inter_token_ms_p50=float(np.median(server_itl)),
        server_inter_token_ms_p99=float(np.percentile(server_itl, 99)),
        speculate_drafts=drafts)
    log(f"  /generate: {json.dumps(numbers['generate'])}")
    if not (ok_plain and ok_stream and ok_spec and drafts > 0):
        raise AssertionError(f"11b /generate: {numbers['generate']}")

    # /adopt: the prefill-role server's segments into the attached engine
    adopt = []
    for i in SERVE_ADOPT:
        t = time.perf_counter()
        status, seg, hdr = post(pre_srv.url + "/generate", {
            "prompt": prompts[i].tolist(), "max_new_tokens": n_new})
        t_pre = time.perf_counter() - t
        t = time.perf_counter()
        toks, fin, t0s, ts = stream_tokens(
            url + f"/adopt?max_new_tokens={n_new}&stream=1", seg)
        adopt.append(dict(prompt=len(prompts[i]), segment_bytes=len(seg),
                          prefill_hop_ms=t_pre * 1e3,
                          adopt_first_token_ms=(ts[0] - t0s) * 1e3,
                          adopt_total_ms=(time.perf_counter() - t) * 1e3,
                          bit_equal=toks == dense_tokens[i]
                          and status == 200))
    counts, plain_calls, realigned = read_counts(fa)
    pre_srv.close(timeout=600)
    release(pre)
    numbers["adopt"] = adopt
    log(f"  /adopt: {json.dumps(adopt)}")
    if not all(a["bit_equal"] for a in adopt):
        raise AssertionError(f"11b /adopt: {adopt}")
    check_engine_counts((gen, pre), counts, plain_calls, realigned,
                        "11b HTTP generation (/generate and /adopt)", False)
    if not captured_once(gen):
        raise AssertionError(f"11b: captures {gen.introspect()['captures']}")

    # /swap at full width: a second set of weights written as a checkpoint
    # (pickled numpy, as io.save writes them), swapped in over HTTP, then
    # reverted; a drifted checkpoint first
    names = gen._weight_names()
    ptrs = {n: gen.scope.find_var(n).data_ptr() for n in names}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_swap_") as d:
        drift = os.path.join(d, "drift")
        os.makedirs(drift)
        with open(os.path.join(drift, "__params__"), "wb") as f:
            pickle.dump({names[0]: np.zeros((3, 3), "float32")}, f)
        status, body, _ = post(url + "/swap", {"dir": drift,
                                               "target": "generate"})
        drift_code = status
        t = time.perf_counter()
        g = torch.Generator(device=gen.device).manual_seed(SERVE_SEEDS[1])
        second = {}
        for n in names:
            live = gen.scope.find_var(n)
            second[n] = (torch.randn(live.shape, generator=g,
                                     device=live.device) * 0.02).cpu(
                ).numpy()
        good = gen_second_dir
        os.makedirs(good)
        with open(os.path.join(good, "__params__"), "wb") as f:
            pickle.dump(second, f, protocol=5)
        del second
        write_s = time.perf_counter() - t
        t = time.perf_counter()
        status, body, _ = post(url + "/swap", {"dir": good,
                                               "target": "generate"})
        swap_wall = time.perf_counter() - t
        swap = json.loads(body)
    # the swap took effect: the live storage holds the second set bit
    # for bit (drawn again from its seed), and the swapped engine's
    # stream equals a fresh engine's over that storage
    g = torch.Generator(device=gen.device).manual_seed(SERVE_SEEDS[1])
    stale = []
    for n in names:
        live = gen.scope.find_var(n)
        if not torch.equal(live, torch.randn(live.shape, generator=g,
                                             device=live.device) * 0.02):
            stale.append(n)
    s_status, s_body, _ = post(url + "/generate", {
        "prompt": prompts[0].tolist(), "max_new_tokens": 16,
        "speculate": False})
    swapped_tokens = json.loads(s_body)["tokens"] if s_status == 200 \
        else None
    fresh = paged_engine(tpt.Scope(parent=scope), engine=GEN_ENGINE,
                         prefix_reuse=False, prefill_chunk=0)
    fresh.start()
    fresh_tokens = fresh.generate(prompts[0], 16, timeout=600)["tokens"]
    release(fresh)
    t = time.perf_counter()
    r_status, r_body, _ = post(url + "/swap", {"revert": True,
                                               "target": "generate"})
    revert_wall = time.perf_counter() - t
    revert = json.loads(r_body)
    gen._prev_weights = {}  # the host copy of the second set goes
    after = concurrently(stream_tokens, [
        (url + "/generate", {"prompt": p.tolist(), "max_new_tokens": n_new,
                             "stream": True, "speculate": False})
        for p in prompts])
    ok_after = all(toks == w for (toks, _, _, _), w
                   in zip(after, dense_tokens))
    moved = [n for n in names if gen.scope.find_var(n).data_ptr() != ptrs[n]]
    numbers["swap"] = dict(
        drift_status=drift_code, swap_status=status,
        swap_ms=swap.get("swap_ms"), swap_wall_ms=swap_wall * 1e3,
        checkpoint_write_s=write_s, revert_status=r_status,
        revert_ms=revert.get("swap_ms"), revert_wall_ms=revert_wall * 1e3,
        weights_version=revert.get("weights_version"),
        weights_not_swapped=len(stale),
        swapped_tokens_equal_fresh_engine=swapped_tokens == fresh_tokens,
        swapped_tokens_differ=swapped_tokens != dense_tokens[0][:16],
        streams_after_revert_bit_equal=ok_after,
        data_ptr_moved=len(moved), captured_once=captured_once(gen))
    log(f"  /swap at full width: {json.dumps(numbers['swap'])}")
    if not (drift_code == 409 and status == 200 and r_status == 200
            and not stale and swapped_tokens == fresh_tokens
            and swapped_tokens != dense_tokens[0][:16]
            and ok_after and not moved and captured_once(gen)):
        raise AssertionError(f"11b /swap: {numbers['swap']}")

    # close(drain=True): every queued request answered, no thread left
    futs = [eng.submit(f) for f in feeds[:16]]
    srv.close(timeout=600)
    drained = all(f.done() and same_outputs(f.result(0), w)
                  for f, w in zip(futs, want))
    left = [t.name for t in threading.enumerate()
            if t.name.startswith(("serving-worker", "generation-scheduler"))]
    numbers["drain"] = dict(answered_bit_equal=drained, threads_left=left)
    log(f"  close(drain=True): {json.dumps(numbers['drain'])}")
    if not drained or left:
        raise AssertionError(f"11b drain: {numbers['drain']}")
    release(gen)
    pred.close()
    SERVING["http"] = numbers
    return counts, fresh_tokens


# -- phase 12: the fleet ----------------------------------------------------

FLEET_SERVE_ARGV = ("--workers", "1", "--max-batch", "8", "--max-delay-ms",
                    "5", "--queue-cap", "256", "--deadline-ms", "600000",
                    "--device", "cuda")
FLEET_GEN_ARGV = ("--generate", "--gen-paged", "--gen-vocab", "32000",
                  "--gen-hidden", "4096", "--gen-layers",
                  str(GEN["num_layers"]),
                  "--gen-heads", "32", "--gen-intermediate", "11008",
                  "--gen-slots", "4", "--gen-max-seq", "1024",
                  "--gen-max-new", "64", "--gen-page-tokens", "16",
                  "--gen-pages", "257", "--deadline-ms", "600000",
                  "--device", "cuda")
# phase 10's prefill buckets (the replica reads the flag's env var)
FLEET_GEN_ENV = {"FLAGS_serving_prefill_buckets": "64,128,256,512"}
# 12b's two fleets: the colocated reference, then the pair (the
# supervisor pins each replica's role across respawns)
FLEET_GEN_ROLES = {"colocated": ("both",), "pair": ("prefill", "decode")}
FLEET_READY_S = 600.0
FLEET_PROFILE_S = 2.0
# 12b's prefill trace: clients sending new prompts, and its length in
# FLEET_PROFILE_S (the profiler starts recording a second or two into
# it: at 3 clients and 4 s a trace once held a single prefill)
FLEET_PROFILE_CLIENTS = 4
FLEET_PREFILL_TRACE = 3
SERVE_SERIAL = 16
# kernel records in a replica's /profilez trace, by family: the fp32
# forward (kernel #1 in a BERT replica, #4 in a prefill replica), the
# product kernel and the RMSNorm kernel; any other attention kernel
# (tensor-core, backward) must not appear on a forward-only fp32 path
# (tensor-core, backward, the library's) must not appear on a
# forward-only fp32 path, nor any product of the library's
TRACE_FAMILIES = {"fa_fwd_f32": ("fa_fwd_f32_kernel",),
                  "gemm_f32": ("gemm_skinny_kernel", "gemm_tiled_kernel",
                               "gemm_fold_kernel"),
                  "rms_norm_f32": ("rms_norm_rows",),
                  "other_attention": ("fa_fwd_tc_kernel", "fa_dkv_",
                                      "fa_dq_", "flash_fwd", "fmha",
                                      "efficient_attention"),
                  "other_product": ("sgemm", "xmma_gemm", "cutlass",
                                    "gemv", "gemmSN", "gemmk1", "nvjet",
                                    "splitKreduce")}
# what one graph replay of a fleet path holds: the fp32 forward once a
# layer, four products a layer at least (a product may add a fold
# kernel), RMSNorm twice a layer and once before the head (Llama) or not
# at all (BERT)
FLEET_DISPATCH = {"fleet_serving": dict(fa_fwd_f32=12, gemm_f32=4 * 12,
                                        rms_norm_f32=0),
                  "fleet_generation": dict(
                      fa_fwd_f32=GEN["num_layers"],
                      gemm_f32=4 * GEN["num_layers"],
                      rms_norm_f32=2 * GEN["num_layers"] + 1)}
FLEET = {}
# the paths of the kernels line whose "launches_by_path" counts are kernel
# records in the replicas' /profilez traces, not wrapper counts
TRACE_PATHS = ("fleet_serving", "fleet_generation", "chaos_fleet")


def trace_family(event):
    """The TRACE_FAMILIES family of a Chrome trace event that is a kernel
    record, else None."""
    if str(event.get("cat", "")).lower() != "kernel":
        return None
    name = str(event.get("name", ""))
    return next((fam for fam, keys in TRACE_FAMILIES.items()
                 if any(k in name for k in keys)), None)


def trace_records(events):
    """Kernel records of a Chrome trace's events, by TRACE_FAMILIES."""
    out = dict.fromkeys(TRACE_FAMILIES, 0)
    for e in events:
        fam = trace_family(e)
        if fam is not None:
            out[fam] += 1
    return out


def trace_dispatches(events):
    """The kernel records by family of each CUDA graph replay whose
    cudaGraphLaunch call is in the trace, in launch order: a graph's
    kernels carry its launch call's correlation id."""
    launches = {e.get("args", {}).get("correlation"): e.get("ts", 0)
                for e in events
                if str(e.get("cat", "")).lower() == "cuda_runtime"
                and "GraphLaunch" in str(e.get("name", ""))}
    launches.pop(None, None)
    groups = {c: dict.fromkeys(TRACE_FAMILIES, 0) for c in launches}
    for e in events:
        fam = trace_family(e)
        corr = e.get("args", {}).get("correlation")
        if fam is not None and corr in groups:
            groups[corr][fam] += 1
    return [groups[c] for c in sorted(launches, key=launches.get)
            if any(groups[c].values())]


def dispatch_gate(events, path, what):
    """Every graph replay of the trace but the last (the profiler may
    stop inside it) holds what one dispatch of `path` must hold
    (FLEET_DISPATCH): the fp32 forward once a layer, at least its
    products, its RMSNorms, and no other attention or product kernel; at
    least two replays.  Returns the replays' records."""
    want = FLEET_DISPATCH[path]
    dispatches = trace_dispatches(events)
    bad = [d for d in dispatches[:-1]
           if d["fa_fwd_f32"] != want["fa_fwd_f32"]
           or d["gemm_f32"] < want["gemm_f32"]
           or d["rms_norm_f32"] != want["rms_norm_f32"]
           or d["other_attention"] or d["other_product"]]
    if len(dispatches) < 2 or bad:
        raise AssertionError(
            f"{what}: {len(dispatches)} graph replays in the trace, "
            f"{len(bad)} of them short of {want}: {bad[:3]}; "
            f"first kernel events "
            f"{[e for e in events if trace_family(e)][:2]}")
    return dispatches


def profilez_events(url, sec=FLEET_PROFILE_S):
    """GET `url`/profilez?sec=N on a replica (its handler thread traces
    the whole process with torch.profiler for N seconds and writes
    trace.json into the replica's metrics dir): the trace's events.  Logs
    the round trip and the replica's longest /healthz gap meanwhile (the
    profiler's stop and export hold its GIL; the supervisor's liveness
    deadline waits out the capture's mark, observatory.CAPTURE_MARK)."""
    gaps = HealthGaps([url])
    t0 = time.monotonic()
    try:
        status, body = get(f"{url}/profilez?sec={sec}", timeout=300)
    finally:
        gap = gaps.stop()
        log(f"  /profilez?sec={sec} on {url}: round trip "
            f"{time.monotonic() - t0:.2f} s, longest /healthz gap {gap} s")
    doc = json.loads(body)
    if status != 200 or "trace.json" not in doc.get("files", []):
        raise AssertionError(f"/profilez on {url}: {status} {doc}")
    with open(os.path.join(doc["dir"], "trace.json")) as f:
        return json.load(f).get("traceEvents", [])


class HealthGaps:
    """Polls each added URL's /healthz every 100 ms on a thread of its
    own and keeps, per URL, the longest gap between two answers (after
    its first): what the supervisor's liveness deadline would see."""

    def __init__(self, urls=()):
        import threading

        self.last, self.gap_s = {}, {}
        for u in urls:
            self.add(u)
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def add(self, url):
        self.last.setdefault(url, None)
        self.gap_s.setdefault(url, 0.0)

    def _run(self):
        while not self._stop.is_set():
            for u in list(self.last):
                try:
                    get(u + "/healthz", timeout=10)
                except OSError:
                    continue
                now = time.monotonic()
                if self.last[u] is not None:
                    self.gap_s[u] = max(self.gap_s[u], now - self.last[u])
                self.last[u] = now
            self._stop.wait(0.1)

    def stop(self):
        self._stop.set()
        self._t.join(30)
        return max(self.gap_s.values(), default=None)


# the end of a dead replica's log that a failed fleet phase prints, and
# how many such logs at most
DEAD_LOG_BYTES = 3000
DEAD_LOGS = 12


def dead_replica_logs(workdir, what):
    """Print the end of every replica log under `workdir` that shows a
    death: a second life, a bind error (fleet.BIND_ERROR) or a traceback.
    A respawn's log is appended to its slot's, so one life's end and the
    next one's start lie side by side."""
    from paddle_tpu_torch.serving.fleet import BIND_ERROR

    shown = 0
    for root, _, files in sorted(os.walk(workdir)):
        for name in sorted(files):
            if name != "replica.log" or shown >= DEAD_LOGS:
                continue
            path = os.path.join(root, name)
            with open(path, "rb") as f:
                text = f.read().decode("utf-8", "replace")
            if text.count(" listening on ") < 2 and BIND_ERROR not in text \
                    and "Traceback" not in text:
                continue
            shown += 1
            log(f"  {what}: the end of {os.path.relpath(path, workdir)} "
                f"({len(text)} bytes):\n{text[-DEAD_LOG_BYTES:]}")
    log(f"  {what}: {shown} replica log(s) showed a death")


@contextlib.contextmanager
def fleet_workdir(prefix, what):
    """A temporary directory for a fleet's replicas that, when the phase
    inside fails, prints its dead replicas' logs (dead_replica_logs)
    before it is removed; the failure goes on up."""
    with tempfile.TemporaryDirectory(prefix=prefix) as fd:
        try:
            yield fd
        except BaseException:
            dead_replica_logs(fd, what)
            raise


def spawn_fleet(what, **kw):
    """A FleetSupervisor (liveness deadline at its default) and, per
    replica, the seconds from spawn to its first ready /healthz; the
    longest /healthz gap of any replica while they started."""
    from paddle_tpu_torch.serving import FleetSupervisor

    t0 = time.monotonic()
    sup = FleetSupervisor(**kw)
    ready, gaps = {}, HealthGaps()
    deadline = t0 + FLEET_READY_S
    while len(ready) < sup.n and time.monotonic() < deadline:
        for rep in sup._replicas:
            if rep.proc is not None and rep.proc.poll() is not None:
                raise AssertionError(f"{what}: replica {rep.idx} exited "
                                     f"rc={rep.proc.poll()} while starting")
            if rep.idx in ready or not os.path.exists(rep.endpoint_file):
                continue
            try:
                with open(rep.endpoint_file) as f:
                    url = json.load(f)["url"]
                doc = json.loads(get(url + "/healthz", timeout=10)[1])
            except (OSError, ValueError, KeyError):
                continue
            gaps.add(url)
            if doc.get("ready"):
                ready[rep.idx] = time.monotonic() - t0
        time.sleep(0.1)
    urls = sup.wait_ready(timeout_s=max(1.0, deadline - time.monotonic()))
    gap = gaps.stop()
    log(f"  {what}: {sup.n} replica(s) at {urls}, spawn to ready "
        f"{json.dumps(ready)} s, longest /healthz gap while starting "
        f"{gap} s")
    return sup, urls, ready, gap


def routed(sup, **kw):
    from paddle_tpu_torch.serving import Router, RouterServer

    router = Router(sup.endpoints(), **dict(dict(poll_interval_ms=100.0),
                                            **kw))
    server = RouterServer(router, host="127.0.0.1").start()
    deadline = time.monotonic() + 60
    while router.stats()["routable"] < sup.n:
        if time.monotonic() > deadline:
            raise AssertionError(f"fleet never routable: {router.stats()}")
        router.poll_once()
        time.sleep(0.05)
    return router, server


def closed_rows(eng_outs, want):
    """A /predict answer's outputs (JSON lists) against `want` (the
    arrays Predictor.run gave for the same rows alone): tolerance 0."""
    return len(eng_outs) == len(want) and all(
        np.array_equal(np.asarray(o, dtype=w.dtype), w) and
        np.asarray(o).shape == w.shape for o, w in zip(eng_outs, want))


def http_closed_loop(url, feeds, want, clients=SERVE_CLIENTS, rounds=1,
                     stop=None):
    """Passes of the closed loop of `feeds` through POST `url`/predict by
    `clients` threads, `rounds` of them or, with `stop` (an Event), until
    it is set after a pass: per request the status, whether a 200's
    outputs equal `want` (tolerance 0), the client's and the replica's
    latency (its "ms"); the walls of the passes."""
    import threading

    bodies = [json.dumps({"inputs": {n: a.tolist() for n, a in f.items()}}
                         ).encode() for f in feeds]
    recs, walls = [], []
    while True:
        nxt, lock = [0], threading.Lock()
        got = [None] * len(feeds)

        def client():
            while True:
                with lock:
                    i = nxt[0]
                    nxt[0] += 1
                if i >= len(feeds):
                    return
                t = time.perf_counter()
                try:
                    status, body, _ = post(url + "/predict", bodies[i])
                except OSError as e:
                    got[i] = dict(status=None, error=str(e))
                    continue
                ms = (time.perf_counter() - t) * 1e3
                t = time.perf_counter()
                doc = json.loads(body)
                parse_ms = (time.perf_counter() - t) * 1e3
                got[i] = dict(status=status, client_ms=ms, bytes=len(body),
                              parse_ms=parse_ms,
                              replica_ms=doc.get("ms"),
                              equal=status == 200 and closed_rows(
                                  doc["outputs"], want[i]),
                              reason=doc.get("reason"))

        threads = [threading.Thread(target=client) for _ in range(clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        walls.append(time.perf_counter() - t0)
        recs += got
        if (stop.is_set() if stop is not None else len(walls) >= rounds):
            return recs, walls


def traffic_gate(recs, what):
    """Every request answered or shed (503), every answer bit-equal;
    returns the sheds."""
    bad = [r for r in recs if r is None or (r["status"] != 503 and not (
        r["status"] == 200 and r["equal"]))]
    if bad:
        raise AssertionError(f"12a {what}: {len(bad)} of {len(recs)} "
                             f"requests failed or differ: {bad[:3]}")
    return sum(1 for r in recs if r["status"] == 503)


def in_background(fn, *args, **kw):
    """Run fn(*args, **kw) on a thread; the returned join() gives its
    result (or raises its exception)."""
    import threading

    box = {}

    def run():
        try:
            box["out"] = fn(*args, **kw)
        except BaseException as e:  # noqa: BLE001 — re-raised in join
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()

    def join():
        t.join(900)
        if "err" in box:
            raise box["err"]
        return box["out"]

    return join


def background_traffic(url, feeds, want):
    """Closed-loop traffic on a thread until the returned stop() is
    called; stop() gives its records."""
    import threading

    ev = threading.Event()
    join = in_background(http_closed_loop, url, feeds, want, stop=ev)

    def stop():
        ev.set()
        return join()[0]

    return stop


def wait_ready_again(rep, old_pid, t0):
    """Seconds from `t0` until slot `rep` runs a new life answering
    ready."""
    while True:
        h = None
        if rep.proc.pid != old_pid and rep.url:
            try:
                h = json.loads(get(rep.url + "/healthz", timeout=5)[1])
            except OSError:
                h = None
        if h and h.get("ready"):
            return time.monotonic() - t0
        if time.monotonic() - t0 > FLEET_READY_S:
            raise AssertionError(f"replica {rep.idx} never came back ready")
        time.sleep(0.1)


def close_fleet(sup, router, server, what):
    """Close the router tier and the fleet; every replica must exit 0
    (a planned exit)."""
    server.close()
    router.close()
    sup.close(timeout_s=120)
    rcs = [r.proc.returncode for r in sup._replicas]
    if rcs != [0] * sup.n:
        raise AssertionError(f"{what}: replicas exited {rcs} at close")
    return rcs


def serial_hops(router_url, replica_url, feeds, want):
    """One request at a time, each straight to a replica and then
    through the router: p50 of the replica's own ms, of what the direct
    request adds to it (the reply's JSON and the socket) and of what
    the router adds to the direct request (its hop)."""
    direct, routed = (http_closed_loop(u, feeds, want, clients=1)[0]
                      for u in (replica_url, router_url))
    for recs, what in ((direct, "straight to a replica"),
                       (routed, "through the router")):
        traffic_gate(recs, f"one at a time, {what}")
    med = lambda xs: float(np.median(xs))  # noqa: E731
    return dict(requests=len(feeds),
                replica_ms_p50=med([r["replica_ms"] for r in direct]),
                reply_ms_p50=med([r["client_ms"] - r["replica_ms"]
                                  for r in direct]),
                router_hop_ms_p50=med([b["client_ms"] - a["client_ms"]
                                       for a, b in zip(direct, routed)]),
                parse_ms_p50=med([r["parse_ms"] for r in direct]),
                mb_p50=med([r["bytes"] / 2 ** 20 for r in direct]))


def fleet_serving(workdir, second_dir, feeds, want, want_second,
                  in_process, loadgen_dir):
    """Phase 12a: 11a's saved BERT-base served by two replica processes
    behind the router.  Gates (tolerance 0): every routed answer equals
    Predictor.run of its rows alone; every replica's /statusz names the
    card; a /profilez trace during traffic holds kernel #1's and the
    product kernel's records; a SIGKILLed replica is respawned at its
    URL, ejected and recovered by the router, no request failing except
    by shedding; a rolling restart under traffic with zero non-shed
    failures and every exit code 0; a hot swap to the second seed's
    weights answered as a fresh Predictor on them; every replica exits
    0 at close.  Before the close, phase 13a's load generator drives the
    fleet through the router (loadgen_fleet; its reports in
    `loadgen_dir`).  Returns the trace's kernel records."""
    import torch

    argv = ["--model-dir", workdir]
    for n in feeds[0]:
        argv += ["--shape", f"{n}={SERVE_BERT['seq_len']}"]
    argv += list(FLEET_SERVE_ARGV)
    out = {}
    with fleet_workdir("chip_smoke_fleet_", "12a") as fd:
        sup, urls, ready, gap = spawn_fleet(
            "12a BERT-base", replicas=2, replica_argv=argv, workdir=fd)
        out["startup_s"], out["startup_healthz_gap_s"] = ready, gap
        router = server = None
        try:
            router, server = routed(sup)
            card = torch.cuda.get_device_name(0)
            for u in urls:
                if card not in get(u + "/statusz")[1].decode():
                    raise AssertionError(f"12a: {u}/statusz does not name "
                                         f"{card}")

            recs, walls = http_closed_loop(server.url, feeds, want,
                                           rounds=SERVE_ROUNDS)
            shed = traffic_gate(recs, "traffic")
            rows = sum(f["input_ids"].shape[0] for f in feeds)
            wall = float(np.median(walls))
            client = np.asarray([r["client_ms"] for r in recs])
            replica = np.asarray([r["replica_ms"] for r in recs])
            hop = client - replica
            out["traffic"] = dict(
                requests=len(feeds), rows=rows, rounds=SERVE_ROUNDS,
                shed=shed, wall_s=wall, round_walls_s=walls,
                requests_per_s=len(feeds) / wall, rows_per_s=rows / wall,
                in_process_2_workers=dict(
                    requests_per_s=in_process["requests_per_s"],
                    rows_per_s=in_process["rows_per_s"]),
                client_ms_p50=float(np.percentile(client, 50)),
                client_ms_p99=float(np.percentile(client, 99)),
                replica_ms_p50=float(np.percentile(replica, 50)),
                replica_ms_p99=float(np.percentile(replica, 99)),
                router_hop_ms_p50=float(np.percentile(hop, 50)),
                router_hop_ms_p99=float(np.percentile(hop, 99)),
                response_mb_mean=float(np.mean([r["bytes"] for r in recs])
                                       / 2 ** 20),
                client_parse_ms_p50=float(np.percentile(
                    [r["parse_ms"] for r in recs], 50)))
            log("  12a traffic: " + json.dumps(out["traffic"]))
            out["serial"] = serial_hops(server.url, urls[0],
                                        feeds[:SERVE_SERIAL], want)
            log("  12a one request at a time: " + json.dumps(out["serial"]))

            # a /profilez trace of replica 0 while traffic runs
            stop = background_traffic(server.url, feeds, want)
            time.sleep(0.3)
            events = profilez_events(urls[0])
            traffic_gate(stop(), "traffic while profiling")
            records = trace_records(events)
            out["trace_records"] = records
            dispatches = dispatch_gate(events, "fleet_serving",
                                       "12a /profilez trace")
            out["trace_dispatches"] = len(dispatches)
            log(f"  12a /profilez trace of replica 0: kernel records "
                f"{records}; {len(dispatches)} graph replays, each but "
                f"the last holding one dispatch's "
                f"{FLEET_DISPATCH['fleet_serving']} at least: "
                f"{dispatches}")
            if records["other_attention"] or records["other_product"]:
                raise AssertionError(f"12a trace records {records}")

            # SIGKILL replica 0 mid-traffic
            before = dict(router.stats()["counters"])
            victim = sup._replicas[0]
            old_pid = victim.proc.pid
            stop = background_traffic(server.url, feeds, want)
            time.sleep(0.5)
            t_kill = time.monotonic()
            os.kill(old_pid, 9)
            respawn_s = wait_ready_again(victim, old_pid, t_kill)
            deadline = time.monotonic() + 60
            while router.stats()["routable"] < 2:
                if time.monotonic() > deadline:
                    raise AssertionError("12a: the respawned replica was "
                                         "never recovered")
                time.sleep(0.1)
            time.sleep(0.5)  # some traffic through the recovered fleet
            recs = stop()
            after = router.stats()["counters"]
            out["sigkill"] = dict(
                requests=len(recs),
                shed=traffic_gate(recs, "traffic through a SIGKILL"),
                respawn_s=respawn_s, url_kept=victim.url == urls[0],
                attribution=victim.last_death["attribution"],
                ejections=after["ejections"] - before["ejections"],
                recoveries=after["recoveries"] - before["recoveries"],
                retries=after["retries"] - before["retries"])
            log("  12a SIGKILL: " + json.dumps(out["sigkill"]))
            if not (out["sigkill"]["url_kept"]
                    and out["sigkill"]["ejections"] >= 1
                    and out["sigkill"]["recoveries"] >= 1
                    and out["sigkill"]["attribution"] == "signal:SIGKILL"):
                raise AssertionError(f"12a SIGKILL: {out['sigkill']}")

            # rolling restart under traffic
            stop = background_traffic(server.url, feeds, want)
            t0 = time.monotonic()
            report = sup.rolling_restart(ready_timeout_s=FLEET_READY_S)
            rolling_s = time.monotonic() - t0
            recs = stop()
            rcs = [e.get("exit_rc") for e in report["replicas"]]
            out["rolling_restart"] = dict(
                seconds=rolling_s, exit_rcs=rcs, requests=len(recs),
                shed=traffic_gate(recs, "traffic through the rolling "
                                  "restart"),
                successors_ready=[e.get("successor_ready")
                                  for e in report["replicas"]])
            log("  12a rolling restart: "
                + json.dumps(out["rolling_restart"]))
            if rcs != [0, 0] or not all(
                    out["rolling_restart"]["successors_ready"]):
                raise AssertionError(f"12a rolling restart: {report}")

            # hot swap to the second seed's weights
            t0 = time.monotonic()
            gaps = HealthGaps(sup.endpoints())
            rep = sup.hot_swap(second_dir, ready_timeout_s=FLEET_READY_S)
            swap_s = time.monotonic() - t0
            swap_gap = gaps.stop()
            versions = [json.loads(get(u + "/healthz")[1])[
                "weights_version"] for u in sup.endpoints()]
            if not rep["converged"] or len(set(versions)) != 1 \
                    or versions[0] < 2:
                raise AssertionError(f"12a hot swap: {rep}, versions "
                                     f"{versions}")
            sub = feeds[:SERVE_SWAP_REQUESTS]
            recs, _ = http_closed_loop(server.url, sub, want_second)
            traffic_gate(recs, "answers after the hot swap")
            for u in sup.endpoints():
                traffic_gate(http_closed_loop(u, sub[:4], want_second[:4],
                                              clients=4)[0],
                             f"{u} after the hot swap")
            out["hot_swap"] = dict(
                seconds=swap_s, converged=rep["converged"],
                weights_versions=versions,
                fallbacks=[r.get("fallback") for r in rep["replicas"]],
                longest_healthz_gap_s=swap_gap)
            log("  12a hot swap (answers equal a fresh Predictor on the "
                "second weights): " + json.dumps(out["hot_swap"]))
            loadgen_fleet(server.url, urls[0],
                          out["traffic"]["requests_per_s"], loadgen_dir)
            out["close_exit_rcs"] = close_fleet(sup, router, server, "12a")
        finally:
            if server is not None:
                server.close()
                router.close()
            sup.close(timeout_s=120)
    FLEET["serving"] = out
    return out["trace_records"]


def generate_http(url, prompt, stream):
    """One /generate of GEN_NEW_TOKENS through `url`: (tokens, finish,
    the client's TTFT ms and inter-token ms list for a stream)."""
    body = {"prompt": [int(t) for t in prompt],
            "max_new_tokens": GEN_NEW_TOKENS}
    if not stream:
        status, raw, _ = post(url + "/generate", body)
        doc = json.loads(raw)
        if status != 200:
            raise AssertionError(f"/generate: {status} {doc}")
        return doc["tokens"], doc["finish"], None, None
    body["stream"] = True
    toks, final, t0, times = stream_tokens(url + "/generate", body)
    if final is None or final.get("error"):
        raise AssertionError(f"streamed /generate ended {final}")
    return (toks, final.get("finish"), (times[0] - t0) * 1e3,
            list(np.diff(times) * 1e3))


def generate_all(url, prompts, stream):
    """The prompts' /generate requests, all at once: (tokens by prompt,
    finishes, wall seconds, TTFTs, inter-token ms)."""
    t0 = time.perf_counter()
    res = concurrently(generate_http, [(url, p, stream) for p in prompts])
    wall = time.perf_counter() - t0
    return ([r[0] for r in res], [r[1] for r in res], wall,
            [r[2] for r in res if r[2] is not None],
            [x for r in res if r[3] for x in r[3]])


def brief(summary):
    """A latency summary's count, p50 and p99."""
    return {k: summary.get(k) for k in ("count", "p50", "p99")}


def pct(xs, q):
    return float(np.percentile(np.asarray(xs), q)) if len(xs) else None


def disagg_counters_ok(counters, n_prompts):
    """The router's counters after 12b's pair served the prompts plain
    and streamed: every one of the 2 n generations went through the
    prefill -> /adopt -> decode pipeline, none lost its decode replica."""
    return (counters["disagg_generations"] == 2 * n_prompts
            and counters["affinity_lost"] == 0)


def generation_swap(sup, router_url, checkpoint_dir, prompt,
                    want_swapped, want_first):
    """12b's hot swap: FleetSupervisor.hot_swap(target="generate") of the
    colocated replica to the second weights phase 11b wrote (7.01 GiB,
    read by the replica inside its POST /swap), /healthz polled every
    100 ms meanwhile.  Gates: swapped in place (200, no restart fallback,
    no liveness kill), the generation engine at weights_version 2, and
    the prompt's tokens through the router equal phase 11b's fresh
    engine's on the second weights (tolerance 0) and differ from the
    first weights'."""
    victim = sup._replicas[0]
    kills = victim.hung_kills
    gaps = HealthGaps(sup.endpoints())
    t0 = time.monotonic()
    res = sup.hot_swap(checkpoint_dir, ready_timeout_s=FLEET_READY_S,
                       target="generate")
    seconds = time.monotonic() - t0
    gap = gaps.stop()
    (entry,) = res["replicas"]
    health = json.loads(get(sup.endpoints()[0] + "/healthz")[1])
    status, body, _ = post(router_url + "/generate", {
        "prompt": [int(t) for t in prompt],
        "max_new_tokens": len(want_swapped)})
    tokens = json.loads(body).get("tokens") if status == 200 else None
    out = dict(seconds=seconds, swap_ms=entry.get("swap_ms"),
               swap_status=entry.get("swap_status"),
               fallback=entry.get("fallback"), converged=res["converged"],
               weights_version=health["generation"]["weights_version"],
               hung_kills=victim.hung_kills - kills,
               longest_healthz_gap_s=gap,
               liveness_timeout_s=sup._liveness_s,
               tokens_equal_fresh_engine=tokens == list(want_swapped),
               tokens_differ_from_first=tokens != list(
                   want_first[:len(want_swapped)]))
    log("  12b hot swap of the generation weights: "
        + json.dumps(out))
    if not (res["converged"] and out["swap_status"] == 200
            and not out["fallback"] and out["hung_kills"] == 0
            and out["weights_version"] == 2
            and out["tokens_equal_fresh_engine"]
            and out["tokens_differ_from_first"]):
        raise AssertionError(f"12b hot swap: {out} {res}")
    return out


def fleet_generation(gen_second_dir, swapped_tokens, loadgen_dir):
    """Phase 12b: Llama-2-7B's widths (GEN's 8 layers, fp32, 4 slots x 1024, 257 pages
    of 16) in replica processes behind the router.  A one-replica fleet
    in role "both" answers GEN_PROMPTS through /generate (the colocated
    reference), is hot-swapped to phase 11b's second weights
    (`gen_second_dir`; generation_swap) and closes; then a prefill-role
    and a decode-role replica serve the prompts through the router's
    prefill -> /adopt -> decode pipeline.  Gates (tolerance 0): the
    swap's (generation_swap: the first prompt's tokens equal
    `swapped_tokens`); the disaggregated tokens, plain and streamed,
    equal the colocated ones; disagg_generations 16 and affinity_lost 0;
    a /profilez trace of the prefill replica during prefills holds kernel
    #4's fp32 forward and the product and RMSNorm kernels' records, every
    graph replay but the last one whole prefill's (dispatch_gate); every
    replica exits 0 at close.  Between the colocated reference and the
    swap, phase 13a's load generator streams generations from the
    colocated replica (loadgen_generate; its report in `loadgen_dir`).
    Returns the trace's kernel records."""
    prompts = gen_prompts(GEN_PROMPTS, GEN["vocab_size"], 32)
    n_tokens = len(prompts) * GEN_NEW_TOKENS
    out = {}
    with fleet_workdir("chip_smoke_genfleet_", "12b") as fd:
        sup, urls, ready, gap = spawn_fleet(
            "12b colocated", roles=list(FLEET_GEN_ROLES["colocated"]),
            replica_argv=FLEET_GEN_ARGV, env=FLEET_GEN_ENV,
            workdir=os.path.join(fd, "both"))
        router = server = None
        try:
            router, server = routed(sup)
            want, finish, wall, _, _ = generate_all(server.url, prompts,
                                                    False)
            if any(f != "length" or len(t) != GEN_NEW_TOKENS
                   for t, f in zip(want, finish)):
                raise AssertionError(f"12b colocated: finishes {finish}")
            out["colocated"] = dict(startup_s=ready[0],
                                    startup_healthz_gap_s=gap,
                                    tokens=n_tokens, wall_s=wall,
                                    tokens_per_s=n_tokens / wall)
            log("  12b colocated through the router: "
                + json.dumps(out["colocated"]))
            loadgen_generate(urls[0], loadgen_dir)
            out["hot_swap"] = generation_swap(
                sup, server.url, gen_second_dir, prompts[0],
                swapped_tokens, want[0])
            close_fleet(sup, router, server, "12b colocated")
        finally:
            if server is not None:
                server.close()
                router.close()
            sup.close(timeout_s=120)

        sup, urls, ready, gap = spawn_fleet(
            "12b prefill / decode", roles=list(FLEET_GEN_ROLES["pair"]),
            replica_argv=FLEET_GEN_ARGV, env=FLEET_GEN_ENV,
            workdir=os.path.join(fd, "pair"))
        router = server = None
        try:
            router, server = routed(sup)
            if not router.disagg_active():
                raise AssertionError("12b: the router sees no prefill / "
                                     "decode pair")
            got, finish, wall, _, _ = generate_all(server.url, prompts,
                                                   False)
            plain_equal = got == want
            got_s, _, wall_s, ttft, itl = generate_all(server.url, prompts,
                                                       True)
            stream_equal = got_s == want
            counters = router.stats()["counters"]
            pre, dec = (json.loads(get(u + "/healthz")[1])["generation"]
                        for u in urls)

            # a /profilez trace of the prefill replica while prompts of
            # the longest length, each new (no prefix hit), are prefilled
            records, n_dispatches = profile_prefills(server.url, urls[0])
            out["pair"] = dict(
                startup_s={"prefill": ready[0], "decode": ready[1]},
                startup_healthz_gap_s=gap,
                plain_bit_equal=plain_equal, stream_bit_equal=stream_equal,
                tokens=n_tokens, plain_wall_s=wall,
                tokens_per_s=n_tokens / wall, stream_wall_s=wall_s,
                tokens_per_s_stream=n_tokens / wall_s,
                client_ttft_ms_p50=pct(ttft, 50),
                client_ttft_ms_p99=pct(ttft, 99),
                client_inter_token_ms_p50=pct(itl, 50),
                client_inter_token_ms_p99=pct(itl, 99),
                decode_replica_ttft_ms=brief(dec["ttft_ms"]),
                decode_replica_inter_token_ms=brief(dec["inter_token_ms"]),
                prefill_replica_prefill_ms=brief(pre["prefill_ms"]),
                export_ms=brief(pre["segment_export_ms"]),
                adopt_ms=brief(dec["segment_adopt_ms"]),
                disagg_generations=counters["disagg_generations"],
                affinity_lost=counters["affinity_lost"],
                trace_records=records, trace_dispatches=n_dispatches)
            log("  12b prefill / decode through the router: "
                + json.dumps(out["pair"]))
            if not (plain_equal and stream_equal
                    and disagg_counters_ok(counters, len(prompts))):
                raise AssertionError(f"12b: {out['pair']}")
            if records["other_attention"] or records["other_product"]:
                raise AssertionError(f"12b trace records {records}")
            close_fleet(sup, router, server, "12b prefill / decode")
        finally:
            if server is not None:
                server.close()
                router.close()
            sup.close(timeout_s=120)
    FLEET["generation"] = out
    return out["pair"]["trace_records"]


def profile_prefills(url, prefill_url):
    """The kernel records of a /profilez trace of the prefill replica
    taken while FLEET_PROFILE_CLIENTS clients send /generate requests
    through the router at `url`, each a new prompt of the longest
    GEN_PROMPTS length (a new prompt has no prefix hit, so its whole
    prefill runs on kernel #4), held to one prefill a graph replay
    (dispatch_gate); and the number of replays."""
    import threading

    stop, n = threading.Event(), [0]
    lock = threading.Lock()

    def client():
        while not stop.is_set():
            with lock:
                i = n[0]
                n[0] += 1
            prompt = gen_prompts((max(GEN_PROMPTS),), GEN["vocab_size"],
                                 4000 + i)[0]
            generate_http(url, prompt, False)

    joins = [in_background(client) for _ in range(FLEET_PROFILE_CLIENTS)]
    time.sleep(0.5)
    events = profilez_events(prefill_url,
                             sec=FLEET_PREFILL_TRACE * FLEET_PROFILE_S)
    stop.set()
    for j in joins:
        j()
    records = trace_records(events)
    dispatches = dispatch_gate(events, "fleet_generation",
                               "12b /profilez trace")
    log(f"  12b /profilez trace of the prefill replica ({n[0]} prompts "
        f"of {max(GEN_PROMPTS)} tokens sent meanwhile): kernel records "
        f"{records}; {len(dispatches)} graph replays, each but the last "
        f"holding one prefill's {FLEET_DISPATCH['fleet_generation']} at "
        f"least: {dispatches}")
    return records, len(dispatches)


def trace_launches(records, index):
    """A fleet path's Launches: the fp32 forward's trace records at
    `index` of the six attention kernels, the product and RMSNorm
    kernels' beside them."""
    counts = [0] * 6
    counts[index] = records["fa_fwd_f32"]
    out = Launches(counts)
    out.gemm, out.rms_norm = records["gemm_f32"], records["rms_norm_f32"]
    return out


def release_card(what):
    """Free what the process's caching allocator holds; print what stays
    reserved."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved() / 2 ** 30
    log(f"  {what}: {reserved:.2f} GiB reserved, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    return reserved


# -- phase 13: the port's load generator and chaos harness -----------------

# 13a in process: 11a's engine settings (1 worker, max batch 8, 5 ms), a
# closed loop of 64 one-row requests at 16 clients, then an open loop at
# half 11a's 1-worker requests/s for 5 s
LOADGEN_ENGINE = ("--workers", "1", "--max-batch", "8", "--max-delay-ms",
                  "5")
LOADGEN_CLOSED = ("--requests", "64", "--concurrency", "16")
LOADGEN_OPEN_S = 5.0
# 13a through 12a's router at half 12a's requests/s: a burst-shaped open
# loop under generous budgets, an impossible p99, then 4 tenants through
# the router and straight to a replica
LOADGEN_BURST_S = 10.0
LOADGEN_SLO_FAIL_S = 3.0
LOADGEN_TENANTS = ("--mode", "closed", "--requests", "32", "--concurrency",
                   "8", "--tenants", "4", "--tenant-dist", "uniform",
                   "--slo-tenant-p99-ms", "600000")
# 13a against 12b's colocated replica: 8 streamed requests at 4 clients,
# prompts of 20-500 tokens, 64 new tokens each (an output-length mean far
# above the clamp gives every request the clamp)
LOADGEN_GEN = ("--generate", "--gen-stream", "--mode", "closed",
               "--requests", "8", "--concurrency", "4", "--gen-prompt-min",
               "20", "--gen-prompt-max", "500", "--gen-out-mean", "1e9",
               "--gen-out-max", "64", "--gen-vocab", "32000",
               "--gen-max-seq", "1024")
# 13b: the chaos harness.  Its /predict fleets serve BERT-base's encoder
# output at the first position, [B, 768] (a sentence-embedding reply),
# from 11a's model built again with the slice op; 1-row requests; the
# poison sentinel in the float32 attn_mask feed
CHAOS_REPLICAS = 3
CHAOS_SEED = 41
# one worker a replica, max batch 8 (the harness's), and a batch held open
# 10 ms for riders: the router spreads a rate the host bounds over three
# replicas, so at the harness's 2 ms (one H100, ~93 requests/s) none of
# 427 poisoned requests shared a batch, and none was bisected
CHAOS_ENGINE = ("--workers", "1", "--max-delay-ms", "10")
# the closed-loop probe that sets the harness's rate and forward timeout:
# requests, clients
CHAOS_PROBE = (256, 32)
# each replica's swap commit widened by one delay a weight array (149
# arrays: ~0.6 s, the reference MLP's 4 x 150 ms)
CHAOS_SWAP_FAULT = "weight_swap:delay:4~1.0"
# poison_paged and spec_storm: GEN (8 layers) in this process,
# paged (pages of 16) and, for spec_storm, speculating as phase 10c runs
CHAOS_GEN_ENGINE = dict(num_slots=4, max_seq_len=1024,
                        prefill_buckets=(8, 64, 128, 256, 512),
                        page_tokens=16)
# disagg_crash's four replicas: Llama-2-7B's widths at 4 layers (four
# 32-layer replicas, 25.10 GiB each, do not fit in 80 GB); its prompts
# are 4-48 tokens
CHAOS_DISAGG_LAYERS = 4
CHAOS_DISAGG_ARGV = ("--feat", "8", "--hidden", "16", "--depth", "1",
                     "--generate", "--gen-vocab", "32000", "--gen-hidden",
                     "4096", "--gen-layers", str(CHAOS_DISAGG_LAYERS),
                     "--gen-heads", "32", "--gen-intermediate", "11008",
                     "--gen-slots", "4", "--gen-max-seq", "128",
                     "--gen-max-new", "8", "--gen-page-tokens", "16",
                     "--queue-cap", "512", "--deadline-ms", "60000")
CHAOS_DISAGG_ENV = {"FLAGS_serving_prefill_buckets": "64"}
# the supervisor's liveness deadline: the flag's default
CHAOS_LIVENESS_MS = 5000.0
# phase 13's numbers, for the "loadgen:" and "chaos:" lines
LOADGEN = {}
CHAOS = {}


def bert_shape_args():
    S = str(SERVE_BERT["seq_len"])
    return ["--shape", f"input_ids={S}", "--shape", f"token_type_ids={S}",
            "--shape", f"attn_mask={S}"]


def loadgen_main(args, out_path):
    """serving_loadgen.main(args + --out out_path) in this process, the
    report it prints kept off this script's standard output: (rc, the
    report)."""
    import contextlib
    import io

    from paddle_tpu_torch.tools import serving_loadgen

    with contextlib.redirect_stdout(io.StringIO()):
        rc = serving_loadgen.main(list(args) + ["--out", out_path])
    with open(out_path) as f:
        return rc, json.load(f)


def lat(rep, key="latency_ms"):
    """A loadgen latency block's count, p50 and p99."""
    return brief(rep.get(key) or {})


def model_ops(model_dir):
    """The op types of a saved model's program, with their counts."""
    from collections import Counter

    from paddle_tpu_torch import io

    program, _ = io._load_model_payload(model_dir)
    return Counter(op.type for op in program.global_block().ops)


def loadgen_in_process(fa, model_dir, rate_1w, workdir):
    """13a in process: serving_loadgen.main on 11a's saved BERT-base
    (--model-dir, --mode both, --device cuda, 11a's engine settings):
    the closed loop's 64 requests at 16 clients, then the open loop at
    half `rate_1w` (11a's 1-worker requests/s) for LOADGEN_OPEN_S.  The
    counts are set to 0 as the closed loop starts and read as the open
    one ends (the loadgen's drivers wrapped for it), so the engine's
    warmup is not among them.  Gates: rc 0, no failure, closed ok 64, the
    report's engine.batch_fill_pct present, kernel #1 12 times and the
    product kernel once a mul a dispatched batch, no plain call, nothing
    realigned.  Returns the launches."""
    from paddle_tpu_torch.tools import serving_loadgen as lg

    ops = model_ops(model_dir)
    n_attn, n_mul = ops["flash_attention_qkv"], ops["mul"]
    seen = {}
    closed, open_ = lg.run_closed_loop, lg.run_open_loop

    def counted_closed(engine, *a, **kw):
        seen["batches"] = engine.stats()["counters"]["batches"]
        reset_counts(fa)
        return closed(engine, *a, **kw)

    def counted_open(engine, *a, **kw):
        rep = open_(engine, *a, **kw)
        seen["counts"] = read_counts(fa)
        seen["batches"] = (engine.stats()["counters"]["batches"]
                           - seen["batches"])
        return rep

    qps = rate_1w / 2
    lg.run_closed_loop, lg.run_open_loop = counted_closed, counted_open
    t0 = time.perf_counter()
    try:
        rc, rep = loadgen_main(
            ["--model-dir", model_dir] + bert_shape_args()
            + ["--mode", "both", *LOADGEN_CLOSED, "--qps", repr(qps),
               "--duration", repr(LOADGEN_OPEN_S), "--device", "cuda",
               *LOADGEN_ENGINE],
            os.path.join(workdir, "loadgen_in_process.json"))
    finally:
        lg.run_closed_loop, lg.run_open_loop = closed, open_
    seconds = time.perf_counter() - t0
    counts, plain, realigned = seen["counts"]
    batches = seen["batches"]
    c, o = rep["closed"], rep["open"]
    out = dict(
        seconds=seconds,
        closed=dict(requests=c["requests"], ok=c["ok"], shed=c["shed"],
                    failed=c["failed"], requests_per_s=c["qps"],
                    latency_ms=lat(c)),
        open=dict(target_qps=o["target_qps"], requests=o["requests"],
                  ok=o["ok"], shed=o["shed"], failed=o["failed"],
                  requests_per_s=o["qps"], latency_ms=lat(o)),
        batch_fill_pct=(c.get("engine") or {}).get("batch_fill_pct"),
        batches=batches, serving_engine_1_worker_requests_per_s=rate_1w,
        launches=dict(fa_fwd_f32=counts[0], gemm_f32=counts.gemm,
                      plain=plain, realigned=realigned))
    LOADGEN["in_process"] = out
    log("  13a serving_loadgen.main in process (1-row requests; 11a's are "
        "1-3 rows): " + json.dumps(out))
    want = (n_attn * batches, 0, 0, 0, 0, 0)
    if rc != 0 or c["failed"] or o["failed"] or c["ok"] != 64 \
            or "batch_fill_pct" not in (c.get("engine") or {}) \
            or counts != want or counts.gemm != n_mul * batches \
            or plain or realigned or batches <= 0:
        raise AssertionError(
            f"13a in process: rc {rc}, {out}; launches {counts} (want "
            f"{want}), product kernel {counts.gemm} (want "
            f"{n_mul * batches})")
    return counts


def loadgen_fleet(router_url, replica_url, rate, workdir):
    """13a through 12a's router over its two BERT-base replicas, at half
    `rate` (12a's requests/s): a burst-shaped open loop under generous
    budgets (rc 0, a per-phase report, no failure); an impossible p99
    (rc 1, violations labelled by phase, the router's /debugz bundle
    saved); 4 tenants through the router (its /fleetz tenant families
    embedded; the router has no /usagez, so the tenant p99 bound is
    unmeasured there: rc 1 naming it) and straight to a replica (its
    /usagez: every tenant's p99 measured, rc 0)."""
    qps = rate / 2
    base = ["--url", router_url] + bert_shape_args()
    out = {"target_qps": qps}
    rc, rep = loadgen_main(
        base + ["--mode", "open", "--qps", repr(qps), "--duration",
                repr(LOADGEN_BURST_S), "--traffic", "burst",
                "--traffic-amplitude", "1.0", "--slo-p99-ms", "600000",
                "--slo-shed-pct", "50"],
        os.path.join(workdir, "loadgen_burst.json"))
    phases = rep.get("phases") or {}
    out["burst"] = dict(
        rc=rc, requests=rep["requests"], ok=rep["ok"], shed=rep["shed"],
        failed=rep["failed"], requests_per_s=rep["qps"],
        latency_ms=lat(rep),
        phases={k: dict(requests=p["requests"], failed=p["failed"],
                        offered_qps=p["offered_qps"], qps=p["qps"],
                        latency_ms=lat(p)) for k, p in phases.items()})
    if rc != 0 or rep["failed"] or set(phases) != {"burst", "base"} \
            or any(p["failed"] for p in phases.values()):
        raise AssertionError(f"13a burst through the router: {out}")
    rc, rep = loadgen_main(
        base + ["--mode", "open", "--qps", repr(qps), "--duration",
                repr(LOADGEN_SLO_FAIL_S), "--traffic", "sine",
                "--slo-p99-ms", "0.001"],
        os.path.join(workdir, "loadgen_slo.json"))
    bundle = rep["slo"].get("debugz")
    doc = None
    if bundle and os.path.isfile(bundle):
        with open(bundle) as f:
            doc = json.load(f)
    out["impossible_slo"] = dict(
        rc=rc, failed=rep["failed"], violations=rep["slo"]["violations"],
        debugz_bytes=os.path.getsize(bundle) if doc else None)
    if rc != 1 or rep["failed"] or doc is None \
            or doc.get("bundle") != "paddle_tpu.debugz.v1" \
            or not any("[" in v for v in rep["slo"]["violations"]):
        raise AssertionError(f"13a impossible SLO: {out['impossible_slo']}")
    names = [f"tenant-{i:02d}" for i in range(4)]
    for what, url in (("router", router_url), ("replica", replica_url)):
        rc, rep = loadgen_main(
            ["--url", url] + bert_shape_args() + list(LOADGEN_TENANTS),
            os.path.join(workdir, f"loadgen_tenants_{what}.json"))
        usage = rep.get("usage") or {}
        tenants = usage.get("tenants") or {}
        out[f"tenants_{what}"] = dict(
            rc=rc, ok=rep["ok"], failed=rep["failed"],
            violations=rep["slo"]["violations"],
            usage_from="/fleetz" if usage.get("fleet") else "/usagez",
            tenant_p99_ms={t: ((tenants.get(t) or {}).get("request_ms")
                               or {}).get("p99") for t in names})
        fed = json.dumps(usage.get("tenant_families"))
        ok = (rep["failed"] == 0 and rep["ok"] == 32 and (
            rc == 1 and usage.get("fleet") is True
            and all(t in fed for t in names)
            and any("no per-tenant usage breakdown" in v
                    for v in rep["slo"]["violations"])
            if what == "router" else
            rc == 0 and all(out[f"tenants_{what}"]["tenant_p99_ms"][t]
                            is not None for t in names)))
        if not ok:
            raise AssertionError(f"13a tenants through the {what}: "
                                 f"{out[f'tenants_{what}']}")
    LOADGEN["fleet"] = out
    log("  13a serving_loadgen --url through 12a's router: "
        + json.dumps(out))
    return out


def loadgen_generate(replica_url, workdir):
    """13a against 12b's colocated Llama-2-7B replica: --generate --url
    --gen-stream, 8 requests at 4 clients, prompts of 20-500 tokens, 64
    new tokens each.  Gates: rc 0, every request answered with its 64
    tokens, the report's client TTFT and inter-token blocks measured.
    Printed beside the replica's own TTFT and inter-token numbers."""
    rc, rep = loadgen_main(["--url", replica_url] + list(LOADGEN_GEN),
                           os.path.join(workdir, "loadgen_generate.json"))
    gen = json.loads(get(replica_url + "/healthz")[1])["generation"]
    out = dict(rc=rc, requests=rep["requests"], ok=rep["ok"],
               failed=rep["failed"], shed=rep["shed"],
               generated_tokens=rep["generated_tokens"],
               tokens_per_s=rep["tokens_per_sec"], latency_ms=lat(rep),
               client_ttft_ms=lat(rep, "ttft_ms"),
               client_inter_token_ms=lat(rep, "inter_token_ms"),
               replica_ttft_ms=brief(gen["ttft_ms"]),
               replica_inter_token_ms=brief(gen["inter_token_ms"]))
    LOADGEN["generate"] = out
    log("  13a serving_loadgen --generate --gen-stream against 12b's "
        "colocated replica: " + json.dumps(out))
    if rc != 0 or rep["failed"] or rep["ok"] != 8 \
            or rep["generated_tokens"] != 8 * 64 \
            or not (rep.get("ttft_ms") or {}).get("count") \
            or not (rep.get("inter_token_ms") or {}).get("count"):
        raise AssertionError(f"13a generate: {out}")
    return out


def chaos_feeds(seed, n=16):
    """`n` one-row BERT requests from a seed (11a's recipe)."""
    return serving_feeds(n, seed, rows_range=(1, 1))


def json_body(feed):
    return json.dumps({"inputs": {n: np.asarray(a).tolist()
                                  for n, a in feed.items()}}).encode()


def chaos_model(tpt, workdir):
    """BERT-base (seq 128, fp32) serving its encoder output's first
    position [B, 768], built from 11a's encoder with the slice op and
    saved with CHAOS_SEED's weights: the chaos harness's PredictModel (1
    worker a replica; 1-row bodies; the poison sentinel in attn_mask;
    swap checkpoints of other seeds; a fresh Predictor on the saved model
    with a checkpoint swapped in)."""
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.inference import Predictor
    from paddle_tpu_torch.models.bert import bert_encoder
    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.tools.chaos import POISON, PredictModel

    op_seed = registry._OP_SEED[0]
    S = SERVE_BERT["seq_len"]
    main, startup = tpt.Program(), tpt.Program()
    startup._is_startup = True
    with tpt.program_guard(main, startup):
        feeds = [layers.data(n, [-1, S], dtype=dt, append_batch_size=False)
                 for n, dt in (("input_ids", "int64"),
                               ("token_type_ids", "int64"),
                               ("attn_mask", "float32"))]
        enc = bert_encoder(*feeds, **{k: SERVE_BERT[k] for k in (
            "vocab_size", "hidden", "num_layers", "num_heads",
            "intermediate")}, seq_len=S, max_position=max(512, S),
            dropout=0.0, is_test=True, use_flash=True)
        first = layers.squeeze(layers.slice(enc, axes=[1], starts=[0],
                                            ends=[1]), axes=[1])
    registry.reset_op_seed(op_seed)
    names = [v.name for v in feeds]

    def write_checkpoint(dirname, seed):
        exe, scope = tpt.Executor(), tpt.Scope()
        startup.random_seed = seed
        with tpt.scope_guard(scope):
            exe.run(startup)
            tpt.io.save_inference_model(dirname, names, [first], exe,
                                        main_program=main)
        exe.close()

    model_dir = os.path.join(workdir, "bert_first_position")
    write_checkpoint(model_dir, CHAOS_SEED)

    def fresh(checkpoint):
        pred = Predictor(model_dir)
        pred.swap_weights(checkpoint)
        return pred

    poison = chaos_feeds(7, 1)[0]
    poison["attn_mask"][0, 0] = POISON
    return PredictModel(
        ["--model-dir", model_dir] + bert_shape_args() + list(CHAOS_ENGINE),
        lambda seed: [json_body(f) for f in chaos_feeds(seed)],
        json_body(poison), write_checkpoint=write_checkpoint, fresh=fresh,
        probe=chaos_feeds(9, 1)[0], swap_fault=CHAOS_SWAP_FAULT), model_dir


def chaos_probe(model, model_dir):
    """The closed-loop probe of a fleet as the chaos harness spawns it
    (CHAOS_REPLICAS replicas, the shared fleet's argv) behind the router:
    CHAOS_PROBE's requests through serving_loadgen.run_closed_loop_http
    give the rate the fleet sustains and its latency; a /profilez trace of
    one replica under closed-loop traffic holds kernel #1's and the product
    kernel's records, every graph replay but the last one dispatch's, no
    other attention or product kernel (dispatch_gate); every replica exits
    0 at close.  Returns the probe's numbers and the trace's records."""
    import threading

    from paddle_tpu_torch.tools import chaos
    from paddle_tpu_torch.tools import serving_loadgen as lg

    ops = model_ops(model_dir)
    feeds = chaos_feeds(0)
    make_feed = lambda i: feeds[i % len(feeds)]  # noqa: E731
    with fleet_workdir("chip_smoke_chaos_probe_", "13b's probe fleet") as fd:
        sup, urls, ready, gap = spawn_fleet(
            "13b probe fleet", replicas=CHAOS_REPLICAS,
            replica_argv=chaos.shared_fleet_argv(model, "cuda"),
            workdir=fd)
        router = server = None
        try:
            router, server = routed(sup)
            n, clients = CHAOS_PROBE
            rep = lg.run_closed_loop_http(server.url, make_feed, n, clients)
            if rep["ok"] != n:
                raise AssertionError(f"13b probe: {rep}")
            out = dict(startup_s=ready, requests=n, clients=clients,
                       requests_per_s=rep["qps"],
                       latency_ms=lat(rep), ops=dict(ops))
            # closed-loop traffic until the trace is back
            stop = threading.Event()

            def traffic():
                reps = []
                while not stop.is_set():
                    reps.append(lg.run_closed_loop_http(
                        server.url, make_feed, 64, 8))
                return reps

            join = in_background(traffic)
            time.sleep(0.3)
            try:
                events = profilez_events(urls[0])
            finally:
                stop.set()
            bg = join()
            if any(r["failed"] for r in bg):
                raise AssertionError(f"13b traffic while profiling: {bg}")
            records = trace_records(events)
            dispatches = dispatch_gate(events, "fleet_serving",
                                       "13b /profilez trace of a chaos "
                                       "replica")
            out["trace_records"] = records
            out["trace_dispatches"] = len(dispatches)
            if records["other_attention"] or records["other_product"]:
                raise AssertionError(f"13b trace records {records}")
            close_fleet(sup, router, server, "13b probe fleet")
        finally:
            if server is not None:
                server.close()
                router.close()
            sup.close(timeout_s=120)
    log("  13b probe of a chaos fleet: " + json.dumps(out))
    return out


def chaos_settings(probe, respawn_s):
    """The harness's settings from the probe and 12a's SIGKILL respawn:
    half the rate the fleet sustained; a forward timeout four times the
    probe's p99 (at least 1 s); the supervisor's liveness deadline at its
    default; scenarios long enough that a SIGKILL at a quarter of one
    respawns before it ends: 1.6 times the longer of 12a's respawn and
    the probe fleet's spawn to ready (a chaos replica respawns under the
    harness's load, beside two others)."""
    respawn_s = max([respawn_s] + list(probe["startup_s"].values()))
    return dict(qps=probe["requests_per_s"] / 2,
                forward_timeout_ms=max(1000.0,
                                       4.0 * probe["latency_ms"]["p99"]),
                liveness_timeout_ms=CHAOS_LIVENESS_MS,
                duration_s=float(math.ceil(1.6 * respawn_s)))


def chaos_gate(report):
    """The hard gates of 13b's report: no scenario error, no collateral
    failure, no poison leak, no leaked page, no torn version,
    availability >= 99%, report["ok"]; and every recovery path fired: a
    respawn after crash (attributed SIGKILL), a liveness kill after hang,
    a bisection in a replica after poison, drafts verified and slots
    failed by the decode_step fault in spec_storm (its pool drained:
    leaked_pages).  A rejected draft's rollback is not required: the
    seed-0 Llama-2-7B accepts every draft of the scenario's periodic
    prompts (20 drafts, acceptance 1.0, the same in every run), so its
    count is reported.  Returns the failed gates."""
    sc, t = report["scenarios"], report["totals"]
    bad = []
    checks = (
        ("errors", report["errors"] == {}),
        ("collateral_failures", t["collateral_failures"] == 0),
        ("poison_leaks", t["poison_leaks"] == 0),
        ("leaked_pages", t.get("leaked_pages") == 0),
        ("torn_responses", t.get("torn_responses") == 0),
        ("availability", report["availability_pct"] >= 99.0),
        ("ok", report["ok"] is True),
        ("crash respawn", "crash" in sc
         and sc["crash"].get("recovery_s") is not None
         and (sc["crash"]["notes"].get("postmortem") or {}).get(
             "attribution") == "signal:SIGKILL"),
        ("hang liveness kill", "hang" in sc
         and sc["hang"]["notes"].get("hung_kills_after", 0)
         > sc["hang"]["notes"].get("hung_kills_before", 0)),
        ("poison bisection", "poison" in sc
         and sc["poison"]["notes"].get("bisections", 0) >= 1),
        ("spec_storm speculated through the fault", "spec_storm" in sc
         and ((sc["spec_storm"]["notes"].get("spec") or {}).get(
             "drafts") or 0) >= 1
         and (sc["spec_storm"]["notes"].get("fault_victims") or 0) >= 1))
    for name, ok in checks:
        if not ok:
            bad.append(name)
    return bad


def chaos_flagship(fa, model, settings):
    """13b: run_chaos with every port scenario at full width: the shared
    and the hot_swap / noisy_neighbor fleets of CHAOS_REPLICAS BERT-base
    replicas (`model`), poison_paged and spec_storm on Llama-2-7B at 32
    layers in this process, disagg_crash on four replicas of Llama-2-7B's
    widths at CHAOS_DISAGG_LAYERS layers.  The counts in this process are
    set to 0 before and read after (the in-process engines and
    hot_swap's fresh predictor): no plain call, nothing realigned, the
    prefill kernel (#4), the product and RMSNorm kernels launched.  The
    hard gates of chaos_gate.  Returns the launches."""
    from paddle_tpu_torch.tools import chaos

    reset_counts(fa)
    t0 = time.perf_counter()
    with fleet_workdir("chip_smoke_chaos_", "13b") as fd:
        report = chaos.run_chaos(
            replicas=CHAOS_REPLICAS, scenarios=chaos.DEFAULT_SCENARIOS,
            availability_pct=99.0, workdir=fd,
            log=lambda m: log("  13b " + m), device="cuda", model=model,
            gen_model=GEN, gen_engine=CHAOS_GEN_ENGINE,
            disagg_argv=CHAOS_DISAGG_ARGV, disagg_env=CHAOS_DISAGG_ENV,
            **settings)
        if chaos_gate(report):  # its replicas' logs before they go
            dead_replica_logs(fd, "13b")
    seconds = time.perf_counter() - t0
    counts, plain, realigned = read_counts(fa)
    keep = ("requests", "ok", "shed", "injected_failures",
            "collateral_failures", "poison_leaks", "availability_pct",
            "p99_ms", "recovery_s", "wall_s", "leaked_pages",
            "torn_responses", "usage_conservation_delta",
            "hog_attribution_ratio", "alerts")
    CHAOS["run"] = dict(
        seconds=seconds, settings=settings,
        availability_pct=report["availability_pct"],
        p99_under_fault_ms=report["p99_under_fault_ms"],
        totals=report["totals"], errors=report["errors"], ok=report["ok"],
        scenarios={n: dict({k: r[k] for k in keep if k in r},
                           notes={k: v for k, v in r["notes"].items()
                                  if k in ("bisections", "poison_rows",
                                           "spec", "fault_victims",
                                           "recovery_s",
                                           "hung_kills_after",
                                           "prefix_hits", "page_evictions",
                                           "swap_clean", "swap_killed",
                                           "bit_exact")})
                   for n, r in report["scenarios"].items()},
        in_process_launches=dict(fa_fwd_f32=counts[0],
                                 fa_fwd_prefill=counts[3],
                                 gemm_f32=counts.gemm,
                                 rms_norm_f32=counts.rms_norm, plain=plain,
                                 realigned=realigned))
    log("  13b run_chaos: " + json.dumps(CHAOS["run"]))
    bad = chaos_gate(report)
    if plain or realigned or counts[3] <= 0 or counts.gemm <= 0 \
            or counts.rms_norm <= 0:
        bad.append("in-process launches")
    if bad:
        raise AssertionError(f"13b chaos: failed {bad}: "
                             f"{json.dumps(CHAOS['run'])[:4000]}")
    return counts



# -- phase 14: BERT-base training under TrainGuard -------------------------

# three lives of bench.py's flagship step (FLAGSHIP, FLAGSHIP_LR, bf16 AMP,
# dropout 0.1) from one startup scope, copied: A runs GUARD_STEPS guarded
# steps through a NaN; B is A preempted by a SIGTERM; C resumes B's final
# checkpoint in a fresh executor and scope and runs to A's count
GUARD_STEPS = 12
GUARD_INTERVAL = 4
GUARD_KEEP = 2
GUARD_NAN = "loss:nan@3"         # the third guarded step's feed is NaN
GUARD_SIGTERM = "step:sigterm@6"  # life B stops after its sixth step
GUARD_TELEMETRY_REPLAYS = 20
GUARD_PROFILED_REPLAYS = 3
GUARD = {}


def guard_batches():
    """Four masked-gather batches; run k of any life reads the same one,
    (k - 1) % 4."""
    return [train_batch(FLAGSHIP, seed=1400 + i, padding=False)
            for i in range(4)]


def guard_scope(tpt, start):
    """A new scope holding a copy of `start`'s tensors (state is updated
    in place: each life needs its own)."""
    scope = tpt.Scope()
    for n, t in start.items():
        scope.set_var(n, t.clone())
    return scope


def guard_step(guard, exe, fa, want, batches, scope, loss, what):
    """One guarded run_async step of `guard` on run exe._step + 1's batch,
    its loss handle read; returns the loss.  The step launches `want` of
    the six kernels (read through the replay-aware counters), no plain
    version and no realigned operand."""
    before = read_counts(fa)
    res = guard.step_async(batches[exe._step % len(batches)],
                           fetch_list=[loss], scope=scope)
    after = read_counts(fa)
    got = count_delta(before, after)
    if got != (want, 0, 0):
        raise AssertionError(f"{what} run {exe._step}: (launches, plain "
                             f"calls, realigned) {got}, want {want}, 0, 0")
    return float(np.ravel(res[0].numpy())[0])


def guard_life(tpt, fa, main, loss, start, batches, ckpt_dir, spec, what):
    """One life: a fresh executor and a copy of the startup scope under
    TrainGuard(checkpoint_dir=ckpt_dir, interval GUARD_INTERVAL, keep
    GUARD_KEEP) with `spec` injected, GUARD_STEPS guarded steps (or until
    a SIGTERM ends it).  The poisoned step must leave every persistable
    bit-unchanged and be the one skip, its callback at its own run.
    Returns (executor, scope, losses by run, the TrainingInterrupted or
    None, the counts over the life)."""
    import torch
    from paddle_tpu_torch import fault
    from paddle_tpu_torch.train_guard import TrainGuard, TrainingInterrupted

    want = per_step_launches(main)
    exe = tpt.Executor()
    scope = guard_scope(tpt, start)
    fault.configure(spec)
    seen = []
    guard = TrainGuard(exe, loss, program=main, checkpoint_dir=ckpt_dir,
                       interval_steps=GUARD_INTERVAL, keep_last_n=GUARD_KEEP,
                       on_nonfinite=seen.append)
    if guard.resumed_step is not None:
        raise AssertionError(f"{what} resumed at {guard.resumed_step}")
    reset_counts(fa)
    losses, stopped, nan_run = {}, None, None
    try:
        for i in range(GUARD_STEPS):
            held = None
            if i == 2:  # GUARD_NAN's step: hold the state before it
                nan_run = exe._step + 1
                held = {n: scope.find_var(n).clone() for n in start}
            run = exe._step + 1
            losses[run] = guard_step(guard, exe, fa, want, batches, scope,
                                     loss, what)
            if held is not None:
                moved = [n for n, t in held.items()
                         if not torch.equal(scope.find_var(n), t)]
                if moved or math.isfinite(losses[nan_run]):
                    raise AssertionError(
                        f"{what}: the NaN step {nan_run} (loss "
                        f"{losses[nan_run]}) moved {moved[:5]}")
                del held
    except TrainingInterrupted as e:
        stopped = e
    finally:
        fault.reset()
        guard.close()
    if guard.skipped_steps != 1 or seen != [nan_run]:
        raise AssertionError(f"{what}: skips {guard.skipped_steps}, "
                             f"callbacks at {seen}, want one at {nan_run}")
    return exe, scope, losses, stopped, read_counts(fa)


def guard_replay_ms(tpt, exe, main, batches, scope, loss, n):
    """Median host ms of a replay ending in its loss fetch, with
    FLAGS_telemetry on and off: `n` replays each, in turns (on, off, on,
    ...), so a drift of the card's clocks falls on both."""
    times = {True: [], False: []}
    for i in range(2 * n):
        on = i % 2 == 0
        tpt.set_flags({"FLAGS_telemetry": on})
        t = time.perf_counter()
        exe.run(main, feed=batches[i % len(batches)], fetch_list=[loss],
                scope=scope)
        times[on].append((time.perf_counter() - t) * 1e3)
    tpt.set_flags({"FLAGS_telemetry": True})
    return float(np.median(times[True])), float(np.median(times[False]))


def guard_profile_table(exe, main, batches, scope, loss, workdir):
    """GUARD_PROFILED_REPLAYS replays between profiler.start_profiler and
    stop_profiler("ave"): the printed table (the reference's 30 rows) must
    name the forward, dK/dV and dQ tensor-core kernels.  By average: by
    total the forward's 36 launches (~1.6 ms) sit below the 30th row,
    under host ops and elementwise kernels of many launches."""
    import contextlib
    import io

    from paddle_tpu_torch import profiler

    profiler.start_profiler(trace_dir=os.path.join(workdir, "profile"))
    for i in range(GUARD_PROFILED_REPLAYS):
        exe.run(main, feed=batches[i % len(batches)], fetch_list=[loss],
                scope=scope)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        profiler.stop_profiler("ave")
    table = out.getvalue()
    log("  profiler.stop_profiler('ave') over "
        f"{GUARD_PROFILED_REPLAYS} replays:")
    for line in table.splitlines():
        log("    " + line)
    missing = [k for k in TC_KERNELS if k not in table]
    if missing:
        raise AssertionError(f"the profiler's table does not name {missing}")


def guard_trace(mdir):
    """The metrics dir's trace.json and heartbeat.json, and
    paddle_tpu_torch.tools.trace_export's merge of the dir."""
    with open(os.path.join(mdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events}
    need = {"executor/step", "executor/dispatch", "executor/compile",
            "executor/fetch", "ckpt/write", "ckpt/publish",
            "train_guard/resume"}
    steps = {e["args"]["span_id"] for e in events
             if e["name"] == "executor/step"}
    orphans = [e for e in events if e["name"] == "executor/dispatch"
               and e["args"].get("parent_id") not in steps]
    if need - names or orphans:
        raise AssertionError(f"trace.json lacks {sorted(need - names)}; "
                             f"{len(orphans)} dispatch spans outside a step")
    with open(os.path.join(mdir, "heartbeat.json")) as f:
        hb = json.load(f)
    if not (hb.get("examples_per_sec") or 0) > 0:
        raise AssertionError(f"heartbeat.json: {hb}")
    out = os.path.join(mdir, "merged.json")
    r = subprocess.run([sys.executable, "-m",
                        "paddle_tpu_torch.tools.trace_export", mdir, out],
                       capture_output=True, text=True, timeout=300,
                       cwd=HERE)
    if r.returncode:
        raise AssertionError(f"trace_export: {r.stdout}{r.stderr}")
    with open(out) as f:
        merged = {e["name"] for e in json.load(f)["traceEvents"]}
    if not {"executor/step", "event/ckpt_publish", "event/resume"} <= merged:
        raise AssertionError(f"trace_export's merge lacks spans or events: "
                             f"{sorted(merged)[:40]}")
    log(f"  trace.json: {len(events)} events, {len(steps)} executor/step "
        f"spans; heartbeat examples/s {hb['examples_per_sec']}; "
        f"{r.stdout.strip()}")
    return len(events)


def train_guard_flagship(tpt, fa):
    """Phase 14: bench.py's flagship step under TrainGuard, in three lives
    from one startup scope.  A: GUARD_STEPS guarded steps, a NaN feed at
    the third, checkpoints every GUARD_INTERVAL runs.  B: the same with a
    SIGTERM at the sixth step: TrainingInterrupted, code 0, a valid final
    checkpoint.  C: a fresh executor and scope resume B's checkpoint and
    run to A's count: every loss after the resume and every persistable
    bit-equal to A's.  Every step launches 12 / 12 / 12 of the packed
    bf16 kernels, no plain version, nothing realigned.  Then the spans in
    the metrics dir, trace_export, telemetry's cost on a replay,
    profiler.py's table and memory.py's peak.  Returns the launches over
    the three lives."""
    import torch
    from paddle_tpu_torch import checkpoint as ckpt
    from paddle_tpu_torch import memory, telemetry
    from paddle_tpu_torch.flags import flag_value

    t0 = time.perf_counter()
    main, startup, loss = build_train(tpt, FLAGSHIP, FLAGSHIP_LR, amp=True,
                                      dropout=0.1)
    batches = guard_batches()
    names = [v.name for v in main.list_vars() if v.persistable]
    exe0, scope0 = tpt.Executor(), tpt.Scope()
    exe0.run(startup, scope=scope0)
    start = {n: scope0.find_var(n) for n in names}
    exe0.close()
    total = [0] * 6
    old_dir = flag_value("FLAGS_metrics_dir")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_guard_") as wd:
        mdir = os.path.join(wd, "metrics")
        dir_a, dir_b = os.path.join(wd, "ckpt_a"), os.path.join(wd, "ckpt_b")
        tpt.set_flags({"FLAGS_metrics_dir": mdir, "FLAGS_telemetry": True})
        telemetry.clear_spans()
        writes = telemetry.metrics.histogram("checkpoint_write_ms")
        w0 = (writes.summary()["count"], writes.summary()["sum"])

        exe_a, scope_a, losses_a, _, counts = guard_life(
            tpt, fa, main, loss, start, batches, dir_a, GUARD_NAN, "life A")
        total = [x + y for x, y in zip(total, counts[0])]
        exe_a.close()
        steps_a = ckpt.valid_steps(dir_a)
        with open(os.path.join(dir_a, str(steps_a[-1]),
                               ckpt.MANIFEST)) as f:
            ckpt_bytes = sum(m["bytes"]
                             for m in json.load(f)["files"].values())
        log(f"  life A: {GUARD_STEPS} guarded steps, one skip at run 3; "
            f"losses {', '.join(f'{x:.5f}' for x in losses_a.values())}; "
            f"checkpoints kept {steps_a} ({ckpt_bytes} bytes each)")

        exe_b, scope_b, losses_b, stopped, counts = guard_life(
            tpt, fa, main, loss, start, batches, dir_b,
            f"{GUARD_NAN},{GUARD_SIGTERM}", "life B")
        total = [x + y for x, y in zip(total, counts[0])]
        if stopped is None or stopped.code != 0 or \
                not ckpt.validate_checkpoint(dir_b, stopped.step):
            raise AssertionError(f"life B: interrupted {stopped!r}, "
                                 f"checkpoints {ckpt.valid_steps(dir_b)}")
        sigterm_ms = telemetry.metrics.gauge("sigterm_to_exit_ms").get()
        exe_b.close()
        del scope_b
        log(f"  life B: SIGTERM at its sixth step: TrainingInterrupted "
            f"code {stopped.code} at run {stopped.step}, final checkpoint "
            f"valid; sigterm_to_exit_ms {sigterm_ms:.1f}")

        from paddle_tpu_torch.train_guard import TrainGuard
        exe_c, scope_c = tpt.Executor(), guard_scope(tpt, start)
        with tpt.scope_guard(scope_c):
            guard = TrainGuard(exe_c, loss, program=main,
                               checkpoint_dir=dir_b)
        resume_ms = telemetry.metrics.gauge("train_guard_resume_ms").get()
        if guard.resumed_step != stopped.step:
            raise AssertionError(f"life C resumed at {guard.resumed_step}, "
                                 f"not {stopped.step}")
        reset_counts(fa)
        want = per_step_launches(main)
        losses_c = {}
        while exe_c._step < GUARD_STEPS:
            run = exe_c._step + 1
            losses_c[run] = guard_step(guard, exe_c, fa, want, batches,
                                       scope_c, loss, "life C")
        counts = read_counts(fa)
        total = [x + y for x, y in zip(total, counts[0])]
        differ = [k for k, v in losses_c.items() if v != losses_a[k]]
        moved = [n for n in names
                 if not torch.equal(scope_c.find_var(n), scope_a.find_var(n))]
        log(f"  life C: resumed at run {guard.resumed_step} in "
            f"{resume_ms:.1f} ms, ran to {exe_c._step}; losses "
            f"{', '.join(f'{x:.5f}' for x in losses_c.values())}; losses "
            f"unequal to A's at runs {differ}; persistables unequal to A's "
            f"{len(moved)} of {len(names)}")
        if differ or moved:
            raise AssertionError(f"life C differs from life A: losses at "
                                 f"{differ}, persistables {moved[:5]}")
        del scope_a

        on, off = guard_replay_ms(tpt, exe_c, main, batches, scope_c, loss,
                                  GUARD_TELEMETRY_REPLAYS)
        log(f"  median guarded replay (host clock, ends in the loss "
            f"fetch): telemetry on {on:.3f} ms, off {off:.3f} ms "
            f"({GUARD_TELEMETRY_REPLAYS} replays each, in turns)")
        guard_profile_table(exe_c, main, batches, scope_c, loss, wd)
        guard.close()
        n_events = guard_trace(mdir)
        s = writes.summary()
        n_writes, write_ms = s["count"] - w0[0], s["sum"] - w0[1]

        peak = memory.max_memory_allocated()
        exe_c.close()
        del scope_c, start, scope0
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        if peak != torch.cuda.max_memory_allocated():
            raise AssertionError(f"memory.max_memory_allocated() {peak} != "
                                 f"{torch.cuda.max_memory_allocated()}")
        memory.reset_peak()
        after = memory.max_memory_allocated()
        if not after < peak:
            raise AssertionError(f"the peak did not drop after reset_peak: "
                                 f"{peak} -> {after}")
        tpt.set_flags({"FLAGS_metrics_dir": old_dir})
    GUARD.update(
        checkpoint_bytes=ckpt_bytes, checkpoint_writes=n_writes,
        checkpoint_write_ms_mean=write_ms / max(n_writes, 1),
        train_guard_resume_ms=resume_ms, sigterm_to_exit_ms=sigterm_ms,
        replay_ms_telemetry_on=on, replay_ms_telemetry_off=off,
        trace_events=n_events, peak_gib=peak / 2 ** 30,
        peak_after_reset_gib=after / 2 ** 30,
        launches=total, phase_s=time.perf_counter() - t0)
    log(f"  checkpoints: {n_writes} written, {ckpt_bytes} bytes each, "
        f"checkpoint_write_ms mean {GUARD['checkpoint_write_ms_mean']:.1f} "
        f"(the sha256 pass included); memory.max_memory_allocated() "
        f"{peak / 2 ** 30:.2f} GiB, {after / 2 ** 30:.2f} after reset_peak")
    return Launches(total)


# -- phase 15: recompute and Llama-2's training recipe ----------------------

RECOMPUTE_STEPS = 6
RECOMPUTE_REPLAYS = 5
# a Llama-2-7B-width decoder at Llama-2's 4096 context, depth cut to 4 of
# its 32 layers (AdamW's state for all 32 is ~104 GB)
LLAMA_RECIPE = dict(LLAMA, num_layers=4, batch_size=2, seq_len=4096)
# Llama-2's pretraining recipe (Touvron et al. 2023, section 2.2): AdamW
# with beta2 0.95, eps 1e-5 and weight decay 0.1, warmup then a cosine
# decay, a global-norm clip at 1.0.  Fluid's cosine_decay goes down to 0
# (Llama-2's stops at 10% of the peak, which the schedules cannot write).
RECIPE = dict(beta1=0.9, beta2=0.95, epsilon=1e-5, weight_decay=0.1,
              peak_lr=3e-4, warmup_steps=2, step_each_epoch=1, epochs=6,
              clip_norm=1.0)
# a fetched LR against the host's formula: the card's float32 cos and
# numpy's may differ by a few ulps, which 0.5 * peak * (1 + cos) carries
# (up to ~8x relative near cos = -1); 1e-6 of the peak is far below the
# schedule's own steps (> 1e-5 of the peak apart)
RECIPE_LR_ATOL = 1e-6 * RECIPE["peak_lr"]
# the least drop of the eager step's peak allocated bytes that recompute
# must show at LLAMA_RECIPE
RECOMPUTE_SAVING = 3 * 2 ** 30
# the unpacked kernels' new shape on this path, held and timed in bf16
RECOMPUTE_ATTN = (1, 32, 4096, 128)
RECOMPUTE = {}


def forward_ops(main):
    """The forward ops of a built program (a recompute program's
    re-emitted copies, role Backward, left out)."""
    from paddle_tpu_torch.framework.core import OpRole

    return [op for op in main.global_block().ops
            if op.attr("op_role", OpRole.Forward) in
            (OpRole.Forward, OpRole.Forward | OpRole.Loss)]


def bert_checkpoints(main):
    """Each encoder layer's output in a built BERT program (the
    layer_norm after its FFN's residual add, paddle_tpu/models/bert.py
    :132): of the layer_norm ops whose X an elementwise_add writes (the
    embeddings' and two a layer), every second from the third."""
    ops = forward_ops(main)
    producer = {}
    for op in ops:
        for n in op.output_arg_names():
            producer.setdefault(n, op)
    norms = [op for op in ops if op.type == "layer_norm" and getattr(
        producer.get(op.input("X")[0]), "type", None) == "elementwise_add"]
    return [op.output("Y")[0] for op in norms[2::2]]


def llama_checkpoints(main):
    """The residual stream entering each block, and the final norm's
    input, in a built Llama program (the X of rms_norm at
    paddle_tpu/models/llama.py:71 and :163): every second rms_norm's X,
    since a block has two (before attention, before the MLP) and the
    final norm closes the stack."""
    norms = [op for op in forward_ops(main) if op.type == "rms_norm"]
    return [op.input("X")[0] for op in norms[::2]]


def build_llama_recipe(tpt, cfg, recompute):
    """The Llama training step under Llama-2's recipe (RECIPE): AdamW,
    linear_lr_warmup over cosine_decay, GradientClipByGlobalNorm, bf16
    AMP with the default lists; with `recompute` a RecomputeOptimizer
    checkpointed by llama_checkpoints.  Names and op seeds restart, so
    the two settings build the same parameters and startup.  Returns
    (main, startup, loss name, LR name)."""
    from paddle_tpu_torch import clip, optimizer
    from paddle_tpu_torch.contrib import mixed_precision
    from paddle_tpu_torch.models import build_llama_train
    from paddle_tpu_torch.ops import registry

    r = RECIPE
    tpt.reset_unique_name()
    registry.reset_op_seed()
    main, startup = tpt.Program(), tpt.Program()
    startup._is_startup = True
    with tpt.program_guard(main, startup):
        _, outs = build_llama_train(**cfg)
        lr = tpt.layers.linear_lr_warmup(
            tpt.layers.cosine_decay(r["peak_lr"], r["step_each_epoch"],
                                    r["epochs"]),
            r["warmup_steps"], 0.0, r["peak_lr"])
        opt = optimizer.AdamW(
            learning_rate=lr, beta1=r["beta1"], beta2=r["beta2"],
            epsilon=r["epsilon"], weight_decay=r["weight_decay"],
            grad_clip=clip.GradientClipByGlobalNorm(r["clip_norm"]))
        if recompute:
            opt = optimizer.RecomputeOptimizer(opt)
            opt._set_checkpoints(llama_checkpoints(main))
        opt = mixed_precision.decorate(opt, dtype="bfloat16")
        opt.minimize(outs["loss"])
    return main, startup, outs["loss"].name, lr.name


def recipe_lrs(steps, recipe=RECIPE):
    """The LR of each of the first `steps` runs: the schedule's ops in
    their order, in float32 on the host.  Run r counts step r - 1 (each
    counter starts at -1 and counts before it is read); linear_lr_warmup
    gives start + (peak - start) / warmup * step below warmup_steps, else
    cosine_decay's 0.5 peak (1 + cos(pi floor(step / step_each_epoch) /
    epochs))."""
    f = np.float32
    peak, warm = recipe["peak_lr"], recipe["warmup_steps"]
    out = []
    for r in range(steps):
        step = f(r)
        ramp = step * f(peak / warm) + f(0.0)
        epoch = np.floor(step * f(1.0 / recipe["step_each_epoch"]))
        cos = np.cos(epoch * f(math.pi / recipe["epochs"]))
        decay = cos * f(0.5 * peak) + f(0.5 * peak)
        out.append(ramp if step < f(warm) else decay)
    return out


def recompute_life(tpt, fa, what, main, startup, fetch, batches, key):
    """One life of `main` in a fresh executor and scope, from its startup
    program's state (run in that executor: the startup's draws are keyed
    by the program's seed and the run count, so every life starts from
    the same weights): RECOMPUTE_STEPS steps (eager, capture and replay,
    replays), each launching per_step_launches(main), no plain call,
    nothing realigned.  Read: the eager step's peak allocated bytes (the
    peak reset just before it), the graph pool's bytes, each step's
    fetches, the persistables after the last step (copied to the host).
    Then the median host ms of RECOMPUTE_REPLAYS replays (ending in the
    fetch) and one profiled replay (PROFILES[key]).  Closes the
    executor; returns the life's numbers."""
    import torch

    want = per_step_launches(main)
    held = torch.cuda.memory_allocated()  # by earlier phases
    exe, scope = tpt.Executor(), tpt.Scope()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa)
    fetched, peak = [], None
    for step in range(RECOMPUTE_STEPS):
        before = read_counts(fa)
        out = exe.run(main, feed=batches[step % len(batches)],
                      fetch_list=fetch, scope=scope)
        after = read_counts(fa)
        if step == 0:
            peak = torch.cuda.max_memory_allocated()
        got = count_delta(before, after)
        if got != (want, 0, 0) or not np.isfinite(out[0]).all():
            raise AssertionError(f"{what} step {step + 1}: (launches, plain "
                                 f"calls, realigned operands) {got}, want "
                                 f"{want}, 0, 0; loss {out[0]}")
        fetched.append([np.asarray(x).reshape(-1)[0] for x in out])
    counts = read_counts(fa)[0]
    info = exe.cache_info()["entries"][-1]
    if not info["aot"]:
        raise AssertionError(f"{what}: the step was never captured")
    state = {v.name: scope.find_var(v.name).to("cpu", copy=True)
             for v in main.list_vars()
             if v.persistable and scope.find_var(v.name) is not None}
    times = []
    for _ in range(RECOMPUTE_REPLAYS):
        t = time.perf_counter()
        out = exe.run(main, feed=batches[0], fetch_list=fetch, scope=scope)
        times.append((time.perf_counter() - t) * 1e3)
    profiled_launches(lambda: exe.run(main, feed=batches[0],
                                      fetch_list=fetch, scope=scope),
                      fa, f"one {what} replay", key, strict=False)
    exe.close()
    del scope
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    life = dict(losses=[x[0] for x in fetched],
                fetched=[x[1:] for x in fetched], state=state, peak=peak,
                held=held, pool=info["manifest"] or 0,
                params=sum(int(np.prod(p.shape))
                           for p in main.all_parameters()),
                replay_ms=float(np.median(times)), launches=counts,
                want=want, idle=PROFILES[key]["idle"])
    log(f"  {what}: losses {', '.join(f'{x:.6f}' for x in life['losses'])}; "
        f"eager step's peak {peak / 2 ** 30:.3f} GiB ({held / 2 ** 30:.3f} "
        f"of it held before the life), graph pool "
        f"{life['pool'] / 2 ** 30:.3f} GiB; replay {life['replay_ms']:.2f} "
        f"ms (median of {RECOMPUTE_REPLAYS}); launches {counts} ({want} a "
        f"step)")
    return life


def recompute_pair(tpt, fa, what, build, batches, key):
    """`build(recompute)` -> (main, startup, fetch names): the plain life,
    then the recompute life (recompute_life each, the first closed before
    the second starts).  Gates: the recompute program launches each
    forward kernel twice as often as the plain one and the backward ones
    as often; every fetch of every step and every persistable after the
    last step bit-equal.  Returns (plain life, recompute life)."""
    import torch

    lives = []
    for recompute in (False, True):
        main, startup, fetch = build(recompute)
        lives.append(recompute_life(
            tpt, fa, f"{what}, {'recompute' if recompute else 'plain'}",
            main, startup, fetch, batches,
            key + ("" if recompute else "_plain")))
        del main, startup
    plain, rc = lives
    w0, w1 = plain["want"], rc["want"]
    if not (w1[1:3] == w0[1:3] and w1[4:] == w0[4:] and
            w1[0] == 2 * w0[0] and w1[3] == 2 * w0[3]):
        raise AssertionError(f"{what}: recompute launches {w1} a step "
                             f"against plain's {w0}")
    differ = [i + 1 for i, (a, b) in enumerate(zip(
        plain["losses"], rc["losses"])) if a != b or
        any(x != y for x, y in zip(plain["fetched"][i], rc["fetched"][i]))]
    moved = sorted(n for n in set(plain["state"]) | set(rc["state"])
                   if n not in plain["state"] or n not in rc["state"] or
                   not torch.equal(plain["state"][n], rc["state"][n]))
    log(f"  {what}: recompute against plain: fetches unequal at steps "
        f"{differ}; persistables unequal {len(moved)} of "
        f"{len(plain['state'])}; eager peak {plain['peak'] / 2 ** 30:.3f} "
        f"-> {rc['peak'] / 2 ** 30:.3f} GiB, graph pool "
        f"{plain['pool'] / 2 ** 30:.3f} -> {rc['pool'] / 2 ** 30:.3f} GiB, "
        f"replay {plain['replay_ms']:.2f} -> {rc['replay_ms']:.2f} ms")
    if differ or moved:
        raise AssertionError(f"{what}: recompute is not bit-equal to "
                             f"plain: fetches at steps {differ}, "
                             f"persistables {moved[:5]}")
    return plain, rc


def life_numbers(life):
    return dict(peak_gib=life["peak"] / 2 ** 30,
                held_gib=life["held"] / 2 ** 30,
                pool_gib=life["pool"] / 2 ** 30,
                replay_ms=life["replay_ms"], idle=life["idle"],
                launches=list(life["want"]),
                losses=[float(x) for x in life["losses"]])


def deepest_stack(plain, rc, cfg, capacity):
    """The deepest stack of cfg's widths whose eager step fits in
    `capacity` bytes, reckoned from the two lives' measured peaks at
    cfg's depth L: each layer adds its static bytes (fp32 weight, two
    AdamW moments, fp32 grad, bf16 cast: 18 bytes a parameter) and, plain,
    one block's kept activations, which the recompute life holds once
    (so a block's activations are (plain peak - recompute peak) /
    (L - 1)), or under recompute one checkpoint (tokens x hidden x 4
    bytes); the bytes earlier phases held are left out.  Returns (plain
    layers, recompute layers, the per-layer bytes of each)."""
    L = cfg["num_layers"]
    tokens = cfg["batch_size"] * cfg["seq_len"]
    per_layer_params = (plain["params"] - 2 * cfg["vocab_size"] *
                        cfg["hidden"] - cfg["hidden"]) / L
    static = 18 * per_layer_params
    own_plain = plain["peak"] - plain["held"]  # less earlier phases
    own_rc = rc["peak"] - rc["held"]
    act = (own_plain - own_rc) / (L - 1)
    ckpt = tokens * cfg["hidden"] * 4
    per_plain, per_rc = static + act, static + ckpt
    base_plain = own_plain - L * per_plain
    base_rc = own_rc - L * per_rc
    return (int((capacity - base_plain) // per_plain),
            int((capacity - base_rc) // per_rc), per_plain, per_rc)


def recompute_flagship(tpt, fa, device):
    """Phase 15.  a: bench.py's flagship step (BERT-base, seq 512, batch
    8, bf16 AMP, dropout 0.1), plain and with recompute at every encoder
    layer's output (bert_checkpoints).  b: LLAMA_RECIPE under RECIPE,
    plain and with recompute at the residual stream entering each block
    and the final norm (llama_checkpoints).  Each a pair of lives
    (recompute_pair): bit-equal; b's every LR equal to recipe_lrs within
    RECIPE_LR_ATOL and its recompute peak at least RECOMPUTE_SAVING
    below plain's.  Returns each life's launches by path name."""
    import torch
    from paddle_tpu_torch.ops import registry

    t0 = time.perf_counter()
    paths = {}

    def bert(recompute):
        registry.reset_op_seed()
        main, startup, loss = build_train(tpt, FLAGSHIP, FLAGSHIP_LR,
                                          amp=True, dropout=0.1,
                                          recompute=recompute)
        if recompute:
            log(f"  15a checkpoints: {bert_checkpoints(main)}")
        return main, startup, [loss]

    batches = [train_batch(FLAGSHIP, seed=600 + i, padding=False)
               for i in range(4)]
    plain, rc = recompute_pair(tpt, fa, "15a BERT-base seq 512", bert,
                               batches, "recompute_bert")
    paths["recompute_bert_plain"] = plain["launches"]
    paths["recompute_bert"] = rc["launches"]
    RECOMPUTE["bert"] = dict(plain=life_numbers(plain),
                             recompute=life_numbers(rc))
    del plain, rc

    def llama(recompute):
        main, startup, loss, lr = build_llama_recipe(tpt, LLAMA_RECIPE,
                                                     recompute)
        if recompute:
            log(f"  15b checkpoints: {llama_checkpoints(main)}")
        return main, startup, [loss, lr]

    batches = [llama_batch(LLAMA_RECIPE, seed=1500 + i) for i in range(3)]
    plain, rc = recompute_pair(
        tpt, fa, f"15b Llama-2-7B widths, {LLAMA_RECIPE['num_layers']} "
        f"layers, seq {LLAMA_RECIPE['seq_len']}", llama, batches,
        "recompute_llama")
    paths["recompute_llama_plain"] = plain["launches"]
    paths["recompute_llama"] = rc["launches"]
    want_lrs = recipe_lrs(RECOMPUTE_STEPS)
    got_lrs = [x[0] for x in rc["fetched"]]
    log("  15b LR by step (card / host formula): " + ", ".join(
        f"{a:.6e} / {b:.6e}" for a, b in zip(got_lrs, want_lrs)))
    if not all(abs(float(a) - float(b)) <= RECIPE_LR_ATOL
               for a, b in zip(got_lrs, want_lrs)):
        raise AssertionError(f"15b LRs {got_lrs} are not the schedule's "
                             f"{want_lrs} (atol {RECIPE_LR_ATOL:g})")
    saving = plain["peak"] - rc["peak"]
    capacity = torch.cuda.get_device_properties(device).total_memory
    deep = deepest_stack(plain, rc, LLAMA_RECIPE, capacity)
    log(f"  15b recompute saves {saving / 2 ** 30:.3f} GiB of the eager "
        f"step's peak (at least {RECOMPUTE_SAVING / 2 ** 30:g} GiB); "
        f"replay {rc['replay_ms'] / plain['replay_ms']:.3f}x plain's; the "
        f"deepest stack of these widths whose eager step fits in "
        f"{capacity / 2 ** 30:.2f} GiB, reckoned from these peaks: "
        f"{deep[0]} layers plain ({deep[2] / 2 ** 30:.3f} GiB a layer), "
        f"{deep[1]} with recompute ({deep[3] / 2 ** 30:.3f} GiB a layer)")
    if saving < RECOMPUTE_SAVING:
        raise AssertionError(f"15b: recompute's eager peak is only "
                             f"{saving / 2 ** 30:.3f} GiB below plain's")
    RECOMPUTE["llama"] = dict(
        plain=life_numbers(plain), recompute=life_numbers(rc),
        saving_gib=saving / 2 ** 30,
        lrs=[float(x) for x in got_lrs],
        deepest_layers_plain=deep[0], deepest_layers_recompute=deep[1],
        gib_a_layer_plain=deep[2] / 2 ** 30,
        gib_a_layer_recompute=deep[3] / 2 ** 30)
    del plain, rc
    torch.cuda.empty_cache()
    RECOMPUTE["phase_s"] = time.perf_counter() - t0
    return paths


# phase 16: float16 AMP with dynamic loss scaling.  16a: bench.py's step
# with decorate(dtype="float16") at its defaults (init 2**15, incr 1000,
# decr 2); 16a': a scale far past float16's range, halved at every
# non-finite step and doubled after two finite ones; 16b: phase 9's
# Llama step in float16.
FP16_AMP = dict(dtype="float16")
FP16_OVERFLOW = dict(dtype="float16", init_loss_scaling=2.0 ** 18,
                     incr_every_n_steps=2, decr_every_n_nan_or_inf=1)
FP16_OVERFLOW_STEPS = 8
FP16_MAX = 65504.0
# 16a at dropout 0 against an fp32 life of the same step from its startup
# state: the fp16 losses within FP16_FP32_LOSS_RTOL relative, eight times
# fp16's largest reading on an H100 (2.53e-5).  The loss cannot tell
# fp16 from bf16 at this step: a bf16 life's readings (2.4e-5 to 8.2e-5)
# overlap fp16's.  The first step's last layer_norm output can, an
# average over 0.47M values that are rounded alike, to 2**-11 or 2**-8:
# ||x - x_fp32|| / ||x_fp32|| read 1.43e-3 for fp16 and 1.23e-2 for bf16
# on an H100 (8.6x, the ratio of the roundings), and the limit, 4e-3,
# lies near their geometric mean: fp16 within it, the bf16 life (the
# control) outside it, so a life that ran in bf16 fails 16a.
FP16_FP32_LOSS_RTOL = 2e-4
FP16_FP32_ACT_RTOL = 4e-3
# 16b against phase 9's bf16 losses (same startup seed, same feeds):
# ten times the largest reading on an H100, 1.0e-4.  This limit cannot
# tell fp16 from bf16 (a bf16 life reads 0 here); the profiled replay's
# kernel types (float16's alone) do that.
FP16_BF16_LOSS_RTOL = 1e-3
# phase 16's numbers, for the "fp16:" JSON line
FP16 = {}


def loss_scale_machine(found, init, incr_n, decr_n, incr_ratio=2.0,
                       decr_ratio=0.5):
    """The host's run of update_loss_scaling's state machine over the
    steps' overflow flags `found`: (scale, good, bad) after each step, in
    float32 as the op computes the scale."""
    scale, good, bad = np.float32(init), 0, 0
    out = []
    for f in found:
        bad, good = (bad + 1, 0) if f else (0, good + 1)
        if bad >= decr_n:
            scale, bad = max(np.float32(scale * np.float32(decr_ratio)),
                             np.float32(1e-8)), 0
        elif good >= incr_n:
            scale, good = np.float32(scale * np.float32(incr_ratio)), 0
        out.append((float(scale), good, bad))
    return out


def check_fp16_profile(key):
    """The profiled replay's attention kernels (PROFILES[key]
    ["attention_types"]) are the float16 instantiations alone; a
    profile that saw no device time leaves this not measured."""
    p = PROFILES[key]
    if not p.get("busy_ms"):
        log(f"  {key}: the kernels' types in the profile: not measured")
        return
    log(f"  {key}: attention kernels in the profiled replay: "
        f"{p['attention_types']}")
    if p["attention_types"] != ["__half"]:
        raise AssertionError(f"{key}: the replay ran attention kernels of "
                             f"{p['attention_types']}, not float16's alone")


def fp16_against_fp32(tpt, fa, batches):
    """16a at dropout 0: an fp32 life of bench.py's step, a float16 one
    (decorate's defaults) and a bfloat16 one from the fp32 life's startup
    state, on the same feeds, FLAGSHIP_STEPS steps each; the fp16 losses
    within FP16_FP32_LOSS_RTOL of the fp32 ones, and the first step's
    last layer_norm output within FP16_FP32_ACT_RTOL of the fp32 life's,
    where the bf16 life's (the control) lies outside it, so the limit
    tells the two types apart.  Each step launches
    per_step_launches(main), no plain call, nothing realigned."""
    import torch

    lives, acts, start = {}, {}, None
    for name, amp in (("float32", None), ("float16", FP16_AMP),
                      ("bfloat16", dict(dtype="bfloat16"))):
        main, startup, loss = build_train(tpt, FLAGSHIP, FLAGSHIP_LR,
                                          amp=amp is not None, dropout=0.0,
                                          amp_args=amp)
        last_norm = [op for op in main.global_block().ops
                     if op.type == "layer_norm"][-1].output("Y")[0]
        want = per_step_launches(main)
        exe, scope = tpt.Executor(), tpt.Scope()
        exe.run(startup, scope=scope)
        if start is None:
            start = {n: scope.find_var(n).clone()
                     for n in scope.local_var_names()}
        else:
            params = {p.name for p in main.all_parameters()}
            copied = set()
            for n, t in start.items():
                dst = scope.find_var(n)
                if isinstance(dst, torch.Tensor) and dst.shape == t.shape \
                        and dst.dtype == t.dtype:
                    dst.copy_(t)
                    copied.add(n)
            if not params <= copied:
                missing = sorted(params - copied)[:5]
                raise AssertionError(f"16a: parameters not carried from the "
                                     f"fp32 life: {missing}")
        losses = []
        for step in range(FLAGSHIP_STEPS):
            before = read_counts(fa)
            out = exe.run(main, feed=batches[step % len(batches)],
                          fetch_list=[loss, last_norm], scope=scope)
            after = read_counts(fa)
            got = count_delta(before, after)
            if got != (want, 0, 0) or not np.isfinite(out[0]).all():
                raise AssertionError(f"16a {name} life step {step + 1}: "
                                     f"{got}, want {want}, 0, 0; loss "
                                     f"{out[0]}")
            losses.append(float(np.ravel(out[0])[0]))
            if step == 0:
                acts[name] = np.asarray(out[1]).astype("float32")
        lives[name] = losses
        exe.close()
        del scope
        torch.cuda.empty_cache()
    rel, bf16_rel = ([abs(a - b) / abs(b) for a, b in zip(
        lives[name], lives["float32"])] for name in ("float16", "bfloat16"))
    act = {name: float(np.linalg.norm(acts[name] - acts["float32"]) /
                       np.linalg.norm(acts["float32"]))
           for name in ("float16", "bfloat16")}
    FP16["bert_vs_fp32"] = dict(lives, rel=rel, bf16_rel=bf16_rel,
                                limit=FP16_FP32_LOSS_RTOL, act_rel=act,
                                act_limit=FP16_FP32_ACT_RTOL,
                                act_shape=list(acts["float32"].shape))
    for name, r in (("float16", rel), ("bfloat16 (the control)", bf16_rel)):
        log(f"  16a at dropout 0, {name} against fp32 from one startup "
            f"state: " + ", ".join(f"{a:.6f} / {b:.6f} ({x:.2e})" for a, b, x
                                   in zip(lives[name.split()[0]],
                                          lives["float32"], r)) +
            f" (limit {FP16_FP32_LOSS_RTOL:g} relative)")
    log(f"  16a's first step, the last layer_norm output "
        f"{list(acts['float32'].shape)} against fp32's: float16 "
        f"{act['float16']:.3e}, bfloat16 (the control) "
        f"{act['bfloat16']:.3e} (limit {FP16_FP32_ACT_RTOL:g} relative)")
    if max(rel) > FP16_FP32_LOSS_RTOL:
        raise AssertionError(f"16a: fp16 losses part from fp32's by "
                             f"{max(rel):.3e}")
    if not act["float16"] <= FP16_FP32_ACT_RTOL < act["bfloat16"]:
        raise AssertionError(f"16a: the last layer_norm output reads "
                             f"{act} from fp32's; the limit "
                             f"{FP16_FP32_ACT_RTOL:g} must hold fp16's and "
                             f"not the bf16 control's")


def fp16_overflow(tpt, fa, batches):
    """16a': bench.py's step (dropout 0) under FP16_OVERFLOW, two lives
    from one startup state: captured (the compiled step: eager, capture,
    replays) and eager (every run a fresh, uncached entry, so every step
    runs op by op).  Each step fetches the loss, the scale, the good and
    bad counters, the overflow flag and the first attention layer's
    d(out) and d(qkv) (float16, scaled by the loss scale: the dS side's
    nearest readable values; each step prints their largest magnitude
    against 65504).  Gates: the scale state follows loss_scale_machine
    over the flags exactly; the scale falls until a step is finite, then
    doubles; the attention's values are float16; the two lives bit-equal
    in every fetch and every persistable."""
    import torch

    main, startup, loss = build_train(tpt, FLAGSHIP, FLAGSHIP_LR, amp=True,
                                      dropout=0.0, amp_args=FP16_OVERFLOW)
    ops = main.global_block().ops
    found = next(op for op in ops if op.type == "check_finite_and_unscale"
                 ).output("FoundInfinite")[0]
    grad = next(op for op in ops if op.type == "flash_attention_qkv_grad")
    d_out, d_qkv = grad.input("Out@GRAD")[0], grad.output("QKV@GRAD")[0]
    fetch = [loss, "loss_scaling_0", "loss_scaling_good_0",
             "loss_scaling_bad_0", found, d_out, d_qkv]
    want = per_step_launches(main)
    lives = []
    for cached in (True, False):
        exe, scope = tpt.Executor(), tpt.Scope()
        exe.run(startup, scope=scope)
        steps = []
        for step in range(FP16_OVERFLOW_STEPS):
            before = read_counts(fa)
            out = exe.run(main, feed=batches[step % len(batches)],
                          fetch_list=fetch, scope=scope,
                          use_program_cache=cached)
            after = read_counts(fa)
            got = count_delta(before, after)
            if got != (want, 0, 0):
                raise AssertionError(f"16a' step {step + 1}: {got}, want "
                                     f"{want}, 0, 0")
            steps.append([np.asarray(x) for x in out])
        if cached and not exe.cache_info()["entries"][-1]["aot"]:
            raise AssertionError("16a': the step was never captured")
        state = {v.name: scope.find_var(v.name).to("cpu", copy=True)
                 for v in main.list_vars()
                 if v.persistable and scope.find_var(v.name) is not None}
        lives.append((steps, state))
        exe.close()
        del scope
        torch.cuda.empty_cache()
    (steps, state), (eager, eager_state) = lives
    flags = [bool(s[4].reshape(-1)[0]) for s in steps]
    machine = loss_scale_machine(
        flags, FP16_OVERFLOW["init_loss_scaling"],
        FP16_OVERFLOW["incr_every_n_steps"],
        FP16_OVERFLOW["decr_every_n_nan_or_inf"])
    got = [(float(s[1].reshape(-1)[0]), int(s[2].reshape(-1)[0]),
            int(s[3].reshape(-1)[0])) for s in steps]
    rows = []
    for i, (s, m) in enumerate(zip(steps, machine)):
        dmax = [float(np.abs(x.astype("float32")).max()) for x in s[5:7]]
        rows.append(dict(loss=float(np.ravel(s[0])[0]), scale=got[i][0],
                         good=got[i][1], bad=got[i][2], found=flags[i],
                         **{k: x if math.isfinite(x) else None for k, x in
                            zip(("d_out_max", "d_qkv_max"), dmax)}))
        log(f"  16a' step {i + 1}: loss {rows[-1]['loss']:.6f}, overflow "
            f"{flags[i]}, scale {got[i][0]:g} good {got[i][1]} bad "
            f"{got[i][2]} (host machine: {m[0]:g} {m[1]} {m[2]}); "
            f"max|d out| {dmax[0]:.4g}, max|d qkv| {dmax[1]:.4g} "
            f"(65504 / it: {FP16_MAX / dmax[1] if dmax[1] else math.inf:.4g})")
    unequal = [i + 1 for i, (a, b) in enumerate(zip(steps, eager))
               if any(x.dtype != y.dtype or x.tobytes() != y.tobytes()
                      for x, y in zip(a, b))]
    moved = sorted(n for n in state if n not in eager_state or
                   not torch.equal(state[n].view(-1).view(torch.uint8),
                                   eager_state[n].view(-1).view(torch.uint8)))
    first_finite = flags.index(False) if False in flags else None
    FP16["overflow"] = dict(steps=rows, captured_eq_eager=not (unequal or
                                                               moved))
    log(f"  16a': captured against eager: fetches unequal at steps "
        f"{unequal}, persistables unequal {len(moved)} of {len(state)}")
    dtypes = {steps[0][5].dtype.name, steps[0][6].dtype.name}
    if got != machine:
        raise AssertionError(f"16a': scale state {got} is not the host "
                             f"machine's {machine}")
    if first_finite is None or first_finite == 0 or \
            not all(flags[:first_finite]) or \
            2 * rows[first_finite]["scale"] not in [r["scale"] for r in
                                                    rows[first_finite:]]:
        raise AssertionError(f"16a': the scale did not fall until a finite "
                             f"step and then double: {got}, flags {flags}")
    if dtypes != {"float16"}:
        raise AssertionError(f"16a': the attention's grads are {dtypes}")
    if unequal or moved:
        raise AssertionError(f"16a': captured and eager lives differ: "
                             f"fetches at steps {unequal}, persistables "
                             f"{moved[:5]}")


def fp16_flagship(tpt, fa, llama_op_seed, bf16_losses):
    """Phase 16.  16a: bench.py's seq-512 step in float16 AMP
    (decorate's defaults) through train_flagship (12 / 12 / 12 launches
    a step, the run_async window, a profiled replay whose attention
    kernels are the float16 ones), then fp16_against_fp32 and
    fp16_overflow.  16b: phase 9's Llama step in float16 from phase 9's
    op seed (so its startup draws phase 9's weights), its losses within
    FP16_BF16_LOSS_RTOL of phase 9's `bf16_losses`.  The op-seed counter
    is put back afterwards (see bert_fp32_profile).  Returns the two
    flagships' launches by path name."""
    import torch
    from paddle_tpu_torch.ops import registry

    t0 = time.perf_counter()
    op_seed = registry._OP_SEED[0]
    paths = {}
    main, startup, loss = build_train(tpt, FLAGSHIP, FLAGSHIP_LR, amp=True,
                                      dropout=0.1, amp_args=FP16_AMP)
    batches = [train_batch(FLAGSHIP, seed=600 + i, padding=False)
               for i in range(4)]
    paths["training_fp16"], losses = train_flagship(
        tpt, fa, "bench.py's seq-512 step (fp16 AMP, dynamic loss scaling, "
        "dropout 0.1)", main, startup, loss, batches, FLAGSHIP_STEPS,
        FLAGSHIP["batch_size"] * FLAGSHIP["seq_len"], "bert_fp16")
    check_fp16_profile("bert_fp16")
    FP16["bert"] = dict(losses=losses)
    del main, startup
    fp16_against_fp32(tpt, fa, batches)
    fp16_overflow(tpt, fa, batches)
    FP16["bert_s"] = time.perf_counter() - t0

    t1 = time.perf_counter()
    registry.reset_op_seed(llama_op_seed)
    main, startup, loss = build_llama(tpt, LLAMA_FLAGSHIP, LLAMA_FLAGSHIP_LR,
                                      amp=True, amp_args=FP16_AMP)
    registry.reset_op_seed(op_seed)
    batches = [llama_batch(LLAMA_FLAGSHIP, seed=800 + i) for i in range(3)]
    paths["llama_fp16"], losses = train_flagship(
        tpt, fa, f"Llama-2-7B-width training ({LLAMA_FLAGSHIP['num_layers']}"
        f" layers, fp16 AMP, dynamic loss scaling)", main, startup, loss,
        batches, FLAGSHIP_STEPS,
        LLAMA_FLAGSHIP["batch_size"] * LLAMA_FLAGSHIP["seq_len"],
        "llama_fp16")
    check_fp16_profile("llama_fp16")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, bf16_losses)]
    FP16["llama"] = dict(losses=losses, bf16_losses=list(bf16_losses),
                         rel=rel, limit=FP16_BF16_LOSS_RTOL,
                         layers=LLAMA_FLAGSHIP["num_layers"])
    log("  16b losses beside phase 9's bf16 ones: " + ", ".join(
        f"{a:.5f} / {b:.5f} ({r:.2e})" for a, b, r in zip(
            losses, bf16_losses, rel)) +
        f" (limit {FP16_BF16_LOSS_RTOL:g} relative)")
    if len(rel) != len(bf16_losses) or max(rel) > FP16_BF16_LOSS_RTOL:
        raise AssertionError("16b: the fp16 Llama losses part from phase "
                             "9's bf16 ones")
    del main, startup
    torch.cuda.empty_cache()
    FP16["llama_s"] = time.perf_counter() - t1
    FP16["phase_s"] = time.perf_counter() - t0
    return paths


def d32_build_report():
    """Phase 17a's look at phase 2's build: HGMMA, UTMALDG, registers and
    spills of each D-32 instantiation (phase 2 already held every one of
    CHECKED_KERNELS to no spill, and the 16-bit ones to HGMMA and
    UTMALDG)."""
    rows = {}
    for label in CHECKED_KERNELS:
        if not re.search(r"<(?:\w+, )?32[,>]", label):
            continue
        hgmma, utmaldg = BUILD_REPORT["sass"].get(label, (0, 0))
        regs = [m for line in BUILD_REPORT["ptxas"].get(label, ())
                for m in re.findall(r"Used (\d+) registers", line)]
        spills = [int(x) for line in BUILD_REPORT["ptxas"].get(label, ())
                  for x in re.findall(r"(\d+) bytes spill", line)]
        rows[label] = dict(hgmma=hgmma, utmaldg=utmaldg,
                           registers=int(regs[0]) if regs else None,
                           spill_bytes=sum(spills))
        log(f"  {label}: {hgmma} HGMMA, {utmaldg} UTMALDG, "
            f"{rows[label]['registers']} registers, {sum(spills)} bytes "
            f"spilled")
        if spills == [] or any(spills) or (
                "_tc_" in label and not (hgmma and utmaldg)):
            raise AssertionError(f"{label}: {rows[label]}")
    if len(rows) != 9:
        raise AssertionError(f"D-32 instantiations in the build: "
                             f"{sorted(rows)}")
    return rows


def minilm_kernels(fa, device):
    """Phase 17a: the unpacked kernels at D 32 against their plain
    versions over unpacked_cases(32), in fp32, bf16 and fp16 at the
    phase's limits; fp16's overflow check at D 32; the D-32 builds'
    SASS and ptxas lines; then each kernel's times at MiniLM-L12-H384's
    training shape (MINILM_TRAIN_ATTN, not causal, a padding bias) in
    bf16 and fp16 and its serving shape (MINILM_SERVE_ATTN) in fp32,
    beside SDPA's and the bound.  Returns the rows by dtype."""
    import torch

    t0 = time.perf_counter()
    MINILM_RUN["build"] = d32_build_report()
    check_unpacked(fa, device, unpacked_cases(32), seed=1700)
    check_fp16_overflow(fa, device, unpacked=True, D=32)
    rows = {}
    for dtype, shape in (("bfloat16", MINILM_TRAIN_ATTN),
                         ("float16", MINILM_TRAIN_ATTN),
                         ("float32", MINILM_SERVE_ATTN)):
        log(f"  MiniLM's attention {list(shape)}, not causal, padding "
            f"bias, {dtype}:")
        rows[dtype] = time_unpacked(fa, device, dtype, shape=shape,
                                    causal=False, bias_kind="pad_dead_row")
    torch.cuda.empty_cache()
    MINILM_RUN["kernels_s"] = time.perf_counter() - t0
    return rows


def serving_launches(main):
    """A served request's launches of the six kernels: the packed
    forward once a flash_attention_qkv op, the unpacked one once a
    flash_attention op (impl "auto"; the einsum formulation launches
    none)."""
    ops = main.global_block().ops
    return (sum(op.type == "flash_attention_qkv" for op in ops), 0, 0,
            sum(op.type == "flash_attention" and
                op.attr("impl", "auto") != "xla" for op in ops), 0, 0)


def forward_products(main):
    """A served request's launches of the product kernel: one a mul or
    matmul op (every forward-only fp32 product on the card)."""
    return sum(op.type in ("mul", "matmul") for op in main.global_block().ops)


def bert_serving_check(tpt, fa, what, cfg, use_flash, workdir):
    """One model's serving on the card (phases 17b and 17d): the
    pretraining program at `cfg` (is_test, random weights from its
    startup), saved with io.save_inference_model and served by a
    Predictor on the card, warmed at batches 1, 4 and 8; two requests a
    batch, each launching the six kernels as serving_launches says and
    the product kernel as forward_products says, with no plain call and
    no realigned operand; each row of a batch-4 request equal to the same
    row served alone (tolerance 0); batch 4 against a CPU Predictor at
    phase 4's limits.  Returns the launches of the six kernels and the
    numbers."""
    import torch
    from paddle_tpu_torch.models import build_bert_pretrain

    t0 = time.perf_counter()
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        feeds, outs = build_bert_pretrain(is_test=True, use_flash=use_flash,
                                          **cfg)
    ops = main.global_block().ops
    logits = [op for op in ops if op.type == "softmax_with_cross_entropy"][
        0].input("Logits")[0]
    loss = outs["loss"].name
    want, n_products = serving_launches(main), forward_products(main)
    exe = tpt.Executor()
    scope = tpt.Scope()
    with tpt.scope_guard(scope):
        exe.run(startup)
        tpt.io.save_inference_model(workdir, feeds, [logits, loss], exe,
                                    main_program=main)
    del scope
    torch.cuda.empty_cache()
    pred = tpt.inference.Predictor(workdir)
    S, V = cfg["seq_len"], cfg["vocab_size"]
    feed = bert_feed  # BERT's seq 128 and vocab: both models' feeds
    warmed = pred.warmup([{n: a.shape for n, a in feed(b, 0).items()}
                          for b in (1, 4, 8)])
    log(f"  {what}: built, saved and loaded in "
        f"{time.perf_counter() - t0:.2f} s; {warmed} signatures captured; "
        f"{n_products} forward products a request")
    reset_counts(fa)
    lat = {}
    for b in (1, 4, 8):
        for s in range(2):
            before = read_counts(fa)
            t = time.perf_counter()
            out = pred.run(feed(b, 30 + 10 * b + s))
            lat.setdefault(b, []).append((time.perf_counter() - t) * 1e3)
            after = read_counts(fa)
            d = count_delta(before, after)
            gemm = after[0].gemm - before[0].gemm
            if d != (want, 0, 0) or gemm != n_products:
                raise AssertionError(f"{what} batch {b}: (launches, plain, "
                                     f"realigned) {d}, {gemm} product "
                                     f"launches; want {want}, 0, 0 and "
                                     f"{n_products}")
            if out[0].shape != (b, S, V) or not np.isfinite(out[0]).all():
                raise AssertionError(f"{what} batch {b}: bad logits")
    f4 = feed(4, 70)
    whole = pred.run(f4)[0]
    alone = [pred.run({n: a[r:r + 1] for n, a in f4.items()})[0]
             for r in range(4)]
    same = all(np.array_equal(whole[r:r + 1], a) for r, a in
               enumerate(alone))
    cpu = tpt.inference.Predictor(workdir, device="cpu")
    want_cpu = cpu.run(feed(4, 70))
    diff = float(np.abs(whole - want_cpu[0]).max())
    got_loss = pred.run(f4)[1]
    loss_rel = float(abs(got_loss[0] - want_cpu[1][0]) / abs(want_cpu[1][0]))
    counts = read_counts(fa)[0]
    log(f"  {what}: request latency by batch "
        + "; ".join(f"{b}: {', '.join(f'{x:.2f}' for x in v)} ms"
                    for b, v in lat.items())
        + f"; {want} launches and {n_products} products a request"
        + f"; batch-4 rows equal to each row alone: {same}; card vs CPU "
        f"logits max|diff| {diff:.3e} (limit {LOGITS_ATOL:g}), loss rel "
        f"{loss_rel:.3e} (limit {LOSS_RTOL:g}); launches {tuple(counts)}, "
        f"product kernel {counts.gemm}")
    if not (same and diff <= LOGITS_ATOL and loss_rel <= LOSS_RTOL):
        raise AssertionError(f"{what}: batched != single or card != CPU")
    pred.close()
    del pred, cpu
    torch.cuda.empty_cache()
    return counts, dict(latency_ms=lat, card_vs_cpu=diff, loss_rel=loss_rel)


def minilm_training(tpt, fa):
    """Phase 17c: MiniLM-L12-H384 training.  First card-vs-CPU fp32
    parity at 2 layers and seq 128 (phase 5's train_parity: 3 steps of
    the parity recipe, the loss, step-1 grads and the parameters), then
    bench.py's recipe (Adam, global-norm clip 1.0, linear warmup, bf16
    AMP with the bench's white list, the masked-gather head, dropout 0.1)
    at MINILM_TRAIN through train_flagship: 12 / 12 / 12 D-32 launches a
    step, the run_async window and a profiled replay whose attention
    kernels are the bf16 D-32 instantiations.  Returns the two paths'
    launches."""
    t0 = time.perf_counter()
    main, startup, loss = build_train(tpt, MINILM_PARITY, PARITY_LR,
                                      amp=False, dropout=0.0)
    params = [p.name for p in main.all_parameters()]
    grads = ["fc_0.w_0@GRAD", "fc_0.tmp_1@GRAD", "layer_norm_0.w_0@GRAD",
             "embedding_0.w_0@GRAD", f"{params[-2]}@GRAD"]
    batches = [train_batch(MINILM_PARITY, seed=1710 + step, padding=True)
               for step in range(3)]
    parity = train_parity(tpt, fa, "MiniLM-L12-H384 (2 layers)", main,
                          startup, loss, batches, grads, PARITY_LRS)
    MINILM_RUN["parity_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    main, startup, loss = build_train(tpt, MINILM_TRAIN, FLAGSHIP_LR,
                                      amp=True, dropout=0.1)
    batches = [train_batch(MINILM_TRAIN, seed=1720 + i, padding=False)
               for i in range(4)]
    flagship, losses = train_flagship(
        tpt, fa, "MiniLM-L12-H384 training (bench.py's recipe, seq 512, "
        "batch 32, bf16 AMP, dropout 0.1)", main, startup, loss, batches,
        MINILM_STEPS, MINILM_TRAIN["batch_size"] * MINILM_TRAIN["seq_len"],
        "minilm_flagship")
    kernels = PROFILES["minilm_flagship"].get("attention_kernels", [])
    log(f"  the profiled replay's attention kernels: {kernels}")
    want = {f"fa_{k}_tc_kernel<__nv_bfloat16, 32>"
            for k in ("fwd", "dkv", "dq")}
    if set(kernels) != want:
        raise AssertionError(f"MiniLM's replay ran {kernels}, want {want}")
    MINILM_RUN.update(losses=losses, train_s=time.perf_counter() - t1)
    return parity, flagship


def seq128_lives(tpt, fa):
    """Phase 17d's control lives: bench.py's seq-128 step at dropout 0,
    unfused, einsum ("xla") and packed flash (kernels #1-#3 at seq 128),
    each from the unfused life's startup weights (copied into the other
    two), SEQ128_CONTROL_STEPS captured steps.  The unfused and
    einsum lives launch no attention kernel and call no plain version;
    the packed one launches 12 / 12 / 12 a step.  Their losses agree
    within SEQ128_LOSS_RTOL (bf16 rounds scores, probabilities and
    products at other places in each).  Returns the losses by life."""
    import torch
    from paddle_tpu_torch.ops import registry

    op_seed = registry._OP_SEED[0]
    batches = [train_batch(SEQ128, seed=1760 + i, padding=True)
               for i in range(SEQ128_CONTROL_STEPS)]
    losses, first = {}, None
    for name, use_flash in (("unfused", False), ("einsum", "xla"),
                            ("packed_flash", True)):
        registry.reset_op_seed(op_seed)
        main, startup, loss = build_train(
            tpt, dict(SEQ128, use_flash=use_flash), FLAGSHIP_LR, amp=True,
            dropout=0.0)
        want = per_step_launches(main)
        exe, scope = tpt.Executor(), tpt.Scope()
        exe.run(startup, scope=scope)
        params = [p.name for p in main.all_parameters()]
        if first is None:  # the unfused life's weights for all three
            first = {n: scope.find_var(n).clone() for n in params}
        elif sorted(first) != sorted(params):
            raise AssertionError(f"17d {name}: other parameters")
        else:
            for n in params:
                scope.find_var(n).copy_(first[n])
        reset_counts(fa)
        got = []
        for feed in batches:
            got.append(float(np.ravel(exe.run(
                main, feed=feed, fetch_list=[loss], scope=scope)[0])[0]))
        counts = read_counts(fa)
        steps = len(batches)
        if counts != (tuple(steps * x for x in want), 0, 0):
            raise AssertionError(f"17d {name}: (launches, plain, realigned) "
                                 f"{counts}, want {want} a step, 0, 0")
        if name != "packed_flash" and any(want):
            raise AssertionError(f"17d {name} built attention kernels")
        losses[name] = got
        log(f"  {name} at dropout 0: losses "
            f"{', '.join(f'{x:.5f}' for x in got)}; launches "
            f"{tuple(counts[0])}")
        exe.close()
        del scope
        torch.cuda.empty_cache()
    del first
    registry.reset_op_seed(op_seed)
    rel = {n: max(abs(a - b) / abs(b) for a, b in zip(l, losses["unfused"]))
           for n, l in losses.items() if n != "unfused"}
    log(f"  largest loss rel diff from the unfused life: "
        + ", ".join(f"{n} {r:.3e}" for n, r in rel.items())
        + f" (limit {SEQ128_LOSS_RTOL:g})")
    if max(rel.values()) > SEQ128_LOSS_RTOL or \
            not all(np.isfinite(l).all() for l in losses.values()):
        raise AssertionError("17d: the three attention branches' losses "
                             "part")
    return losses, rel


def seq128_flagship(tpt, fa, workdir):
    """Phase 17d: bench.py's seq-128 step at BERT-base, unfused as
    _attn_for(128) picks it (SEQ128: batch 192, 19 predictions, bf16 AMP,
    dropout 0.1) through train_flagship (no attention kernel a step, the
    run_async window, a profiled replay); captured against eager over
    SEQ128_STEPS steps, bit for bit, probability dropout included; the
    three branches' control lives (seq128_lives); BERT-base serving with
    use_flash=False (bert_serving_check).  Returns the paths' launches."""
    t0 = time.perf_counter()
    paths = {}
    main, startup, loss = build_train(tpt, dict(SEQ128, use_flash=False),
                                      FLAGSHIP_LR, amp=True, dropout=0.1)
    batches = [train_batch(SEQ128, seed=1740 + i, padding=False)
               for i in range(4)]
    paths["seq128_unfused"], losses = train_flagship(
        tpt, fa, "bench.py's seq-128 step (BERT-base unfused, batch 192, "
        "bf16 AMP, dropout 0.1)", main, startup, loss, batches,
        SEQ128_STEPS, SEQ128["batch_size"] * SEQ128["seq_len"],
        "seq128_unfused")
    exact = captured_vs_eager(tpt, main, startup, loss,
                              [batches[i % len(batches)]
                               for i in range(SEQ128_STEPS)],
                              [FLAGSHIP_LR["end_lr"]] * SEQ128_STEPS)
    if not exact:
        raise AssertionError("17d: the captured seq-128 step is not "
                             "bit-equal to the eager one")
    SEQ128_RUN.update(losses=losses, captured_bit_equal=exact,
                      train_s=time.perf_counter() - t0)
    del main, startup
    t1 = time.perf_counter()
    SEQ128_RUN["control_losses"], SEQ128_RUN["control_rel"] = \
        seq128_lives(tpt, fa)
    SEQ128_RUN["control_s"] = time.perf_counter() - t1
    t2 = time.perf_counter()
    paths["seq128_serving"], SEQ128_RUN["serving"] = bert_serving_check(
        tpt, fa, "BERT-base serving, use_flash=False, seq 128, fp32",
        SERVE_BERT, False, workdir)
    SEQ128_RUN["serving_s"] = time.perf_counter() - t2
    return paths


def minilm_flagship(tpt, fa, device, card):
    """Phase 17: MiniLM-L12-H384 and bench.py's seq-128 step (17a-17d).
    The op-seed counter is put back afterwards (see bert_fp32_profile).
    Returns the paths' launches and 17a's kernel rows."""
    from paddle_tpu_torch.ops import registry

    t0 = time.perf_counter()
    op_seed = registry._OP_SEED[0]
    paths = {}
    log("  17a: kernels #4-#6 at D 32")
    rows = minilm_kernels(fa, device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_minilm_") as wd:
        t1 = time.perf_counter()
        log("  17b: MiniLM-L12-H384 serving (fp32, seq 128)")
        paths["minilm_serving"], MINILM_RUN["serving"] = bert_serving_check(
            tpt, fa, "MiniLM-L12-H384 serving, seq 128, fp32",
            dict(MINILM, seq_len=MINILM_SERVE_SEQ), True,
            os.path.join(wd, "minilm"))
        MINILM_RUN["serving_s"] = time.perf_counter() - t1
        log("  17c: MiniLM-L12-H384 training")
        paths["minilm_parity"], paths["minilm_flagship"] = \
            minilm_training(tpt, fa)
        log("  17d: bench.py's seq-128 BERT-base step, unfused")
        paths.update(seq128_flagship(tpt, fa, os.path.join(wd, "bert")))
    registry.reset_op_seed(op_seed)
    MINILM_RUN["card"] = SEQ128_RUN["card"] = card
    MINILM_RUN["phase_s"] = time.perf_counter() - t0
    return paths, rows


# ---------------------------------------------------------------------------
# phase 18: Wide&Deep, SelectedRows gradients and lazy Adam
# ---------------------------------------------------------------------------

# wide_deep_net's defaults, the Criteo layout of Wide & Deep (Cheng et al.
# 2016): 26 categorical slots hashed into one table space of 1,000,001
# ids, 13 dense features, 10-wide embeddings, a 400-400-400 MLP; batch
# 4096, Adam 1e-3, fp32 (TF32 off).  Nothing is cut: both tables and their
# moments are ~132 MB on the card.
WIDE_DEEP = dict(num_sparse=26, num_dense=13, vocab_size=1000001,
                 embed_dim=10, hidden=(400, 400, 400))
WIDE_DEEP_BATCH = 4096
WIDE_DEEP_LR = 1e-3
WIDE_DEEP_STEPS = 6
# ids: Zipf(1.1) ranks over a seeded permutation of the vocabulary, so a
# batch's hottest id repeats ~13,000 times among its 106,496
WIDE_DEEP_ZIPF = 1.1
WIDE_DEEP_SEED = 1800
WIDE_DEEP_SERVE_BATCHES = (1, 64)
# Limits.  Dense against sparse with lazy_mode off (18b) and the lazy life
# on the card against the same program on the CPU (18c) run the same
# arithmetic with sums in other orders: PyTorch's chunked embedding
# backward against the merge kernel's sequential sums (18b), cuBLAS
# against MKL in the MLP's fp32 products (18c), ~1e-7 to 1e-6 relative a
# sum.  Over 6 Adam steps that keeps every loss within WIDE_DEEP_LOSS_RTOL
# relative and every persistable within WIDE_DEEP_STATE_RTOL of its norm
# (||got - want|| / ||want||); a weight whose gradient sums to nearly 0
# may take Adam's step of either sign, so a parameter's worst element is
# held to 2 lr a step.  Everything else is held bit for bit.
WIDE_DEEP_LOSS_RTOL = 1e-5
WIDE_DEEP_STATE_RTOL = 1e-4
# serving on the card against a CPU Predictor: logits of a 400-wide fp32
# MLP's products summed in other orders
WIDE_DEEP_SERVE_ATOL = 1e-5
# the optimizers and clips that merge a SelectedRows gradient once (18's
# launch reckoning), by the slot that takes it
MERGING_SLOTS = {"sgd": "Grad", "momentum": "Grad", "adam": "Grad",
                 "adamw": "Grad", "adagrad": "Grad", "clip": "X",
                 "clip_by_norm": "X", "merge_selected_rows": "X"}
WIDE_DEEP_RUN = {}


def zipf_ids(rng, n, vocab, perm, s=WIDE_DEEP_ZIPF):
    """n ids: Zipf(s) ranks (those within the vocabulary) mapped through
    the permutation `perm` of the vocabulary."""
    out = np.empty(0, np.int64)
    while out.size < n:
        r = rng.zipf(s, 2 * n)
        out = np.concatenate([out, r[r <= vocab]])
    return perm[out[:n] - 1].astype(np.int64)


def wide_deep_feeds(cfg, batch, steps, seed):
    """`steps` feeds of wide_deep_net: Zipf ids, standard-normal dense
    features, labels 1 with probability 0.25."""
    rng = np.random.RandomState(seed)
    perm = rng.permutation(cfg["vocab_size"])
    return [{"sparse_ids": zipf_ids(rng, batch * cfg["num_sparse"],
                                    cfg["vocab_size"], perm).reshape(
                                        batch, cfg["num_sparse"]),
             "dense_x": rng.randn(batch, cfg["num_dense"]).astype(
                 np.float32),
             "label": (rng.rand(batch, 1) < 0.25).astype(np.float32)}
            for _ in range(steps)]


def untouched_rows(feeds, vocab):
    """The ids no feed looks up (int64, ascending)."""
    seen = np.zeros(vocab, bool)
    for f in feeds:
        seen[f["sparse_ids"].ravel()] = True
    return np.flatnonzero(~seen)


def merge_launches(main, fetch_names=()):
    """The merge kernel's launches a step of `main`: one a SelectedRows
    value that an optimizer, a clip or merge_selected_rows takes
    (MERGING_SLOTS), one a distinct elementwise or global_norm_sq operand
    that is one (it densifies), one a fetched one.  SelectedRows are the
    SELECTED_ROWS vars and what stays sparse after them: the output of a
    clip, a clip by norm, merge_selected_rows, a scale without bias and a
    sum of SelectedRows alone."""
    block = main.global_block()
    sparse = {n for n, v in block.vars.items()
              if getattr(v, "type", None) == "selected_rows"}
    n = 0
    for op in block.ops:
        ins = op.input_arg_names()
        if op.type in MERGING_SLOTS:
            n += sum(name in sparse for name in op.input(
                MERGING_SLOTS[op.type]))
        elif op.type.startswith("elementwise_") or \
                op.type == "global_norm_sq":
            n += len({name for name in ins if name in sparse})
        keeps = op.type in ("clip", "clip_by_norm", "merge_selected_rows") \
            or (op.type == "scale" and not op.attr("bias", 0.0)) \
            or (op.type == "sum" and ins and all(x in sparse for x in ins))
        if keeps and any(x in sparse for x in ins):
            sparse.update(op.output("Out"))
    return n + sum(name in sparse for name in fetch_names)


def build_wide_deep(tpt, is_sparse, lazy, op_seed):
    """wide_deep_net at WIDE_DEEP with Adam(WIDE_DEEP_LR, lazy_mode), its
    ops seeded from `op_seed` (every life's startup draws the same
    weights).  Returns (main, startup, loss)."""
    from paddle_tpu_torch.models import wide_deep_net
    from paddle_tpu_torch.ops import registry

    registry.reset_op_seed(op_seed)
    tpt.reset_unique_name()
    main, startup = tpt.Program(), tpt.Program()
    startup._is_startup = True
    main.random_seed = startup.random_seed = WIDE_DEEP_SEED
    with tpt.program_guard(main, startup):
        net = wide_deep_net(is_sparse=is_sparse, **WIDE_DEEP)
        tpt.optimizer.AdamOptimizer(WIDE_DEEP_LR, lazy_mode=lazy).minimize(
            net["loss"])
    return main, startup, net["loss"]


def wide_deep_life(tpt, fa, what, main, startup, loss, feeds, start=None,
                   eager=False, device=None):
    """One life of `feeds` steps: a fresh executor and scope on `device`
    (the card by default) run `startup` (on the CPU its values come from
    `start`, a dict of the card's startup tensors), then each step
    (`eager`: every step op by op, never captured).  On the card the
    kernel counts are read from 0 around the steps: the plain versions'
    calls and realigned operands must stay 0 and the merge kernel's
    launches must be merge_launches(main) a step.  Returns (losses,
    {persistable: tensor}, startup state, per-step wall ms, launches)."""
    import torch

    names = [v.name for v in main.list_vars() if v.persistable]
    on_cpu = device is not None and device.type == "cpu"
    exe = tpt.Executor(tpt.CPUPlace() if on_cpu else None)
    scope = tpt.Scope()
    exe.run(startup, scope=scope)
    if start is not None:
        for n in names:
            scope.find_var(n).copy_(start[n])
    first = {n: scope.find_var(n).clone() for n in names}
    if not on_cpu:
        reset_counts(fa)
    losses, wall = [], []
    for feed in feeds:
        if not on_cpu:
            torch.cuda.synchronize()
        t = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                      use_program_cache=not eager)
        wall.append((time.perf_counter() - t) * 1e3)
        losses.append(float(np.ravel(out[0])[0]))
    counts = None
    if not on_cpu:
        counts, plain, realigned = read_counts(fa)
        want = merge_launches(main) * len(feeds)
        log(f"  {what}: losses {', '.join(f'{x:.7f}' for x in losses)}; "
            f"step ms {', '.join(f'{x:.2f}' for x in wall)}; merge "
            f"kernel launches {counts.merge} (reckoned {want}), plain "
            f"calls {plain}, realigned {realigned}")
        if counts.merge != want or plain or realigned or any(counts):
            raise AssertionError(f"{what}: merge launches {counts.merge} "
                                 f"(want {want}), plain {plain}, realigned "
                                 f"{realigned}, attention {tuple(counts)}")
        if not eager and not exe.cache_info()["entries"][-1]["aot"]:
            raise AssertionError(f"{what}: the step was never captured")
    else:
        log(f"  {what}: losses {', '.join(f'{x:.7f}' for x in losses)}; "
            f"step ms {', '.join(f'{x:.0f}' for x in wall)}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{what}: non-finite losses {losses}")
    state = {n: scope.find_var(n) for n in names}
    exe.close()
    return losses, state, first, wall, counts


def state_gap(got, want, what, params, lr_sum):
    """Holds two lives' persistables to WIDE_DEEP_STATE_RTOL of each
    tensor's norm and a parameter's worst element to 2 * lr_sum; returns
    the worst relative gap."""
    worst, worst_name = 0.0, None
    for n, w in want.items():
        g = got[n].to(w.device).double()
        w = w.double()
        d = (g - w)
        norm = float(w.norm())
        rel = float(d.norm()) / norm if norm > 0 else float(d.norm())
        if rel > worst:
            worst, worst_name = rel, n
        if rel > WIDE_DEEP_STATE_RTOL or (
                n in params and float(d.abs().max()) > 2 * lr_sum):
            raise AssertionError(f"{what}: {n} apart by {rel:.3e} of its "
                                 f"norm, max|d| {float(d.abs().max()):.3e}")
    return worst, worst_name


def check_untouched(state, first, rows, what):
    """Every row no step looked up keeps its startup bits in both tables
    and in both tables' moments.  Returns the names checked."""
    import torch

    checked = []
    for n, t in state.items():
        if "embedding_w" not in n or "_pow" in n:
            continue
        idx = torch.from_numpy(rows).to(t.device)
        got = t.index_select(0, idx).view(torch.int32)
        if not torch.equal(got, first[n].index_select(0, idx).view(
                torch.int32)):
            raise AssertionError(f"{what}: untouched rows of {n} moved")
        checked.append(n)
    if len(checked) != 6:
        raise AssertionError(f"{what}: checked {checked}, want both tables "
                             f"and their two moments")
    return checked


def lives_equal(a, b, what):
    """Bit-equality of two lives' losses and persistables."""
    import torch

    la, sa = a[0], a[1]
    lb, sb = b[0], b[1]
    diff = [n for n in sa if not torch.equal(sa[n], sb[n])]
    if la != lb or diff:
        raise AssertionError(f"{what}: losses {la} vs {lb}; persistables "
                             f"apart: {diff[:5]}")


def profile_wide_deep(tpt, fa, main, startup, loss, feeds, key):
    """One profiled replay of a captured sparse step (after two runs: the
    eager one and the capture): wall, device busy and idle share, the top
    kernels (report_profile), and the profiler's merge-kernel records
    held to merge_launches(main)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    exe, scope = tpt.Executor(), tpt.Scope()
    exe.run(startup, scope=scope)
    for feed in feeds[:2]:
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(PROFILE_SETTLE_S)
        t = time.perf_counter()
        exe.run(main, feed=feeds[2], fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    kernels, busy = report_profile(prof, wall_us, "a lazy sparse Wide&Deep "
                                   "step (a replay)", key=key)
    merges = sum(e.count for e in kernels if "merge_rows_kernel" in e.key)
    want = merge_launches(main)
    top = [(e.key[:80], e.self_device_time_total / 1e3) for e in sorted(
        kernels, key=lambda e: -e.self_device_time_total)[:6]]
    PROFILES[key]["top_kernels_ms"] = top
    log(f"  the profiled replay: {merges} merge kernel records "
        f"(reckoned {want})")
    if busy > 0 and merges != want:
        raise AssertionError(f"{key}: the profiler saw {merges} merge "
                             f"launches, want {want}")
    exe.close()


def wide_deep_serving(tpt, fa, workdir, tables, feeds):
    """18e: wide_deep_serving_net at WIDE_DEEP's widths (random weights
    from its startup) saved and served by a Predictor on the card, fed
    rows gathered from `tables` (the lazy life's trained tables) at the
    first feed's ids: each of 64 rows served alone at batch 1 gives the
    bits of its row of the batch of 64; batch 64 against a CPU Predictor
    within WIDE_DEEP_SERVE_ATOL; every request launches the product
    kernel once a forward product (forward_products) and nothing else
    counted.  Returns (launches, numbers)."""
    import torch

    from paddle_tpu_torch.models import wide_deep_serving_net

    tpt.reset_unique_name()
    main, startup = tpt.Program(), tpt.Program()
    startup._is_startup = True
    cfg = {k: v for k, v in WIDE_DEEP.items() if k != "vocab_size"}
    with tpt.program_guard(main, startup):
        net = wide_deep_serving_net(**cfg)
    feeds_names = ["wide_rows", "deep_rows", "dense_x"]
    exe, scope = tpt.Executor(), tpt.Scope()
    with tpt.scope_guard(scope):
        exe.run(startup)
        tpt.io.save_inference_model(workdir, feeds_names,
                                    [net["logit"], net["prob"]], exe,
                                    main_program=main)
    n = max(WIDE_DEEP_SERVE_BATCHES)
    ids = torch.from_numpy(feeds[0]["sparse_ids"][:n])
    wide = tables["wide_embedding_w"].cpu()[ids].numpy()
    deep = tables["deep_embedding_w"].cpu()[ids].numpy()
    batch = {"wide_rows": wide, "deep_rows": deep,
             "dense_x": feeds[0]["dense_x"][:n]}
    n_products = forward_products(main)
    pred = tpt.inference.Predictor(workdir)
    pred.warmup([{k: (b,) + v.shape[1:] for k, v in batch.items()}
                 for b in WIDE_DEEP_SERVE_BATCHES])
    reset_counts(fa)
    lat = {}
    t = time.perf_counter()
    whole = pred.run(batch)
    lat[n] = (time.perf_counter() - t) * 1e3
    alone, single_ms = [], []
    for r in range(n):
        t = time.perf_counter()
        alone.append(pred.run({k: v[r:r + 1] for k, v in batch.items()}))
        single_ms.append((time.perf_counter() - t) * 1e3)
    lat[1] = float(np.median(single_ms))
    counts, plain, realigned = read_counts(fa)
    requests = 1 + n
    same = all(np.array_equal(whole[i][r:r + 1], a[i])
               for r, a in enumerate(alone) for i in range(2))
    cpu = tpt.inference.Predictor(workdir, device="cpu")
    want = cpu.run(batch)
    diff = max(float(np.abs(g - w).max()) for g, w in zip(whole, want))
    log(f"  18e serving: batch 64 {lat[n]:.2f} ms, batch 1 median "
        f"{lat[1]:.2f} ms; rows served alone equal to the batch's: {same};"
        f" card vs CPU max|diff| {diff:.3e} (limit "
        f"{WIDE_DEEP_SERVE_ATOL:g}); product kernel launches {counts.gemm} "
        f"({n_products} a request x {requests}), merge {counts.merge}, "
        f"plain {plain}, realigned {realigned}")
    if not (same and diff <= WIDE_DEEP_SERVE_ATOL
            and counts.gemm == n_products * requests and not counts.merge
            and not plain and not realigned and not any(counts)
            and all(np.isfinite(x).all() for x in whole)
            and whole[1].shape == (n, 1)):
        raise AssertionError("18e: Wide&Deep serving failed its gates")
    pred.close()
    del pred, cpu, exe, scope
    torch.cuda.empty_cache()
    return counts, dict(latency_ms=lat, card_vs_cpu=diff,
                        batched_equals_single=same)


def wide_deep_flagship(tpt, fa, card):
    """Phase 18: Wide&Deep at WIDE_DEEP, batch WIDE_DEEP_BATCH, on the
    card, lives of WIDE_DEEP_STEPS steps from one startup seed:
    (a) dense tables; (b) sparse tables, lazy_mode off: (a)'s losses and
    persistables within the limits; (c) sparse, lazy_mode on: the port's
    CPU run of the same program from the card's startup values within the
    limits, and every row no step touched at its startup bits (moments
    at 0); (d) (c) again in a fresh executor and scope, bit for bit, and
    (c) with every step eager, bit for bit (captured = eager); (e) the
    serving net (wide_deep_serving).  Each card life asserts its merge
    launches against merge_launches and no plain call; a profiled replay
    of the lazy step gives the device's idle share and top kernels.  The
    op-seed counter is put back afterwards.  Returns the paths' launches
    and WIDE_DEEP_RUN."""
    import torch

    from paddle_tpu_torch.ops import registry

    t0 = time.perf_counter()
    op_seed = registry._OP_SEED[0]
    feeds = wide_deep_feeds(WIDE_DEEP, WIDE_DEEP_BATCH, WIDE_DEEP_STEPS,
                            WIDE_DEEP_SEED)
    untouched = untouched_rows(feeds, WIDE_DEEP["vocab_size"])
    hot = np.bincount(feeds[0]["sparse_ids"].ravel()).max()
    log(f"  {WIDE_DEEP_BATCH * WIDE_DEEP['num_sparse']} ids a step, the "
        f"hottest id {hot} times in the first; "
        f"{WIDE_DEEP['vocab_size'] - untouched.size} rows touched in "
        f"{WIDE_DEEP_STEPS} steps, {untouched.size} not")
    lr_sum = WIDE_DEEP_LR * WIDE_DEEP_STEPS
    paths, lives, reckoned = {}, {}, {}
    for key, is_sparse, lazy in (("dense", False, False),
                                 ("sparse", True, False),
                                 ("lazy", True, True)):
        main, startup, loss = build_wide_deep(tpt, is_sparse, lazy,
                                              op_seed)
        reckoned[key] = merge_launches(main)
        lives[key] = wide_deep_life(tpt, fa, f"18{'abc'[len(lives)]} "
                                    f"{key}", main, startup, loss, feeds)
        paths[f"wide_deep_{key}"] = lives[key][4]
        torch.cuda.empty_cache()
    params = {v.name for v in main.all_parameters()}
    for key in ("sparse", "lazy"):
        diff = [n for n in lives["dense"][2]
                if not torch.equal(lives[key][2][n], lives["dense"][2][n])]
        if diff:
            raise AssertionError(f"18: the {key} life's startup state "
                                 f"differs from the dense life's: {diff}")
    d_loss = max(abs(a - b) / abs(b) for a, b in
                 zip(lives["sparse"][0], lives["dense"][0]))
    d_state = state_gap(lives["sparse"][1], lives["dense"][1],
                        "18b sparse vs dense", params, lr_sum)
    log(f"  18b sparse (lazy_mode off) vs dense: loss rel {d_loss:.3e} "
        f"(limit {WIDE_DEEP_LOSS_RTOL:g}), worst persistable "
        f"{d_state[0]:.3e} of its norm ({d_state[1]}; limit "
        f"{WIDE_DEEP_STATE_RTOL:g})")
    if d_loss > WIDE_DEEP_LOSS_RTOL:
        raise AssertionError(f"18b: losses apart by {d_loss}")
    lives["dense"] = lives["dense"][:1] + (None, None) + lives["dense"][3:]
    check_untouched(lives["lazy"][1], lives["lazy"][2], untouched, "18c")
    # the CPU life starts from the card's startup values (the CPU's
    # generators draw other numbers)
    start = {n: t.cpu() for n, t in lives["lazy"][2].items()}
    t_cpu = time.perf_counter()
    cpu = wide_deep_life(tpt, fa, "18c lazy on the CPU", main, startup,
                         loss, feeds, start=start,
                         device=torch.device("cpu"))
    cpu_s = time.perf_counter() - t_cpu
    c_loss = max(abs(a - b) / abs(b) for a, b in
                 zip(lives["lazy"][0], cpu[0]))
    c_state = state_gap(lives["lazy"][1], cpu[1], "18c card vs CPU",
                        params, lr_sum)
    log(f"  18c lazy card vs CPU: loss rel {c_loss:.3e} (limit "
        f"{WIDE_DEEP_LOSS_RTOL:g}), worst persistable {c_state[0]:.3e} of "
        f"its norm ({c_state[1]}); untouched rows at their startup bits")
    if c_loss > WIDE_DEEP_LOSS_RTOL:
        raise AssertionError(f"18c: card and CPU losses apart by {c_loss}")
    del cpu, start
    again = wide_deep_life(tpt, fa, "18d lazy again (fresh executor and "
                           "scope)", main, startup, loss, feeds)
    lives_equal(again, lives["lazy"], "18d")
    del again
    eager = wide_deep_life(tpt, fa, "18d lazy eager (every step op by "
                           "op)", main, startup, loss, feeds, eager=True)
    lives_equal(eager, lives["lazy"], "18d captured vs eager")
    del eager
    torch.cuda.empty_cache()
    profile_wide_deep(tpt, fa, main, startup, loss, feeds, "wide_deep_lazy")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_wide_deep_") as wd:
        paths["wide_deep_serving"], serving = wide_deep_serving(
            tpt, fa, wd, lives["lazy"][1], feeds)
    registry.reset_op_seed(op_seed)
    replay = {k: float(np.median(v[3][2:])) for k, v in lives.items()}
    WIDE_DEEP_RUN.update(
        card=card, hottest_id=int(hot), untouched_rows=int(untouched.size),
        losses={k: v[0] for k, v in lives.items()},
        replay_ms=replay, sparse_vs_dense=dict(loss_rel=d_loss,
                                               state_rel=d_state[0]),
        card_vs_cpu=dict(loss_rel=c_loss, state_rel=c_state[0],
                         cpu_s=cpu_s),
        merge_launches_a_step=reckoned, serving=serving,
        profile=PROFILES.get("wide_deep_lazy"),
        phase_s=time.perf_counter() - t0)
    log("  replay ms a step (median of steps 3-6): " + ", ".join(
        f"{k} {v:.2f}" for k, v in replay.items()))
    return paths


# the merge kernel in phase 2: the deep table's 10 columns and the wide
# table's 1, at Wide&Deep's K
MERGE_COLS = (10, 1)


def check_merge(kernel, device):
    """Phase 2's look at the SelectedRows merge kernel at Wide&Deep's K
    (WIDE_DEEP_BATCH x 26 Zipf ids over WIDE_DEEP's 1,000,001 rows, from
    fixed seeds), MERGE_COLS columns: its output bit-equal to the plain
    version run on the CPU on the same inputs and across two launches;
    the event and device time of the wrapper (sort, scan, kernel) and of
    the kernel alone, the plain version's on the card, torch's index_add_
    of the same sums into a dense table (the library call) and the bound
    (rows and values read once, merged rows and values written once at
    the HBM peak).  Returns {f"cols{c}": row}."""
    import torch

    height = WIDE_DEEP["vocab_size"]
    k = WIDE_DEEP_BATCH * WIDE_DEEP["num_sparse"]
    rng = np.random.RandomState(WIDE_DEEP_SEED + 2)
    rows = torch.from_numpy(zipf_ids(rng, k, height,
                                     rng.permutation(height))).to(device)
    out = {}
    for cols in MERGE_COLS:
        vals = seeded((k, cols), WIDE_DEEP_SEED + cols, device)
        got = kernel.merge_rows(rows, vals, height)
        again = kernel.merge_rows(rows, vals, height)
        want = kernel.merge_rows_reference(rows.cpu(), vals.cpu(), height)
        same = (torch.equal(got[0].cpu(), want[0]) and
                got[1].cpu().numpy().tobytes() == want[1].numpy().tobytes())
        repeat = (torch.equal(got[0], again[0]) and torch.equal(
            got[1].view(torch.int32), again[1].view(torch.int32)))
        names = []
        ms, dev = timed(lambda: kernel.merge_rows(rows, vals, height), 20,
                        names=names)
        kernel_dev = sum(us for n, us in names
                         if "merge_rows_kernel" in n) / 1e3
        plain_ms = cuda_ms(
            lambda: kernel.merge_rows_reference(rows, vals, height), 1,
            warmup=1)
        dense = torch.zeros(height, cols, device=device)
        lib_ms, lib_dev = timed(lambda: dense.index_add_(0, rows, vals), 20)
        bound = (16.0 + 8.0 * cols) * k / PEAK_BYTES_PER_S * 1e3
        unique = int((got[0] < height).sum())
        err = float((got[1].cpu() - want[1]).abs().max())
        out[f"cols{cols}"] = dict(
            ms=ms, device_ms=dev, kernel_device_ms=kernel_dev,
            plain_ms=plain_ms, library_ms=lib_ms, library_device_ms=lib_dev,
            bound_ms=bound, bound_by="bytes", max_abs_err=err, k=k,
            unique_rows=unique, sha256=sha256(got[1]))
        log(f"  merge kernel [{k}, {cols}] ({unique} unique rows): "
            f"bit-equal to the plain version on the CPU: {same}, across "
            f"two launches: {repeat}; wrapper {ms:.4f} ms events / "
            f"{dev:.4f} ms device ({kernel_dev:.4f} ms the kernel), plain "
            f"on the card {plain_ms:.1f} ms, index_add_ {lib_ms:.4f} / "
            f"{lib_dev:.4f} ms, bound {bound:.5f} ms (bytes)")
        log_kernels(f"merge [{k}, {cols}]", names)
        if not (same and repeat):
            raise AssertionError(f"merge kernel at {cols} columns: bit-equal "
                                 f"to the plain version {same}, across "
                                 f"launches {repeat}")
    return out


def use_bytecode_cache():
    """Write and read the interpreter's compiled bytecode under
    BYTECODE_CACHE, in this process and every process it starts
    (spawn_process passes the environment on).  Where torch is installed
    without .pyc files and the environment forbids writing them
    (PYTHONDONTWRITEBYTECODE), every replica start and respawn compiles
    torch's sources anew, seconds of each (probe_replica_start.py).
    Bytecode goes to the prefix only, never beside a source; a prefix
    the caller set is kept."""
    prefix = os.environ.setdefault("PYTHONPYCACHEPREFIX", BYTECODE_CACHE)
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    sys.pycache_prefix = prefix
    sys.dont_write_bytecode = False


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    use_bytecode_cache()
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.ops.cuda import build, gemm, rms_norm
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import selected_rows

    pkg_dir = os.path.dirname(os.path.abspath(tpt.__file__))
    if pkg_dir != os.path.join(HERE, "paddle_tpu_torch"):
        raise RuntimeError(f"paddle_tpu_torch imported from {pkg_dir}, not "
                           f"from this checkout")

    t_start = time.perf_counter()
    card = card_line()
    log(f"[1/18] device: {card}; torch {torch.__version__}, CUDA "
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
    gemm._lib()
    rms_norm._lib()
    selected_rows._lib()
    log(f"[2/18] built {sorted(built)} in {time.perf_counter() - t0:.2f} s")
    check_build(build)
    gemm_rows, gemm_ratios = check_gemm(gemm, build, device)
    norm_rows = check_rms_norm(rms_norm, device)
    merge_rows = check_merge(selected_rows, device)

    log("[3/18] packed kernels against their plain versions")
    check_kernel(fa, device)
    check_backward(fa, device)
    fwd_f32 = time_forward_f32(fa, device)
    time_forward_flagship(fa, device, "bfloat16")
    bwd_timing = time_backward(fa, device, "bfloat16")
    bwd_f32 = time_backward(fa, device, "float32")
    t_f16 = time.perf_counter()
    fwd_f16 = time_forward_flagship(fa, device, "float16")
    bwd_f16 = time_backward(fa, device, "float16")
    check_fp16_overflow(fa, device, unpacked=False)
    f16_s = time.perf_counter() - t_f16
    log(f"  ({time.perf_counter() - t_start:.1f} s so far)")

    # each path's launches of the six kernels, each read from 0
    by_path = {}
    log("[4/18] BERT-base serving through Predictor on the card")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        by_path["serving"] = serve(tpt, fa, workdir)
    log(f"  ({time.perf_counter() - t_start:.1f} s so far)")

    log("[5/18] BERT-base training, card against the CPU (fp32)")
    by_path["training_parity"] = bert_parity(tpt, fa)
    bert_fp32_profile(tpt, fa)
    log(f"  ({time.perf_counter() - t_start:.1f} s so far)")

    log("[6/18] bench.py's seq-512 training step on the card (bf16 AMP)")
    by_path["training_flagship"], _ = bert_flagship(tpt, fa)
    log(f"  ({time.perf_counter() - t_start:.1f} s so far)")

    log("[7/18] unpacked kernels against their plain versions")
    check_unpacked(fa, device)
    unpacked_timing = time_unpacked(fa, device, "bfloat16")
    unpacked_f32 = time_unpacked(fa, device, "float32")
    log(f"  phase 15b's attention shape, {list(RECOMPUTE_ATTN)} causal:")
    seq4096 = time_unpacked(fa, device, "bfloat16", shape=RECOMPUTE_ATTN)
    t_f16 = time.perf_counter()
    unpacked_f16 = time_unpacked(fa, device, "float16")
    check_fp16_overflow(fa, device, unpacked=True)
    f16_s += time.perf_counter() - t_f16 + CASE_SECONDS["float16"]
    log(f"  the fp16 kernels' cases, times and overflow checks of phases 3 "
        f"and 7 took {f16_s:.1f} s ({CASE_SECONDS['float16']:.1f} s of "
        f"cases)")
    log(f"  ({time.perf_counter() - t_start:.1f} s so far)")

    # phase 17 runs here, beside phase 7's unpacked kernels: right after
    # phase 16 the profiler saw no device time in any session (my chip
    # runs 4 and 6, PR 20), while phase 7's sessions see it
    log("[17/18] MiniLM-L12-H384 (kernels #4-#6 at D 32) and bench.py's "
        "seq-128 BERT-base step (unfused) on the card")
    paths17, d32_rows = minilm_flagship(tpt, fa, device, card)
    by_path.update(paths17)
    log("minilm: " + json.dumps(MINILM_RUN))
    log("seq128: " + json.dumps(SEQ128_RUN))
    log(f"  (phase 17 took {MINILM_RUN['phase_s']:.1f} s; "
        f"{time.perf_counter() - t_start:.1f} s in all)")

    # phase 18 runs beside phase 17, where the profiler still sees the
    # card (PERF.md section 7)
    log("[18/18] Wide&Deep at the Criteo layout: dense, sparse and lazy "
        "Adam training lives and the serving net on the card")
    by_path.update(wide_deep_flagship(tpt, fa, card))
    log("wide_deep: " + json.dumps(WIDE_DEEP_RUN))
    log(f"  (phase 18 took {WIDE_DEEP_RUN['phase_s']:.1f} s; "
        f"{time.perf_counter() - t_start:.1f} s in all)")

    log("[8/18] Llama-2-7B-width training, card against the CPU (fp32)")
    by_path["llama_parity"] = llama_parity(tpt, fa)
    log(f"  ({time.perf_counter() - t_start:.1f} s so far)")

    log("[9/18] Llama-2-7B-width training on the card (4 layers, bf16 AMP)")
    llama_op_seed = registry._OP_SEED[0]  # phase 9's startup draws
    by_path["llama_flagship"], losses = llama_flagship(tpt, fa)
    compare_losses(losses)
    log(f"  ({time.perf_counter() - t_start:.1f} s so far)")

    # phase 16 runs here, where torch.profiler still sees the card (after
    # phase 14 its sessions have seen no device time or lost records)
    log("[16/18] float16 AMP with dynamic loss scaling: bench.py's seq-512 "
        "step and the Llama-2-7B-width step on the card")
    by_path.update(fp16_flagship(tpt, fa, llama_op_seed, losses))
    FP16["card"] = card
    FP16["kernel_checks_s"] = f16_s
    log("fp16: " + json.dumps(FP16))
    log(f"  (phase 16 took {FP16['phase_s']:.1f} s, the fp16 kernel checks "
        f"{f16_s:.1f} s; {time.perf_counter() - t_start:.1f} s in all)")

    log("[10/18] Llama generation serving on the card (dense and paged KV "
        "cache, speculative decoding, prefill / decode roles)")
    by_path["generation_parity"] = generation_parity(tpt, fa)
    by_path["generation"], paged_paths, gen_scope, dense_tokens = \
        generation_flagship(tpt, fa)
    by_path.update(paged_paths)
    log("generation: " + json.dumps(GENERATION))
    log("fetch: " + json.dumps(FETCH))
    log(f"  ({time.perf_counter() - t_start:.1f} s so far)")

    t11 = time.perf_counter()
    log("[11/18] the serving stack: BERT-base through ServingEngine, then "
        "HTTP with Llama-2-7B generation attached")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serving_") as wd:
        model_dir, second_dir, gen_second_dir = (
            os.path.join(wd, "model"), os.path.join(wd, "second"),
            os.path.join(wd, "gen_second"))
        eng, pred, feeds, want, want_second, by_path["serving_engine"] = \
            serving_engine_flagship(tpt, fa, model_dir, second_dir)
        by_path["serving_http"], gen_swapped_tokens = serving_http_flagship(
            tpt, fa, eng, pred, feeds, want, gen_scope, dense_tokens,
            gen_second_dir)
        SERVING["phase_s"] = time.perf_counter() - t11
        SERVING["card"] = card
        log("serving: " + json.dumps(SERVING))
        log(f"  (phase 11 took {SERVING['phase_s']:.1f} s; "
            f"{time.perf_counter() - t_start:.1f} s in all)")

        # phase 12 spawns replicas that need the card's memory: release
        # phases 10 and 11 (the weights' scope, the engines, their graphs
        # and private pools) first
        pred.close()
        del eng, pred, gen_scope
        t12 = time.perf_counter()
        log("[12/18] the fleet: BERT-base and Llama-2-7B in replica "
            "processes behind the router")
        FLEET["reserved_gib_before"] = release_card(
            "released phases 10 and 11")
        loadgen_dir = os.path.join(wd, "loadgen")
        os.makedirs(loadgen_dir)
        by_path["fleet_serving"] = trace_launches(fleet_serving(
            model_dir, second_dir, feeds, want, want_second,
            SERVING["engine"]["workers_2"], loadgen_dir), 0)
        by_path["fleet_generation"] = trace_launches(fleet_generation(
            gen_second_dir, gen_swapped_tokens, loadgen_dir), 3)
        FLEET["phase_s"] = time.perf_counter() - t12
        FLEET["card"] = card
        log("fleet: " + json.dumps(FLEET))
        log(f"  (phase 12 took {FLEET['phase_s']:.1f} s; "
            f"{time.perf_counter() - t_start:.1f} s in all)")

        t13 = time.perf_counter()
        log("[13/18] the port's load generator and chaos harness: "
            "BERT-base and Llama-2-7B fleets (13a's --url legs ran in "
            "phase 12)")
        by_path["loadgen"] = loadgen_in_process(
            fa, model_dir, SERVING["engine"]["workers_1"]["requests_per_s"],
            loadgen_dir)
    release_card("13a's engine closed")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_chaos_") as wd:
        model, model_dir = chaos_model(tpt, wd)
        probe = chaos_probe(model, model_dir)
        CHAOS["probe"] = probe
        by_path["chaos_fleet"] = trace_launches(probe["trace_records"], 0)
        settings = chaos_settings(probe,
                                  FLEET["serving"]["sigkill"]["respawn_s"])
        log("  13b settings (from the probe and 12a's respawn): "
            + json.dumps(settings))
        by_path["chaos"] = chaos_flagship(fa, model, settings)
    LOADGEN["card"] = CHAOS["card"] = card
    CHAOS["phase_s"] = time.perf_counter() - t13
    log("loadgen: " + json.dumps(LOADGEN))
    log("chaos: " + json.dumps(CHAOS))
    log(f"  (phase 13 took {CHAOS['phase_s']:.1f} s; "
        f"{time.perf_counter() - t_start:.1f} s in all)")

    log("[14/18] bench.py's seq-512 step under TrainGuard: a NaN, a SIGTERM "
        "and a resume, bit for bit")
    release_card("phase 13 closed")
    by_path["train_guard"] = train_guard_flagship(tpt, fa)
    GUARD["card"] = card
    log("train_guard: " + json.dumps(GUARD))
    log(f"  (phase 14 took {GUARD['phase_s']:.1f} s; "
        f"{time.perf_counter() - t_start:.1f} s in all)")

    log("[15/18] recompute: bench.py's seq-512 step and a Llama-2-7B-width "
        "decoder at seq 4096 under Llama-2's recipe, plain against "
        "recompute, bit for bit")
    release_card("phase 14 closed")
    by_path.update(recompute_flagship(tpt, fa, device))
    RECOMPUTE["card"] = card
    log("recompute: " + json.dumps(RECOMPUTE))
    log(f"  (phase 15 took {RECOMPUTE['phase_s']:.1f} s; "
        f"{time.perf_counter() - t_start:.1f} s in all)")
    for key, (wall, busy, idle, launches) in EAGER_PROFILES.items():
        p = PROFILES[key]
        ours = "not measured" if p["idle"] is None else \
            f"{100 * p['idle']:.1f}%"
        log(f"  {key}: wall {p['wall_ms']:.3f} ms (eager before: {wall}), "
            f"device busy {p['busy_ms']:.3f} ms ({busy}), idle {ours} "
            f"({idle}), host launches "
            f"{p['kernel_launches']} cudaLaunchKernel + "
            f"{p['graph_launches']} cudaGraphLaunch ({launches} "
            f"cudaLaunchKernel)")
    log("compiled step: " + json.dumps(PROFILES))

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
    # the unpacked kernels in bf16 at phase 15b's attention shape
    for i, name in ((3, "fwd"), (4, "dkv"), (5, "dq")):
        kernels[i]["seq4096"] = dict(shape=list(RECOMPUTE_ATTN),
                                     **seq4096[name])
    # the six kernels' fp16 instantiations: BERT's training shape [8, 512,
    # 2304] for the packed ones, the Llama shape for the unpacked ones
    f16_rows = {0: fwd_f16, 1: bwd_f16["dkv"], 2: bwd_f16["dq"],
                3: unpacked_f16["fwd"], 4: unpacked_f16["dkv"],
                5: unpacked_f16["dq"]}
    for i, row in f16_rows.items():
        kernels[i]["f16"] = {x: row[x] for x in (
            "device_ms", "ms", "bound_ms", "library_device_ms",
            "max_abs_err")}
    # the fp32 forward at generation's largest prefill bucket
    kernels[3]["f32_prefill"] = {x: fwd_f32["prefill"][x] for x in (
        "device_ms", "ms", "plain_ms", "bound_ms", "library_device_ms",
        "max_abs_err")}
    # the unpacked kernels at D 32 (MiniLM-L12-H384's heads): their bf16
    # rows at MiniLM's training shape, where phase 17c launches them, the
    # fp16 ones there too, the fp32 ones at its serving shape
    for slot, name, line in ((3, "fwd", "120"), (4, "dkv", "226"),
                             (5, "dq", "292")):
        row = dict(name=f"flash_attention_{name}_d32", route="cuda",
                   source=src + ("flash_attention_fwd.cu" if name == "fwd"
                                 else "flash_attention_bwd.cu"),
                   replaces=tpu + line, main_path="minilm_flagship",
                   slot=slot, shape=list(MINILM_TRAIN_ATTN),
                   **d32_rows["bfloat16"][name])
        for key, dtype in (("f16", "float16"), ("f32", "float32")):
            row[key] = {x: d32_rows[dtype][name][x] for x in (
                "device_ms", "ms", "plain_ms", "bound_ms", "library_ms",
                "library_device_ms", "max_abs_err")}
        row["f32_shape"] = list(MINILM_SERVE_ATTN)
        kernels.append(row)
    for i, k in enumerate(kernels):
        slot = k.pop("slot", i)
        k["launches"] = by_path[k.pop("main_path")][slot]
        k["launches_by_path"] = {p: n[slot] for p, n in by_path.items()}
        k["trace_record_paths"] = list(TRACE_PATHS)
    # the product kernel: its row is the decode step's qkv product (M 4),
    # its "shapes" every timed decode (M 4) and prefill (M 512) shape
    kernels.append(dict(
        name="gemm_f32", route="cuda", source=src + "gemm_f32.cu",
        replaces="paddle_tpu/ops/math_ops.py:365",
        **gemm_rows["M4_K4096_N12288"],
        launches=by_path["generation"].gemm,
        launches_by_path={p: getattr(n, "gemm", None)
                          for p, n in by_path.items()},
        trace_record_paths=list(TRACE_PATHS), tolerance_ratio=gemm_ratios, shapes=gemm_rows))
    # the RMSNorm kernel: its row the decode step's [4, 4096]
    kernels.append(dict(
        name="rms_norm_f32", route="cuda", source=src + "rms_norm_f32.cu",
        replaces="paddle_tpu/ops/nn_ops.py:772",
        **norm_rows["rows4_n4096"],
        launches=by_path["generation"].rms_norm,
        launches_by_path={p: getattr(n, "rms_norm", None)
                          for p, n in by_path.items()},
        trace_record_paths=list(TRACE_PATHS), shapes=norm_rows))
    # the SelectedRows merge kernel: its row the deep table's [106496, 10]
    # merge, its launches phase 18's lazy life's (two a step, one a table)
    kernels.append(dict(
        name="selected_rows_merge", route="cuda",
        source=src + "selected_rows.cu",
        replaces="paddle_tpu/framework/selected_rows.py:56",
        **merge_rows["cols10"],
        launches=by_path["wide_deep_lazy"].merge,
        launches_by_path={p: getattr(n, "merge", None)
                          for p, n in by_path.items()},
        shapes=merge_rows))
    for k in kernels:
        if not all(math.isfinite(x) for x in
                   [k[x] for x in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms")]
                   + list(k.get("f32", {}).values())
                   + list(k.get("f16", {}).values())
                   + list(k.get("f32_prefill", {}).values())
                   + [v for v in k.get("seq4096", {}).values()
                      if isinstance(v, float)]):
            raise AssertionError(f"non-finite measurement in {k}")
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} never launched on the path")
    log(f"chip_smoke: the run took {time.perf_counter() - t_start:.1f} s "
        f"(phase 16 {FP16['phase_s']:.1f} s, the fp16 kernel checks "
        f"{f16_s:.1f} s, phase 17 {MINILM_RUN['phase_s']:.1f} s, phase 18 "
        f"{WIDE_DEEP_RUN['phase_s']:.1f} s)")
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
