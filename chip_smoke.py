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
   and 512 rows.
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
   at the flagship training shape, at the Llama shape (causal) and at
   generation's largest prefill bucket ([1, 32, 512, 128] causal), the
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
   b. the flagship: Llama-2-7B (32 layers, fp32 weights from the startup
      program, 6.74 B parameters), 4 slots x 1024 positions (4 GiB of
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
      25.10 GiB of weights), runs them through HostBytesTransport (each
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
      speculating Llama-2-7B engine attached (32 layers, fp32, 4 slots x
      1024, phase 10's weights).  Gates (tolerance 0): /predict at batch
      1 equals the in-process answer; /healthz, /statusz (cost manifests,
      the H100's peaks), /tracez and /metrics (Prometheus text lines)
      answer; /generate for the 8 GEN_PROMPTS, plain and streamed, gives
      phase 10b's tokens, and a repetitive prompt with "speculate": true
      (drafts fire) gives the engine's plain stream for it;
      /adopt of a prefill-role server's segments gives them too; the
      launches of check_engine_counts over both engines; /swap "target":
      "generate" to a second set of weights (a checkpoint written to
      disk, 25.10 GiB, kept for phase 12b): every live weight then
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
      /predict, 16 closed-loop clients, five rounds.  Gates (tolerance
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
   b. Llama-2-7B (32 layers, MHA, fp32, 4 slots x 1024, 257 pages of 16,
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
      this process on Llama-2-7B at 32 layers (paged, pages of 16, 10c's
      buckets; spec_storm speculating); disagg_crash on four replicas of
      Llama-2-7B's widths at 4 layers (the only depth cut: four 25.10 GiB
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

Every profiled replay (phases 4, 5, 6 and 9) also holds the profiler's
launches of the forward, dK/dV and dQ kernels against what the
replay-aware counters added over it: a replay runs no wrapper, so this
is what shows that the counts the per-step gates read are the
kernels that ran.  torch.profiler now and then loses kernel records;
while the two disagree the replay is profiled again, up to 3 in all,
each profile's kernel records and launches logged.  A disagreement is
put down to lost records only in a profile with fewer kernel records
than another of the same replay; the profile with the most records
must agree (phase 4 and the flagships' profiled steps).

On every path (phases 4, 5, 6, 8, 9, 10) no bfloat16 operand is copied to
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
(13a in process) and chaos (13b in this process); and fleet_serving,
fleet_generation and chaos_fleet (12a, 12b, 13b's probe fleet), which
count kernel records in a replica's /profilez trace instead (the
replicas' counters live in their processes): each kernel's
"trace_record_paths" names them. Kernel #4's entry also carries "f32_prefill": the fp32
forward at the largest prefill bucket, [1, 32, 512, 128] causal. The
four backward entries also carry "f32": their fp32 kernel's device_ms,
ms, bound_ms and SDPA's fp32 backward's library_device_ms at the same
shape (BERT's training shape for the packed, the Llama shape for the
unpacked ones). The seventh entry is the product kernel (gemm_f32): its
row the decode step's qkv product (M 4, K 4096, N 12288), its "launches"
phase 10b's dense traffic's, "tolerance_ratio" the largest |kernel -
plain| / gemm.tolerance of phase 2 and the smallest of its TF32 and bf16
controls, "shapes" every shape phase 2 timed (decode attention's
products among them); the eighth the RMSNorm
kernel (rms_norm_f32): its row the decode step's [4, 4096], "library_ms"
torch.nn.functional.rms_norm's. The last lines are the card's name and
power limit, one {"kernels": ...} JSON line, and {"ok": true, "device":
{...}}. Before them, one "compiled step:" JSON line holds each profiled
path's wall ms, device busy ms, idle share and host launches
(serving_b4, bert_fp32, bert_flagship, llama_flagship), the run_async
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
# phase 10: greedy generation at Llama-2-7B's widths and depth, fp32
# weights, a dense KV cache of 4 slots x 1024 positions, prefill buckets
# 64-512, 8 requests of 20-500 prompt tokens and 64 new tokens each
GEN = dict(LLAMA, num_layers=32)
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
SERVE_ROUNDS = 5
SERVE_PROFILE_REQUESTS = 32
# 11b: the GEN_PROMPTS handed from a prefill-role server to /adopt
SERVE_ADOPT = (0, 3, 1)
# phase 11's numbers, for the "serving:" line
SERVING = {}
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
    from paddle_tpu_torch.ops.cuda import gemm, rms_norm

    return (fa.flash_attention_packed_reference,
            fa.flash_attention_packed_backward_reference,
            fa.flash_attention_reference,
            fa.flash_attention_backward_reference, gemm.matmul_reference,
            rms_norm.rms_norm_rows_reference)


def tma_wrappers(fa):
    """The wrappers that launch a bfloat16 TMA kernel and count the
    operands they had to copy to meet its alignment (``.realigned``): all
    six."""
    return kernel_wrappers(fa)


class Launches(tuple):
    """The six attention kernels' launches (a tuple, as the gates compare
    it), with the product kernel's and the RMSNorm kernel's beside them
    in ``.gemm`` and ``.rms_norm``."""
    gemm = 0
    rms_norm = 0


def reset_counts(fa):
    from paddle_tpu_torch.ops.cuda import gemm, rms_norm

    for w in kernel_wrappers(fa) + (gemm.matmul, rms_norm.rms_norm_rows):
        w.launches = 0
    for w in tma_wrappers(fa):
        w.realigned = 0
    for p in plain_versions(fa):
        p.calls = 0


def read_counts(fa):
    """(launches of the six kernels, with the product kernel's in
    ``.gemm`` and the RMSNorm kernel's in ``.rms_norm``; plain-version
    calls; operands realigned for TMA): a path must leave the last two at
    0."""
    from paddle_tpu_torch.ops.cuda import gemm, rms_norm

    counts = Launches(w.launches for w in kernel_wrappers(fa))
    counts.gemm = gemm.matmul.launches
    counts.rms_norm = rms_norm.rms_norm_rows.launches
    return (counts, sum(p.calls for p in plain_versions(fa)),
            sum(w.realigned for w in tma_wrappers(fa)))


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
# differ from the counters'
PROFILE_TRIES = 3


def profiled_launches(call, fa, what, key):
    """One profiled call of `call` (a replay): report_profile's numbers,
    and the profiler's launches held to the replay-aware counts
    (check_profiled_launches).  torch.profiler now and then loses kernel
    records; so while the two disagree the replay is profiled again, up
    to PROFILE_TRIES in all, each reading logged, and gated_profile
    decides which profile the gate holds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    readings, runs = [], []
    for attempt in range(1, PROFILE_TRIES + 1):
        before = read_counts(fa)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
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
    kernels, before, after, PROFILES[key] = runs[gated_profile(readings,
                                                               what)]
    check_profiled_launches(kernels, before, after, what)


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
            device_launches=sum(e.count for e in kernels))
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
    op's forward once (its grad op differentiates the graph the forward
    kept), then dK/dV and dQ once."""
    ops = main.global_block().ops
    packed = sum(op.type == "flash_attention_qkv" for op in ops)
    unpacked = sum(op.type == "flash_attention" for op in ops)
    return (packed, packed, packed, unpacked, unpacked, unpacked)


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
    run, from one startup scope copied (fp32, TF32 off, dropout 0).  Both
    run the same kernels on the same shapes, so the losses and every
    parameter are expected bit-equal; otherwise the largest differences
    are logged and held to the parity limits (loss rel LOSS_RTOL,
    parameters 2 * (sum of the LRs) and PARITY_PARAM_ATOL on 99.9%)."""
    import torch

    exe, dbg = tpt.Executor(), tpt.Executor()
    scope, dscope = tpt.Scope(), tpt.Scope()
    exe.run(startup, scope=scope)
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
    got = (tuple(a - b for a, b in zip(after[0], before[0])),
           after[1] - before[1], after[2] - before[2])
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
    """'gemm_skinny_kernel<4, 4, 1, 1>' for a product or RMSNorm kernel's
    mangled name (its template arguments in order), None for anything
    else."""
    m = re.search(r"((?:gemm_(?:skinny|tiled|fold)|rms_norm_rows(?:_loop)?)"
                  r"_kernel)(I\w*?E)?E", mangled)
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
    """ptxas's report of the product and RMSNorm sources: every function
    of both is in it, and none spills."""
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
    log(f"  product and RMSNorm kernel functions: {len(labels)} "
        f"({', '.join(labels)})")
    for prefix in ("gemm_tiled", "gemm_skinny", "gemm_fold", "rms_norm_rows"):
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
    import hashlib

    return hashlib.sha256(t.detach().cpu().contiguous().numpy()
                          .tobytes()).hexdigest()


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
    paged, speculating Llama-2-7B engine attached (32 layers, fp32, 4
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
                  "--gen-hidden", "4096", "--gen-layers", "32",
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
                  "fleet_generation": dict(fa_fwd_f32=32, gemm_f32=4 * 32,
                                           rms_norm_f32=2 * 32 + 1)}
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
    trace.json into the replica's metrics dir): the trace's events."""
    status, body = get(f"{url}/profilez?sec={sec}", timeout=300)
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
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_") as fd:
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
    colocated replica to the second weights phase 11b wrote (25.10 GiB,
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
    log("  12b hot swap of the generation weights (25.10 GiB): "
        + json.dumps(out))
    if not (res["converged"] and out["swap_status"] == 200
            and not out["fallback"] and out["hung_kills"] == 0
            and out["weights_version"] == 2
            and out["tokens_equal_fresh_engine"]
            and out["tokens_differ_from_first"]):
        raise AssertionError(f"12b hot swap: {out} {res}")
    return out


def fleet_generation(gen_second_dir, swapped_tokens, loadgen_dir):
    """Phase 12b: Llama-2-7B (32 layers, fp32, 4 slots x 1024, 257 pages
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
    with tempfile.TemporaryDirectory(prefix="chip_smoke_genfleet_") as fd:
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
# poison_paged and spec_storm: Llama-2-7B at 32 layers in this process,
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
    with tempfile.TemporaryDirectory(prefix="chip_smoke_chaos_probe_") as fd:
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
    with tempfile.TemporaryDirectory(prefix="chip_smoke_chaos_") as fd:
        report = chaos.run_chaos(
            replicas=CHAOS_REPLICAS, scenarios=chaos.DEFAULT_SCENARIOS,
            availability_pct=99.0, workdir=fd,
            log=lambda m: log("  13b " + m), device="cuda", model=model,
            gen_model=GEN, gen_engine=CHAOS_GEN_ENGINE,
            disagg_argv=CHAOS_DISAGG_ARGV, disagg_env=CHAOS_DISAGG_ENV,
            **settings)
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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch.ops.cuda import build, gemm, rms_norm
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    pkg_dir = os.path.dirname(os.path.abspath(tpt.__file__))
    if pkg_dir != os.path.join(HERE, "paddle_tpu_torch"):
        raise RuntimeError(f"paddle_tpu_torch imported from {pkg_dir}, not "
                           f"from this checkout")

    t_start = time.perf_counter()
    card = card_line()
    log(f"[1/13] device: {card}; torch {torch.__version__}, CUDA "
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
    log(f"[2/13] built {sorted(built)} in {time.perf_counter() - t0:.2f} s")
    check_build(build)
    gemm_rows, gemm_ratios = check_gemm(gemm, build, device)
    norm_rows = check_rms_norm(rms_norm, device)

    log("[3/13] packed kernels against their plain versions")
    check_kernel(fa, device)
    check_backward(fa, device)
    fwd_f32 = time_forward_f32(fa, device)
    time_forward_flagship(fa, device)
    bwd_timing = time_backward(fa, device, "bfloat16")
    bwd_f32 = time_backward(fa, device, "float32")
    log(f"  ({time.perf_counter() - t_start:.1f} s so far)")

    # each path's launches of the six kernels, each read from 0
    by_path = {}
    log("[4/13] BERT-base serving through Predictor on the card")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        by_path["serving"] = serve(tpt, fa, workdir)
    log(f"  ({time.perf_counter() - t_start:.1f} s so far)")

    log("[5/13] BERT-base training, card against the CPU (fp32)")
    by_path["training_parity"] = bert_parity(tpt, fa)
    bert_fp32_profile(tpt, fa)
    log(f"  ({time.perf_counter() - t_start:.1f} s so far)")

    log("[6/13] bench.py's seq-512 training step on the card (bf16 AMP)")
    by_path["training_flagship"], _ = bert_flagship(tpt, fa)
    log(f"  ({time.perf_counter() - t_start:.1f} s so far)")

    log("[7/13] unpacked kernels against their plain versions")
    check_unpacked(fa, device)
    unpacked_timing = time_unpacked(fa, device, "bfloat16")
    unpacked_f32 = time_unpacked(fa, device, "float32")
    log(f"  ({time.perf_counter() - t_start:.1f} s so far)")

    log("[8/13] Llama-2-7B-width training, card against the CPU (fp32)")
    by_path["llama_parity"] = llama_parity(tpt, fa)
    log(f"  ({time.perf_counter() - t_start:.1f} s so far)")

    log("[9/13] Llama-2-7B-width training on the card (4 layers, bf16 AMP)")
    by_path["llama_flagship"], losses = llama_flagship(tpt, fa)
    compare_losses(losses)
    log(f"  ({time.perf_counter() - t_start:.1f} s so far)")

    log("[10/13] Llama generation serving on the card (dense and paged KV "
        "cache, speculative decoding, prefill / decode roles)")
    by_path["generation_parity"] = generation_parity(tpt, fa)
    by_path["generation"], paged_paths, gen_scope, dense_tokens = \
        generation_flagship(tpt, fa)
    by_path.update(paged_paths)
    log("generation: " + json.dumps(GENERATION))
    log("fetch: " + json.dumps(FETCH))
    log(f"  ({time.perf_counter() - t_start:.1f} s so far)")

    t11 = time.perf_counter()
    log("[11/13] the serving stack: BERT-base through ServingEngine, then "
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
        log("[12/13] the fleet: BERT-base and Llama-2-7B in replica "
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
        log("[13/13] the port's load generator and chaos harness: "
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
    # the fp32 forward at generation's largest prefill bucket
    kernels[3]["f32_prefill"] = {x: fwd_f32["prefill"][x] for x in (
        "device_ms", "ms", "plain_ms", "bound_ms", "library_device_ms",
        "max_abs_err")}
    for i, k in enumerate(kernels):
        k["launches"] = by_path[k.pop("main_path")][i]
        k["launches_by_path"] = {p: n[i] for p, n in by_path.items()}
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
    for k in kernels:
        if not all(math.isfinite(x) for x in
                   [k[x] for x in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms")]
                   + list(k.get("f32", {}).values())
                   + list(k.get("f32_prefill", {}).values())):
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
