// Flash-attention backward for Hopper (sm_90a), each entry serving the
// packed or the unpacked layout of one TPU kernel of
// paddle_tpu/ops/pallas/flash_attention.py:
//
//   * the dK/dV entries replace `_fp_dkv_kernel` (pt_flash_attention_
//     packed_bwd_dkv; :611, launched by `_packed_backward` at :745) and
//     `_fa_dkv_kernel` (pt_flash_attention_bwd_dkv; :226, launched by
//     `_flash_backward` at :342): fa_dkv_tc_kernel in bfloat16 and
//     float16, fa_dkv_f32_kernel in float32.
//   * the dQ entries replace `_fp_dq_kernel` (pt_flash_attention_packed_
//     bwd_dq; :686) and `_fa_dq_kernel` (pt_flash_attention_bwd_dq; :292):
//     fa_dq_tc_kernel in bfloat16 and float16, fa_dq_f32_kernel in
//     float32.
//
// All read q [B, nh, Sq, D], k and v [B, nh, Sk, D], dO [B, nh, Sq, D]
// through per-tensor batch, head and row strides (the last dim contiguous:
// the packed layout is q, k and v as column blocks of qkv [B, S, 3H] and dO
// as [B, S, H]), the forward's per-row log-sum-exp lse [B, nh, Sq] and
// delta = rowsum(dO * O) [B, nh, Sq] (both float32), and the optional
// additive float32 [B, Sk] key bias.  They recompute
// p = exp(q.k^T * scale + bias - lse) tile by tile and never hold an
// Sq x Sk matrix in device memory:
//
//   dV = P^T dO,  dS = P * (dO V^T - delta),  dK = dS^T (q * scale),
//   dQ = dS K * scale,  dbias[k] = sum over heads and queries of dS.
//
// dq, dk and dv are written through their own strides too: the packed
// entries put them straight into the three column blocks of one [B, S, 3H]
// gradient, so nothing is concatenated afterwards.  The bias gradient is
// written as per-head partials [B, nh, Sk] that the wrapper sums: no
// atomics, so the sum is deterministic.  Any Sq and Sk work: rows and keys
// past them in the last tile are masked; causal masking is by absolute
// position (q_pos >= k_pos).  p is exactly 0 for a masked score and in a row
// with no live key (lse = -inf, the forward kernels' convention), never
// exp(-inf + inf).  The bias stays float32 (bfloat16 would round -10000 to
// -9984).
//
// Design (a block runs alone on Hopper, so a loop inside the block takes
// the place of the TPU's sequential grid axis):
//   * dK/dV, bfloat16 and float16 (fa_dkv_tc_kernel<T, D>, tensor cores,
//     one code for either 16-bit type T): one block of 256 threads per
//     (128-key tile, head, batch), so each key row is owned by one block
//     (no atomics, deterministic): two warpgroups of 64 keys.
//     The K and V tiles are loaded once by TMA and stay in 128B-swizzled
//     shared memory; the 64-row Q and dO tiles stream through a three-stage
//     TMA ring, from the diagonal q tile on when causal, each stage with
//     its rows' lse and delta (64 floats each, cp.async: a 1-D bulk copy
//     would need Sq % 4 == 0 and would read past the arrays at the ragged
//     end).  Warp 0 issues every load, between its own stages, one stage
//     behind the one just finished, so that it waits for the other
//     warpgroup only when that is a whole stage behind.  Per stage a
//     warpgroup computes S^T = K Q^T and dP^T = V dO^T with wgmma (both
//     operands K-major in shared memory; the exponentials run while dP^T's
//     product does), P^T = exp((S^T * scale + bias[key]) - lse[q]) (summed
//     in the plain version's order, so an all-padding row's -1e4 rounds
//     alike) and dS^T = P^T * (dP^T - delta[q]) in fp32 registers (the keys
//     are the rows, so each thread loads its two keys' bias once per block
//     and reads lse and delta from shared memory at use), rounds P^T and
//     dS^T to T in registers (the accumulator layout is wgmma's
//     A-fragment layout) and accumulates dV += P^T dO and dK += dS^T Q with
//     wgmma (dO and Q read MN-major from the same stage through the
//     transpose bit).  The bias gradient's row sums are taken from the fp32
//     dS^T, before the rounding, reduced over a quad once at the end, one
//     writer per key.  Registers are what shaped it: at D 128 a thread
//     holds dK, dV, S^T and dP^T (64 + 64 + 32 + 32 fp32).  ptxas sizes a
//     block's wgmma pipeline by its launch budget per thread (65536 over
//     the threads rounded up to whole warpgroups: 168 with a third,
//     producer warpgroup, setmaxnreg or not), and there it serialised the
//     wgmmas and spilled; two warpgroups get up to 255, and no spill.
//   * dK/dV, float32 (fa_dkv_f32_kernel, exact fp32 FMAs on the CUDA
//     cores; no TF32: the fp32 gates hold the port to the CPU at 1e-4):
//     one block of 8 warps per (key tile, head, batch), each warp owning
//     16 keys at D 32 and 64 (128-key tiles) and 8 at D 128 (64-key tiles),
//     whose
//     k * scale and v rows stay in shared memory; the 64-row Q and dO
//     tiles with their lse and delta stream through a two-stage ring
//     filled by 16-byte cp.async copies, one block barrier a tile (from
//     the diagonal q tile on when causal).  Lanes hold 4-key x 8-row (D
//     32 and 64) or 4 x 4 (D 128) patches of S^T and dP^T, then 4 keys x 8
//     columns (4 at D 32) of dK and dV; P^T and dS^T reach the second
//     products through a warp-private strip.  The bias gradient's sums
//     stay in registers, reduced by shuffles once at the end.  See
//     namespace f32 below.
//   * dQ, bfloat16 and float16 (fa_dq_tc_kernel<T, D>, tensor cores): one
//     block of 288 threads per (128-row q tile, head, batch), so each q
//     row is owned by one block (no atomics, deterministic): two consumer
//     warpgroups of 64 rows and a producer warp.  The producer loads Q and
//     dO once and streams 64-key K and V tiles through a two-stage TMA ring
//     (hopper.cuh).
//     Per tile a warpgroup computes S = Q K^T and dP = dO V^T with wgmma
//     (operands in shared memory), P = exp(S * scale + bias - lse) and
//     dS = P * (dP - delta) in fp32 registers, rounds dS to T in
//     registers and accumulates dQ += dS K with wgmma (K read MN-major from
//     the same shared tile through the transpose bit).  dQ stays in fp32
//     registers; the epilogue writes dq * scale in T.  In float16 both
//     kernels round dS * scale instead and write dq and dk unscaled
//     (kFold): float16 stops at 65504, and a loss-scaled dS alone can pass
//     it where dq and dk are still finite.  Inf and NaN are never clamped
//     or masked: an overflow in dO, q, k or v reaches dq, dk and dv, so
//     the loss scaler sees it.  Causal q tiles run longest first.
//   * D 32 in 16 bits (both tensor-core kernels): the tiles are 64-byte
//     swizzled (a row is 64 bytes; hopper.cuh's Tile), the score-side
//     products take two k16 steps and the accumulating ones (dQ += dS K,
//     dV += P^T dO, dK += dS^T Q) wgmma's n32 shape; nothing else changes.
//     At MiniLM-L12-H384's training shape (B 32, 12 heads, S 512, D 32)
//     each kernel recomputes B*nh*S^2 = 101 M exponentials, 26 us at the
//     ~3.9 T/s of the special-function units, above its products (dK/dV
//     25.8 GFLOP, dQ 19.3: 26 and 20 us) and its bytes.
//   * dQ, float32 (fa_dq_f32_kernel): one block of 8 warps per (q tile,
//     head, batch), each warp owning 16 q rows at D 32 and 64 (128-row
//     tiles) and
//     8 at D 128 (64-row tiles), whose q * scale and dO rows stay in
//     shared memory; 64-key K, V and bias tiles stream through the same
//     kind of ring (up to the diagonal when causal, the longest q tiles
//     first).  Lanes hold 4-row x 8-key (D 64) or 4 x 4 (D 128) patches of
//     S and dP, then 4 rows x 8 columns of dQ; dS goes through the strip.
//
// Bounds on an H100 SXM (data-sheet peaks at the card's 700 W limit).
// Packed, at BERT's training shape (B=8, S=512, 12 heads, D=64, bf16):
// dK/dV does 4 products of B*nh*S^2*D = 1.61e9 multiply-adds each, 12.9
// GFLOP, 13.0 us at the 989 TFLOP/s bf16 tensor-core peak, against about
// 38 MB moved (11.4 us at 3.35 TB/s); dQ 3 products, 9.7 GFLOP, 9.8 us.
// Unpacked, at Llama-2-7B width (B=1, 32 heads, S=2048, D=128, causal,
// bf16): dK/dV 6.87e10 flop (69.5 us), dQ 5.15e10 (52.1 us).  In fp32 (67
// TFLOP/s outside the tensor cores) the same work takes 192 us and 144 us
// at BERT's shape, 1026 us and 770 us at the Llama shape.  All are bound
// by operations.  Both bf16 kernels run their products on the tensor
// cores with loads kept off the compute warps.  The fp32 FMA pipes wait on
// shared-memory reads (a cycle per float a lane against 4 FMA instructions
// a cycle), which the register patches cut to 2-2.7 FMAs a float, and on
// loads, which the ring keeps in flight.  The fp32 products are exact
// FMAs (no TF32): the fp32 gates hold the port to the CPU at 1e-4.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"

namespace {

using hopper::Layout;

// Strides and sizes of one call.  The pointers travel as __restrict__
// kernel parameters, which keeps the read-only load path.
struct BwdShape {
  Layout ql, kl, vl, dol, dql, dkl, dvl;
  int Sq, Sk, num_heads, causal;
  float scale;
};

// Pointers and layouts of one backward call, as the entries receive them.
struct Call {
  const void *q, *k, *v, *dout, *bias, *lse, *delta;
  void *dq, *dk, *dv, *dbias_heads;
  BwdShape a;
  int B, D;
};

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

namespace f32 {

// Both kernels give each warp kR = 4 RG rows of its block's outputs (keys
// in dK/dV, q rows in dQ) and stream the other side in kTile-row tiles (q
// rows in dK/dV, keys in dQ) through a two-stage ring of shared memory
// filled by 16-byte cp.async copies: one block barrier a tile, the next
// tile landing while this one is computed.  A warp's lanes are RG row
// groups x kCG = 32 / RG column groups: lane (rg, cg) holds its rows
// 4 rg .. 4 rg + 3 against the tile's rows cg + kCG j (j < kTile / kCG) in
// the two score-side products, and against output columns 4 cg + 4 kCG jj
// .. + 3 (jj < D / (4 kCG)) in the accumulating ones.  The warp's own rows
// are read as broadcasts, the tile's rows from rows padded to D + 4
// floats, so the eight lanes of one phase of a 16-byte load fall in eight
// bank groups.  A shared-memory load costs the SM's load pipe a cycle per
// float a lane against 4 FMA instructions a cycle, so the patch sizes set
// the pace: a lane's score-side patches (4 rows x kJ = kTile / kCG) get
// 32 kJ FMAs from 32 + 8 kJ floats a 4-column step (2 a float at kJ 4,
// 2.7 at kJ 8), its accumulator patch (4 rows x c = D / kCG columns) 16 c
// FMAs from 16 + 4 c floats a 4-row step (2 at c 4, 2.7 at c 8).
constexpr int kTile = 64;              // streamed rows a tile
constexpr int kPStride = kTile + 4;    // a warp strip's row stride
constexpr int kWarps = 8;              // warps a block

// A warp's lanes as RG row groups x 32 / RG column groups.
template <int RG>
struct Lanes {
  static constexpr int kR = 4 * RG;      // rows a warp owns
  static constexpr int kCG = 32 / RG;    // column groups
  static constexpr int kJ = kTile / kCG; // tile rows a lane holds in S
};

// Shared memory of a block, in floats: a two-stage ring whose
// stage holds two padded tiles and kExtra floats (dQ: K, V and the keys'
// bias; dK/dV: Q, dO and the rows' lse and delta), then each warp's two
// operand row sets (dQ: q * scale and dO; dK/dV: k * scale and v) and its
// strip of the tile's P or dS (rows padded to kPStride).  Every part
// starts on a 16-byte boundary.
template <int D, int RG, int kExtra>
struct Smem {
  static constexpr int kS = D + 4;           // a tile row's stride
  static constexpr int kT = kTile * kS;      // one padded tile
  static constexpr int kStage = 2 * kT + kExtra;
  static constexpr int kOwn = 2 * Lanes<RG>::kR * D;  // a warp's rows
  static constexpr int kStrip = Lanes<RG>::kR * kPStride;
  static constexpr int kBytes = 4 * (2 * kStage + kWarps * (kOwn + kStrip));
};

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float c) {
  c = fmaf(a.x, b.x, c);
  c = fmaf(a.y, b.y, c);
  c = fmaf(a.z, b.z, c);
  return fmaf(a.w, b.w, c);
}

__device__ __forceinline__ float pick(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// The warp's kR rows r0 .. of two [rows, D] operands (row strides as, bs)
// into `dst` as [kR][D] each, the first times `mul`; rows past `rows` are
// zeros.  Read once a block, by __ldg.
template <int D, int kR>
__device__ __forceinline__ void load_own(float* dst, const float* a,
                                         long long as, const float* b,
                                         long long bs, int r0, int rows,
                                         float mul, int lane) {
  constexpr int kChunks = D / 4;
  for (int i = lane; i < kR * kChunks; i += 32) {
    const int r = i / kChunks, c = (i % kChunks) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
    if (r0 + r < rows) {
      x = __ldg(reinterpret_cast<const float4*>(a + (r0 + r) * as + c));
      y = __ldg(reinterpret_cast<const float4*>(b + (r0 + r) * bs + c));
    }
    x.x *= mul;
    x.y *= mul;
    x.z *= mul;
    x.w *= mul;
    *reinterpret_cast<float4*>(dst + r * D + c) = x;
    *reinterpret_cast<float4*>(dst + kR * D + r * D + c) = y;
  }
}

// Tile rows t0 .. t0 + kTile - 1 of two [rows, D] operands into a stage's
// two padded tiles as one thread's share of 16-byte cp.async copies: the
// same column chunk of rows r0, r0 + kStep, ... (the block's threads
// cover kStep rows a pass, from `ac` / `bc`, this thread's chunk of row r0
// of each); rows past `rows` are zero-filled.
template <int D, int RG, int kExtra>
__device__ __forceinline__ void load_tiles(float* st, const float* ac,
                                           const float* a0, long long as,
                                           const float* bc, const float* b0,
                                           long long bs, int t0, int rows,
                                           int r0, int col) {
  using S = Smem<D, RG, kExtra>;
  constexpr int kStep = 32 * kWarps / (D / 4);
  const float* ap = ac + (long long)t0 * as;
  const float* bp = bc + (long long)t0 * bs;
#pragma unroll
  for (int j = 0; j < kTile / kStep; ++j) {
    const int r = r0 + j * kStep;
    const bool in = t0 + r < rows;
    hopper::cp_async_16(st + r * S::kS + col, in ? ap : a0, in);
    hopper::cp_async_16(st + S::kT + r * S::kS + col, in ? bp : b0, in);
    ap += kStep * as;
    bp += kStep * bs;
  }
}

// acc += W X over one tile: W the lane's 4 strip rows (kTile weights each,
// read as float4 broadcasts), X the tile's kTile rows of D columns (row
// stride kS); the lane's columns 4 cg + 4 kCG jj .. + 3, four rows a step.
template <int D, int kCG, int kS>
__device__ __forceinline__ void accumulate(float (&acc)[4][D / kCG],
                                           const float* pr, const float* x,
                                           int cg) {
#pragma unroll 2
  for (int k = 0; k < kTile; k += 4) {
    float4 w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = *reinterpret_cast<const float4*>(pr + i * kPStride + k);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float* xr = x + (k + u) * kS + 4 * cg;
#pragma unroll
      for (int jj = 0; jj < D / (4 * kCG); ++jj) {
        const float4 y = *reinterpret_cast<const float4*>(xr + 4 * kCG * jj);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float c = pick(w[i], u);
          acc[i][4 * jj + 0] = fmaf(c, y.x, acc[i][4 * jj + 0]);
          acc[i][4 * jj + 1] = fmaf(c, y.y, acc[i][4 * jj + 1]);
          acc[i][4 * jj + 2] = fmaf(c, y.z, acc[i][4 * jj + 2]);
          acc[i][4 * jj + 3] = fmaf(c, y.w, acc[i][4 * jj + 3]);
        }
      }
    }
  }
}

// dK/dV: one block per (4 RG kWarps-key tile, head, batch), so each
// key row is owned by one block (no atomics, deterministic).  A warp's keys'
// k * scale and v rows stay in shared memory while the block loops over
// the 64-row q tiles (from the diagonal tile on when causal), each with its
// rows' lse and delta.  Per tile a lane computes a 4-key x kJ-row patch of
// S^T = (k * scale) q^T and dP^T = v dO^T, then P^T = exp(S^T + bias -
// lse) where live and dS^T = P^T (dP^T - delta); P^T and then dS^T go
// through the warp's strip to dV += P^T dO and dK += dS^T q, where the
// lane holds 4 keys x D / kCG columns of each.  The bias gradient's
// partial sums stay in registers, reduced over the kCG lanes of a row
// group by shuffles once at the end: one writer per key.
template <int D, int RG>
__global__ void __launch_bounds__(32 * kWarps)
fa_dkv_f32_kernel(const float* __restrict__ q_, const float* __restrict__ k_,
                  const float* __restrict__ v_,
                  const float* __restrict__ dout,
                  const float* __restrict__ bias,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dk,
                  float* __restrict__ dv, float* __restrict__ dbias_heads,
                  const BwdShape a) {
  constexpr int kR = Lanes<RG>::kR, kCG = Lanes<RG>::kCG, kJ = Lanes<RG>::kJ;
  constexpr int CP = D / kCG;  // output columns a lane
  using S = Smem<D, RG, 2 * kTile>;
  constexpr int kKeys = kWarps * kR;  // keys per block
  extern __shared__ float4 smem_f4[];
  float* sm = reinterpret_cast<float*>(smem_f4);

  const int nh = a.num_heads, Sq = a.Sq, Sk = a.Sk;
  const int h = blockIdx.x % nh, b = blockIdx.x / nh;
  const int k0 = blockIdx.y * kKeys;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rg = lane / kCG, cg = lane % kCG;
  const int kw0 = k0 + warp * kR;  // the warp's first key
  const int my0 = kw0 + 4 * rg;    // the lane's first key
  // causal: q tiles before the diagonal see no key of this block
  const int first = a.causal ? k0 / kTile : 0;
  const int n = max((Sq + kTile - 1) / kTile - first, 0);
  const long long stats = ((long long)b * nh + h) * Sq;
  const float* qb = q_ + b * a.ql.b + h * a.ql.h;
  const float* ob = dout + b * a.dol.b + h * a.dol.h;

  // q tile first + t into stage t % 2: Q and dO by 16-byte copies, the
  // rows' lse and delta by 4-byte ones (a row past Sq copies row Sq - 1;
  // the mask drops it); one cp.async group
  const int col = (tid % (D / 4)) * 4, r0 = tid / (D / 4);
  const float* qc = qb + (long long)r0 * a.ql.s + col;
  const float* oc = ob + (long long)r0 * a.dol.s + col;
  auto load = [&](int t) {
    float* st = sm + (t & 1) * S::kStage;
    const int q0 = (first + t) * kTile;
    load_tiles<D, RG, 2 * kTile>(st, qc, qb, a.ql.s, oc, ob, a.dol.s, q0, Sq,
                                 r0, col);
    for (int i = tid; i < 2 * kTile; i += 32 * kWarps) {
      const long long q = stats + min(q0 + i % kTile, Sq - 1);
      hopper::cp_async_f32(st + 2 * S::kT + i, (i < kTile ? lse : delta) + q);
    }
    hopper::cp_async_commit();
  };
  if (n > 0) load(0);

  // the warp's keys: k * scale and v rows, zeros past Sk; the lane's
  // keys' bias
  float* kw = sm + 2 * S::kStage + warp * S::kOwn;
  float* vw = kw + kR * D;
  float* ps = sm + 2 * S::kStage + kWarps * S::kOwn + warp * S::kStrip;
  load_own<D, kR>(kw, k_ + b * a.kl.b + h * a.kl.h, a.kl.s,
              v_ + b * a.vl.b + h * a.vl.h, a.vl.s, kw0, Sk, a.scale, lane);
  float bk[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    bk[i] = bias ? __ldg(bias + (long long)b * Sk + min(my0 + i, Sk - 1))
                 : 0.f;

  float dka[4][CP], dva[4][CP], db[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    db[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CP; ++c) dka[i][c] = dva[i][c] = 0.f;
  }
  const bool keys_live = kw0 < Sk;
  const float* kr = kw + 4 * rg * D;        // the lane's keys' rows
  const float* vr = vw + 4 * rg * D;
  float* pr = ps + 4 * rg * kPStride;       // and strip rows

  for (int t = 0; t < n; ++t) {
    // tile t has landed for every thread, and every warp is done with
    // tile t - 1, whose stage the next load reuses: the one block barrier
    hopper::cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < n) load(t + 1);
    const int q0 = (first + t) * kTile;
    // else the warp's keys all come after the tile's last row
    if (!keys_live || (a.causal && kw0 > q0 + kTile - 1)) continue;
    const float* qs = sm + (t & 1) * S::kStage;
    const float* os = qs + S::kT;
    const float* ls = os + S::kT;  // lse [kTile], then delta [kTile]

    // S^T = (k * scale) q^T and dP^T = v dO^T: keys my0 + i, q rows
    // q0 + cg + kCG j
    float s[4][kJ], dp[4][kJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j) s[i][j] = dp[i][j] = 0.f;
    const float* qcol = qs + cg * S::kS;
    const float* ocol = os + cg * S::kS;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 kx[4], vx[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kx[i] = *reinterpret_cast<const float4*>(kr + i * D + d);
        vx[i] = *reinterpret_cast<const float4*>(vr + i * D + d);
      }
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const float4 qx =
            *reinterpret_cast<const float4*>(qcol + j * kCG * S::kS + d);
        const float4 ox =
            *reinterpret_cast<const float4*>(ocol + j * kCG * S::kS + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][j] = dot4(kx[i], qx, s[i][j]);
          dp[i][j] = dot4(vx[i], ox, dp[i][j]);
        }
      }
    }

    // P^T into the strip, dS^T = P^T (dP^T - delta) in place of dP^T and
    // its row sums.  Score and bias are summed before lse is taken off, as
    // the plain version does: an all-padding row's -1e4 rounds alike.
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int ql = cg + kCG * j;
      const int q = q0 + ql;
      const float l = ls[ql], dl = ls[kTile + ql];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = my0 + i;
        const bool live = q < Sq && key < Sk && !(a.causal && key > q) &&
                          l != -INFINITY;
        const float p = live ? expf(s[i][j] + bk[i] - l) : 0.f;
        dp[i][j] = p * (dp[i][j] - dl);
        db[i] += dp[i][j];
        pr[i * kPStride + ql] = p;
      }
    }
    __syncwarp();

    // dV += P^T dO, then (the strip refilled with dS^T) dK += dS^T q
    accumulate<D, kCG, S::kS>(dva, pr, os, cg);
    __syncwarp();  // every lane has read P^T
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i * kPStride + cg + kCG * j] = dp[i][j];
    __syncwarp();
    accumulate<D, kCG, S::kS>(dka, pr, qs, cg);
    // the strip's next writes follow the next block barrier
  }

  // epilogue: dk = acc * scale and dv through the strides; each key's bias
  // gradient summed over its row group's 16 lanes, written by one
  float* dkb = dk + b * a.dkl.b + h * a.dkl.h;
  float* dvb = dv + b * a.dvl.b + h * a.dvl.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = my0 + i;
    float x = db[i];
#pragma unroll
    for (int off = kCG / 2; off > 0; off >>= 1)
      x += __shfl_xor_sync(0xffffffffu, x, off);
    if (key >= Sk) continue;
    if (dbias_heads && cg == 0)
      dbias_heads[((long long)b * nh + h) * Sk + key] = x;
    float* krow = dkb + (long long)key * a.dkl.s + 4 * cg;
    float* vrow = dvb + (long long)key * a.dvl.s + 4 * cg;
#pragma unroll
    for (int jj = 0; jj < CP / 4; ++jj) {
      *reinterpret_cast<float4*>(krow + 4 * kCG * jj) = make_float4(
          dka[i][4 * jj] * a.scale, dka[i][4 * jj + 1] * a.scale,
          dka[i][4 * jj + 2] * a.scale, dka[i][4 * jj + 3] * a.scale);
      *reinterpret_cast<float4*>(vrow + 4 * kCG * jj) =
          make_float4(dva[i][4 * jj], dva[i][4 * jj + 1], dva[i][4 * jj + 2],
                      dva[i][4 * jj + 3]);
    }
  }
}

// dQ: one block per (4 RG kWarps-row q tile, head, batch), so each q
// row is owned by one block; causal q tiles run longest first.  A warp's
// rows' q * scale and dO stay in shared memory while the block loops over
// the 64-key K, V and bias tiles (up to the diagonal when causal).  Per
// tile a lane computes a 4-row x kJ-key patch of S = (q * scale) K^T and
// dP = dO V^T, then dS = P (dP - delta) with P = exp(S + bias - lse) where
// live; dS goes through the warp's strip to dQ += dS K, where the lane
// holds 4 rows x D / kCG columns.  The epilogue writes dq = acc * scale.
template <int D, int RG>
__global__ void __launch_bounds__(32 * kWarps)
fa_dq_f32_kernel(const float* __restrict__ q_, const float* __restrict__ k_,
                 const float* __restrict__ v_, const float* __restrict__ dout,
                 const float* __restrict__ bias,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq,
                 const BwdShape a) {
  constexpr int kR = Lanes<RG>::kR, kCG = Lanes<RG>::kCG, kJ = Lanes<RG>::kJ;
  constexpr int CP = D / kCG;
  using S = Smem<D, RG, kTile>;
  constexpr int kRows = kWarps * kR;  // q rows per block
  extern __shared__ float4 smem_f4[];
  float* sm = reinterpret_cast<float*>(smem_f4);

  const int nh = a.num_heads, Sq = a.Sq, Sk = a.Sk;
  const int h = blockIdx.x % nh, b = blockIdx.x / nh;
  // causal: the longest q tiles first, the short ones fill the tail
  const int qt = a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * kRows;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rg = lane / kCG, cg = lane % kCG;
  const int row0 = q0 + warp * kR;  // the warp's first row
  const int my0 = row0 + 4 * rg;    // the lane's first row
  const float* kb = k_ + b * a.kl.b + h * a.kl.h;
  const float* vb = v_ + b * a.vl.b + h * a.vl.h;
  const float* brow = bias ? bias + (long long)b * Sk : nullptr;
  int nkt = (Sk + kTile - 1) / kTile;
  if (a.causal) nkt = min(nkt, (q0 + kRows - 1) / kTile + 1);  // later dead

  // key tile t into stage t % 2: K and V by 16-byte copies, the tile's
  // bias by 4-byte ones (keys past Sk: never read live); one group
  const int col = (tid % (D / 4)) * 4, r0 = tid / (D / 4);
  const float* kc = kb + (long long)r0 * a.kl.s + col;
  const float* vc = vb + (long long)r0 * a.vl.s + col;
  auto load = [&](int t) {
    float* st = sm + (t & 1) * S::kStage;
    const int k0 = t * kTile;
    load_tiles<D, RG, kTile>(st, kc, kb, a.kl.s, vc, vb, a.vl.s, k0, Sk, r0,
                             col);
    if (brow)
      for (int i = tid; i < kTile; i += 32 * kWarps)
        if (k0 + i < Sk)
          hopper::cp_async_f32(st + 2 * S::kT + i, brow + k0 + i);
    hopper::cp_async_commit();
  };
  load(0);

  // the warp's rows: q * scale and dO, zeros past Sq (as the TPU kernels
  // do: q * scale, then q . k); the lane's rows' lse and delta, a row
  // past Sq as one with no live key
  float* qw = sm + 2 * S::kStage + warp * S::kOwn;
  float* ow = qw + kR * D;
  float* ps = sm + 2 * S::kStage + kWarps * S::kOwn + warp * S::kStrip;
  load_own<D, kR>(qw, q_ + b * a.ql.b + h * a.ql.h, a.ql.s,
              dout + b * a.dol.b + h * a.dol.h, a.dol.s, row0, Sq, a.scale,
              lane);
  const long long stats = ((long long)b * nh + h) * Sq;
  float lse_r[4], dlt_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = my0 + i;
    lse_r[i] = row < Sq ? lse[stats + row] : -INFINITY;
    dlt_r[i] = row < Sq ? delta[stats + row] : 0.f;
  }

  float acc[4][CP];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CP; ++c) acc[i][c] = 0.f;
  const bool rows_live = row0 < Sq;
  const int row_last = row0 + kR - 1;
  const float* qr = qw + 4 * rg * D;  // the lane's rows
  const float* orr = ow + 4 * rg * D;
  float* pr = ps + 4 * rg * kPStride;

  for (int t = 0; t < nkt; ++t) {
    hopper::cp_async_wait<0>();
    __syncthreads();  // the one block barrier a tile, as in dK/dV
    if (t + 1 < nkt) load(t + 1);
    const int k0 = t * kTile;
    if (!rows_live || (a.causal && k0 > row_last)) continue;  // all dead
    const float* ks = sm + (t & 1) * S::kStage;
    const float* vs = ks + S::kT;
    const float* bs = vs + S::kT;

    // S = (q * scale) K^T and dP = dO V^T: rows my0 + i, keys k0 + cg +
    // kCG j
    float s[4][kJ], dp[4][kJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j) s[i][j] = dp[i][j] = 0.f;
    const float* kcol = ks + cg * S::kS;
    const float* vcol = vs + cg * S::kS;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 qx[4], ox[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qx[i] = *reinterpret_cast<const float4*>(qr + i * D + d);
        ox[i] = *reinterpret_cast<const float4*>(orr + i * D + d);
      }
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const float4 kx =
            *reinterpret_cast<const float4*>(kcol + j * kCG * S::kS + d);
        const float4 vx =
            *reinterpret_cast<const float4*>(vcol + j * kCG * S::kS + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][j] = dot4(qx[i], kx, s[i][j]);
          dp[i][j] = dot4(ox[i], vx, dp[i][j]);
        }
      }
    }

    // dS = P (dP - delta) into the strip; score and bias summed before lse
    // is taken off, as the plain version does
    float bv[kJ];
#pragma unroll
    for (int j = 0; j < kJ; ++j) bv[j] = brow ? bs[cg + kCG * j] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = my0 + i;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int key = k0 + cg + kCG * j;
        const bool live = key < Sk && !(a.causal && key > row) &&
                          lse_r[i] != -INFINITY;
        const float p = live ? expf(s[i][j] + bv[j] - lse_r[i]) : 0.f;
        pr[i * kPStride + cg + kCG * j] = p * (dp[i][j] - dlt_r[i]);
      }
    }
    __syncwarp();

    // dQ += dS K
    accumulate<D, kCG, S::kS>(acc, pr, ks, cg);
    // the strip's next writes follow the next block barrier
  }
  if (!rows_live) return;

  // epilogue: dq = acc * scale through the strides
  float* dqb = dq + b * a.dql.b + h * a.dql.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = my0 + i;
    if (row >= Sq) continue;
    float* qrow = dqb + (long long)row * a.dql.s + 4 * cg;
#pragma unroll
    for (int jj = 0; jj < CP / 4; ++jj)
      *reinterpret_cast<float4*>(qrow + 4 * kCG * jj) = make_float4(
          acc[i][4 * jj] * a.scale, acc[i][4 * jj + 1] * a.scale,
          acc[i][4 * jj + 2] * a.scale, acc[i][4 * jj + 3] * a.scale);
  }
}

// Whether every operand of the call can go through the 16-byte copies and
// stores (the wrappers copy an input that cannot; outputs are fresh).
inline bool aligned(const Call& c) {
  using hopper::aligned16;
  const BwdShape& a = c.a;
  const int B = c.B, nh = a.num_heads;
  return aligned16(c.q, a.ql, B, nh, a.Sq) &&
         aligned16(c.k, a.kl, B, nh, a.Sk) &&
         aligned16(c.v, a.vl, B, nh, a.Sk) &&
         aligned16(c.dout, a.dol, B, nh, a.Sq) &&
         (!c.dq || aligned16(c.dq, a.dql, B, nh, a.Sq)) &&
         (!c.dk || aligned16(c.dk, a.dkl, B, nh, a.Sk)) &&
         (!c.dv || aligned16(c.dv, a.dvl, B, nh, a.Sk));
}

template <int D, int RG>
int launch_dkv(const Call& c, cudaStream_t stream) {
  if (!aligned(c)) return (int)cudaErrorMisalignedAddress;
  constexpr int smem = Smem<D, RG, 2 * kTile>::kBytes;
  constexpr int kRows = kWarps * Lanes<RG>::kR;
  static const cudaError_t attr = hopper::set_smem_limit(
      fa_dkv_f32_kernel<D, RG>, smem, /*max_carveout=*/true);
  if (attr != cudaSuccess) return (int)attr;
  const int tiles = (c.a.Sk + kRows - 1) / kRows;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(c.B * c.a.num_heads, tiles);
  fa_dkv_f32_kernel<D, RG><<<grid, 32 * kWarps, smem, stream>>>(
      static_cast<const float*>(c.q), static_cast<const float*>(c.k),
      static_cast<const float*>(c.v), static_cast<const float*>(c.dout),
      static_cast<const float*>(c.bias), static_cast<const float*>(c.lse),
      static_cast<const float*>(c.delta), static_cast<float*>(c.dk),
      static_cast<float*>(c.dv), static_cast<float*>(c.dbias_heads), c.a);
  return (int)cudaGetLastError();
}

template <int D, int RG>
int launch_dq(const Call& c, cudaStream_t stream) {
  if (!aligned(c)) return (int)cudaErrorMisalignedAddress;
  constexpr int smem = Smem<D, RG, kTile>::kBytes;
  constexpr int kRows = kWarps * Lanes<RG>::kR;
  static const cudaError_t attr = hopper::set_smem_limit(
      fa_dq_f32_kernel<D, RG>, smem, /*max_carveout=*/true);
  if (attr != cudaSuccess) return (int)attr;
  const int tiles = (c.a.Sq + kRows - 1) / kRows;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(c.B * c.a.num_heads, tiles);
  fa_dq_f32_kernel<D, RG><<<grid, 32 * kWarps, smem, stream>>>(
      static_cast<const float*>(c.q), static_cast<const float*>(c.k),
      static_cast<const float*>(c.v), static_cast<const float*>(c.dout),
      static_cast<const float*>(c.bias), static_cast<const float*>(c.lse),
      static_cast<const float*>(c.delta), static_cast<float*>(c.dq), c.a);
  return (int)cudaGetLastError();
}

}  // namespace f32

namespace tc {

using namespace hopper::attn;

// float16 folds the softmax scale into dS before rounding it to an A
// fragment (dq = (dS scale) K, dk = (dS scale)^T Q), so the rounded dS
// is no larger than what the outputs themselves hold: dS alone can pass
// 65504 under a large loss scale where dq and dk, a factor 1/sqrt(D)
// smaller, are still finite.  bfloat16 has float32's range and keeps its
// product order (its outputs stay bit-identical).
template <typename T>
constexpr bool kFold = hopper::kIsF16<T>;

// Shared memory: the Q and dO tiles, the K/V ring, its barriers, and slack
// to align the tiles to 1024 bytes.
template <int D>
constexpr int kDqSmem =
    2 * kRowTile<D> + Ring<D>::kBytes + Ring<D>::kBarBytes + 1024;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
fa_dq_tc_kernel(const __grid_constant__ hopper::TmaMaps<4> maps,
                const float* __restrict__ bias, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq,
                const BwdShape a) {
  constexpr int kQ = kRowTile<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = hopper::align1024(smem_raw);
  Ring<D> ring(sm + 2 * kQ, sm + 2 * kQ + Ring<D>::kBytes);
  const Frame f(a.num_heads, a.Sk, a.causal);
  const int Sq = a.Sq, Sk = a.Sk, nkt = f.nkt, quad = f.quad;

  if (threadIdx.x == 0) ring.init(kConsumerWarps);
  __syncthreads();

  if (f.producer()) {  // one thread issues every load
    if (f.lane == 0) {
      hopper::mbar_expect_tx(ring.q_full, 2 * kQ);
      load_rows<D>(sm, &maps.m[0], ring.q_full, f);
      load_rows<D>(sm + kQ, &maps.m[3], ring.q_full, f);
      ring.produce(&maps.m[1], &maps.m[2], nkt, f.h, f.b);
    }
    return;
  }

  const int row0 = f.row0, wg_last = f.wg_last;
  const uint8_t* qs = wg_rows<D>(sm, f.wg);
  const uint8_t* dos = qs + kQ;
  const float* brow = bias ? bias + (long long)f.b * Sk : nullptr;
  const long long stats = ((long long)f.b * a.num_heads + f.h) * Sq;
  float lse_r[2], dlt_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    // a row past Sq behaves as a row with no live key: p = 0
    lse_r[i] = row < Sq ? lse[stats + row] : -INFINITY;
    dlt_r[i] = row < Sq ? delta[stats + row] : 0.f;
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[kBN / 2], dp[kBN / 2];

  hopper::mbar_wait(ring.q_full, 0);
  for (int t = 0; t < nkt; ++t) {
    const int k0 = t * kBN;
    ring.wait(t);
    if (!(a.causal && k0 > wg_last)) {  // else every key of the tile is dead
      // S = Q K^T, dP = dO V^T
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss_n64<T>(
            s, hopper::desc_k_step<D>(qs, kBM, kk),
            hopper::desc_k_step<D>(ring.k(t), kBN, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss_n64<T>(
            dp, hopper::desc_k_step<D>(dos, kBM, kk),
            hopper::desc_k_step<D>(ring.v(t), kBN, kk), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(s);
      hopper::fence_regs(dp);

      // p and dS = p * (dP - delta), in place of S, key by key: each key's
      // bias is loaded once for both of this thread's rows (an array of the
      // tile's 16 would spill the D-128 kernel past its 168 registers)
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int key = k0 + 8 * j + 2 * quad + c;
          const float bk = brow ? __ldg(brow + min(key, Sk - 1)) : 0.f;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = 4 * j + 2 * i + c;
            const bool live = key < Sk && !(a.causal && key > row0 + 8 * i) &&
                              lse_r[i] != -INFINITY;
            const float x = s[r] * a.scale + bk - lse_r[i];
            const float p = live ? exp2f(x * kLog2e) : 0.f;
            s[r] = p * (dp[r] - dlt_r[i]);
          }
        }

      // dS in T as wgmma A fragments: 16 keys per fragment.  float16
      // takes dS * scale (kFold), so that it overflows 65504 only where
      // dq itself would
      uint32_t ds[kBN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float lo = s[8 * kk + 2 * r], hi = s[8 * kk + 2 * r + 1];
          if constexpr (kFold<T>)
            ds[kk][r] = hopper::pack16<T>(lo * a.scale, hi * a.scale);
          else
            ds[kk][r] = hopper::pack16<T>(lo, hi);
        }

      // dQ += dS K
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        hopper::wgmma_rs<T, D>(
            acc, ds[kk], hopper::desc_mn_step<D>(ring.k(t), kBN, kk));
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(acc);
    }
    ring.release(t);
  }

  // epilogue: dq (times scale unless folded) in T through the strides
  const float sc = kFold<T> ? 1.f : a.scale;
  const float mul[2] = {sc, sc};
  store16<T, D>(dq + f.b * a.dql.b + f.h * a.dql.h, a.dql.s, Sq, row0, quad,
                acc, mul);
}

template <typename T, int D>
int launch_dq(const Call& c, cudaStream_t stream) {
  const BwdShape& a = c.a;
  const int nh = a.num_heads;
  if (!pairs_aligned(c.dq, a.dql)) return (int)cudaErrorMisalignedAddress;
  hopper::TmaMaps<4> maps;
  const Operand ops[4] = {{c.q, a.Sq, a.ql, kBM},
                          {c.k, a.Sk, a.kl, kBN},
                          {c.v, a.Sk, a.vl, kBN},
                          {c.dout, a.Sq, a.dol, kBM}};
  const int err = encode_maps<T>(&maps, ops, D, nh, c.B);
  if (err) return err;
  constexpr int smem = kDqSmem<D>;
  static const cudaError_t attr = hopper::set_smem_limit(
      fa_dq_tc_kernel<T, D>, smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid(c.B * nh, (a.Sq + kBM - 1) / kBM);
  fa_dq_tc_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      maps, static_cast<const float*>(c.bias),
      static_cast<const float*>(c.lse), static_cast<const float*>(c.delta),
      static_cast<T*>(c.dq), a);
  return (int)cudaGetLastError();
}

// dK/dV: 128 keys a block, 64 per warpgroup, q tiles of 64 rows streamed
// through the ring (the dQ kernel's frame turned around: the keys are the
// rows of every accumulator); two warpgroups and no producer warp, for
// the registers (see the top of the file).
constexpr int kKeys = 128;                           // keys per block
constexpr int kQRows = 64;                           // q rows per stage
constexpr int kQStages = 3;                          // Q/dO ring depth
constexpr int kDkvThreads = 2 * 128;                 // two warpgroups

template <int D>
using QRing = hopper::KvRing<D, kQRows, kQStages>;

// K and V (kKeys x D 16-bit values each), the ring, its stats (lse and delta,
// kQRows floats each a stage), its barriers, and alignment slack.
template <int D>
constexpr int kKvTile = kKeys * D * 2;
constexpr int kStatBytes = kQStages * 2 * kQRows * 4;
template <int D>
constexpr int kDkvSmem = 2 * kKvTile<D> + QRing<D>::kBytes + kStatBytes +
                         QRing<D>::kBarBytes + 1024;

template <typename T, int D>
__global__ void __launch_bounds__(kDkvThreads, 1)
fa_dkv_tc_kernel(const __grid_constant__ hopper::TmaMaps<4> maps,
                 const float* __restrict__ bias, const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, float* __restrict__ dbias_heads,
                 const BwdShape a) {
  constexpr int kKV = kKvTile<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = hopper::align1024(smem_raw);
  uint8_t* ring_tiles = sm + 2 * kKV;
  float* stats = reinterpret_cast<float*>(ring_tiles + QRing<D>::kBytes);
  QRing<D> ring(ring_tiles, ring_tiles + QRing<D>::kBytes + kStatBytes);

  const int nh = a.num_heads, Sq = a.Sq, Sk = a.Sk;
  const int h = blockIdx.x % nh, b = blockIdx.x / nh;
  const int k0 = blockIdx.y * kKeys;
  // causal: q tiles before the diagonal see no key of this block
  const int first = a.causal ? k0 / kQRows : 0;
  const int n = max((Sq + kQRows - 1) / kQRows - first, 0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = ((long long)b * nh + h) * Sq;

  // Warp 0 fills iteration j's stage once it is free: every lane copies two
  // rows' lse and delta with cp.async (a row past Sq copies row Sq - 1; the
  // consumers mask it) and arrives when they land, lane 0 also with the Q
  // and dO tiles' bytes: 33 arrivals a fill.
  auto fill = [&](int j) {
    ring.acquire(j);
    const int q0 = (first + j) * kQRows;
    float* st = stats + (j % kQStages) * 2 * kQRows;
    for (int r = lane; r < kQRows; r += 32) {
      const long long q = row + min(q0 + r, Sq - 1);
      hopper::cp_async_f32(st + r, lse + q);
      hopper::cp_async_f32(st + kQRows + r, delta + q);
    }
    hopper::cp_async_arrive(&ring.full[j % kQStages]);
    if (lane == 0) ring.load(&maps.m[0], &maps.m[3], j, first + j, h, b);
  };

  if (threadIdx.x == 0) ring.init(kDkvThreads / 32, 33);
  __syncthreads();
  if (warp == 0) {
    if (lane == 0) {  // K and V once
      hopper::mbar_expect_tx(ring.q_full, 2 * kKV);
      using L = hopper::Tile<D>;
      for (int c = 0; c < L::kBoxes; ++c) {
        hopper::tma_load(sm + c * kKeys * L::kSpan, &maps.m[1], ring.q_full,
                         c * L::kCols, h, k0, b);
        hopper::tma_load(sm + kKV + c * kKeys * L::kSpan, &maps.m[2],
                         ring.q_full, c * L::kCols, h, k0, b);
      }
    }
    for (int j = 0; j < min(n, kQStages - 1); ++j) fill(j);
  }

  // this warpgroup's keys kw0 .. kw0 + 63
  const int wg = warp / 4, quad = lane % 4;
  const int kw0 = k0 + wg * 64;
  const int row0 = kw0 + (warp % 4) * 16 + lane / 4;  // keys row0, row0 + 8
  const uint8_t* ks = wg_rows<D>(sm, wg);
  const uint8_t* vs = ks + kKV;
  float bk[2];  // this thread's keys' bias
#pragma unroll
  for (int i = 0; i < 2; ++i)
    bk[i] = bias ? __ldg(bias + (long long)b * Sk + min(row0 + 8 * i, Sk - 1))
                 : 0.f;

  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  float db[2] = {0.f, 0.f};  // bias-gradient row sums

  hopper::mbar_wait(ring.q_full, 0);
  for (int i = 0; i < n; ++i) {
    const int q0 = (first + i) * kQRows;
    ring.wait(i);
    // else this warpgroup's keys all come after the stage's last row
    if (!(a.causal && kw0 > q0 + kQRows - 1)) {
      const uint8_t* qs = ring.k(i);
      const uint8_t* dos = ring.v(i);
      const float* st = stats + (i % kQStages) * 2 * kQRows;
      float s[kQRows / 2], dp[kQRows / 2];

      // S^T = K Q^T, then dP^T = V dO^T: two groups, so the
      // exponentials below run while the second one does
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss_n64<T>(s, hopper::desc_k_step<D>(ks, kKeys, kk),
                                hopper::desc_k_step<D>(qs, kQRows, kk),
                                kk > 0);
      hopper::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss_n64<T>(dp, hopper::desc_k_step<D>(vs, kKeys, kk),
                                hopper::desc_k_step<D>(dos, kQRows, kk),
                                kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_regs(s);

      // P^T in place of S^T: row r of the thread is key row0 + 8 r,
      // column 8 j + 2 quad + c its q row ql.  The score and the bias
      // are summed before lse is taken off, as the plain version does:
      // an all-padding row's -1e4 then rounds alike in both.
#pragma unroll
      for (int j = 0; j < kQRows / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int ql = 8 * j + 2 * quad + c;
          const float l = st[ql];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float& x = s[4 * j + 2 * r + c];
            const bool live = q0 + ql < Sq &&
                              !(a.causal && row0 + 8 * r > q0 + ql) &&
                              l != -INFINITY;
            x = live ? exp2f((fmaf(x, a.scale, bk[r]) - l) * kLog2e)
                     : 0.f;
          }
        }

      hopper::wgmma_wait<0>();
      hopper::fence_regs(dp);

      // dS^T = P^T (dP^T - delta) in place of dP^T; its fp32 row sums
#pragma unroll
      for (int j = 0; j < kQRows / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float dl = st[kQRows + 8 * j + 2 * quad + c];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int e = 4 * j + 2 * r + c;
            dp[e] = s[e] * (dp[e] - dl);
            db[r] += dp[e];
          }
        }

      // P^T and dS^T in T as wgmma A fragments, 16 q rows each; float16
      // takes dS^T * scale (kFold, after the bias-gradient sums)
      uint32_t pf[kQRows / 16][4], dsf[kQRows / 16][4];
#pragma unroll
      for (int kk = 0; kk < kQRows / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pf[kk][r] =
              hopper::pack16<T>(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
          const float lo = dp[8 * kk + 2 * r], hi = dp[8 * kk + 2 * r + 1];
          if constexpr (kFold<T>)
            dsf[kk][r] = hopper::pack16<T>(lo * a.scale, hi * a.scale);
          else
            dsf[kk][r] = hopper::pack16<T>(lo, hi);
        }

      // dV += P^T dO, dK += dS^T Q
      hopper::fence_regs(dva);
      hopper::fence_regs(dka);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQRows / 16; ++kk)
        hopper::wgmma_rs<T, D>(dva, pf[kk],
                               hopper::desc_mn_step<D>(dos, kQRows, kk));
#pragma unroll
      for (int kk = 0; kk < kQRows / 16; ++kk)
        hopper::wgmma_rs<T, D>(dka, dsf[kk],
                               hopper::desc_mn_step<D>(qs, kQRows, kk));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dva);
      hopper::fence_regs(dka);
    }
    ring.release(i);
    // warp 0 refills the stage of iteration i - 1, which the other
    // warpgroup has most likely released by now: it waits on it only when
    // a whole stage behind
    if (warp == 0 && i + kQStages - 1 < n) fill(i + kQStages - 1);
  }

  // epilogue: dk (times scale unless folded) and dv in T through the
  // strides; each key's bias gradient summed over its quad, written by one
  // thread
  const float k_mul = kFold<T> ? 1.f : a.scale;
  const float one[2] = {1.f, 1.f}, sc[2] = {k_mul, k_mul};
  store16<T, D>(dv + b * a.dvl.b + h * a.dvl.h, a.dvl.s, Sk, row0, quad,
                dva, one);
  store16<T, D>(dk + b * a.dkl.b + h * a.dkl.h, a.dkl.s, Sk, row0, quad,
                dka, sc);
  if (dbias_heads) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x = db[r];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      const int key = row0 + 8 * r;
      if (quad == 0 && key < Sk)
        dbias_heads[((long long)b * nh + h) * Sk + key] = x;
    }
  }
}

template <typename T, int D>
int launch_dkv(const Call& c, cudaStream_t stream) {
  const BwdShape& a = c.a;
  const int nh = a.num_heads;
  if (!pairs_aligned(c.dk, a.dkl) || !pairs_aligned(c.dv, a.dvl))
    return (int)cudaErrorMisalignedAddress;
  hopper::TmaMaps<4> maps;
  const Operand ops[4] = {{c.q, a.Sq, a.ql, kQRows},
                          {c.k, a.Sk, a.kl, kKeys},
                          {c.v, a.Sk, a.vl, kKeys},
                          {c.dout, a.Sq, a.dol, kQRows}};
  const int err = encode_maps<T>(&maps, ops, D, nh, c.B);
  if (err) return err;
  constexpr int smem = kDkvSmem<D>;
  static const cudaError_t attr = hopper::set_smem_limit(
      fa_dkv_tc_kernel<T, D>, smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid(c.B * nh, (a.Sk + kKeys - 1) / kKeys);
  fa_dkv_tc_kernel<T, D><<<grid, kDkvThreads, smem, stream>>>(
      maps, static_cast<const float*>(c.bias),
      static_cast<const float*>(c.lse), static_cast<const float*>(c.delta),
      static_cast<T*>(c.dk), static_cast<T*>(c.dv),
      static_cast<float*>(c.dbias_heads), a);
  return (int)cudaGetLastError();
}

}  // namespace tc

// which: 0 = dK/dV, 1 = dQ.  dtype: 0 = float32, 1 = bfloat16, 2 =
// float16.  bfloat16 and float16 run the tensor-core kernels
// (fa_dkv_tc_kernel<T, D>, fa_dq_tc_kernel<T, D>), float32
// the CUDA-core ones (fa_dkv_f32_kernel, fa_dq_f32_kernel) in blocks of 8
// warps: at D 32 and 64 as 4 row groups x 8 column groups (16 rows a warp,
// 128 a block; at D 32 a lane's accumulator patch is 4 rows x 4 columns,
// the narrowest float4 patch, where D 64 holds 4 x 8), at D 128 as 2 x 16
// (8 rows a warp, 64 a block), where 4 x 16 spilled (dK/dV) or, in blocks
// of 4 warps to fit shared memory, ran slower (dQ).
int run(const Call& c, int which, int dtype, void* stream) {
  if (c.B <= 0 || c.a.Sq <= 0 || c.a.Sk <= 0 || c.a.num_heads <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (which == 0) {
    if (dtype == 0 && c.D == 32) return f32::launch_dkv<32, 4>(c, st);
    if (dtype == 0 && c.D == 64) return f32::launch_dkv<64, 4>(c, st);
    if (dtype == 0 && c.D == 128) return f32::launch_dkv<128, 2>(c, st);
    if (dtype == 1 && c.D == 32)
      return tc::launch_dkv<__nv_bfloat16, 32>(c, st);
    if (dtype == 1 && c.D == 64)
      return tc::launch_dkv<__nv_bfloat16, 64>(c, st);
    if (dtype == 1 && c.D == 128)
      return tc::launch_dkv<__nv_bfloat16, 128>(c, st);
    if (dtype == 2 && c.D == 32) return tc::launch_dkv<__half, 32>(c, st);
    if (dtype == 2 && c.D == 64) return tc::launch_dkv<__half, 64>(c, st);
    if (dtype == 2 && c.D == 128) return tc::launch_dkv<__half, 128>(c, st);
  } else {
    if (dtype == 0 && c.D == 32) return f32::launch_dq<32, 4>(c, st);
    if (dtype == 0 && c.D == 64) return f32::launch_dq<64, 4>(c, st);
    if (dtype == 0 && c.D == 128) return f32::launch_dq<128, 2>(c, st);
    if (dtype == 1 && c.D == 32)
      return tc::launch_dq<__nv_bfloat16, 32>(c, st);
    if (dtype == 1 && c.D == 64)
      return tc::launch_dq<__nv_bfloat16, 64>(c, st);
    if (dtype == 1 && c.D == 128)
      return tc::launch_dq<__nv_bfloat16, 128>(c, st);
    if (dtype == 2 && c.D == 32) return tc::launch_dq<__half, 32>(c, st);
    if (dtype == 2 && c.D == 64) return tc::launch_dq<__half, 64>(c, st);
    if (dtype == 2 && c.D == 128) return tc::launch_dq<__half, 128>(c, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The packed layout: q, k, v (and dq, dk, dv) as the column blocks of
// qkv (dqkv) [B, S, 3H], dout [B, S, H].
Call packed_call(const void* qkv, const void* bias, const void* dout,
                 const void* lse, const void* delta, void* dqkv,
                 void* dbias_heads, int B, int S, int H, int num_heads,
                 int causal, float scale, int dtype) {
  const int D = H / num_heads;
  const long long row = 3LL * H;
  const Layout in{(long long)S * row, D, row};
  const Layout dl{(long long)S * H, D, H};
  const size_t col = (size_t)H * (dtype == 0 ? sizeof(float) : 2);
  const char* x = static_cast<const char*>(qkv);
  char* dx = static_cast<char*>(dqkv);
  return Call{x, x + col, x + 2 * col, dout, bias, lse, delta,
              dx, dx + col, dx + 2 * col, dbias_heads,
              BwdShape{in, in, in, dl, in, in, in, S, S, num_heads, causal,
                       scale},
              B, D};
}

// The unpacked layout: 21 element strides, (batch, head, row) of q, k, v,
// dout, dq, dk and dv in that order.
Call unpacked_call(const void* q, const void* k, const void* v,
                   const void* dout, const void* bias, const void* lse,
                   const void* delta, void* dq, void* dk, void* dv,
                   void* dbias_heads, const long long* s, int B, int Sq,
                   int Sk, int num_heads, int D, int causal, float scale) {
  Layout l[7];
  for (int i = 0; i < 7; ++i) l[i] = Layout{s[3 * i], s[3 * i + 1],
                                            s[3 * i + 2]};
  return Call{q, k, v, dout, bias, lse, delta, dq, dk, dv, dbias_heads,
              BwdShape{l[0], l[1], l[2], l[3], l[4], l[5], l[6], Sq, Sk,
                       num_heads, causal, scale},
              B, D};
}

}  // namespace

extern "C" {

// Packed QKV.  dtype: 0 = float32, 1 = bfloat16, 2 = float16.  bias is
// float32 [B, S]
// or null; dbias_heads is float32 [B, num_heads, S] or null (no bias
// grad).  Each returns the cudaError_t of its launch (0 = success).
int pt_flash_attention_packed_bwd_dkv(const void* qkv, const void* bias,
                                      const void* dout, const void* lse,
                                      const void* delta, void* dqkv,
                                      void* dbias_heads, int B, int S, int H,
                                      int num_heads, int causal, float scale,
                                      int dtype, void* stream) {
  if (num_heads <= 0 || H % num_heads != 0) return (int)cudaErrorInvalidValue;
  return run(packed_call(qkv, bias, dout, lse, delta, dqkv, dbias_heads, B, S,
                         H, num_heads, causal, scale, dtype),
             0, dtype, stream);
}

int pt_flash_attention_packed_bwd_dq(const void* qkv, const void* bias,
                                     const void* dout, const void* lse,
                                     const void* delta, void* dqkv, int B,
                                     int S, int H, int num_heads, int causal,
                                     float scale, int dtype, void* stream) {
  if (num_heads <= 0 || H % num_heads != 0) return (int)cudaErrorInvalidValue;
  return run(packed_call(qkv, bias, dout, lse, delta, dqkv, nullptr, B, S, H,
                         num_heads, causal, scale, dtype),
             1, dtype, stream);
}

// Unpacked q, dout [B, nh, Sq, D] and k, v [B, nh, Sk, D], each read
// through its strides; dk, dv (dK/dV entry) and dq (dQ entry) written
// through theirs.  bias float32 [B, Sk] or null, lse and delta float32
// [B, nh, Sq], dbias_heads float32 [B, nh, Sk] or null.
int pt_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                               const void* dout, const void* bias,
                               const void* lse, const void* delta, void* dk,
                               void* dv, void* dbias_heads,
                               const long long* strides, int B, int Sq,
                               int Sk, int num_heads, int D, int causal,
                               float scale, int dtype, void* stream) {
  return run(unpacked_call(q, k, v, dout, bias, lse, delta, nullptr, dk, dv,
                           dbias_heads, strides, B, Sq, Sk, num_heads, D,
                           causal, scale),
             0, dtype, stream);
}

int pt_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                              const void* dout, const void* bias,
                              const void* lse, const void* delta, void* dq,
                              const long long* strides, int B, int Sq, int Sk,
                              int num_heads, int D, int causal, float scale,
                              int dtype, void* stream) {
  return run(unpacked_call(q, k, v, dout, bias, lse, delta, dq, nullptr,
                           nullptr, nullptr, strides, B, Sq, Sk, num_heads, D,
                           causal, scale),
             1, dtype, stream);
}

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
