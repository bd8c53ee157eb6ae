// Flash-attention backward for Hopper (sm_90a), each entry serving the
// packed or the unpacked layout of one TPU kernel of
// paddle_tpu/ops/pallas/flash_attention.py:
//
//   * the dK/dV entries replace `_fp_dkv_kernel` (pt_flash_attention_
//     packed_bwd_dkv; :611, launched by `_packed_backward` at :745) and
//     `_fa_dkv_kernel` (pt_flash_attention_bwd_dkv; :226, launched by
//     `_flash_backward` at :342): fa_dkv_tc_kernel in bfloat16,
//     fa_dkv_kernel in float32.
//   * the dQ entries replace `_fp_dq_kernel` (pt_flash_attention_packed_
//     bwd_dq; :686) and `_fa_dq_kernel` (pt_flash_attention_bwd_dq; :292):
//     fa_dq_tc_kernel in bfloat16, fa_dq_kernel in float32.
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
//   * dK/dV, bfloat16 (fa_dkv_tc_kernel, tensor cores): one block of 256
//     threads per (128-key tile, head, batch), so each key row is owned by
//     one block (no atomics, deterministic): two warpgroups of 64 keys.
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
//     dS^T to bf16 in registers (the accumulator layout is wgmma's
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
//   * dK/dV, float32 (fa_dkv_kernel, fp32 FMAs on the CUDA cores): one
//     block of 256 threads per (64-key tile, head, batch).  Its K and V
//     tiles stay in shared memory while it loops over the 64-row q tiles
//     (from the diagonal tile on when causal).  Each thread owns a 4x4 patch
//     of the 64x64 score tile for P and dS, and 4 key rows x D/16 columns of
//     the dK and dV accumulators, in float32 registers.  It keeps the fp32
//     gates bit-equal to the plain version, which TF32 would not.
//   * dQ, bfloat16 (fa_dq_tc_kernel, tensor cores): one block of 288
//     threads per (128-row q tile, head, batch), so each q row is owned by
//     one block (no atomics, deterministic): two consumer warpgroups of 64
//     rows and a producer warp.  The producer loads Q and dO once and
//     streams 64-key K and V tiles through a two-stage TMA ring (hopper.cuh).
//     Per tile a warpgroup computes S = Q K^T and dP = dO V^T with wgmma
//     (operands in shared memory), P = exp(S * scale + bias - lse) and
//     dS = P * (dP - delta) in fp32 registers, rounds dS to bf16 in
//     registers and accumulates dQ += dS K with wgmma (K read MN-major from
//     the same shared tile through the transpose bit).  dQ stays in fp32
//     registers; the epilogue writes dq * scale in bf16.  Causal q tiles run
//     longest first.
//   * dQ, float32 (fa_dq_kernel): one block of 256 threads per (64-row q
//     tile, head, batch), looping over the 64-key tiles up to the diagonal
//     when causal; a thread owns 4 q rows x D/16 columns of dQ, in fp32
//     FMAs (the fp32 gates hold its dq bit-equal to the plain version).
//
// Bounds on an H100 SXM (data-sheet peaks at the card's 700 W limit).
// Packed, at BERT's training shape (B=8, S=512, 12 heads, D=64, bf16):
// dK/dV does 4 products of B*nh*S^2*D = 1.61e9 multiply-adds each, 12.9
// GFLOP, 13.0 us at the 989 TFLOP/s bf16 tensor-core peak, against about
// 38 MB moved (11.4 us at 3.35 TB/s); dQ 3 products, 9.7 GFLOP, 9.8 us.
// Unpacked, at Llama-2-7B width (B=1, 32 heads, S=2048, D=128, causal,
// bf16): dK/dV 6.87e10 flop (69.5 us), dQ 5.15e10 (52.1 us).  All are
// bound by operations.  Both bf16 kernels run their products on the tensor
// cores with loads kept off the compute warps; the fp32 ones run FMAs on
// the CUDA cores (67 TFLOP/s).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int kBQ = 64;        // q rows per tile
constexpr int kBK = 64;        // k/v rows per tile
constexpr int kThreads = 256;  // 8 warps; 16 x 16 thread grid

using hopper::Layout;

// Strides and sizes of one call.  The pointers travel as __restrict__
// kernel parameters, which keeps the read-only load path.
struct BwdShape {
  Layout ql, kl, vl, dol, dql, dkl, dvl;
  int Sq, Sk, num_heads, causal;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

// Rows r0..r0+63 of a [rows, D] matrix with row stride `row_stride`, from
// `src`, into dst [64][D + 1] as float32 (times `mul`); rows past `rows`
// read as 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int rows, long long row_stride,
                                          float mul, int tid) {
  for (int i = tid; i < 64 * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int g = r0 + r;
    dst[r * (D + 1) + c] =
        g < rows ? to_f32(src[g * row_stride + c]) * mul : 0.f;
  }
}

// The 64x64 tile of P and dS for q rows q0 + ty + 16 i and keys
// k0 + tx + 16 j:  s = Qs.Ks^T + bias, p = exp(s - lse) where live,
// dS = p * (dOs.Vs^T - delta).  Qs is q * scale; b_s the tile's bias.
template <int D>
__device__ __forceinline__ void p_and_ds(const float* Qs, const float* dOs,
                                         const float* Ks, const float* Vs,
                                         const float* lse_s,
                                         const float* dlt_s, const float* b_s,
                                         int q0, int k0, int Sq, int Sk,
                                         int causal, int tx, int ty,
                                         float p[4][4], float ds[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) p[i][j] = ds[i][j] = 0.f;
  for (int d = 0; d < D; ++d) {
    float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = Qs[(ty + 16 * i) * (D + 1) + d];
      dov[i] = dOs[(ty + 16 * i) * (D + 1) + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
      vv[j] = Vs[(tx + 16 * j) * (D + 1) + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = fmaf(qv[i], kv[j], p[i][j]);     // score so far
        ds[i][j] = fmaf(dov[i], vv[j], ds[i][j]);  // dP so far
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int q = q0 + r;
    const float lse = lse_s[r], dlt = dlt_s[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const int k = k0 + c;
      const bool live = q < Sq && k < Sk && !(causal && k > q) &&
                        lse != -INFINITY;
      const float pv = live ? expf(p[i][j] + b_s[c] - lse) : 0.f;
      p[i][j] = pv;
      ds[i][j] = pv * (ds[i][j] - dlt);
    }
  }
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // Ks, Vs, Qs, dOs [64][D+1]; Ps, dSs [64][65]; lse, delta, bias [64]
  return sizeof(float) * (4 * 64 * (D + 1) + 2 * 64 * 65 + 3 * 64);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // Qs, dOs, Ks, Vs [64][D+1]; dSs [64][65]; lse, delta, bias [64]
  return sizeof(float) * (4 * 64 * (D + 1) + 64 * 65 + 3 * 64);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_dkv_kernel(const T* __restrict__ q_, const T* __restrict__ k_,
              const T* __restrict__ v_, const T* __restrict__ dout,
              const float* __restrict__ bias, const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dk,
              T* __restrict__ dv, float* __restrict__ dbias_heads,
              const BwdShape a) {
  extern __shared__ float smem[];
  float* Ks = smem;                    // [kBK][D + 1]
  float* Vs = Ks + kBK * (D + 1);      // [kBK][D + 1]
  float* Qs = Vs + kBK * (D + 1);      // [kBQ][D + 1], q * scale
  float* dOs = Qs + kBQ * (D + 1);     // [kBQ][D + 1]
  float* Ps = dOs + kBQ * (D + 1);     // [kBQ][kBK + 1]
  float* dSs = Ps + kBQ * (kBK + 1);   // [kBQ][kBK + 1]
  float* lse_s = dSs + kBQ * (kBK + 1);
  float* dlt_s = lse_s + kBQ;
  float* b_s = dlt_s + kBQ;

  const int k0 = blockIdx.x * kBK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int Sq = a.Sq, Sk = a.Sk;
  const long long row = (long long)b * a.num_heads + h;
  const float* lse_row = lse + row * Sq;
  const float* dlt_row = delta + row * Sq;
  const T* qb = q_ + b * a.ql.b + h * a.ql.h;
  const T* dob = dout + b * a.dol.b + h * a.dol.h;

  load_tile<T, D>(Ks, k_ + b * a.kl.b + h * a.kl.h, k0, Sk, a.kl.s, 1.f,
                  tid);
  load_tile<T, D>(Vs, v_ + b * a.vl.b + h * a.vl.h, k0, Sk, a.vl.s, 1.f,
                  tid);
  if (tid < kBK)
    b_s[tid] = (bias && k0 + tid < Sk)
                   ? bias[(long long)b * Sk + k0 + tid] : 0.f;

  constexpr int NJ = D / 16;
  float acc_dk[4][NJ], acc_dv[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc_dk[i][j] = acc_dv[i][j] = 0.f;
  float db = 0.f;  // this key's bias-grad sum (threads tid < kBK)

  const int nqt = (Sq + kBQ - 1) / kBQ;
  for (int qt = a.causal ? k0 / kBQ : 0; qt < nqt; ++qt) {
    const int q0 = qt * kBQ;
    __syncthreads();  // the previous tile's reads of Qs/dOs/Ps/dSs are done
    load_tile<T, D>(Qs, qb, q0, Sq, a.ql.s, a.scale, tid);
    load_tile<T, D>(dOs, dob, q0, Sq, a.dol.s, 1.f, tid);
    if (tid < kBQ) {
      lse_s[tid] = q0 + tid < Sq ? lse_row[q0 + tid] : 0.f;
      dlt_s[tid] = q0 + tid < Sq ? dlt_row[q0 + tid] : 0.f;
    }
    __syncthreads();

    float p[4][4], ds[4][4];
    p_and_ds<D>(Qs, dOs, Ks, Vs, lse_s, dlt_s, b_s, q0, k0, Sq, Sk, a.causal,
                tx, ty, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        Ps[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] = p[i][j];
        dSs[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] = ds[i][j];
      }
    __syncthreads();

    // dV[k] += sum_q P[q][k] dO[q];  dK[k] += sum_q dS[q][k] (q * scale)
    for (int q = 0; q < kBQ; ++q) {
      float pv[4], dsv[4], dov[NJ], qv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[q * (kBK + 1) + ty + 16 * i];
        dsv[i] = dSs[q * (kBK + 1) + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        dov[j] = dOs[q * (D + 1) + tx + 16 * j];
        qv[j] = Qs[q * (D + 1) + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          acc_dv[i][j] = fmaf(pv[i], dov[j], acc_dv[i][j]);
          acc_dk[i][j] = fmaf(dsv[i], qv[j], acc_dk[i][j]);
        }
    }
    if (dbias_heads && tid < kBK) {
      for (int q = 0; q < kBQ; ++q) db += dSs[q * (kBK + 1) + tid];
    }
  }

  T* dkb = dk + b * a.dkl.b + h * a.dkl.h;
  T* dvb = dv + b * a.dvl.b + h * a.dvl.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty + 16 * i;
    if (k >= Sk) continue;
    T* dkrow = dkb + k * a.dkl.s;
    T* dvrow = dvb + k * a.dvl.s;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dkrow[tx + 16 * j] = from_f32<T>(acc_dk[i][j]);
      dvrow[tx + 16 * j] = from_f32<T>(acc_dv[i][j]);
    }
  }
  if (dbias_heads && tid < kBK && k0 + tid < Sk)
    dbias_heads[row * Sk + k0 + tid] = db;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_dq_kernel(const T* __restrict__ q_, const T* __restrict__ k_,
             const T* __restrict__ v_, const T* __restrict__ dout,
             const float* __restrict__ bias, const float* __restrict__ lse,
             const float* __restrict__ delta, T* __restrict__ dq,
             const BwdShape a) {
  extern __shared__ float smem[];
  float* Qs = smem;                    // [kBQ][D + 1], q * scale
  float* dOs = Qs + kBQ * (D + 1);     // [kBQ][D + 1]
  float* Ks = dOs + kBQ * (D + 1);     // [kBK][D + 1]
  float* Vs = Ks + kBK * (D + 1);      // [kBK][D + 1]
  float* dSs = Vs + kBK * (D + 1);     // [kBQ][kBK + 1]
  float* lse_s = dSs + kBQ * (kBK + 1);
  float* dlt_s = lse_s + kBQ;
  float* b_s = dlt_s + kBQ;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int Sq = a.Sq, Sk = a.Sk;
  const long long row = (long long)b * a.num_heads + h;
  const float* lse_row = lse + row * Sq;
  const float* dlt_row = delta + row * Sq;
  const T* kb = k_ + b * a.kl.b + h * a.kl.h;
  const T* vb = v_ + b * a.vl.b + h * a.vl.h;

  load_tile<T, D>(Qs, q_ + b * a.ql.b + h * a.ql.h, q0, Sq, a.ql.s, a.scale,
                  tid);
  load_tile<T, D>(dOs, dout + b * a.dol.b + h * a.dol.h, q0, Sq, a.dol.s,
                  1.f, tid);
  if (tid < kBQ) {
    lse_s[tid] = q0 + tid < Sq ? lse_row[q0 + tid] : 0.f;
    dlt_s[tid] = q0 + tid < Sq ? dlt_row[q0 + tid] : 0.f;
  }

  constexpr int NJ = D / 16;
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  int nkt = (Sk + kBK - 1) / kBK;
  if (a.causal) nkt = min(nkt, (q0 + kBQ - 1) / kBK + 1);  // later tiles dead
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's reads of Ks/Vs/dSs are done
    load_tile<T, D>(Ks, kb, k0, Sk, a.kl.s, 1.f, tid);
    load_tile<T, D>(Vs, vb, k0, Sk, a.vl.s, 1.f, tid);
    if (tid < kBK)
      b_s[tid] = (bias && k0 + tid < Sk)
                     ? bias[(long long)b * Sk + k0 + tid] : 0.f;
    __syncthreads();

    float p[4][4], ds[4][4];
    p_and_ds<D>(Qs, dOs, Ks, Vs, lse_s, dlt_s, b_s, q0, k0, Sq, Sk, a.causal,
                tx, ty, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dSs[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] = ds[i][j];
    __syncthreads();

    // dQ[q] += sum_k dS[q][k] K[k]
    for (int k = 0; k < kBK; ++k) {
      float dsv[4], kv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dSs[(ty + 16 * i) * (kBK + 1) + k];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kv[j] = Ks[k * (D + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

  T* dqb = dq + b * a.dql.b + h * a.dql.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + ty + 16 * i;
    if (q >= Sq) continue;
    T* dqrow = dqb + q * a.dql.s;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      dqrow[tx + 16 * j] = from_f32<T>(acc[i][j] * a.scale);
  }
}

// Pointers and layouts of one backward call, as the entries receive them.
struct Call {
  const void *q, *k, *v, *dout, *bias, *lse, *delta;
  void *dq, *dk, *dv, *dbias_heads;
  BwdShape a;
  int B, D;
};

template <int D>
int launch_dkv_f32(const Call& c, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  static const cudaError_t attr = hopper::set_smem_limit(
      fa_dkv_kernel<float, D>, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((c.a.Sk + kBK - 1) / kBK, c.a.num_heads, c.B);
  fa_dkv_kernel<float, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(c.q), static_cast<const float*>(c.k),
      static_cast<const float*>(c.v), static_cast<const float*>(c.dout),
      static_cast<const float*>(c.bias), static_cast<const float*>(c.lse),
      static_cast<const float*>(c.delta), static_cast<float*>(c.dk),
      static_cast<float*>(c.dv), static_cast<float*>(c.dbias_heads), c.a);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq_f32(const Call& c, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  static const cudaError_t attr = hopper::set_smem_limit(
      fa_dq_kernel<float, D>, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((c.a.Sq + kBQ - 1) / kBQ, c.a.num_heads, c.B);
  fa_dq_kernel<float, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(c.q), static_cast<const float*>(c.k),
      static_cast<const float*>(c.v), static_cast<const float*>(c.dout),
      static_cast<const float*>(c.bias), static_cast<const float*>(c.lse),
      static_cast<const float*>(c.delta), static_cast<float*>(c.dq), c.a);
  return (int)cudaGetLastError();
}

namespace tc {

using namespace hopper::attn;
using hopper::attn::kThreads;  // not the CUDA-core kernels', found first

// Shared memory: the Q and dO tiles, the K/V ring, its barriers, and slack
// to align the tiles to 1024 bytes.
template <int D>
constexpr int kDqSmem =
    2 * kRowTile<D> + Ring<D>::kBytes + Ring<D>::kBarBytes + 1024;

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
fa_dq_tc_kernel(const __grid_constant__ hopper::TmaMaps<4> maps,
                const float* __restrict__ bias, const float* __restrict__ lse,
                const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dq, const BwdShape a) {
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
  const uint8_t* qs = sm + f.wg * 64 * 128;
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
        hopper::wgmma_ss_n64(s, hopper::desc_k_step(qs, kBM, kk),
                             hopper::desc_k_step(ring.k(t), kBN, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss_n64(dp, hopper::desc_k_step(dos, kBM, kk),
                             hopper::desc_k_step(ring.v(t), kBN, kk), kk > 0);
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

      // dS in bf16 as wgmma A fragments: 16 keys per fragment
      uint32_t ds[kBN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          ds[kk][r] =
              hopper::pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

      // dQ += dS K
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        hopper::wgmma_rs<D>(acc, ds[kk],
                            hopper::desc_mn_step(ring.k(t), kBN, kk));
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(acc);
    }
    ring.release(t);
  }

  // epilogue: dq * scale in bf16 through the strides
  const float mul[2] = {a.scale, a.scale};
  store_bf16<D>(dq + f.b * a.dql.b + f.h * a.dql.h, a.dql.s, Sq, row0, quad,
                acc, mul);
}

template <int D>
int launch_dq(const Call& c, cudaStream_t stream) {
  const BwdShape& a = c.a;
  const int nh = a.num_heads;
  if (!pairs_aligned(c.dq, a.dql)) return (int)cudaErrorMisalignedAddress;
  hopper::TmaMaps<4> maps;
  const Operand ops[4] = {{c.q, a.Sq, a.ql, kBM},
                          {c.k, a.Sk, a.kl, kBN},
                          {c.v, a.Sk, a.vl, kBN},
                          {c.dout, a.Sq, a.dol, kBM}};
  const int err = encode_maps(&maps, ops, D, nh, c.B);
  if (err) return err;
  constexpr int smem = kDqSmem<D>;
  static const cudaError_t attr = hopper::set_smem_limit(
      fa_dq_tc_kernel<D>, smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid(c.B * nh, (a.Sq + kBM - 1) / kBM);
  fa_dq_tc_kernel<D><<<grid, kThreads, smem, stream>>>(
      maps, static_cast<const float*>(c.bias),
      static_cast<const float*>(c.lse), static_cast<const float*>(c.delta),
      static_cast<__nv_bfloat16*>(c.dq), a);
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

// K and V (kKeys x D bf16 each), the ring, its stats (lse and delta,
// kQRows floats each a stage), its barriers, and alignment slack.
template <int D>
constexpr int kKvTile = kKeys * D * 2;
constexpr int kStatBytes = kQStages * 2 * kQRows * 4;
template <int D>
constexpr int kDkvSmem = 2 * kKvTile<D> + QRing<D>::kBytes + kStatBytes +
                         QRing<D>::kBarBytes + 1024;

template <int D>
__global__ void __launch_bounds__(kDkvThreads, 1)
fa_dkv_tc_kernel(const __grid_constant__ hopper::TmaMaps<4> maps,
                 const float* __restrict__ bias, const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                 float* __restrict__ dbias_heads, const BwdShape a) {
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
      for (int c = 0; c < D / 64; ++c) {
        hopper::tma_load(sm + c * kKeys * 128, &maps.m[1], ring.q_full,
                         c * 64, h, k0, b);
        hopper::tma_load(sm + kKV + c * kKeys * 128, &maps.m[2], ring.q_full,
                         c * 64, h, k0, b);
      }
    }
    for (int j = 0; j < min(n, kQStages - 1); ++j) fill(j);
  }

  // this warpgroup's keys kw0 .. kw0 + 63
  const int wg = warp / 4, quad = lane % 4;
  const int kw0 = k0 + wg * 64;
  const int row0 = kw0 + (warp % 4) * 16 + lane / 4;  // keys row0, row0 + 8
  const uint8_t* ks = sm + wg * 64 * 128;
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
        hopper::wgmma_ss_n64(s, hopper::desc_k_step(ks, kKeys, kk),
                             hopper::desc_k_step(qs, kQRows, kk), kk > 0);
      hopper::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss_n64(dp, hopper::desc_k_step(vs, kKeys, kk),
                             hopper::desc_k_step(dos, kQRows, kk), kk > 0);
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

      // P^T and dS^T in bf16 as wgmma A fragments, 16 q rows each
      uint32_t pf[kQRows / 16][4], dsf[kQRows / 16][4];
#pragma unroll
      for (int kk = 0; kk < kQRows / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pf[kk][r] =
              hopper::pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
          dsf[kk][r] =
              hopper::pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
        }

      // dV += P^T dO, dK += dS^T Q
      hopper::fence_regs(dva);
      hopper::fence_regs(dka);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQRows / 16; ++kk)
        hopper::wgmma_rs<D>(dva, pf[kk],
                            hopper::desc_mn_step(dos, kQRows, kk));
#pragma unroll
      for (int kk = 0; kk < kQRows / 16; ++kk)
        hopper::wgmma_rs<D>(dka, dsf[kk],
                            hopper::desc_mn_step(qs, kQRows, kk));
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

  // epilogue: dk * scale and dv in bf16 through the strides; each key's
  // bias gradient summed over its quad, written by one thread
  const float one[2] = {1.f, 1.f}, sc[2] = {a.scale, a.scale};
  store_bf16<D>(dv + b * a.dvl.b + h * a.dvl.h, a.dvl.s, Sk, row0, quad,
                dva, one);
  store_bf16<D>(dk + b * a.dkl.b + h * a.dkl.h, a.dkl.s, Sk, row0, quad,
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

template <int D>
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
  const int err = encode_maps(&maps, ops, D, nh, c.B);
  if (err) return err;
  constexpr int smem = kDkvSmem<D>;
  static const cudaError_t attr = hopper::set_smem_limit(
      fa_dkv_tc_kernel<D>, smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid(c.B * nh, (a.Sk + kKeys - 1) / kKeys);
  fa_dkv_tc_kernel<D><<<grid, kDkvThreads, smem, stream>>>(
      maps, static_cast<const float*>(c.bias),
      static_cast<const float*>(c.lse), static_cast<const float*>(c.delta),
      static_cast<__nv_bfloat16*>(c.dk), static_cast<__nv_bfloat16*>(c.dv),
      static_cast<float*>(c.dbias_heads), a);
  return (int)cudaGetLastError();
}

}  // namespace tc

// which: 0 = dK/dV, 1 = dQ.  dtype: 0 = float32, 1 = bfloat16.  bfloat16
// runs the tensor-core kernels (fa_dkv_tc_kernel, fa_dq_tc_kernel), float32
// the CUDA-core ones (fa_dkv_kernel, fa_dq_kernel).
int run(const Call& c, int which, int dtype, void* stream) {
  if (c.B <= 0 || c.a.Sq <= 0 || c.a.Sk <= 0 || c.a.num_heads <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (which == 0) {
    if (dtype == 0 && c.D == 64) return launch_dkv_f32<64>(c, st);
    if (dtype == 0 && c.D == 128) return launch_dkv_f32<128>(c, st);
    if (dtype == 1 && c.D == 64) return tc::launch_dkv<64>(c, st);
    if (dtype == 1 && c.D == 128) return tc::launch_dkv<128>(c, st);
  } else {
    if (dtype == 0 && c.D == 64) return launch_dq_f32<64>(c, st);
    if (dtype == 0 && c.D == 128) return launch_dq_f32<128>(c, st);
    if (dtype == 1 && c.D == 64) return tc::launch_dq<64>(c, st);
    if (dtype == 1 && c.D == 128) return tc::launch_dq<128>(c, st);
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
  const size_t col = (size_t)H * (dtype == 1 ? sizeof(__nv_bfloat16)
                                             : sizeof(float));
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

// Packed QKV.  dtype: 0 = float32, 1 = bfloat16.  bias is float32 [B, S]
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
