// Packed-QKV flash-attention backward for Hopper (sm_90a): two kernels.
//
// fp_dkv_kernel replaces the TPU kernel `_fp_dkv_kernel` and fp_dq_kernel
// replaces `_fp_dq_kernel` (paddle_tpu/ops/pallas/flash_attention.py:611
// and :686, launched by `_packed_backward` at :745).  Both read q, k and v
// straight out of the fused projection qkv [B, S, 3H] (q at column h*D, k
// at H + h*D, v at 2H + h*D), dO [B, S, H], the forward's per-row
// log-sum-exp lse [B, num_heads, S] and delta = rowsum(dO * O)
// [B, num_heads, S] (both float32), and the optional additive float32
// [B, S] key bias.  They recompute p = exp(q.k^T * scale + bias - lse) tile
// by tile and never hold an S x S matrix in device memory:
//
//   dV = P^T dO,  dS = P * (dO V^T - delta),  dK = dS^T (q * scale),
//   dQ = dS K * scale,  dbias[k] = sum over heads and queries of dS.
//
// dq, dk and dv go straight into the three column blocks of one [B, S, 3H]
// gradient, so nothing is concatenated afterwards.  The bias gradient is
// written as per-head partials [B, num_heads, S] that the wrapper sums:
// no atomics, so the sum is deterministic.
//
// Design (a block runs alone on Hopper, so a loop inside the block takes
// the place of the TPU's sequential grid axis):
//   * dK/dV: one block of 256 threads per (64-key tile, head, batch).  Its
//     K and V tiles stay in shared memory while it loops over the 64-row
//     q tiles (from the diagonal tile on when causal).  Each thread owns a
//     4x4 patch of the 64x64 score tile for P and dS, and 4 key rows x
//     D/16 columns of the dK and dV accumulators, in float32 registers.
//   * dQ: one block per (64-row q tile, head, batch), looping over the
//     64-key tiles up to the diagonal when causal; a thread owns 4 q rows x
//     D/16 columns of dQ.
// Inputs may be float32 or bfloat16; all math is float32 and the bias
// stays float32 (bfloat16 would round -10000 to -9984).  Any S works: rows
// and keys past S in the last tile are masked.  p is exactly 0 for a
// masked score and in a row with no live key (lse = -inf, the forward
// kernel's convention), never exp(-inf + inf).
//
// Bound on an H100 SXM (data-sheet peaks at the card's 700 W limit) at the
// flagship training shape (B=8, S=512, 12 heads, D=64, bf16):
// dK/dV does 4 products of B*nh*S^2*D = 1.61e9 multiply-adds each, 12.9
// GFLOP, 13.0 us at the 989 TFLOP/s bf16 tensor-core peak, against about
// 38 MB moved (11.4 us at 3.35 TB/s); dQ does 3 products, 9.7 GFLOP,
// 9.8 us, against about 32 MB (9.5 us).  Both are bound by operations.
// This first version keeps every intermediate on chip but runs its
// products as fp32 FMAs on the CUDA cores (67 TFLOP/s, so at least 192 us
// and 144 us); wgmma on bf16 tiles, TMA loads and warp specialisation are
// the later steps toward the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;        // q rows per tile
constexpr int kBK = 64;        // k/v rows per tile
constexpr int kThreads = 256;  // 8 warps; 16 x 16 thread grid

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Rows r0..r0+63 of a [S, row_stride] matrix, D columns from `src`, into
// dst [64][D + 1] as float32 (times `mul`); rows past S read as 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int S, long row_stride, float mul,
                                          int tid) {
  for (int i = tid; i < 64 * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int g = r0 + r;
    dst[r * (D + 1) + c] = g < S ? to_f32(src[g * row_stride + c]) * mul : 0.f;
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
                                         int q0, int k0, int S, int causal,
                                         int tx, int ty, float p[4][4],
                                         float ds[4][4]) {
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
      const bool live = q < S && k < S && !(causal && k > q) &&
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
fp_dkv_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dqkv,
              float* __restrict__ dbias_heads, int S, int H, int num_heads,
              int causal, float scale) {
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
  const long row_stride = 3L * H;
  const T* base = qkv + (long)b * S * row_stride;
  const T* dob = dout + (long)b * S * H + h * D;
  const float* lse_row = lse + ((long)b * num_heads + h) * S;
  const float* dlt_row = delta + ((long)b * num_heads + h) * S;

  load_tile<T, D>(Ks, base + H + h * D, k0, S, row_stride, 1.f, tid);
  load_tile<T, D>(Vs, base + 2 * H + h * D, k0, S, row_stride, 1.f, tid);
  if (tid < kBK)
    b_s[tid] = (bias && k0 + tid < S) ? bias[(long)b * S + k0 + tid] : 0.f;

  constexpr int NJ = D / 16;
  float acc_dk[4][NJ], acc_dv[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc_dk[i][j] = acc_dv[i][j] = 0.f;
  float db = 0.f;  // this key's bias-grad sum (threads tid < kBK)

  const int nqt = (S + kBQ - 1) / kBQ;
  for (int qt = causal ? k0 / kBQ : 0; qt < nqt; ++qt) {
    const int q0 = qt * kBQ;
    __syncthreads();  // the previous tile's reads of Qs/dOs/Ps/dSs are done
    load_tile<T, D>(Qs, base + h * D, q0, S, row_stride, scale, tid);
    load_tile<T, D>(dOs, dob, q0, S, H, 1.f, tid);
    if (tid < kBQ) {
      lse_s[tid] = q0 + tid < S ? lse_row[q0 + tid] : 0.f;
      dlt_s[tid] = q0 + tid < S ? dlt_row[q0 + tid] : 0.f;
    }
    __syncthreads();

    float p[4][4], ds[4][4];
    p_and_ds<D>(Qs, dOs, Ks, Vs, lse_s, dlt_s, b_s, q0, k0, S, causal, tx,
                ty, p, ds);
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty + 16 * i;
    if (k >= S) continue;
    T* row = dqkv + ((long)b * S + k) * row_stride + h * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      row[H + tx + 16 * j] = from_f32<T>(acc_dk[i][j]);
      row[2 * H + tx + 16 * j] = from_f32<T>(acc_dv[i][j]);
    }
  }
  if (dbias_heads && tid < kBK && k0 + tid < S)
    dbias_heads[((long)b * num_heads + h) * S + k0 + tid] = db;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fp_dq_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
             const T* __restrict__ dout, const float* __restrict__ lse,
             const float* __restrict__ delta, T* __restrict__ dqkv, int S,
             int H, int num_heads, int causal, float scale) {
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
  const long row_stride = 3L * H;
  const T* base = qkv + (long)b * S * row_stride;
  const float* lse_row = lse + ((long)b * num_heads + h) * S;
  const float* dlt_row = delta + ((long)b * num_heads + h) * S;

  load_tile<T, D>(Qs, base + h * D, q0, S, row_stride, scale, tid);
  load_tile<T, D>(dOs, dout + (long)b * S * H + h * D, q0, S, H, 1.f, tid);
  if (tid < kBQ) {
    lse_s[tid] = q0 + tid < S ? lse_row[q0 + tid] : 0.f;
    dlt_s[tid] = q0 + tid < S ? dlt_row[q0 + tid] : 0.f;
  }

  constexpr int NJ = D / 16;
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  int nkt = (S + kBK - 1) / kBK;
  if (causal) nkt = min(nkt, (q0 + kBQ - 1) / kBK + 1);  // later tiles dead
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's reads of Ks/Vs/dSs are done
    load_tile<T, D>(Ks, base + H + h * D, k0, S, row_stride, 1.f, tid);
    load_tile<T, D>(Vs, base + 2 * H + h * D, k0, S, row_stride, 1.f, tid);
    if (tid < kBK)
      b_s[tid] = (bias && k0 + tid < S) ? bias[(long)b * S + k0 + tid] : 0.f;
    __syncthreads();

    float p[4][4], ds[4][4];
    p_and_ds<D>(Qs, dOs, Ks, Vs, lse_s, dlt_s, b_s, q0, k0, S, causal, tx,
                ty, p, ds);
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + ty + 16 * i;
    if (q >= S) continue;
    T* row = dqkv + ((long)b * S + q) * row_stride + h * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) row[tx + 16 * j] = from_f32<T>(acc[i][j] * scale);
  }
}

template <typename T, int D>
int launch_dkv(const void* qkv, const void* bias, const void* dout,
               const void* lse, const void* delta, void* dqkv,
               void* dbias_heads, int B, int S, int H, int num_heads,
               int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      fp_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kBK - 1) / kBK, num_heads, B);
  fp_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(bias),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dqkv),
      static_cast<float*>(dbias_heads), S, H, num_heads, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const void* qkv, const void* bias, const void* dout,
              const void* lse, const void* delta, void* dqkv, int B, int S,
              int H, int num_heads, int causal, float scale,
              cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      fp_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kBQ - 1) / kBQ, num_heads, B);
  fp_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(bias),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dqkv), S, H,
      num_heads, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  bias is float32 [B, S] or null;
// dbias_heads is float32 [B, num_heads, S] or null (no bias grad).
// Each returns the cudaError_t of its launch (0 = success).
int pt_flash_attention_packed_bwd_dkv(const void* qkv, const void* bias,
                                      const void* dout, const void* lse,
                                      const void* delta, void* dqkv,
                                      void* dbias_heads, int B, int S, int H,
                                      int num_heads, int causal, float scale,
                                      int dtype, void* stream) {
  if (num_heads <= 0 || H % num_heads != 0) return (int)cudaErrorInvalidValue;
  const int D = H / num_heads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PT_DKV(T, DD)                                                       \
  return launch_dkv<T, DD>(qkv, bias, dout, lse, delta, dqkv, dbias_heads, \
                           B, S, H, num_heads, causal, scale, st)
  if (dtype == 0 && D == 64) PT_DKV(float, 64);
  if (dtype == 0 && D == 128) PT_DKV(float, 128);
  if (dtype == 1 && D == 64) PT_DKV(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) PT_DKV(__nv_bfloat16, 128);
#undef PT_DKV
  return (int)cudaErrorInvalidValue;
}

int pt_flash_attention_packed_bwd_dq(const void* qkv, const void* bias,
                                     const void* dout, const void* lse,
                                     const void* delta, void* dqkv, int B,
                                     int S, int H, int num_heads, int causal,
                                     float scale, int dtype, void* stream) {
  if (num_heads <= 0 || H % num_heads != 0) return (int)cudaErrorInvalidValue;
  const int D = H / num_heads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PT_DQ(T, DD)                                                          \
  return launch_dq<T, DD>(qkv, bias, dout, lse, delta, dqkv, B, S, H,        \
                          num_heads, causal, scale, st)
  if (dtype == 0 && D == 64) PT_DQ(float, 64);
  if (dtype == 0 && D == 128) PT_DQ(float, 128);
  if (dtype == 1 && D == 64) PT_DQ(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) PT_DQ(__nv_bfloat16, 128);
#undef PT_DQ
  return (int)cudaErrorInvalidValue;
}

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
