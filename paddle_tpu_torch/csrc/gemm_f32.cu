// fp32 matrix product for Hopper (sm_90a) whose rows do not depend on M.
//
// out[b, m, n] = sum_k x[b, m, k] * w[b, k, n], batched, in exact fp32 on
// the CUDA cores (no TF32).  It replaces no TPU kernel: on the TPU the
// JAX package leaves `mul` (paddle_tpu/ops/math_ops.py) and the attention
// products to XLA.  The port runs every product that no grad op
// differentiates through it (ops/cuda/gemm.py), because a library GEMM
// picks its kernel, and with it the order of each dot product's sums, by
// the number of rows M: a decode step's M = 4 rows then differ in the last
// bits from the same rows of a prefill's M = 512 product, and cached decode
// stops being bit-equal to the uncached forward.
//
// The arithmetic is fixed per output element, so every launch shape below
// gives the same bits:
//
//   * K splits into chunks of KC = 256 (the last one may be short);
//   * chunk c's partial is one chain in increasing k from +0:
//     p = __fmaf_rn(x[m, k], w[k, n], p);
//   * out = p_0, then out = __fadd_rn(out, p_c) for c = 1, 2, ...
//
// The intrinsics keep nvcc's -fmad contraction from fusing the fold
// differently in the two kernels.  A chain over zero padding is the same
// chain: p starts at +0 and never becomes -0, so fma(0, 0, p) == p.
//
// Two launch shapes over that definition:
//
//   * skinny (M <= 16: the decode step, short chunks, decode attention):
//     a block of 128 threads per (512-column tile, K chunk, batch).  The
//     chunk's x rows sit in shared memory; each thread owns 4 neighbouring
//     columns for every row and streams its weights once, with 16-byte
//     loads where the layout allows, neighbouring threads on neighbouring
//     columns, 16 k of them in flight before the first is used (the
//     chain over k is sequential, so loads in flight are what hides the
//     memory's latency).  The chunk partials go to a [batch, chunks, M, N] scratch
//     and a second kernel folds them in order (one chunk: written straight
//     to out).  Bound by the weight bytes: 4 * K * N a product.
//   * register-tiled (M > 16: prefill, prefill chunks, BERT serving): a
//     block of 256 threads per 128 x 128 output tile (64 x 64 where the
//     larger tiles would leave most SMs idle), 8-deep k tiles through a
//     double-buffered shared-memory ring filled from registers prefetched
//     one tile ahead.  Each thread keeps an 8 x 8 (4 x 4) chunk
//     accumulator in registers; at each chunk's end it folds it into the
//     running total, which lives in out itself (each element is one
//     thread's alone), so the registers hold one 8 x 8 patch, not two
//     (two spilled).  Bound by operations: 2 * M * N * K at the 67
//     TFLOP/s fp32 peak.
//
// w is read either k-major (w[k, n] with unit n stride: `mul`'s weights,
// P V's values) or n-major (w[n, k] with unit k stride: K^T of Q K^T read
// straight from the K cache).  x needs a unit k stride, out a unit n stride.
#include <cuda_runtime.h>

namespace {

constexpr int KC = 256;          // the chunk of K every partial covers
constexpr int SK_THREADS = 128;  // skinny: threads a block
constexpr int SK_CPT = 4;        // skinny: columns a thread
constexpr int SK_U = 16;         // skinny: k loaded ahead a thread
constexpr int KT = 8;            // tiled: k depth of a shared-memory tile

struct Strides {
  long long xb, xm;      // x [batch, M, K], unit k stride
  long long wb, wk, wn;  // w [batch, K, N], wk == 1 or wn == 1
  long long ob, om;      // out [batch, M, N], unit n stride
};

// Chunk partials of up to MR rows x SK_CPT columns.  WT: w is n-major
// (unit k stride).  VEC: 16-byte loads (aligned pointer and strides).
template <int MR, bool WT, bool VEC>
__global__ void __launch_bounds__(SK_THREADS)
gemm_skinny_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ part, int M, int N, int K, Strides s,
                   long long pb, long long pc, long long pm) {
  __shared__ __align__(16) float xs[MR * KC];
  const int b = blockIdx.z, c = blockIdx.y;
  const int k0 = c * KC, klen = min(KC, K - k0);
  const float* xp = x + b * s.xb + k0;
  for (int i = threadIdx.x; i < MR * KC; i += SK_THREADS) {
    const int m = i / KC, kk = i % KC;
    xs[i] = (m < M && kk < klen) ? xp[m * s.xm + kk] : 0.f;
  }
  __syncthreads();
  const int n0 = (blockIdx.x * SK_THREADS + threadIdx.x) * SK_CPT;
  if (n0 >= N) return;
  float acc[MR][SK_CPT];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int j = 0; j < SK_CPT; ++j) acc[m][j] = 0.f;
  const float* wp = w + b * s.wb + (long long)k0 * s.wk;
  const bool full = n0 + SK_CPT <= N;
  if (!WT) {
    // w[k, n], unit n stride: SK_U rows of 4 columns loaded before any is
    // used, so a thread keeps SK_U loads in flight
    for (int kk0 = 0; kk0 < klen; kk0 += SK_U) {
      float wv[SK_U][SK_CPT];
#pragma unroll
      for (int u = 0; u < SK_U; ++u) {
        const float* row = wp + (kk0 + u) * s.wk + n0;
        if (kk0 + u >= klen) {
#pragma unroll
          for (int j = 0; j < SK_CPT; ++j) wv[u][j] = 0.f;
        } else if (VEC && full) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(row));
          wv[u][0] = v.x; wv[u][1] = v.y; wv[u][2] = v.z; wv[u][3] = v.w;
        } else {
#pragma unroll
          for (int j = 0; j < SK_CPT; ++j)
            wv[u][j] = n0 + j < N ? __ldg(row + j) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < SK_U; ++u) {
        if (kk0 + u < klen) {
#pragma unroll
          for (int m = 0; m < MR; ++m) {
            const float xv = xs[m * KC + kk0 + u];
#pragma unroll
            for (int j = 0; j < SK_CPT; ++j)
              acc[m][j] = __fmaf_rn(xv, wv[u][j], acc[m][j]);
          }
        }
      }
    }
  } else {
    // w[n, k], unit k stride: SK_U k of each of the 4 columns loaded
    // (16 bytes at a time) before any is used, then applied in
    // increasing k
    for (int kk0 = 0; kk0 < klen; kk0 += SK_U) {
      float wv[SK_CPT][SK_U];
#pragma unroll
      for (int j = 0; j < SK_CPT; ++j) {
        const float* col = wp + (long long)(n0 + j) * s.wn + kk0;
#pragma unroll
        for (int q = 0; q < SK_U; q += 4) {
          if (n0 + j < N && VEC && kk0 + q + 4 <= klen) {
            const float4 v = __ldg(reinterpret_cast<const float4*>(col + q));
            wv[j][q] = v.x; wv[j][q + 1] = v.y; wv[j][q + 2] = v.z;
            wv[j][q + 3] = v.w;
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              wv[j][q + e] = n0 + j < N && kk0 + q + e < klen
                                 ? __ldg(col + q + e) : 0.f;
          }
        }
      }
#pragma unroll
      for (int q = 0; q < SK_U; ++q) {
        if (kk0 + q < klen) {
#pragma unroll
          for (int m = 0; m < MR; ++m) {
            const float xv = xs[m * KC + kk0 + q];
#pragma unroll
            for (int j = 0; j < SK_CPT; ++j)
              acc[m][j] = __fmaf_rn(xv, wv[j][q], acc[m][j]);
          }
        }
      }
    }
  }
  float* pp = part + b * pb + c * pc + n0;
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    if (m >= M) break;
#pragma unroll
    for (int j = 0; j < SK_CPT; ++j)
      if (n0 + j < N) pp[m * pm + j] = acc[m][j];
  }
}

// out[b, m, n] = partials [b, c, m, n] folded left to right.
__global__ void gemm_fold_kernel(const float* __restrict__ part,
                                 float* __restrict__ out, int batch, int M,
                                 int N, int chunks, long long ob,
                                 long long om) {
  const long long total = (long long)batch * M * N;
  const long long mn = (long long)M * N;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long b = i / mn, r = i % mn;
    const int m = (int)(r / N), n = (int)(r % N);
    const float* p = part + b * chunks * mn + r;
    float t = p[0];
    for (int c = 1; c < chunks; ++c) t = __fadd_rn(t, p[c * mn]);
    out[b * ob + m * om + n] = t;
  }
}

// Vectorised shared-memory reads of V neighbouring floats (16 or 8 bytes).
template <int V>
__device__ __forceinline__ void ld_smem(const float* p, float* d) {
  if (V == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    d[0] = v.x; d[1] = v.y;
  }
}

// One BM x BN output tile a block of (BM/TM) x (BN/TN) = 256 threads.  A
// thread owns two groups of V = TM/2 neighbouring rows, ty*V and BM/2 +
// ty*V, and likewise of columns, so it reads each k's operands from shared
// memory as four V-wide loads: broadcasts for A (a warp spans two ty), 16
// neighbouring V-wide pieces for B.
template <int BM, int BN, int TM, int TN, bool WT>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
gemm_tiled_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ out, int M, int N, int K, Strides s) {
  constexpr int RT = BM / TM, CT = BN / TN, NT = RT * CT;
  constexpr int EA = BM * KT / NT, EB = BN * KT / NT;
  constexpr int V = TM / 2;
  static_assert(NT == 256 && EA * NT == BM * KT && EB * NT == BN * KT &&
                TM == TN && (V == 4 || V == 2), "tile shape");
  __shared__ __align__(16) float As[2][KT][BM];
  __shared__ __align__(16) float Bs[2][KT][BN];
  const int tid = threadIdx.x, tx = tid % CT, ty = tid / CT;
  const int b = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const float* xp = x + b * s.xb;
  const float* wp = w + b * s.wb;
  float ra[EA], rb[EB];

  auto load = [&](int k0) {
#pragma unroll
    for (int e = 0; e < EA; ++e) {
      const int l = tid + e * NT, m = l / KT, kk = l % KT;
      ra[e] = (m0 + m < M && k0 + kk < K)
                  ? __ldg(xp + (m0 + m) * s.xm + k0 + kk) : 0.f;
    }
#pragma unroll
    for (int e = 0; e < EB; ++e) {
      const int l = tid + e * NT;
      int n, kk;
      if (WT) { n = l / KT; kk = l % KT; } else { kk = l / BN; n = l % BN; }
      rb[e] = (n0 + n < N && k0 + kk < K)
                  ? __ldg(wp + (long long)(k0 + kk) * s.wk +
                          (long long)(n0 + n) * s.wn) : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int e = 0; e < EA; ++e) {
      const int l = tid + e * NT;
      As[buf][l % KT][l / KT] = ra[e];
    }
#pragma unroll
    for (int e = 0; e < EB; ++e) {
      const int l = tid + e * NT;
      if (WT) Bs[buf][l % KT][l / KT] = rb[e];
      else Bs[buf][l / BN][l % BN] = rb[e];
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  float* op = out + b * s.ob;

  const int ntiles = (K + KT - 1) / KT;
  load(0);
  store(0);
  __syncthreads();
  for (int t = 0; t < ntiles; ++t) {
    const int cur = t & 1;
    if (t + 1 < ntiles) load((t + 1) * KT);
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      float a[TM], bv[TN];
      ld_smem<V>(&As[cur][kk][ty * V], a);
      ld_smem<V>(&As[cur][kk][BM / 2 + ty * V], a + V);
      ld_smem<V>(&Bs[cur][kk][tx * V], bv);
      ld_smem<V>(&Bs[cur][kk][BN / 2 + tx * V], bv + V);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = __fmaf_rn(a[i], bv[j], acc[i][j]);
    }
    const int k_end = (t + 1) * KT;
    if (k_end % KC == 0 || t + 1 == ntiles) {
      // the chunk's end: its partial goes into the running total, which
      // lives in out (each element this thread's alone)
      const bool first = k_end <= KC;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int m = m0 + (i / V) * (BM / 2) + ty * V + i % V;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int n = n0 + (j / V) * (BN / 2) + tx * V + j % V;
          if (m < M && n < N) {
            float* o = op + (long long)m * s.om + n;
            *o = first ? acc[i][j] : __fadd_rn(*o, acc[i][j]);
          }
          acc[i][j] = 0.f;
        }
      }
    }
    if (t + 1 < ntiles) store(cur ^ 1);
    __syncthreads();
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

template <int MR, bool WT>
cudaError_t launch_skinny_rows(bool vec, dim3 grid, const float* x,
                               const float* w, float* part, int M, int N,
                               int K, const Strides& s, long long pb,
                               long long pc, long long pm,
                               cudaStream_t st) {
  if (vec)
    gemm_skinny_kernel<MR, WT, true><<<grid, SK_THREADS, 0, st>>>(
        x, w, part, M, N, K, s, pb, pc, pm);
  else
    gemm_skinny_kernel<MR, WT, false><<<grid, SK_THREADS, 0, st>>>(
        x, w, part, M, N, K, s, pb, pc, pm);
  return cudaGetLastError();
}

template <bool WT>
cudaError_t launch_skinny(bool vec, dim3 grid, const float* x, const float* w,
                          float* part, int M, int N, int K, const Strides& s,
                          long long pb, long long pc, long long pm,
                          cudaStream_t st) {
  if (M <= 1)
    return launch_skinny_rows<1, WT>(vec, grid, x, w, part, M, N, K, s, pb,
                                     pc, pm, st);
  if (M <= 2)
    return launch_skinny_rows<2, WT>(vec, grid, x, w, part, M, N, K, s, pb,
                                     pc, pm, st);
  if (M <= 4)
    return launch_skinny_rows<4, WT>(vec, grid, x, w, part, M, N, K, s, pb,
                                     pc, pm, st);
  if (M <= 8)
    return launch_skinny_rows<8, WT>(vec, grid, x, w, part, M, N, K, s, pb,
                                     pc, pm, st);
  return launch_skinny_rows<16, WT>(vec, grid, x, w, part, M, N, K, s, pb,
                                    pc, pm, st);
}

template <int BM, int BN, int TM, int TN>
cudaError_t launch_tiled(bool wt, int batch, const float* x, const float* w,
                         float* out, int M, int N, int K, const Strides& s,
                         cudaStream_t st) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  if (wt)
    gemm_tiled_kernel<BM, BN, TM, TN, true><<<grid, 256, 0, st>>>(
        x, w, out, M, N, K, s);
  else
    gemm_tiled_kernel<BM, BN, TM, TN, false><<<grid, 256, 0, st>>>(
        x, w, out, M, N, K, s);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [batch, M, K], w [batch, K, N] (wk == 1 or wn == 1), out [batch, M, N];
// strides: 7 element strides xb, xm, wb, wk, wn, ob, om.  scratch: for M <=
// 16 and K > 256, batch * ceil(K / 256) * M * N floats (else unused, may be
// null).  Returns the cudaError_t of the launches (0 = success).
int pt_gemm_f32(const void* x, const void* w, void* out, void* scratch,
                int batch, int M, int N, int K, const long long* strides,
                void* stream) {
  if (batch < 1 || M < 1 || N < 1 || K < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides s{strides[0], strides[1], strides[2], strides[3],
                  strides[4], strides[5], strides[6]};
  const bool wt = s.wk == 1 && s.wn != 1;
  if ((!wt && s.wn != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* of = static_cast<float*>(out);
  if (M <= 16) {
    const int chunks = (K + KC - 1) / KC;
    if (chunks > 65535) return (int)cudaErrorInvalidValue;
    // 16-byte weight loads: aligned base, batch stride and row stride
    const long long lead = wt ? s.wn : s.wk;
    const bool vec = aligned16(w) && s.wb % 4 == 0 && lead % 4 == 0;
    const dim3 grid((N + SK_THREADS * SK_CPT - 1) / (SK_THREADS * SK_CPT),
                    chunks, batch);
    float* part = of;
    long long pb = s.ob, pc = 0, pm = s.om;
    if (chunks > 1) {
      if (scratch == nullptr) return (int)cudaErrorInvalidValue;
      part = static_cast<float*>(scratch);
      pm = N;
      pc = (long long)M * N;
      pb = pc * chunks;
    }
    cudaError_t e = wt ? launch_skinny<true>(vec, grid, xf, wf, part, M, N, K,
                                             s, pb, pc, pm, st)
                       : launch_skinny<false>(vec, grid, xf, wf, part, M, N,
                                              K, s, pb, pc, pm, st);
    if (e != cudaSuccess || chunks == 1) return (int)e;
    const long long total = (long long)batch * M * N;
    const int blocks = (int)((total + 255) / 256 < 8192 ? (total + 255) / 256
                                                        : 8192);
    gemm_fold_kernel<<<blocks, 256, 0, st>>>(part, of, batch, M, N, chunks,
                                              s.ob, s.om);
    return (int)cudaGetLastError();
  }
  if ((M + 63) / 64 > 65535) return (int)cudaErrorInvalidValue;
  // 128 x 128 tiles, or 64 x 64 where those would leave most of the 132
  // SMs without a block
  const long long big = (long long)((M + 127) / 128) * ((N + 127) / 128) *
                        batch;
  if (big >= 66)
    return (int)launch_tiled<128, 128, 8, 8>(wt, batch, xf, wf, of, M, N, K,
                                             s, st);
  return (int)launch_tiled<64, 64, 4, 4>(wt, batch, xf, wf, of, M, N, K, s,
                                         st);
}

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
