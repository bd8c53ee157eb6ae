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
// The wrapper chooses the launch (ops/cuda/gemm.py `plan`) and passes it
// in; two kernels take it:
//
//   * skinny (M <= 16: the decode step, decode attention): a cluster of
//     up to 8 blocks per (32 * CPT columns, batch), the chunks shared out
//     among its blocks and each block's among its warps, one chunk a
//     warp at a time.  Each lane owns CPT neighbouring columns for every
//     row and streams their weights once, up to 64 floats in flight a
//     lane (the chain over k is sequential, so loads in flight are what
//     hides the memory's latency), reads x from the chunk's rows staged
//     in shared memory, and keeps each chunk's partial there too.
//     After a cluster barrier each block folds its share of the outputs
//     over all chunks in order, reading the other blocks' partials
//     through distributed shared memory: no scratch, no second launch and
//     no counter.  Bound by the weight bytes, 4 * K * N a product.
//   * register-tiled (M > 16: prefill, prefill chunks, BERT serving): a
//     block of 64 threads per 64 x 64 output tile, each thread an 8 x 8
//     patch (measured against 128 x 128 and 128 x 64 tiles at every
//     main-path shape: fastest or within 1.3%).  16-deep k tiles arrive
//     by cp.async (16 bytes where the layout is aligned, with each
//     thread's addresses worked out once; 4 bytes else) in a 4-stage ring
//     in dynamic shared memory, each operand kept as it lies in memory: x
//     m-major, w k-major, or n-major where K^T is read straight from the
//     K cache.  A row pitch of 20 floats puts 8 neighbouring rows' 16-byte
//     reads on 8 distinct bank groups.  At each
//     chunk's end a thread folds its 8 x 8 partial onto its running total,
//     which lives in shared memory ([64][threads], conflict-free); the
//     last fold writes out once.  Where tiles alone leave SMs idle, K is
//     split at chunk boundaries: the first split folds its chunks as
//     above into out, every other split writes each chunk's partial to
//     scratch, and the fold kernel adds them onto out in chunk order.
//     Bound by operations: 2 * M * N * K at the 67 TFLOP/s fp32 peak.
//
// w is read either k-major (w[k, n] with unit n stride: `mul`'s weights,
// P V's values) or n-major (w[n, k] with unit k stride: K^T of Q K^T read
// straight from the K cache).  x needs a unit k stride, out a unit n stride.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int KC = 256;                  // the chunk every partial covers
constexpr int SK_MAX_WARPS = 8;          // skinny: warps a block
constexpr int SK_MAX_CLUSTER = 8;        // skinny: blocks a cluster
constexpr int SK_MAX_SMEM = 227 * 1024;  // skinny: shared bytes a block
constexpr int BM = 64, BN = 64;          // tiled: the output tile
constexpr int BK = 16;                   // tiled: k depth of a stage
constexpr int STAGES = 4;                // tiled: stages of the ring
constexpr int PITCH = BK + 4;  // tiled: row pitch of a k-contiguous tile

struct Strides {
  long long xb, xm;      // x [batch, M, K], unit k stride
  long long wb, wk, wn;  // w [batch, K, N], wk == 1 or wn == 1
  long long ob, om;      // out [batch, M, N], unit n stride
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four neighbouring floats, the first v (<= 4; <= 0: none) from src, the
// rest zero, into 16-byte aligned shared memory: one 16-byte cp.async
// (VEC: src 16-byte aligned) or four 4-byte ones.  `safe` is an address
// to name when no byte is read.
template <bool VEC>
__device__ __forceinline__ void copy4(float* dst, const float* src, int v,
                                      const float* safe) {
  if (VEC) {
    const int bytes = v <= 0 ? 0 : (v >= 4 ? 16 : 4 * v);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                 "r"(smem_u32(dst)), "l"(v > 0 ? src : safe), "r"(bytes));
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::
                   "r"(smem_u32(dst + e)), "l"(e < v ? src + e : safe),
                   "r"(e < v ? 4 : 0));
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ld4(const float* p, float* d) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
}

// Skinny: rows up to MR, CPT columns a lane.  WT: w is n-major (unit k
// stride).  VEC: x and w rows 16-byte aligned (16-byte loads).  A cluster
// of CL blocks along x covers one column tile's chunks: block r takes
// chunks [r CPB, (r + 1) CPB), its warp w chunks r CPB + w, + W, ...,
// each chunk's partial kept in its own slot of the block's dynamic shared
// memory (CPB * MR * 32 * CPT floats), after them each warp's x rows of
// its chunk (W * MR * 256 floats).  After a cluster barrier block r folds
// its 1 / CL of the tile's outputs over all chunks in order, reading the
// other blocks' slots through distributed shared memory.  Two blocks an
// SM (128 registers), but one where an n-major w feeds more than one row
// (its columns' loads along k spill at 128).
template <int MR, int CPT, bool WT, bool VEC>
__global__ void __launch_bounds__(SK_MAX_WARPS * 32, WT && MR > 1 ? 1 : 2)
gemm_skinny_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ out, int M, int N, int K, int CL,
                   int cpb, Strides s) {
  constexpr int COLS = 32 * CPT, E = MR * COLS;
  // k in flight a lane: 64 weights, fewer where registers run short
  constexpr int U = MR > 4 ? 16 : CPT == 1 ? 32 : WT && MR > 1 ? 8 : 16;
  static_assert(U % 4 == 0 && (CPT == 1 || CPT == 4), "skinny shape");
  extern __shared__ __align__(16) float sk[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int W = blockDim.x / 32, warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.y, n0 = blockIdx.x / CL * COLS;
  const int nl = n0 + lane * CPT;  // this lane's first column
  const int chunks = (K + KC - 1) / KC;
  const float* xb = x + b * s.xb;
  const float* wb = w + b * s.wb;
  float* xs = sk + cpb * E + warp * MR * KC;  // this warp's x rows

  for (int slot = warp; slot < cpb; slot += W) {
    const int c = rank * cpb + slot;
    if (c < chunks) {
      const int k0 = c * KC, klen = min(KC, K - k0);
      // the chunk's x rows into the warp's shared memory, zero past M and
      // past the chunk's end
      __syncwarp();
      for (int i = lane; i < MR * KC; i += 32) {
        const int m = i / KC, kk = i % KC;
        xs[i] = m < M && kk < klen
                    ? __ldg(xb + (long long)m * s.xm + k0 + kk) : 0.f;
      }
      __syncwarp();
      float acc[MR][CPT];
#pragma unroll
      for (int m = 0; m < MR; ++m)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[m][j] = 0.f;
      for (int kk0 = 0; kk0 < klen; kk0 += U) {
        // U k of this lane's CPT columns, all loaded before any is used
        float wv[U][CPT];
        if (!WT) {
          const float* wp = wb + (long long)(k0 + kk0) * s.wk + nl;
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const float* row = wp + (long long)u * s.wk;
            if (kk0 + u >= klen) {
#pragma unroll
              for (int j = 0; j < CPT; ++j) wv[u][j] = 0.f;
            } else if (CPT == 4 && VEC && nl + 4 <= N) {
              float t[4];
              const float4 v = __ldg(reinterpret_cast<const float4*>(row));
              t[0] = v.x; t[1] = v.y; t[2] = v.z; t[3] = v.w;
#pragma unroll
              for (int j = 0; j < CPT; ++j) wv[u][j] = t[j];
            } else {
#pragma unroll
              for (int j = 0; j < CPT; ++j)
                wv[u][j] = nl + j < N ? __ldg(row + j) : 0.f;
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            const float* col = wb + (long long)(nl + j) * s.wn + k0 + kk0;
#pragma unroll
            for (int q = 0; q < U; q += 4) {
              if (nl + j < N && VEC && kk0 + q + 4 <= klen) {
                const float4 v =
                    __ldg(reinterpret_cast<const float4*>(col + q));
                wv[q][j] = v.x; wv[q + 1][j] = v.y; wv[q + 2][j] = v.z;
                wv[q + 3][j] = v.w;
              } else {
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  wv[q + e][j] = nl + j < N && kk0 + q + e < klen
                                     ? __ldg(col + q + e) : 0.f;
              }
            }
          }
        }
        // the chains in increasing k, x from the warp's staged rows (4 k
        // at a time up to 4 rows, one k past them)
#pragma unroll
        for (int q = 0; q < U; q += 4) {
          constexpr int XQ = MR <= 4 ? 4 : 1;
          float xv[MR][XQ];
          if constexpr (XQ == 4) {
#pragma unroll
            for (int m = 0; m < MR; ++m) ld4(xs + m * KC + kk0 + q, xv[m]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (kk0 + q + e < klen) {
#pragma unroll
              for (int m = 0; m < MR; ++m) {
                const float xe =
                    XQ == 4 ? xv[m][e % XQ] : xs[m * KC + kk0 + q + e];
#pragma unroll
                for (int j = 0; j < CPT; ++j)
                  acc[m][j] = __fmaf_rn(xe, wv[q + e][j], acc[m][j]);
              }
            }
          }
        }
      }
      float* pp = sk + slot * E + lane * CPT;
#pragma unroll
      for (int m = 0; m < MR; ++m)
#pragma unroll
        for (int j = 0; j < CPT; ++j) pp[m * COLS + j] = acc[m][j];
    }
  }
  cluster.sync();
  // this block's share of the tile's outputs: p_0, then + p_c in order,
  // 8 chunks' partials loaded at a time
  const int per = (E + CL - 1) / CL;
  for (int e = rank * per + threadIdx.x; e < min(E, (rank + 1) * per);
       e += blockDim.x) {
    float t = 0.f;
    for (int c0 = 0; c0 < chunks; c0 += 8) {
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = c0 + i;
        v[i] = c < chunks
                   ? cluster.map_shared_rank(sk, c / cpb)[c % cpb * E + e]
                   : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (c0 + i < chunks) t = c0 + i == 0 ? v[i] : __fadd_rn(t, v[i]);
    }
    const int m = e / COLS, n = n0 + e % COLS;
    if (m < M && n < N) out[b * s.ob + m * s.om + n] = t;
  }
  // no block leaves while another may still read its slots
  cluster.sync();
}

// Tiled: one BM x BN output tile, BM * BN / 64 threads of 8 x 8.  Thread
// (ty, tx) owns rows ty + RT i (i < 8) and columns tx * 4 + j, BN / 2 +
// tx * 4 + j (j < 4; WT: tx + CT j, j < 8).  blockIdx.z = batch * split +
// the split; split s of S takes chunks [s C / S, (s + 1) C / S).  Split 0
// writes its fold to out, split s > 0 chunk c's partial to
// part[b, c - c1, m, n] (c1 = C / S).  Dynamic shared memory: STAGES
// stages of x and w tiles, then the [64][threads] running totals.
template <bool WT, bool VEC>
__global__ void __launch_bounds__(BM * BN / 64)
gemm_tiled_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ out, float* __restrict__ part, int M,
                  int N, int K, int split, Strides s) {
  constexpr int NT = BM * BN / 64, CT = BN / 8, RT = BM / 8;
  constexpr int A_ELEMS = BM * PITCH;
  constexpr int B_ELEMS = WT ? BN * PITCH : BK * BN;
  constexpr int STAGE = A_ELEMS + B_ELEMS;
  static_assert(KC % BK == 0 && BK % 4 == 0 && NT % 32 == 0, "tile shape");
  extern __shared__ __align__(16) float smem[];
  float* tot = smem + STAGES * STAGE;
  const int tid = threadIdx.x, tx = tid % CT, ty = tid / CT;
  const int sp = blockIdx.z % split, b = blockIdx.z / split;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int chunks = (K + KC - 1) / KC;
  const int c_begin = (int)((long long)sp * chunks / split);
  const int c_end = (int)((long long)(sp + 1) * chunks / split);
  const int c1 = chunks / split;  // the first chunk of split 1
  const int k_begin = c_begin * KC, k_end = min(c_end * KC, K);
  const int ntiles = (k_end - k_begin + BK - 1) / BK;
  const float* xp = x + b * s.xb;
  const float* wp = w + b * s.wb;

  auto load = [&](int t) {
    float* As = smem + (t % STAGES) * STAGE;
    float* Bs = As + A_ELEMS;
    const int k0 = k_begin + t * BK;
    for (int p = tid; p < BM * BK / 4; p += NT) {
      const int m = p / (BK / 4), kq = p % (BK / 4) * 4;
      const int v = m0 + m < M ? k_end - (k0 + kq) : 0;
      copy4<VEC>(As + m * PITCH + kq,
                 xp + (long long)(m0 + m) * s.xm + k0 + kq, v, xp);
    }
    if (WT) {
      for (int p = tid; p < BN * BK / 4; p += NT) {
        const int n = p / (BK / 4), kq = p % (BK / 4) * 4;
        const int v = n0 + n < N ? k_end - (k0 + kq) : 0;
        copy4<VEC>(Bs + n * PITCH + kq,
                   wp + (long long)(n0 + n) * s.wn + k0 + kq, v, wp);
      }
    } else {
      for (int p = tid; p < BK * BN / 4; p += NT) {
        const int kk = p / (BN / 4), nq = p % (BN / 4) * 4;
        const int v = k0 + kk < k_end ? N - (n0 + nq) : 0;
        copy4<VEC>(Bs + kk * BN + nq,
                   wp + (long long)(k0 + kk) * s.wk + n0 + nq, v, wp);
      }
    }
  };

  // A full k tile's 16-byte copies (VEC) need no bounds test past the
  // rows and columns: each thread's copies keep their shared-memory
  // offset, their source at k_begin and their byte count every stage
  constexpr int CA = BM * BK / 4 / NT, CB = BN * BK / 4 / NT;
  static_assert(CA * NT * 4 == BM * BK && CB * NT * 4 == BN * BK,
                "whole copies a thread");
  const float* a_src[CA];
  const float* b_src[CB];
  int a_dst[CA], b_dst[CB], a_bytes[CA], b_bytes[CB];
#pragma unroll
  for (int c = 0; c < CA; ++c) {
    const int p = tid + c * NT, m = p / (BK / 4), kq = p % (BK / 4) * 4;
    a_dst[c] = m * PITCH + kq;
    a_bytes[c] = m0 + m < M ? 16 : 0;
    a_src[c] = xp + (long long)(m0 + m) * s.xm + k_begin + kq;
  }
#pragma unroll
  for (int c = 0; c < CB; ++c) {
    const int p = tid + c * NT;
    if (WT) {
      const int n = p / (BK / 4), kq = p % (BK / 4) * 4;
      b_dst[c] = n * PITCH + kq;
      b_bytes[c] = n0 + n < N ? 16 : 0;
      b_src[c] = wp + (long long)(n0 + n) * s.wn + k_begin + kq;
    } else {
      const int kk = p / (BN / 4), nq = p % (BN / 4) * 4;
      b_dst[c] = kk * BN + nq;
      b_bytes[c] = 4 * max(0, min(4, N - (n0 + nq)));
      b_src[c] = wp + (long long)(k_begin + kk) * s.wk + n0 + nq;
    }
  }
  const long long b_step = WT ? BK : BK * s.wk;  // a stage's advance along k
  auto load_full = [&](int t) {
    float* As = smem + (t % STAGES) * STAGE;
    float* Bs = As + A_ELEMS;
#pragma unroll
    for (int c = 0; c < CA; ++c)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                   "r"(smem_u32(As + a_dst[c])),
                   "l"(a_bytes[c] ? a_src[c] + t * BK : xp),
                   "r"(a_bytes[c]));
#pragma unroll
    for (int c = 0; c < CB; ++c)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                   "r"(smem_u32(Bs + b_dst[c])),
                   "l"(b_bytes[c] ? b_src[c] + t * b_step : wp),
                   "r"(b_bytes[c]));
  };
  auto load_tile = [&](int t) {
    if (VEC && k_begin + (t + 1) * BK <= k_end) load_full(t);
    else load(t);
  };

  // where this thread's (i, j) lands in out and in the partials
  auto col = [&](int j) {
    return WT ? n0 + tx + CT * j : n0 + (j / 4) * (BN / 2) + tx * 4 + j % 4;
  };
  auto row = [&](int i) { return m0 + ty + RT * i; };
  float acc[8][8];
  // this thread's 8 x 8 acc into [.., M, N] rows of pitch `pitch` (16-byte
  // stores where the layout allows)
  auto store = [&](float* base, long long pitch) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = row(i);
      if (m >= M) continue;
      float* o = base + (long long)m * pitch;
#pragma unroll
      for (int g = 0; g < 8; g += 4) {
        if (!WT && VEC && col(g) + 4 <= N) {
          *reinterpret_cast<float4*>(o + col(g)) = make_float4(
              acc[i][g], acc[i][g + 1], acc[i][g + 2], acc[i][g + 3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (col(g + e) < N) o[col(g + e)] = acc[i][g + e];
        }
      }
    }
  };

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < ntiles) load_tile(t);
    cp_commit();
  }
  int c = c_begin;
  for (int t = 0; t < ntiles; ++t) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    if (t + STAGES - 1 < ntiles) load_tile(t + STAGES - 1);
    cp_commit();
    const float* As = smem + (t % STAGES) * STAGE;
    const float* Bs = As + A_ELEMS;
#pragma unroll
    for (int kq = 0; kq < BK; kq += 4) {
      float a[8][4], bv[4][8];
#pragma unroll
      for (int i = 0; i < 8; ++i) ld4(As + (ty + RT * i) * PITCH + kq, a[i]);
      if (WT) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float t4[4];
          ld4(Bs + (tx + CT * j) * PITCH + kq, t4);
#pragma unroll
          for (int e = 0; e < 4; ++e) bv[e][j] = t4[e];
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ld4(Bs + (kq + e) * BN + tx * 4, bv[e]);
          ld4(Bs + (kq + e) * BN + BN / 2 + tx * 4, bv[e] + 4);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = __fmaf_rn(a[i][e], bv[e][j], acc[i][j]);
    }
    if ((t + 1) % (KC / BK) != 0 && t + 1 != ntiles) continue;
    // chunk c ends here
    if (c_begin > 0) {
      // a later split: the chunk's partial to scratch
      store(part + ((long long)b * (chunks - c1) + (c - c1)) * M * N, N);
    } else {
      const bool last = c + 1 == c_end;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float* tp = tot + (i * 8 + j) * NT + tid;
          const float v = c == 0 ? acc[i][j] : __fadd_rn(*tp, acc[i][j]);
          if (last) acc[i][j] = v; else *tp = v;
        }
      if (last) store(out + b * s.ob, s.om);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    ++c;
  }
  cp_wait<0>();
}

// out[b, m, n] += parts [b, c, m, n] for c = 0, 1, ..., left to right.
__global__ void gemm_fold_kernel(const float* __restrict__ part,
                                 float* __restrict__ out, int batch, int M,
                                 int N, int parts, long long ob,
                                 long long om) {
  const long long total = (long long)batch * M * N;
  const long long mn = (long long)M * N;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long b = i / mn, r = i % mn;
    const int m = (int)(r / N), n = (int)(r % N);
    const float* p = part + b * parts * mn + r;
    float* o = out + b * ob + m * om + n;
    float t = *o;
    for (int c = 0; c < parts; ++c) t = __fadd_rn(t, p[c * mn]);
    *o = t;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

template <int MR, int CPT, bool WT, bool VEC>
cudaError_t launch_skinny_kernel(int cluster, int batch, const float* x,
                                 const float* w, float* out, int M, int N,
                                 int K, const Strides& s, cudaStream_t st) {
  const int chunks = (K + KC - 1) / KC;
  const int cpb = (chunks + cluster - 1) / cluster;
  const int warps = cpb < SK_MAX_WARPS ? cpb : SK_MAX_WARPS;
  const size_t bytes = sizeof(float) * (cpb * MR * 32 * CPT + warps * MR * KC);
  auto kernel = gemm_skinny_kernel<MR, CPT, WT, VEC>;
  // above 48 KB of dynamic shared memory needs the attribute (once)
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SK_MAX_SMEM);
  if (attr != cudaSuccess) return attr;
  if (bytes > (size_t)SK_MAX_SMEM) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + 32 * CPT - 1) / (32 * CPT) * cluster, batch);
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, x, w, out, M, N, K, cluster, cpb,
                            s);
}

template <int MR, int CPT, bool WT>
cudaError_t launch_skinny_vec(bool vec, int cluster, int batch,
                              const float* x, const float* w, float* out,
                              int M, int N, int K, const Strides& s,
                              cudaStream_t st) {
  return vec ? launch_skinny_kernel<MR, CPT, WT, true>(
                   cluster, batch, x, w, out, M, N, K, s, st)
             : launch_skinny_kernel<MR, CPT, WT, false>(
                   cluster, batch, x, w, out, M, N, K, s, st);
}

template <int MR, bool WT>
cudaError_t launch_skinny_rows(int cpt, bool vec, int cluster, int batch,
                               const float* x, const float* w, float* out,
                               int M, int N, int K, const Strides& s,
                               cudaStream_t st) {
  if (cpt == 4) {
    if (MR > 4) return cudaErrorInvalidValue;
    return launch_skinny_vec<(MR > 4 ? 4 : MR), 4, WT>(
        vec, cluster, batch, x, w, out, M, N, K, s, st);
  }
  return launch_skinny_vec<MR, 1, WT>(vec, cluster, batch, x, w, out, M, N,
                                      K, s, st);
}

template <bool WT>
cudaError_t launch_skinny(int cpt, bool vec, int cluster, int batch,
                          const float* x, const float* w, float* out, int M,
                          int N, int K, const Strides& s, cudaStream_t st) {
  if (M <= 1)
    return launch_skinny_rows<1, WT>(cpt, vec, cluster, batch, x, w, out, M,
                                     N, K, s, st);
  if (M <= 2)
    return launch_skinny_rows<2, WT>(cpt, vec, cluster, batch, x, w, out, M,
                                     N, K, s, st);
  if (M <= 4)
    return launch_skinny_rows<4, WT>(cpt, vec, cluster, batch, x, w, out, M,
                                     N, K, s, st);
  if (M <= 8)
    return launch_skinny_rows<8, WT>(cpt, vec, cluster, batch, x, w, out, M,
                                     N, K, s, st);
  return launch_skinny_rows<16, WT>(cpt, vec, cluster, batch, x, w, out, M,
                                    N, K, s, st);
}

template <bool WT, bool VEC>
cudaError_t launch_tiled_kernel(int batch, int split, const float* x,
                                const float* w, float* out, float* part,
                                int M, int N, int K, const Strides& s,
                                cudaStream_t st) {
  constexpr int NT = BM * BN / 64;
  constexpr int STAGE = BM * PITCH + (WT ? BN * PITCH : BK * BN);
  constexpr int BYTES = sizeof(float) * (STAGES * STAGE + 64 * NT);
  auto kernel = gemm_tiled_kernel<WT, VEC>;
  // above 48 KB of dynamic shared memory needs the attribute (once)
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch * split);
  kernel<<<grid, NT, BYTES, st>>>(x, w, out, part, M, N, K, split, s);
  return cudaGetLastError();
}

cudaError_t launch_tiled(bool wt, bool vec, int batch, int split,
                         const float* x, const float* w, float* out,
                         float* part, int M, int N, int K, const Strides& s,
                         cudaStream_t st) {
  if (wt)
    return vec ? launch_tiled_kernel<true, true>(batch, split, x, w, out,
                                                 part, M, N, K, s, st)
               : launch_tiled_kernel<true, false>(batch, split, x, w, out,
                                                  part, M, N, K, s, st);
  return vec ? launch_tiled_kernel<false, true>(batch, split, x, w, out,
                                                part, M, N, K, s, st)
             : launch_tiled_kernel<false, false>(batch, split, x, w, out,
                                                 part, M, N, K, s, st);
}

}  // namespace

extern "C" {

// x [batch, M, K], w [batch, K, N] (wk == 1 or wn == 1), out [batch, M, N];
// strides: 7 element strides xb, xm, wb, wk, wn, ob, om.  plan: 3 ints from
// ops/cuda/gemm.py `plan`: {0, columns a lane (1 or 4), blocks a cluster
// (1-8, at most the chunk count)} for the skinny kernel (M <= 16), {1,
// split (1 to the chunk count), 0} for the tiled one.  scratch: for a
// split S > 1, batch * (C - C / S) * M * N floats, C = ceil(K / 256) (else
// unused, may be null).  Returns the cudaError_t of the launches (0 =
// success).
int pt_gemm_f32(const void* x, const void* w, void* out, void* scratch,
                int batch, int M, int N, int K, const long long* strides,
                const int* plan, void* stream) {
  if (batch < 1 || M < 1 || N < 1 || K < 1)
    return (int)cudaErrorInvalidValue;
  const Strides s{strides[0], strides[1], strides[2], strides[3],
                  strides[4], strides[5], strides[6]};
  const bool wt = s.wk == 1 && s.wn != 1;
  if (!wt && s.wn != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* of = static_cast<float*>(out);
  const long long lead = wt ? s.wn : s.wk;
  // 16-byte loads: aligned bases, batch strides and row strides
  const bool vec_in = aligned16(x) && aligned16(w) && s.xb % 4 == 0 &&
                      s.xm % 4 == 0 && s.wb % 4 == 0 && lead % 4 == 0;
  const int chunks = (K + 255) / 256;
  if (plan[0] == 0) {
    const int cpt = plan[1], cluster = plan[2];
    if (M > 16 || batch > 65535 || (cpt != 1 && cpt != 4) ||
        (cpt == 4 && M > 4) || cluster < 1 || cluster > SK_MAX_CLUSTER ||
        cluster > chunks)
      return (int)cudaErrorInvalidValue;
    return (int)(wt ? launch_skinny<true>(cpt, vec_in, cluster, batch, xf,
                                          wf, of, M, N, K, s, st)
                    : launch_skinny<false>(cpt, vec_in, cluster, batch, xf,
                                           wf, of, M, N, K, s, st));
  }
  const int split = plan[1];
  if (plan[0] != 1 || split < 1 || split > chunks ||
      (long long)batch * split > 65535 || (M + BM - 1) / BM > 65535 ||
      (split > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  // 16-byte stores too: out's base and strides
  const bool vec = vec_in && aligned16(out) && s.ob % 4 == 0 &&
                   s.om % 4 == 0 && N % 4 == 0;
  float* part = static_cast<float*>(scratch);
  const cudaError_t e = launch_tiled(wt, vec, batch, split, xf, wf, of, part,
                                     M, N, K, s, st);
  if (e != cudaSuccess || split == 1) return (int)e;
  const long long total = (long long)batch * M * N;
  const int blocks = (int)((total + 255) / 256 < 8192 ? (total + 255) / 256
                                                      : 8192);
  gemm_fold_kernel<<<blocks, 256, 0, st>>>(part, of, batch, M, N,
                                            chunks - chunks / split, s.ob,
                                            s.om);
  return (int)cudaGetLastError();
}

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
