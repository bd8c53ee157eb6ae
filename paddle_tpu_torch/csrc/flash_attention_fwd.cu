// Flash-attention forward for Hopper (sm_90a), packed and unpacked.
//
// Each entry replaces one TPU kernel of
// paddle_tpu/ops/pallas/flash_attention.py:
//
//   * pt_flash_attention_packed_fwd replaces `_fp_fwd_kernel` (:513,
//     launched by `_packed_forward` at :572).  It reads q, k and v straight
//     out of the fused projection qkv [B, S, 3H] (q at column h*D, k at
//     H + h*D, v at 2H + h*D; nothing is transposed or copied first) and
//     writes out [B, S, H] with heads merged.
//   * pt_flash_attention_fwd replaces `_fa_fwd_kernel` (:120, launched by
//     `_flash_forward` at :174).  It reads q [B, nh, Sq, D] and k, v
//     [B, nh, Sk, D], each through its own batch, head and row strides
//     (the last dim contiguous), so a [B, nh, S, D] view of a [B, S, nh, D]
//     buffer is read in place, and writes out [B, nh, Sq, D] through the
//     strides it is given.
//
// The two layouts differ only in strides: the packed q of (b, h, s) sits at
// b*S*3H + s*3H + h*D, the unpacked one at b*qb + h*qh + s*qs.  Both add an
// optional additive float32 [B, Sk] key bias broadcast over heads and
// queries (in float32: bfloat16 would round -10000 to -9984), apply an
// optional causal mask q_pos >= k_pos by absolute position (Sq != Sk
// allowed; key tiles past a q tile's last row are skipped) and the softmax
// scale, and write the per-row log-sum-exp lse [B, nh, Sq] in float32, which
// the backward kernels read.  Any Sq and Sk work: rows and keys past them in
// the last tile are masked.  A running max of -inf is never subtracted from
// itself, so a row with no live key gets p = 0 (never exp(0)) and lse = -inf.
//
// run() picks the kernel by dtype, for both entries:
//
//   * bfloat16: fa_fwd_tc_kernel, on the tensor cores.  One block of 288
//     threads per (128-row q tile, head, batch): two consumer warpgroups of
//     64 rows each and one producer warp.  The producer issues every load
//     as a TMA copy (hopper.cuh): the Q tile once, then 64-key K and V tiles
//     through a two-stage ring of 128B-swizzled shared memory gated by
//     mbarriers, so the next tile is in flight while the current one is
//     computed.  A consumer warpgroup computes S = Q K^T with wgmma (both
//     operands in shared memory, fp32 accumulators in registers), applies
//     scale, bias and masks and the online-softmax update to its registers
//     (a row lives in the four threads of a quad: two shuffles reduce it),
//     rounds P to bf16 in registers and accumulates O += P V with wgmma (A
//     from registers, V read MN-major through the transpose bit).  The
//     epilogue writes O / l in bf16 through the strides and lse in float32.
//     Causal q tiles run longest first (the grid's y index is reversed), so
//     the short tiles fill the tail.  Shared memory: 32 KB of Q and 2 x 32
//     KB of K/V at D 128.
//   * float32: fa_fwd_kernel, fp32 FMAs on the CUDA cores: one block of 256
//     threads per (64-row q tile, head, batch) looping over 64-row k/v tiles
//     in shared memory (each thread owns a 4x4 patch of S and 4 rows x D/16
//     columns of O).  It serves fp32 inference and the fp32 card-vs-CPU
//     gates, which TF32 tensor cores would not hold.
//
// Bounds on an H100 SXM (data-sheet peaks, which assume its 700 W power
// limit).  Packed, at BERT-base serving shape (B=4, S=128, 12 heads, D=64,
// fp32): 4*B*nh*S^2*D = 201 MFLOP, 3.0 us at the 67 TFLOP/s fp32
// (non-tensor-core) peak, against 6.3 MB moved (1.9 us at 3.35 TB/s).
// Unpacked, at Llama-2-7B width (B=1, 32 heads, S=2048, D=128, causal,
// bf16): about half of 4*B*nh*S^2*D, 3.44e10 flop, 34.7 us at the 989
// TFLOP/s bf16 tensor-core peak, against 67.4 MB (20.1 us).  Both are
// bound by operations; the bf16 kernel puts its products on the tensor
// cores, keeps loads off the compute warps and balances the causal grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"

namespace {

using hopper::Layout;

// Strides and sizes of one call.  The pointers travel as __restrict__
// kernel parameters, which keeps the read-only load path.
struct FwdShape {
  Layout ql, kl, vl, ol;
  int Sq, Sk, num_heads, causal;
  float scale;
};

// One call's pointers: bias [B, Sk] or null, lse [B, num_heads, Sq].
struct FwdPtrs {
  const void *q, *k, *v, *bias;
  void *out, *lse;
};

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;        // q rows per block
constexpr int kBK = 64;        // k/v rows per tile
constexpr int kThreads = 256;  // 8 warps; 16 x 16 thread grid

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

template <int D>
constexpr size_t smem_bytes() {
  // Qs [BQ][D+1], Ks [BK][D+1], Vs [BK][D], Ps [BQ][BK+1], m/l/corr [BQ]
  return sizeof(float) * (kBQ * (D + 1) + kBK * (D + 1) + kBK * D +
                          kBQ * (kBK + 1) + 3 * kBQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const T* __restrict__ q_, const T* __restrict__ k_,
              const T* __restrict__ v_, const float* __restrict__ bias,
              T* __restrict__ out, float* __restrict__ lse,
              const FwdShape a) {
  extern __shared__ float smem[];
  float* Qs = smem;                      // [kBQ][D + 1]
  float* Ks = Qs + kBQ * (D + 1);        // [kBK][D + 1]
  float* Vs = Ks + kBK * (D + 1);        // [kBK][D]
  float* Ps = Vs + kBK * D;              // [kBQ][kBK + 1]
  float* m_s = Ps + kBQ * (kBK + 1);     // running max per row
  float* l_s = m_s + kBQ;                // running sum per row
  float* c_s = l_s + kBQ;                // this tile's rescale per row

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int Sq = a.Sq, Sk = a.Sk;
  const T* qb = q_ + b * a.ql.b + h * a.ql.h;
  const T* kb = k_ + b * a.kl.b + h * a.kl.h;
  const T* vb = v_ + b * a.vl.b + h * a.vl.h;
  const float* brow = bias ? bias + (long long)b * Sk : nullptr;

  // q tile, pre-scaled as the TPU kernels do (q * scale, then q . k)
  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int q = q0 + r;
    Qs[r * (D + 1) + c] =
        q < Sq ? to_f32(qb[q * a.ql.s + c]) * a.scale : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
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
    __syncthreads();  // previous tile's Ps/Vs reads are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const int k = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (k < Sk) {
        kv = to_f32(kb[k * a.kl.s + c]);
        vv = to_f32(vb[k * a.vl.s + c]);
      }
      Ks[r * (D + 1) + c] = kv;
      Vs[r * D + c] = vv;
    }
    __syncthreads();

    // scores for rows ty + 16*i, keys tx + 16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int k = k0 + c;
        float v = -INFINITY;
        if (k < Sk && !(a.causal && k > q0 + r)) {
          v = s[i][j];
          if (brow) v += brow[k];
        }
        Ps[r * (kBK + 1) + c] = v;
      }
    }
    __syncthreads();

    // online softmax: warp w updates rows 8w .. 8w+7
#pragma unroll
    for (int rr = 0; rr < kBQ / 8; ++rr) {
      const int r = warp * (kBQ / 8) + rr;
      float* prow = Ps + r * (kBK + 1);
      const float v0 = prow[lane], v1 = prow[lane + 32];
      float mx = fmaxf(v0, v1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = v0 == -INFINITY ? 0.f : expf(v0 - m_new);
      const float p1 = v1 == -INFINITY ? 0.f : expf(v1 - m_new);
      prow[lane] = p0;
      prow[lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + sum;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    for (int k = 0; k < kBK; ++k) {
      float pv[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (kBK + 1) + k];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = Vs[k * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

  T* ob = out + b * a.ol.b + h * a.ol.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int q = q0 + r;
    if (q >= Sq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
    T* orow = ob + q * a.ol.s;
#pragma unroll
    for (int j = 0; j < NJ; ++j) orow[tx + 16 * j] = from_f32<T>(acc[i][j] / l);
  }
  if (tid < kBQ && q0 + tid < Sq) {
    lse[((long long)b * a.num_heads + h) * Sq + q0 + tid] =
        m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
  }
}

template <int D>
int launch_f32(const FwdPtrs& p, const FwdShape& a, int B,
               cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_kernel<float, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Sq + kBQ - 1) / kBQ, a.num_heads, B);
  fa_fwd_kernel<float, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(p.q), static_cast<const float*>(p.k),
      static_cast<const float*>(p.v), static_cast<const float*>(p.bias),
      static_cast<float*>(p.out), static_cast<float*>(p.lse), a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (wgmma), TMA loads, warp specialisation
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper::attn;
using hopper::attn::kThreads;  // not the CUDA-core kernel's, found first

// Shared memory: the Q tile, the K/V ring, its barriers, and slack to align
// the tiles to 1024 bytes.
template <int D>
constexpr int kSmem =
    kRowTile<D> + Ring<D>::kBytes + Ring<D>::kBarBytes + 1024;

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
fa_fwd_tc_kernel(const __grid_constant__ hopper::TmaMaps<3> maps,
                 const float* __restrict__ bias,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 const FwdShape a) {
  constexpr int kQ = kRowTile<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = hopper::align1024(smem_raw);
  Ring<D> ring(sm + kQ, sm + kQ + Ring<D>::kBytes);
  const Frame f(a.num_heads, a.Sk, a.causal);
  const int Sq = a.Sq, Sk = a.Sk, nkt = f.nkt, quad = f.quad;

  if (threadIdx.x == 0) ring.init(kConsumerWarps);
  __syncthreads();

  if (f.producer()) {  // one thread issues every load
    if (f.lane == 0) {
      hopper::mbar_expect_tx(ring.q_full, kQ);
      load_rows<D>(sm, &maps.m[0], ring.q_full, f);
      ring.produce(&maps.m[1], &maps.m[2], nkt, f.h, f.b);
    }
    return;
  }

  const int row0 = f.row0, wg_last = f.wg_last;
  const uint8_t* qs = sm + f.wg * 64 * 128;
  const float* brow = bias ? bias + (long long)f.b * Sk : nullptr;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float s[kBN / 2];

  hopper::mbar_wait(ring.q_full, 0);
  for (int t = 0; t < nkt; ++t) {
    const int k0 = t * kBN;
    ring.wait(t);
    if (!(a.causal && k0 > wg_last)) {  // else every key of the tile is dead
      // S = Q K^T
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss_n64(s, hopper::desc_k_step(qs, kBM, kk),
                             hopper::desc_k_step(ring.k(t), kBN, kk), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(s);

      float bv[kBN / 4];  // the bias of this thread's keys, 0 past Sk
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int key = k0 + 8 * j + 2 * quad + c;
          bv[2 * j + c] = brow && key < Sk ? __ldg(brow + key) : 0.f;
        }
      // scale, bias, masks and the online-softmax update, row by row
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + 8 * i;
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int key = k0 + 8 * j + 2 * quad + c;
            float& x = s[4 * j + 2 * i + c];
            const bool live = key < Sk && !(a.causal && key > row);
            x = live ? x * a.scale + bv[2 * j + c] : -INFINITY;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx);
        // a row with no live key yet keeps m = -inf: subtract 0, not -inf,
        // so exp gives 0 for its masked scores and its (empty) past
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float corr = exp2f((m[i] - m_use) * kLog2e);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = s[4 * j + 2 * i + c];
            x = exp2f((x - m_use) * kLog2e);
            sum += x;
          }
        l[i] = l[i] * corr + sum;  // this thread's share; the quad sums last
        m[i] = m_new;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j + 2 * i] *= corr;
          o[4 * j + 2 * i + 1] *= corr;
        }
      }

      // P in bf16 as wgmma A fragments: 16 keys per fragment
      uint32_t p[kBN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          p[kk][r] =
              hopper::pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

      // O += P V
      hopper::fence_regs(o);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        hopper::wgmma_rs<D>(o, p[kk],
                            hopper::desc_mn_step(ring.v(t), kBN, kk));
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(o);
    }
    ring.release(t);
  }

  // epilogue: O / l in bf16 through the strides, lse in float32
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    inv[i] = 1.f / fmaxf(li, 1e-30f);
    const int row = row0 + 8 * i;
    if (quad == 0 && row < Sq)
      lse[((long long)f.b * a.num_heads + f.h) * Sq + row] =
          m[i] + logf(fmaxf(li, 1e-30f));
  }
  store_bf16<D>(out + f.b * a.ol.b + f.h * a.ol.h, a.ol.s, Sq, row0, quad, o,
                inv);
}

template <int D>
int launch(const FwdPtrs& p, const FwdShape& a, int B, cudaStream_t stream) {
  if (!pairs_aligned(p.out, a.ol)) return (int)cudaErrorMisalignedAddress;
  hopper::TmaMaps<3> maps;
  const int nh = a.num_heads;
  const Operand ops[3] = {{p.q, a.Sq, a.ql, kBM},
                          {p.k, a.Sk, a.kl, kBN},
                          {p.v, a.Sk, a.vl, kBN}};
  const int err = encode_maps(&maps, ops, D, nh, B);
  if (err) return err;
  constexpr int smem = kSmem<D>;
  cudaError_t e = cudaFuncSetAttribute(
      fa_fwd_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * nh, (a.Sq + kBM - 1) / kBM);
  fa_fwd_tc_kernel<D><<<grid, kThreads, smem, stream>>>(
      maps, static_cast<const float*>(p.bias),
      static_cast<__nv_bfloat16*>(p.out), static_cast<float*>(p.lse), a);
  return (int)cudaGetLastError();
}

}  // namespace tc

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).
int run(int dtype, int D, const FwdPtrs& p, const FwdShape& a, int B,
        void* stream) {
  if (B <= 0 || a.Sq <= 0 || a.Sk <= 0 || a.num_heads <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return launch_f32<64>(p, a, B, st);
  if (dtype == 0 && D == 128) return launch_f32<128>(p, a, B, st);
  if (dtype == 1 && D == 64) return tc::launch<64>(p, a, B, st);
  if (dtype == 1 && D == 128) return tc::launch<128>(p, a, B, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Packed QKV.  dtype: 0 = float32, 1 = bfloat16.  bias is float32 [B, S]
// or null.  Returns the cudaError_t of the launch (0 = success).
int pt_flash_attention_packed_fwd(const void* qkv, const void* bias,
                                  void* out, void* lse, int B, int S, int H,
                                  int num_heads, int causal, float scale,
                                  int dtype, void* stream) {
  if (num_heads <= 0 || H % num_heads != 0) return (int)cudaErrorInvalidValue;
  const int D = H / num_heads;
  const long long row = 3LL * H;
  const Layout in{(long long)S * row, D, row};
  const Layout ol{(long long)S * H, D, H};
  const char* base = static_cast<const char*>(qkv);
  const size_t col = (size_t)H * (dtype == 1 ? sizeof(__nv_bfloat16)
                                             : sizeof(float));
  const FwdPtrs p{base, base + col, base + 2 * col, bias, out, lse};
  const FwdShape a{in, in, in, ol, S, S, num_heads, causal, scale};
  return run(dtype, D, p, a, B, stream);
}

// Unpacked q [B, nh, Sq, D], k and v [B, nh, Sk, D], out [B, nh, Sq, D].
// strides: 12 element strides, (batch, head, row) of q, k, v and out in
// that order; every last dim is contiguous.  bias is float32 [B, Sk] or
// null; lse float32 [B, nh, Sq].  dtype as above.  In bfloat16, q, k and v
// are read by TMA: their addresses and byte strides must be multiples of
// 16 (cudaErrorMisalignedAddress otherwise).
int pt_flash_attention_fwd(const void* q, const void* k, const void* v,
                           const void* bias, void* out, void* lse,
                           const long long* strides, int B, int Sq, int Sk,
                           int num_heads, int D, int causal, float scale,
                           int dtype, void* stream) {
  const Layout ql{strides[0], strides[1], strides[2]};
  const Layout kl{strides[3], strides[4], strides[5]};
  const Layout vl{strides[6], strides[7], strides[8]};
  const Layout ol{strides[9], strides[10], strides[11]};
  const FwdPtrs p{q, k, v, bias, out, lse};
  const FwdShape a{ql, kl, vl, ol, Sq, Sk, num_heads, causal, scale};
  return run(dtype, D, p, a, B, stream);
}

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
