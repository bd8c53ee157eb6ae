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
//   * bfloat16 and float16: fa_fwd_tc_kernel<T, D>, on the tensor cores
//     (the same code for either 16-bit type T; hopper.cuh's Half16).  One
//     block of 288 threads per (128-row q tile, head, batch): two consumer
//     warpgroups of 64 rows each and one producer warp.  The producer
//     issues every load as a TMA copy (hopper.cuh): the Q tile once, then
//     64-key K and V tiles through a two-stage ring of 128B-swizzled shared
//     memory gated by mbarriers, so the next tile is in flight while the
//     current one is computed.  A consumer warpgroup computes S = Q K^T
//     with wgmma (both operands in shared memory, fp32 accumulators in
//     registers), applies scale, bias and masks and the online-softmax
//     update to its registers (a row lives in the four threads of a quad:
//     two shuffles reduce it), rounds P to T in registers and accumulates
//     O += P V with wgmma (A from registers, V read MN-major through the
//     transpose bit).  The epilogue writes O / l in T through the strides
//     and lse in float32.
//     Inf and NaN in q, k or v pass through the max, the exponentials and
//     both products into out (nothing is clamped), as in the plain
//     version, so a float16 overflow upstream reaches the loss scaler.
//     Causal q tiles run longest first (the grid's y index is reversed), so
//     the short tiles fill the tail.  Shared memory: 32 KB of Q and 2 x 32
//     KB of K/V at D 128.  D is 32, 64 or 128: at D 32 a 16-bit row is 64
//     bytes, so the tiles are 64-byte swizzled (hopper.cuh's Tile), S =
//     Q K^T takes two k16 steps and O += P V wgmma's n32 shape.
//   * float32: fa_fwd_f32_kernel, exact fp32 FMAs on the CUDA cores (no
//     TF32: the fp32 gates hold the port to the CPU at 2e-5 / 1e-5).  It
//     stands for `_fp_fwd_kernel` (#1: BERT serving, 12 launches a request,
//     and the fp32 BERT training gate) and `_fa_fwd_kernel` (#4: the fp32
//     Llama gate) in float32.  Each warp owns 8 q rows; a block of 2 or 8
//     warps (16- or 64-row q tile; the launch takes 16 where 64-row tiles
//     would leave more than half of the SMs without a block, as BERT
//     serving at batch 1 does) streams 64-key K, V and bias tiles through
//     a two-stage ring of shared memory filled by 16-byte cp.async copies,
//     so the next tile lands while this one is computed; one block barrier
//     a tile.  A warp's lanes are 2 row groups x 16 key groups: a lane
//     holds a 4-row x 4-key patch of S (max and sum over the key group by
//     shuffles), then P goes through a warp-private strip to P V, where the
//     lane holds a 4-row x D/16-column patch of O.  All shared-memory reads
//     are 16 bytes a lane, from rows padded against bank conflicts; each
//     float read feeds 2 FMAs (2.7 in P V at D 128).  Operands must be
//     16-byte aligned (the wrappers copy one that is not); out is written
//     with 16-byte stores.
//
// Bounds on an H100 SXM (data-sheet peaks, which assume its 700 W power
// limit).  At D 32 (MiniLM-L12-H384: 12 heads of 32) the exponentials
// bound it: B*nh*S^2 of them against 4*B*nh*S^2*D flop, so at its training
// shape (B 32, S 512, bf16) 101 M exponentials take 26 us at the ~3.9 T/s
// of the special-function units, the products 13 us, the bytes 7.5 us.
// fp32 (67 TFLOP/s outside the tensor cores, 3.35 TB/s): BERT-base
// serving (B 4, S 128, 12 heads, D 64) is 4*B*nh*S^2*D = 201 MFLOP, 3.0 us,
// against 6.3 MB moved (1.9 us); B 1: 0.75 us, B 8: 6.0 us.  BERT's
// training shape (B 8, S 512) 6.44 GFLOP, 96 us.  The Llama shape (B 1, 32
// heads, S 2048, D 128, causal) about half of 4*B*nh*S^2*D, 3.44e10 flop,
// 513 us.  All bound by operations; the FMA pipes wait on shared-memory
// reads (a cycle per float a lane, against 4 FMA instructions a cycle),
// which the register patches cut, on loads, which the ring keeps in
// flight, and at serving's size on the card's fill, which the tile choice
// sets.  bf16 at the Llama shape: 34.7 us at the 989 TFLOP/s tensor-core
// peak, against 67.4 MB (20.1 us); the bf16 kernel puts its products on
// the tensor cores, keeps loads off the compute warps and balances the
// causal grid.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
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

namespace f32 {

constexpr int kKeys = 64;  // keys per K/V tile
constexpr float kLog2e = 1.4426950408889634f;

// The lanes of a warp as 2 row groups x kKG = 16 key (column) groups:
// lane (rg, kg) holds 4 q rows, 4 rg .. 4 rg + 3 of the warp's kR = 8,
// against keys kg + 16 j of a tile (j < 4) in Q K^T and output columns
// 4 kg + 64 jj .. + 3 (jj < D / 64; at D 32 columns 2 kg and 2 kg + 1) in
// P V.  A shared-memory load costs the
// SM's load pipe a cycle per float a lane, broadcast or not, against 4 FMA
// instructions a cycle: a lane's 4 x 4 patch of S gets 16 FMAs from 8
// floats, its 4 x D/16 patch of O 4 D/16 from 4 + D/16 (2 at D 64, 2.7 at
// D 128).
constexpr int kKG = 16;
constexpr int kR = 4 * 32 / kKG;   // q rows a warp
constexpr int kKP = kKeys / kKG;   // keys a lane

// Shared memory of a block of W warps, in floats: a two-stage ring whose
// stage holds a K tile (rows padded to D + 4 floats, so the eight lanes of
// one phase of a 16-byte load, which read eight consecutive keys, fall in
// eight different 4-bank groups), a V tile and the tile's bias; then each
// warp's pre-scaled Q rows and its P strip (rows padded to 68 floats).
// Every part starts on a 16-byte boundary.
template <int D, int W>
struct Smem {
  static constexpr int kKStride = D + 4;
  static constexpr int kPStride = kKeys + 4;
  static constexpr int kK = kKeys * kKStride;
  static constexpr int kV = kKeys * D;
  static constexpr int kStage = kK + kV + kKeys;
  static constexpr int kQ = W * kR * D;
  static constexpr int kP = W * kR * kPStride;
  static constexpr int kBytes = 4 * (2 * kStage + kQ + kP);
};

// One block of W warps per (8 W-row q tile, head, batch); a warp's rows'
// scores, softmax state and output stay in its lanes' registers.
template <int D, int W>
__global__ void __launch_bounds__(32 * W)
fa_fwd_f32_kernel(const float* __restrict__ q_, const float* __restrict__ k_,
                  const float* __restrict__ v_,
                  const float* __restrict__ bias, float* __restrict__ out,
                  float* __restrict__ lse, const FwdShape a) {
  constexpr int R = kR, KG = kKG, KP = kKP;
  constexpr int CP = D / kKG;  // output columns a lane
  using S = Smem<D, W>;
  constexpr int kTile = W * R;    // q rows per block
  constexpr int kChunks = D / 4;  // 16-byte chunks per row
  extern __shared__ float4 smem_f4[];
  float* sm = reinterpret_cast<float*>(smem_f4);

  const int h = blockIdx.x % a.num_heads;
  const int b = blockIdx.x / a.num_heads;
  // causal: the longest q tiles first, the short ones fill the tail
  const int qt = a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * kTile;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rg = lane / KG, kg = lane % KG;
  const int row0 = q0 + warp * R;  // the warp's first row
  const int my0 = row0 + 4 * rg;   // the lane's first row
  const int Sq = a.Sq, Sk = a.Sk;
  const float* kb = k_ + b * a.kl.b + h * a.kl.h;
  const float* vb = v_ + b * a.vl.b + h * a.vl.h;
  const float* brow = bias ? bias + (long long)b * Sk : nullptr;
  int nkt = (Sk + kKeys - 1) / kKeys;
  if (a.causal) nkt = min(nkt, (q0 + kTile - 1) / kKeys + 1);  // later dead

  // Key tile t into stage t % 2, as one cp.async group of this thread's
  // copies: the same 16-byte column chunk `col` of rows r0, r0 + kStep, ...
  // (the block's 32 W threads cover kStep rows a pass); keys past Sk read
  // as zeros (their bias is never read).
  constexpr int kStep = 32 * W / kChunks;
  const int col = (tid % kChunks) * 4, r0 = tid / kChunks;
  const float* kc = kb + (long long)r0 * a.kl.s + col;
  const float* vc = vb + (long long)r0 * a.vl.s + col;
  const long long kstep = (long long)kStep * a.kl.s;
  const long long vstep = (long long)kStep * a.vl.s;
  auto load = [&](int t) {
    float* st = sm + (t & 1) * S::kStage;
    const int k0 = t * kKeys;
    const float* kp = kc + (long long)k0 * a.kl.s;
    const float* vp = vc + (long long)k0 * a.vl.s;
#pragma unroll
    for (int j = 0; j < kKeys / kStep; ++j) {
      const int r = r0 + j * kStep;
      const bool in = k0 + r < Sk;
      hopper::cp_async_16(st + r * S::kKStride + col, in ? kp : kb, in);
      hopper::cp_async_16(st + S::kK + r * D + col, in ? vp : vb, in);
      kp += kstep;
      vp += vstep;
    }
    if (brow)
      for (int i = tid; i < kKeys; i += 32 * W)
        if (k0 + i < Sk)
          hopper::cp_async_f32(st + S::kK + S::kV + i, brow + k0 + i);
    hopper::cp_async_commit();
  };
  load(0);

  // the warp's q rows, pre-scaled as the TPU kernels do (q * scale, then
  // q . k); rows past Sq are zeros and never written out
  float* qs = sm + 2 * S::kStage + warp * R * D;
  float* ps = sm + 2 * S::kStage + S::kQ + warp * R * S::kPStride;
  const float* qb = q_ + b * a.ql.b + h * a.ql.h;
#pragma unroll
  for (int i = lane; i < R * kChunks; i += 32) {
    const int r = i / kChunks, c = (i % kChunks) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < Sq)
      x = __ldg(reinterpret_cast<const float4*>(
          qb + (long long)(row0 + r) * a.ql.s + c));
    x.x *= a.scale;
    x.y *= a.scale;
    x.z *= a.scale;
    x.w *= a.scale;
    *reinterpret_cast<float4*>(qs + r * D + c) = x;
  }

  float acc[4][CP], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;  // this lane's share; the key group sums it at the end
#pragma unroll
    for (int c = 0; c < CP; ++c) acc[i][c] = 0.f;
  }
  const bool rows_live = row0 < Sq;
  const int row_last = row0 + R - 1;
  const float* qr = qs + 4 * rg * D;                // the lane's Q rows
  float* pr = ps + 4 * rg * S::kPStride;            // and P rows

  for (int t = 0; t < nkt; ++t) {
    // tile t has landed for every thread, and every warp is done with
    // tile t - 1, whose stage the next load reuses: the one block barrier
    hopper::cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < nkt) load(t + 1);
    const int k0 = t * kKeys;
    if (!rows_live || (a.causal && k0 > row_last)) continue;  // all dead
    const float* ks = sm + (t & 1) * S::kStage;
    const float* vs = ks + S::kK;
    const float* bs = vs + S::kV;

    // S = (q * scale) K^T: rows my0 + i, keys k0 + kg + KG j
    float s[4][KP];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KP; ++j) s[i][j] = 0.f;
    const float* kr = ks + kg * S::kKStride;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qr + i * D + d);
#pragma unroll
      for (int j = 0; j < KP; ++j) {
        const float4 x =
            *reinterpret_cast<const float4*>(kr + j * KG * S::kKStride + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][j] = fmaf(qv[i].x, x.x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, x.y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, x.z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, x.w, s[i][j]);
        }
      }
    }

    // bias, masks and the online-softmax update, row by row: score and
    // bias are summed before the max is taken, as the plain version does;
    // a row's keys lie in the KG lanes of its row group
    float bv[KP];
#pragma unroll
    for (int j = 0; j < KP; ++j) bv[j] = brow ? bs[kg + KG * j] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = my0 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < KP; ++j) {
        const int key = k0 + kg + KG * j;
        const bool live = key < Sk && !(a.causal && key > row);
        s[i][j] = live ? (brow ? s[i][j] + bv[j] : s[i][j]) : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = KG / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      // a row with no live key yet keeps m = -inf: subtract 0, not -inf,
      // so its masked scores and its (empty) past give exp = 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = exp2f((m[i] - m_use) * kLog2e);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KP; ++j) {
        const float p = exp2f((s[i][j] - m_use) * kLog2e);
        sum += p;
        pr[i * S::kPStride + kg + KG * j] = p;
      }
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CP; ++c) acc[i][c] *= corr;
    }
    __syncwarp();  // the warp's P strip is written

    // O += P V: rows my0 + i, columns 4 kg + 4 KG jj .. + 3 (at D 32:
    // columns 2 kg, 2 kg + 1), four keys a step
#pragma unroll 2
    for (int k = 0; k < kKeys; k += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(pr + i * S::kPStride + k);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if constexpr (CP == 2) {
          const float2 x =
              *reinterpret_cast<const float2*>(vs + (k + u) * D + 2 * kg);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = u == 0   ? pv[i].x
                            : u == 1 ? pv[i].y
                            : u == 2 ? pv[i].z
                                     : pv[i].w;
            acc[i][0] = fmaf(p, x.x, acc[i][0]);
            acc[i][1] = fmaf(p, x.y, acc[i][1]);
          }
        } else {
          const float* vr = vs + (k + u) * D + 4 * kg;
#pragma unroll
          for (int jj = 0; jj < CP / 4; ++jj) {
            const float4 x =
                *reinterpret_cast<const float4*>(vr + 4 * KG * jj);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float p = u == 0   ? pv[i].x
                              : u == 1 ? pv[i].y
                              : u == 2 ? pv[i].z
                                       : pv[i].w;
              acc[i][4 * jj + 0] = fmaf(p, x.x, acc[i][4 * jj + 0]);
              acc[i][4 * jj + 1] = fmaf(p, x.y, acc[i][4 * jj + 1]);
              acc[i][4 * jj + 2] = fmaf(p, x.z, acc[i][4 * jj + 2]);
              acc[i][4 * jj + 3] = fmaf(p, x.w, acc[i][4 * jj + 3]);
            }
          }
        }
      }
    }
    // the strip's next writes follow the next block barrier
  }
  if (!rows_live) return;

  // epilogue: out = acc / l through the strides, lse = m + log(l)
  float* ob = out + b * a.ol.b + h * a.ol.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = KG / 2; off > 0; off >>= 1)
      li += __shfl_xor_sync(0xffffffffu, li, off);
    const int row = my0 + i;
    if (row >= Sq) continue;
    const float den = fmaxf(li, 1e-30f);
    if constexpr (CP == 2) {
      *reinterpret_cast<float2*>(ob + (long long)row * a.ol.s + 2 * kg) =
          make_float2(acc[i][0] / den, acc[i][1] / den);
    } else {
      float* orow = ob + (long long)row * a.ol.s + 4 * kg;
#pragma unroll
      for (int jj = 0; jj < CP / 4; ++jj)
        *reinterpret_cast<float4*>(orow + 4 * KG * jj) = make_float4(
            acc[i][4 * jj] / den, acc[i][4 * jj + 1] / den,
            acc[i][4 * jj + 2] / den, acc[i][4 * jj + 3] / den);
    }
    if (kg == 0)
      lse[((long long)b * a.num_heads + h) * Sq + row] = m[i] + logf(den);
  }
}

inline int num_sms() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

template <int D, int W>
int launch_tiles(const FwdPtrs& p, const FwdShape& a, int B,
                 cudaStream_t stream) {
  constexpr int smem = Smem<D, W>::kBytes;
  // the largest shared-memory carveout, so that three 16-row blocks (77 KB
  // each at D 64) fit an SM
  static const cudaError_t attr = hopper::set_smem_limit(
      fa_fwd_f32_kernel<D, W>, smem, /*max_carveout=*/true);
  if (attr != cudaSuccess) return (int)attr;
  const int tiles = (a.Sq + W * kR - 1) / (W * kR);
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(B * a.num_heads, tiles);
  fa_fwd_f32_kernel<D, W><<<grid, 32 * W, smem, stream>>>(
      static_cast<const float*>(p.q), static_cast<const float*>(p.k),
      static_cast<const float*>(p.v), static_cast<const float*>(p.bias),
      static_cast<float*>(p.out), static_cast<float*>(p.lse), a);
  return (int)cudaGetLastError();
}

// 16-row q tiles (2 warps of 8 rows) where 64-row tiles would leave more
// than half of the card's SMs without a block (BERT serving at batch 1:
// 12 heads x 2 tiles), else 64-row tiles (8 warps), which read each K/V
// tile from L2 once for 4x the rows.  D 32 takes 64-row tiles at every
// fill: its 16-row instantiation spilled (8 bytes, ptxas on sm_90a).
template <int D>
int launch(const FwdPtrs& p, const FwdShape& a, int B, cudaStream_t stream) {
  const int nh = a.num_heads;
  using hopper::aligned16;
  if (!aligned16(p.q, a.ql, B, nh, a.Sq) ||
      !aligned16(p.k, a.kl, B, nh, a.Sk) ||
      !aligned16(p.v, a.vl, B, nh, a.Sk) ||
      !aligned16(p.out, a.ol, B, nh, a.Sq))
    return (int)cudaErrorMisalignedAddress;
  if constexpr (D != 32) {
    static const int sms = num_sms();
    const long long big = (long long)B * nh * ((a.Sq + 63) / 64);
    if (2 * big < sms) return launch_tiles<D, 2>(p, a, B, stream);
  }
  return launch_tiles<D, 8>(p, a, B, stream);
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bfloat16 and float16: tensor cores (wgmma), TMA loads, warp
// specialisation
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper::attn;

// Shared memory: the Q tile, the K/V ring, its barriers, and slack to align
// the tiles to 1024 bytes.
template <int D>
constexpr int kSmem =
    kRowTile<D> + Ring<D>::kBytes + Ring<D>::kBarBytes + 1024;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
fa_fwd_tc_kernel(const __grid_constant__ hopper::TmaMaps<3> maps,
                 const float* __restrict__ bias, T* __restrict__ out,
                 float* __restrict__ lse, const FwdShape a) {
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
  const uint8_t* qs = wg_rows<D>(sm, f.wg);
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
        hopper::wgmma_ss_n64<T>(
            s, hopper::desc_k_step<D>(qs, kBM, kk),
            hopper::desc_k_step<D>(ring.k(t), kBN, kk), kk > 0);
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

      // P in T as wgmma A fragments: 16 keys per fragment (P in [0, 1]:
      // float16 keeps 2**-24 and up, finer than bfloat16 above 2**-14)
      uint32_t p[kBN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          p[kk][r] =
              hopper::pack16<T>(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

      // O += P V
      hopper::fence_regs(o);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        hopper::wgmma_rs<T, D>(o, p[kk],
                               hopper::desc_mn_step<D>(ring.v(t), kBN, kk));
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(o);
    }
    ring.release(t);
  }

  // epilogue: O / l in T through the strides, lse in float32
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
  store16<T, D>(out + f.b * a.ol.b + f.h * a.ol.h, a.ol.s, Sq, row0, quad, o,
                inv);
}

template <typename T, int D>
int launch(const FwdPtrs& p, const FwdShape& a, int B, cudaStream_t stream) {
  if (!pairs_aligned(p.out, a.ol)) return (int)cudaErrorMisalignedAddress;
  hopper::TmaMaps<3> maps;
  const int nh = a.num_heads;
  const Operand ops[3] = {{p.q, a.Sq, a.ql, kBM},
                          {p.k, a.Sk, a.kl, kBN},
                          {p.v, a.Sk, a.vl, kBN}};
  const int err = encode_maps<T>(&maps, ops, D, nh, B);
  if (err) return err;
  constexpr int smem = kSmem<D>;
  static const cudaError_t attr = hopper::set_smem_limit(
      fa_fwd_tc_kernel<T, D>, smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid(B * nh, (a.Sq + kBM - 1) / kBM);
  fa_fwd_tc_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      maps, static_cast<const float*>(p.bias), static_cast<T*>(p.out),
      static_cast<float*>(p.lse), a);
  return (int)cudaGetLastError();
}

}  // namespace tc

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16, 2 = float16 (tensor
// cores).
int run(int dtype, int D, const FwdPtrs& p, const FwdShape& a, int B,
        void* stream) {
  if (B <= 0 || a.Sq <= 0 || a.Sk <= 0 || a.num_heads <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 32) return f32::launch<32>(p, a, B, st);
  if (dtype == 0 && D == 64) return f32::launch<64>(p, a, B, st);
  if (dtype == 0 && D == 128) return f32::launch<128>(p, a, B, st);
  if (dtype == 1 && D == 32)
    return tc::launch<__nv_bfloat16, 32>(p, a, B, st);
  if (dtype == 1 && D == 64)
    return tc::launch<__nv_bfloat16, 64>(p, a, B, st);
  if (dtype == 1 && D == 128)
    return tc::launch<__nv_bfloat16, 128>(p, a, B, st);
  if (dtype == 2 && D == 32) return tc::launch<__half, 32>(p, a, B, st);
  if (dtype == 2 && D == 64) return tc::launch<__half, 64>(p, a, B, st);
  if (dtype == 2 && D == 128) return tc::launch<__half, 128>(p, a, B, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {


// Packed QKV.  dtype: 0 = float32, 1 = bfloat16, 2 = float16.  bias is
// float32 [B, S] or null.  Returns the cudaError_t of the launch (0 =
// success).
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
  const size_t col = (size_t)H * (dtype == 0 ? sizeof(float) : 2);
  const FwdPtrs p{base, base + col, base + 2 * col, bias, out, lse};
  const FwdShape a{in, in, in, ol, S, S, num_heads, causal, scale};
  return run(dtype, D, p, a, B, stream);
}

// Unpacked q [B, nh, Sq, D], k and v [B, nh, Sk, D], out [B, nh, Sq, D].
// strides: 12 element strides, (batch, head, row) of q, k, v and out in
// that order; every last dim is contiguous.  bias is float32 [B, Sk] or
// null; lse float32 [B, nh, Sq].  dtype as above.  q, k and v are read in
// 16-byte pieces (TMA in 16 bits, cp.async in float32): their addresses
// and byte strides must be multiples of 16, and in float32 out's too
// (cudaErrorMisalignedAddress otherwise).
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
