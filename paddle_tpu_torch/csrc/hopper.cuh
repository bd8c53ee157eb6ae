// Hopper (sm_90a) building blocks of the attention kernels in
// flash_attention_fwd.cu and flash_attention_bwd.cu: TMA tensor maps and
// loads, cp.async (also the fp32 forward's 16-byte copies), mbarriers, the
// launch-side shared-memory limit, and warpgroup matrix multiplies (wgmma) on
// 16-bit tiles held in 128-byte-swizzled shared memory; then the frame the
// kernels share (tile sizes, block and thread coordinates, q-tile loads,
// the 16-bit epilogue, the launch-side maps).  Raw PTX, no CUTLASS/CuTe, so
// a source builds in seconds.
//
// The tensor-core kernels are templates on their 16-bit element type T,
// bfloat16 or float16 (Half16 below).  Both are 2 bytes, so everything
// laid out in bytes (tiles, swizzle, TMA boxes, descriptors) is the same;
// T picks the TMA map's data type, the wgmma operand type (.bf16 or
// .f16) and the rounding of fp32 registers into operands and outputs.
//
// Shared-memory tiles.  TMA writes a box of 16-bit columns x R rows as R
// rows of one swizzle span, the 16-byte chunks of each row XOR-ed with its
// place in an atom of 8 rows; wgmma reads the same layout in the matching
// swizzle mode (Tile<D> below).  At D 64 and 128 the span is 128 bytes (64
// columns; a chunk XOR-ed with r % 8; 1024-byte atoms) and a D-wide tile is
// D/64 such boxes ("halves") one after another.  At D 32 a row is 64 bytes,
// so the span is 64 (the whole row, one box; a chunk XOR-ed with (r / 2) %
// 4; 512-byte atoms): a 128-byte box would be half zeros, doubling the
// tile's bytes and the K of every product.  A tile is read by wgmma in two
// ways:
//   * K-major (the contraction runs along the columns): Q, dO, K and V
//     as the operands of Q K^T and dO V^T (K Q^T and V dO^T in dK/dV).
//     Descriptor: SBO = one atom (the next 8 rows); a 16-column k step
//     moves the start address by 32 bytes inside the span; past the span,
//     the next half.
//   * MN-major (the contraction runs along the rows, the output columns
//     along the contiguous ones), V in P V, K in dS K, dO in P^T dO and Q
//     in dS^T Q, with the instruction's transpose bit.  Descriptor: SBO =
//     one atom (the next 8 rows of the contraction), LBO = the byte
//     distance between halves (the next 64 output columns; unused at D
//     32); a 16-row k step moves the start by 16 rows of the span.
// Every tile starts on a 1024-byte boundary, a multiple of either atom.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hopper {

// The 16-bit element types of the tensor-core kernels.  pair() rounds two
// floats to nearest even into the two halves of one 32-bit register (lo
// in the low half); a float16 rounding past 65504 gives inf, and inf and
// NaN pass through, so an overflow reaches the caller's finiteness check.
template <typename T>
struct Half16;

template <>
struct Half16<__nv_bfloat16> {
  using Pair = __nv_bfloat162;
  static constexpr CUtensorMapDataType kMapType =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static __device__ __forceinline__ Pair pair(float lo, float hi) {
    return __floats2bfloat162_rn(lo, hi);
  }
};

template <>
struct Half16<__half> {
  using Pair = __half2;
  static constexpr CUtensorMapDataType kMapType =
      CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  static __device__ __forceinline__ Pair pair(float lo, float hi) {
    return __floats2half2_rn(lo, hi);
  }
};

template <typename T>
constexpr bool kIsF16 = std::is_same<T, __half>::value;

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up at run time through the
// CUDA runtime, so that the library links against the runtime only (no
// -lcuda).
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The N maps one kernel reads (q, k, v, and dO for the dQ kernel).  Passed
// by value as a __grid_constant__ kernel parameter.
template <int N>
struct TmaMaps {
  CUtensorMap m[N];
};

// The shared-memory layout of a D-wide 16-bit tile (D = 32, 64 or 128): the
// swizzle span in bytes, the columns of one TMA box, the boxes of a row,
// the atom of 8 rows (the descriptors' SBO) and the descriptor's layout
// type (1 = 128-byte swizzle, 2 = 64-byte).
template <int D>
struct Tile {
  static_assert(D == 32 || D == 64 || D == 128, "head_dim 32, 64 or 128");
  static constexpr int kSpan = D >= 64 ? 128 : 64;
  static constexpr int kCols = kSpan / 2;
  static constexpr int kBoxes = D / kCols;
  static constexpr int kAtom = 8 * kSpan;
  static constexpr uint64_t kLayout = kSpan == 128 ? 1 : 2;
};

// A rank-4 map (D, heads, rows, batch) over a 16-bit [B, heads, rows, D]
// operand of TMA data type `type` whose last dim is contiguous, with
// element strides (sb, sh, ss):
// boxes of Tile<D>::kCols columns x `box_rows` rows of one head and batch,
// swizzled over Tile<D>::kSpan bytes (128 at D 64 and 128, 64 at D 32);
// rows past `rows` read as zeros.  TMA needs the base address and
// every byte stride to be multiples of 16 (a size-1 dim's stride is never
// stepped).  Returns 0 or a cudaError_t.
inline int encode_map(CUtensorMap* map, CUtensorMapDataType type,
                      const void* base, int D, int heads, int rows, int B,
                      long long sb, long long sh, long long ss,
                      int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const long long sizes[3] = {heads, rows, B};
  const long long elems[3] = {sh, ss, sb};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) {
    const long long bytes = sizes[i] == 1 ? 16 : elems[i] * 2;
    if (bytes <= 0 || bytes % 16 != 0 || bytes >= (1LL << 40))
      return (int)cudaErrorMisalignedAddress;
    strides[i] = (cuuint64_t)bytes;
  }
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)rows, (cuuint64_t)B};
  if (D != 32 && D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  const bool wide = D >= 64;  // Tile<D>::kSpan == 128
  const cuuint32_t box[4] = {wide ? 64u : 32u, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, type, 4,
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        wide ? CU_TENSOR_MAP_SWIZZLE_128B
                             : CU_TENSOR_MAP_SWIZZLE_64B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidPitchValue;
}

// Lifts a kernel's dynamic shared-memory limit to `bytes` and, with
// `max_carveout`, asks for the largest shared-memory share of the SM's
// L1.  A launch site calls it once per kernel, from a function-local
// static, not per launch.
template <typename Kernel>
inline cudaError_t set_smem_limit(Kernel* kernel, int bytes,
                                  bool max_carveout = false) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && max_carveout)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  return e;
}

// ---------------------------------------------------------------------------
// device: shared memory, mbarriers, TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary at or after `p` (the 128B swizzle repeats
// every 1024 bytes, the 64B one every 512, so a swizzled tile must start on
// such a boundary).
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the TMA unit.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed.  A
// wait that outlasts ~10 s of clock (a lost TMA transaction or a wrong
// parity) traps, so a fault ends the launch with an error, never a hang.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > 20000000000LL) __trap();
  }
}

// One float from global to shared memory, asynchronously (cp.async); the
// thread's copies so far count as one arrival on `bar` when they land
// (cp_async_arrive; .noinc: the barrier's initial count includes it).
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// 16 bytes from global to shared memory (cp.async.cg: through L2 only);
// with `full` false nothing is read and the 16 bytes are zero-filled.
// Both addresses must be 16-byte aligned.  Completion is tracked by
// cp_async_commit / cp_async_wait, or by cp_async_arrive.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

// Closes this thread's cp.async copies issued so far into one group.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// One box of `map` at coordinates (col, head, row, batch) into `dst`,
// counted against `bar`'s transaction bytes.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// The tile ring of a kernel whose consumer warps loop over tiles of kBN
// rows of two maps: K and V tiles (forward, dQ) or Q and dO tiles (dK/dV).
// Stage s holds a tile of the first map then one of the second, each
// Tile<D>::kBoxes halves of kBN rows of the span.  Barriers: `q_full` for
// the tiles loaded once, then full[s] (the producers' arrivals and TMA's
// bytes) and empty[s] (one arrival from each consumer warp) per stage.
// Iteration i of a loop uses stage i % kStages, whichever tile it loads.
template <int D, int kBN, int kStages>
struct KvRing {
  static constexpr int kHalf = kBN * Tile<D>::kSpan;  // one box
  static constexpr int kTile = kBN * D * 2;     // one tile of one map
  static constexpr int kBytes = kStages * 2 * kTile;
  static constexpr int kBarBytes = 8 * (1 + 2 * kStages);

  uint8_t* tiles;  // kBytes, 1024-aligned
  uint64_t* q_full;
  uint64_t* full;
  uint64_t* empty;

  __device__ KvRing(uint8_t* tiles_, uint8_t* bars)
      : tiles(tiles_),
        q_full(reinterpret_cast<uint64_t*>(bars)),
        full(q_full + 1),
        empty(q_full + 1 + kStages) {}

  // One thread, before the block's __syncthreads.  `producers` arrivals
  // on full[s] complete a fill: the TMA thread's, and one from each
  // thread whose cp.async copies fill the rest of the stage.
  __device__ void init(int consumer_warps, int producers = 1) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], producers);
      mbar_init(&empty[s], consumer_warps);
    }
    fence_barrier_init();
  }

  __device__ const uint8_t* k(int i) const {
    return tiles + (i % kStages) * 2 * kTile;
  }
  __device__ const uint8_t* v(int i) const { return k(i) + kTile; }

  // A producer thread: wait until iteration i's stage is free again.
  __device__ void acquire(int i) {
    if (i >= kStages) mbar_wait(&empty[i % kStages], (i / kStages - 1) & 1);
  }

  // The TMA thread: rows tile * kBN .. of (head, batch) of both maps into
  // iteration i's stage, counted on full[s] (its arrival and the bytes).
  __device__ void load(const CUtensorMap* kmap, const CUtensorMap* vmap,
                       int i, int tile, int head, int batch) {
    const int s = i % kStages;
    uint8_t* kt = tiles + s * 2 * kTile;
    mbar_expect_tx(&full[s], 2 * kTile);
    for (int c = 0; c < Tile<D>::kBoxes; ++c) {
      tma_load(kt + c * kHalf, kmap, &full[s], c * Tile<D>::kCols, head,
               tile * kBN, batch);
      tma_load(kt + kTile + c * kHalf, vmap, &full[s], c * Tile<D>::kCols,
               head, tile * kBN, batch);
    }
  }

  // The producer thread: tiles 0 .. n-1 of (head, batch), each into its
  // stage once the consumers have freed it.
  __device__ void produce(const CUtensorMap* kmap, const CUtensorMap* vmap,
                          int n, int head, int batch) {
    for (int t = 0; t < n; ++t) {
      acquire(t);
      load(kmap, vmap, t, t, head, batch);
    }
  }

  // A consumer warp: wait for iteration i's tiles, and release them when
  // done with them.
  __device__ void wait(int i) {
    mbar_wait(&full[i % kStages], (i / kStages) & 1);
  }
  __device__ void release(int i) {
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(&empty[i % kStages]);
  }
};

// ---------------------------------------------------------------------------
// device: wgmma
// ---------------------------------------------------------------------------

// A shared-memory matrix descriptor in swizzle mode `layout` (see the top
// and Tile).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (layout << 62);
}

// k step kk (16 columns) of a K-major D-wide tile whose halves have `rows`
// rows: half kk / (span / 32), 32 bytes a step inside it.  LBO is unused
// in swizzled K-major mode (1 by convention), SBO = one 8-row atom.
template <int D>
__device__ __forceinline__ uint64_t desc_k_step(const uint8_t* tile,
                                                int rows, int kk) {
  using L = Tile<D>;
  constexpr int kSteps = L::kSpan / 32;
  const uint8_t* p = tile + (kk / kSteps) * rows * L::kSpan +
                     (kk % kSteps) * 32;
  return smem_desc(p, 16, L::kAtom, L::kLayout);
}

// k step kk (16 rows) of a D-wide tile of `rows` rows read MN-major: 16
// rows of the span a step, the halves `rows` rows of the span apart (LBO).
template <int D>
__device__ __forceinline__ uint64_t desc_mn_step(const uint8_t* tile,
                                                 int rows, int kk) {
  using L = Tile<D>;
  return smem_desc(tile + kk * 16 * L::kSpan, rows * L::kSpan, L::kAtom,
                   L::kLayout);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed wgmma groups are still running (groups
// finish in the order they were committed).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void wgmma_wait_all() { wgmma_wait<0>(); }

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Two floats as the 16-bit pair of one A-fragment register (lo in the low
// half: the lower column).
template <typename T>
__device__ __forceinline__ uint32_t pack16(float lo, float hi) {
  typename Half16<T>::Pair v = Half16<T>::pair(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

#define PT_F8(d, i)                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define PT_F16(d) PT_F8(d, 0), PT_F8(d, 8)
#define PT_F32(d) PT_F8(d, 0), PT_F8(d, 8), PT_F8(d, 16), PT_F8(d, 24)
#define PT_F64(d) \
  PT_F32(d), PT_F8(d, 32), PT_F8(d, 40), PT_F8(d, 48), PT_F8(d, 56)

// The four wgmma shapes, each instantiated for .bf16 and .f16 operands
// (TY): the instruction string is a literal, so the type is pasted in.

// d[64 x 64] (+)= A[64 x 16] B[64 x 16]^T, A and B K-major in shared
// memory; the first product of a sum passes accumulate = 0.
#define PT_WGMMA_SS_N64(TY)                                               \
  asm volatile(                                                           \
      "{\n"                                                               \
      ".reg .pred p;\n"                                                   \
      "setp.ne.b32 p, %34, 0;\n"                                          \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "         \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"                    \
      "}\n"                                                               \
      : PT_F32(d)                                                         \
      : "l"(a), "l"(b), "r"(accumulate))

template <typename T>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  if constexpr (kIsF16<T>) {
    PT_WGMMA_SS_N64("f16");
  } else {
    PT_WGMMA_SS_N64("bf16");
  }
}

// d[64 x N] += A[64 x 16] B[16 x N], A in registers (the accumulator
// layout of a 64 x 16 slice, as 16-bit pairs), B MN-major in shared
// memory.
#define PT_WGMMA_RS_N64(TY)                                               \
  asm volatile(                                                           \
      "{\n"                                                               \
      ".reg .pred p;\n"                                                   \
      "setp.ne.b32 p, %37, 0;\n"                                          \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "         \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"      \
      "}\n"                                                               \
      : PT_F32(d)                                                         \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))

template <typename T>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  if constexpr (kIsF16<T>) {
    PT_WGMMA_RS_N64("f16");
  } else {
    PT_WGMMA_RS_N64("bf16");
  }
}

// d[64 x 32] += A[64 x 16] B[16 x 32] (D 32's P V, dS K, P^T dO, dS^T Q).
#define PT_WGMMA_RS_N32(TY)                                               \
  asm volatile(                                                           \
      "{\n"                                                               \
      ".reg .pred p;\n"                                                   \
      "setp.ne.b32 p, %21, 0;\n"                                          \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "         \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"                     \
      "}\n"                                                               \
      : PT_F16(d)                                                         \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))

template <typename T>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  if constexpr (kIsF16<T>) {
    PT_WGMMA_RS_N32("f16");
  } else {
    PT_WGMMA_RS_N32("bf16");
  }
}

#define PT_WGMMA_RS_N128(TY)                                              \
  asm volatile(                                                           \
      "{\n"                                                               \
      ".reg .pred p;\n"                                                   \
      "setp.ne.b32 p, %69, 0;\n"                                          \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "        \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "  \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "  \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "                \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"                           \
      "}\n"                                                               \
      : PT_F64(d)                                                         \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))

template <typename T>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  if constexpr (kIsF16<T>) {
    PT_WGMMA_RS_N128("f16");
  } else {
    PT_WGMMA_RS_N128("bf16");
  }
}

#undef PT_WGMMA_RS_N128
#undef PT_WGMMA_RS_N64
#undef PT_WGMMA_RS_N32
#undef PT_WGMMA_SS_N64
#undef PT_F64
#undef PT_F32
#undef PT_F16
#undef PT_F8

// d[64 x D] += A B for D = 32, 64 or 128 (see wgmma_rs_n64).
template <typename T, int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (D == 32) {
    wgmma_rs_n32<T>(d, a, b);
  } else if constexpr (D == 64) {
    wgmma_rs_n64<T>(d, a, b);
  } else {
    static_assert(D == 128, "head_dim 32, 64 or 128");
    wgmma_rs_n128<T>(d, a, b);
  }
}

// ---------------------------------------------------------------------------
// the frame of the tensor-core attention kernels.  The forward and dQ use
// all of it: 288 threads (ptxas gives a block registers by whole
// warpgroups, so 168 a thread), a 128-row q tile held once, 64-key K/V
// tiles streamed.  dK/dV (flash_attention_bwd.cu) turns it around: 256
// threads, two warpgroups that hold dK and dV as well as S^T and dP^T (up
// to 255 registers a thread), a 128-key K/V tile held once, 64-row Q/dO
// tiles streamed through the same KvRing by warp 0 between its stages,
// the keys as every accumulator's rows; it shares the tile ring,
// store16 and the maps.
// ---------------------------------------------------------------------------

// Element strides of one [B, heads, rows, D] operand; the last dim is
// contiguous.
struct Layout {
  long long b, h, s;
};

// Whether the fp32 kernels' 16-byte copies and stores can take a float32
// [B, heads, rows, D] operand in place: its address and every stride of a
// dim longer than 1 are multiples of 16 bytes.
inline bool aligned16(const void* p, const Layout& l, int B, int heads,
                      int rows) {
  auto ok = [](long long stride, int n) { return n == 1 || stride % 4 == 0; };
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ok(l.b, B) &&
         ok(l.h, heads) && ok(l.s, rows);
}

namespace attn {

constexpr int kBM = 128;                   // q rows per block
constexpr int kBN = 64;                    // keys per K/V tile
constexpr int kStages = 2;                 // K/V ring depth
constexpr int kConsumerWarps = 8;          // two warpgroups of 64 rows
constexpr int kThreads = 32 * kConsumerWarps + 32;  // + the producer warp
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
using Ring = KvRing<D, kBN, kStages>;

// A kBM-row tile of D 16-bit columns: Tile<D>::kBoxes halves of kBM rows
// of the span.
template <int D>
constexpr int kRowTile = kBM * D * 2;

// Warpgroup wg's 64 rows of a D-wide tile (within its first half).
template <int D>
__device__ __forceinline__ const uint8_t* wg_rows(const uint8_t* tile,
                                                  int wg) {
  return tile + wg * 64 * Tile<D>::kSpan;
}

// Where a block and one of its threads work.  Block (x = b * heads + h, y)
// takes q tile y of head h and batch b, reversed when causal so that the
// longest tiles run first, and visits nkt key tiles (causal: none past its
// last row).  A consumer thread of warpgroup wg owns rows row0 and row0 + 8
// of the warpgroup's 64 (q0 + 64 wg .. wg_last) and keys 2 * quad + {0, 1}
// of every 8-key group: the wgmma accumulator layout.
struct Frame {
  int h, b, q0, nkt, warp, lane, wg, quad, row0, wg_last;

  __device__ Frame(int num_heads, int Sk, int causal) {
    h = blockIdx.x % num_heads;
    b = blockIdx.x / num_heads;
    const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
    q0 = qt * kBM;
    nkt = (Sk + kBN - 1) / kBN;
    if (causal) nkt = min(nkt, (q0 + kBM - 1) / kBN + 1);  // later tiles dead
    warp = threadIdx.x / 32;
    lane = threadIdx.x % 32;
    wg = warp / 4;
    quad = lane % 4;
    row0 = q0 + wg * 64 + (warp % 4) * 16 + lane / 4;
    wg_last = q0 + wg * 64 + 63;
  }

  __device__ bool producer() const { return warp == kConsumerWarps; }
};

// The producer: the block's q tile of `map` (q or dO) into `dst`.
template <int D>
__device__ __forceinline__ void load_rows(uint8_t* dst, const CUtensorMap* map,
                                          uint64_t* bar, const Frame& f) {
  for (int c = 0; c < Tile<D>::kBoxes; ++c)
    tma_load(dst + c * kBM * Tile<D>::kSpan, map, bar, c * Tile<D>::kCols,
             f.h, f.q0, f.b);
}

// This thread's share of a warpgroup's 64 x D fp32 accumulator (its rows
// row0 and row0 + 8, columns 2 * quad + {0, 1} of every 8), row i times
// mul[i], as 16-bit pairs into the rows of `base` (row stride `ss`
// elements) below `rows`.
template <typename T, int D>
__device__ __forceinline__ void store16(T* base, long long ss, int rows,
                                        int row0, int quad,
                                        const float (&acc)[D / 2],
                                        const float (&mul)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= rows) continue;
    T* r = base + row * ss + 2 * quad;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<typename Half16<T>::Pair*>(r + 8 * j) =
          Half16<T>::pair(acc[4 * j + 2 * i] * mul[i],
                          acc[4 * j + 2 * i + 1] * mul[i]);
  }
}

// An output that store16 writes as 4-byte 16-bit pairs: its base and
// every stride must be even.
inline bool pairs_aligned(const void* p, const Layout& l) {
  return reinterpret_cast<uintptr_t>(p) % 4 == 0 && l.b % 2 == 0 &&
         l.h % 2 == 0 && l.s % 2 == 0;
}

// One operand that a kernel reads by TMA: base, rows, strides, and the rows
// of its box (kBM for q and dO, kBN for k and v).
struct Operand {
  const void* p;
  int rows;
  Layout l;
  int box_rows;
};

// The maps of one call over operands of element type T, in the kernel's
// order (see encode_map); 0 or the first error.
template <typename T, int N>
inline int encode_maps(TmaMaps<N>* maps, const Operand (&ops)[N], int D,
                       int heads, int B) {
  for (int i = 0; i < N; ++i) {
    const Operand& o = ops[i];
    const int err = encode_map(&maps->m[i], Half16<T>::kMapType, o.p, D,
                               heads, o.rows, B, o.l.b, o.l.h, o.l.s,
                               o.box_rows);
    if (err) return err;
  }
  return 0;
}

}  // namespace attn

}  // namespace hopper
