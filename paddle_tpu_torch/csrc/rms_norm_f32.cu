// fp32 RMSNorm for Hopper (sm_90a) whose rows do not depend on how many
// rows there are.
//
// out[r, j] = x[r, j] / sqrt(sum_j x[r, j]^2 / n + eps) * scale[j] over the
// last dim of x [rows, n].  It replaces no TPU kernel: the JAX package's
// `rms_norm` (paddle_tpu/ops/nn_ops.py) is XLA's.  The port runs every
// float32 RMSNorm that no grad op differentiates through it on the card
// (ops/cuda/rms_norm.py): a library reduction splits a row's sum by the
// number of rows, so a decode step's 4 rows came out in another order
// than the same rows of the uncached forward's 256 (2.4e-7 apart at a
// Llama-2-7B layer, probe_decode_rows.py), and cached decode stopped being
// bit-equal to the uncached forward.
//
// The order is fixed per row: 256 threads a row; thread t sums x[j]^2 for
// j = t, t + 256, ... in increasing j (one __fmaf_rn chain from +0); each
// warp folds its lanes by one fixed butterfly of shuffles, and the 8 warp
// sums are folded the same way (offsets 4, 2, 1 over lanes 0-7).  Then
// mean = sum / n, d = sqrt(mean + eps), out = x / d * scale, each rounded
// once (__fdiv_rn, __fsqrt_rn, __fmul_rn).  Bound by bytes: x read once,
// scale once, out written once, 8 bytes an element at the HBM peak.
//
// Two launches over that order.  Rows up to 256 V wide (V <= 32: 8192
// floats) load the row and its scale once into registers, 2 V values a
// thread all in flight at once, and run both passes from there; every warp folds the 8
// warp sums itself (the same fold, the same bits as lane 0 of warp 0), so
// a block meets at one barrier.  Wider rows loop over the row twice (the second time from L1 /
// L2) with one fold in warp 0.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_V = 32;

// the butterfly fold of a warp's lanes (every lane ends with the same bits)
__device__ __forceinline__ float warp_fold(float s, int top) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    if (off <= top) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  return s;
}

template <int V>
__global__ void __launch_bounds__(THREADS)
rms_norm_rows_kernel(const float* __restrict__ x,
                     const float* __restrict__ scale,
                     float* __restrict__ out, int n, float eps) {
  __shared__ float warp_sums[THREADS / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float* xr = x + blockIdx.x * (long long)n;
  float* orow = out + blockIdx.x * (long long)n;
  float v[V], sc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int j = t + i * THREADS;
    v[i] = j < n ? __ldg(xr + j) : 0.f;
    sc[i] = j < n && scale != nullptr ? __ldg(scale + j) : 1.f;
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i)
    if (t + i * THREADS < n) s = __fmaf_rn(v[i], v[i], s);
  s = warp_fold(s, 16);
  if (lane == 0) warp_sums[warp] = s;
  __syncthreads();
  // lanes 0-7 fold the 8 warp sums; every lane takes lane 0's total
  const float w = __shfl_sync(
      0xffffffffu,
      warp_fold(lane < THREADS / 32 ? warp_sums[lane] : 0.f, THREADS / 64),
      0);
  const float d = __fsqrt_rn(__fadd_rn(__fdiv_rn(w, (float)n), eps));
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int j = t + i * THREADS;
    if (j < n) {
      const float y = __fdiv_rn(v[i], d);
      orow[j] = scale != nullptr ? __fmul_rn(y, sc[i]) : y;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
rms_norm_rows_loop_kernel(const float* __restrict__ x,
                          const float* __restrict__ scale,
                          float* __restrict__ out, int n, float eps) {
  __shared__ float warp_sums[THREADS / 32];
  __shared__ float denom;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float* xr = x + blockIdx.x * (long long)n;
  float* orow = out + blockIdx.x * (long long)n;
  float s = 0.f;
  for (int j = t; j < n; j += THREADS) s = __fmaf_rn(xr[j], xr[j], s);
  s = warp_fold(s, 16);
  if (lane == 0) warp_sums[warp] = s;
  __syncthreads();
  if (warp == 0) {
    const float w = warp_fold(lane < THREADS / 32 ? warp_sums[lane] : 0.f,
                              THREADS / 64);
    if (lane == 0)
      denom = __fsqrt_rn(__fadd_rn(__fdiv_rn(w, (float)n), eps));
  }
  __syncthreads();
  const float d = denom;
  for (int j = t; j < n; j += THREADS) {
    const float y = __fdiv_rn(xr[j], d);
    orow[j] = scale != nullptr ? __fmul_rn(y, scale[j]) : y;
  }
}

template <int V>
void launch_rows(unsigned rows, const float* x, const float* scale,
                 float* out, int n, float eps, cudaStream_t st) {
  rms_norm_rows_kernel<V><<<rows, THREADS, 0, st>>>(x, scale, out, n, eps);
}

}  // namespace

extern "C" {

// x and out [rows, n] float32, contiguous; scale float32 [n] or null.
// Returns the cudaError_t of the launch (0 = success).
int pt_rms_norm_f32(const void* x, const void* scale, void* out,
                    long long rows, int n, float eps, void* stream) {
  if (rows < 1 || n < 1 || rows > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const unsigned r = (unsigned)rows;
  const float* xf = static_cast<const float*>(x);
  const float* sf = static_cast<const float*>(scale);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int v = (n + THREADS - 1) / THREADS;  // values a thread
  if (v <= 1) launch_rows<1>(r, xf, sf, of, n, eps, st);
  else if (v <= 2) launch_rows<2>(r, xf, sf, of, n, eps, st);
  else if (v <= 4) launch_rows<4>(r, xf, sf, of, n, eps, st);
  else if (v <= 8) launch_rows<8>(r, xf, sf, of, n, eps, st);
  else if (v <= 16) launch_rows<16>(r, xf, sf, of, n, eps, st);
  else if (v <= MAX_V) launch_rows<MAX_V>(r, xf, sf, of, n, eps, st);
  else
    rms_norm_rows_loop_kernel<<<r, THREADS, 0, st>>>(xf, sf, of, n, eps);
  return (int)cudaGetLastError();
}

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
