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
// The order is fixed per row: one block of 256 threads a row; thread t
// sums x[j]^2 for j = t, t + 256, ... in increasing j (one __fmaf_rn chain
// from +0); each warp folds its lanes by one fixed butterfly of shuffles,
// and warp 0 folds the 8 warp sums the same way.  Then mean = sum / n,
// d = sqrt(mean + eps), out = x / d * scale, each rounded once
// (__fdiv_rn, __fsqrt_rn, __fmul_rn).  Bound by bytes: x read twice (the
// second time from L1 / L2), scale once, out written once, 8 bytes an
// element at the HBM peak.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
rms_norm_rows_kernel(const float* __restrict__ x,
                     const float* __restrict__ scale,
                     float* __restrict__ out, int n, float eps) {
  __shared__ float warp_sums[THREADS / 32];
  __shared__ float denom;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float* xr = x + blockIdx.x * (long long)n;
  float* orow = out + blockIdx.x * (long long)n;
  float s = 0.f;
  for (int j = t; j < n; j += THREADS) s = __fmaf_rn(xr[j], xr[j], s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  if (lane == 0) warp_sums[warp] = s;
  __syncthreads();
  if (warp == 0) {
    float w = lane < THREADS / 32 ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int off = THREADS / 64; off > 0; off >>= 1)
      w = __fadd_rn(w, __shfl_xor_sync(0xffffffffu, w, off));
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

}  // namespace

extern "C" {

// x and out [rows, n] float32, contiguous; scale float32 [n] or null.
// Returns the cudaError_t of the launch (0 = success).
int pt_rms_norm_f32(const void* x, const void* scale, void* out,
                    long long rows, int n, float eps, void* stream) {
  if (rows < 1 || n < 1 || rows > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  rms_norm_rows_kernel<<<(unsigned)rows, THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(scale),
      static_cast<float*>(out), n, eps);
  return (int)cudaGetLastError();
}

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
