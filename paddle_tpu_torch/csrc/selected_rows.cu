// SelectedRows MergeAdd for Hopper (sm_90a): the segment sum of a sparse
// gradient's values over its stably sorted rows, in one fixed order.
//
// A SelectedRows gradient is K (row, value-row) pairs of a [height, C]
// table, rows repeated as often as an id was looked up.  MergeAdd gives
// each unique row the sum of its value-rows.  It replaces no TPU kernel:
// the JAX package's merge (paddle_tpu/framework/selected_rows.py) is a
// sort and a scatter-add that XLA emits.  PyTorch's scatter-adds
// (index_add_, scatter_add_, index_put_ with accumulate) add repeated rows
// in an order that can change from run to run on the card; this kernel
// adds them in one order, so a sparse step gives the same bits every run.
//
// The wrapper (ops/cuda/selected_rows.py) sorts the rows stably
// (torch.sort: sorted rows and the permutation `order`) and counts the
// segment starts (`seg`, the inclusive prefix count of positions whose row
// differs from the one before).  One warp a sorted position i:
//   * a segment start sums value-rows order[i], order[i + 1], ... of its
//     segment one after another from +0 (__fadd_rn), lane c holding
//     column c (column groups of 32 for C > 32), and writes the unique
//     row and the sums to slot seg[i] - 1: unique rows packed at the
//     front in ascending order, as the JAX package's merge packs them;
//   * any other position fills one slot of the tail, U + i - seg[i]
//     (U = seg[K - 1], the unique rows), with the sentinel row `height`
//     and zeros, so every one of the K slots is written exactly once.
// The segment's positions come 32 at a time: each lane loads one entry of
// `order` and of the sorted rows, a ballot finds how many still belong to
// the segment, and the 32 value loads a column takes are issued before
// its adds.  Bound by bytes: the rows (8 bytes) and values (4 C bytes)
// read once and the merged rows and values written once; a hot row looked
// up thousands of times is one warp's chain of adds, which the card runs
// at the latency of its loads (PERF.md).
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;  // warps a block: 8 sorted positions

__global__ void __launch_bounds__(WARPS * 32)
merge_rows_kernel(const long long* __restrict__ sorted_rows,
                  const long long* __restrict__ order,
                  const long long* __restrict__ seg,
                  const float* __restrict__ values,
                  long long* __restrict__ out_rows,
                  float* __restrict__ out_values, long long k, int cols,
                  long long height) {
  const int lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (i >= k) return;
  const long long row = sorted_rows[i];
  const long long s = seg[i];  // segment starts in [0, i]
  if (i > 0 && sorted_rows[i - 1] == row) {
    const long long slot = seg[k - 1] + i - s;
    if (lane == 0) out_rows[slot] = height;
    for (int c = lane; c < cols; c += 32) out_values[slot * cols + c] = 0.f;
    return;
  }
  const long long slot = s - 1;
  if (lane == 0) out_rows[slot] = row;
  for (int c0 = 0; c0 < cols; c0 += 32) {
    const int c = c0 + lane;
    float acc = 0.f;
    for (long long j0 = i;; j0 += 32) {
      const long long j = j0 + lane;
      const bool in_seg = j < k && sorted_rows[j] == row;
      const long long o = in_seg ? order[j] : 0;
      // sorted: the segment's positions in this chunk are a prefix of it
      const int n = __popc(__ballot_sync(0xffffffffu, in_seg));
      float v[32];
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        const long long ot = __shfl_sync(0xffffffffu, o, t);
        v[t] = (t < n && c < cols) ? __ldg(values + ot * cols + c) : 0.f;
      }
#pragma unroll
      for (int t = 0; t < 32; ++t)
        if (t < n) acc = __fadd_rn(acc, v[t]);
      if (n < 32) break;
    }
    if (c < cols) out_values[slot * cols + c] = acc;
  }
}

}  // namespace

extern "C" {

// sorted_rows, order, seg int64 [k]; values float32 [k, cols] in the
// unsorted order, contiguous; out_rows int64 [k], out_values float32
// [k, cols].  Returns the cudaError_t of the launch (0 = success).
int pt_merge_rows_f32(const void* sorted_rows, const void* order,
                      const void* seg, const void* values, void* out_rows,
                      void* out_values, long long k, int cols,
                      long long height, void* stream) {
  if (k < 1 || cols < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (k + WARPS - 1) / WARPS;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  merge_rows_kernel<<<(unsigned)blocks, WARPS * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(sorted_rows),
      static_cast<const long long*>(order),
      static_cast<const long long*>(seg), static_cast<const float*>(values),
      static_cast<long long*>(out_rows), static_cast<float*>(out_values), k,
      cols, height);
  return (int)cudaGetLastError();
}

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
