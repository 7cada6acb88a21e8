// Moment scatter: out[vid[i], f] += feats[i, f] for N points and 16
// feature columns, the accumulator of moment_method="pallas".
//
// Replaces the TPU kernel icet_tpu/ops/pallas_moments.py::_moment_kernel
// (wrapper pallas_moment_sums, pallas_call at pallas_moments.py:86), which
// built a (block, V) one-hot matrix in VMEM and contracted it with the
// feature block on the MXU.  On Hopper the scatter is done directly with
// atomics; there is no one-hot.
//
// Bound on the card: the call must read the ids and the features (68 B a
// point, 4.46 MB at N = 65,536) and write the (V+1, 16) table (115 KB at
// V = 1,800): 1.36 us at 3.35 TB/s.  One add a feature element, so bytes
// bound it.
//
// Design: one thread per (point, column) element, so the 16 lanes that
// share a point add into 16 different columns of its row and a warp's
// atomics land on at most two rows.  Reads of the features are coalesced.
//   * shared branch (table of (V+1) x 16 floats fits one block's shared
//     memory: V+1 <= 3,631): each block takes a contiguous slice of the
//     elements, finds the band of rows its nonzero elements go to, sums
//     them into a shared copy of that band with shared-memory atomics, then
//     adds the band's nonzero entries into the output with global atomics.
//     A beam-major scan sends a slice to a narrow band of voxels (about one
//     ring of 75 azimuth bins at 1,024 points a slice), and the moment
//     features of non-members are zero, so the band stays small.
//   * global branch (larger tables, e.g. fixed radial mode's 90,001 rows):
//     grid-stride over the elements, global atomics straight into the
//     output.
// The output is zeroed on the stream first.  Float atomics commit in
// hardware order, so the feature sums can differ in their last bits from
// run to run; a count column of ones is exact.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 16;

__global__ void __launch_bounds__(kThreads)
scatter_shared(const int* __restrict__ vid, const float* __restrict__ feats,
               long long elements, int rows, long long per_block,
               float* __restrict__ out) {
  extern __shared__ float band[];
  __shared__ int span[2];
  if (threadIdx.x == 0) {
    span[0] = rows;
    span[1] = -1;
  }
  __syncthreads();

  // The band [lo, hi] of rows this block's slice adds nonzero values to
  // (adding zero changes no sum, so zero elements are skipped throughout).
  const long long begin = (long long)blockIdx.x * per_block;
  const long long end = min(begin + per_block, elements);
  int lo = rows, hi = -1;
  for (long long e = begin + threadIdx.x; e < end; e += blockDim.x) {
    if (feats[e] != 0.0f) {
      const int v = vid[e / kCols];
      lo = min(lo, v);
      hi = max(hi, v);
    }
  }
  atomicMin(span, lo);
  atomicMax(span + 1, hi);
  __syncthreads();
  lo = span[0];
  hi = span[1];
  if (hi < lo) return;  // the whole block sees the same span
  const int cells = (hi - lo + 1) * kCols;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) band[i] = 0.0f;
  __syncthreads();

  for (long long e = begin + threadIdx.x; e < end; e += blockDim.x) {
    const float s = feats[e];
    if (s != 0.0f) atomicAdd(band + (vid[e / kCols] - lo) * kCols + (int)(e % kCols), s);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const float s = band[i];
    if (s != 0.0f) atomicAdd(out + (long long)lo * kCols + i, s);
  }
}

__global__ void __launch_bounds__(kThreads)
scatter_global(const int* __restrict__ vid, const float* __restrict__ feats,
               long long elements, float* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < elements; e += stride) {
    const float s = feats[e];
    if (s != 0.0f) atomicAdd(out + (long long)vid[e / kCols] * kCols + e % kCols, s);
  }
}

}  // namespace

extern "C" {

// Zeroes out and launches one branch on `stream`; returns
// cudaGetLastError() (0 = ok).  vid (n,) int32 in [0, rows), feats (n, 16)
// float32, out (rows, 16) float32, all device arrays.
int icet_moment_scatter(const void* vid, const void* feats, int n, int rows,
                        void* out, int blocks, int shared, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)rows * kCols * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  const long long elements = (long long)n * kCols;
  if (elements == 0) return (int)cudaGetLastError();
  if (shared) {
    const int smem = rows * kCols * (int)sizeof(float);
    // Above 48 KB of dynamic shared memory needs an opt-in, kept per
    // device: set it on every call (the current device may differ).
    err = cudaFuncSetAttribute(scatter_shared,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const long long per_block = (elements + blocks - 1) / blocks;
    scatter_shared<<<blocks, kThreads, smem, s>>>(
        static_cast<const int*>(vid), static_cast<const float*>(feats),
        elements, rows, per_block, static_cast<float*>(out));
  } else {
    scatter_global<<<blocks, kThreads, 0, s>>>(
        static_cast<const int*>(vid), static_cast<const float*>(feats),
        elements, static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}

const char* icet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
