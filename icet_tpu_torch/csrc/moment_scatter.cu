// Moment scatter: out[vid[i], f] += feats[i, f] for N points and 16
// feature columns, the accumulator of moment_method="pallas".  Ids outside
// [0, rows) are dropped.
//
// Replaces the TPU kernel icet_tpu/ops/pallas_moments.py::_moment_kernel
// (wrapper pallas_moment_sums, pallas_call at pallas_moments.py:86), which
// built a (block, V) one-hot matrix in VMEM and contracted it with the
// feature block on the MXU; an id that matches no one-hot column (negative,
// or past the table) adds nothing, and so it is dropped here.  On Hopper the
// scatter is done directly with atomics; there is no one-hot.
//
// Bound on the card: the call must read the ids and the features (68 B a
// point, 4.46 MB at N = 65,536) and write the (V+1, 16) table (115 KB at
// V = 1,800): 1.36 us at 3.35 TB/s.  One add a feature element, so bytes
// bound it.  At this size the call is set by latency: the loads in flight,
// the adds that collide on one row, and the sum across blocks.
//
// Design, one cooperative launch a call, no memset:
// - Four lanes a point, each loading one 16-byte quarter of its 64-byte
//   row (a warp reads 8 consecutive rows, 512 contiguous bytes), and the
//   point's id; at most one block of 1,024 threads an SM, each block a
//   contiguous slice of the points, the next round's loads issued before
//   this round's adds.
// - Warp aggregation: the lanes of one column quarter that share an id
//   form a group (__match_any_sync); the group's lowest lane sums the
//   group's float4s (a shuffle tree when the whole warp shares one id,
//   the common case of a beam-major scan, else ordered shuffles) and alone
//   adds the sum, skipping an all-zero one (a non-member's features).
// - Tables of up to 3,631 rows (the drive's 1,801): the whole table in the
//   block's shared memory, summed with shared atomics; then, after a grid
//   barrier, every nonzero float4 of it is added to the output with one
//   16-byte global atomic (sm_90).  The output is zeroed by the grid before
//   the barrier.  The barrier is cooperative_groups' grid sync: the launch
//   is cooperative, so all blocks are resident.
// - Larger tables (fixed radial mode's 90,001 rows): the output is zeroed,
//   then after the grid barrier the groups' sums go straight to it with
//   16-byte global atomics.
// The cross-block sum is in hardware order, not a fixed one: within a block
// the shared atomics of different warps commit in hardware order anyway, so
// a fixed-order combine would not make the sums reproducible, and the
// atomics need no round trip after the barrier.  The float sums can differ
// in their last bits from run to run; a count column of ones is exact.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kQuarters = 4;                          // float4s of a 16-float row
constexpr int kPointsPerRound = kThreads / kQuarters;  // 256
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 shfl4(float4 v, int src) {
  return make_float4(__shfl_sync(kFull, v.x, src), __shfl_sync(kFull, v.y, src),
                     __shfl_sync(kFull, v.z, src), __shfl_sync(kFull, v.w, src));
}

__device__ __forceinline__ float4 shfl_xor4(float4 v, int mask) {
  return make_float4(__shfl_xor_sync(kFull, v.x, mask), __shfl_xor_sync(kFull, v.y, mask),
                     __shfl_xor_sync(kFull, v.z, mask), __shfl_xor_sync(kFull, v.w, mask));
}

__device__ __forceinline__ bool nonzero(float4 v) {
  return v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f;
}

// Sums into f, on the lowest lane of each group of lanes with the same key
// and the same column quarter, the group's float4s; returns true on that
// lane when its key is a row (>= 0).  Every lane of the warp calls it.
__device__ __forceinline__ bool aggregate(int key, float4& f) {
  const int lane = threadIdx.x % 32;
  const unsigned same = __match_any_sync(kFull, key);
  if (same == kFull) {  // one key in the whole warp: a tree over the 8 points
    f = add4(f, shfl_xor4(f, 4));
    f = add4(f, shfl_xor4(f, 8));
    f = add4(f, shfl_xor4(f, 16));
    return key >= 0 && lane < kQuarters;
  }
  const unsigned group = same & (0x11111111u << (lane % kQuarters));
  const bool leader = key >= 0 && lane == __ffs(group) - 1;
  unsigned rest = leader ? group & (group - 1u) : 0u;  // the group less its leader
  const float4 mine = f;
  while (__any_sync(kFull, rest != 0u)) {
    const float4 v = shfl4(mine, rest ? __ffs(rest) - 1 : lane);
    if (rest) f = add4(f, v);
    rest &= rest - 1u;
  }
  return leader;
}

// The id (-1 when outside [0, rows) or past the slice) and the features'
// quarter of point i.
__device__ __forceinline__ void load_point(const int* __restrict__ vid,
                                           const float4* __restrict__ feats, int i, int p1,
                                           int rows, int& key, float4& f) {
  key = -1;
  f = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (i < p1) {
    const int v = __ldg(vid + i);
    f = __ldg(feats + (size_t)i * kQuarters + threadIdx.x % kQuarters);
    if ((unsigned)v < (unsigned)rows) key = v;
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads, 1)
scatter_kernel(const int* __restrict__ vid, const float4* __restrict__ feats, int n,
               int per_block, int rows, float4* __restrict__ out) {
  extern __shared__ float4 table[];  // rows x 4 float4s (shared-table variant)
  const int quarter = threadIdx.x % kQuarters;
  const int p0 = blockIdx.x * per_block;
  const int p1 = min(n, p0 + per_block);
  // The first round's point, loaded before the zeroing so the load overlaps it.
  int next_key;
  float4 next_f;
  load_point(vid, feats, p0 + threadIdx.x / kQuarters, p1, rows, next_key, next_f);

  const int cells = rows * kQuarters;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int k = blockIdx.x * kThreads + threadIdx.x; k < cells; k += gridDim.x * kThreads)
    out[k] = zero;
  if (kShared) {
    for (int k = threadIdx.x; k < cells; k += kThreads) table[k] = zero;
    __syncthreads();
  } else {
    cooperative_groups::this_grid().sync();  // the output is zero everywhere
  }

  // Every thread of the block runs the same number of rounds, so each
  // round's warp-wide collectives see all 32 lanes.
  for (int base = p0; base < p1; base += kPointsPerRound) {
    int key = next_key;
    float4 f = next_f;
    load_point(vid, feats, base + kPointsPerRound + threadIdx.x / kQuarters, p1, rows,
               next_key, next_f);
    if (aggregate(key, f) && nonzero(f)) {
      if (kShared) {
        float* cell = reinterpret_cast<float*>(table + key * kQuarters + quarter);
        atomicAdd(cell + 0, f.x);
        atomicAdd(cell + 1, f.y);
        atomicAdd(cell + 2, f.z);
        atomicAdd(cell + 3, f.w);
      } else {
        atomicAdd(out + (size_t)key * kQuarters + quarter, f);
      }
    }
  }

  if (kShared) {
    // Grid barrier: the output is zero everywhere and this block's table is
    // complete; then its nonzero float4s are added to the output.
    cooperative_groups::this_grid().sync();
    for (int k = threadIdx.x; k < cells; k += kThreads) {
      const float4 v = table[k];
      if (nonzero(v)) atomicAdd(out + k, v);
    }
  }
}

// Above 48 KB of dynamic shared memory needs an opt-in, which is kept per
// device: set it once a device and size (the current device may differ
// from one call to the next).
cudaError_t opt_in_shared(int smem) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  static int opted_in[64] = {};
  if (device < 64 && opted_in[device] >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(scatter_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && device < 64) opted_in[device] = smem;
  return err;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`: `blocks` blocks of `per_block` points
// each, the table in shared memory when `shared` is nonzero.  vid (n,)
// int32, feats (n, 16) float32 (16-byte aligned), out (rows, 16) float32,
// all device arrays.  A cooperative launch: it fails, rather than waits, if
// the blocks cannot all be resident.  Returns cudaGetLastError() (0 = ok).
int icet_moment_scatter(const void* vid, const void* feats, int n, int rows, void* out,
                        int blocks, int per_block, int shared, void* stream) {
  const int* p_vid = static_cast<const int*>(vid);
  const float4* p_feats = static_cast<const float4*>(feats);
  float4* p_out = static_cast<float4*>(out);
  void* args[] = {&p_vid, &p_feats, &n, &per_block, &rows, &p_out};
  const int smem = shared ? rows * kQuarters * (int)sizeof(float4) : 0;
  cudaError_t err = cudaSuccess;
  if (shared) {
    err = opt_in_shared(smem);
    if (err != cudaSuccess) return (int)err;
  }
  const void* kernel = shared ? reinterpret_cast<const void*>(scatter_kernel<true>)
                              : reinterpret_cast<const void*>(scatter_kernel<false>);
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* icet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
