// Fused scan transform + spherical re-bin + radial-bounds membership +
// anchored moment sums: the one per-point pass of every Gauss-Newton
// iteration and of every voxel-model fit.
//
// Replaces the TPU kernel icet_tpu/ops/pallas_fused.py::_kernel (wrapper
// fused_moment_sums, pallas_call at pallas_fused.py:411), and with it the
// XLA stand-in that ran in the kernel's place on the TPU
// (icet_tpu/ops/windowed_moments.py plus its spill pass and segsum
// fallback, icet_tpu/solver.py:377-430).  It computes what
// icet_tpu/solver.py::_jnp_sums computes:
//   p' = euler_R(-X[3:6]) p + X[:3]
//   (r, theta, phi) of p' (NaN/inf -> 0; r == 0 -> (0, 0, 0)), exact
//   atan2f/acosf;  vid as grid.voxel_ids (adaptive radial mode)
//   member = |p| >= min_range  (gate on the RAW point)
//            && vid < V && bounds[vid, 0] <= r' <= bounds[vid, 1]
//   g = p' - anchors[vid] for members only (a select, never a multiply)
//   sums[vid] += [1, g, gx^2, gy^2, gz^2, gx gy, gx gz, gy gz]
//
// Bound on the card: the call must read the scan once (12 B a point,
// 0.79 MB at N = 65,536), the bounds and anchors (20 B a voxel row) and
// write the (V+1, 16) sums, about 0.9 MB in all: about 0.27 us at
// 3.35 TB/s.  The arithmetic (a few dozen flops and three transcendentals
// a point) is far below the card's rate.  At this size the kernel is set
// by latency: one launch, one pass over the points, and the cross-block
// sum, and by contention: a beam-major scan sends runs of neighbouring
// points into one voxel, so the lanes of a warp add into one row.
//
// Design, one launch a call:
// - One block an SM at most (the wrapper sizes the grid), each walking a
//   contiguous slice of the points, so a block of a beam-major scan sees
//   a few beam rings and touches ~100 of the V+1 rows.  The whole
//   (V+1) x 10 table lives in the block's dynamic shared memory (72,040 B
//   at V = 1,800): no window, no spill, any scan order.
// - Warp aggregation: the lanes that share a voxel id form a group
//   (__match_any_sync); the group's lowest lane sums the group's features
//   with shuffles in ascending lane order and alone issues the row's ten
//   shared atomicAdds and sets the row's bit in a shared bitmap.
// - The block writes only the rows it touched, compacted in vid order
//   (slot = the bitmap's prefix count), with its bitmap and the bitmap's
//   per-word prefix counts: ~4 KB a block on a beam-major scan instead of
//   the whole table.
// - The partials are summed by the whole grid after a grid barrier
//   (cooperative_groups' grid sync: the launch is cooperative, so all
//   blocks are resident).  Block b writes bitmap words b, b + G, ... of the output; its
//   warps split the source blocks into contiguous runs, a lane (a row)
//   sums its run in ascending block order, loading up to 8 partial rows
//   at once, and the runs' sums are added in warp order.  The cross-block
//   order is fixed; within a block, the atomics of different groups commit
//   in hardware order, so the float sums can differ in their last bits
//   from run to run (the count column is exact).
//
// Built without FMA contraction (-fmad=false, see icet_tpu_torch/_build.py)
// and with the operations in the order of the plain PyTorch version
// (icet_tpu_torch/ops/geometry.py), so both compute the same p', r, theta
// and phi for the same point.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kFeatures = 10;   // accumulated columns
constexpr int kOutCols = 16;    // the JAX package's padded layout
constexpr int kGather = 8;      // blocks whose partial rows a lane loads at once
constexpr unsigned kFull = 0xffffffffu;
constexpr float kTwoPi = 6.28318530717958647692f;

__global__ void __launch_bounds__(kThreads)
fused_moments_kernel(const float* __restrict__ pts, int n, int per_block,
                     const float* __restrict__ X,
                     const float* __restrict__ bounds,
                     const float* __restrict__ anchors,
                     int n_voxels, int n_theta, int n_phi,
                     float phi_min, float phi_span, float min_range,
                     int cap, float* __restrict__ prow,
                     uint32_t* __restrict__ pbits, int* __restrict__ ppre,
                     float* __restrict__ out) {
  extern __shared__ float table[];
  const int rows = n_voxels + 1;
  const int words = (rows + 31) / 32;
  uint32_t* bits = reinterpret_cast<uint32_t*>(table + rows * kFeatures);
  int* pre = reinterpret_cast<int*>(bits + words);

  const int lane = threadIdx.x % 32;
  const int p0 = blockIdx.x * per_block;
  const int p1 = min(n, p0 + per_block);
  // The thread's point of the first round, loaded before the table is
  // zeroed so the load overlaps it.
  float nx = 0.0f, ny = 0.0f, nz = 0.0f;
  if (p0 + (int)threadIdx.x < p1) {
    const int i = p0 + threadIdx.x;
    nx = pts[3 * i];
    ny = pts[3 * i + 1];
    nz = pts[3 * i + 2];
  }
  {
    // Zero the table and the bitmap, 16 bytes a store where it can.
    const int cells = rows * kFeatures + words;
    float4* t4 = reinterpret_cast<float4*>(table);
    for (int i = threadIdx.x; i < cells / 4; i += blockDim.x)
      t4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int i = cells / 4 * 4 + threadIdx.x; i < cells; i += blockDim.x) table[i] = 0.0f;
  }

  // euler_R(-X[3:6]), entry by entry as geometry.euler_R forms it.
  const float cf = cosf(-X[3]), sf = sinf(-X[3]);
  const float ct = cosf(-X[4]), st = sinf(-X[4]);
  const float cp = cosf(-X[5]), sp = sinf(-X[5]);
  const float r00 = ct * cp, r01 = sp * cf + sf * st * cp,
              r02 = sf * sp - st * cf * cp;
  const float r10 = -sp * ct, r11 = cf * cp - sf * st * sp,
              r12 = sf * cp + st * sp * cf;
  const float r20 = st, r21 = -sf * ct, r22 = cf * ct;
  const float tx = X[0], ty = X[1], tz = X[2];
  __syncthreads();

  // Every thread of the block runs the same number of rounds, so each
  // round's warp-wide collectives see all 32 lanes.
  for (int base = p0; base < p1; base += blockDim.x) {
    const int i = base + threadIdx.x;
    bool member = false;
    int vid = -1;
    float x = 0.0f, y = 0.0f, z = 0.0f, ax = 0.0f, ay = 0.0f, az = 0.0f;
    const float x0 = nx, y0 = ny, z0 = nz;
    if (i + (int)blockDim.x < p1) {  // the next round's point
      nx = pts[3 * (i + blockDim.x)];
      ny = pts[3 * (i + blockDim.x) + 1];
      nz = pts[3 * (i + blockDim.x) + 2];
    }
    if (i < p1) {
      // NaN rows fail this comparison and are never members.
      if (sqrtf(x0 * x0 + y0 * y0 + z0 * z0) >= min_range) {
        x = x0 * r00 + y0 * r01 + z0 * r02 + tx;
        y = x0 * r10 + y0 * r11 + z0 * r12 + ty;
        z = x0 * r20 + y0 * r21 + z0 * r22 + tz;
        const float xs = isfinite(x) ? x : 0.0f;
        const float ys = isfinite(y) ? y : 0.0f;
        const float zs = isfinite(z) ? z : 0.0f;
        const float r = sqrtf(xs * xs + ys * ys + zs * zs);
        if (r >= min_range) {
          float theta = 0.0f, phi = 0.0f;
          if (r > 0.0f) {
            theta = atan2f(ys, xs);
            if (theta < 0.0f) theta = theta + kTwoPi;
            phi = acosf(fminf(fmaxf(zs / r, -1.0f), 1.0f));
          }
          int itheta = (int)(theta / kTwoPi * (float)n_theta);
          itheta = min(max(itheta, 0), n_theta - 1);
          const int iphi = (int)floorf((phi - phi_min) / phi_span * (float)n_phi);
          if (iphi >= 0 && iphi < n_phi) {
            const int v = iphi * n_theta + itheta;
            // The anchor is loaded beside the bounds, not after the test.
            const float lo = bounds[2 * v], hi = bounds[2 * v + 1];
            ax = anchors[3 * v];
            ay = anchors[3 * v + 1];
            az = anchors[3 * v + 2];
            if (r >= lo && r <= hi) {
              member = true;
              vid = v;
            }
          }
        }
      }
    }
    float f[kFeatures] = {};
    if (member) {
      const float gx = x - ax;
      const float gy = y - ay;
      const float gz = z - az;
      f[0] = 1.0f; f[1] = gx; f[2] = gy; f[3] = gz;
      f[4] = gx * gx; f[5] = gy * gy; f[6] = gz * gz;
      f[7] = gx * gy; f[8] = gx * gz; f[9] = gy * gz;
    }
    // Warp aggregation: non-members share the key -1 and add nothing.
    const unsigned group = __match_any_sync(kFull, vid);
    const bool leader = member && lane == __ffs(group) - 1;
    unsigned rest = leader ? group & (group - 1) : 0u;  // the group less its leader
    float s[kFeatures];
#pragma unroll
    for (int k = 0; k < kFeatures; ++k) s[k] = f[k];
    while (__any_sync(kFull, rest != 0u)) {
      const int src = rest ? __ffs(rest) - 1 : lane;
#pragma unroll
      for (int k = 0; k < kFeatures; ++k) {
        const float v = __shfl_sync(kFull, f[k], src);
        if (rest) s[k] += v;
      }
      rest &= rest - 1u;
    }
    if (leader) {
      float* row = table + vid * kFeatures;
#pragma unroll
      for (int k = 0; k < kFeatures; ++k) atomicAdd(row + k, s[k]);
      atomicOr(bits + vid / 32, 1u << (vid % 32));
    }
  }
  __syncthreads();

  // Exclusive prefix counts of the bitmap's words (warp 0), then the
  // block's compacted partial: its bitmap, the prefixes and, for each set
  // bit in vid order, its row of ten sums.
  if (threadIdx.x < 32) {
    const int per = (words + 31) / 32;
    const int w0 = min(words, lane * per), w1 = min(words, w0 + per);
    int c = 0;
    for (int w = w0; w < w1; ++w) c += __popc(bits[w]);
    int incl = c;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    int run = incl - c;
    for (int w = w0; w < w1; ++w) {
      pre[w] = run;
      run += __popc(bits[w]);
    }
  }
  __syncthreads();
  uint32_t* my_bits = pbits + (size_t)blockIdx.x * words;
  int* my_pre = ppre + (size_t)blockIdx.x * words;
  float* my_rows = prow + (size_t)blockIdx.x * cap * kFeatures;
  for (int w = threadIdx.x; w < words; w += blockDim.x) {
    my_bits[w] = bits[w];
    my_pre[w] = pre[w];
  }
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const uint32_t word = bits[r / 32];
    if ((word >> (r % 32)) & 1u) {
      const int slot = pre[r / 32] + __popc(word & ((1u << (r % 32)) - 1u));
#pragma unroll
      for (int k = 0; k < kFeatures; ++k)
        my_rows[slot * kFeatures + k] = table[r * kFeatures + k];
    }
  }

  // Grid barrier: every block's partial is written and visible.
  cooperative_groups::this_grid().sync();

  // The combine, spread over the grid: block b writes bitmap words b,
  // b + G, ... of the output.  Its warps split the source blocks into
  // contiguous runs; a lane (a row) sums its run's partial rows in
  // ascending block order, loading up to kGather of them at once, and
  // warp 0 adds the runs' sums in warp order: a fixed order of addition.
  const int G = gridDim.x;
  const int warp = threadIdx.x / 32, warps = blockDim.x / 32;
  float* runs = table;  // (warps, 32, kFeatures)
  const int b_lo = G * warp / warps, b_hi = G * (warp + 1) / warps;
  for (int w = blockIdx.x; w < words; w += G) {
    float acc[kFeatures] = {};
    for (int b0 = b_lo; b0 < b_hi; b0 += 32) {
      const int b = b0 + lane;
      const uint32_t word = b < b_hi ? __ldcg(pbits + (size_t)b * words + w) : 0u;
      const int wpre = b < b_hi ? __ldcg(ppre + (size_t)b * words + w) : 0;
      unsigned todo = __ballot_sync(kFull, word != 0u);
      while (todo) {
        float v[kGather][kFeatures];
#pragma unroll
        for (int j = 0; j < kGather; ++j) {
          const int src = todo ? __ffs(todo) - 1 : 0;
          const bool any = todo != 0u;
          todo &= todo - 1u;
          const uint32_t bw = __shfl_sync(kFull, word, src);
          const int bp = __shfl_sync(kFull, wpre, src);
          const bool mine = any && ((bw >> lane) & 1u);
          const int slot = bp + __popc(bw & ((1u << lane) - 1u));
          const float* src_row = prow + ((size_t)(b0 + src) * cap + slot) * kFeatures;
#pragma unroll
          for (int k = 0; k < kFeatures; ++k) v[j][k] = mine ? __ldcg(src_row + k) : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < kGather; ++j)
#pragma unroll
          for (int k = 0; k < kFeatures; ++k) acc[k] += v[j][k];
      }
    }
#pragma unroll
    for (int k = 0; k < kFeatures; ++k) runs[(warp * 32 + lane) * kFeatures + k] = acc[k];
    __syncthreads();
    const int r = 32 * w + lane;
    if (warp == 0 && r < rows) {
      float sum[kFeatures];
#pragma unroll
      for (int k = 0; k < kFeatures; ++k) sum[k] = runs[lane * kFeatures + k];
      for (int wp = 1; wp < warps; ++wp)
#pragma unroll
        for (int k = 0; k < kFeatures; ++k) sum[k] += runs[(wp * 32 + lane) * kFeatures + k];
      float* o = out + (size_t)r * kOutCols;
#pragma unroll
      for (int k = 0; k < kFeatures; ++k) o[k] = sum[k];
#pragma unroll
      for (int k = kFeatures; k < kOutCols; ++k) o[k] = 0.0f;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`, `blocks` blocks of `per_block` points
// each; returns cudaGetLastError() (0 = ok).  pts (n, 3), X (6,), bounds
// (V+1, 2), anchors (V+1, 3) and out (V+1, 16) are float32 device arrays;
// scratch holds blocks * cap * 10 floats of compacted rows, then
// blocks * words bitmap words and blocks * words prefix counts (words =
// ceil((V+1) / 32), cap >= the rows one block can touch).  A cooperative
// launch: it fails, rather than waits, if the blocks cannot all be resident.
int icet_fused_moment_sums(const void* pts, int n, const void* X,
                           const void* bounds, const void* anchors,
                           int n_voxels, int n_theta, int n_phi,
                           float phi_min, float phi_span, float min_range,
                           void* scratch, int blocks, int per_block, int cap,
                           void* out, void* stream) {
  const int rows = n_voxels + 1;
  const int words = (rows + 31) / 32;
  // The table and its bitmap, and later the warps' run sums of 32 rows.
  const int smem = max(rows * kFeatures + 2 * words, kThreads * kFeatures) * (int)sizeof(float);
  // Above 48 KB of dynamic shared memory needs an opt-in, which is kept
  // per device: set it once a device and size (the current device may
  // differ from one call to the next).
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  static int opted_in[64] = {};
  if (device >= 64 || opted_in[device] < smem) {
    err = cudaFuncSetAttribute(fused_moments_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (device < 64) opted_in[device] = smem;
  }
  float* prow = static_cast<float*>(scratch);
  uint32_t* pbits = reinterpret_cast<uint32_t*>(prow + (size_t)blocks * cap * kFeatures);
  int* ppre = reinterpret_cast<int*>(pbits + (size_t)blocks * words);
  const float* p_pts = static_cast<const float*>(pts);
  const float* p_X = static_cast<const float*>(X);
  const float* p_bounds = static_cast<const float*>(bounds);
  const float* p_anchors = static_cast<const float*>(anchors);
  float* p_out = static_cast<float*>(out);
  void* args[] = {&p_pts, &n, &per_block, &p_X, &p_bounds, &p_anchors, &n_voxels,
                  &n_theta, &n_phi, &phi_min, &phi_span, &min_range, &cap, &prow,
                  &pbits, &ppre, &p_out};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fused_moments_kernel),
                                    dim3(blocks), dim3(kThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* icet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
