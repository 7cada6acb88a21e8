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
//   atan2f/acosf;  vid as grid.voxel_ids, in adaptive radial mode and in
//   fixed radial mode (shell = floor(logf(max(r', min_range) / min_range)
//   / log(growth)), the log growth the float32 that torch divides by;
//   in band if 0 <= shell < n_shells; vid += shell * n_theta * n_phi)
//   member = |p| >= min_range  (gate on the RAW point)
//            && vid < V && bounds[vid, 0] <= r' <= bounds[vid, 1]
//   g = p' - anchors[vid] for members only (a select, never a multiply)
//   sums[vid] += [1, g, gx^2, gy^2, gz^2, gx gy, gx gz, gy gz]
//
// Bound on the card: the call must read the scan once (12 B a point,
// 0.79 MB at N = 65,536), the bounds and anchors (20 B a row) of the rows
// its points fall in, and write the (V+1, 16) sums: under 0.9 MB and
// 0.27 us at 3.35 TB/s at V = 1,800; at fixed radial mode's 90,001 rows
// the 5.76 MB of sums written set it near 2 us.  The arithmetic (a few dozen flops and three or four
// transcendentals a point) is far below the card's rate.  At these sizes
// the kernel is set by latency: one launch, one pass over the points, and
// the cross-block sum, and by contention: a beam-major scan sends runs of
// neighbouring points into one voxel, so the lanes of a warp add into one
// row.
//
// Two branches, one cooperative launch a call either way.  Adaptive tables
// whose (V+1) x 10 floats fit one block's shared memory (V <= 5,774) take
// the shared table; fixed radial mode and larger tables take the sorted
// parts of csrc/sorted_parts.cuh, the large-table branch of the moment
// scatter (kernel #3): a block of 1,024 threads bins a part of 1,024
// consecutive points, stages each member's ten features in shared memory
// (a 16-float row, columns 10-15 zero), sorts the part's (vid, position)
// keys and sums each voxel's rows in sorted order; after the grid barrier
// the parts' compacted partials are added in part order and every output
// row is written.  The bounds and anchors are read from device memory
// (1.8 MB at 90,001 rows, which stay in L2).  The launcher keeps a part's
// bitmap in shared memory where it fits (up to ~1.36 million rows), in
// device memory beyond (tools/time_bitmap_placement.py times the two).
//
// The shared-table design:
// - One block an SM at most (the wrapper sizes the grid), each walking a
//   contiguous slice of the points, so a block of a beam-major scan sees
//   a few beam rings and touches ~100 of the V+1 rows.  The whole
//   (V+1) x 10 table lives in the block's dynamic shared memory (72,040 B
//   at V = 1,800): no window, no spill, any scan order.
// - Warp aggregation: the lanes that share a voxel id form a group
//   (__match_any_sync); the group's lowest lane sums the group's features
//   with shuffles in ascending lane order and sets the row's bit in a
//   shared bitmap (an order-free atomicOr).
// - The groups' sums are added to the table in a fixed order: round by
//   round, and within a round warp 0 to warp 15, one turn a warp with a
//   barrier between turns.  Within one warp the leaders' voxel ids are
//   distinct, so a turn's plain adds never meet.  Every row's sum is thus
//   taken in an order the code fixes, whatever order the hardware runs
//   the warps in.
// - The block writes only the rows it touched, compacted in vid order
//   (slot = the bitmap's prefix count), with its bitmap and the bitmap's
//   per-word prefix counts: ~4 KB a block on a beam-major scan instead of
//   the whole table.
// - The partials are summed by the whole grid after a grid barrier
//   (cooperative_groups' grid sync: the launch is cooperative, so all
//   blocks are resident).  Block b writes bitmap words b, b + G, ... of the output; its
//   warps split the source blocks into contiguous runs, a lane (a row)
//   sums its run in ascending block order, loading up to 8 partial rows
//   at once, and the runs' sums are added in warp order.
// The order of every float addition is fixed by the code, in the block and
// across blocks, so a launch on the same inputs with the same grid gives
// the same bits every time.
//
// Built without FMA contraction (-fmad=false, see icet_tpu_torch/_build.py)
// and with the operations in the order of the plain PyTorch version
// (icet_tpu_torch/ops/geometry.py), so both compute the same p', r, theta
// and phi for the same point.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sorted_parts.cuh"

namespace {

constexpr int kThreads = 512;   // threads a block of the shared table
constexpr int kWarps = kThreads / 32;
constexpr int kFeatures = 10;   // accumulated columns
constexpr int kOutCols = 16;    // the JAX package's padded layout
constexpr int kGather = 8;      // blocks whose partial rows a lane loads at once
constexpr unsigned kFull = 0xffffffffu;
constexpr float kTwoPi = 6.28318530717958647692f;

struct Grid {
  int n_voxels, n_theta, n_phi, radial_fixed, n_shells;
  float phi_min, phi_span, min_range, shell_log_growth;
};

// euler_R(-X[3:6]) and X[:3].
struct Rot {
  float r00, r01, r02, r10, r11, r12, r20, r21, r22, tx, ty, tz;
};

// euler_R(-X[3:6]), entry by entry as geometry.euler_R forms it.
__device__ __forceinline__ Rot rotation(const float* __restrict__ X) {
  const float cf = cosf(-X[3]), sf = sinf(-X[3]);
  const float ct = cosf(-X[4]), st = sinf(-X[4]);
  const float cp = cosf(-X[5]), sp = sinf(-X[5]);
  Rot R;
  R.r00 = ct * cp; R.r01 = sp * cf + sf * st * cp; R.r02 = sf * sp - st * cf * cp;
  R.r10 = -sp * ct; R.r11 = cf * cp - sf * st * sp; R.r12 = sf * cp + st * sp * cf;
  R.r20 = st; R.r21 = -sf * ct; R.r22 = cf * ct;
  R.tx = X[0]; R.ty = X[1]; R.tz = X[2];
  return R;
}

// The voxel of raw point (x0, y0, z0) if it is a member, else -1, and then
// its ten anchored features in f (all zero for a non-member).
__device__ __forceinline__ int member_features(float x0, float y0, float z0, const Rot& R,
                                               const Grid& g,
                                               const float* __restrict__ bounds,
                                               const float* __restrict__ anchors,
                                               float (&f)[kFeatures]) {
  int vid = -1;
  float x = 0.0f, y = 0.0f, z = 0.0f, ax = 0.0f, ay = 0.0f, az = 0.0f;
  // NaN rows fail this comparison and are never members.
  if (sqrtf(x0 * x0 + y0 * y0 + z0 * z0) >= g.min_range) {
    x = x0 * R.r00 + y0 * R.r01 + z0 * R.r02 + R.tx;
    y = x0 * R.r10 + y0 * R.r11 + z0 * R.r12 + R.ty;
    z = x0 * R.r20 + y0 * R.r21 + z0 * R.r22 + R.tz;
    const float xs = isfinite(x) ? x : 0.0f;
    const float ys = isfinite(y) ? y : 0.0f;
    const float zs = isfinite(z) ? z : 0.0f;
    const float r = sqrtf(xs * xs + ys * ys + zs * zs);
    if (r >= g.min_range) {
      float theta = 0.0f, phi = 0.0f;
      if (r > 0.0f) {
        theta = atan2f(ys, xs);
        if (theta < 0.0f) theta = theta + kTwoPi;
        phi = acosf(fminf(fmaxf(zs / r, -1.0f), 1.0f));
      }
      int itheta = (int)(theta / kTwoPi * (float)g.n_theta);
      itheta = min(max(itheta, 0), g.n_theta - 1);
      const int iphi = (int)floorf((phi - g.phi_min) / g.phi_span * (float)g.n_phi);
      bool in_band = iphi >= 0 && iphi < g.n_phi;
      int v = iphi * g.n_theta + itheta;
      if (g.radial_fixed) {
        const float safe_r = fmaxf(r, g.min_range);
        const int shell = (int)floorf(logf(safe_r / g.min_range) / g.shell_log_growth);
        in_band = in_band && shell >= 0 && shell < g.n_shells;
        v = min(max(shell, 0), g.n_shells - 1) * (g.n_theta * g.n_phi) + v;
      }
      if (in_band) {
        // The anchor is loaded beside the bounds, not after the test.
        const float lo = bounds[2 * v], hi = bounds[2 * v + 1];
        ax = anchors[3 * v];
        ay = anchors[3 * v + 1];
        az = anchors[3 * v + 2];
        if (r >= lo && r <= hi) vid = v;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kFeatures; ++k) f[k] = 0.0f;
  if (vid >= 0) {
    const float gx = x - ax;
    const float gy = y - ay;
    const float gz = z - az;
    f[0] = 1.0f; f[1] = gx; f[2] = gy; f[3] = gz;
    f[4] = gx * gx; f[5] = gy * gy; f[6] = gz * gz;
    f[7] = gx * gy; f[8] = gx * gz; f[9] = gy * gz;
  }
  return vid;
}

__global__ void __launch_bounds__(kThreads)
fused_moments_kernel(const float* __restrict__ pts, int n, int per_block,
                     const float* __restrict__ X,
                     const float* __restrict__ bounds,
                     const float* __restrict__ anchors, Grid g,
                     int cap, float* __restrict__ prow,
                     uint32_t* __restrict__ pbits, int* __restrict__ ppre,
                     float* __restrict__ out) {
  extern __shared__ float table[];
  const int rows = g.n_voxels + 1;
  const int words = (rows + 31) / 32;
  uint32_t* bits = reinterpret_cast<uint32_t*>(table + rows * kFeatures);
  int* pre = reinterpret_cast<int*>(bits + words);

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
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

  const Rot R = rotation(X);
  __syncthreads();

  // Every thread of the block runs the same number of rounds, so each
  // round's warp-wide collectives see all 32 lanes.
  for (int base = p0; base < p1; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const float x0 = nx, y0 = ny, z0 = nz;
    if (i + (int)blockDim.x < p1) {  // the next round's point
      nx = pts[3 * (i + blockDim.x)];
      ny = pts[3 * (i + blockDim.x) + 1];
      nz = pts[3 * (i + blockDim.x) + 2];
    }
    float f[kFeatures] = {};
    const int vid = i < p1 ? member_features(x0, y0, z0, R, g, bounds, anchors, f) : -1;
    const bool member = vid >= 0;
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
    if (leader) atomicOr(bits + vid / 32, 1u << (vid % 32));
    // The leaders' adds, warp by warp: a fixed order of addition.
    for (int turn = 0; turn < kWarps; ++turn) {
      if (leader && warp == turn) {
        float* row = table + vid * kFeatures;
#pragma unroll
        for (int k = 0; k < kFeatures; ++k) row[k] += s[k];
      }
      __syncthreads();
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
  const int warps = kWarps;
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

// The scan's points for the sorted parts: a point's key is its voxel if
// it is a member (no row otherwise), its row the ten features the thread
// that binned it staged in shared memory (columns 10-15 zero).
struct FusedSource {
  const float* pts;
  const float* bounds;
  const float* anchors;
  Rot R;
  Grid g;
  float4* stage;  // (icet::kThreads, 3): the staged rows, a thread's at 3 t

  __device__ __forceinline__ uint32_t key(int i, int t) const {
    if (i < 0) return icet::kNoKey;
    float f[kFeatures];
    const int vid = member_features(pts[3 * i], pts[3 * i + 1], pts[3 * i + 2], R, g,
                                    bounds, anchors, f);
    if (vid < 0) return icet::kNoKey;
    stage[3 * t] = make_float4(f[0], f[1], f[2], f[3]);
    stage[3 * t + 1] = make_float4(f[4], f[5], f[6], f[7]);
    stage[3 * t + 2] = make_float4(f[8], f[9], 0.0f, 0.0f);
    return (uint32_t)vid;
  }

  __device__ __forceinline__ void row(int, int pos, float4 (&q)[icet::kQuarters]) const {
    q[0] = stage[3 * pos];
    q[1] = stage[3 * pos + 1];
    q[2] = stage[3 * pos + 2];
  }
};

// Bytes of the staged rows beside the sort's buffers.
constexpr int kStageBytes = icet::kThreads * 3 * (int)sizeof(float4);

// The most dynamic shared memory a block of the sorted parts takes with a
// part's bitmap in it (Hopper's 227 KB a block); a larger bitmap lives in
// device memory.  tools/time_bitmap_placement.py builds the kernel with 0
// here to time the two placements.
#ifndef ICET_SORTED_SMEM_LIMIT
#define ICET_SORTED_SMEM_LIMIT 232448
#endif

// The large-table branch: the parts binned, sorted and summed, then, after
// the grid barrier, combined in part order into every row of `out`.
template <bool kGlobalBits>
__global__ void __launch_bounds__(icet::kThreads, 1)
fused_large_kernel(const float* __restrict__ pts, int n, int chunk, int parts,
                   const float* __restrict__ X, const float* __restrict__ bounds,
                   const float* __restrict__ anchors, Grid g, icet::Partials P,
                   float4* __restrict__ out) {
  extern __shared__ float4 large_smem[];
  icet::SortSmem& sm = *reinterpret_cast<icet::SortSmem*>(large_smem);
  float4* stage = reinterpret_cast<float4*>(&sm + 1);
  FusedSource src{pts, bounds, anchors, rotation(X), g, stage};
  icet::sorted_parts<kGlobalBits>(src, n, chunk, parts, P, sm,
                                  reinterpret_cast<uint32_t*>(stage + 3 * icet::kThreads));
  // Grid barrier: every part's partial is written and visible.
  cooperative_groups::this_grid().sync();
  icet::combine(P, parts, g.n_voxels + 1, out);
}

// Above 48 KB of dynamic shared memory needs an opt-in, which is kept per
// device and kernel: set it once a device, kernel and size (the current
// device may differ from one call to the next).
// `variant` 0: the shared table; 1 and 2: the sorted parts with a part's
// bitmap in shared memory, in device memory.
cudaError_t opt_in_shared(const void* kernel, int variant, int smem) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  static int opted_in[3][64] = {};
  if (device < 64 && opted_in[variant][device] >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && device < 64) opted_in[variant][device] = smem;
  return err;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = ok).
// pts (n, 3), X (6,), bounds (V+1, 2), anchors (V+1, 3) and out (V+1, 16)
// are float32 device arrays.  `branch` 0: the shared table (adaptive radial
// mode only), `blocks` blocks of `per_block` points each; scratch holds
// blocks * cap * 10 floats of compacted rows, then blocks * words bitmap
// words and blocks * words prefix counts (words = ceil((V+1) / 32), cap >=
// the rows one block can touch; `parts` unused).  `branch` 1: the sorted
// parts, `blocks` blocks walking `parts` parts of `per_block` (<= 1,024)
// points each; scratch holds parts * cap * 16 floats of compacted rows,
// then parts * words bitmap words and parts * words prefix counts (a
// part's bitmap is kept in shared memory where it fits, else in its words
// of the scratch).  A cooperative launch: it fails, rather than waits, if
// the blocks cannot all be resident.
int icet_fused_moment_sums(const void* pts, int n, const void* X,
                           const void* bounds, const void* anchors,
                           int n_voxels, int n_theta, int n_phi,
                           float phi_min, float phi_span, float min_range,
                           int radial_fixed, int n_shells, float shell_log_growth,
                           void* scratch, int branch, int blocks, int per_block, int parts,
                           int cap, void* out, void* stream) {
  const int rows = n_voxels + 1;
  const int words = (rows + 31) / 32;
  if (branch < 0 || branch > 1 || (branch == 0 && radial_fixed)
      || (branch > 0 && per_block > icet::kThreads))
    return (int)cudaErrorInvalidValue;
  Grid g{n_voxels, n_theta, n_phi, radial_fixed, n_shells,
         phi_min, phi_span, min_range, shell_log_growth};
  const float* p_pts = static_cast<const float*>(pts);
  const float* p_X = static_cast<const float*>(X);
  const float* p_bounds = static_cast<const float*>(bounds);
  const float* p_anchors = static_cast<const float*>(anchors);
  cudaError_t err;
  if (branch == 0) {
    // The table and its bitmap, and later the warps' run sums of 32 rows.
    const int smem = max(rows * kFeatures + 2 * words, kThreads * kFeatures) * (int)sizeof(float);
    err = opt_in_shared(reinterpret_cast<const void*>(fused_moments_kernel), 0, smem);
    if (err != cudaSuccess) return (int)err;
    float* prow = static_cast<float*>(scratch);
    uint32_t* pbits = reinterpret_cast<uint32_t*>(prow + (size_t)blocks * cap * kFeatures);
    int* ppre = reinterpret_cast<int*>(pbits + (size_t)blocks * words);
    float* p_out = static_cast<float*>(out);
    void* args[] = {&p_pts, &n, &per_block, &p_X, &p_bounds, &p_anchors, &g, &cap, &prow,
                    &pbits, &ppre, &p_out};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fused_moments_kernel),
                                      dim3(blocks), dim3(kThreads), args, smem,
                                      static_cast<cudaStream_t>(stream));
  } else {
    // The sort's buffers, the staged rows and, where it fits, a part's bitmap.
    const int base = (int)sizeof(icet::SortSmem) + kStageBytes;
    const bool smem_bits = base + words * (int)sizeof(uint32_t) <= ICET_SORTED_SMEM_LIMIT;
    const int smem = base + (smem_bits ? words * (int)sizeof(uint32_t) : 0);
    const void* kernel = smem_bits ? reinterpret_cast<const void*>(fused_large_kernel<false>)
                                   : reinterpret_cast<const void*>(fused_large_kernel<true>);
    err = opt_in_shared(kernel, smem_bits ? 1 : 2, smem);
    if (err != cudaSuccess) return (int)err;
    icet::Partials P;
    P.cap = cap;
    P.words = words;
    P.rows = static_cast<float4*>(scratch);
    P.bits = reinterpret_cast<uint32_t*>(P.rows + (size_t)parts * cap * icet::kQuarters);
    P.pre = reinterpret_cast<int*>(P.bits + (size_t)parts * words);
    float4* p_out = static_cast<float4*>(out);
    void* args[] = {&p_pts, &n, &per_block, &parts, &p_X, &p_bounds, &p_anchors, &g, &P,
                    &p_out};
    err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(icet::kThreads), args, smem,
                                      static_cast<cudaStream_t>(stream));
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* icet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
