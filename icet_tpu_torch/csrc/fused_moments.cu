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
// by launch latency and by contention: a beam-major scan sends runs of
// neighbouring points into the same voxel, so the lanes of a warp add into
// one shared-memory row and their atomics serialise.
//
// Design: the whole (V+1) x 10 float table lives in one block's dynamic
// shared memory (72,040 B at V = 1,800), so no point needs a window, a
// spill or a fallback, and scan order does not matter.  Each block walks a
// grid-stride slice of the points and accumulates with shared-memory
// atomics, then writes its table to a (blocks, V+1, 10) scratch; a second
// kernel sums the partial tables in block order.  The cross-block sum is
// therefore in a fixed order; within a block the atomics commit in
// hardware order, so float sums can differ in their last bits from run to
// run (the count column is exact).  Warp aggregation of same-voxel lanes
// is left for later work.
//
// Built without FMA contraction (-fmad=false, see icet_tpu_torch/_build.py)
// and with the operations in the order of the plain PyTorch version
// (icet_tpu_torch/ops/geometry.py), so both compute the same p', r, theta
// and phi for the same point.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFeatures = 10;   // accumulated columns
constexpr int kOutCols = 16;    // the JAX package's padded layout
constexpr float kTwoPi = 6.28318530717958647692f;

__global__ void __launch_bounds__(kThreads)
fused_moments_partial(const float* __restrict__ pts, int n,
                      const float* __restrict__ X,
                      const float* __restrict__ bounds,
                      const float* __restrict__ anchors,
                      int n_voxels, int n_theta, int n_phi,
                      float phi_min, float phi_span, float min_range,
                      float* __restrict__ partial) {
  extern __shared__ float table[];
  const int cells = (n_voxels + 1) * kFeatures;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) table[i] = 0.0f;

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

  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const float x0 = pts[3 * i], y0 = pts[3 * i + 1], z0 = pts[3 * i + 2];
    // NaN rows fail this comparison and are never members.
    if (!(sqrtf(x0 * x0 + y0 * y0 + z0 * z0) >= min_range)) continue;

    const float x = x0 * r00 + y0 * r01 + z0 * r02 + tx;
    const float y = x0 * r10 + y0 * r11 + z0 * r12 + ty;
    const float z = x0 * r20 + y0 * r21 + z0 * r22 + tz;
    const float xs = isfinite(x) ? x : 0.0f;
    const float ys = isfinite(y) ? y : 0.0f;
    const float zs = isfinite(z) ? z : 0.0f;
    const float r = sqrtf(xs * xs + ys * ys + zs * zs);
    if (!(r >= min_range)) continue;

    float theta = 0.0f, phi = 0.0f;
    if (r > 0.0f) {
      theta = atan2f(ys, xs);
      if (theta < 0.0f) theta = theta + kTwoPi;
      phi = acosf(fminf(fmaxf(zs / r, -1.0f), 1.0f));
    }

    int itheta = (int)(theta / kTwoPi * (float)n_theta);
    itheta = min(max(itheta, 0), n_theta - 1);
    const int iphi = (int)floorf((phi - phi_min) / phi_span * (float)n_phi);
    if (iphi < 0 || iphi >= n_phi) continue;
    const int vid = iphi * n_theta + itheta;
    if (!(r >= bounds[2 * vid] && r <= bounds[2 * vid + 1])) continue;

    const float gx = x - anchors[3 * vid];
    const float gy = y - anchors[3 * vid + 1];
    const float gz = z - anchors[3 * vid + 2];
    float* row = table + vid * kFeatures;
    atomicAdd(row + 0, 1.0f);
    atomicAdd(row + 1, gx);
    atomicAdd(row + 2, gy);
    atomicAdd(row + 3, gz);
    atomicAdd(row + 4, gx * gx);
    atomicAdd(row + 5, gy * gy);
    atomicAdd(row + 6, gz * gz);
    atomicAdd(row + 7, gx * gy);
    atomicAdd(row + 8, gx * gz);
    atomicAdd(row + 9, gy * gz);
  }
  __syncthreads();

  float* dst = partial + (size_t)blockIdx.x * cells;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) dst[i] = table[i];
}

// out[row, f] = sum over blocks b, in order, of partial[b, row, f];
// columns 10-15 are zero.
__global__ void fused_moments_reduce(const float* __restrict__ partial,
                                     int blocks, int rows,
                                     float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * kOutCols) return;
  const int row = i / kOutCols, f = i % kOutCols;
  float s = 0.0f;
  if (f < kFeatures) {
    const size_t stride = (size_t)rows * kFeatures;
    const float* p = partial + (size_t)row * kFeatures + f;
    for (int b = 0; b < blocks; ++b) s += p[b * stride];
  }
  out[i] = s;
}

}  // namespace

extern "C" {

// Launches both kernels on `stream`; returns cudaGetLastError() (0 = ok).
// pts (n, 3), X (6,), bounds (V+1, 2), anchors (V+1, 3), partial
// (blocks, V+1, 10) scratch and out (V+1, 16) are float32 device arrays.
int icet_fused_moment_sums(const void* pts, int n, const void* X,
                           const void* bounds, const void* anchors,
                           int n_voxels, int n_theta, int n_phi,
                           float phi_min, float phi_span, float min_range,
                           void* partial, int blocks, void* out,
                           void* stream) {
  const int rows = n_voxels + 1;
  const int smem = rows * kFeatures * (int)sizeof(float);
  // Above 48 KB of dynamic shared memory needs an opt-in, which is kept
  // per device: set it on every call (the current device may differ).
  cudaError_t err = cudaFuncSetAttribute(
      fused_moments_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fused_moments_partial<<<blocks, kThreads, smem, s>>>(
      static_cast<const float*>(pts), n, static_cast<const float*>(X),
      static_cast<const float*>(bounds), static_cast<const float*>(anchors),
      n_voxels, n_theta, n_phi, phi_min, phi_span, min_range,
      static_cast<float*>(partial));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = rows * kOutCols;
  fused_moments_reduce<<<(total + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(partial), blocks, rows,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

const char* icet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
