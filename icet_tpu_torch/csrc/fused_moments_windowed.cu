// Windowed fused moment sums: the fused transform + spherical re-bin +
// radial-bounds membership + anchored moment pass of fused_moments.cu,
// restricted per block of points to a narrow band of voxel ids, with the
// points that fall outside their block's band counted as overflow.
//
// Replaces the TPU kernel icet_tpu/ops/pallas_fused.py::_windowed_kernel
// (wrapper fused_moment_sums_windowed, pallas_call at pallas_fused.py:340)
// and computes its function:
//   p' = euler_R(-X[3:6]) p + X[:3];  (r, theta, phi) of p' (NaN/inf -> 0;
//   r == 0 -> (0, 0, 0)), exact atan2f/acosf (the TPU kernel's polynomial
//   atan exists only because Mosaic has no atan; it differs within about
//   1e-6 rad of a bin edge)
//   ok  = iphi in [0, n_phi) && r' >= min_range (the TRANSFORMED range,
//         unlike fused_moments.cu, which gates the raw range as the
//         solver's _jnp_sums does), and in fixed radial mode a shell in
//         [0, n_shells); vid as grid.voxel_ids
//   per block of `block` consecutive points: vmin = least ok vid (0 if
//   none), start = max(min((vmin / 128) * 128, v_pad - window), 0)
//   in_win   = ok && start <= vid < start + window - 1 (the window's last
//              column is the TPU's overflow slot)
//   overflow = count of ok && !in_win, over all blocks (members or not)
//   sums[vid] += [1, g, gx^2, gy^2, gz^2, gx gy, gx gz, gy gz] for
//   in-window points with bounds[vid, 0] <= r' <= bounds[vid, 1],
//   g = p' - anchors[vid]; columns 10-15 and row V zero.
//
// Bound on the card: the call must read the scan once (12 B a point), the
// bounds and anchors (20 B a voxel row), and write the (V+1, 16) sums and
// the overflow word: about 0.94 MB at N = 65,536, V = 1,800, 0.28 us at
// 3.35 TB/s.  The arithmetic is the same few dozen flops and three
// transcendentals a point as fused_moments.cu.
//
// Design: one thread block per point block.  The block keeps its points'
// transformed coordinates, ranges and voxel ids in shared memory (20 B a
// point), finds vmin with a shared atomicMin, and accumulates into a
// window x 10 float table in shared memory (10 KB at window 256) with
// shared atomics, so only the window lives on chip and fixed radial mode
// (V = 90,000) runs too.  Each block writes its (window, 10) partial table,
// its start and its overflow count; a second kernel sums, for each output
// row, the partials whose window covers it, in block order.  The
// cross-block sum is therefore in a fixed order (within a block the
// shared atomics commit in hardware order, as in fused_moments.cu), and
// the overflow total is an exact integer sum.
//
// Built without FMA contraction (-fmad=false, see icet_tpu_torch/_build.py)
// and with the operations in the order of the plain PyTorch version, so
// both bin and gate the same points.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFeatures = 10;
constexpr int kOutCols = 16;
constexpr int kNone = 0x7fffffff;
constexpr float kTwoPi = 6.28318530717958647692f;

struct Grid {
  int n_voxels, n_theta, n_phi, radial_fixed, n_shells;
  float phi_min, phi_span, min_range, shell_log_growth;
};

__global__ void __launch_bounds__(kThreads)
windowed_partial(const float* __restrict__ pts, int n,
                 const float* __restrict__ X,
                 const float* __restrict__ bounds,
                 const float* __restrict__ anchors, Grid g, int block,
                 int window, int v_pad, float* __restrict__ partial,
                 int* __restrict__ starts, int* __restrict__ overflow) {
  extern __shared__ float smem[];
  float* table = smem;                            // window * 10
  float* sx = table + window * kFeatures;         // block each
  float* sy = sx + block;
  float* sz = sy + block;
  float* sr = sz + block;
  int* svid = reinterpret_cast<int*>(sr + block);  // kNone when not ok
  __shared__ int s_vmin;
  __shared__ int s_ovf;

  for (int i = threadIdx.x; i < window * kFeatures; i += blockDim.x)
    table[i] = 0.0f;
  if (threadIdx.x == 0) {
    s_vmin = kNone;
    s_ovf = 0;
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

  const long base = (long)blockIdx.x * block;
  int local_min = kNone;
  for (int k = threadIdx.x; k < block; k += blockDim.x) {
    const long i = base + k;
    int vid = kNone;
    float x = 0.0f, y = 0.0f, z = 0.0f, r = 0.0f;
    if (i < n) {  // the zero-padded tail is never ok
      const float x0 = pts[3 * i], y0 = pts[3 * i + 1], z0 = pts[3 * i + 2];
      x = x0 * r00 + y0 * r01 + z0 * r02 + tx;
      y = x0 * r10 + y0 * r11 + z0 * r12 + ty;
      z = x0 * r20 + y0 * r21 + z0 * r22 + tz;
      const float xs = isfinite(x) ? x : 0.0f;
      const float ys = isfinite(y) ? y : 0.0f;
      const float zs = isfinite(z) ? z : 0.0f;
      r = sqrtf(xs * xs + ys * ys + zs * zs);
      if (r >= g.min_range) {
        float theta = 0.0f, phi = 0.0f;
        if (r > 0.0f) {
          theta = atan2f(ys, xs);
          if (theta < 0.0f) theta = theta + kTwoPi;
          phi = acosf(fminf(fmaxf(zs / r, -1.0f), 1.0f));
        }
        int itheta = (int)(theta / kTwoPi * (float)g.n_theta);
        itheta = min(max(itheta, 0), g.n_theta - 1);
        const int iphi =
            (int)floorf((phi - g.phi_min) / g.phi_span * (float)g.n_phi);
        if (iphi >= 0 && iphi < g.n_phi) {
          vid = iphi * g.n_theta + itheta;
          if (g.radial_fixed) {
            const float safe_r = fmaxf(r, g.min_range);
            const int shell =
                (int)floorf(logf(safe_r / g.min_range) / g.shell_log_growth);
            vid = (shell >= 0 && shell < g.n_shells)
                      ? shell * (g.n_theta * g.n_phi) + vid
                      : kNone;
          }
        }
      }
    }
    sx[k] = x;
    sy[k] = y;
    sz[k] = z;
    sr[k] = r;
    svid[k] = vid;
    local_min = min(local_min, vid);
  }
  for (int off = 16; off > 0; off >>= 1)
    local_min = min(local_min, __shfl_xor_sync(0xffffffffu, local_min, off));
  if ((threadIdx.x & 31) == 0) atomicMin(&s_vmin, local_min);
  __syncthreads();

  const int vmin = s_vmin == kNone ? 0 : s_vmin;
  const int start = max(min((vmin / 128) * 128, v_pad - window), 0);
  const int stop = start + window - 1;
  int local_ovf = 0;
  for (int k = threadIdx.x; k < block; k += blockDim.x) {
    const int vid = svid[k];
    if (vid == kNone) continue;
    if (vid < start || vid >= stop) {
      ++local_ovf;
      continue;
    }
    const float r = sr[k];
    if (!(r >= bounds[2 * vid] && r <= bounds[2 * vid + 1])) continue;
    const float gx = sx[k] - anchors[3 * vid];
    const float gy = sy[k] - anchors[3 * vid + 1];
    const float gz = sz[k] - anchors[3 * vid + 2];
    float* row = table + (vid - start) * kFeatures;
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
  for (int off = 16; off > 0; off >>= 1)
    local_ovf += __shfl_xor_sync(0xffffffffu, local_ovf, off);
  if ((threadIdx.x & 31) == 0) atomicAdd(&s_ovf, local_ovf);
  __syncthreads();

  float* dst = partial + (size_t)blockIdx.x * window * kFeatures;
  for (int i = threadIdx.x; i < window * kFeatures; i += blockDim.x)
    dst[i] = table[i];
  if (threadIdx.x == 0) {
    starts[blockIdx.x] = start;
    overflow[blockIdx.x] = s_ovf;
  }
}

// out[row, f] = sum over blocks b, in order, whose window covers row, of
// partial[b, row - starts[b], f]; columns 10-15 are zero.  The first
// thread also sums the blocks' overflow counts.
__global__ void windowed_reduce(const float* __restrict__ partial,
                                const int* __restrict__ starts,
                                const int* __restrict__ overflow, int blocks,
                                int window, int rows, float* __restrict__ out,
                                int* __restrict__ out_overflow) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i == 0) {
    int total = 0;
    for (int b = 0; b < blocks; ++b) total += overflow[b];
    *out_overflow = total;
  }
  if (i >= rows * kOutCols) return;
  const int row = i / kOutCols, f = i % kOutCols;
  float s = 0.0f;
  if (f < kFeatures && row < rows - 1) {
    for (int b = 0; b < blocks; ++b) {
      const int off = row - starts[b];
      if (off >= 0 && off < window - 1)
        s += partial[((size_t)b * window + off) * kFeatures + f];
    }
  }
  out[i] = s;
}

}  // namespace

extern "C" {

// Shared memory of one block of windowed_partial, in bytes.
int icet_windowed_shared_bytes(int block, int window) {
  return window * kFeatures * (int)sizeof(float) + block * 5 * 4;
}

// Launches both kernels on `stream`; returns cudaGetLastError() (0 = ok).
// pts (n, 3), X (6,), bounds (V+1, 2), anchors (V+1, 3), partial
// (blocks, window, 10) scratch and out (V+1, 16) are float32 device
// arrays; starts and overflow (blocks,) and out_overflow (1,) int32, with
// blocks = ceil(n / block).
int icet_fused_moment_sums_windowed(
    const void* pts, int n, const void* X, const void* bounds,
    const void* anchors, int n_voxels, int n_theta, int n_phi, float phi_min,
    float phi_span, float min_range, int radial_fixed, int n_shells,
    float shell_log_growth, int block, int window, int v_pad, void* partial,
    void* starts, void* overflow, void* out, void* out_overflow,
    void* stream) {
  const int blocks = (n + block - 1) / block;
  const int smem = icet_windowed_shared_bytes(block, window);
  cudaError_t err = cudaFuncSetAttribute(
      windowed_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Grid g{n_voxels, n_theta, n_phi, radial_fixed, n_shells,
               phi_min,  phi_span, min_range, shell_log_growth};
  if (blocks > 0) {
    windowed_partial<<<blocks, kThreads, smem, s>>>(
        static_cast<const float*>(pts), n, static_cast<const float*>(X),
        static_cast<const float*>(bounds),
        static_cast<const float*>(anchors), g, block, window, v_pad,
        static_cast<float*>(partial), static_cast<int*>(starts),
        static_cast<int*>(overflow));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int rows = n_voxels + 1;
  const int total = rows * kOutCols;
  windowed_reduce<<<(total + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(partial), static_cast<const int*>(starts),
      static_cast<const int*>(overflow), blocks, window, rows,
      static_cast<float*>(out), static_cast<int*>(out_overflow));
  return (int)cudaGetLastError();
}

const char* icet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
