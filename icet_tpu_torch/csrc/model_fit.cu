// The voxel-model fit of the prepare: from scan 1's (V+1, 16) moment sums at
// X = 0, its clusters and anchors to the whole voxel model (count, mean,
// cov, valid, the eigenbasis and the per-axis keep mask), in two launches a
// fit.
//
// Replaces no TPU kernel.  The JAX package writes this math as plane-form
// array code (icet_tpu/solver.py: finalize_moments_planes, eigh3_planes,
// _sigma_axis_mask) and leaves its fusion to XLA.  Unfused on this card it
// is a chain of ~1,270 tiny elementwise launches a fit (solver.
// model_from_sums before this kernel, most of them the 3x3 Jacobi sweeps),
// 83% of every frame's prepare.  The plain version stays in
// icet_tpu_torch/ops/model_fit.py (model_fit_reference).
//
// Bound on the card: the call reads the sums (64 B a row), the bounds,
// found flags and anchors (21 B) and writes the model (101 B a row): 0.34
// MB at V + 1 = 1,801, ~0.1 us at 3.35 TB/s; a few thousand float
// operations a row.  So latency bounds it: one thread's chain through six
// 3x3 Jacobi sweeps (18 atan2f, cosf, sinf) and the six endpoints' spherical
// coordinates (atan2f, acosf).
//
// Design:
// - One thread a row, everything of a row in registers.  Launch 1: the
//   finalize (as kernel #6 finalizes scan 2), validity, the first `sweeps`
//   cyclic Jacobi sweeps, the convergence test, one more sweep and the test
//   again; it writes count, mean, cov and valid, and the two states to the
//   scratch.  Launch 2: the committed state (and the last extra sweep where
//   both tests held somewhere), the ascending sort, then the axis mask:
//   the endpoint test of _sigma_axis_mask (each endpoint's spherical
//   coordinates and voxel id, against its own bin and radial bounds) or
//   _ndt_axis_mask's, times _clip_fill_mask's where clip_fill > 0 (template
//   choices: every configuration takes this kernel).
// - The safeguard is global: eigh3_planes commits extra sweep k to every
//   row while ANY of the V+1 rows (invalid rows and the sentinel too) keeps
//   off-diagonal mass above rtol ||diag||.  Launch 1 computes each row's
//   states after `sweeps` and `sweeps` + 1 sweeps and its two unconverged
//   bits, and each block ORs its bits into one word (integer, exact in any
//   order: no float atomic).  Launch 2 ORs every block's word: go1 (some row
//   unconverged after `sweeps`), go2 (after one more); a row keeps
//   go1 ? (go2 ? S+2 : S+1) : S, which is what the plain version's
//   torch.where commits.  The split into two launches is the grid-wide
//   barrier: no co-residency limit, the same code at every row count.
// - The plain version's rounding: built with -fmad=false and without fast
//   math; precise atan2f/acosf/cosf/sinf/sqrtf/logf, true division where the
//   plain version divides tensor by tensor, and its order of operations
//   term by term.  A tensor divided by a Python scalar is, on the card, a
//   multiply by the scalar's float32 reciprocal (PyTorch's div_true kernel
//   with a CPU scalar operand), so the wrapper passes those reciprocals
//   (voxel_ids' theta / 2 pi, / phi_span, / min_range, / log growth) and
//   the kernel multiplies.  Each row's values equal the plain route's on
//   the card bit for bit.
// - Block size from the row count as kernel #6 picks it (64 threads up to
//   16,384 rows, else 256).  Nothing allocated, no atomics, every value a
//   function of its row (and the two global flags): the same inputs give
//   the same bits every launch and every graph replay.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
// eigh3_planes' extra sweeps under the safeguard
constexpr int kMaxExtra = 2;
// floats of a state in the scratch: A (3, 3), then V (3, 3)
constexpr int kState = 18;
// scratch floats a row: the states after `sweeps` and `sweeps` + 1 sweeps
constexpr int kScratchPerRow = 2 * kState;
// float32 of geometry.TWO_PI (cart_to_spherical's theta + TWO_PI)
constexpr float kTwoPi = 6.28318530717958647692f;
static_assert(kMaxExtra == 2, "launch 2 commits at most two extra sweeps");

struct Args {
  const float* sums;      // (rows, 16)
  const float* anchors;   // (rows, 3)
  const float* bounds;    // (rows, 2)
  const uint8_t* found;   // (rows,) bool
  int rows;
  int sweeps;             // cyclic sweeps before the safeguard
  float min_pts;
  float min_outer_range;
  float rtol2;            // float32 of rtol * rtol
  // grid.voxel_ids
  int n_theta, n_phi, n_voxels, n_angular, radial_fixed, n_shells;
  float phi_min, inv_two_pi, inv_phi_span, min_range, inv_min_range, inv_log_growth;
  // the axis masks
  float sigma_scale;
  float half_clip_fill;   // float32 of 0.5 * clip_fill
  float d_theta, d_phi;   // float32 of 2 pi / n_theta, (phi_max - phi_min) / n_phi
  float* scratch;         // (kScratchPerRow, rows)
  int* flags;             // (blocks,)
  float* count;           // (rows,)
  float* mean;            // (rows, 3)
  float* cov;             // (rows, 3, 3)
  float* basis;           // (rows, 3, 3), eigenvectors as columns, ascending
  float* lmask;           // (rows, 3)
  uint8_t* valid;         // (rows,) bool
};

// torch.clamp(v, min=lo) on the card: NaN passes through.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

// torch.clamp(v, -1, 1) on the card: NaN passes through.
__device__ __forceinline__ float clamp_unit(float v) {
  return isnan(v) ? v : fminf(fmaxf(v, -1.0f), 1.0f);
}

// One Jacobi rotation zeroing A[p][q] (wls_planes._rotate3).
template <int p, int q>
__device__ __forceinline__ void rotate3(float (&A)[3][3], float (&V)[3][3]) {
  const float ang = 0.5f * atan2f(2.0f * A[p][q], A[q][q] - A[p][p]);
  const float c = cosf(ang);
  const float s = sinf(ang);
  float rp[3], rq[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    rp[j] = c * A[p][j] - s * A[q][j];
    rq[j] = s * A[p][j] + c * A[q][j];
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    A[p][j] = rp[j];
    A[q][j] = rq[j];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float ap = c * A[i][p] - s * A[i][q];
    const float aq = s * A[i][p] + c * A[i][q];
    A[i][p] = ap;
    A[i][q] = aq;
    const float vp = c * V[i][p] - s * V[i][q];
    const float vq = s * V[i][p] + c * V[i][q];
    V[i][p] = vp;
    V[i][q] = vq;
  }
}

// One cyclic sweep (wls_planes._sweep3).
__device__ __forceinline__ void sweep3(float (&A)[3][3], float (&V)[3][3]) {
  rotate3<0, 1>(A, V);
  rotate3<0, 2>(A, V);
  rotate3<1, 2>(A, V);
}

// wls_planes._unconverged3 of one row.
__device__ __forceinline__ bool unconverged(const float (&A)[3][3], float rtol2) {
  const float off = (A[0][1] * A[0][1] + A[0][2] * A[0][2]) + A[1][2] * A[1][2];
  const float dg = (A[0][0] * A[0][0] + A[1][1] * A[1][1]) + A[2][2] * A[2][2];
  return off > rtol2 * clamp_min(dg, 1e-30f);
}

__device__ __forceinline__ void store_state(float* s, int rows, int v, const float (&A)[3][3],
                                            const float (&V)[3][3]) {
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    s[(size_t)k * rows + v] = A[k / 3][k % 3];
    s[(size_t)(9 + k) * rows + v] = V[k / 3][k % 3];
  }
}

__device__ __forceinline__ void load_state(const float* s, int rows, int v, float (&A)[3][3],
                                           float (&V)[3][3]) {
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    A[k / 3][k % 3] = s[(size_t)k * rows + v];
    V[k / 3][k % 3] = s[(size_t)(9 + k) * rows + v];
  }
}

// grid.voxel_ids of one point in spherical coordinates.
__device__ __forceinline__ int voxel_id(float r, float theta, float phi, const Args& a) {
  int itheta = (int)((theta * a.inv_two_pi) * (float)a.n_theta);
  itheta = min(max(itheta, 0), a.n_theta - 1);
  const int iphi = (int)floorf(((phi - a.phi_min) * a.inv_phi_span) * (float)a.n_phi);
  bool in_band = iphi >= 0 && iphi < a.n_phi && r >= a.min_range;
  int vid = iphi * a.n_theta + itheta;
  if (a.radial_fixed) {
    const float safe_r = clamp_min(r, a.min_range);
    const int shell = (int)floorf(logf(safe_r * a.inv_min_range) * a.inv_log_growth);
    in_band = in_band && shell >= 0 && shell < a.n_shells;
    vid = min(max(shell, 0), a.n_shells - 1) * a.n_angular + vid;
  }
  return in_band ? vid : a.n_voxels;
}

// Whether the endpoint (x, y, z) lies inside row v's voxel: its own bin
// (geometry.cart_to_spherical, then voxel_ids) and the radial bounds.
__device__ __forceinline__ bool endpoint_inside(float x, float y, float z, int v, float lo,
                                                float hi, const Args& a) {
  x = isfinite(x) ? x : 0.0f;
  y = isfinite(y) ? y : 0.0f;
  z = isfinite(z) ? z : 0.0f;
  const float r = sqrtf((x * x + y * y) + z * z);
  float theta = atan2f(y, x);
  if (theta < 0.0f) theta = theta + kTwoPi;
  const bool pos = r > 0.0f;
  const float safe_r = pos ? r : 1.0f;
  float phi = acosf(clamp_unit(z / safe_r));
  if (!pos) {
    theta = 0.0f;
    phi = 0.0f;
  }
  return voxel_id(r, theta, phi, a) == v && r >= lo && r <= hi;
}

// Launch 1: finalize, validity, the sweeps and the two convergence tests.
__global__ void __launch_bounds__(kMaxThreads) model_fit_kernel_sweeps(Args a) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  bool u1 = false, u2 = false;
  if (v < a.rows) {
    // finalize_moments_planes.
    const float* s = a.sums + (size_t)v * 16;
    const float count = s[0];
    const float safe_n = clamp_min(count, 1.0f);
    const float g[3] = {s[1] / safe_n, s[2] / safe_n, s[3] / safe_n};
    const float denom = clamp_min(count - 1.0f, 1.0f);
    const float c6[6] = {
        (s[4] - safe_n * (g[0] * g[0])) / denom, (s[5] - safe_n * (g[1] * g[1])) / denom,
        (s[6] - safe_n * (g[2] * g[2])) / denom, (s[7] - safe_n * (g[0] * g[1])) / denom,
        (s[8] - safe_n * (g[0] * g[2])) / denom, (s[9] - safe_n * (g[1] * g[2])) / denom};
    const int sym6[3][3] = {{0, 3, 4}, {3, 1, 5}, {4, 5, 2}};
    a.count[v] = count;
#pragma unroll
    for (int j = 0; j < 3; ++j) a.mean[(size_t)v * 3 + j] = a.anchors[(size_t)v * 3 + j] + g[j];
    float A[3][3], V[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        A[i][j] = c6[sym6[i][j]];
        V[i][j] = i == j ? 1.0f : 0.0f;
        a.cov[(size_t)v * 9 + i * 3 + j] = A[i][j];
      }
    }
    a.valid[v] = a.found[v] != 0 && count >= a.min_pts
                 && a.bounds[(size_t)v * 2 + 1] > a.min_outer_range;

    // eigh3_planes: the sweeps, then one extra sweep, each state tested.
#pragma unroll 1
    for (int k = 0; k < a.sweeps; ++k) sweep3(A, V);
    u1 = unconverged(A, a.rtol2);
    store_state(a.scratch, a.rows, v, A, V);
    sweep3(A, V);
    u2 = unconverged(A, a.rtol2);
    store_state(a.scratch + (size_t)kState * a.rows, a.rows, v, A, V);
  }
  const bool any1 = __syncthreads_or(u1);
  const bool any2 = __syncthreads_or(u2);
  if (threadIdx.x == 0) a.flags[blockIdx.x] = (any1 ? 1 : 0) | (any2 ? 2 : 0);
}

// Launch 2: the committed state, the sort and the axis mask.
template <bool kNdt, bool kClip>
__global__ void __launch_bounds__(kMaxThreads) model_fit_kernel_masks(Args a) {
  int f = 0;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += blockDim.x) f |= a.flags[b];
  const bool go1 = __syncthreads_or(f & 1);
  const bool go2 = __syncthreads_or(f & 2);
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= a.rows) return;

  float A[3][3], V[3][3];
  load_state(a.scratch + (go1 ? (size_t)kState * a.rows : 0), a.rows, v, A, V);
  if (go1 && go2) sweep3(A, V);

  // The ascending sort: eigh3_planes' cswap(0, 1), cswap(1, 2), cswap(0, 1).
  float w[3] = {A[0][0], A[1][1], A[2][2]};
  float col[3][3];  // col[k][i] = eigenvector k, component i
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int i = 0; i < 3; ++i) col[k][i] = V[i][k];
  }
  const int order[3][2] = {{0, 1}, {1, 2}, {0, 1}};
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    const int p = order[t][0], q = order[t][1];
    const bool swap = w[p] > w[q];
    const float wp = swap ? w[q] : w[p];
    const float wq = swap ? w[p] : w[q];
    w[p] = wp;
    w[q] = wq;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float cp = swap ? col[q][i] : col[p][i];
      const float cq = swap ? col[p][i] : col[q][i];
      col[p][i] = cp;
      col[q][i] = cq;
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int k = 0; k < 3; ++k) a.basis[(size_t)v * 9 + i * 3 + k] = col[k][i];
  }

  const float lo = a.bounds[(size_t)v * 2];
  const float hi = a.bounds[(size_t)v * 2 + 1];
  float m[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) m[j] = a.mean[(size_t)v * 3 + j];
  bool keep[3];
  if (kNdt) {
    // _ndt_axis_mask: |u_k| lam_k against the radial width squared.
    const float width = hi - lo;
    const float thr = width * width;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float lam = clamp_min(w[k], 0.0f);
      keep[k] = !(fabsf(col[k][0]) * lam > thr || fabsf(col[k][1]) * lam > thr
                  || fabsf(col[k][2]) * lam > thr);
    }
  } else {
    // _sigma_axis_mask: an endpoint mu +- s sqrt(lam_k) u_k inside the voxel.
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float sq = a.sigma_scale * sqrtf(clamp_min(w[k], 0.0f));
      float off[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) off[i] = sq * col[k][i];
      keep[k] = endpoint_inside(m[0] + off[0], m[1] + off[1], m[2] + off[2], v, lo, hi, a)
                || endpoint_inside(m[0] - off[0], m[1] - off[1], m[2] - off[2], v, lo, hi, a);
    }
  }
  if (kClip) {
    // _clip_fill_mask: sigma_scale sqrt(lam_k) against clip_fill / 2 of the
    // cell's extent along axis k (an L1 box bound in the local spherical
    // frame).
    const float r = sqrtf((m[0] * m[0] + m[1] * m[1]) + m[2] * m[2]);
    const float safe_r = clamp_min(r, 1e-6f);
    const float rhat[3] = {m[0] / safe_r, m[1] / safe_r, m[2] / safe_r};
    const float sin_phi = sqrtf(clamp_min(m[0] * m[0] + m[1] * m[1], 1e-12f)) / safe_r;
    const float den = clamp_min(sin_phi * safe_r, 1e-9f);
    const float that[3] = {-(m[1] / den), m[0] / den, 0.0f};
    const float phat[3] = {that[1] * rhat[2] - that[2] * rhat[1],
                           that[2] * rhat[0] - that[0] * rhat[2],
                           that[0] * rhat[1] - that[1] * rhat[0]};
    const float w_r = hi - lo;
    const float w_t = (r * sin_phi) * a.d_theta;
    const float w_p = r * a.d_phi;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float pr = fabsf((rhat[0] * col[k][0] + rhat[1] * col[k][1]) + rhat[2] * col[k][2]);
      const float pt = fabsf((that[0] * col[k][0] + that[1] * col[k][1]) + that[2] * col[k][2]);
      const float pp = fabsf((phat[0] * col[k][0] + phat[1] * col[k][1]) + phat[2] * col[k][2]);
      const float extent = (pr * w_r + pt * w_t) + pp * w_p;
      const float span = a.sigma_scale * sqrtf(clamp_min(w[k], 0.0f));
      keep[k] = keep[k] && span <= a.half_clip_fill * extent;
    }
  }
  const bool ok = a.valid[v] != 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) a.lmask[(size_t)v * 3 + k] = ok && keep[k] ? 1.0f : 0.0f;
}

const void* pick_masks(bool ndt, bool clip) {
  return ndt ? (clip ? reinterpret_cast<const void*>(model_fit_kernel_masks<true, true>)
                     : reinterpret_cast<const void*>(model_fit_kernel_masks<true, false>))
             : (clip ? reinterpret_cast<const void*>(model_fit_kernel_masks<false, true>)
                     : reinterpret_cast<const void*>(model_fit_kernel_masks<false, false>));
}

}  // namespace

extern "C" {

// Launches the two kernels on `stream`; returns the first CUDA error (0 =
// ok).  Every array is a contiguous device array, float32 unless said: sums
// (rows, 16), anchors (rows, 3), bounds (rows, 2), found (rows,) bool.
// `sweeps` Jacobi sweeps before the safeguard's two; `ndt` takes
// _ndt_axis_mask's test in place of the endpoint test; `clip` multiplies in
// _clip_fill_mask's, at clip_fill / 2 = half_clip_fill.  `blocks` blocks of `threads` (a
// multiple of 32, at most 256) cover the rows; scratch holds 36 floats a
// row, flags one int a block.  Writes count (rows,), mean (rows, 3), cov
// and basis (rows, 3, 3), lmask (rows, 3) and valid (rows,) bool.
int icet_model_fit(const void* sums, const void* anchors, const void* bounds,
                   const void* found, int rows, int sweeps, float min_pts,
                   float min_outer_range, float rtol2, int n_theta, int n_phi, int n_voxels,
                   int n_angular, int radial_fixed, int n_shells, float phi_min,
                   float inv_two_pi, float inv_phi_span, float min_range, float inv_min_range,
                   float inv_log_growth, int ndt, int clip, float sigma_scale,
                   float half_clip_fill,
                   float d_theta, float d_phi, int blocks, int threads, void* scratch,
                   void* flags, void* count, void* mean, void* cov, void* basis, void* lmask,
                   void* valid, void* stream) {
  if (rows < 1 || sweeps < 0 || threads < 32 || threads > kMaxThreads || threads % 32
      || (long long)blocks * threads < rows)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.sums = static_cast<const float*>(sums);
  a.anchors = static_cast<const float*>(anchors);
  a.bounds = static_cast<const float*>(bounds);
  a.found = static_cast<const uint8_t*>(found);
  a.rows = rows;
  a.sweeps = sweeps;
  a.min_pts = min_pts;
  a.min_outer_range = min_outer_range;
  a.rtol2 = rtol2;
  a.n_theta = n_theta;
  a.n_phi = n_phi;
  a.n_voxels = n_voxels;
  a.n_angular = n_angular;
  a.radial_fixed = radial_fixed;
  a.n_shells = n_shells;
  a.phi_min = phi_min;
  a.inv_two_pi = inv_two_pi;
  a.inv_phi_span = inv_phi_span;
  a.min_range = min_range;
  a.inv_min_range = inv_min_range;
  a.inv_log_growth = inv_log_growth;
  a.sigma_scale = sigma_scale;
  a.half_clip_fill = half_clip_fill;
  a.d_theta = d_theta;
  a.d_phi = d_phi;
  a.scratch = static_cast<float*>(scratch);
  a.flags = static_cast<int*>(flags);
  a.count = static_cast<float*>(count);
  a.mean = static_cast<float*>(mean);
  a.cov = static_cast<float*>(cov);
  a.basis = static_cast<float*>(basis);
  a.lmask = static_cast<float*>(lmask);
  a.valid = static_cast<uint8_t*>(valid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* args[] = {&a};
  cudaError_t err = cudaLaunchKernel(reinterpret_cast<const void*>(model_fit_kernel_sweeps),
                                     dim3(blocks), dim3(threads), args, 0, s);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernel(pick_masks(ndt != 0, clip != 0), dim3(blocks),
                         dim3(threads), args, 0, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* icet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
