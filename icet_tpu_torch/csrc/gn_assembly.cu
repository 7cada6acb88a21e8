// Gauss-Newton normal-equation assembly: one launch an iteration, from
// scan 2's (V+1, 16) moment sums and the voxel model to the correspondence
// mask, its count, the moving-object rejections and the 21 + 6 (+ 6) sums
// of H^T W H, H^T W dz (and H^T W g, the range-sensitivity right-hand side).
//
// Replaces no TPU kernel.  The JAX package writes this math as plane-form
// array code (icet_tpu/ops/wls_planes.py, icet_tpu/solver.py) and leaves its
// fusion to XLA.  Unfused on this card it is a chain of ~1,650 tiny
// elementwise and reduction launches an iteration (solver.iteration_from_sums
// before this kernel: finalize_moments_planes, the correspondence mask, the
// moving-object test, assemble_normal_equations), which costs more than the
// rest of the frame.  The plain version stays in
// icet_tpu_torch/ops/gn_assembly.py (gn_assembly_reference).
//
// Bound on the card: the call reads the sums (64 B a row) and the model
// (113 B a row: count, mean, cov, basis, lmask, valid, anchors) and writes
// the mask (1 B a row) and 48 floats: 0.32 MB at V + 1 = 1,801, 0.096 us at
// 3.35 TB/s; a few thousand float operations a row.  So latency bounds it:
// one thread's chain through five Jacobi sweeps of a 3x3 (15 atan2f, cosf,
// sinf) and the sum across blocks.
//
// Design:
// - One thread a row, everything in registers: finalize, the mask, the
//   moving test, P = diag(l) U^T, R, P R P^T, its pseudo-inverse by five
//   cyclic Jacobi sweeps, Hz, W Hz, W P dz (and W P g).  No intermediate
//   goes to device memory.
// - The plain version's rounding: the file is built with -fmad=false and
//   without fast math; precise atan2f/cosf/sinf/sqrtf, true division, and
//   the plain version's order of operations term by term (a Python sum()
//   starts from 0, so a three-term sum here is ((0 + a) + b) + c).  Each
//   row's values equal the plain route's on the card; only the sums over
//   rows are added in another order.
// - Small blocks (64 threads up to 16,384 rows, else 256) so the rows
//   spread over the SMs.
// - Sums over rows in a fixed order (no float atomics): a block adds its
//   rows by a shuffle tree in each warp and its warps in order, and writes
//   that partial; the last block to finish (an integer ticket counts the
//   blocks done) adds the partials in block order, writes the outputs and
//   resets the ticket for the next launch.  The same inputs give the same
//   bits every launch and every graph replay.  The ticket is one word a
//   device: launches on one device run in stream order (as every caller of
//   the port runs them), never two at once.
// - The optional terms are template parameters: a correspondence mask, the
//   moving-object test (active from rm_start_iter), the range sensitivity.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// A block's partial in the scratch: 33 sums (21 of H^T W H's upper
// triangle, 6 of H^T W dz, 6 of H^T W g), then n_corr and n_rejected.
constexpr int kSums = 33;
constexpr int kStride = kSums + 2;

__device__ unsigned int g_ticket = 0;

struct Args {
  const float* sums;     // (rows, 16)
  const float* anchors;  // (rows, 3)
  const float* count1;   // (rows,)
  const float* mean1;    // (rows, 3)
  const float* cov1;     // (rows, 3, 3)
  const float* basis;    // (rows, 3, 3), eigenvectors as columns
  const float* lmask;    // (rows, 3)
  const uint8_t* valid;  // (rows,) bool
  const uint8_t* mask;   // (rows,) bool, or null
  const float* X;        // (6,)
  const float* dR;       // (3, 3, 3)
  int rows;
  float min_pts;
  float rcond;
  float rm_residual;
  float rm_yaw;
  float* scratch;        // (blocks, kStride)
  uint8_t* corr;         // (rows,) bool
  float* out;            // (48,): H^T W H (6, 6), H^T W dz (6,), H^T W g (6,)
  int* counts;           // (2,): n_corr, n_rejected
};

// torch.clamp(v, min=lo): NaN passes through.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return (isnan(v) || v > lo) ? v : lo;
}

// torch.maximum: NaN if either is NaN.
__device__ __forceinline__ float max_nan(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

// Python's sum() of three planes: ((0 + a) + b) + c.
__device__ __forceinline__ float sum3(float a, float b, float c) {
  return ((0.0f + a) + b) + c;
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

// Pseudo-inverse of a symmetric 3x3 by five cyclic Jacobi sweeps
// (wls_planes._pinv3_planes).
__device__ __forceinline__ void pinv3(const float (&R)[3][3], float rcond, float (&W)[3][3]) {
  float A[3][3], V[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      A[i][j] = R[i][j];
      V[i][j] = i == j ? 1.0f : 0.0f;
    }
  }
#pragma unroll 1
  for (int sweep = 0; sweep < 5; ++sweep) {
    rotate3<0, 1>(A, V);
    rotate3<0, 2>(A, V);
    rotate3<1, 2>(A, V);
  }
  const float w[3] = {A[0][0], A[1][1], A[2][2]};
  const float wmax = max_nan(max_nan(fabsf(w[0]), fabsf(w[1])), fabsf(w[2]));
  const float thresh = clamp_min(rcond * wmax, 1e-12f);
  float iw[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float safe = fabsf(w[k]) > 1e-30f ? w[k] : 1.0f;
    iw[k] = fabsf(w[k]) > thresh ? 1.0f / safe : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      W[i][j] = sum3(V[i][0] * iw[0] * V[j][0], V[i][1] * iw[1] * V[j][1],
                     V[i][2] * iw[2] * V[j][2]);
    }
  }
}

// Sums v over the block's threads in a fixed order: a shuffle tree in
// each warp, then the warps in order.  Threads t < NV get sum t in *total.
template <int NV>
__device__ __forceinline__ void block_sum(float (&v)[NV], float (*smem)[kSums], float* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_down_sync(kFull, v[k], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) smem[warp][k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x < NV) {
    float t = smem[0][threadIdx.x];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) t += smem[w][threadIdx.x];
    *total = t;
  }
}

template <bool kMask, bool kMoving, bool kSens>
__global__ void __launch_bounds__(kMaxThreads) gn_assembly_kernel(Args a) {
  constexpr int NV = kSens ? 33 : 27;
  __shared__ float smem[kMaxWarps][kSums];
  __shared__ int s_counts[2];
  __shared__ bool s_last;

  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  float val[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) val[k] = 0.0f;
  bool corr = false;
  bool bad = false;

  if (v < a.rows) {
    // finalize_moments_planes of scan 2's row.
    const float* s = a.sums + (size_t)v * 16;
    const float count2 = s[0];
    const float safe_n = clamp_min(count2, 1.0f);
    const float g[3] = {s[1] / safe_n, s[2] / safe_n, s[3] / safe_n};
    float m2[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) m2[j] = a.anchors[(size_t)v * 3 + j] + g[j];
    const float denom = clamp_min(count2 - 1.0f, 1.0f);
    const float c2[6] = {
        (s[4] - safe_n * (g[0] * g[0])) / denom, (s[5] - safe_n * (g[1] * g[1])) / denom,
        (s[6] - safe_n * (g[2] * g[2])) / denom, (s[7] - safe_n * (g[0] * g[1])) / denom,
        (s[8] - safe_n * (g[0] * g[2])) / denom, (s[9] - safe_n * (g[1] * g[2])) / denom};

    float B[3][3], C1[3][3], L[3], M1[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      L[i] = a.lmask[(size_t)v * 3 + i];
      M1[i] = a.mean1[(size_t)v * 3 + i];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        B[i][j] = a.basis[(size_t)v * 9 + i * 3 + j];
        C1[i][j] = a.cov1[(size_t)v * 9 + i * 3 + j];
      }
    }
    float res[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) res[j] = m2[j] - M1[j];

    corr = a.valid[v] != 0 && count2 >= a.min_pts;
    if (kMask) corr = corr && a.mask[v] != 0;
    if (kMoving) {
      // residual_compact_planes and the covariance-yaw test.
      bool bad_res = false;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float rc = L[i] * sum3(B[0][i] * res[0], B[1][i] * res[1], B[2][i] * res[2]);
        bad_res = bad_res || fabsf(rc) > a.rm_residual;
      }
      const float yaw_delta = fabsf(atan2f(-C1[0][1], C1[0][0]) - atan2f(-c2[3], c2[0]));
      bad = corr && (bad_res || yaw_delta > a.rm_yaw);
      corr = corr && !bad;
    }
    const float cm = corr ? 1.0f : 0.0f;

    // assemble_normal_equations.
    float P[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) P[i][j] = L[i] * B[j][i];
    }
    const float n1 = clamp_min(a.count1[v] - 1.0f, 1.0f);
    const float n2 = clamp_min(count2 - 1.0f, 1.0f);
    const int sym6[3][3] = {{0, 3, 4}, {3, 1, 5}, {4, 5, 2}};
    float R[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) R[i][j] = C1[i][j] / n1 + c2[sym6[i][j]] / n2;
    }
    float res_c[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      res_c[i] = sum3(P[i][0] * res[0], P[i][1] * res[1], P[i][2] * res[2]);
    float T[3][3], Rp[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j)
        T[i][j] = sum3(P[i][0] * R[0][j], P[i][1] * R[1][j], P[i][2] * R[2][j]);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j)
        Rp[i][j] = sum3(T[i][0] * P[j][0], T[i][1] * P[j][1], T[i][2] * P[j][2]);
    }
    float W[3][3];
    pinv3(Rp, a.rcond, W);

    float Hrot[3][3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
        Hrot[r][k] = sum3(__ldg(a.dR + r * 9 + 0 * 3 + k) * m2[0],
                          __ldg(a.dR + r * 9 + 1 * 3 + k) * m2[1],
                          __ldg(a.dR + r * 9 + 2 * 3 + k) * m2[2]);
    }
    float Hz[3][6];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int c = 0; c < 3; ++c) Hz[i][c] = -P[i][c];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        Hz[i][3 + k] = sum3(P[i][0] * Hrot[0][k], P[i][1] * Hrot[1][k], P[i][2] * Hrot[2][k]);
    }
    float WHz[3][6];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int c = 0; c < 6; ++c)
        WHz[i][c] = sum3(W[i][0] * Hz[0][c], W[i][1] * Hz[1][c], W[i][2] * Hz[2][c]);
    }
    float Wdz[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      Wdz[i] = sum3(W[i][0] * res_c[0], W[i][1] * res_c[1], W[i][2] * res_c[2]);

    int k = 0;
#pragma unroll
    for (int c = 0; c < 6; ++c) {
#pragma unroll
      for (int d = c; d < 6; ++d, ++k)
        val[k] = cm * sum3(Hz[0][c] * WHz[0][d], Hz[1][c] * WHz[1][d], Hz[2][c] * WHz[2][d]);
    }
#pragma unroll
    for (int c = 0; c < 6; ++c)
      val[21 + c] = cm * sum3(Hz[0][c] * Wdz[0], Hz[1][c] * Wdz[1], Hz[2][c] * Wdz[2]);

    if (kSens) {
      // A common-mode range offset moves the transformed voxel means along
      // (mu2 - t) / |mu2 - t| (solver.iteration_from_sums).
      float d3[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) d3[j] = m2[j] - __ldg(a.X + j);
      const float gn =
          sqrtf(clamp_min((d3[0] * d3[0] + d3[1] * d3[1]) + d3[2] * d3[2], 1e-12f));
      float G[3], g_c[3], Wg[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) G[j] = d3[j] / gn;
#pragma unroll
      for (int i = 0; i < 3; ++i)
        g_c[i] = sum3(P[i][0] * G[0], P[i][1] * G[1], P[i][2] * G[2]);
#pragma unroll
      for (int i = 0; i < 3; ++i)
        Wg[i] = sum3(W[i][0] * g_c[0], W[i][1] * g_c[1], W[i][2] * g_c[2]);
#pragma unroll
      for (int c = 0; c < 6; ++c)
        val[27 + c] = cm * sum3(Hz[0][c] * Wg[0], Hz[1][c] * Wg[1], Hz[2][c] * Wg[2]);
    }
    a.corr[v] = corr ? 1 : 0;
  }

  // The block's partial.
  const int n_corr = __syncthreads_count(corr);
  const int n_rej = kMoving ? __syncthreads_count(bad) : 0;
  float total = 0.0f;
  block_sum<NV>(val, smem, &total);
  float* part = a.scratch + (size_t)blockIdx.x * kStride;
  if (threadIdx.x < NV) part[threadIdx.x] = total;
  if (threadIdx.x == 0) {
    reinterpret_cast<int*>(part)[kSums] = n_corr;
    reinterpret_cast<int*>(part)[kSums + 1] = n_rej;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(&g_ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;

  // The last block: the partials in block order.
  __threadfence();
  float acc[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) acc[k] = 0.0f;
  if (threadIdx.x < 2) s_counts[threadIdx.x] = 0;
  int nc = 0, nr = 0;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += blockDim.x) {
    const float* pb = a.scratch + (size_t)b * kStride;
#pragma unroll
    for (int k = 0; k < NV; ++k) acc[k] += __ldcg(pb + k);
    nc += __ldcg(reinterpret_cast<const int*>(pb) + kSums);
    nr += __ldcg(reinterpret_cast<const int*>(pb) + kSums + 1);
  }
  __syncthreads();
  atomicAdd(&s_counts[0], nc);  // integers: exact in any order
  atomicAdd(&s_counts[1], nr);
  block_sum<NV>(acc, smem, &total);
  if (threadIdx.x < 21) {
    // upper-triangle index k -> (c, d)
    int c = 0, k = threadIdx.x;
    while (k >= 6 - c) {
      k -= 6 - c;
      ++c;
    }
    const int d = c + k;
    a.out[c * 6 + d] = total;
    a.out[d * 6 + c] = total;
  } else if (threadIdx.x < NV) {
    a.out[36 + threadIdx.x - 21] = total;
  }
  if (threadIdx.x == 0) {
    a.counts[0] = s_counts[0];
    a.counts[1] = s_counts[1];
    g_ticket = 0;
  }
}

template <bool kMask, bool kMoving>
const void* pick(bool sens) {
  return sens ? reinterpret_cast<const void*>(gn_assembly_kernel<kMask, kMoving, true>)
              : reinterpret_cast<const void*>(gn_assembly_kernel<kMask, kMoving, false>);
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = ok).
// Every array is a contiguous device array, float32 unless said: sums (rows,
// 16), anchors (rows, 3), the model's count (rows,), mean (rows, 3), cov and
// basis (rows, 3, 3), lmask (rows, 3), valid (rows,) bool; mask (rows,)
// bool or null; X (6,); dR (3, 3, 3).  `moving` turns the moving-object
// test on, `sens` the range sensitivity.  `blocks` blocks of `threads`
// (a multiple of 32, at most 256) cover the rows; scratch holds blocks * 35
// words.  Writes corr (rows,) bool, out (48,) and counts (2,) int32.
int icet_gn_assembly(const void* sums, const void* anchors, const void* count1,
                     const void* mean1, const void* cov1, const void* basis,
                     const void* lmask, const void* valid, const void* mask,
                     const void* X, const void* dR, int rows, float min_pts, float rcond,
                     int moving, float rm_residual, float rm_yaw, int sens, int blocks,
                     int threads, void* scratch, void* corr, void* out, void* counts,
                     void* stream) {
  if (rows < 1 || threads < 32 || threads > kMaxThreads || threads % 32
      || (long long)blocks * threads < rows)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.sums = static_cast<const float*>(sums);
  a.anchors = static_cast<const float*>(anchors);
  a.count1 = static_cast<const float*>(count1);
  a.mean1 = static_cast<const float*>(mean1);
  a.cov1 = static_cast<const float*>(cov1);
  a.basis = static_cast<const float*>(basis);
  a.lmask = static_cast<const float*>(lmask);
  a.valid = static_cast<const uint8_t*>(valid);
  a.mask = static_cast<const uint8_t*>(mask);
  a.X = static_cast<const float*>(X);
  a.dR = static_cast<const float*>(dR);
  a.rows = rows;
  a.min_pts = min_pts;
  a.rcond = rcond;
  a.rm_residual = rm_residual;
  a.rm_yaw = rm_yaw;
  a.scratch = static_cast<float*>(scratch);
  a.corr = static_cast<uint8_t*>(corr);
  a.out = static_cast<float*>(out);
  a.counts = static_cast<int*>(counts);
  const bool has_mask = mask != nullptr;
  const bool s = sens != 0;
  const void* kernel = has_mask ? (moving ? pick<true, true>(s) : pick<true, false>(s))
                                : (moving ? pick<false, true>(s) : pick<false, false>(s));
  void* args[] = {&a};
  cudaError_t err = cudaLaunchKernel(kernel, dim3(blocks), dim3(threads), args, 0,
                                     static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* icet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
