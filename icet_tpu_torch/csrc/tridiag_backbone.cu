// Block-tridiagonal backbone of the pose graph's sparse Gauss-Newton step:
// its block Cholesky (the factor) and the forward and backward block
// substitution sweeps that apply its inverse (the apply), 6x6 float32
// blocks over K poses.
//
// Replaces icet_tpu/pose_graph.py::_tridiag_factor and ::_tridiag_apply
// (:193-245), which run the recurrences under lax.scan.  That is not a
// Pallas kernel: the TPU package leaves the loop to XLA as one device loop.
// In plain PyTorch every step of it is several launches (about 5e6 steps
// on a 10,000-pose solve), so here each factor and each apply is one
// launch, and one warp carries the whole recurrence.
//
// Factor: S_0 = D_0, S_k = D_k - E_{k-1}^T S_{k-1}^{-1} E_{k-1}; returns
// S_inv_k = S_k^{-1} (K, 6, 6) and U_k = S_k^{-1} E_k (K-1, 6, 6).  Each
// inverse is the JAX package's _spd_inv6: the Cholesky factor L of the
// symmetrised block ((S + S^T) / 2, as jnp.linalg.cholesky symmetrises),
// L^-1 by forward substitution, then L^-T L^-1.  A block whose Cholesky
// fails (a pivot that is not > 0) or whose inverse is not finite falls back
// to the inverse of D_k, with U = 0, exactly as :212-217 (not for k = 0).
//
// Apply: z_0 = r_0, z_k = r_k - U_{k-1}^T z_{k-1}; then y_{K-1} =
// S_inv_{K-1} z_{K-1}, y_k = S_inv_k z_k - U_k y_{k+1}.
//
// Bound on the card: the work is K dependent steps, each a chain of small
// dense operations; the bytes (144 B a block) and operations (about 1,500
// flop a factor step, 216 an apply step) are microseconds at the card's
// rates, so latency sets the time: the dependent operations of one step
// times K.  Design for that, kept simple:
// - one warp; every 6x6 block lives in shared memory, one entry (or two) a
//   lane for the products, __syncwarp between phases; the Cholesky is one
//   lane's serial loop, the triangular inverse six lanes, one column each;
// - the factor loads the next step's D and E into registers before it
//   computes this step's, so their latency hides behind the step;
// - the apply stages kChunk steps of its inputs into shared memory with all
//   lanes at once, then six lanes (one a row) run the chunk's steps, each
//   step's vector passed between lanes by shuffles.
// No host synchronisation and nothing allocated: the wrapper allocates the
// outputs.  The apply writes S_inv_k z_k into y during the forward sweep and
// overwrites it in place during the backward sweep.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kB = 6;
constexpr int kBB = kB * kB;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 128;

// out = spd_inv6(A): A, L, Linv, out each a 36-float shared block.  Returns
// (to every lane) whether every entry of out is finite and the Cholesky
// found every pivot > 0.
__device__ bool spd_inv6(const float* A, float* L, float* Linv, float* out, int lane) {
  // Lane 0: Cholesky of (A + A^T) / 2, lower triangle only (the upper one
  // is never read); a pivot that is not > 0 (or NaN) makes the factor NaN,
  // as a failed potrf makes JAX's.
  if (lane == 0) {
    bool ok = true;
    for (int j = 0; j < kB; ++j) {
      float s = A[j * kB + j];
      for (int k = 0; k < j; ++k) s = s - L[j * kB + k] * L[j * kB + k];
      if (!(s > 0.0f)) ok = false;
      const float d = ok ? sqrtf(s) : __int_as_float(0x7fc00000);
      L[j * kB + j] = d;
      for (int i = j + 1; i < kB; ++i) {
        float t = 0.5f * (A[i * kB + j] + A[j * kB + i]);
        for (int k = 0; k < j; ++k) t = t - L[i * kB + k] * L[j * kB + k];
        L[i * kB + j] = t / d;
      }
    }
  }
  __syncwarp();
  // Lanes 0-5: column c of L^-1 by forward substitution of L x = e_c.
  if (lane < kB) {
    const int c = lane;
    for (int i = 0; i < kB; ++i) {
      float t = (i == c) ? 1.0f : 0.0f;
      for (int k = 0; k < i; ++k) t = t - L[i * kB + k] * Linv[k * kB + c];
      Linv[i * kB + c] = t / L[i * kB + i];
    }
  }
  __syncwarp();
  // out = Linv^T Linv.
  bool fin = true;
  for (int e = lane; e < kBB; e += 32) {
    const int i = e / kB, j = e % kB;
    float t = 0.0f;
    for (int m = 0; m < kB; ++m) t = t + Linv[m * kB + i] * Linv[m * kB + j];
    out[e] = t;
    fin = fin && isfinite(t);
  }
  __syncwarp();
  return __all_sync(kFull, fin);
}

__global__ void __launch_bounds__(32) tridiag_factor_kernel(
    const float* __restrict__ diag_d, const float* __restrict__ E, int K,
    float* __restrict__ S_inv, float* __restrict__ U) {
  __shared__ float Sp[kBB];   // S_{k-1}^{-1}
  __shared__ float D[kBB], Ek[kBB], Uk[kBB], S[kBB], L[kBB], Li[kBB], Si[kBB];
  const int lane = threadIdx.x;

  for (int e = lane; e < kBB; e += 32) D[e] = diag_d[e];
  __syncwarp();
  spd_inv6(D, L, Li, Sp, lane);  // k = 0: no fallback, as the JAX package
  for (int e = lane; e < kBB; e += 32) S_inv[e] = Sp[e];

  // Registers holding the next step's D and E (entries lane and lane + 32).
  float dn0 = 0.0f, dn1 = 0.0f, en0 = 0.0f, en1 = 0.0f;
  if (K > 1) {
    dn0 = diag_d[kBB + lane];
    en0 = E[lane];
    if (lane + 32 < kBB) {
      dn1 = diag_d[kBB + lane + 32];
      en1 = E[lane + 32];
    }
  }
  for (int k = 1; k < K; ++k) {
    D[lane] = dn0;
    Ek[lane] = en0;
    if (lane + 32 < kBB) {
      D[lane + 32] = dn1;
      Ek[lane + 32] = en1;
    }
    if (k + 1 < K) {
      const size_t nd = (size_t)(k + 1) * kBB, ne = (size_t)k * kBB;
      dn0 = diag_d[nd + lane];
      en0 = E[ne + lane];
      if (lane + 32 < kBB) {
        dn1 = diag_d[nd + lane + 32];
        en1 = E[ne + lane + 32];
      }
    }
    __syncwarp();
    // U = S_{k-1}^{-1} E_{k-1}.
    for (int e = lane; e < kBB; e += 32) {
      const int i = e / kB, j = e % kB;
      float t = 0.0f;
      for (int m = 0; m < kB; ++m) t = t + Sp[i * kB + m] * Ek[m * kB + j];
      Uk[e] = t;
    }
    __syncwarp();
    // S_k = D_k - E_{k-1}^T U.
    for (int e = lane; e < kBB; e += 32) {
      const int i = e / kB, j = e % kB;
      float t = 0.0f;
      for (int m = 0; m < kB; ++m) t = t + Ek[m * kB + i] * Uk[m * kB + j];
      S[e] = D[e] - t;
    }
    __syncwarp();
    bool ok = spd_inv6(S, L, Li, Si, lane);
    if (!ok) {
      // Non-SPD round-off: this block degrades to block-Jacobi.
      spd_inv6(D, L, Li, Si, lane);
    }
    for (int e = lane; e < kBB; e += 32) {
      const float u = ok ? Uk[e] : 0.0f;
      Sp[e] = Si[e];
      S_inv[(size_t)k * kBB + e] = Si[e];
      U[(size_t)(k - 1) * kBB + e] = u;
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(32) tridiag_apply_kernel(
    const float* __restrict__ S_inv, const float* __restrict__ U,
    const float* __restrict__ r, int K, float* __restrict__ y) {
  __shared__ float sU[kChunk * kBB];
  __shared__ float sS[kChunk * kBB];
  __shared__ float sv[kChunk * kB];
  const int lane = threadIdx.x;
  const int a = lane < kB ? lane : 0;  // the row this lane carries

  // Forward sweep, writing S_inv_k z_k to y.  Chunk c holds steps
  // [k0, k0 + n): S_inv_k and r_k, and U_{k-1} for k >= 1.
  float z = 0.0f;  // lane a: z_{k-1}[a]
  for (int k0 = 0; k0 < K; k0 += kChunk) {
    const int n = min(kChunk, K - k0);
    for (int e = lane; e < n * kBB; e += 32) {
      const size_t g = (size_t)k0 * kBB + e;
      sS[e] = S_inv[g];
      sU[e] = (k0 + e / kBB >= 1) ? U[g - kBB] : 0.0f;
    }
    for (int e = lane; e < n * kB; e += 32) sv[e] = r[(size_t)k0 * kB + e];
    __syncwarp();
    for (int s = 0; s < n; ++s) {
      const float* u = sU + s * kBB;
      float t = 0.0f;
      for (int b = 0; b < kB; ++b) t = t + u[b * kB + a] * __shfl_sync(kFull, z, b);
      z = (k0 + s == 0) ? sv[s * kB + a] : sv[s * kB + a] - t;
      const float* si = sS + s * kBB;
      float q = 0.0f;
      for (int b = 0; b < kB; ++b) q = q + si[a * kB + b] * __shfl_sync(kFull, z, b);
      if (lane < kB) y[(size_t)(k0 + s) * kB + a] = q;
    }
    __syncwarp();
  }

  // Backward sweep: y_k = Sz_k - U_k y_{k+1}, chunks from the end.  Chunk
  // holds steps [k0, k0 + n) with U_k for k <= K - 2.
  float w = 0.0f;  // lane a: y_{k+1}[a]
  for (int end = K; end > 0; end -= kChunk) {
    const int k0 = max(0, end - kChunk), n = end - k0;
    for (int e = lane; e < n * kBB; e += 32) {
      const size_t g = (size_t)k0 * kBB + e;
      sU[e] = (k0 + e / kBB <= K - 2) ? U[g] : 0.0f;
    }
    for (int e = lane; e < n * kB; e += 32) sv[e] = y[(size_t)k0 * kB + e];
    __syncwarp();
    for (int s = n - 1; s >= 0; --s) {
      const float* u = sU + s * kBB;
      float t = 0.0f;
      for (int b = 0; b < kB; ++b) t = t + u[a * kB + b] * __shfl_sync(kFull, w, b);
      w = (k0 + s == K - 1) ? sv[s * kB + a] : sv[s * kB + a] - t;
      if (lane < kB) y[(size_t)(k0 + s) * kB + a] = w;
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" {

// Factor of the (K, 6, 6) diagonal blocks diag_d and the (K-1, 6, 6)
// super-diagonal blocks E into S_inv (K, 6, 6) and U (K-1, 6, 6); float32
// device arrays, one launch of one warp on `stream`.  Returns
// cudaGetLastError() (0 = ok).
int icet_tridiag_factor(const void* diag_d, const void* E, int K, void* S_inv, void* U,
                        void* stream) {
  tridiag_factor_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(diag_d), static_cast<const float*>(E), K,
      static_cast<float*>(S_inv), static_cast<float*>(U));
  return (int)cudaGetLastError();
}

// y (K, 6) = M^-1 r for the factored backbone (S_inv, U); r (K, 6); float32
// device arrays, one launch of one warp on `stream`.  Returns
// cudaGetLastError() (0 = ok).
int icet_tridiag_apply(const void* S_inv, const void* U, const void* r, int K, void* y,
                       void* stream) {
  tridiag_apply_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(S_inv), static_cast<const float*>(U),
      static_cast<const float*>(r), K, static_cast<float*>(y));
  return (int)cudaGetLastError();
}

const char* icet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
