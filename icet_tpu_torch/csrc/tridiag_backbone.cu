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
// launch: one warp carries the recurrence, a second feeds it its inputs.
//
// Factor: S_0 = D_0, S_k = D_k - E_{k-1}^T S_{k-1}^{-1} E_{k-1}; returns
// S_inv_k = S_k^{-1} (K, 6, 6) and U_k = S_k^{-1} E_k (K-1, 6, 6).  A block
// whose Cholesky meets a pivot that is not > 0, or whose inverse is not
// finite in float32, takes the inverse of D_k and U_{k-1} = 0 (block-Jacobi
// for that block), exactly as :212-217 (not for k = 0, whose failed factor
// is NaN as a failed potrf makes JAX's).  D is symmetrised, (D + D^T) / 2,
// as jnp.linalg.cholesky symmetrises its input.
//
// Apply: z_0 = r_0, z_k = r_k - U_{k-1}^T z_{k-1}; then y_{K-1} =
// S_inv_{K-1} z_{K-1}, y_k = S_inv_k z_k - U_k y_{k+1}.
//
// What bounds it on the card: neither bytes (144 B a block, 2.9 MB a
// 10,000-pose factor: ~1 us at the card's rate) nor operations, but the K
// dependent steps: the time is K times the latency of one step's chain of
// dependent instructions.  The design puts on that chain only what the next
// step needs and keeps memory off it:
// - Factor.  With L_k the Cholesky factor of S_k and W = L_k^{-1} E_k,
//   S_{k+1} = D_{k+1} - W^T W.  The chain is: Cholesky of S_k (every lane
//   the same, in registers: no lane waits for another's pivot) -> W by
//   forward substitution (lane (a, b) of the 21 lower-triangle lanes solves
//   for W's columns a and b) -> S_{k+1}[a][b] = D - W_a . W_b -> the 21
//   entries to every lane through one shared-memory slot a step.  The
//   outputs are off the chain, in the same lanes between the chain's
//   dependent instructions: column a of S_inv_k = L^-T L^-1 e_a by two
//   substitutions and column a of U_k = L_k^-T W_a, stored when the next
//   step has shown no fallback (which zeroes U_k).
// - The Cholesky takes one reciprocal square root a pivot and multiplies by
//   it: no division and no square root on the chain.  The chain runs in
//   float64 (the reciprocal square root from float32 rsqrtf and one Newton
//   step): the recurrence's last blocks cancel (S_{K-1} = D - E^T S^-1 E
//   with D close to E^T S^-1 E on a 10,000-pose ring), where any float32
//   evaluation lands ~1e-4 of the block from the exact value; in float64 the
//   kernel is exact to the outputs' float32 rounding, and its distance to
//   the plain float32 version is that version's own error.
// - The fallback is lazy: a failed pivot is known when the Cholesky ends
//   and a non-finite inverse when the outputs are formed; only then is the
//   step taken again from D_k.
// - Apply.  Lane a (of six) carries z_k[a] (then y_k[a]); a step is six
//   broadcasts of the previous vector, six products and a pairwise sum of
//   depth three.  One thread carrying the whole vector would issue the
//   step's 72 float32 operations (no fused multiply-add, -fmad=false)
//   alone.  S_inv_k z_k is formed a step later from the same broadcasts,
//   off the chain.  A whole chunk of steps is unrolled so that each step's
//   shared-memory reads issue ahead of it.  What a step then costs on the
//   card is mostly the warp's memory-pipe instructions (six shuffles, the
//   ring reads, the store of y), not its arithmetic chain.
// - Inputs stream through a ring of kStages stages of kChunk steps in
//   shared memory.  A second warp (the producer) fills each stage with one
//   bulk copy an array (the tensor memory accelerator), completing on the
//   stage's "full" mbarrier, as soon as the recurrence's warp has released
//   the stage on its "empty" one: no load and no fill sits on the chain,
//   and the chain's warp spends one wait and one arrival a chunk on it.
// No host synchronisation and nothing allocated: the wrapper allocates the
// outputs.  The apply writes S_inv_k z_k into y during the forward sweep and
// overwrites it in place during the backward sweep.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_addr;

constexpr int kB = 6;
constexpr int kBB = kB * kB;
constexpr int kTri = 21;  // entries of a lower triangle
constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 32;  // steps a ring stage
constexpr int kStages = 4;  // ring stages: kStages - 1 chunks in flight

// ---- the ring of input chunks ----------------------------------------------

// n floats to copy from src (device memory) to dst (shared memory).
struct Piece {
  float* dst;
  const float* src;
  int n;
};

// Whether the tensor memory accelerator can take the piece in one bulk
// copy: 16-byte aligned ends and a multiple of 16 bytes.
__device__ __forceinline__ bool bulk_ok(const Piece& p) {
  return ((reinterpret_cast<uintptr_t>(p.src) | smem_addr(p.dst) | (4u * p.n)) & 15) == 0;
}

// Fills one stage: lane 0 issues a bulk copy a piece, all completing on the
// stage's mbarrier `bar`.  A piece the bulk copy cannot take (a misaligned
// tensor, or the last 24 bytes of an odd-length (K, 6) chunk) is copied by
// the lanes themselves before the barrier is armed.
template <int N>
__device__ __forceinline__ void stage_fill(uint64_t* bar, const Piece (&p)[N], int lane) {
  uint32_t bytes = 0;
  bool by_lanes = false;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (p[i].n <= 0) continue;
    if (bulk_ok(p[i]))
      bytes += 4u * p[i].n;
    else
      by_lanes = true;
  }
  if (by_lanes) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (p[i].n > 0 && !bulk_ok(p[i]))
        for (int e = lane; e < p[i].n; e += 32) p[i].dst[e] = p[i].src[e];
    __syncwarp();
  }
  if (lane == 0) {
    // The stage's earlier reads (generic proxy) before the copies' writes.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
                 "r"(bytes)
                 : "memory");
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (p[i].n > 0 && bulk_ok(p[i]))
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
            "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(p[i].dst)),
            "l"(p[i].src), "r"(4u * p[i].n), "r"(smem_addr(bar))
            : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// The ring's barriers, one arrival a phase each: full[s] completes when
// stage s holds its chunk (the producer's arrival and the bulk copies'
// bytes), empty[s] when the consumer is done reading it.  Walk step w,
// counted over all of a kernel's sweeps, uses stage w % kStages in its
// round w / kStages.
struct Ring {
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

// Thread 0, before a __syncthreads().
__device__ __forceinline__ void ring_init(Ring& ring) {
#pragma unroll
  for (int i = 0; i < kStages; ++i) {
    mbar_init(&ring.full[i], 1);
    mbar_init(&ring.empty[i], 1);
  }
}

// The producer warp: fills walk steps w0 .. w0 + n - 1 in order, each once
// the consumer has released its stage's previous round (the first round
// finds every stage free).  fill(j, stage) fills a stage with walk step
// w0 + j's chunk.
template <typename Fill>
__device__ __forceinline__ void ring_produce(Ring& ring, int w0, int n, Fill fill) {
  for (int j = 0; j < n; ++j) {
    const int w = w0 + j;
    mbar_wait(&ring.empty[w % kStages], ((w / kStages) & 1) ^ 1);
    fill(j, w % kStages);
  }
}

// The consumer warp, before reading walk step w's stage.
__device__ __forceinline__ void ring_wait(Ring& ring, int w) {
  mbar_wait(&ring.full[w % kStages], (w / kStages) & 1);
}

// The consumer warp, done with walk step w's stage.
__device__ __forceinline__ void ring_release(Ring& ring, int w, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(&ring.empty[w % kStages]);
}

// ---- the factor's arithmetic, in float64 ------------------------------------

__host__ __device__ constexpr int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// 1 / sqrt(s) for s > 0 (float32 reciprocal square root, one Newton step:
// relative error ~1e-13), NaN otherwise.
__device__ __forceinline__ double rsqrt_pos(double s) {
  const double r0 = (double)rsqrtf((float)s);
  const double r = r0 * (1.5 - (0.5 * s) * (r0 * r0));
  return s > 0.0 ? r : __longlong_as_double(0x7ff8000000000000ll);
}

// In place, the lower triangle a (row-major, tri()) of an SPD block becomes
// its Cholesky factor's strictly lower part; ri[j] = 1 / L[j][j].  Returns
// whether every pivot was > 0 (a failed pivot makes what follows NaN).
__device__ __forceinline__ bool cholesky(double (&a)[kTri], double (&ri)[kB]) {
  bool ok = true;
#pragma unroll
  for (int j = 0; j < kB; ++j) {
    const double s = a[tri(j, j)];
    ok = ok && s > 0.0;
    const double r = rsqrt_pos(s);
    ri[j] = r;
#pragma unroll
    for (int i = j + 1; i < kB; ++i) a[tri(i, j)] = a[tri(i, j)] * r;
#pragma unroll
    for (int i = j + 1; i < kB; ++i)
#pragma unroll
      for (int m = j + 1; m <= i; ++m) a[tri(i, m)] = a[tri(i, m)] - a[tri(i, j)] * a[tri(m, j)];
  }
  return ok;
}

// x = L^-1 b (forward substitution; each row's sum in the order of m).
__device__ __forceinline__ void lower_solve(const double (&L)[kTri], const double (&ri)[kB],
                                            double (&x)[kB]) {
#pragma unroll
  for (int i = 0; i < kB; ++i) {
    double t = x[i];
#pragma unroll
    for (int m = 0; m < i; ++m) t = t - L[tri(i, m)] * x[m];
    x[i] = t * ri[i];
  }
}

// y = L^-T y (backward substitution; each row's sum from m = 5 down).
__device__ __forceinline__ void upper_solve(const double (&L)[kTri], const double (&ri)[kB],
                                            double (&y)[kB]) {
#pragma unroll
  for (int i = kB - 1; i >= 0; --i) {
    double t = y[i];
#pragma unroll
    for (int m = kB - 1; m > i; --m) t = t - L[tri(m, i)] * y[m];
    y[i] = t * ri[i];
  }
}

// The lower triangle of (D + D^T) / 2 for a 36-float block in device memory.
__device__ __forceinline__ void sym_lower(const float* D, double (&a)[kTri]) {
#pragma unroll
  for (int i = 0; i < kB; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j)
      a[tri(i, j)] = 0.5 * ((double)D[i * kB + j] + (double)D[j * kB + i]);
}

// Warp 0 runs the recurrence; warp 1 fills the ring.
__global__ void __launch_bounds__(64) tridiag_factor_kernel(
    const float* __restrict__ diag_d, const float* __restrict__ E, int K,
    float* __restrict__ S_inv, float* __restrict__ U) {
  // Ring slot k (walk step k / kChunk) holds D_{k+1} and E_k: what step k's
  // chain needs to form S_{k+1}.
  __shared__ __align__(16) float sD[kStages][kChunk * kBB];
  __shared__ __align__(16) float sE[kStages][kChunk * kBB];
  __shared__ __align__(16) double sS[2][kTri + 1];  // S_{k+1}'s lower triangle, by parity
  __shared__ Ring ring;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) ring_init(ring);
  __syncthreads();
  const int n_chunks = (K + kChunk - 1) / kChunk;
  if (threadIdx.x >= 32) {
    ring_produce(ring, 0, n_chunks, [&](int c, int st) {
      const int k0 = c * kChunk, n = min(kChunk, K - 1 - k0);
      const Piece p[2] = {{sD[st], diag_d + (size_t)(k0 + 1) * kBB, n * kBB},
                          {sE[st], E + (size_t)k0 * kBB, n * kBB}};
      stage_fill(&ring.full[st], p, lane);
    });
    return;
  }
  // This lane's pair (a, b), a >= b, of the lower triangle; lanes 21-31
  // repeat lanes 0-10 and write nothing.
  const int l = lane % kTri;
  int a = 0;
  while (tri(a + 1, 0) <= l) ++a;
  const int b = l - tri(a, 0);
  const bool owner = lane < kTri;         // writes its entry of S_{k+1}
  const bool col_owner = lane < kTri && a == b;  // stores column a

  float u_prev[kB];  // column a of U_{k-1} as formed, stored once S_k holds
#pragma unroll
  for (int i = 0; i < kB; ++i) u_prev[i] = 0.0f;

  for (int k = 0; k < K; ++k) {
    const int s = k % kChunk;
    if (s == 0) ring_wait(ring, k / kChunk);
    const float* Dn = sD[(k / kChunk) % kStages] + s * kBB;  // D_{k+1}
    const float* En = sE[(k / kChunk) % kStages] + s * kBB;  // E_k
    // Off the chain: this step's inputs to the next (garbage at k = K - 1,
    // where nothing uses them).
    float ea[kB], eb[kB];
#pragma unroll
    for (int m = 0; m < kB; ++m) {
      ea[m] = En[m * kB + a];
      eb[m] = En[m * kB + b];
    }
    const double d_ab = 0.5 * ((double)Dn[a * kB + b] + (double)Dn[b * kB + a]);

    // S_k's lower triangle, the same in every lane, becomes L_k.
    double L[kTri], ri[kB];
    if (k == 0) {
      sym_lower(diag_d, L);
    } else {
#pragma unroll
      for (int e = 0; e < kTri; ++e) L[e] = sS[(k - 1) & 1][e];
    }
    const bool piv_ok = cholesky(L, ri);
    bool fallback = false;
    float col[kB];
    float u_next[kB];
    for (bool force = false;; force = true) {
      if (k > 0 && (!piv_ok || force)) {
        // Block-Jacobi for this block: S_k^{-1} = D_k^{-1}, U_{k-1} = 0.
        fallback = true;
        sym_lower(diag_d + (size_t)k * kBB, L);
        cholesky(L, ri);
      }
      // Column a of S_inv_k = L^-T L^-1 e_a.
      double x[kB];
#pragma unroll
      for (int i = 0; i < kB; ++i) x[i] = (i == a) ? 1.0 : 0.0;
      lower_solve(L, ri, x);
      upper_solve(L, ri, x);
      bool fin = true;
#pragma unroll
      for (int i = 0; i < kB; ++i) {
        col[i] = (float)x[i];
        fin = fin && isfinite(col[i]);
      }
      // The chain: W's columns a and b, S_{k+1}[a][b], to every lane.
      double wa[kB], wb[kB];
#pragma unroll
      for (int m = 0; m < kB; ++m) {
        wa[m] = (double)ea[m];
        wb[m] = (double)eb[m];
      }
      lower_solve(L, ri, wa);
      lower_solve(L, ri, wb);
      double t = wa[0] * wb[0];
#pragma unroll
      for (int m = 1; m < kB; ++m) t = t + wa[m] * wb[m];
      double* slot = sS[k & 1];
      if (owner) slot[l] = d_ab - t;
      // Off the chain: column a of U_k = L^-T W_a.
      upper_solve(L, ri, wa);
#pragma unroll
      for (int i = 0; i < kB; ++i) u_next[i] = (float)wa[i];
      __syncwarp();
      if (k == 0 || fallback || __all_sync(kFull, fin)) break;
      // A finite factor whose inverse is not finite in float32: take the
      // step again from D_k.
    }
    if (col_owner) {
      float* so = S_inv + (size_t)k * kBB + a;
#pragma unroll
      for (int i = 0; i < kB; ++i) so[i * kB] = col[i];
      if (k > 0) {
        float* uo = U + (size_t)(k - 1) * kBB + a;
#pragma unroll
        for (int i = 0; i < kB; ++i) uo[i * kB] = fallback ? 0.0f : u_prev[i];
      }
    }
#pragma unroll
    for (int i = 0; i < kB; ++i) u_prev[i] = u_next[i];
    if (s == kChunk - 1 || k == K - 1) ring_release(ring, k / kChunk, lane);
  }
}

// ---- the apply --------------------------------------------------------------

// The six floats at p (8-byte aligned shared memory), as three 8-byte loads.
__device__ __forceinline__ void load6(const float* p, float (&v)[kB]) {
  const float2* q = reinterpret_cast<const float2*>(p);
#pragma unroll
  for (int i = 0; i < kB / 2; ++i) {
    const float2 t = q[i];
    v[2 * i] = t.x;
    v[2 * i + 1] = t.y;
  }
}

// p[0] + ... + p[5] as ((p0 + p1) + (p2 + p3)) + (p4 + p5).
__device__ __forceinline__ float sum6(const float (&p)[kB]) {
  return ((p[0] + p[1]) + (p[2] + p[3])) + (p[4] + p[5]);
}

// b - (p[0] + ... + p[5]) as ((b - p0) - (p1 + p2)) - ((p3 + p4) + p5):
// depth three after the products.
__device__ __forceinline__ float minus_sum6(float b, const float (&p)[kB]) {
  return ((b - p[0]) - (p[1] + p[2])) - ((p[3] + p[4]) + p[5]);
}

// The rows k0 .. k0 + n - 1 of a (K, 6) array: the even count by one bulk
// copy, an odd last row by the lanes.
__device__ __forceinline__ void vec_pieces(Piece* p, float* dst, const float* src, int n) {
  const int even = (n & ~1) * kB;
  p[0] = {dst, src, even};
  p[1] = {dst + even, src + even, (n & 1) * kB};
}

// Runs step(s) for s = 0 .. n - 1 (or n - 1 .. 0), unrolled over a whole
// chunk so that each step's loads are issued ahead of the chain.
template <bool kDown, typename Step>
__device__ __forceinline__ void chunk_steps(int n, Step step) {
  if (n == kChunk) {
#pragma unroll
    for (int i = 0; i < kChunk; ++i) step(kDown ? kChunk - 1 - i : i);
  } else {
    for (int i = 0; i < n; ++i) step(kDown ? n - 1 - i : i);
  }
}

// Warp 0 runs the two sweeps; warp 1 fills the ring.
__global__ void __launch_bounds__(64) tridiag_apply_kernel(
    const float* __restrict__ S_inv, const float* __restrict__ U,
    const float* __restrict__ r, int K, float* __restrict__ y) {
  // Forward ring slot k (walk step k / kChunk): U_{k-1} (k >= 1), S_inv_k,
  // r_k.  Backward ring slot k (walk step n_chunks + the chunk's place from
  // the end): U_k (k <= K - 2), S_inv_k z_k (in sv).
  __shared__ __align__(16) float sU[kStages][kChunk * kBB];
  __shared__ __align__(16) float sS[kStages][kChunk * kBB];
  __shared__ __align__(16) float sv[kStages][kChunk * kB];
  __shared__ Ring ring;
  __shared__ uint64_t forward_done;  // the forward sweep's y is written
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    ring_init(ring);
    mbar_init(&forward_done, 1);
  }
  __syncthreads();
  const int n_chunks = (K + kChunk - 1) / kChunk;

  if (threadIdx.x >= 32) {
    ring_produce(ring, 0, n_chunks, [&](int c, int st) {
      const int k0 = c * kChunk, n = min(kChunk, K - k0);
      const int u0 = max(k0, 1);  // first step with a U_{k-1}
      Piece p[4] = {{sU[st] + (u0 - k0) * kBB, U + (size_t)(u0 - 1) * kBB, (k0 + n - u0) * kBB},
                    {sS[st], S_inv + (size_t)k0 * kBB, n * kBB}};
      vec_pieces(p + 2, sv[st], r + (size_t)k0 * kB, n);
      stage_fill(&ring.full[st], p, lane);
    });
    mbar_wait(&forward_done, 0);
    ring_produce(ring, n_chunks, n_chunks, [&](int j, int st) {
      const int k0 = (n_chunks - 1 - j) * kChunk, n = min(kChunk, K - k0);
      Piece p[3] = {{sU[st], U + (size_t)k0 * kBB, min(n, K - 1 - k0) * kBB}};
      vec_pieces(p + 1, sv[st], y + (size_t)k0 * kB, n);
      stage_fill(&ring.full[st], p, lane);
    });
    return;
  }
  const int a = lane < kB ? lane : 0;  // the entry this lane carries
  const bool writer = lane < kB;

  // Forward sweep: z_k, and S_inv_{k-1} z_{k-1} into y at step k.
  float z = 0.0f;       // z_{k-1}[a]
  float srow[kB] = {};  // row a of S_inv_{k-1}
  for (int c = 0; c < n_chunks; ++c) {
    ring_wait(ring, c);
    const int st = c % kStages, k0 = c * kChunk;
    chunk_steps<false>(min(kChunk, K - k0), [&](int s) {
      float ut[kB], zb[kB], p[kB], q[kB];
#pragma unroll
      for (int m = 0; m < kB; ++m) ut[m] = sU[st][s * kBB + m * kB + a];  // U_{k-1}[m][a]
      const float rk = sv[st][s * kB + a];
#pragma unroll
      for (int m = 0; m < kB; ++m) zb[m] = __shfl_sync(kFull, z, m);
#pragma unroll
      for (int m = 0; m < kB; ++m) {
        p[m] = ut[m] * zb[m];
        q[m] = srow[m] * zb[m];
      }
      const int k = k0 + s;
      z = (k == 0) ? rk : minus_sum6(rk, p);
      if (k > 0 && writer) y[(size_t)(k - 1) * kB + a] = sum6(q);
      load6(sS[st] + s * kBB + a * kB, srow);
    });
    ring_release(ring, c, lane);
  }
  {
    float zb[kB], q[kB];
#pragma unroll
    for (int m = 0; m < kB; ++m) {
      zb[m] = __shfl_sync(kFull, z, m);
      q[m] = srow[m] * zb[m];
    }
    if (writer) y[(size_t)(K - 1) * kB + a] = sum6(q);
  }
  // The forward sweep's y (generic proxy) before the producer's bulk reads.
  __threadfence();
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  __syncwarp();
  if (lane == 0) mbar_arrive(&forward_done);

  // Backward sweep, chunks from the last: y_k = S_inv_k z_k - U_k y_{k+1}.
  float w = 0.0f;  // y_{k+1}[a]
  for (int j = 0; j < n_chunks; ++j) {
    ring_wait(ring, n_chunks + j);
    const int st = (n_chunks + j) % kStages, k0 = (n_chunks - 1 - j) * kChunk;
    chunk_steps<true>(min(kChunk, K - k0), [&](int s) {
      float u[kB], wb[kB], p[kB];
      load6(sU[st] + s * kBB + a * kB, u);  // row a of U_k
      const float sz = sv[st][s * kB + a];
#pragma unroll
      for (int m = 0; m < kB; ++m) wb[m] = __shfl_sync(kFull, w, m);
#pragma unroll
      for (int m = 0; m < kB; ++m) p[m] = u[m] * wb[m];
      const int k = k0 + s;
      w = (k == K - 1) ? sz : minus_sum6(sz, p);
      if (writer) y[(size_t)k * kB + a] = w;
    });
    ring_release(ring, n_chunks + j, lane);
  }
}

}  // namespace

extern "C" {

// Factor of the (K, 6, 6) diagonal blocks diag_d and the (K-1, 6, 6)
// super-diagonal blocks E into S_inv (K, 6, 6) and U (K-1, 6, 6); float32
// device arrays, one launch of two warps on `stream`.  Returns
// cudaGetLastError() (0 = ok).
int icet_tridiag_factor(const void* diag_d, const void* E, int K, void* S_inv, void* U,
                        void* stream) {
  tridiag_factor_kernel<<<1, 64, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(diag_d), static_cast<const float*>(E), K,
      static_cast<float*>(S_inv), static_cast<float*>(U));
  return (int)cudaGetLastError();
}

// y (K, 6) = M^-1 r for the factored backbone (S_inv, U); r (K, 6); float32
// device arrays, one launch of two warps on `stream`.  Returns
// cudaGetLastError() (0 = ok).
int icet_tridiag_apply(const void* S_inv, const void* U, const void* r, int K, void* y,
                       void* stream) {
  tridiag_apply_kernel<<<1, 64, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(S_inv), static_cast<const float*>(U),
      static_cast<const float*>(r), K, static_cast<float*>(y));
  return (int)cudaGetLastError();
}

const char* icet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
