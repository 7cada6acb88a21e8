// The Gauss-Newton iteration's 6x6 eigensystem and its pruned update: one
// launch an iteration, from H^T W H, H^T W dz, X and (warm) the previous
// eigenbasis to the eigenvalues, the eigenbasis, the kept axes, X + dx and
// the iteration's diagnostics (condition, |dx|, dropped axes).
//
// Replaces no TPU kernel.  The JAX package writes the round-robin Jacobi
// as array code (icet_tpu/ops/linalg.py: eigh_small, eigh_small_warm_safe)
// and leaves it to XLA.  Unfused on this card every round is ~17 launches
// of a few floats each (the gathers of A[p, p], the angles, G, G^T A G,
// V G): ~690 launches a cold eigensystem (8 sweeps of 5 rounds) and ~220 a
// warm one, ~1.1 ms and ~0.36 ms of device time, the largest share of the
// frame.  The plain version stays in icet_tpu_torch/ops/gn_eigh6.py
// (gn_eigh6_reference).
//
// Bound on the card: it reads 36 to 78 floats and writes 53 words, so no
// byte bound matters.  What bounds it is a dependent chain of rounds on 36
// numbers: 40 rounds cold, 10 or 15 warm, each three atan2f/cosf/sinf and
// two 6-term products in a row.
//
// Design:
// - One block of 36 threads, one entry (i, j) of the 6x6 matrices a
//   thread, the matrices in shared memory.  A round is three steps with a
//   barrier after each: the three angles, their cosines and their sines
//   (the longest chain of the round: an atan2f, then a cosf or a sinf, so
//   six threads of two warps run them side by side, while the others read
//   their part of the round's plan, built once a launch in shared memory);
//   B = G^T A and V = V G (each thread its entry; V in two buffers, read
//   one and write the other); A = B G.
// - The plain version's arithmetic: A symmetrised as 0.5 (A + A^T); the
//   rounds of _round_robin_rounds(6) (c_rounds below); the angle
//   0.5 atan2(2 a_pq, a_qq - a_pp); G^T A G and V G as full products,
//   rows then columns, each term of the 6-term sums taken (G's zeros
//   too); a stable sort of the diagonal.  Built with -fmad=false and no
//   fast math: precise atan2f, cosf, sinf, sqrtf and true division.  The
//   sums of the products are added in the order k = 0..5 (cuBLAS, behind
//   the plain version on the card, adds them in its own order).
// - Warm (eigh_small_warm_safe): A0 = V0^T A V0, one sweep from it,
//   R = V1^T A0 V1 and the off-diagonal test; the second sweep runs only
//   where the test fails, which is the value torch.where picks in the plain
//   version.
// - No atomics, every sum in a fixed order, nothing allocated: the same
//   inputs give the same bits every launch and every graph replay.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kN = 6;
constexpr int kThreads = kN * kN;
constexpr int kPairs = kN / 2;
constexpr int kRoundsPerSweep = kN - 1;
// eigh_small's sweeps from a cold start
constexpr int kColdSweeps = 8;
// eigh_small_warm_safe's rtol
constexpr float kWarmRtol = 1e-5f;

// The output, in 32-bit words: w6 (6), U2 (6, 6), X + dx (6), the
// condition, |dx|, the dropped axes (int32), keep (6 bytes).
constexpr int kOutW = 0;
constexpr int kOutU = 6;
constexpr int kOutX = 42;
constexpr int kOutCond = 48;
constexpr int kOutDxNorm = 49;
constexpr int kOutDropped = 50;
constexpr int kOutKeep = 51;
constexpr int kOutWords = 53;
static_assert(kOutKeep * 4 + kN <= kOutWords * 4, "keep's bytes lie inside the output");

// _round_robin_rounds(6): each round's three disjoint (p, q), p < q.
__constant__ int c_rounds[kRoundsPerSweep][kPairs][2] = {
    {{0, 5}, {1, 4}, {2, 3}},
    {{0, 4}, {3, 5}, {1, 2}},
    {{0, 3}, {2, 4}, {1, 5}},
    {{0, 2}, {1, 3}, {4, 5}},
    {{0, 1}, {2, 5}, {3, 4}},
};

// torch.clamp(v, min=lo): NaN passes through.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return (isnan(v) || v > lo) ? v : lo;
}

// torch.sort's order: NaN above everything.
__device__ __forceinline__ bool less_nan_last(float a, float b) {
  return isnan(b) ? !isnan(a) : a < b;
}

// Entry (i, j) of L R (L^T R with kTransL), the terms added for k = 0..5.
template <bool kTransL>
__device__ __forceinline__ float product(const float* L, const float* R, int i, int j) {
  float acc = (kTransL ? L[i] : L[i * kN]) * R[j];
#pragma unroll
  for (int k = 1; k < kN; ++k) {
    acc = acc + (kTransL ? L[k * kN + i] : L[i * kN + k]) * R[k * kN + j];
  }
  return acc;
}

// The rounds' plans, read from c_rounds once a launch: for each round and
// column of G, its pair, its partner and whether the partner's entry is
// -s (the column is the pair's p: G[q][p] = -s) or s (G[p][q] = s), packed
// as pair | partner << 2 | negated << 5; for each round and pair, the
// offsets of A[p][p], A[q][q] and A[p][q], packed as bytes.
struct Plan {
  int col[kRoundsPerSweep][kN];
  int angle[kRoundsPerSweep][kPairs];
};

// Thread e < 30 fills col[e / 6][e % 6], thread e < 15 angle[e / 3][e % 3].
__device__ __forceinline__ void make_plan(Plan& plan, int e) {
  if (e < kRoundsPerSweep * kN) {
    const int r = e / kN, col = e % kN;
    int packed = 0;
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int p = c_rounds[r][k][0], q = c_rounds[r][k][1];
      if (p == col) packed = k | q << 2 | 1 << 5;
      if (q == col) packed = k | p << 2;
    }
    plan.col[r][col] = packed;
  }
  if (e < kRoundsPerSweep * kPairs) {
    const int p = c_rounds[e / kPairs][e % kPairs][0], q = c_rounds[e / kPairs][e % kPairs][1];
    plan.angle[e / kPairs][e % kPairs] = p * (kN + 1) | q * (kN + 1) << 8 | (p * kN + q) << 16;
  }
}

// Column `col` of the round's G from its plan and the angles' cs:
// G[col][col] = c, G[p][q] = s, G[q][p] = -s (the plain version's
// eye * c_row + sign * s_row), 0 elsewhere.
__device__ __forceinline__ void g_column(int packed, int col, const float* cs, float (&g)[kN]) {
  const int pair = packed & 3, partner = (packed >> 2) & 7;
  const float c = cs[pair];
  const float s = cs[kPairs + pair];
  const float gs = (packed >> 5) ? -s : s;
#pragma unroll
  for (int k = 0; k < kN; ++k) g[k] = k == col ? c : (k == partner ? gs : 0.0f);
}

// One round r: A <- G^T A G, V <- V G (read from *V, written to *W, then
// the two swapped).  The three angles go into cs (the cosines, then the
// sines): threads 0-2 (warp 0) each compute one angle and its cosine,
// threads 32-34 (warp 1) the same angle and its sine, so neither warp
// takes both branches.  Then every thread builds its columns of G from cs,
// its entries of B = G^T A and of V G, and after a barrier its entry of
// B G.  Ends with a barrier.
__device__ __forceinline__ void jacobi_round(float* A, float* B, float*& V, float*& W, float* cs,
                                             const Plan& plan, int r, int i, int j) {
  const int e = i * kN + j;
  const int pair = e < 32 ? e : e - 32;
  if (pair < kPairs) {
    const int at = plan.angle[r][pair];
    const int pp = at & 255, qq = (at >> 8) & 255, pq = at >> 16;
    const float ang = 0.5f * atan2f(2.0f * A[pq], A[qq] - A[pp]);
    if (e < 32) {
      cs[pair] = cosf(ang);
    } else {
      cs[kPairs + pair] = sinf(ang);
    }
  }
  const int plan_i = plan.col[r][i], plan_j = plan.col[r][j];
  __syncthreads();
  float gi[kN], gj[kN];
  g_column(plan_i, i, cs, gi);
  g_column(plan_j, j, cs, gj);
  // B = G^T A (row i of G^T is column i of G) and V G (column j of G).
  float b = gi[0] * A[j];
  float v = V[i * kN] * gj[0];
#pragma unroll
  for (int k = 1; k < kN; ++k) {
    b = b + gi[k] * A[k * kN + j];
    v = v + V[i * kN + k] * gj[k];
  }
  B[e] = b;
  W[e] = v;
  __syncthreads();
  // A = B G.
  float a = B[i * kN] * gj[0];
#pragma unroll
  for (int k = 1; k < kN; ++k) a = a + B[i * kN + k] * gj[k];
  A[e] = a;
  __syncthreads();
  float* t = V;
  V = W;
  W = t;
}

// eigh_small(M, sweeps): A = 0.5 (M + M^T), V = I, the rounds, then the
// diagonal sorted ascending (stable) into w and V's columns to match into
// U.  A, B, V, W and cs are scratch.  Ends with a barrier.
__device__ void eigh(const float* M, int sweeps, float* A, float* B, float* V, float* W,
                     float* cs, const Plan& plan, float* w, float* U, int i, int j) {
  const int e = i * kN + j;
  A[e] = 0.5f * (M[e] + M[j * kN + i]);
  V[e] = i == j ? 1.0f : 0.0f;
  __syncthreads();
  for (int sweep = 0; sweep < sweeps; ++sweep) {
#pragma unroll 1
    for (int r = 0; r < kRoundsPerSweep; ++r) jacobi_round(A, B, V, W, cs, plan, r, i, j);
  }
  // Column j's place: the diagonal entries before it, ties by index.
  const float wj = A[j * kN + j];
  int rank = 0;
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    const float wk = A[k * kN + k];
    rank += less_nan_last(wk, wj) || (!less_nan_last(wj, wk) && k < j);
  }
  U[i * kN + rank] = V[e];
  if (i == 0) w[rank] = wj;
  __syncthreads();
}

// Everything of one launch in shared memory: 6x6 matrices and 6-vectors.
struct Shared {
  float H[kThreads], V0[kThreads], A0[kThreads], T[kThreads], R[kThreads];
  float A[kThreads], B[kThreads], Va[kThreads], Vb[kThreads];
  float V1[kThreads], V2[kThreads], U[kThreads];
  float w1[kN], w2[kN], u[kN], dx[kN], cs[2 * kPairs];
  Plan plan;
};

template <bool kWarm>
__global__ void __launch_bounds__(kThreads) gn_eigh6_kernel(
    const float* __restrict__ htwh, const float* __restrict__ htwdz, const float* __restrict__ X,
    const float* __restrict__ U0, float cutoff, float* __restrict__ out) {
  __shared__ Shared sm;
  const int e = threadIdx.x;
  const int i = e / kN, j = e % kN;
  make_plan(sm.plan, e);
  sm.H[e] = htwh[e];
  const float* w6 = sm.w1;
  if constexpr (!kWarm) {
    __syncthreads();
    eigh(sm.H, kColdSweeps, sm.A, sm.B, sm.Va, sm.Vb, sm.cs, sm.plan, sm.w1, sm.U, i, j);
  } else {
    sm.V0[e] = U0[e];
    __syncthreads();
    // A0 = V0^T A V0
    sm.T[e] = product<true>(sm.V0, sm.H, i, j);
    __syncthreads();
    sm.A0[e] = product<false>(sm.T, sm.V0, i, j);
    __syncthreads();
    eigh(sm.A0, 1, sm.A, sm.B, sm.Va, sm.Vb, sm.cs, sm.plan, sm.w1, sm.V1, i, j);
    // R = V1^T A0 V1
    sm.T[e] = product<true>(sm.V1, sm.A0, i, j);
    __syncthreads();
    sm.R[e] = product<false>(sm.T, sm.V1, i, j);
    __syncthreads();
    // |R - diag(R)|_F <= rtol * max(|diag(R)|, 1e-30), row by row (every
    // thread the same sums).
    float off = 0.0f, dg = 0.0f;
#pragma unroll
    for (int k = 0; k < kThreads; ++k) {
      const float rk = k % (kN + 1) == 0 ? sm.R[k] - sm.R[k] * 1.0f : sm.R[k];
      off = off + rk * rk;
    }
#pragma unroll
    for (int k = 0; k < kN; ++k) dg = dg + sm.R[k * (kN + 1)] * sm.R[k * (kN + 1)];
    const bool converged = sqrtf(off) <= kWarmRtol * clamp_min(sqrtf(dg), 1e-30f);
    if (converged) {
      sm.U[e] = product<false>(sm.V0, sm.V1, i, j);
    } else {
      eigh(sm.R, 1, sm.A, sm.B, sm.Va, sm.Vb, sm.cs, sm.plan, sm.w2, sm.V2, i, j);
      sm.T[e] = product<false>(sm.V1, sm.V2, i, j);
      __syncthreads();
      sm.U[e] = product<false>(sm.V0, sm.T, i, j);
      w6 = sm.w2;
    }
    __syncthreads();
  }

  // The pruned update: keep the axes within the condition cutoff,
  // dx = U2 (w^-1 on the kept axes) U2^T H^T W dz.
  const float top = fabsf(w6[kN - 1]);
  if (e < kN) {
    const float we = w6[e];
    const bool keep = top <= cutoff * fabsf(we) && fabsf(we) > 1e-30f;
    float t = sm.U[e] * htwdz[0];
#pragma unroll
    for (int k = 1; k < kN; ++k) t = t + sm.U[k * kN + e] * htwdz[k];
    sm.u[e] = (keep ? 1.0f / we : 0.0f) * t;
    out[kOutW + e] = we;
    reinterpret_cast<uint8_t*>(out + kOutKeep)[e] = keep;
  }
  out[kOutU + e] = sm.U[e];
  __syncthreads();
  if (e < kN) {
    float d = sm.U[e * kN] * sm.u[0];
#pragma unroll
    for (int k = 1; k < kN; ++k) d = d + sm.U[e * kN + k] * sm.u[k];
    sm.dx[e] = d;
    out[kOutX + e] = X[e] + d;
  }
  __syncthreads();
  if (e == 0) {
    float sq = 0.0f;
    int dropped = 0;
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      sq = sq + sm.dx[k] * sm.dx[k];
      const float wk = fabsf(w6[k]);
      dropped += !(top <= cutoff * wk && wk > 1e-30f);
    }
    out[kOutCond] = top / clamp_min(fabsf(w6[0]), 1e-30f);
    out[kOutDxNorm] = sqrtf(sq);
    reinterpret_cast<int*>(out)[kOutDropped] = dropped;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = ok).
// htwh (6, 6), htwdz (6,), X (6,) and U0 (6, 6, the previous eigenbasis,
// or null for a cold start) are contiguous float32 device arrays; out
// holds kOutWords (53) 32-bit words.
int icet_gn_eigh6(const void* htwh, const void* htwdz, const void* X, const void* U0,
                  float cutoff, void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* h = static_cast<const float*>(htwh);
  const float* b = static_cast<const float*>(htwdz);
  const float* x = static_cast<const float*>(X);
  const float* u0 = static_cast<const float*>(U0);
  float* o = static_cast<float*>(out);
  if (u0 != nullptr)
    gn_eigh6_kernel<true><<<1, kThreads, 0, s>>>(h, b, x, u0, cutoff, o);
  else
    gn_eigh6_kernel<false><<<1, kThreads, 0, s>>>(h, b, x, u0, cutoff, o);
  return (int)cudaGetLastError();
}

const char* icet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
