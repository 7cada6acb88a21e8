// BiasNet encoder + max-pool: for every voxel b and point p,
//   h1 = stage(x[b, p, :4], W1 4x64)      h2 = stage(h1, W2 64x128)
//   h3 = stage(h2, W3 128x256)            out[b, :] = max over p of h3
// where stage(h, W) is icet_tpu's _dense_ln_relu in bf16:
//   a = bf16(h @ W)  (bf16 operands, float32 accumulation)
//   a = bf16(a + bias_bf16)
//   y = (a - mu) * (1 / sqrt(max(E[a^2] - mu^2, 0) + 1e-6)) * scale + beta
//   h = bf16(relu(y))
//
// Replaces the TPU kernel icet_tpu/models/bias_net.py::_encoder_kernel
// (wrapper apply_bias_net(fused=True), pallas_call at bias_net.py:185) and
// its tile variants in tools/bench_encoder_variants.py::kern (the `tile`
// argument: voxels a block).  The TPU ran stage 1 outside its kernel
// because a 4-wide input wastes its 128 lanes; here all three stages and the
// pool are one kernel, and no activation leaves the registers.
//
// Bound on the card: 2 (4*64 + 64*128 + 128*256) = 82,432 flop a point;
// at 1,801 voxels x 200 points, 2.97e10 flop, 0.030 ms at the 989 TFLOP/s
// bf16 tensor-core peak, against 7.7 MB of input, output and weights
// (2.3 us at 3.35 TB/s): the work is bound by operations.
//
// Design: a block of 8 warps takes `tile` voxels; W2 and W3 are staged
// once, transposed (k contiguous), into its shared memory.  The work unit
// is 16 consecutive points of one voxel (a voxel's 200 points are 13 units,
// the last 8 rows long); the warps of a block share out the units of its
// voxels.  A warp carries its 16 rows through all three stages in
// registers, with mma.sync m16n8k16 (bf16 operands, float32 accumulators):
// lane (g = lane / 4, t = lane % 4) holds rows g and g + 8 at columns
// 8 j + 2 t + {0, 1} of every 8-column tile j of a stage's output, which is
// exactly the A-operand layout of the next stage's 16-column k-steps, so a
// stage's output, rounded to bf16, is the next stage's input as it stands.
// Stage 1 (K = 4) is scalar float math straight into that layout.  The
// epilogue rounds to bf16 at the three points of _dense_ln_relu and reduces
// each row's LayerNorm statistics over the 4 lanes that hold the row (two
// shuffles).  The pool takes the max over a lane's two rows, then over the
// 8 lanes that hold a column, and merges it into the block's pooled table
// with integer atomicMax (the values are >= +0, so their bit patterns
// order like the floats).  Padded rows (past the voxel's P points, when 16
// does not divide P) are computed from zero input and left out of the max;
// a zero row is not neutral, since the LayerNorm of the bias alone is
// nonzero.  Voxels past B are not computed.  Every row is computed by the
// same instructions whatever the tile, so tiles 8/16/32 give bitwise-equal
// codes.  wgmma, TMA and a persistent grid are later work.
//
// Built without FMA contraction (-fmad=false, see icet_tpu_torch/_build.py)
// and without fast math: 1/sqrtf is correctly rounded, rsqrtf is not.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kIn = 4, kF1 = 64, kF2 = 128, kF3 = 256;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;          // points a warp carries at a time (mma m16)
constexpr int kLdK2 = kF1 + 8;     // row strides of the staged W2^T and W3^T
constexpr int kLdK3 = kF2 + 8;     // (padded: a warp's B loads hit 32 banks)
constexpr float kEps = 1e-6f;

constexpr int kW2Bytes = kF2 * kLdK2 * 2;
constexpr int kW3Bytes = kF3 * kLdK3 * 2;
// W1 (4x64) and the per-stage bias, scale and beta vectors, as floats.
constexpr int kVecFloats = kIn * kF1 + 3 * (kF1 + kF2 + kF3);
static_assert(kW2Bytes % 16 == 0 && kW3Bytes % 16 == 0, "aligned regions");

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Two bf16-exact floats as one bf16x2 register, `lo` in the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c (16 x 8, float32) += a (16 x 16, bf16, row-major) b (16 x 8, bf16, col-major)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The epilogue of a stage whose output is T tiles of 8 columns: c[j][e] is
// row g, column 8 j + 2 t + e, and c[j][2 + e] row g + 8.  Returns the
// stage output (bf16 values) in place.
template <int T>
__device__ __forceinline__ void ln_relu(float (&c)[T][4], const float* bias,
                                        const float* scale, const float* beta,
                                        int t) {
  constexpr float kInvF = 1.0f / (8 * T);
  float s0 = 0.0f, ss0 = 0.0f, s1 = 0.0f, ss1 = 0.0f;
#pragma unroll
  for (int j = 0; j < T; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + 2 * t + e;
      const float v = bf16r(bf16r(c[j][e]) + bias[col]);
      const float w = bf16r(bf16r(c[j][2 + e]) + bias[col]);
      c[j][e] = v;
      c[j][2 + e] = w;
      s0 += v;
      ss0 += v * v;
      s1 += w;
      ss1 += w * w;
    }
  }
  // The 4 lanes of a row are lanes 4 g .. 4 g + 3.
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, o);
    ss0 += __shfl_xor_sync(0xffffffffu, ss0, o);
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    ss1 += __shfl_xor_sync(0xffffffffu, ss1, o);
  }
  // Divide as the mean does (a power of two, so * kInvF is the same).
  const float mu0 = s0 * kInvF, mu1 = s1 * kInvF;
  const float inv0 = 1.0f / sqrtf(fmaxf(ss0 * kInvF - mu0 * mu0, 0.0f) + kEps);
  const float inv1 = 1.0f / sqrtf(fmaxf(ss1 * kInvF - mu1 * mu1, 0.0f) + kEps);
#pragma unroll
  for (int j = 0; j < T; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + 2 * t + e;
      float y = (c[j][e] - mu0) * inv0;
      y = y * scale[col] + beta[col];
      c[j][e] = bf16r(y > 0.0f ? y : 0.0f);
      y = (c[j][2 + e] - mu1) * inv1;
      y = y * scale[col] + beta[col];
      c[j][2 + e] = bf16r(y > 0.0f ? y : 0.0f);
    }
  }
}

// A fragments of the next stage from a stage output of T tiles: k-step kk
// covers tiles 2 kk and 2 kk + 1.
template <int T>
__device__ __forceinline__ void to_a(const float (&c)[T][4], uint32_t (&a)[T / 2][4]) {
#pragma unroll
  for (int kk = 0; kk < T / 2; ++kk) {
    a[kk][0] = pack(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// c (16 x 8 N8) = a (16 x 16 K16) @ W, with W^T staged as rows of stride ld.
template <int K16, int N8>
__device__ __forceinline__ void product(const uint32_t (&a)[K16][4],
                                        const __nv_bfloat16* wt, int ld,
                                        int g, int t, float (&c)[N8][4]) {
#pragma unroll
  for (int n = 0; n < N8; ++n) {
    c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.0f;
    const __nv_bfloat16* col = wt + (8 * n + g) * ld + 2 * t;
#pragma unroll
    for (int kk = 0; kk < K16; ++kk) {
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(col + 16 * kk);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(col + 16 * kk + 8);
      mma(c[n], a[kk], b0, b1);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
bias_encoder_kernel(const float* __restrict__ x, int B, int P,
                    const __nv_bfloat16* __restrict__ w1,
                    const __nv_bfloat16* __restrict__ b1,
                    const float* __restrict__ g1, const float* __restrict__ e1,
                    const __nv_bfloat16* __restrict__ w2,
                    const __nv_bfloat16* __restrict__ b2,
                    const float* __restrict__ g2, const float* __restrict__ e2,
                    const __nv_bfloat16* __restrict__ w3,
                    const __nv_bfloat16* __restrict__ b3,
                    const float* __restrict__ g3, const float* __restrict__ e3,
                    float* __restrict__ out, int tile) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sw2t = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sw3t = reinterpret_cast<__nv_bfloat16*>(smem + kW2Bytes);
  float* vec = reinterpret_cast<float*>(smem + kW2Bytes + kW3Bytes);
  float* sw1 = vec;
  float* sb1 = sw1 + kIn * kF1;
  float* sg1 = sb1 + kF1;
  float* se1 = sg1 + kF1;
  float* sb2 = se1 + kF1;
  float* sg2 = sb2 + kF2;
  float* se2 = sg2 + kF2;
  float* sb3 = se2 + kF2;
  float* sg3 = sb3 + kF3;
  float* se3 = sg3 + kF3;
  float* pooled = vec + kVecFloats;

  for (int i = threadIdx.x; i < kF1 * kF2; i += kThreads)
    sw2t[(i % kF2) * kLdK2 + i / kF2] = w2[i];
  for (int i = threadIdx.x; i < kF2 * kF3; i += kThreads)
    sw3t[(i % kF3) * kLdK3 + i / kF3] = w3[i];
  for (int i = threadIdx.x; i < kIn * kF1; i += kThreads) sw1[i] = __bfloat162float(w1[i]);
  for (int i = threadIdx.x; i < kF1; i += kThreads) {
    sb1[i] = __bfloat162float(b1[i]); sg1[i] = g1[i]; se1[i] = e1[i];
  }
  for (int i = threadIdx.x; i < kF2; i += kThreads) {
    sb2[i] = __bfloat162float(b2[i]); sg2[i] = g2[i]; se2[i] = e2[i];
  }
  for (int i = threadIdx.x; i < kF3; i += kThreads) {
    sb3[i] = __bfloat162float(b3[i]); sg3[i] = g3[i]; se3[i] = e3[i];
  }
  for (int i = threadIdx.x; i < tile * kF3; i += kThreads) pooled[i] = 0.0f;
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int v0 = blockIdx.x * tile;
  const int nv = min(tile, B - v0);
  const int units = (P + kRows - 1) / kRows;
  for (int u = warp; u < nv * units; u += kWarps) {
    const int vl = u / units;
    const int row0 = (u % units) * kRows;
    const int nrows = min(kRows, P - row0);
    const float* xv = x + ((long long)(v0 + vl) * P + row0) * kIn;

    // Stage 1 (K = 4): a = ((x0 w0 + x1 w1) + x2 w2) + x3 w3 for rows g
    // and g + 8; the products of bf16 values are exact in float32.
    float xa[kIn], xb[kIn];
#pragma unroll
    for (int k = 0; k < kIn; ++k) {
      xa[k] = g < nrows ? bf16r(xv[g * kIn + k]) : 0.0f;
      xb[k] = g + 8 < nrows ? bf16r(xv[(g + 8) * kIn + k]) : 0.0f;
    }
    float c1[kF1 / 8][4];
#pragma unroll
    for (int j = 0; j < kF1 / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t + e;
        const float wa = sw1[col], wb = sw1[kF1 + col];
        const float wc = sw1[2 * kF1 + col], wd = sw1[3 * kF1 + col];
        c1[j][e] = ((xa[0] * wa + xa[1] * wb) + xa[2] * wc) + xa[3] * wd;
        c1[j][2 + e] = ((xb[0] * wa + xb[1] * wb) + xb[2] * wc) + xb[3] * wd;
      }
    }
    ln_relu(c1, sb1, sg1, se1, t);
    uint32_t a2[kF1 / 16][4];
    to_a(c1, a2);

    // Stage 2.
    float c2[kF2 / 8][4];
    product(a2, sw2t, kLdK2, g, t, c2);
    ln_relu(c2, sb2, sg2, se2, t);
    uint32_t a3[kF2 / 16][4];
    to_a(c2, a3);

    // Stage 3 and the column max over the unit's real rows.
    float c3[kF3 / 8][4];
    product(a3, sw3t, kLdK3, g, t, c3);
    ln_relu(c3, sb3, sg3, se3, t);
    const bool ok0 = g < nrows, ok1 = g + 8 < nrows;
#pragma unroll
    for (int j = 0; j < kF3 / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float m = fmaxf(ok0 ? c3[j][e] : 0.0f, ok1 ? c3[j][2 + e] : 0.0f);
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 8));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 16));
        if (g == 0)
          atomicMax(reinterpret_cast<int*>(pooled + vl * kF3 + 8 * j + 2 * t + e),
                    __float_as_int(m));
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < nv * kF3; i += kThreads)
    out[(long long)v0 * kF3 + i] = pooled[i];
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`, ceil(B / tile) blocks; returns
// cudaGetLastError() (0 = ok).  x (B, P, 4) float32; per stage s the
// weight (in, out) and bias as bf16, the LayerNorm scale and beta as
// float32; out (B, 256) float32; all device arrays.
int icet_bias_encoder(const void* x, int B, int P,
                      const void* w1, const void* b1, const void* g1, const void* e1,
                      const void* w2, const void* b2, const void* g2, const void* e2,
                      const void* w3, const void* b3, const void* g3, const void* e3,
                      void* out, int tile, void* stream) {
  const int smem = kW2Bytes + kW3Bytes + (kVecFloats + tile * kF3) * (int)sizeof(float);
  // Above 48 KB of dynamic shared memory needs an opt-in, kept per device:
  // set it on every call (the current device may differ).
  cudaError_t err = cudaFuncSetAttribute(
      bias_encoder_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  using bf = const __nv_bfloat16*;
  using f = const float*;
  const int blocks = (B + tile - 1) / tile;
  bias_encoder_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<f>(x), B, P,
      static_cast<bf>(w1), static_cast<bf>(b1), static_cast<f>(g1), static_cast<f>(e1),
      static_cast<bf>(w2), static_cast<bf>(b2), static_cast<f>(g2), static_cast<f>(e2),
      static_cast<bf>(w3), static_cast<bf>(b3), static_cast<f>(g3), static_cast<f>(e3),
      static_cast<float*>(out), tile);
  return (int)cudaGetLastError();
}

const char* icet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
