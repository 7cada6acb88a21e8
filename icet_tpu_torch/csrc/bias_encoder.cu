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
// argument: voxels a work item).  The TPU ran stage 1 outside its kernel
// because a 4-wide input wastes its 128 lanes; here all three stages and the
// pool are one kernel, and no activation leaves the registers.
//
// Bounds on the card: 2 (4*64 + 64*128 + 128*256) = 82,432 flop a point;
// at 1,801 voxels x 200 points, 2.97e10 flop, 0.030 ms at the 989 TFLOP/s
// bf16 tensor-core peak, against 7.7 MB of input, output and weights
// (2.3 us at 3.35 TB/s).  A second floor is the LayerNorm epilogue: about
// 16 float32 instructions an element (two bf16 roundings, the bias, the
// two sums, the normalisation, scale, beta, ReLU and the last rounding),
// 448 elements a point, 2.6e9 instructions at that size, ~0.08 ms at the
// card's 128 float32 lanes an SM.
//
// Design:
// - Persistent grid: one block an SM (the wrapper sizes it), three
//   warpgroups a block (168 registers a thread, with a few spills), so
//   that two warpgroups' epilogues run while the third's products are in
//   the tensor cores.  Block b takes a contiguous, balanced run of voxels
//   and walks it in work items of `tile` voxels; a work item's P-point
//   voxels are one run of rows, cut into 64-row chunks (only the last
//   chunk of a work item is ragged) that the warpgroups take in turn.
// - Weights: the wrapper packs W2 and W3 once into wgmma's K-major
//   128-byte-swizzled layout (hopper.cuh), followed by W1 and the
//   per-stage bias, scale and beta as float32; the block copies that
//   88,320-byte image into shared memory with one bulk copy on an mbarrier.
// - Stage 1 (K = 4) is scalar float math, straight into the accumulator
//   layout; stages 2 and 3 are wgmma m64n128k16 and m64n256k16 with A from
//   registers: a stage's output, rounded to bf16, is the next stage's A
//   fragments as it stands (hopper.cuh, Layouts).  Each warp owns 16 rows
//   of the chunk, so a row's LayerNorm statistics reduce over the 4 lanes
//   that hold it (two shuffles).  The epilogue works on two columns at a
//   time: cvt.rn.bf16x2 rounds the products, add.rn.bf16x2 adds the bf16
//   bias, cvt.rn.relu.bf16x2 does the ReLU and the last rounding, so a
//   stage's output comes out as packed bf16 pairs.
// - Input rows are loaded one chunk ahead.
// - Pool: a row pools into its own voxel (row / P); a warp's 16 rows span
//   one voxel or a few, and for each the warp takes the max (on the packed
//   pairs) over its rows of that voxel, then over the 8 lanes that hold a
//   column by a reduce-scatter (three shuffle steps that halve the columns
//   a lane holds, so each lane ends with 8 columns), and merges those into
//   the work item's pooled table with 8 integer atomicMax a lane, in 32
//   different banks (the values are >= +0, so their bit patterns order
//   like the floats).  Rows past the work item's last point are computed
//   from zero input and left out of the max: a zero row is not neutral,
//   since the LayerNorm of the bias alone is nonzero.
// Every row is computed by the same instructions wherever it falls in a
// chunk, and the max is exact, so tiles 8/16/32 give bitwise-equal codes.
//
// Built without FMA contraction (-fmad=false, see icet_tpu_torch/_build.py)
// and without fast math: 1/sqrtf is correctly rounded, rsqrtf is not.  The
// one explicit fused multiply-add, in the LayerNorm's sum of squares, rounds
// as the separate product and sum do (see ln_relu).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kIn = 4, kF1 = 64, kF2 = 128, kF3 = 256;
constexpr int kGroups = 3;                  // warpgroups a block
constexpr int kThreads = kGroups * 128;
constexpr int kTileRows = 64;               // rows of a wgmma tile
constexpr float kEps = 1e-6f;

// The weight image (ops/bias_encoder.py, weight_image): W2 and W3
// swizzled, then the float vectors.
constexpr int kW2Bytes = kF2 * kF1 * 2;     // one 64-deep K region
constexpr int kW3Bytes = kF3 * kF2 * 2;     // two K regions
constexpr int kW3Region = kF3 * 128;        // bytes of one W3 K region
constexpr int kVecFloats = kIn * kF1 + 3 * (kF1 + kF2 + kF3);
constexpr int kImageBytes = kW2Bytes + kW3Bytes + kVecFloats * 4;
static_assert(kImageBytes % 16 == 0, "bulk copies move multiples of 16 bytes");
// Offsets of the vectors in the image's float part.
constexpr int kW1 = 0, kB1 = kW1 + kIn * kF1, kG1 = kB1 + kF1, kE1 = kG1 + kF1;
constexpr int kB2 = kE1 + kF1, kG2 = kB2 + kF2, kE2 = kG2 + kF2;
constexpr int kB3 = kE2 + kF2, kG3 = kB3 + kF3, kE3 = kG3 + kF3;
static_assert(kE3 + kF3 == kVecFloats, "vector layout");
// Shared memory past the image: the mbarrier (8 bytes, padded to 16), then
// the pooled table; the image starts at the first 1,024-byte boundary.
constexpr int kAlignSlack = 1024;
// The pooled table: a row of 256 columns a voxel, column c of lane group
// g = c / 32 shifted by 8 g + g / 4, so the 32 lanes of a warp's atomicMax
// (columns 32 g + 2 t + const) fall in 32 different banks.
constexpr int kPoolStride = kF3 + 64;

__device__ __forceinline__ int pool_pos(int col) {
  const int g = col >> 5;
  return col + 8 * g + (g >> 2);
}

// bf16 pairs in one 32-bit register, the lower column in the low half.
__device__ __forceinline__ uint32_t bf16x2(float lo_val, float hi_val) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi_val), "f"(lo_val));
  return r;
}
// The same of max(x, 0) (relu; a NaN stays NaN).
__device__ __forceinline__ uint32_t bf16x2_relu(float lo_val, float hi_val) {
  uint32_t r;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi_val), "f"(lo_val));
  return r;
}
__device__ __forceinline__ float lo(uint32_t p) { return __uint_as_float(p << 16); }
__device__ __forceinline__ float hi(uint32_t p) { return __uint_as_float(p & 0xffff0000u); }
__device__ __forceinline__ float bf16r(float v) { return lo(bf16x2(v, 0.0f)); }
// The sum of two bf16 pairs, half by half, rounded once to bf16.  For bf16
// inputs this equals rounding the float32 sum to bf16: where the float32
// sum is inexact, the smaller addend is below 2^-15 of the larger and both
// roundings return the larger.
__device__ __forceinline__ uint32_t badd2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
// The max of two bf16 pairs, half by half.
__device__ __forceinline__ uint32_t bmax2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("max.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// One reduce-scatter step over lanes `mask` apart on packed bf16 pairs:
// the lane with the bit clear keeps m[0, H), the other m[H, 2H) (moved
// down to [0, H)), each the max of its own and the partner's pair.
template <int H>
__device__ __forceinline__ void reduce_half(uint32_t (&m)[kF3 / 8], int lane, int mask) {
  const bool upper = lane & mask;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const uint32_t send = upper ? m[i] : m[i + H];
    const uint32_t keep = upper ? m[i + H] : m[i];
    m[i] = bmax2(keep, __shfl_xor_sync(0xffffffffu, send, mask));
  }
}

// The epilogue of a stage whose output is T tiles of 8 columns: c[j][e] is
// row g, column 8 j + 2 t + e, and c[j][2 + e] row g + 8.  Writes the stage
// output as bf16 pairs: h[j][0] row g, columns 8 j + 2 t and + 1, h[j][1]
// row g + 8 (the A fragments of the next stage, hopper.cuh).  The
// roundings are _dense_ln_relu's.  The sum of squares uses a fused
// multiply-add, which rounds as a product and a sum would: the square of a
// bf16 value (8 significant bits) is exact in float32.
template <int T>
__device__ __forceinline__ void ln_relu(float (&c)[T][4], const float* bias,
                                        const float* scale, const float* beta,
                                        int t, uint32_t (&h)[T][2]) {
  constexpr float kInvF = 1.0f / (8 * T);
  float s0 = 0.0f, ss0 = 0.0f, s1 = 0.0f, ss1 = 0.0f;
#pragma unroll
  for (int j = 0; j < T; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * t);
    // a = bf16(bf16(c) + bias), two columns at a time (the bias is bf16).
    const uint32_t bb = bf16x2(b.x, b.y);
    const uint32_t v = badd2(bf16x2(c[j][0], c[j][1]), bb);
    const uint32_t w = badd2(bf16x2(c[j][2], c[j][3]), bb);
    c[j][0] = lo(v); c[j][1] = hi(v); c[j][2] = lo(w); c[j][3] = hi(w);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s0 += c[j][e];
      ss0 = __fmaf_rn(c[j][e], c[j][e], ss0);
      s1 += c[j][2 + e];
      ss1 = __fmaf_rn(c[j][2 + e], c[j][2 + e], ss1);
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
    const float2 sc = *reinterpret_cast<const float2*>(scale + 8 * j + 2 * t);
    const float2 be = *reinterpret_cast<const float2*>(beta + 8 * j + 2 * t);
    h[j][0] = bf16x2_relu((c[j][0] - mu0) * inv0 * sc.x + be.x,
                          (c[j][1] - mu0) * inv0 * sc.y + be.y);
    h[j][1] = bf16x2_relu((c[j][2] - mu1) * inv1 * sc.x + be.x,
                          (c[j][3] - mu1) * inv1 * sc.y + be.y);
  }
}

// A fragments of the next stage from a stage output of T tiles: k-step kk
// covers tiles 2 kk and 2 kk + 1.
template <int T>
__device__ __forceinline__ void to_a(const uint32_t (&h)[T][2], uint32_t (&a)[T / 2][4]) {
#pragma unroll
  for (int kk = 0; kk < T / 2; ++kk) {
    a[kk][0] = h[2 * kk][0];
    a[kk][1] = h[2 * kk][1];
    a[kk][2] = h[2 * kk + 1][0];
    a[kk][3] = h[2 * kk + 1][1];
  }
}

template <int T>
__device__ __forceinline__ void zero(float (&c)[T][4]) {
#pragma unroll
  for (int j = 0; j < T; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.0f;
}

__global__ void __launch_bounds__(kThreads, 1)
bias_encoder_kernel(const float* __restrict__ x, int B, int P,
                    const unsigned char* __restrict__ image,
                    float* __restrict__ out, int tile) {
  extern __shared__ unsigned char smem_raw[];
  // The image's swizzled regions need 1,024-byte alignment.
  const uint32_t raw = hopper::smem_addr(smem_raw);
  unsigned char* smem = smem_raw + ((kAlignSlack - (raw % kAlignSlack)) % kAlignSlack);
  const float* vec = reinterpret_cast<const float*>(smem + kW2Bytes + kW3Bytes);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + kImageBytes);
  float* pooled = reinterpret_cast<float*>(smem + kImageBytes + 16);

  if (threadIdx.x == 0) {
    hopper::mbar_init(bar, 1);
    hopper::bulk_load(smem, image, kImageBytes, bar);
  }
  for (int i = threadIdx.x; i < tile * kPoolStride; i += kThreads) pooled[i] = 0.0f;
  __syncthreads();  // the barrier's init before anyone waits; the zeros
  hopper::mbar_wait(bar, 0);

  const uint32_t w2 = hopper::smem_addr(smem);
  const uint32_t w3 = w2 + kW2Bytes;
  const int group = threadIdx.x / 128;
  const int wib = (threadIdx.x / 32) % 4;   // warp in its warpgroup
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  // Block b's voxels [v_lo, v_hi): a balanced split of B.
  const int v_lo = (int)((long long)B * blockIdx.x / gridDim.x);
  const int v_hi = (int)((long long)B * (blockIdx.x + 1) / gridDim.x);
  for (int item = v_lo; item < v_hi; item += tile) {
    const int nv = min(tile, v_hi - item);
    const int rows = nv * P;                       // the work item's rows
    const float* xi = x + (long long)item * P * kIn;
    const int chunks = (rows + kTileRows - 1) / kTileRows;
    // The lane's two input rows of a chunk (zero past the work item's
    // rows), loaded one chunk ahead so the load overlaps a chunk's work.
    auto load_rows = [&](int ch, float4& a, float4& b) {
      const int r = ch * kTileRows + 16 * wib + g;
      const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      a = r < rows ? *reinterpret_cast<const float4*>(xi + (long long)r * kIn) : zero4;
      b = r + 8 < rows ? *reinterpret_cast<const float4*>(xi + (long long)(r + 8) * kIn)
                       : zero4;
    };
    float4 next_a, next_b;
    load_rows(group, next_a, next_b);
    for (int ch = group; ch < chunks; ch += kGroups) {
      const int r0 = ch * kTileRows + 16 * wib;     // the warp's first row
      const int ra = r0 + g, rb = r0 + g + 8;
      const bool oka = ra < rows, okb = rb < rows;
      const float4 in_a = next_a, in_b = next_b;
      if (ch + kGroups < chunks) load_rows(ch + kGroups, next_a, next_b);

      // Stage 1 (K = 4): a = ((x0 w0 + x1 w1) + x2 w2) + x3 w3 for rows
      // ra and rb; the products of bf16 values are exact in float32.
      const float xa[kIn] = {bf16r(in_a.x), bf16r(in_a.y), bf16r(in_a.z), bf16r(in_a.w)};
      const float xb[kIn] = {bf16r(in_b.x), bf16r(in_b.y), bf16r(in_b.z), bf16r(in_b.w)};
      float c1[kF1 / 8][4];
#pragma unroll
      for (int j = 0; j < kF1 / 8; ++j) {
        const float* w1 = vec + kW1 + 8 * j + 2 * t;
        const float2 wa2 = *reinterpret_cast<const float2*>(w1);
        const float2 wb2 = *reinterpret_cast<const float2*>(w1 + kF1);
        const float2 wc2 = *reinterpret_cast<const float2*>(w1 + 2 * kF1);
        const float2 wd2 = *reinterpret_cast<const float2*>(w1 + 3 * kF1);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float wa = e ? wa2.y : wa2.x, wb = e ? wb2.y : wb2.x;
          const float wc = e ? wc2.y : wc2.x, wd = e ? wd2.y : wd2.x;
          c1[j][e] = ((xa[0] * wa + xa[1] * wb) + xa[2] * wc) + xa[3] * wd;
          c1[j][2 + e] = ((xb[0] * wa + xb[1] * wb) + xb[2] * wc) + xb[3] * wd;
        }
      }
      uint32_t h1[kF1 / 8][2];
      ln_relu(c1, vec + kB1, vec + kG1, vec + kE1, t, h1);
      uint32_t a2[kF1 / 16][4];
      to_a(h1, a2);

      // Stage 2: 4 k16 steps of m64n128k16.
      float c2[kF2 / 8][4];
      zero(c2);
      hopper::fence_regs(c2);
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kF1 / 16; ++ks)
        hopper::wgmma_n128(c2, a2[ks], hopper::desc_sw128(w2 + 32 * ks));
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(c2);
      uint32_t h2[kF2 / 8][2];
      ln_relu(c2, vec + kB2, vec + kG2, vec + kE2, t, h2);
      uint32_t a3[kF2 / 16][4];
      to_a(h2, a3);

      // Stage 3: 8 k16 steps of m64n256k16 over W3's two K regions.
      float c3[kF3 / 8][4];
      zero(c3);
      hopper::fence_regs(c3);
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kF2 / 16; ++ks)
        hopper::wgmma_n256(c3, a3[ks],
                           hopper::desc_sw128(w3 + kW3Region * (ks / 4) + 32 * (ks % 4)));
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(c3);
      uint32_t h3[kF3 / 8][2];
      ln_relu(c3, vec + kB3, vec + kG3, vec + kE3, t, h3);

      // Pool each of the warp's voxels over the warp's real rows of it.
      const int v_first = r0 / P;
      const int v_last = r0 < rows ? min(r0 + 15, rows - 1) / P : v_first - 1;
      const int va = ra / P, vb = rb / P;
      for (int v = v_first; v <= v_last; ++v) {
        const bool ina = oka && va == v, inb = okb && vb == v;
        // m[j]: the max over the lane's two rows of columns 8 j + 2 t, + 1.
        uint32_t m[kF3 / 8];
#pragma unroll
        for (int j = 0; j < kF3 / 8; ++j)
          m[j] = bmax2(ina ? h3[j][0] : 0u, inb ? h3[j][1] : 0u);
        // Reduce-scatter over the 8 lanes of a column (lane bits 4, 3, 2):
        // each step keeps half of the pairs and takes the partner's max of
        // them, so lane (g, t) ends with m[4 g + q], q < 4, reduced.
        reduce_half<16>(m, lane, 16);
        reduce_half<8>(m, lane, 8);
        reduce_half<4>(m, lane, 4);
        float* row = pooled + v * kPoolStride;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int col = 32 * g + 8 * q + 2 * t;
          atomicMax(reinterpret_cast<int*>(row + pool_pos(col)), __float_as_int(lo(m[q])));
          atomicMax(reinterpret_cast<int*>(row + pool_pos(col + 1)), __float_as_int(hi(m[q])));
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nv * kF3; i += kThreads) {
      float* cell = pooled + (i / kF3) * kPoolStride + pool_pos(i % kF3);
      out[(long long)item * kF3 + i] = *cell;
      *cell = 0.0f;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`, `blocks` blocks; returns
// cudaGetLastError() (0 = ok).  x (B, P, 4) float32; image the packed
// weights (ops/bias_encoder.py, weight_image: kImageBytes, 16-byte
// aligned); out (B, 256) float32; all device arrays.
int icet_bias_encoder(const void* x, int B, int P, const void* image,
                      void* out, int tile, int blocks, void* stream) {
  const int smem = kAlignSlack + kImageBytes + 16 + tile * kPoolStride * (int)sizeof(float);
  // Above 48 KB of dynamic shared memory needs an opt-in, which is kept
  // per device: set it once a device and size (the current device may
  // differ from one call to the next), so that no attribute call reaches a
  // stream capture after the first launch.
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  static int opted_in[64] = {};
  if (device >= 64 || opted_in[device] < smem) {
    err = cudaFuncSetAttribute(bias_encoder_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (device < 64) opted_in[device] = smem;
  }
  bias_encoder_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), B, P, static_cast<const unsigned char*>(image),
      static_cast<float*>(out), tile);
  return (int)cudaGetLastError();
}

// Bytes of the weight image the kernel expects.
int icet_bias_encoder_image_bytes() { return kImageBytes; }

const char* icet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
