// Sorted parts: per-point feature rows summed by row id in an order the
// code fixes, for tables too large for one block's shared memory.  Shared
// by the moment scatter (csrc/moment_scatter.cu, kernel #3) and the fused
// moment sums (csrc/fused_moments.cu, kernel #1).
//
// - The points are cut into parts of at most kThreads consecutive points,
//   each block walking parts blockIdx.x, + gridDim.x, ...  A part's
//   (id, position) keys are sorted in the block (a bitonic sort, shuffles
//   below a distance of 32, shared memory above), and each id's rows summed
//   in sorted order by a segmented scan: shuffles inside a warp, then the
//   warps' carries chained in warp order; an all-zero sum touches no row.
// - Each part writes a compacted partial: the rows it touched in row order
//   (slot = the bitmap's prefix count), its bitmap of those rows and the
//   bitmap's per-word prefix counts.
// - After a grid barrier (the caller's) `combine` adds the partials in
//   ascending part order, a warp a bitmap word, and writes every output
//   row (zero where no part touched it).
//
// A source of points says what each point's row id and row are:
//   uint32_t key(int i, int t): point i's row id (kNoKey: no row, also
//     for i < 0, no point), called by thread t of the block for every
//     position of the part before the sort;
//   void row(int i, int pos, float4 (&q)[kQuarters]): point i's 16-float
//     row, the point at position pos of the part, called after the sort for
//     each point with a row.
// The part's bitmap lives in shared memory, or, for tables whose bitmap
// does not fit there (kGlobalBits), in the part's own words of the partial.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace icet {

constexpr int kThreads = 1024;      // threads a block, one a point of a part
constexpr int kWarps = kThreads / 32;
constexpr int kQuarters = 4;        // float4s of a 16-float row
constexpr int kGather = 2;          // parts whose rows a lane loads at once
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNoKey = 0xffffffffu;

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 shfl4(float4 v, int src) {
  return make_float4(__shfl_sync(kFull, v.x, src), __shfl_sync(kFull, v.y, src),
                     __shfl_sync(kFull, v.z, src), __shfl_sync(kFull, v.w, src));
}

__device__ __forceinline__ float4 shfl_up4(float4 v, int off) {
  return make_float4(__shfl_up_sync(kFull, v.x, off), __shfl_up_sync(kFull, v.y, off),
                     __shfl_up_sync(kFull, v.z, off), __shfl_up_sync(kFull, v.w, off));
}

__device__ __forceinline__ float4 shfl_xor4(float4 v, int mask) {
  return make_float4(__shfl_xor_sync(kFull, v.x, mask), __shfl_xor_sync(kFull, v.y, mask),
                     __shfl_xor_sync(kFull, v.z, mask), __shfl_xor_sync(kFull, v.w, mask));
}

__device__ __forceinline__ bool nonzero(float4 v) {
  return v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f;
}

// Where the partials live: part p's rows (cap x 4 float4s, compacted), its
// bitmap words and their exclusive prefix counts.
struct Partials {
  float4* rows;
  uint32_t* bits;
  int* pre;
  int cap, words;
};

// Sorts one 64-bit key a thread across the block, ascending (bitonic:
// shuffles for partners within a warp, shared memory `s` beyond).
__device__ __forceinline__ unsigned long long block_sort(unsigned long long v,
                                                         unsigned long long* s) {
  const int t = threadIdx.x;
  for (int k = 2; k <= kThreads; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      unsigned long long o;
      if (j >= 32) {
        s[t] = v;
        __syncthreads();
        o = s[t ^ j];
        __syncthreads();
      } else {
        o = __shfl_xor_sync(kFull, v, j);
      }
      const bool keep_min = ((t & j) == 0) == ((t & k) == 0);
      v = keep_min ? (o < v ? o : v) : (o < v ? v : o);
    }
  }
  return v;
}

// The shared memory of the sorted parts.
struct SortSmem {
  unsigned long long keys[kThreads];
  float4 tail[kWarps][kQuarters];   // each warp's last running sum
  float4 carry[kWarps][kQuarters];  // the running sum carried into each warp
  uint32_t tail_key[kWarps], carry_key[kWarps];
  int counts[kWarps], sums[kWarps];
};

// The parts blockIdx.x, + gridDim.x, ... of `chunk` points each, each
// sorted by id and summed in sorted order; then each part's partial.
// `smem_bits` holds a part's bitmap (unused with kGlobalBits).
template <bool kGlobalBits, class Source>
__device__ void sorted_parts(Source& src, int n, int chunk, int parts, const Partials& P,
                             SortSmem& sm, uint32_t* smem_bits) {
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int words = P.words;
  const int per = (words + kThreads - 1) / kThreads;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int part = blockIdx.x; part < parts; part += gridDim.x) {
    const int p0 = part * chunk;
    const int len = max(0, min(chunk, n - p0));
    uint32_t* bits = kGlobalBits ? P.bits + (size_t)part * words : smem_bits;
    for (int w = t; w < words; w += kThreads) bits[w] = 0u;
    uint32_t key = src.key(t < len ? p0 + t : -1, t);
    // Sorted by (id, position): the ties keep the points' order.
    const unsigned long long e = block_sort(((unsigned long long)key << 32) | (unsigned)t, sm.keys);
    key = (uint32_t)(e >> 32);
    float4 q[kQuarters];
#pragma unroll
    for (int c = 0; c < kQuarters; ++c) q[c] = zero;
    if (key != kNoKey) {
      const int pos = (int)(e & 0xffffffffu);
      src.row(p0 + pos, pos, q);
    }
    // Segmented inclusive scan in the warp: each lane adds the running sum
    // `off` lanes back where that lane holds the same id, earlier first.
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t back = __shfl_up_sync(kFull, key, off);
      const bool take = lane >= off && back == key;
#pragma unroll
      for (int c = 0; c < kQuarters; ++c) {
        const float4 o = shfl_up4(q[c], off);
        if (take) q[c] = add4(o, q[c]);
      }
    }
    uint32_t* sorted = reinterpret_cast<uint32_t*>(sm.keys);  // the ids, after the sort
    sorted[t] = key;
    if (lane == 31) {
      sm.tail_key[warp] = key;
#pragma unroll
      for (int c = 0; c < kQuarters; ++c) sm.tail[warp][c] = q[c];
    }
    __syncthreads();
    // The carries, warp by warp in order: four lanes, a column quarter each.
    if (t < kQuarters) {
      uint32_t ck = kNoKey;
      float4 cv = zero;
      for (int w = 0; w < kWarps; ++w) {
        sm.carry_key[w] = ck;
        sm.carry[w][t] = cv;
        const uint32_t tk = sm.tail_key[w];
        cv = tk == ck ? add4(cv, sm.tail[w][t]) : sm.tail[w][t];
        ck = tk;
      }
    }
    __syncthreads();
    if (key != kNoKey && key == sm.carry_key[warp]) {
#pragma unroll
      for (int c = 0; c < kQuarters; ++c) q[c] = add4(sm.carry[warp][c], q[c]);
    }
    // An id's last position holds its sum; its slot is the ids before it.
    // An all-zero sum (non-members' features, all on the sentinel row in
    // every part) touches no row, as in a shared table, so no part sends
    // it to the combine.
    const uint32_t next = t + 1 < kThreads ? sorted[t + 1] : kNoKey;
    const bool last = key != kNoKey && next != key
                      && (nonzero(q[0]) || nonzero(q[1]) || nonzero(q[2]) || nonzero(q[3]));
    const unsigned ends = __ballot_sync(kFull, last);
    if (lane == 0) sm.counts[warp] = __popc(ends);
    if (last) atomicOr(bits + key / 32, 1u << (key % 32));
    __syncthreads();
    if (last) {
      int slot = __popc(ends & ((1u << lane) - 1u));
      for (int w = 0; w < warp; ++w) slot += sm.counts[w];
      float4* dst = P.rows + ((size_t)part * P.cap + slot) * kQuarters;
#pragma unroll
      for (int c = 0; c < kQuarters; ++c) dst[c] = q[c];
    }
    // The bitmap's exclusive prefix counts: a thread a run of words, the
    // runs' counts scanned across the block.  A bitmap in device memory is
    // read past L1, where the other threads' atomics are not.
    const int w0 = min(words, t * per), w1 = min(words, w0 + per);
    int c = 0;
    for (int w = w0; w < w1; ++w) c += __popc(kGlobalBits ? __ldcg(bits + w) : bits[w]);
    int incl = c;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += u;
    }
    if (lane == 31) sm.sums[warp] = incl;
    __syncthreads();
    int run = incl - c;
    for (int w = 0; w < warp; ++w) run += sm.sums[w];
    uint32_t* my_bits = P.bits + (size_t)part * words;
    int* my_pre = P.pre + (size_t)part * words;
    for (int w = w0; w < w1; ++w) {
      const uint32_t word = kGlobalBits ? __ldcg(bits + w) : bits[w];
      if (!kGlobalBits) my_bits[w] = word;
      my_pre[w] = run;
      run += __popc(word);
    }
    __syncthreads();  // before the next part reuses the shared memory
  }
}

// Adds to `acc`, on each lane (row 32 w + lane), the rows of bitmap word w
// that parts lo, lo + 1, ..., hi - 1 touched, in that order: a lane loads
// one part's word and prefix count, 32 parts at a time, and the rows of up
// to kGather parts at once.
__device__ __forceinline__ void add_parts(const Partials& P, int lo, int hi, int w,
                                          float4 (&acc)[kQuarters]) {
  const int lane = threadIdx.x % 32;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int b0 = lo; b0 < hi; b0 += 32) {
    const int b = b0 + lane;
    const uint32_t word = b < hi ? __ldcg(P.bits + (size_t)b * P.words + w) : 0u;
    const int wpre = b < hi ? __ldcg(P.pre + (size_t)b * P.words + w) : 0;
    unsigned todo = __ballot_sync(kFull, word != 0u);
    while (todo) {
      float4 v[kGather][kQuarters];
#pragma unroll
      for (int j = 0; j < kGather; ++j) {
        const int src = todo ? __ffs(todo) - 1 : 0;
        const bool any = todo != 0u;
        todo &= todo - 1u;
        const uint32_t bw = __shfl_sync(kFull, word, src);
        const int bp = __shfl_sync(kFull, wpre, src);
        const bool mine = any && ((bw >> lane) & 1u);
        const int slot = bp + __popc(bw & ((1u << lane) - 1u));
        const float4* row = P.rows + ((size_t)(b0 + src) * P.cap + slot) * kQuarters;
#pragma unroll
        for (int c = 0; c < kQuarters; ++c) v[j][c] = mine ? __ldcg(row + c) : zero;
      }
#pragma unroll
      for (int j = 0; j < kGather; ++j)
#pragma unroll
        for (int c = 0; c < kQuarters; ++c) acc[c] = add4(acc[c], v[j][c]);
    }
  }
}

// The combine of many words after the grid barrier: a warp owns 32 output
// rows (one bitmap word) and its lanes add, part by part in ascending
// order, the rows each part touched.
__device__ void combine(const Partials& P, int parts, int rows, float4* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  const int n_warps = gridDim.x * kWarps;
  for (int w = blockIdx.x * kWarps + threadIdx.x / 32; w < P.words; w += n_warps) {
    float4 acc[kQuarters];
#pragma unroll
    for (int c = 0; c < kQuarters; ++c) acc[c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    add_parts(P, 0, parts, w, acc);
    const int r = 32 * w + lane;
    if (r < rows) {
#pragma unroll
      for (int c = 0; c < kQuarters; ++c) out[(size_t)r * kQuarters + c] = acc[c];
    }
  }
}

}  // namespace icet
