// Moment scatter: out[vid[i], f] += feats[i, f] for N points and 16
// feature columns, the accumulator of moment_method="pallas" and of the
// plain moments route on the card.  Ids outside [0, rows) are dropped.
//
// Replaces the TPU kernel icet_tpu/ops/pallas_moments.py::_moment_kernel
// (wrapper pallas_moment_sums, pallas_call at pallas_moments.py:86), which
// built a (block, V) one-hot matrix in VMEM and contracted it with the
// feature block on the MXU; an id that matches no one-hot column (negative,
// or past the table) adds nothing, and so it is dropped here.  On Hopper
// there is no one-hot: the rows are summed by id.
//
// Bound on the card: the call must read the ids and the features (68 B a
// point, 4.46 MB at N = 65,536) and write the (V+1, 16) table (115 KB at
// V = 1,800; 5.76 MB at fixed radial mode's 90,001 rows): 1.36 us and
// 3.05 us at 3.35 TB/s.  One add a feature element, so bytes bound it.  At
// these sizes the call is set by latency: the loads in flight, the adds
// that collide on one row, and the sum across blocks.
//
// Every float addition is in an order the code fixes, so the same inputs
// give the same bits every launch.  Design, one cooperative launch a call,
// no memset:
// - The points are cut into parts, each a contiguous slice; a part's sums
//   go to a compacted partial: the rows it touched in row order (slot =
//   the bitmap's prefix count), its bitmap of those rows and the bitmap's
//   per-word prefix counts.
// - Tables of up to 3,631 rows (the drive's 1,801): one part a block, at
//   most one block of 1,024 threads an SM, the whole table in the block's
//   shared memory.  Four lanes a point, each loading one 16-byte quarter
//   of its 64-byte row (a warp reads 8 consecutive rows, 512 contiguous
//   bytes); a round takes two sets of 256 points (one round a block at
//   N = 65,536), the next round's loads issued before this round's adds.
//   Warp aggregation, each set on its own: the lanes of one column quarter
//   that share an id form a group (__match_any_sync); the group's lowest
//   lane sums the group's float4s (a shuffle tree when the whole warp
//   shares one id, the common case of a beam-major scan, else ordered
//   shuffles).  The groups' sums are added round by round, and within a
//   round warp 0 to warp 31, one turn a warp with a barrier between turns,
//   the warp's first set before its second (a set's leaders hold distinct
//   cells); an all-zero sum (a non-member's features) is skipped.  The
//   rows touched are the nonzero ones (a row whose sums cancel to zero is
//   written as zero either way).
// - Larger tables (fixed radial mode's 90,001 rows): parts of at most
//   1,024 points, each block walking parts blockIdx.x, + gridDim.x, ...
//   A part's (id, position) keys are sorted in the block (a bitonic sort,
//   shuffles below a distance of 32, shared memory above), and each id's
//   rows summed in sorted order by a segmented scan: shuffles inside a
//   warp, then the warps' carries chained in warp order; an all-zero sum
//   touches no row.  This branch is csrc/sorted_parts.cuh, which kernel #1
//   (csrc/fused_moments.cu) shares for its own large tables.
// - After a grid barrier (cooperative_groups' grid sync: the launch is
//   cooperative, so all blocks are resident) the partials are added in
//   ascending part order and every output row is written (zero where no
//   part touched it).  A shared table's few bitmap words (57 at V + 1 =
//   1,801) take a block each: its warps split the parts into contiguous
//   runs, a lane (a row) sums its run, loading the rows of two parts at
//   once, and warp 0 adds the runs in warp order.  A large table's many
//   words (2,813 at 90,001 rows) take a warp each, its lanes adding part
//   after part (64 parts of 1,024 points at N = 65,536).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sorted_parts.cuh"

namespace {

using icet::add4;
using icet::add_parts;
using icet::kFull;
using icet::kNoKey;
using icet::kQuarters;
using icet::kThreads;
using icet::kWarps;
using icet::nonzero;
using icet::Partials;
using icet::shfl4;
using icet::shfl_xor4;
using icet::SortSmem;

constexpr int kPointsPerRound = kThreads / kQuarters;  // 256, a set
constexpr int kSets = 2;                              // sets of points a round
constexpr int kMaxWordsPerWarp = 4;                   // bitmap words of a warp, shared table

// Sums into f, on the lowest lane of each group of lanes with the same key
// and the same column quarter, the group's float4s; returns true on that
// lane when its key is a row (>= 0).  Every lane of the warp calls it.
__device__ __forceinline__ bool aggregate(int key, float4& f) {
  const int lane = threadIdx.x % 32;
  const unsigned same = __match_any_sync(kFull, key);
  if (same == kFull) {  // one key in the whole warp: a tree over the 8 points
    f = add4(f, shfl_xor4(f, 4));
    f = add4(f, shfl_xor4(f, 8));
    f = add4(f, shfl_xor4(f, 16));
    return key >= 0 && lane < kQuarters;
  }
  const unsigned group = same & (0x11111111u << (lane % kQuarters));
  const bool leader = key >= 0 && lane == __ffs(group) - 1;
  unsigned rest = leader ? group & (group - 1u) : 0u;  // the group less its leader
  const float4 mine = f;
  while (__any_sync(kFull, rest != 0u)) {
    const float4 v = shfl4(mine, rest ? __ffs(rest) - 1 : lane);
    if (rest) f = add4(f, v);
    rest &= rest - 1u;
  }
  return leader;
}

// The id (-1 when outside [0, rows) or past the slice) and the features'
// quarter of point i.
__device__ __forceinline__ void load_point(const int* __restrict__ vid,
                                           const float4* __restrict__ feats, int i, int p1,
                                           int rows, int& key, float4& f) {
  key = -1;
  f = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (i < p1) {
    const int v = __ldg(vid + i);
    f = __ldg(feats + (size_t)i * kQuarters + threadIdx.x % kQuarters);
    if ((unsigned)v < (unsigned)rows) key = v;
  }
}

// The block's share of the points as one part: the whole table in shared
// memory, the groups' sums added warp by warp; then the part's partial.
__device__ void shared_part(const int* __restrict__ vid, const float4* __restrict__ feats,
                            int n, int chunk, int rows, const Partials& P, float4* table) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int quarter = threadIdx.x % kQuarters;
  const int part = blockIdx.x;
  const int p0 = part * chunk;
  const int p1 = min(n, p0 + chunk);
  // The first round's points, loaded before the zeroing so the loads overlap it.
  int next_key[kSets];
  float4 next_f[kSets];
#pragma unroll
  for (int s = 0; s < kSets; ++s)
    load_point(vid, feats, p0 + s * kPointsPerRound + threadIdx.x / kQuarters, p1, rows,
               next_key[s], next_f[s]);
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int k = threadIdx.x; k < rows * kQuarters; k += kThreads) table[k] = zero;
  __syncthreads();

  // Every thread of the block runs the same number of rounds, so each
  // round's warp-wide collectives and barriers see every thread.
  for (int base = p0; base < p1; base += kSets * kPointsPerRound) {
    int key[kSets];
    float4 f[kSets];
    bool lead[kSets];
#pragma unroll
    for (int s = 0; s < kSets; ++s) {
      key[s] = next_key[s];
      f[s] = next_f[s];
      load_point(vid, feats, base + (kSets + s) * kPointsPerRound + threadIdx.x / kQuarters,
                 p1, rows, next_key[s], next_f[s]);
    }
#pragma unroll
    for (int s = 0; s < kSets; ++s) lead[s] = aggregate(key[s], f[s]) && nonzero(f[s]);
    for (int turn = 0; turn < kWarps; ++turn) {
      if (warp == turn) {
#pragma unroll
        for (int s = 0; s < kSets; ++s) {
          if (lead[s]) {
            float4* cell = table + key[s] * kQuarters + quarter;
            *cell = add4(*cell, f[s]);
          }
          __syncwarp();
        }
      }
      __syncthreads();
    }
  }
  __syncthreads();

  // The touched rows' bitmap, a warp a contiguous run of words held in
  // registers, and the runs' counts (at most 128 rows each) in the bytes
  // after the table.
  const int words = P.words;
  const int per = (words + kWarps - 1) / kWarps;
  const int w0 = min(words, warp * per), w1 = min(words, w0 + per);
  uint32_t wb[kMaxWordsPerWarp];
  int count = 0;
#pragma unroll
  for (int k = 0; k < kMaxWordsPerWarp; ++k) {
    const int r = 32 * (w0 + k) + lane;
    bool touched = false;
    if (w0 + k < w1 && r < rows) {
      const float4* row = table + r * kQuarters;
      touched = nonzero(row[0]) || nonzero(row[1]) || nonzero(row[2]) || nonzero(row[3]);
    }
    wb[k] = __ballot_sync(kFull, touched);
    count += __popc(wb[k]);
  }
  uint8_t* counts = reinterpret_cast<uint8_t*>(table + rows * kQuarters);
  if (lane == 0) counts[warp] = (uint8_t)count;
  __syncthreads();
  int slot0 = 0;
  for (int k = 0; k < warp; ++k) slot0 += counts[k];
  uint32_t* my_bits = P.bits + (size_t)part * words;
  int* my_pre = P.pre + (size_t)part * words;
  float4* my_rows = P.rows + (size_t)part * P.cap * kQuarters;
#pragma unroll
  for (int k = 0; k < kMaxWordsPerWarp; ++k) {
    const int w = w0 + k;
    if (w < w1) {
      if (lane == 0) {
        my_bits[w] = wb[k];
        my_pre[w] = slot0;
      }
      if ((wb[k] >> lane) & 1u) {
        const int slot = slot0 + __popc(wb[k] & ((1u << lane) - 1u));
        const float4* row = table + (32 * w + lane) * kQuarters;
#pragma unroll
        for (int q = 0; q < kQuarters; ++q) my_rows[slot * kQuarters + q] = row[q];
      }
      slot0 += __popc(wb[k]);
    }
  }
}

// The ids and features of the moment scatter's points, for the sorted
// parts: a point's key is its id where in [0, rows), its row its features.
struct ScatterSource {
  const int* vid;
  const float4* feats;
  int rows;
  __device__ __forceinline__ uint32_t key(int i, int) const {
    if (i < 0) return kNoKey;
    const int v = __ldg(vid + i);
    return (unsigned)v < (unsigned)rows ? (uint32_t)v : kNoKey;
  }
  __device__ __forceinline__ void row(int i, int, float4 (&q)[kQuarters]) const {
    const float4* src = feats + (size_t)i * kQuarters;
#pragma unroll
    for (int c = 0; c < kQuarters; ++c) q[c] = __ldg(src + c);
  }
};

// The combine of few words: a block a word, its warps splitting the parts
// into contiguous runs, each lane (a row) summing its run in ascending part
// order; the runs' sums added in warp order by warp 0.
__device__ void combine_by_block(const Partials& P, int parts, int rows,
                                 float4* __restrict__ out, float4* runs) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int b_lo = parts * warp / kWarps, b_hi = parts * (warp + 1) / kWarps;
  for (int w = blockIdx.x; w < P.words; w += gridDim.x) {
    float4 acc[kQuarters];
#pragma unroll
    for (int c = 0; c < kQuarters; ++c) acc[c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    add_parts(P, b_lo, b_hi, w, acc);
#pragma unroll
    for (int c = 0; c < kQuarters; ++c) runs[(warp * 32 + lane) * kQuarters + c] = acc[c];
    __syncthreads();
    const int r = 32 * w + lane;
    if (warp == 0 && r < rows) {
      float4 sum[kQuarters];
#pragma unroll
      for (int c = 0; c < kQuarters; ++c) sum[c] = runs[lane * kQuarters + c];
      for (int wp = 1; wp < kWarps; ++wp)
#pragma unroll
        for (int c = 0; c < kQuarters; ++c)
          sum[c] = add4(sum[c], runs[(wp * 32 + lane) * kQuarters + c]);
#pragma unroll
      for (int c = 0; c < kQuarters; ++c) out[(size_t)r * kQuarters + c] = sum[c];
    }
    __syncthreads();
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads, 1)
scatter_kernel(const int* __restrict__ vid, const float4* __restrict__ feats, int n,
               int chunk, int parts, int rows, Partials P, float4* __restrict__ out) {
  extern __shared__ float4 smem[];
  if (kShared) {
    shared_part(vid, feats, n, chunk, rows, P, smem);
  } else {
    SortSmem& sm = *reinterpret_cast<SortSmem*>(smem);
    ScatterSource src{vid, feats, rows};
    icet::sorted_parts<false>(src, n, chunk, parts, P, sm,
                               reinterpret_cast<uint32_t*>(&sm + 1));
  }
  // Grid barrier: every part's partial is written and visible.
  cooperative_groups::this_grid().sync();
  if (kShared) combine_by_block(P, parts, rows, out, smem);
  else icet::combine(P, parts, rows, out);
}

// Above 48 KB of dynamic shared memory needs an opt-in, which is kept per
// device and variant: set it once a device, variant and size (the current
// device may differ from one call to the next).
template <bool kShared>
cudaError_t opt_in_shared(int smem) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  static int opted_in[64] = {};
  if (device < 64 && opted_in[device] >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(scatter_kernel<kShared>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && device < 64) opted_in[device] = smem;
  return err;
}

// Dynamic shared memory of one block: the table and its warps' counts, or
// the combine's run sums if larger (shared); or the sort's buffers and the
// part's bitmap of `rows` rows.
int smem_bytes(int rows, bool shared) {
  const int words = (rows + 31) / 32;
  return shared ? max(rows * kQuarters * (int)sizeof(float4) + kWarps,
                     kThreads * kQuarters * (int)sizeof(float4))
                : (int)sizeof(SortSmem) + words * (int)sizeof(uint32_t);
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`: `blocks` blocks, `parts` parts of
// `chunk` points each (shared: one a block), the table in shared memory
// when `shared` is nonzero.  vid (n,) int32, feats (n, 16) float32
// (16-byte aligned), out (rows, 16) float32, scratch parts * cap * 16
// floats of compacted rows (cap >= the rows one part can touch), then
// parts * words bitmap words and parts * words prefix counts (words =
// ceil(rows / 32)), all device arrays.  A cooperative launch: it fails,
// rather than waits, if the blocks cannot all be resident.  Returns
// cudaGetLastError() (0 = ok).
int icet_moment_scatter(const void* vid, const void* feats, int n, int rows, void* out,
                        void* scratch, int blocks, int chunk, int parts, int cap, int shared,
                        void* stream) {
  const int* p_vid = static_cast<const int*>(vid);
  const float4* p_feats = static_cast<const float4*>(feats);
  float4* p_out = static_cast<float4*>(out);
  Partials P;
  P.cap = cap;
  P.words = (rows + 31) / 32;
  P.rows = static_cast<float4*>(scratch);
  P.bits = reinterpret_cast<uint32_t*>(P.rows + (size_t)parts * cap * kQuarters);
  P.pre = reinterpret_cast<int*>(P.bits + (size_t)parts * P.words);
  void* args[] = {&p_vid, &p_feats, &n, &chunk, &parts, &rows, &P, &p_out};
  const int smem = smem_bytes(rows, shared != 0);
  cudaError_t err = shared ? opt_in_shared<true>(smem) : opt_in_shared<false>(smem);
  if (err != cudaSuccess) return (int)err;
  const void* kernel = shared ? reinterpret_cast<const void*>(scatter_kernel<true>)
                              : reinterpret_cast<const void*>(scatter_kernel<false>);
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* icet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
