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
// transcendentals a point as fused_moments.cu.  At this size the call is
// set by latency: one pass over the points, then the sum across blocks.
//
// Design, one cooperative launch a call, no memset:
// - Blocks of min(512, block rounded up to 32) threads, as many as can be
//   resident (at most one a point block); each walks point blocks pb =
//   blockIdx.x, + gridDim.x, ... (persistent: a cooperative launch needs
//   every block resident, and a small `block` gives more point blocks than
//   that).  No point is staged in shared memory: a thread keeps the
//   transformed coordinates, range and id of up to kPer points in
//   registers between finding vmin and summing; a point block larger than
//   kPer x threads is binned twice (same code, same bits).
// - Per point block: vmin by warp shuffles and one shared atomicMin; the
//   members' features aggregated across the lanes that share a voxel id
//   (__match_any_sync, ordered shuffles) into a (window, 10) shared table
//   with a bitmap of the rows touched, the groups' lowest lanes adding
//   their sums in a fixed order: warp 0 to the last warp, one turn a warp
//   with a barrier between turns (a warp's leaders hold distinct rows);
//   then only the touched rows are written, compacted
//   in row order (slot = the bitmap's prefix count), beside the bitmap
//   words with their prefix counts, the block's start and its overflow.
// - Grid barrier (cooperative_groups' grid sync), then the combine: a warp
//   owns 32 output rows; a lane finds, for each of 4 x 32 point blocks at
//   a time, the rows of the tile that block touched (from its start and
//   two bitmap words; the loads of the 4 x 32 issued together, so a tile
//   waits on two dependent round trips to L2, not eight), and the tile's
//   rows sum the rows of the point blocks that touched them in ascending
//   point-block order, loading those of up to kGather point blocks at
//   once: a fixed order of addition.  Every output row is written (row V and columns
//   10-15 zero); warp 0 of block 0 sums the overflow counts (an exact
//   integer sum).  Every float addition, in a point block and across them,
//   is in an order the code fixes, so the same inputs and grid give the
//   same bits every launch.
//
// Built without FMA contraction (-fmad=false, see icet_tpu_torch/_build.py)
// and with the operations in the order of the plain PyTorch version, so
// both bin and gate the same points.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kPer = 2;          // points a thread keeps in registers between the passes
constexpr int kFeatures = 10;
constexpr int kRowStride = 12;   // floats of a stored row: three float4s
constexpr int kOutCols = 16;
constexpr int kGather = 4;       // point blocks whose rows a lane loads at once
constexpr int kBatch = 4;        // 32-block groups whose bitmaps a lane loads at once
constexpr int kFar = 1 << 30;    // a window offset past every bitmap
constexpr int kNone = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kTwoPi = 6.28318530717958647692f;

struct Grid {
  int n_voxels, n_theta, n_phi, radial_fixed, n_shells;
  float phi_min, phi_span, min_range, shell_log_growth;
};

struct Rot {
  float r00, r01, r02, r10, r11, r12, r20, r21, r22, tx, ty, tz;
};

struct Point {
  float x, y, z, r;
  int vid;  // kNone when not ok
};

// p' = R p + t, its range and its voxel id, as the plain version computes
// them (see the header).
__device__ __forceinline__ Point bin_point(const float* __restrict__ pts, int i,
                                           const Rot& R, const Grid& g) {
  Point p;
  const float x0 = pts[3 * i], y0 = pts[3 * i + 1], z0 = pts[3 * i + 2];
  p.x = x0 * R.r00 + y0 * R.r01 + z0 * R.r02 + R.tx;
  p.y = x0 * R.r10 + y0 * R.r11 + z0 * R.r12 + R.ty;
  p.z = x0 * R.r20 + y0 * R.r21 + z0 * R.r22 + R.tz;
  const float xs = isfinite(p.x) ? p.x : 0.0f;
  const float ys = isfinite(p.y) ? p.y : 0.0f;
  const float zs = isfinite(p.z) ? p.z : 0.0f;
  p.r = sqrtf(xs * xs + ys * ys + zs * zs);
  p.vid = kNone;
  if (p.r >= g.min_range) {
    float theta = 0.0f, phi = 0.0f;
    if (p.r > 0.0f) {
      theta = atan2f(ys, xs);
      if (theta < 0.0f) theta = theta + kTwoPi;
      phi = acosf(fminf(fmaxf(zs / p.r, -1.0f), 1.0f));
    }
    int itheta = (int)(theta / kTwoPi * (float)g.n_theta);
    itheta = min(max(itheta, 0), g.n_theta - 1);
    const int iphi = (int)floorf((phi - g.phi_min) / g.phi_span * (float)g.n_phi);
    if (iphi >= 0 && iphi < g.n_phi) {
      p.vid = iphi * g.n_theta + itheta;
      if (g.radial_fixed) {
        const float safe_r = fmaxf(p.r, g.min_range);
        const int shell = (int)floorf(logf(safe_r / g.min_range) / g.shell_log_growth);
        p.vid = (shell >= 0 && shell < g.n_shells) ? shell * (g.n_theta * g.n_phi) + p.vid
                                                   : kNone;
      }
    }
  }
  return p;
}

__global__ void __launch_bounds__(kMaxThreads)
windowed_kernel(const float* __restrict__ pts, int n, const float* __restrict__ X,
                const float* __restrict__ bounds, const float* __restrict__ anchors, Grid g,
                int block, int window, int v_pad, int nb, int cap, int words,
                float* __restrict__ prow, int2* __restrict__ pbits, int* __restrict__ phead,
                float* __restrict__ out, int* __restrict__ out_overflow) {
  extern __shared__ float smem[];
  float* table = smem;                                           // window x 10
  uint32_t* bits = reinterpret_cast<uint32_t*>(table + window * kFeatures);  // words
  int* pre = reinterpret_cast<int*>(bits + words);               // words
  __shared__ int s_vmin, s_ovf;

  const int T = blockDim.x, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int chunk = T * kPer;

  // euler_R(-X[3:6]), entry by entry as geometry.euler_R forms it.
  Rot R;
  {
    const float cf = cosf(-X[3]), sf = sinf(-X[3]);
    const float ct = cosf(-X[4]), st = sinf(-X[4]);
    const float cp = cosf(-X[5]), sp = sinf(-X[5]);
    R.r00 = ct * cp; R.r01 = sp * cf + sf * st * cp; R.r02 = sf * sp - st * cf * cp;
    R.r10 = -sp * ct; R.r11 = cf * cp - sf * st * sp; R.r12 = sf * cp + st * sp * cf;
    R.r20 = st; R.r21 = -sf * ct; R.r22 = cf * ct;
    R.tx = X[0]; R.ty = X[1]; R.tz = X[2];
  }

  for (int pb = blockIdx.x; pb < nb; pb += gridDim.x) {
    const int base = pb * block;
    const int len = min(block, n - base);
    for (int i = tid; i < window * kFeatures; i += T) table[i] = 0.0f;
    for (int i = tid; i < words; i += T) bits[i] = 0u;
    if (tid == 0) {
      s_vmin = kNone;
      s_ovf = 0;
    }

    // Pass 1: bin the points, keeping the last chunk's in registers.
    Point p[kPer];
    int local_min = kNone;
    for (int c0 = 0; c0 < len; c0 += chunk) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int k = c0 + j * T + tid;
        p[j].vid = kNone;
        if (k < len) p[j] = bin_point(pts, base + k, R, g);
        local_min = min(local_min, p[j].vid);
      }
    }
    for (int off = 16; off > 0; off >>= 1)
      local_min = min(local_min, __shfl_xor_sync(kFull, local_min, off));
    __syncthreads();  // the table, bitmap and s_vmin are zeroed
    if (lane == 0) atomicMin(&s_vmin, local_min);
    __syncthreads();
    const int vmin = s_vmin == kNone ? 0 : s_vmin;
    const int start = max(min((vmin / 128) * 128, v_pad - window), 0);
    const int stop = start + window - 1;

    // Pass 2: gate, aggregate and sum the in-window members.
    int local_ovf = 0;
    for (int c0 = 0; c0 < len; c0 += chunk) {
      if (len > chunk) {  // the same for every thread of the block
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int k = c0 + j * T + tid;
          p[j].vid = kNone;
          if (k < len) p[j] = bin_point(pts, base + k, R, g);
        }
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (c0 + j * T >= len) break;  // the same for every thread of the block
        const int v = p[j].vid;
        bool member = false;
        float f[kFeatures] = {};
        if (v != kNone) {
          if (v < start || v >= stop) {
            ++local_ovf;
          } else {
            // The row's bounds and anchor loaded together: one round trip.
            const float lo = __ldg(bounds + 2 * v), hi = __ldg(bounds + 2 * v + 1);
            const float ax = __ldg(anchors + 3 * v), ay = __ldg(anchors + 3 * v + 1);
            const float az = __ldg(anchors + 3 * v + 2);
            if (p[j].r >= lo && p[j].r <= hi) {
              member = true;
              const float gx = p[j].x - ax, gy = p[j].y - ay, gz = p[j].z - az;
              f[0] = 1.0f; f[1] = gx; f[2] = gy; f[3] = gz;
              f[4] = gx * gx; f[5] = gy * gy; f[6] = gz * gz;
              f[7] = gx * gy; f[8] = gx * gz; f[9] = gy * gz;
            }
          }
        }
        // Warp aggregation: non-members share the key -1 and add nothing.
        const int key = member ? v - start : -1;
        const unsigned group = __match_any_sync(kFull, key);
        const bool leader = member && lane == __ffs(group) - 1;
        unsigned rest = leader ? group & (group - 1u) : 0u;  // the group less its leader
        float s[kFeatures];
#pragma unroll
        for (int k = 0; k < kFeatures; ++k) s[k] = f[k];
        while (__any_sync(kFull, rest != 0u)) {
          const int src = rest ? __ffs(rest) - 1 : lane;
#pragma unroll
          for (int k = 0; k < kFeatures; ++k) {
            const float w = __shfl_sync(kFull, f[k], src);
            if (rest) s[k] += w;
          }
          rest &= rest - 1u;
        }
        if (leader) atomicOr(bits + key / 32, 1u << (key % 32));
        // The leaders' adds, warp by warp: a fixed order of addition (within
        // a warp the leaders' rows are distinct).
        for (int turn = 0; turn < T / 32; ++turn) {
          if (leader && warp == turn) {
            float* row = table + key * kFeatures;
#pragma unroll
            for (int k = 0; k < kFeatures; ++k) row[k] += s[k];
          }
          __syncthreads();
        }
      }
    }
    for (int off = 16; off > 0; off >>= 1) local_ovf += __shfl_xor_sync(kFull, local_ovf, off);
    if (lane == 0 && local_ovf) atomicAdd(&s_ovf, local_ovf);
    __syncthreads();

    // Exclusive prefix counts of the bitmap's words (warp 0).
    if (tid < 32) {
      const int per = (words + 31) / 32;
      const int w0 = min(words, lane * per), w1 = min(words, w0 + per);
      int c = 0;
      for (int w = w0; w < w1; ++w) c += __popc(bits[w]);
      int incl = c;
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += u;
      }
      int run = incl - c;
      for (int w = w0; w < w1; ++w) {
        pre[w] = run;
        run += __popc(bits[w]);
      }
    }
    __syncthreads();

    // The point block's partial: start and overflow, bitmap words with their
    // prefix counts, and the touched rows compacted in row order.
    if (tid == 0) {
      phead[2 * pb] = start;
      phead[2 * pb + 1] = s_ovf;
    }
    for (int w = tid; w < words; w += T)
      pbits[(size_t)pb * words + w] = make_int2((int)bits[w], pre[w]);
    for (int r = tid; r < window - 1; r += T) {
      const uint32_t word = bits[r / 32];
      if ((word >> (r % 32)) & 1u) {
        const int slot = pre[r / 32] + __popc(word & ((1u << (r % 32)) - 1u));
        const float* t = table + r * kFeatures;
        float4* dst = reinterpret_cast<float4*>(prow + ((size_t)pb * cap + slot) * kRowStride);
        dst[0] = make_float4(t[0], t[1], t[2], t[3]);
        dst[1] = make_float4(t[4], t[5], t[6], t[7]);
        dst[2] = make_float4(t[8], t[9], 0.0f, 0.0f);
      }
    }
    __syncthreads();  // before the next point block zeroes the table
  }

  // Grid barrier: every point block's partial is written and visible.
  cooperative_groups::this_grid().sync();

  const int warps = T / 32;
  const int gw = blockIdx.x * warps + tid / 32, n_warps = gridDim.x * warps;
  if (gw == 0) {
    int total = 0;
    for (int b = lane; b < nb; b += 32) total += __ldcg(phead + 2 * b + 1);
    for (int off = 16; off > 0; off >>= 1) total += __shfl_xor_sync(kFull, total, off);
    if (lane == 0) *out_overflow = total;
  }
  const int rows = g.n_voxels + 1;
  const unsigned below = (1u << lane) - 1u;
  for (int t = gw; t < (rows + 31) / 32; t += n_warps) {
    const int r0 = 32 * t;
    float acc[kFeatures] = {};
    for (int b0 = 0; b0 < nb; b0 += 32 * kBatch) {
      // This lane's point blocks b0 + 32 j + lane: the tile's rows each
      // touched (bit l for row r0 + l) and the slot of the first of them.
      // Each of the two dependent loads is issued for all kBatch point
      // blocks before any is used.
      int lo[kBatch];  // window offset of row r0 (kFar past the last block)
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int b = b0 + 32 * j + lane;
        lo[j] = b < nb ? r0 - __ldcg(phead + 2 * b) : kFar;
      }
      int2 a[kBatch];
      int hi[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const size_t w = (size_t)(b0 + 32 * j + lane) * words;
        const int q = lo[j] >> 5;  // floor division
        a[j] = make_int2(0, 0);
        hi[j] = 0;
        if (q >= 0 && q < words) a[j] = __ldcg(pbits + w + q);
        if (q + 1 >= 0 && q + 1 < words) hi[j] = __ldcg(&pbits[w + q + 1].x);
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int sh = lo[j] & 31;
        const uint32_t touched = __funnelshift_r((uint32_t)a[j].x, (uint32_t)hi[j], sh);
        const int first = a[j].y + __popc((uint32_t)a[j].x & ((1u << sh) - 1u));
        const size_t b_base = (size_t)(b0 + 32 * j) * cap;
        unsigned todo = __ballot_sync(kFull, touched != 0u);
        while (todo) {
          float v[kGather][kFeatures];
#pragma unroll
          for (int k = 0; k < kGather; ++k) {
            const bool any = todo != 0u;
            const int src = any ? __ffs(todo) - 1 : 0;
            todo &= todo - 1u;
            const uint32_t tb = __shfl_sync(kFull, touched, src);
            const int slot = __shfl_sync(kFull, first, src) + __popc(tb & below);
            const bool mine = any && ((tb >> lane) & 1u);
            const float4* row = reinterpret_cast<const float4*>(
                prow + (b_base + (size_t)src * cap + slot) * kRowStride);
            float4 u0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), u1 = u0, u2 = u0;
            if (mine) {
              u0 = __ldcg(row);
              u1 = __ldcg(row + 1);
              u2 = __ldcg(row + 2);
            }
            v[k][0] = u0.x; v[k][1] = u0.y; v[k][2] = u0.z; v[k][3] = u0.w;
            v[k][4] = u1.x; v[k][5] = u1.y; v[k][6] = u1.z; v[k][7] = u1.w;
            v[k][8] = u2.x; v[k][9] = u2.y;
          }
#pragma unroll
          for (int k = 0; k < kGather; ++k)
#pragma unroll
            for (int c = 0; c < kFeatures; ++c) acc[c] += v[k][c];
        }
      }
    }
    const int r = r0 + lane;
    if (r < rows) {
      float4* o = reinterpret_cast<float4*>(out + (size_t)r * kOutCols);
      const bool voxel = r < rows - 1;  // row V, the sentinel, stays zero
      o[0] = voxel ? make_float4(acc[0], acc[1], acc[2], acc[3]) : make_float4(0, 0, 0, 0);
      o[1] = voxel ? make_float4(acc[4], acc[5], acc[6], acc[7]) : make_float4(0, 0, 0, 0);
      o[2] = voxel ? make_float4(acc[8], acc[9], 0.0f, 0.0f) : make_float4(0, 0, 0, 0);
      o[3] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
}

struct Plan {
  int device = -1, threads = 0, smem = 0, blocks = 0;
};

// Resident blocks of the kernel on the current device at this block size
// and shared memory (a cooperative launch takes no more), with the
// shared-memory opt-in above 48 KB; kept for the last size asked.
cudaError_t resident_blocks(int threads, int smem, int* blocks) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  static Plan last[64];
  Plan* plan = device < 64 ? &last[device] : nullptr;
  if (plan && plan->threads == threads && plan->smem == smem) {
    *blocks = plan->blocks;
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(windowed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, windowed_kernel, threads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  *blocks = per_sm * sms;
  if (plan) *plan = Plan{device, threads, smem, *blocks};
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block, in bytes: the (window, 10) table,
// the bitmap and its prefix counts.
int icet_windowed_shared_bytes(int window) {
  const int words = (window + 31) / 32;
  return window * kFeatures * (int)sizeof(float) + 2 * words * 4;
}

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = ok).
// pts (n, 3), X (6,), bounds (V+1, 2), anchors (V+1, 3) and out (V+1, 16)
// are float32 device arrays, out_overflow (1,) int32.  scratch (16-byte
// aligned) holds nb * cap * 12 floats of compacted rows, nb * words int2
// bitmap words with their prefix counts and nb * 2 ints of starts and
// overflow counts, with nb = ceil(n / block), words = ceil(window / 32) and
// cap >= the rows one point block can touch.  `threads` a block, a
// multiple of 32 up to 512.  A cooperative launch with as many blocks as
// can be resident, at most nb: it fails, rather than waits, if they cannot.
int icet_fused_moment_sums_windowed(
    const void* pts, int n, const void* X, const void* bounds, const void* anchors,
    int n_voxels, int n_theta, int n_phi, float phi_min, float phi_span, float min_range,
    int radial_fixed, int n_shells, float shell_log_growth, int block, int window, int v_pad,
    int threads, int cap, void* scratch, void* out, void* out_overflow, void* stream) {
  int nb = (n + block - 1) / block;
  int words = (window + 31) / 32;
  const int smem = icet_windowed_shared_bytes(window);
  int resident = 0;
  cudaError_t err = resident_blocks(threads, smem, &resident);
  if (err != cudaSuccess) return (int)err;
  int blocks = max(1, min(nb, resident));
  Grid g{n_voxels, n_theta, n_phi, radial_fixed, n_shells,
         phi_min, phi_span, min_range, shell_log_growth};
  float* prow = static_cast<float*>(scratch);
  int2* pbits = reinterpret_cast<int2*>(prow + (size_t)nb * cap * kRowStride);
  int* phead = reinterpret_cast<int*>(pbits + (size_t)nb * words);
  const float* p_pts = static_cast<const float*>(pts);
  const float* p_X = static_cast<const float*>(X);
  const float* p_bounds = static_cast<const float*>(bounds);
  const float* p_anchors = static_cast<const float*>(anchors);
  float* p_out = static_cast<float*>(out);
  int* p_ovf = static_cast<int*>(out_overflow);
  void* args[] = {&p_pts, &n, &p_X, &p_bounds, &p_anchors, &g, &block, &window, &v_pad,
                  &nb, &cap, &words, &prow, &pbits, &phead, &p_out, &p_ovf};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(windowed_kernel),
                                    dim3(blocks), dim3(threads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* icet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
