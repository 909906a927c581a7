// K-neighbour candidate scan over one sorted suffix order.
//
// Replaces: zzflate_tpu/ops/pallas_kernels.py scan_candidates (_scan_kernel),
// called from zzflate_tpu/ops/matcher.py _scan_order.
//
// For sorted element i and k = 1..K the LCP to i-k is the running min of
// adj over (i-k, i], capped at lcp_cap; the candidate distance
// spos[i] - spos[i-k] is accepted when 1 <= d <= 32768 and the source is
// at or after the row's window_start. The same runs forward (i+k) unless
// backward_only. The longest length wins, then the smallest distance.
// Neighbours outside [0, n) of their own row are rejected (the TPU kernel
// pads them with position -2^30, which fails the distance test). A negative
// LCP is taken as 0, which is what the reference makes of it (no candidate).
// Exact for positions in [0, 2^30), which the matcher hands in (spos is a
// permutation of 0..n-1).
//
// Bound on the H100: operations for K = 16 both ways, bytes for K <= 8
// backward. Each element reads adj and spos and writes two outputs (16 B:
// 75.5 MB at (16, 294912), 22.5 us at 3.35 TB/s). Each neighbour-direction
// needs 3 operations on the 64-lane integer pipe (the running min, one range
// compare, one max); its two adds (cpos - lo and the key's m + cpos) can
// issue on the FMA pipe as IMAD, which has 64 lanes of its own. So K = 16
// both ways is 32 x 3 per element, 27 us of integer pipe. This kernel issues
// the same 3 there (VIMNMX, ISETP, and a DPX add-max VIADDMNMX that fuses
// the key's add) and the subtract on the FMA pipe. The design:
//   One packed key and one max per candidate. "Longest, then nearest" is a
//      lexicographic max of (len, -dist); with len < 2^15 and dist in
//      [1, 32768] the key len << 15 | (32768 - dist) orders candidates the
//      same way, and equal keys are equal (len, dist). In the loop the key is
//      (m << 15) + cpos (the per-element 32768 - p0 is added once at the
//      end), and the validity test is one range, lo = max(ws, p0 - 32768) <=
//      cpos <= p0 - 1, taken as one unsigned compare of cpos - lo against
//      p0 - 1 - lo. An empty range moves lo above every position. The LCPs
//      are capped and shifted once per window value, so the running min is
//      already m << 15, and the key's add and the max fuse into one Hopper
//      DPX add-max (VIADDMNMX) under the range predicate: a
//      neighbour-direction is a min, a subtract, a compare and a predicated
//      add-max. A candidate whose running min is 0 unpacks to (0, 0), as the
//      reference's `ln > 0` gate leaves it.
//   Register windows. Each thread scores kE consecutive sorted elements from
//      a register window of kE + 2H values of adj and of spos (H = K rounded
//      up to 4), read from the staged tile with 16-byte shared-memory loads;
//      K is a template parameter (every K that levels 1-6 use) and the
//      loops are unrolled, so there is no shared-memory access per
//      neighbour. Any other K takes one runtime-K instance of the same
//      kernel, which reads the neighbours from the staged tile.
//   Loads overlapped with the scoring. A persistent grid (the occupancy's
//      blocks on every SM) walks the (row, tile) space; each block keeps the
//      next tile's copy in flight (cp.async, 16 bytes a thread, into a
//      two-stage ring) while it scores the current one. A tile is kTile
//      elements plus an H halo each side; every 32 staged words carry 4 pad
//      words, so the 16-byte window loads of a quarter warp (stride kE
//      words) fall on distinct banks.
// Measured at (16, 294912) (PERF.md §6): kE = 4 beats 8 (8 writes its
// outputs in half-sector pieces and halves the tiles per block), the
// persistent grid beats one block per tile, and two stages beat three.
// K = 16 both ways is held by the integer pipe: with its global loads and
// stores cut out it still takes 47 of its 54 us.
#include <climits>
#include <cuda_runtime.h>

#include "kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr int kE = 4;  // elements a thread scores
constexpr int kTile = kThreads * kE;
constexpr int kWindow = 32768;
constexpr int kPadPos = -(1 << 30);

static_assert(kE % 4 == 0, "windows are read 16 bytes at a time");

__host__ __device__ constexpr int halo_of(int k) { return (k + 3) & ~3; }

// Words of one staged array: kTile + 2h logical words, 4 pad words per 32.
__host__ __device__ constexpr int stage_words(int h) {
  return kTile + 2 * h + ((kTile + 2 * h) >> 5) * 4 + 4;
}

__device__ __forceinline__ int phys(int w) { return w + ((w >> 5) << 2); }

// An LCP clamped to [0, cap] (one DPX min-relu) and moved to the key's
// length field.
__device__ __forceinline__ int shifted(int adj, int cap) {
  return static_cast<int>(static_cast<unsigned>(__vimin_s32_relu(adj, cap))
                          << 15);
}

__device__ __forceinline__ void cp_async16(int* dst, const int* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

struct Args {
  const int* adj;
  const int* spos;
  const int* wstart;
  int* out_len;
  int* out_dist;
  int n;
  int k_each;  // read by the runtime-K instance
  int lcp_cap;
  int backward_only;  // read by the runtime-K instance
  int vec;  // n % 4 == 0 and every pointer 16-byte aligned
  int tiles_per_row;
  int ntiles;
};

// Issue the copies of one tile (and its halo) into a stage; pads outside
// the row are stored directly.
__device__ __forceinline__ void stage_tile(const Args& a, int tile, int h,
                                           int* s_adj, int* s_pos) {
  const int row = tile / a.tiles_per_row;
  const int g0 = (tile - row * a.tiles_per_row) * kTile - h;
  const long long off = static_cast<long long>(row) * a.n;
  const int chunks = (kTile + 2 * h) / 4;
  for (int c = threadIdx.x; c < chunks; c += kThreads) {
    const int g = g0 + 4 * c;
    int* da = s_adj + phys(4 * c);
    int* dp = s_pos + phys(4 * c);
    if (a.vec && g >= 0 && g + 4 <= a.n) {
      cp_async16(da, a.adj + off + g);
      cp_async16(dp, a.spos + off + g);
      continue;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (g + q >= 0 && g + q < a.n) {
        cp_async4(da + q, a.adj + off + g + q);
        cp_async4(dp + q, a.spos + off + g + q);
      } else {
        da[q] = 0;
        dp[q] = kPadPos;
      }
    }
  }
}

// The best packed key of one element over its neighbours in one direction.
// wa(j): min(adj, cap) << 15 and wp(j): spos at window index j (the element
// is at index c).
template <int K, int kDir, class A, class P>
__device__ __forceinline__ int best_key(A wa, P wp, int c, int kk, int cap,
                                        int lo, unsigned span, int best) {
  int m = cap << 15;
  const auto step = [&](int k) {
    m = min(m, kDir < 0 ? wa(c - k + 1) : wa(c + k));
    const int cpos = wp(c + kDir * k);
    if (static_cast<unsigned>(cpos) - static_cast<unsigned>(lo) <= span) {
      best = __viaddmax_s32(m, cpos, best);  // max(m + cpos, best)
    }
  };
  if constexpr (K > 0) {
#pragma unroll
    for (int k = 1; k <= K; ++k) step(k);
  } else {
    for (int k = 1; k <= kk; ++k) step(k);
  }
  return best;
}

// Score the thread's kE elements of the tile in stage (s_adj, s_pos).
template <int K, bool kBack>
__device__ __forceinline__ void score_tile(const Args& a, int tile, int h,
                                           const int* s_adj,
                                           const int* s_pos) {
  const int row = tile / a.tiles_per_row;
  const int i0 = (tile - row * a.tiles_per_row) * kTile + threadIdx.x * kE;
  if (i0 >= a.n) return;
  const int ws = __ldg(a.wstart + row);
  const bool back = K > 0 ? kBack : a.backward_only != 0;
  const int w0 = threadIdx.x * kE;  // window start: the element less h

  constexpr int H = halo_of(K);
  constexpr int W = K > 0 ? kE + 2 * H : 4;
  int ra[W], rp[W];
  if constexpr (K > 0) {
#pragma unroll
    for (int c = 0; c < W / 4; ++c) {
      const int4 va = *reinterpret_cast<const int4*>(s_adj + phys(w0 + 4 * c));
      const int4 vp = *reinterpret_cast<const int4*>(s_pos + phys(w0 + 4 * c));
      ra[4 * c] = va.x; ra[4 * c + 1] = va.y;
      ra[4 * c + 2] = va.z; ra[4 * c + 3] = va.w;
      rp[4 * c] = vp.x; rp[4 * c + 1] = vp.y;
      rp[4 * c + 2] = vp.z; rp[4 * c + 3] = vp.w;
    }
#pragma unroll
    for (int j = 0; j < W; ++j) ra[j] = shifted(ra[j], a.lcp_cap);
  }
  const auto wa = [&](int j) {
    if constexpr (K > 0) return ra[j];
    else return shifted(s_adj[phys(w0 + j)], a.lcp_cap);
  };
  const auto wp = [&](int j) {
    if constexpr (K > 0) return rp[j];
    else return s_pos[phys(w0 + j)];
  };

  int len[kE], dist[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const int c = (K > 0 ? H : h) + e;  // a constant index for K > 0
    const int p0 = wp(c);
    int lo = max(ws, p0 - kWindow);
    int span = p0 - 1 - lo;
    if (span < 0) {  // empty range: no position passes
      lo = INT_MAX;
      span = 0;
    }
    int best = p0 - kWindow - 1;  // unpacks to (0, 0)
    best = best_key<K, -1>(wa, wp, c, a.k_each, a.lcp_cap, lo,
                           static_cast<unsigned>(span), best);
    if (!back) {
      best = best_key<K, 1>(wa, wp, c, a.k_each, a.lcp_cap, lo,
                            static_cast<unsigned>(span), best);
    }
    const int kt = max(best + (kWindow - p0), 0);
    len[e] = kt >> 15;
    dist[e] = len[e] ? kWindow - (kt & (kWindow - 1)) : 0;
  }

  const long long off = static_cast<long long>(row) * a.n + i0;
  if (a.vec && i0 + kE <= a.n) {
#pragma unroll
    for (int c = 0; c < kE / 4; ++c) {
      *reinterpret_cast<int4*>(a.out_len + off + 4 * c) =
          make_int4(len[4 * c], len[4 * c + 1], len[4 * c + 2], len[4 * c + 3]);
      *reinterpret_cast<int4*>(a.out_dist + off + 4 * c) = make_int4(
          dist[4 * c], dist[4 * c + 1], dist[4 * c + 2], dist[4 * c + 3]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      if (i0 + e < a.n) {
        a.out_len[off + e] = len[e];
        a.out_dist[off + e] = dist[e];
      }
    }
  }
}

// K > 0: compile-time K and direction; K == 0: the runtime-K instance.
template <int K, bool kBack>
__global__ void __launch_bounds__(kThreads) scan_kernel(const Args a) {
  extern __shared__ int4 smem4[];
  int* smem = reinterpret_cast<int*>(smem4);
  const int h = K > 0 ? halo_of(K) : halo_of(a.k_each);
  const int sw = stage_words(h);
  int tile = blockIdx.x;
  if (tile >= a.ntiles) return;
  stage_tile(a, tile, h, smem, smem + sw);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int it = 0; tile < a.ntiles; ++it, tile += gridDim.x) {
    int* cur = smem + (it & 1) * 2 * sw;
    int* nxt = smem + ((it + 1) & 1) * 2 * sw;
    if (tile + gridDim.x < a.ntiles) {
      stage_tile(a, tile + gridDim.x, h, nxt, nxt + sw);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    score_tile<K, kBack>(a, tile, h, cur, cur + sw);
    __syncthreads();  // the stage is refilled next iteration
  }
}

template <int K, bool kBack>
int launch(const Args& a, cudaStream_t stream) {
  const auto fn = scan_kernel<K, kBack>;
  const int h = K > 0 ? halo_of(K) : halo_of(a.k_each);
  const size_t shm = 2 * 2 * stage_words(h) * sizeof(int);
  // Resident blocks on the card, found once per device (and halo, which
  // sets the runtime-K instance's shared memory).
  constexpr int kDevices = 16;
  static int slots_of[kDevices][halo_of(64) / 4 + 1] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  int slots = dev < kDevices ? slots_of[dev][h / 4] : 0;
  if (slots == 0) {
    int sms = 0;
    int per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, shm);
    slots = max(sms * per_sm, 1);
    if (dev < kDevices) slots_of[dev][h / 4] = slots;
  }
  // Equal tile counts per block: the last wave has no stragglers.
  const int per_block = (a.ntiles + slots - 1) / slots;
  const int grid = (a.ntiles + per_block - 1) / per_block;
  fn<<<grid, kThreads, shm, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int zz_scan_candidates(const int* adj, const int* spos,
                                  const int* wstart, int* out_len,
                                  int* out_dist, int batch, int n, int k_each,
                                  int lcp_cap, int backward_only,
                                  void* stream) {
  Args a;
  a.adj = adj;
  a.spos = spos;
  a.wstart = wstart;
  a.out_len = out_len;
  a.out_dist = out_dist;
  a.n = n;
  a.k_each = k_each;
  a.lcp_cap = lcp_cap;
  a.backward_only = backward_only;
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
  };
  a.vec = n % 4 == 0 && aligned(adj) && aligned(spos) && aligned(out_len) &&
          aligned(out_dist);
  a.tiles_per_row = (n + kTile - 1) / kTile;
  a.ntiles = batch * a.tiles_per_row;
  const auto s = static_cast<cudaStream_t>(stream);
  const bool back = backward_only != 0;
  switch (k_each) {
    case 4: return back ? launch<4, true>(a, s) : launch<4, false>(a, s);
    case 6: return back ? launch<6, true>(a, s) : launch<6, false>(a, s);
    case 8: return back ? launch<8, true>(a, s) : launch<8, false>(a, s);
    case 12: return back ? launch<12, true>(a, s) : launch<12, false>(a, s);
    case 16: return back ? launch<16, true>(a, s) : launch<16, false>(a, s);
    default: return launch<0, false>(a, s);
  }
}
