// Device decode's LZ tail: token_scatter (the per-bit path) and resolve_lz
// (both paths).
//
// token_scatter replaces the three .at[tgt].max(..., mode="drop") of the
// reference's _decode_all (zzflate_tpu/models/inflate_tpu.py:628-636): every
// committed token (a committed bit that decodes a literal or a match) max-
// combines its literal, its own output offset and its match distance into
// the three output-space arrays at that offset; offsets outside [0, n_out_pad)
// are dropped. Each field is maxed on its own, as the reference's per-bit path
// does: the walk's packed word (dist << 9 | lit << 1 | 1) would differ where
// two writes share a slot. Not a Pallas kernel.
//
// resolve_lz replaces _resolve_parent and _resolve_lz (inflate_tpu.py:683,
// the lax.while_loop at :716, and :722): the covering token of every
// position (a running max of start_mark), the closed-form first hop into the
// token's source, pointer doubling to the root, and the byte gather
// litval[parent] & 0xFF. Not a Pallas kernel.
//
// Bound on the H100, bytes (a few integer operations an element):
//   token_scatter at 4 194 304 bits: the committed mask read once (1 B a
//   bit) and, at the committed tokens only, their two kind flags, offset,
//   literal or distance, and the three entries read and written: ~8 MB,
//   ~2.5 us for a real group (chip_smoke.py counts it from the run's data).
//   Read whole, the six arrays as the decode hands them (off int64, sym and
//   mdist int32, three masks) are 19 B a bit, 80 MB, 24 us.
//   resolve_lz at n_out_pad = 4 194 304: one pass reads start_mark, dist_at
//   and litval (12 B a position) and writes the bytes (1 B): 54.5 MB, 16.3
//   us; each doubling round moves another ~12 B a position.
//
// The design.
//   token_scatter: one thread a bit. A thread whose bit is not a committed
//      token reads its mask byte and stops; the few hundred thousand tokens
//      of a group each make three int32 atomicMax on their own slot, almost
//      never contended. No trash slot: a dropped bit writes nothing (the
//      torch scatter it replaces aimed ~3.8 M bits at one slot).
//   resolve_lz: 44 launches queued on one stream, none synchronising.
//      1. tile maxima: one block of ZZ_RESOLVE_THREADS a tile of
//         ZZ_RESOLVE_TILE positions; block 0 also zeroes the round flags.
//      2. carry: one block scans the tile maxima into exclusive prefix maxima.
//      3. first hop: one block a tile; each warp scans its ZZ_RESOLVE_STEPS
//         runs of 32 positions with shuffles, carried lane 31 to lane 0, the
//         block joins the warps' totals and the tile's carry; each position
//         then takes the closed-form hop in 64-bit arithmetic, clipped, into
//         parent.
//      4. ZZ_RESOLVE_ROUNDS doubling rounds, the reference's exactly:
//         round r reads buffer (r - 1) % 2 and writes buffer r % 2 (buffer 0
//         is parent), and sets flags[r] where any position changed. Round r
//         > 1 returns at once unless flags[r - 1] is set, as the reference's
//         loop ends after a round that changed nothing. Rounds then equal
//         the reference's count, and its 40-round cap holds. After a round
//         that changed nothing the two buffers are equal, so parent (buffer
//         0, which round 40 writes) holds the result whether the loop ended
//         early or at the cap.
//      5. gather: out[i] = litval[parent[i]] & 0xFF, and rounds[0] from the
//         flags.
// Measured on the H100 (PERF.md section 6, chip_smoke.py phase 6):
// token_scatter 0.03-0.04 ms a 4 194 304-bit group, against ~3 ms for each
// trash-slot scatter it replaced; resolve_lz 0.25-0.36 ms at 4 194 304
// positions and 9-13 rounds, whose own bytes bound them at 0.15-0.21 ms.
#include <algorithm>
#include <climits>

#include <cuda_runtime.h>

#include "kernels.h"

namespace {

constexpr int kScatterThreads = 256;
constexpr int kThreads = ZZ_RESOLVE_THREADS;
constexpr int kWarps = kThreads / 32;
constexpr int kSteps = ZZ_RESOLVE_STEPS;
constexpr int kTile = ZZ_RESOLVE_TILE;
constexpr int kRounds = ZZ_RESOLVE_ROUNDS;
constexpr int kCarryThreads = 1024;
constexpr int kRoundThreads = 256;
constexpr int kRoundBlocks = 1024;  // about one wave of 2 048 threads an SM
constexpr int kGatherThreads = 256;

static_assert(kTile == kWarps * kSteps * 32, "a tile is the warps' runs");

__global__ void __launch_bounds__(kScatterThreads)
token_scatter_kernel(const long long* __restrict__ off,
                     const unsigned char* __restrict__ committed,
                     const unsigned char* __restrict__ islit,
                     const unsigned char* __restrict__ islen,
                     const int* __restrict__ sym,
                     const int* __restrict__ mdist, int nbits,
                     int* __restrict__ litval, int* __restrict__ start_mark,
                     int* __restrict__ dist_at, int n_out_pad) {
  const int b = blockIdx.x * kScatterThreads + threadIdx.x;
  if (b >= nbits || !committed[b]) return;
  const bool lit = islit[b] != 0;
  const bool len = islen[b] != 0;
  if (!lit && !len) return;
  const long long o = off[b];
  if (o < 0 || o >= n_out_pad) return;
  atomicMax(litval + o, lit ? sym[b] : 0);
  atomicMax(start_mark + o, static_cast<int>(o));
  atomicMax(dist_at + o, len ? mdist[b] : 0);
}

__device__ __forceinline__ int warp_max(int v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

// Inclusive running max across the warp's lanes.
__device__ __forceinline__ int warp_scan_max(int v, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(~0u, v, o);
    if (lane >= o) v = max(v, y);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
resolve_tile_max_kernel(const int* __restrict__ start_mark, int n,
                        int* __restrict__ tmax, int* __restrict__ flags) {
  __shared__ int wmax[kWarps];
  const int base = blockIdx.x * kTile;
  int m = INT_MIN;
  for (int k = threadIdx.x; k < kTile; k += kThreads) {
    if (base + k < n) m = max(m, start_mark[base + k]);
  }
  m = warp_max(m);
  if ((threadIdx.x & 31) == 0) wmax[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = warp_max(threadIdx.x < kWarps ? wmax[threadIdx.x] : INT_MIN);
    if (threadIdx.x == 0) tmax[blockIdx.x] = m;
  }
  if (blockIdx.x == 0 && threadIdx.x <= kRounds) flags[threadIdx.x] = 0;
}

// tmax[t] becomes the max of tmax[0..t), INT_MIN for t = 0.
__global__ void __launch_bounds__(kCarryThreads)
resolve_carry_kernel(int* __restrict__ tmax, int ntiles) {
  __shared__ int wsum[kCarryThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int running = INT_MIN;
  for (int c = 0; c < ntiles; c += kCarryThreads) {
    const int t = c + threadIdx.x;
    const int s = warp_scan_max(t < ntiles ? tmax[t] : INT_MIN, lane);
    const int up = __shfl_up_sync(~0u, s, 1);
    if (lane == 31) wsum[warp] = s;
    __syncthreads();
    if (warp == 0) wsum[lane] = warp_scan_max(wsum[lane], lane);
    __syncthreads();
    int ex = max(running, lane ? up : INT_MIN);
    if (warp) ex = max(ex, wsum[warp - 1]);
    if (t < ntiles) tmax[t] = ex;
    running = max(running, wsum[kCarryThreads / 32 - 1]);
    __syncthreads();  // wsum is rewritten by the next chunk
  }
}

__global__ void __launch_bounds__(kThreads)
resolve_hop_kernel(const int* __restrict__ start_mark,
                   const int* __restrict__ dist_at, int n,
                   const int* __restrict__ carry, int* __restrict__ parent) {
  __shared__ int wtot[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wbase = blockIdx.x * kTile + warp * (kSteps * 32);
  int v[kSteps];
  int run = INT_MIN;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int i = wbase + s * 32 + lane;
    const int x = max(warp_scan_max(i < n ? start_mark[i] : INT_MIN, lane),
                      run);
    run = __shfl_sync(~0u, x, 31);
    v[s] = x;
  }
  if (lane == 0) wtot[warp] = run;
  __syncthreads();
  int pre = carry[blockIdx.x];
  for (int w = 0; w < warp; ++w) pre = max(pre, wtot[w]);
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int i = wbase + s * 32 + lane;
    if (i < n) {
      const long long seg = max(v[s], pre);
      const long long at = seg < 0 ? 0 : (seg >= n ? n - 1 : seg);
      const long long dist = dist_at[at];
      const long long d1 = dist > 1 ? dist : 1;
      long long r = (static_cast<long long>(i) - seg) % d1;
      if (r < 0) r += d1;  // the reference's floor mod
      long long p = (dist > 0 && seg >= 0) ? seg - d1 + r : i;
      p = p < 0 ? 0 : (p >= n ? n - 1 : p);
      parent[i] = static_cast<int>(p);
    }
  }
}

// Round r (1-based) of the doubling: dst = src[src], flags[r] = 1 if any
// position changed. It runs only if round r - 1 changed something.
__global__ void __launch_bounds__(kRoundThreads)
resolve_round_kernel(const int* __restrict__ src, int* __restrict__ dst,
                     int n, int* __restrict__ flags, int r) {
  if (r > 1 && flags[r - 1] == 0) return;
  int changed = 0;
  for (int i = blockIdx.x * kRoundThreads + threadIdx.x; i < n;
       i += gridDim.x * kRoundThreads) {
    const int p = src[i];
    const int q = src[p];
    dst[i] = q;
    changed |= q != p;
  }
  if (__syncthreads_or(changed) && threadIdx.x == 0) flags[r] = 1;
}

__global__ void __launch_bounds__(kGatherThreads)
resolve_gather_kernel(const int* __restrict__ litval,
                      const int* __restrict__ parent, int n,
                      const int* __restrict__ flags,
                      unsigned char* __restrict__ out, int* __restrict__ rounds) {
  const int i = blockIdx.x * kGatherThreads + threadIdx.x;
  if (out != nullptr && i < n) {
    out[i] = static_cast<unsigned char>(litval[parent[i]] & 0xFF);
  }
  if (rounds != nullptr && i == 0) {
    int r = 1;
    while (r < kRounds && flags[r] != 0) ++r;
    rounds[0] = r;
  }
}

}  // namespace

extern "C" int zz_token_scatter(const long long* off,
                                const unsigned char* committed,
                                const unsigned char* islit,
                                const unsigned char* islen,
                                const int* sym, const int* mdist, int nbits, int* litval, int* start_mark,
                                int* dist_at, int n_out_pad, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  token_scatter_kernel<<<(nbits + kScatterThreads - 1) / kScatterThreads,
                         kScatterThreads, 0, s>>>(
      off, committed, islit, islen, sym, mdist, nbits, litval, start_mark,
      dist_at, n_out_pad);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int zz_resolve_lz(const int* litval, const int* start_mark,
                             const int* dist_at, int n, int* parent,
                             int* scratch, int* tmax, int* flags,
                             unsigned char* out, int* rounds, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ntiles = (n + kTile - 1) / kTile;
  resolve_tile_max_kernel<<<ntiles, kThreads, 0, s>>>(start_mark, n, tmax,
                                                      flags);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  resolve_carry_kernel<<<1, kCarryThreads, 0, s>>>(tmax, ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  resolve_hop_kernel<<<ntiles, kThreads, 0, s>>>(start_mark, dist_at, n, tmax,
                                                 parent);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int* buf[2] = {parent, scratch};
  const int round_blocks =
      std::min(kRoundBlocks, (n + kRoundThreads - 1) / kRoundThreads);
  for (int r = 1; r <= kRounds; ++r) {
    resolve_round_kernel<<<round_blocks, kRoundThreads, 0, s>>>(
        buf[(r - 1) % 2], buf[r % 2], n, flags, r);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int gather_blocks =
      out != nullptr ? (n + kGatherThreads - 1) / kGatherThreads : 1;
  resolve_gather_kernel<<<gather_blocks, kGatherThreads, 0, s>>>(
      litval, parent, n, flags, out, rounds);
  return static_cast<int>(cudaGetLastError());
}
