// The level 7-9 optimal parse's shortest-bit-path DP, one warp a row.
//
// Replaces no Pallas kernel: the reference runs this DP on the host in C
// (zzflate_tpu/native/zzflate_native.c zzt_optimal_parse, called from
// zzflate_tpu/encode_policy.py optimal_override), and the port's CPU path
// keeps that loop (zzflate_tpu_torch/native). On the card the DP reads the
// matcher's (mlen, mdist) and the row bytes where analyze left them and
// writes each position's choice, so the encode copies no (rows, positions)
// array between host and card: parse_rows turns the choices into committed
// marks, as it does for the lazy parse.
//
// What it computes, the C loop's exactly, for every row b over positions
// [start, end), walking them backwards with cost[end] = 0 (uint32, wrapping
// as the C's does):
//   literal:  cost[i + 1] + (ll[data[i]] or 30 when 0)
//   class c:  when mlen[i] >= 3, ml = min(mlen[i], end - i) and
//             LENGTH_BASE[c] <= ml, the length L = min(ml, top_c) (top_c the
//             class's last length; 257 for c = 27, as 258 is c = 28):
//             cost[i + L] + (ll[257 + c] or 30) + LENGTH_EXTRA[c]
//                         + (d[dc] or 30) + DIST_EXTRA[dc],
//             dc = the distance code of mdist[i] (the C's search: the last
//             code whose base is <= mdist, 0 below 1).
//   choice[i] = the L of the cheapest class when it is strictly cheaper
//   than the literal (the literal wins a tie, then the lowest class), else
//   0. ll and d are the (ll 288, d 30) code lengths of the sub-block that
//   holds i: the last b with bounds[b] <= i (0 below bounds[0]).
//
// Bound on the H100. Bytes: data, mlen, mdist read once (9 B a position) and
// the choice written once (4 B): 15.3 MB at (16, 294 912), 4.6 us, 1.5 us a
// row. That is the wrong yardstick: cost[i] needs cost[i + 1], so a row is
// a chain of (end - start) dependent steps, and what bounds the kernel is the
// latency of one step times 262 144 positions, rows in parallel.
//
// The design.
//   One block of one warp a row. Lane c < 29 prices class c; the literal is
//   priced on every lane. The lanes take the classes' least cost with
//   __reduce_min_sync and the literal's against it, so the dependent chain
//   from cost[i + 1] to cost[i] is an add, a compare and a select. The
//   winning class is the lowest lane at that least cost (a ballot), which
//   ties exactly as the C's ascending loop with its strict '<' does, in the
//   C's 32-bit arithmetic: no bound on a row's cost is needed.
//   Costs: a ring of the last 512 in shared memory (cost[i] reads cost[i + 1
//   .. i + 258]), one copy a lane ([slot][lane], so a lane's read of its own
//   class's cost hits its own bank and needs no barrier).
//   Steps: a tile of 32 positions inside [start, end) and one sub-block runs
//   as 32 unrolled steps with no branch, software-pipelined: a position's
//   word, lengths, costs and ring read three steps ahead (a class reads i +
//   3 or later, stored by then), its least class cost one step ahead, its
//   winner's length and choice one and two steps behind, so each step waits
//   on the chain above alone. Other positions (the top tile, a tile with a
//   sub-block edge or the row's start) go one step at a time.
//   Inputs: tiles of 32 positions, one element a lane, coalesced, loaded two
//   tiles ahead and packed into one word (byte | min(mlen, 258) << 8 |
//   dc << 17) a tile ahead; each step takes its word with one shuffle.
//   Tables: at each sub-block edge the warp reloads the lengths: each class
//   lane its class's cost, lanes 0-29 a distance code's cost (one shuffle a
//   step), the 256 literals' costs to shared memory.
//   Outputs: each lane keeps its position's choice in a tile and the tile
//   leaves in one coalesced store; positions outside [start, end) get 0.
#include <climits>

#include <cuda_runtime.h>

#include "kernels.h"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kRing = ZZ_OPT_RING;     // costs kept, a power of two > 258 + 1
constexpr int kClasses = 29;           // length codes 257..285
constexpr int kAbsent = 30;            // ZZT_ABSENT_BITS
constexpr int kLens = 288 + 30;        // a sub-block's lengths: ll, then d

__constant__ int c_lbase[kClasses] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 13,
                                      15, 17, 19, 23, 27, 31, 35, 43, 51, 59,
                                      67, 83, 99, 115, 131, 163, 195, 227,
                                      258};
__constant__ int c_lext[kClasses] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                                     1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
                                     4, 4, 4, 4, 5, 5, 5, 5, 0};
__constant__ int c_dext[30] = {0, 0, 0, 0, 1, 1, 2,  2,  3,  3,
                               4, 4, 5, 5, 6, 6, 7,  7,  8,  8,
                               9, 9, 10, 10, 11, 11, 12, 12, 13, 13};

// The C's distance-code search (the last code whose base is <= d; 0 for
// d < 1, 29 from 24 577 up) in closed form.
__device__ __forceinline__ unsigned dist_code(int d) {
  const int x = min(max(d, 1), 32768) - 1;
  if (x < 4) return static_cast<unsigned>(x);
  const int bl = 32 - __clz(x);
  return static_cast<unsigned>(2 * (bl - 1) + ((x >> (bl - 2)) & 1));
}

// One tile's element of this lane: (mlen, mdist, byte), 0s outside [lo, hi).
struct Raw {
  int m, d, b;
};

__device__ __forceinline__ Raw load_raw(const unsigned char* d8, const int* ml,
                                        const int* md, int tile, int lo,
                                        int hi) {
  const int pos = tile * 32 + static_cast<int>(threadIdx.x);
  if (tile < 0 || pos < lo || pos >= hi) return Raw{0, 0, 0};
  return Raw{__ldg(ml + pos), __ldg(md + pos), __ldg(d8 + pos)};
}

__device__ __forceinline__ unsigned pack(Raw r) {
  const int m0 = r.m >= 3 ? min(r.m, 258) : 0;
  return static_cast<unsigned>(r.b) | (static_cast<unsigned>(m0) << 8) |
         (dist_code(r.d) << 17);
}

__global__ void __launch_bounds__(32)
    optimal_dp_kernel(const unsigned char* __restrict__ data,
                      const int* __restrict__ mlen,
                      const int* __restrict__ mdist,
                      const int* __restrict__ starts,
                      const int* __restrict__ ends,
                      const int* __restrict__ lens,
                      const int* __restrict__ bounds, int nsb, int n,
                      int* __restrict__ choice) {
  extern __shared__ unsigned ring[];  // [kRing][32]: a lane's own costs
  __shared__ unsigned s_lit[256];     // the sub-block's literal costs
  const int lane = static_cast<int>(threadIdx.x);
  const int row = static_cast<int>(blockIdx.x);
  const long long rb = static_cast<long long>(row) * n;
  const int lo = max(starts[row], 0);
  const int hi = min(ends[row], n);
  int* out = choice + rb;
  for (int k = lane; k < min(lo, n); k += 32) out[k] = 0;
  for (int k = max(hi, lo) + lane; k < n; k += 32) out[k] = 0;
  if (lo >= hi) return;
  const unsigned char* d8 = data + rb;
  const int* ml = mlen + rb;
  const int* md = mdist + rb;
  const int* row_lens = lens + static_cast<long long>(row) * nsb * kLens;

  // This lane's class: lanes 29-31 price none (lbase out of reach).
  const int c = min(lane, kClasses - 1);
  const int lbase = lane < kClasses ? c_lbase[c] : INT_MAX;
  int top = c < kClasses - 1 ? c_lbase[c] + (1 << c_lext[c]) - 1 : 258;
  if (c == 27 && top > 257) top = 257;  // 258 is code 285 (c = 28)
  if (lane >= kClasses) top = 0;
  const unsigned lext = static_cast<unsigned>(c_lext[c]);
  const unsigned dext = static_cast<unsigned>(c_dext[min(lane, 29)]);
  unsigned lcost = 0, dcost = 0;  // this sub-block's class and code costs

  int sb = nsb - 1;
  int sb_lo = INT_MAX;  // reload when a position falls below it
  ring[(hi & (kRing - 1)) * 32 + lane] = 0u;
  unsigned prev = 0u;  // cost[i + 1]
  int tile = (hi - 1) >> 5;
  unsigned t_cur = pack(load_raw(d8, ml, md, tile, lo, hi));
  unsigned t_nxt = pack(load_raw(d8, ml, md, tile - 1, lo, hi));
  Raw raw = load_raw(d8, ml, md, tile - 2, lo, hi);
  int my_choice = 0;

  // The sub-block of position p: the C's search, then its costs.
  auto reload = [&](int p) {
    while (sb > 0 && p < __ldg(bounds + sb)) --sb;
    sb_lo = sb > 0 ? __ldg(bounds + sb) : INT_MIN;
    const int* ln = row_lens + sb * kLens;
    __syncwarp();
    for (int k = lane; k < 256; k += 32) {
      const int b = __ldg(ln + k);
      s_lit[k] = b ? static_cast<unsigned>(b) : kAbsent;
    }
    const int lb = __ldg(ln + 257 + c);
    lcost = (lb ? static_cast<unsigned>(lb) : kAbsent) + lext;
    const int db = __ldg(ln + 288 + min(lane, 29));
    dcost = (db ? static_cast<unsigned>(db) : kAbsent) + dext;
    __syncwarp();
  };
  // Position p's longest match, clamped to the row's end (0: none).
  auto longest = [&](int p, unsigned v) {
    return min(static_cast<int>((v >> 8) & 511), hi - p);
  };
  auto ring_at = [&](int i) { return ring[(i & (kRing - 1)) * 32 + lane]; };
  // Position p from its word v, this lane's length and ring read: the
  // classes' least cost, then the literal against it (the C keeps the
  // literal on a tie); the winner's length to the lane of p's slot.
  auto finish = [&](int p, int slot, unsigned v, int len, bool valid,
                    unsigned cr) {
    const unsigned tc = lcost + __shfl_sync(kFull, dcost, v >> 17) + cr;
    const unsigned mc = __reduce_min_sync(kFull, valid ? tc : kFull);
    const unsigned lt = s_lit[v & 255] + prev;
    const bool lit = lt <= mc;
    prev = lit ? lt : mc;
    ring[(p & (kRing - 1)) * 32 + lane] = prev;
    const unsigned at_min = __ballot_sync(kFull, valid && tc == mc);
    const int won = __shfl_sync(kFull, len, (__ffs(at_min) + 31) & 31);
    if (lane == slot) my_choice = lit ? 0 : won;
  };

  for (int p = hi - 1; p >= lo; --p) {
    const int base = p & ~31;
    bool whole = false;  // p opens a tile inside [lo, hi) and one sub-block
    if (p == base + 31 && base >= lo) {
      if (p < sb_lo) reload(p);
      whole = sb_lo <= base;
    }
    if (whole) {
      // 32 steps unrolled and software-pipelined, so that a step waits on
      // the chain cost[i + 1] -> cost[i] alone. Step k (position base + k):
      // the classes' least cost of position k - 1 (its ring read issued two
      // steps back); the literal of k against its least cost, stored; the
      // word, lengths, costs and ring read of k - 3 (a class reads base + k
      // or later: stored now); the lowest lane at k's least cost, k + 1's
      // winning length, k + 2's choice to its lane.
      unsigned v[32] = {}, dsh[32] = {}, lit[32] = {}, cr[32] = {};
      unsigned tc[32] = {}, mc[32] = {}, at[32] = {};
      int len[32] = {}, won[32] = {};
      bool valid[32] = {}, islit[32] = {};
      unsigned* slot = ring + (base & (kRing - 1)) * 32 + lane;  // base's
      auto prepare = [&](int j) {
        const int m = longest(base + j, v[j]);
        len[j] = min(m, top);
        valid[j] = m >= lbase;
        dsh[j] = __shfl_sync(kFull, dcost, v[j] >> 17);
        lit[j] = s_lit[v[j] & 255];
        cr[j] = ring_at(base + j + len[j]);
      };
      auto least = [&](int j) {
        tc[j] = lcost + dsh[j] + cr[j];
        mc[j] = __reduce_min_sync(kFull, valid[j] ? tc[j] : kFull);
      };
      auto winner = [&](int j) {
        return __shfl_sync(kFull, len[j], (__ffs(at[j]) + 31) & 31);
      };
#pragma unroll
      for (int j = 31; j >= 28; --j) v[j] = __shfl_sync(kFull, t_cur, j);
      prepare(31);
      prepare(30);
      prepare(29);
      least(31);
#pragma unroll
      for (int k = 31; k >= 0; --k) {
        if (k >= 4) v[k - 4] = __shfl_sync(kFull, t_cur, k - 4);
        if (k >= 1) least(k - 1);
        const unsigned lt = lit[k] + prev;
        islit[k] = lt <= mc[k];  // the C keeps the literal on a tie
        prev = islit[k] ? lt : mc[k];
        slot[k * 32] = prev;
        if (k >= 3) prepare(k - 3);
        at[k] = __ballot_sync(kFull, valid[k] && tc[k] == mc[k]);
        if (k <= 30) won[k + 1] = winner(k + 1);
        if (k <= 29 && lane == k + 2) my_choice = islit[k + 2] ? 0 : won[k + 2];
      }
      won[0] = winner(0);
      if (lane == 1) my_choice = islit[1] ? 0 : won[1];
      if (lane == 0) my_choice = islit[0] ? 0 : won[0];
      p = base;
    } else {
      if (p < sb_lo) reload(p);
      const unsigned v = __shfl_sync(kFull, t_cur, p & 31);
      const int m = longest(p, v);
      const int len = min(m, top);
      finish(p, p & 31, v, len, m >= lbase, ring_at(p + len));
    }
    if ((p & 31) == 0 || p == lo) {  // the tile is done: store it
      const int pos = base + lane;
      if (pos >= lo && pos < hi) out[pos] = my_choice;
      if ((p & 31) == 0) {
        t_cur = t_nxt;
        t_nxt = pack(raw);
        tile = (p >> 5) - 3;
        raw = load_raw(d8, ml, md, tile, lo, hi);
      }
    }
  }
}

}  // namespace

extern "C" int zz_optimal_dp(const unsigned char* data, const int* mlen,
                             const int* mdist, const int* starts,
                             const int* ends, const int* lens,
                             const int* bounds, int nsb, int batch, int n,
                             int* choice, void* stream) {
  const size_t smem = kRing * 32 * sizeof(unsigned);
  const cudaError_t rc = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(optimal_dp_kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  optimal_dp_kernel<<<batch, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      data, mlen, mdist, starts, ends, lens, bounds, nsb, n, choice);
  return static_cast<int>(cudaGetLastError());
}
