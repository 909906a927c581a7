// Device decode's anchor walk: the serial token loop of every lane.
//
// Replaces: zzflate_tpu/models/inflate_tpu.py _walk_core (:727), the
// lax.fori_loop of t_steps steps (:819-845) over the lane vector, with
// the LUT-free canonical decode of _decode_bits_canon (:435). A lane
// starts at a known token boundary (a block's first token or an anchor)
// and decodes up to t_steps tokens; each literal or match is max-combined
// into packed[o] as dist << 9 | lit << 1 | 1 at its output offset o. A
// lane stops at EOB or on an invalid window (a code past the tree, a
// reserved symbol, a length with an invalid distance) without advancing.
//
// Bound on the H100. The function reads a group's body once (at most
// 4 MiB) and reads and writes only the packed entries its tokens land on
// (8 B a token), and needs about 30 integer operations a literal and 63
// a match (the step below, counted by kind in chip_smoke.py's
// WALK_OPS_*): a few microseconds by bytes or by operations
// (chip_smoke.py computes both from each launch's data). That bound
// does not see the serial chain: each token's window depends on the
// previous token's width, so a lane is t_steps dependent steps, and a
// launch takes at least t_steps times one step's latency (the chain
// floor, which chip_smoke.py measures from a launch's first lane alone
// at two lengths).
//
// The design, for latency:
//   One lane a thread, one warp a block (ZZ_WALK_THREADS), so a group's
//      lanes make as many blocks as there are warps of them, which the
//      scheduler may spread over as many SMs; the host plan gives foreign
//      streams short lanes (many anchors) for that.
//   One shared-memory lookup a symbol. Each block first builds, for the
//      units its lanes use (at most ZZ_WALK_UNITS: the host plan sorts a
//      group's lanes by (unit, bit) and pads each unit's run to a
//      multiple of ZZ_WALK_THREADS / ZZ_WALK_UNITS), a primary table of
//      2^ZZ_WALK_LL_BITS litlen and 2^ZZ_WALK_D_BITS distance entries,
//      indexed by the window's first stream bits, from the canonical rows
//      (hi, fsh, off, sym) it is given; the warp computes the entries
//      branch-free, several at a time. An entry packs the code length,
//      the symbol's kind, its extra bits and base, and the sums the step
//      needs (the distance's bit offset, a match's distance bits). It is
//      exact where the first B bits fix the code: for canonical rows
//      (boundaries monotone, hi[L] and fsh[L] multiples of 2^(15-L) for
//      L <= B) every boundary below B bits is a multiple of 2^(15-B).
//      Every other window (a longer code, a window past the tree, rows of
//      another shape, a lane whose unit has no table in its block) is
//      marked long and takes the compare ladder of the plain decode, so
//      every window decodes exactly as the plain version does.
//   The window in registers: the three words at clip(p >> 5, 0, nw - 3)
//      plus the next two, loaded a step before a shift can use them (a
//      token is at most 48 bits, so the base word moves by 0, 1 or 2 a
//      step), and the line after them prefetched into L1; s = p & 31 of
//      the unclipped p, as in the plain version.
//   A branch-light step: the distance lookup, both emits and both
//      advances are computed for every lane and selected, so a warp's
//      literal and match lanes stay converged; one rare branch takes a
//      long window, EOB or an invalid symbol, and an emit past the output
//      is a max with 0. The loop is unrolled 8 times, so no register
//      moves sit on the chain.
//   Emits are atomicMax straight into packed. That is exact: every packed
//      value is non-negative, the reference combines its deferred records
//      with max (order-free), and the duplicate re-walks of the next
//      interval's head write identical values. So neither the order of
//      the lanes nor their padding changes packed.
//
// Measured (chip_smoke.py phase 6 on an NVIDIA H100 80GB HBM3 at 700 W,
// L2 flushed before each launch; PERF.md has the runs): an indexed 8 MiB
// group's launch 0.21-0.29 ms, from 0.65-0.68 ms for the one-thread
// ladder walk this replaces; one step of a lane 127-139 ns, from ~330 ns;
// a foreign group at 64 tokens a lane 0.028-0.047 ms (the three 8 MiB
// groups: 0.114 ms at 64 tokens, 0.150 at 128, 0.235 at 256, from
// utils/decode_bench.py). The serial chain (t_steps x one step) is
// 0.50-0.63 of an indexed launch and 0.17-0.30 of a foreign one; the
// rest is the table build (a few microseconds a block), warps whose
// lanes diverge on long windows and lane ends, and body lines arriving
// cold from device memory (the prefetch took ~20% off an indexed launch).
#include <cuda_runtime.h>

#include <climits>

#include "kernels.h"

namespace {

constexpr int kThreads = ZZ_WALK_THREADS;
constexpr int kUnits = ZZ_WALK_UNITS;
constexpr int kLLBits = ZZ_WALK_LL_BITS;
constexpr int kDBits = ZZ_WALK_D_BITS;
constexpr int kLLSize = 1 << kLLBits;
constexpr int kDSize = 1 << kDBits;
constexpr int kUnitWords = kLLSize + kDSize;
constexpr int kMaxLL = 288;
constexpr int kMaxD = 32;
constexpr int kStageWords = 48 + kMaxLL;  // hi, fsh, off, sym of one tree
constexpr unsigned kFull = 0xFFFFFFFFu;
static_assert(kThreads == 32, "a block is one warp");
static_assert(ZZ_WALK_SMEM_BYTES ==
                  (kUnits * kUnitWords + kStageWords) * 4,
              "kernels.h's shared-memory size");

// Table entries. A flag bit marks a window that needs the compare ladder
// ("long").
// litlen: off2 = nb + lext (5 b) | nb << 5 (4 b) | lext << 9 (3 b) |
// value << 12 (9 b: the literal, or the length's base) | kLen | kStop
// (EOB or an invalid symbol) | kLong.
// distance: dnb + dext (5 b) | dnb << 5 (4 b) | dext << 9 (4 b) |
// dbase << 13 (15 b) | kBad (an invalid distance) | kDLong.
constexpr unsigned kLen = 1u << 21;
constexpr unsigned kStop = 1u << 22;
constexpr unsigned kLong = 1u << 23;
constexpr unsigned kBad = 1u << 28;
constexpr unsigned kDLong = 1u << 29;

// 15-bit reversal of x's low 15 bits: the MSB-first code value.
__device__ __forceinline__ int brev15(unsigned x) {
  return static_cast<int>(__brev(x) >> 17);
}

// The litlen entry of symbol `sym` (in [0, 288)) with code length nb,
// without branches (the table build runs several entries at once).
__device__ __forceinline__ unsigned ll_entry(int sym, int nb) {
  // Length code 0..28: extra bits and base (RFC 1951 3.2.5).
  const int lc = min(max(sym - 257, 0), 28);
  const int le = max((lc >> 2) - 1, 0);
  const int lext = lc < 4 || lc >= 28 ? 0 : le;
  const int lbase =
      lc >= 28 ? 258 : (lc < 4 ? lc + 3 : 3 + ((4 + (lc & 3)) << le));
  const unsigned lit = static_cast<unsigned>(nb | (nb << 5) | (sym << 12));
  const unsigned len = static_cast<unsigned>((nb + lext) | (nb << 5) |
                                             (lext << 9) | (lbase << 12)) |
                       kLen;
  return sym < 256 ? lit : (sym == 256 || sym > 285 ? kStop : len);
}

// The distance entry of symbol `dsym` (in [0, 32)) with code length dnb.
__device__ __forceinline__ unsigned d_entry(int dsym, int dnb) {
  const int de = max((dsym >> 1) - 1, 0);
  const int dext = dsym < 4 ? 0 : de;
  const int dbase =
      dsym < 4 ? dsym + 1 : 1 + ((2 + (dsym & 1)) << (de & 15));
  const unsigned e = static_cast<unsigned>((dnb + dext) | (dnb << 5) |
                                           (dext << 9) | (dbase << 13));
  return dsym >= 30 ? kBad : e;
}

// The compare ladder (the plain version's decode, exact for every
// window): the code length is 1 + #{L in 1..15 : v >= hi[L]}, the index
// off[len] + ((v - fsh[len]) >> (15 - len)), clipped into the table; a
// length past 15 is a window past the tree. Returns the window's entry.
__device__ __forceinline__ unsigned ladder(unsigned win, const int* hi,
                                           const int* fsh, const int* off,
                                           const int* sym, bool is_ll) {
  const int v = brev15(win);
  int ln = 1;
#pragma unroll
  for (int L = 1; L < 16; ++L) ln += v >= __ldg(hi + L) ? 1 : 0;
  if (ln > 15) return is_ll ? kStop : kBad;
  const int nsym = is_ll ? kMaxLL : kMaxD;
  int idx = __ldg(off + ln) + ((v - __ldg(fsh + ln)) >> (15 - ln));
  idx = min(max(idx, 0), nsym - 1);
  const int s = __ldg(sym + idx);
  return is_ll ? ll_entry(s, ln) : d_entry(s, ln);
}

// The warp builds one tree's primary table of 2^B entries into tab,
// through the staging rows in shared memory.
template <int B>
__device__ void build_table(const int* hi, const int* fsh, const int* off,
                            const int* sym, bool is_ll, unsigned* tab,
                            int* stage, int lane) {
  const int nsym = is_ll ? kMaxLL : kMaxD;
  if (lane < 16) {
    stage[lane] = __ldg(hi + lane);
    stage[16 + lane] = __ldg(fsh + lane);
    stage[32 + lane] = __ldg(off + lane);
  }
  for (int i = lane; i < nsym; i += 32) stage[48 + i] = __ldg(sym + i);
  __syncwarp();
  // Canonical rows: boundaries monotone, and hi[L], fsh[L] multiples of
  // 2^(15-L) up to B bits. Rows of another shape get no fast entries.
  bool ok = true;
  if (lane >= 2 && lane <= 15) ok = stage[lane] >= stage[lane - 1];
  if (lane >= 1 && lane <= B) {
    const int m = (1 << (15 - lane)) - 1;
    ok = ok && (stage[lane] & m) == 0 && (stage[16 + lane] & m) == 0;
  }
  ok = __all_sync(kFull, ok);
  const int hb = stage[B];
  int h[B];
#pragma unroll
  for (int L = 1; L < B; ++L) h[L] = stage[L];
  // Several entries at once: no branch, so their loads overlap.
#pragma unroll 4
  for (int j = 0; j < (1 << B) / 32; ++j) {
    const int t = lane + 32 * j;
    // The 15-bit windows whose first B stream bits are t.
    const int v = brev15(static_cast<unsigned>(t));
    int ln = 1;
#pragma unroll
    for (int L = 1; L < B; ++L) ln += v >= h[L] ? 1 : 0;
    int idx = stage[32 + ln] + ((v - stage[16 + ln]) >> (15 - ln));
    idx = min(max(idx, 0), nsym - 1);
    const int s = stage[48 + idx];
    const unsigned e = is_ll ? ll_entry(s, ln) : d_entry(s, ln);
    // A code of at most B bits, or long.
    tab[t] = ok && v < hb ? e : (is_ll ? kLong : kDLong);
  }
  __syncwarp();
}

// One lane's walk from bit p, output o. kTabled: its unit's tables are in
// shared memory (lt, dt); otherwise every window takes the ladder.
template <bool kTabled>
__device__ __forceinline__ void walk_lane(
    const unsigned* __restrict__ words, int nw, const unsigned* lt,
    const unsigned* dt, const int* lh, const int* lf, const int* lof,
    const int* ls, const int* dh, const int* df, const int* dof,
    const int* ds, unsigned p, unsigned o, int* __restrict__ packed,
    int n_out_pad, int t_steps) {
  // The window's base word wi = min(p >> 5, nw - 3) moves by 0, 1 or 2 a
  // step (a token is at most 48 bits); room = nw - 3 - wi. s = p & 31
  // comes from the unclipped p, as in the plain version. c0..c2 =
  // words[wi..wi+2]; f3, f4 = the next two (clamped to the last word),
  // loaded a step before a shift can use them.
  const int top = nw - 1;
  int wi = static_cast<int>(min(p >> 5, static_cast<unsigned>(nw - 3)));
  unsigned room = static_cast<unsigned>(nw - 3 - wi);
  unsigned s = p & 31u;
  unsigned c0 = __ldg(words + wi), c1 = __ldg(words + wi + 1),
           c2 = __ldg(words + wi + 2);
  unsigned f3 = __ldg(words + min(wi + 3, top));
  unsigned f4 = __ldg(words + min(wi + 4, top));
#pragma unroll 8
  for (int t = 0; t < t_steps; ++t) {
    const unsigned lo = __funnelshift_r(c0, c1, s);
    const unsigned hi = __funnelshift_r(c1, c2, s);
    unsigned e = kTabled ? lt[lo & (kLLSize - 1)] : kLong;
    unsigned dwin = __funnelshift_r(lo, hi, e & 31u);
    unsigned de = kTabled ? dt[dwin & (kDSize - 1)] : kDLong;
    // One rare branch: a long window, EOB or an invalid symbol.
    if ((e & (kStop | kLong)) || ((e & kLen) && (de & (kBad | kDLong)))) {
      if (e & kLong) e = ladder(lo, lh, lf, lof, ls, true);
      if (e & kStop) break;  // EOB or an invalid window: stop
      if (e & kLen) {
        dwin = __funnelshift_r(lo, hi, e & 31u);
        if (kTabled) de = dt[dwin & (kDSize - 1)];
        if (de & kDLong) de = ladder(dwin, dh, df, dof, ds, false);
        if (de & kBad) break;  // an invalid distance: stop
      }
    }
    const bool islen = (e & kLen) != 0;
    const unsigned off2 = e & 31u;
    const unsigned nb = (e >> 5) & 15u;
    const unsigned lext = (e >> 9) & 7u;
    const unsigned val = (e >> 12) & 511u;
    const unsigned dnb = (de >> 5) & 15u;
    const unsigned dext = (de >> 9) & 15u;
    const unsigned mext = __funnelshift_r(lo, hi, nb) & ((1u << lext) - 1u);
    const unsigned long long win =
        (static_cast<unsigned long long>(hi) << 32) | lo;
    const unsigned dx =
        static_cast<unsigned>(win >> (off2 + dnb)) & ((1u << dext) - 1u);
    const unsigned mdist = ((de >> 13) & 0x7FFFu) + dx;
    const int pk = static_cast<int>(islen ? (mdist << 9) | 1u
                                          : (val << 1) | 1u);
    // Out of range: max with 0 into the last entry, a no-op (entries are
    // >= 0), so no branch.
    const bool in = o < static_cast<unsigned>(n_out_pad);
    atomicMax(packed + (in ? o : n_out_pad - 1), in ? pk : 0);
    o += islen ? val + mext : 1u;
    // Advance by the token's width (<= 15 + 5 + 15 + 13 = 48 bits).
    const unsigned adv = s + (islen ? off2 + (de & 31u) : nb);
    const unsigned delta = min(adv >> 5, room);
    s = adv & 31u;
    room -= delta;
    wi += static_cast<int>(delta);
    const unsigned n0 = delta == 2 ? c2 : (delta == 1 ? c1 : c0);
    const unsigned n1 = delta == 2 ? f3 : (delta == 1 ? c2 : c1);
    const unsigned n2 = delta == 2 ? f4 : (delta == 1 ? f3 : c2);
    c0 = n0;
    c1 = n1;
    c2 = n2;
    f3 = __ldg(words + min(wi + 3, top));
    f4 = __ldg(words + min(wi + 4, top));
    // The next 128-byte line of the body into L1 before the window gets
    // there (the body arrives cold from device memory).
    asm volatile("prefetch.global.L1 [%0];" ::"l"(
        __cvta_generic_to_global(words + min(wi + 40, top))));
  }
}

__global__ void __launch_bounds__(kThreads)
    anchor_walk_kernel(const unsigned* __restrict__ words, int nw,
                       const int* __restrict__ ll_hi,
                       const int* __restrict__ ll_fsh,
                       const int* __restrict__ ll_off,
                       const int* __restrict__ ll_sym,
                       const int* __restrict__ d_hi,
                       const int* __restrict__ d_fsh,
                       const int* __restrict__ d_off,
                       const int* __restrict__ d_sym, int n_units,
                       const int* __restrict__ lane_bit,
                       const int* __restrict__ lane_out,
                       const int* __restrict__ lane_uid,
                       const int* __restrict__ lane_valid, int n_lanes,
                       int* __restrict__ packed, int n_out_pad, int t_steps) {
  extern __shared__ unsigned smem[];
  unsigned* tabs = smem;
  int* stage = reinterpret_cast<int*>(smem + kUnits * kUnitWords);
  const int lane = threadIdx.x;
  const int l = blockIdx.x * kThreads + lane;
  const bool live = l < n_lanes && lane_valid[l] != 0;
  const int uid = live ? min(max(lane_uid[l], 0), n_units - 1) : 0;

  // The block's units: tables for [umin, umin + nu).
  const int umin = __reduce_min_sync(kFull, live ? uid : INT_MAX);
  if (umin == INT_MAX) return;  // no live lane in this block
  const int umax = __reduce_max_sync(kFull, live ? uid : -1);
  const int nu = min(umax - umin + 1, kUnits);
  for (int k = 0; k < nu; ++k) {
    const int u = umin + k;
    unsigned* tab = tabs + k * kUnitWords;
    build_table<kLLBits>(ll_hi + 16 * u, ll_fsh + 16 * u, ll_off + 16 * u,
                         ll_sym + kMaxLL * u, true, tab, stage, lane);
    build_table<kDBits>(d_hi + 16 * u, d_fsh + 16 * u, d_off + 16 * u,
                        d_sym + kMaxD * u, false, tab + kLLSize, stage, lane);
  }
  if (!live) return;
  const unsigned* lt = tabs + (uid - umin) * kUnitWords;
  const unsigned p = static_cast<unsigned>(lane_bit[l]);  // < 2^31
  const unsigned o = static_cast<unsigned>(lane_out[l]);
  const int* rows[8] = {ll_hi + 16 * uid, ll_fsh + 16 * uid,
                        ll_off + 16 * uid, ll_sym + kMaxLL * uid,
                        d_hi + 16 * uid,  d_fsh + 16 * uid,
                        d_off + 16 * uid, d_sym + kMaxD * uid};
  if (uid - umin < nu) {
    walk_lane<true>(words, nw, lt, lt + kLLSize, rows[0], rows[1], rows[2],
                    rows[3], rows[4], rows[5], rows[6], rows[7], p, o,
                    packed, n_out_pad, t_steps);
  } else {
    walk_lane<false>(words, nw, nullptr, nullptr, rows[0], rows[1], rows[2],
                     rows[3], rows[4], rows[5], rows[6], rows[7], p, o,
                     packed, n_out_pad, t_steps);
  }
}

}  // namespace

extern "C" int zz_anchor_walk(const unsigned* words, int nw,
                              const int* ll_hi, const int* ll_fsh,
                              const int* ll_off, const int* ll_sym,
                              const int* d_hi, const int* d_fsh,
                              const int* d_off, const int* d_sym, int n_units,
                              const int* lane_bit, const int* lane_out,
                              const int* lane_uid, const int* lane_valid,
                              int n_lanes, int* packed, int n_out_pad,
                              int t_steps, void* stream) {
  const int grid = (n_lanes + kThreads - 1) / kThreads;
  anchor_walk_kernel<<<grid, kThreads, ZZ_WALK_SMEM_BYTES,
                       static_cast<cudaStream_t>(stream)>>>(
      words, nw, ll_hi, ll_fsh, ll_off, ll_sym, d_hi, d_fsh, d_off, d_sym,
      n_units, lane_bit, lane_out, lane_uid, lane_valid, n_lanes, packed,
      n_out_pad, t_steps);
  return static_cast<int>(cudaGetLastError());
}
