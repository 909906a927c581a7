// Device decode's anchor walk: the serial token loop of every lane.
//
// Replaces: zzflate_tpu/models/inflate_tpu.py _walk_core (:727), the
// lax.fori_loop of t_steps = ANCHOR_TOKENS + 2 steps (:819-845) over the
// lane vector, with the LUT-free canonical decode of _decode_bits_canon
// (:435). The TPU ran it as one XLA device loop; eager torch would need
// about 100 launches a step. A lane starts at a known token boundary (a
// block's first token or an index anchor) and decodes up to t_steps
// tokens; each literal or match is max-combined into packed[o] as
// dist << 9 | lit << 1 | 1 at its output offset o. A lane stops at EOB
// or on an invalid window (a code past the tree, a reserved symbol, a
// length with an invalid distance) without advancing.
//
// Bound on the H100. The function reads a group's body once (at most
// 4 MiB) and reads and writes only the packed entries its tokens land on
// (8 B a token), and does 60 to 136 integer operations a token: a few
// microseconds by bytes or by operations (chip_smoke.py computes both
// from each launch's data). The kernel is far slower than that: each
// token's window depends on the previous token's width, so a lane is
// t_steps dependent steps of loads (the words, then the symbol tables),
// and ~1000 lanes fill 8 of 132 SMs. chip_smoke.py times a launch's
// first lane alone beside the whole launch to show the serial chain.
// The design, simple and right first:
//   One thread a lane, 128 threads a block, u32 arithmetic native.
//   The three words of the 64-bit window are loaded directly: the
//      reference carries a cache (c0, c1, c2, wi_prev) that always equals
//      words[wi..wi+2], because a token is at most 48 bits and p never
//      moves back, so the base word advances by 0, 1 or 2 a step. The
//      plain version keeps the cache; tests hold the two equal.
//   Emits are atomicMax straight into packed. That is exact: every
//      packed value is non-negative, the reference combines its deferred
//      records with max (order-free), and the duplicate re-walks of the
//      next interval's head write identical values.
//   The canonical tables (a unit's 3 x 16 ints) and symbol tables stay
//      in global memory; the L1 caches them.
#include <cuda_runtime.h>

#include "kernels.h"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxLL = 288;
constexpr int kMaxD = 32;

// n (<= 15) bits at bit `offset` (<= 35) of the 64-bit window (lo, hi).
__device__ __forceinline__ unsigned extract(unsigned lo, unsigned hi,
                                            int offset, int n) {
  const unsigned o = min(offset, 31);
  const unsigned a = (lo >> o) | ((hi << (31u - o)) << 1);
  const unsigned b = hi >> min(max(offset - 32, 0), 31);
  const unsigned r = offset < 32 ? a : b;
  return r & ((1u << n) - 1u);
}

// 15-bit reversal of x's low 15 bits: the MSB-first code value.
__device__ __forceinline__ int brev15(unsigned x) {
  return static_cast<int>(__brev(x) >> 17);
}

// One canonical symbol from the left-aligned window v: the code length is
// 1 + #{L in 1..15 : v >= hi[L]} (the boundaries are monotone), the index
// off[len] + ((v - fsh[len]) >> (15 - len)), clipped into the table.
__device__ __forceinline__ int canon_symbol(int v, const int* hi,
                                            const int* fsh, const int* off,
                                            const int* sym, int nsym,
                                            int* len, bool* valid) {
  int ln = 1;
#pragma unroll
  for (int L = 1; L < 16; ++L) ln += v >= __ldg(hi + L) ? 1 : 0;
  *valid = ln <= 15;
  const int lnc = min(ln, 15);
  *len = lnc;
  int idx = __ldg(off + lnc) + ((v - __ldg(fsh + lnc)) >> (15 - lnc));
  idx = min(max(idx, 0), nsym - 1);
  return __ldg(sym + idx);
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
  const int l = blockIdx.x * kThreads + threadIdx.x;
  if (l >= n_lanes || lane_valid[l] == 0) return;
  const int uid = min(max(lane_uid[l], 0), n_units - 1);
  const int* lh = ll_hi + 16 * uid;
  const int* lf = ll_fsh + 16 * uid;
  const int* lo_ = ll_off + 16 * uid;
  const int* ls = ll_sym + kMaxLL * uid;
  const int* dh = d_hi + 16 * uid;
  const int* df = d_fsh + 16 * uid;
  const int* do_ = d_off + 16 * uid;
  const int* ds = d_sym + kMaxD * uid;
  int p = lane_bit[l];
  int o = lane_out[l];
  for (int t = 0; t < t_steps; ++t) {
    // wi is clipped, s is taken from the unclipped p (as the reference).
    const int wi = min(max(p >> 5, 0), nw - 3);
    const unsigned s = static_cast<unsigned>(p) & 31u;
    const unsigned w0 = __ldg(words + wi);
    const unsigned w1 = __ldg(words + wi + 1);
    const unsigned w2 = __ldg(words + wi + 2);
    const unsigned inv = 31u - s;
    const unsigned lo = (w0 >> s) | ((w1 << inv) << 1);
    const unsigned hi = (w1 >> s) | ((w2 << inv) << 1);

    int nb;
    bool lvalid;
    const int sym = canon_symbol(brev15(lo), lh, lf, lo_, ls, kMaxLL, &nb,
                                 &lvalid);
    const bool iseob = sym == 256;
    const bool islen0 = sym >= 257 && sym <= 285;
    const bool valid = lvalid && sym <= 285;
    if (!valid || iseob) break;  // EOB or an invalid window: stop
    if (!islen0) {  // a literal: width nb <= 15
      if (o >= 0 && o < n_out_pad) atomicMax(packed + o, (sym << 1) | 1);
      o += 1;
      p += nb;
      continue;
    }
    // Length code 0..28: extra bits and base (RFC 1951 3.2.5).
    const int lc = sym - 257;
    const int le = max((lc >> 2) - 1, 0);
    const int lext = lc < 4 || lc >= 28 ? 0 : le;
    const int lbase =
        lc >= 28 ? 258 : (lc < 4 ? lc + 3 : 3 + ((4 + (lc & 3)) << le));
    const int mlen = lbase + static_cast<int>(extract(lo, hi, nb, lext));
    const int off2 = nb + lext;
    int dnb;
    bool dv;
    const int dsym =
        canon_symbol(brev15(extract(lo, hi, off2, 15)), dh, df, do_, ds,
                     kMaxD, &dnb, &dv);
    if (!dv || dsym >= 30) break;  // an invalid distance: stop
    const int de = max((dsym >> 1) - 1, 0);
    const int dext = dsym < 4 ? 0 : de;
    const int dbase = dsym < 4 ? dsym + 1 : 1 + ((2 + (dsym & 1)) << de);
    const int mdist =
        dbase + static_cast<int>(extract(lo, hi, off2 + dnb, dext));
    if (o >= 0 && o < n_out_pad) atomicMax(packed + o, (mdist << 9) | 1);
    o += mlen;
    p += off2 + dnb + dext;  // <= 15 + 5 + 15 + 13 = 48
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
  anchor_walk_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      words, nw, ll_hi, ll_fsh, ll_off, ll_sym, d_hi, d_fsh, d_off, d_sym,
      n_units, lane_bit, lane_out, lane_uid, lane_valid, n_lanes, packed,
      n_out_pad, t_steps);
  return static_cast<int>(cudaGetLastError());
}
