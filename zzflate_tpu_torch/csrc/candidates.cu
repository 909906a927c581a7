// Device decode's candidate tokens (the per-bit path): decode_candidates.
//
// Replaces: the candidate stage of zzflate_tpu/models/inflate_tpu.py
// _decode_all (:593-612) inside the reference's one jitted decode program:
// _build_luts (:281, twice), _bit_windows (:330), the owning-unit scatter and
// associative_scan (:603-608) and _decode_bits (:353, with _extract :343).
// Not a Pallas kernel. For every bit b of a group it decodes the token that
// would start there, in the block (unit) that owns b:
//   uid[b]    = max{u : valid[u], max(start[u], 0) <= b, start[u] < nbits},
//               else 0;
//   step[b]   = the token's width in bits, or 257 (_HUGE) at an EOB or an
//               invalid window (a code past the tree, a reserved litlen
//               symbol, or a length whose distance code is invalid);
//   outlen[b] = 1 for a literal, the length for a valid match, else 0;
//   sym[b]    = the litlen symbol (0 where the window is past the tree);
//   mdist[b]  = the distance base plus its extra bits, as the LUT path
//               computes it at EVERY bit (garbage but fixed for literals,
//               EOBs and invalid windows, where the reference still reads
//               the distance table at the following bits);
//   islit[b], islen[b] (bytes, 0 or 1).
// The arithmetic is the LUT path's, not the walk's _decode_bits_canon: a
// window's entry is the closed form that _build_luts tabulates (code length
// 1 + #{L in 1..15 : brev15(w) >= hi_mono[L]}, symbol index off[ln] +
// ((c - first[ln] << (15 - ln)) >> (15 - ln)) in 64-bit arithmetic, clipped
// to the table), evaluated per bit instead of read from (U, 2^15) tables.
// hi_mono is the running max of (first + cnt) << (15 - L) over L = 0..15,
// clipped to [0, 32768]: a window value c lies in [0, 32768), so the clip
// keeps every compare, and the running max is taken in 64 bits. The 64-bit
// window (hi:lo) from bit b is shifted by the extract's offset (<= 37) and
// masked (n <= 15 bits), which equals _extract's split at 32 bits there.
//
// Domain (kernels.h): nbits a multiple of 32 below 2^30 and nw = nbits / 32
// + 2 words; U >= 1 units; symtab entries in [0, 288) and [0, 32) (the host
// plan's canonical symbols; outside them the plain version raises, and the
// kernel clips the attribute index).
//
// Bound on the H100: the outputs, 22 B a bit (five int32 arrays and two
// byte arrays), 92.3 MB or 27.5 us for a 4 194 304-bit group; the words
// (4 B for 32 bits) and the units' rows are read from L2 many times but
// from memory once. The function needs about 59 integer operations a bit
// in the reference's table form (two lookups, three extracts, the fields;
// the tables built once a unit; utils/lz_tail_bench.py CAND_OPS_BIT):
// 14.9 us at 16.7e12 op/s for 5 units, so the bytes bound it. This kernel
// spends about 166 a bit, since it evaluates each table entry's closed
// form (15 compares) per bit instead of building the tables.
//
// The design: two launches, no scratch beyond hi (U * 32 int).
//   bounds: one thread a (unit, table) computes its 16 clipped hi_mono.
//   candidates: one block of ZZ_CAND_THREADS threads a tile of
//      ZZ_CAND_THREADS * ZZ_CAND_BITS bits, each thread ZZ_CAND_BITS
//      consecutive bits (inside one word: its three words are read once).
//      The owning unit: the block reads the U starts; a unit starting at or
//      before the tile's first bit raises the tile's carry (a shared
//      atomicMax), one starting inside the tile is max-ed into a shared
//      slot at its offset; then the tile's running max (per thread in
//      registers, per warp by shuffles, across warps through shared
//      memory) with the carry gives every bit's uid, with no global scan.
//      Then each thread decodes its bits from the 64-bit windows, its
//      unit's rows read through the L1 (the lanes of a warp share a unit
//      almost always: a broadcast), the attribute tables staged in shared
//      memory, and writes each output once, 16 B (4 B for the bytes) a
//      thread.
// Measured on the H100 (PERF.md section 6, chip_smoke.py phase 6): 0.066
// ms a 4 194 304-bit group, 0.41-0.42 of its bytes bound, against
// 3.3 ms in 450 launches for the torch chain it replaced.
#include <cuda_runtime.h>

#include "kernels.h"

namespace {

constexpr int kThreads = ZZ_CAND_THREADS;
constexpr int kBits = ZZ_CAND_BITS;          // consecutive bits a thread
constexpr int kTile = kThreads * kBits;      // bits a block
constexpr int kWarps = kThreads / 32;
constexpr int kLlSyms = 288;
constexpr int kDSyms = 32;
constexpr int kHuge = 257;                   // the stop step (_HUGE)
constexpr int kBoundThreads = 256;

static_assert(kBits == 4, "a thread writes its bits as one int4");
static_assert(32 % kBits == 0, "a thread's bits lie in one word");

// hi[(u * 2 + t) * 16 + L], t = 0 litlen, 1 distance: the running max of
// (first[L] + cnt[L]) << (15 - L) over L, in 64 bits, clipped to [0, 32768].
__global__ void __launch_bounds__(kBoundThreads)
unit_bounds_kernel(const int* __restrict__ ll_first,
                   const int* __restrict__ ll_cnt,
                   const int* __restrict__ d_first,
                   const int* __restrict__ d_cnt, int n_units,
                   int* __restrict__ hi) {
  const int t = blockIdx.x * kBoundThreads + threadIdx.x;
  if (t >= 2 * n_units) return;
  const int u = t >> 1;
  const int* first = (t & 1) ? d_first : ll_first;
  const int* cnt = (t & 1) ? d_cnt : ll_cnt;
  long long run = 0;
  for (int L = 0; L < 16; ++L) {
    const long long h =
        (static_cast<long long>(first[u * 16 + L]) + cnt[u * 16 + L]) *
        (1LL << (15 - L));
    run = L ? max(run, h) : h;
    hi[t * 16 + L] = static_cast<int>(min(max(run, 0LL), 32768LL));
  }
}

// One table entry of the LUT path, in closed form: the symbol, its code
// length nb and its attribute, or all 0 where the window is past the tree.
// w: the window's low 15 bits (LSB first); hi, first, off: the unit's rows.
template <int kSyms>
__device__ __forceinline__ void entry(unsigned w, const int* __restrict__ hi,
                                      const int* __restrict__ first,
                                      const int* __restrict__ off,
                                      const int* __restrict__ symtab,
                                      const int* attr, int& sym, int& nb,
                                      int& a) {
  const int c = static_cast<int>(__brev(w) >> 17);  // 15-bit reversal
  const int4* h4 = reinterpret_cast<const int4*>(hi);
  int ln = 1;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int4 h = __ldg(h4 + q);
    if (q) ln += c >= h.x;  // L = 0 takes no part
    ln += (c >= h.y) + (c >= h.z) + (c >= h.w);
  }
  if (ln > 15) {
    sym = 0;
    nb = 0;
    a = 0;
    return;
  }
  const int sh = 15 - ln;
  long long idx = static_cast<long long>(__ldg(off + ln)) +
                  ((static_cast<long long>(c) -
                    static_cast<long long>(__ldg(first + ln)) * (1LL << sh)) >>
                   sh);
  idx = idx < 0 ? 0 : (idx > kSyms - 1 ? kSyms - 1 : idx);
  sym = __ldg(symtab + idx);
  a = attr[min(max(sym, 0), kSyms - 1)];
  nb = ln;
}

// n (<= 15) bits at `offset` (<= 37) of the 64-bit window.
__device__ __forceinline__ int bits_at(unsigned long long win, int offset,
                                       int n) {
  return static_cast<int>((win >> offset) & ((1ull << n) - 1ull));
}

__global__ void __launch_bounds__(kThreads)
candidates_kernel(const unsigned* __restrict__ words, int nbits,
                  const int* __restrict__ ll_first,
                  const int* __restrict__ ll_off,
                  const int* __restrict__ ll_sym,
                  const int* __restrict__ d_first,
                  const int* __restrict__ d_off,
                  const int* __restrict__ d_sym,
                  const int* __restrict__ ll_attr,
                  const int* __restrict__ d_attr,
                  const int* __restrict__ start,
                  const unsigned char* __restrict__ valid, int n_units,
                  const int* __restrict__ hi, int* __restrict__ uid_out,
                  int* __restrict__ step_out, int* __restrict__ outlen_out,
                  int* __restrict__ sym_out, int* __restrict__ mdist_out,
                  unsigned char* __restrict__ islit_out,
                  unsigned char* __restrict__ islen_out) {
  __shared__ __align__(16) int slot[kTile];
  __shared__ int warp_max[kWarps];
  __shared__ int carry;
  __shared__ int ll_attr_s[kLlSyms];
  __shared__ int d_attr_s[kDSyms];
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * kTile;
  for (int i = tid; i < kTile; i += kThreads) slot[i] = 0;
  for (int i = tid; i < kLlSyms; i += kThreads) ll_attr_s[i] = ll_attr[i];
  if (tid < kDSyms) d_attr_s[tid] = d_attr[tid];
  if (tid == 0) carry = 0;
  __syncthreads();

  // The owning unit: the units starting at or before b0 into the carry,
  // those starting inside the tile into their slot.
  for (int u = tid; u < n_units; u += kThreads) {
    const int s = start[u];
    if (!valid[u] || s >= nbits) continue;
    const int p = max(s, 0);
    if (p <= b0) {
      atomicMax(&carry, u);
    } else if (p < b0 + kTile) {
      atomicMax(slot + (p - b0), u);
    }
  }
  __syncthreads();
  const int4 v = reinterpret_cast<const int4*>(slot)[tid];
  int uid[kBits];
  uid[0] = v.x;
  uid[1] = max(uid[0], v.y);
  uid[2] = max(uid[1], v.z);
  uid[3] = max(uid[2], v.w);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int run = uid[kBits - 1];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(~0u, run, o);
    if (lane >= o) run = max(run, y);
  }
  int before = __shfl_up_sync(~0u, run, 1);
  if (lane == 0) before = 0;
  if (lane == 31) warp_max[warp] = run;
  __syncthreads();
  int c = max(carry, before);
  for (int k = 0; k < warp; ++k) c = max(c, warp_max[k]);

  const int bit = b0 + kBits * tid;
  if (bit >= nbits) return;  // nbits % 32 == 0: a thread's bits are all in
  const int w = bit >> 5;
  const unsigned long long w01 =
      (static_cast<unsigned long long>(words[w + 1]) << 32) | words[w];
  const unsigned long long w2 = words[w + 2];
  int o_uid[kBits], o_step[kBits], o_len[kBits], o_sym[kBits], o_dist[kBits];
  unsigned o_lit = 0, o_islen = 0;
#pragma unroll
  for (int j = 0; j < kBits; ++j) {
    const int u = max(c, uid[j]);
    const int s = (bit & 31) + j;
    const unsigned long long win = s ? (w01 >> s) | (w2 << (64 - s)) : w01;

    int sym, nb, a;
    entry<kLlSyms>(static_cast<unsigned>(win) & 0x7fffu, hi + u * 32,
                   ll_first + u * 16, ll_off + u * 16, ll_sym + u * kLlSyms,
                   ll_attr_s, sym, nb, a);
    const int lext = a & 7;
    const int lbase = (a >> 3) & 511;
    const bool ok = nb > 0 && (a & (1 << 14)) == 0;
    const bool iseob = (a & (1 << 12)) != 0;
    const bool len = (a & (1 << 13)) != 0;
    const int mlen = lbase + bits_at(win, nb, lext);
    const int off2 = nb + lext;

    int dsym, dnb, da;
    entry<kDSyms>(static_cast<unsigned>(bits_at(win, off2, 15)),
                  hi + u * 32 + 16, d_first + u * 16, d_off + u * 16,
                  d_sym + u * kDSyms, d_attr_s, dsym, dnb, da);
    const int dext = da & 15;
    const int dbase = (da >> 4) & 32767;
    const bool dok = dnb > 0 && dbase > 0;  // dbase 0: symbols 30 and 31
    const int mdist = dbase + bits_at(win, off2 + dnb, dext);

    const bool invalid = !ok || (len && !dok);
    const int width = len ? off2 + dnb + dext : nb;
    const bool lit = ok && !iseob && !len;
    o_uid[j] = u;
    o_step[j] = (invalid || iseob) ? kHuge : width;
    o_len[j] = lit ? 1 : ((len && !invalid) ? mlen : 0);
    o_sym[j] = sym;
    o_dist[j] = mdist;
    o_lit |= static_cast<unsigned>(lit) << (8 * j);
    o_islen |= static_cast<unsigned>(len && !invalid) << (8 * j);
  }
  const int q = bit / kBits;
  reinterpret_cast<int4*>(uid_out)[q] =
      make_int4(o_uid[0], o_uid[1], o_uid[2], o_uid[3]);
  reinterpret_cast<int4*>(step_out)[q] =
      make_int4(o_step[0], o_step[1], o_step[2], o_step[3]);
  reinterpret_cast<int4*>(outlen_out)[q] =
      make_int4(o_len[0], o_len[1], o_len[2], o_len[3]);
  reinterpret_cast<int4*>(sym_out)[q] =
      make_int4(o_sym[0], o_sym[1], o_sym[2], o_sym[3]);
  reinterpret_cast<int4*>(mdist_out)[q] =
      make_int4(o_dist[0], o_dist[1], o_dist[2], o_dist[3]);
  reinterpret_cast<unsigned*>(islit_out)[q] = o_lit;
  reinterpret_cast<unsigned*>(islen_out)[q] = o_islen;
}

}  // namespace

extern "C" int zz_decode_candidates(
    const unsigned* words, int nbits, const int* ll_first, const int* ll_cnt,
    const int* ll_off, const int* ll_sym, const int* d_first,
    const int* d_cnt, const int* d_off, const int* d_sym, const int* ll_attr,
    const int* d_attr, const int* start, const unsigned char* valid,
    int n_units, int* hi, int* uid, int* step, int* outlen, int* sym,
    int* mdist, unsigned char* islit, unsigned char* islen, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unit_bounds_kernel<<<(2 * n_units + kBoundThreads - 1) / kBoundThreads,
                       kBoundThreads, 0, s>>>(ll_first, ll_cnt, d_first,
                                              d_cnt, n_units, hi);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  candidates_kernel<<<(nbits + kTile - 1) / kTile, kThreads, 0, s>>>(
      words, nbits, ll_first, ll_off, ll_sym, d_first, d_off, d_sym, ll_attr,
      d_attr, start, valid, n_units, hi, uid, step, outlen, sym, mdist, islit,
      islen);
  return static_cast<int>(cudaGetLastError());
}
