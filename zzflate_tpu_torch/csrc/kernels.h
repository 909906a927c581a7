// Plain C interface of the port's CUDA kernels: the matcher's three, the
// level 7-9 optimal parse's DP, device decode's anchor walk, candidate
// decode, commit walk, token scatter and LZ resolve, and CRC-32 and Adler-32
// over row ranges.
//
// Every entry launches on the given stream without synchronising and
// returns cudaGetLastError() as an int (0 = cudaSuccess). The matcher's
// arrays are row-major (batch, n) int32 in device memory; the caller
// allocates every output and scratch buffer. zzflate_tpu_torch/ops/kernels.py binds these
// with ctypes and checks shapes, dtypes and devices before the call.
#pragma once

#ifdef __cplusplus
extern "C" {
#endif

// spos: positions in [0, 2^30) (the matcher's suffix order is a permutation
// of 0..n-1); adj: any int32, a negative LCP counts as 0; 0 <= lcp_cap <
// 2^15 (checked by the wrapper).
int zz_scan_candidates(const int* adj, const int* spos, const int* wstart,
                       int* out_len, int* out_dist, int batch, int n,
                       int k_each, int lcp_cap, int backward_only,
                       void* stream);

// pk: every entry in [0, 2^31): 0, or len << 15 | (32768 - dist), which is
// what the matcher hands in. The kernel is not defined for a negative entry
// (the plain version maps one to 0).
int zz_propagate_matches(const int* pk, int* out, int batch, int n,
                         void* stream);

// parse_rows in two launches, called in turn: exits and prefix tables
// (pre: batch * npad / row * 258 u16; seg0_ent: batch * 33 int, the start
// segment's row entries and the next segment's entry), then the marks.
// row % 128 == 0; step and mark 16-byte aligned.
int zz_parse_exits(const int* step, const int* starts, unsigned short* pre,
                   int* seg0_ent, int batch, int npad, int row, void* stream);

int zz_parse_marks(const int* step, const int* starts,
                   const unsigned short* pre, const int* seg0_ent, int* mark,
                   int batch, int npad, int row, void* stream);

// Device decode's token walk: each of n_lanes lanes walks up to t_steps
// tokens from (lane_bit, lane_out) and atomicMax-es dist << 9 | lit << 1 | 1
// into packed[o] for 0 <= o < n_out_pad. words: nw >= 3 u32; per unit
// (n_units >= 1): *_hi, *_fsh, *_off 16 int each, ll_sym 288 entries in
// [0, 288), d_sym 32 in [0, 32); lane_bit and lane_out >= 0; packed
// entries >= 0. Any lane order gives the same packed; a block's lanes
// find their units' tables in shared memory when they span at most
// ZZ_WALK_UNITS units from the lowest (the host plan sorts and pads them
// so), and any other lane decodes every window by the compare ladder.
//
// The launch: one warp a block, ZZ_WALK_THREADS lanes; ZZ_WALK_SMEM_BYTES
// of dynamic shared memory a block (21 824 B: ZZ_WALK_UNITS units of
// 2^ZZ_WALK_LL_BITS litlen and 2^ZZ_WALK_D_BITS distance u32 entries, and
// one tree's staged rows, 48 + 288 int).
#define ZZ_WALK_THREADS 32
#define ZZ_WALK_UNITS 4
#define ZZ_WALK_LL_BITS 10
#define ZZ_WALK_D_BITS 8
#define ZZ_WALK_SMEM_BYTES                                          \
  ((ZZ_WALK_UNITS * ((1 << ZZ_WALK_LL_BITS) + (1 << ZZ_WALK_D_BITS)) \
    + 48 + 288) * 4)
int zz_anchor_walk(const unsigned* words, int nw, const int* ll_hi,
                   const int* ll_fsh, const int* ll_off, const int* ll_sym,
                   const int* d_hi, const int* d_fsh, const int* d_off,
                   const int* d_sym, int n_units, const int* lane_bit,
                   const int* lane_out, const int* lane_uid,
                   const int* lane_valid, int n_lanes, int* packed,
                   int n_out_pad, int t_steps, void* stream);

// CRC-32 and Adler-32 of data[r, start_r:end_r] for every row r of a
// (batch, n) uint8 array, n < 2^31 and 0 <= start_r <= end_r <= n, into
// out[r] (u32 values in int64). ends and starts hold batch ints, or are
// both NULL and every row takes [start0, end0). Each entry makes two
// launches: batch * nblk blocks of ZZ_CKS_THREADS threads, a thread
// taking ZZ_CKS_SEG bytes, so a block ZZ_CKS_BLOCK_BYTES of a row's range
// counted back from its end (nblk such blocks must cover the longest
// range), writing partials to part (2 * batch * nblk u32); then one block
// a row. tables (CRC only): T's 256 entries, then for j < 32 the four
// byte tables of A^(2^j) (1 024 entries each).
#define ZZ_CKS_SEG 64
#define ZZ_CKS_THREADS 256
#define ZZ_CKS_BLOCK_BYTES (ZZ_CKS_SEG * ZZ_CKS_THREADS)
int zz_crc32_rows(const unsigned char* data, int batch, int n,
                  const int* ends, const int* starts, int end0, int start0,
                  const unsigned* tables, unsigned* part, int nblk,
                  long long* out, void* stream);

int zz_adler32_rows(const unsigned char* data, int batch, int n,
                    const int* ends, const int* starts, int end0, int start0,
                    unsigned* part, int nblk, long long* out, void* stream);

// Device decode's candidate tokens (the per-bit path): for every bit b below
// nbits, the owning unit uid[b] = max{u : valid[u], max(start[u], 0) <= b,
// start[u] < nbits} (else 0) and the token that would start at b in that
// unit's Huffman tables, by the reference's LUT arithmetic (_build_luts and
// _decode_bits) evaluated in closed form: step (its width, or 257 at an EOB
// or an invalid window), outlen, sym, mdist (int32 each) and islit, islen
// (bytes, 0 or 1), each written once. words: nw = nbits / 32 + 2 u32; nbits
// a multiple of 32 below 2^30; per unit (n_units >= 1) the canonical rows
// *_first, *_cnt, *_off (16 int each) and ll_sym (288 entries in [0, 288)),
// d_sym (32 in [0, 32)); ll_attr (288) and d_attr (32): the symbols'
// attribute tables; valid: n_units bytes. Scratch the caller allocates: hi
// (n_units * 32 int, the units' clipped code-length bounds). Two launches:
// one thread a (unit, table), then one block of ZZ_CAND_THREADS a tile of
// ZZ_CAND_THREADS * ZZ_CAND_BITS bits, each thread ZZ_CAND_BITS consecutive
// bits, writing 16 B of each int32 output (4 B of each byte output) at once:
// the outputs 16-byte aligned.
#define ZZ_CAND_THREADS 256
#define ZZ_CAND_BITS 4
int zz_decode_candidates(const unsigned* words, int nbits,
                         const int* ll_first, const int* ll_cnt,
                         const int* ll_off, const int* ll_sym,
                         const int* d_first, const int* d_cnt,
                         const int* d_off, const int* d_sym,
                         const int* ll_attr, const int* d_attr,
                         const int* start, const unsigned char* valid,
                         int n_units, int* hi, int* uid, int* step,
                         int* outlen, int* sym, int* mdist,
                         unsigned char* islit, unsigned char* islen,
                         void* stream);

// Device decode's commit walk (the per-bit path): mark[p] = 1 at every
// token start p that a valid unit reaches from its start bit by
// next[p] = p + step[p] in the reference's row (ZZ_COMMIT_ROW bits) and
// superrow (ZZ_COMMIT_ROW rows) sweeps, else 0 (nbits bytes, every one
// written). nbits a multiple of ZZ_COMMIT_ROW^2 below 2^30; step 16-byte
// and mark 4-byte aligned; valid holds n_units bytes, 0 or not; span is
// max_sup_span. Domain: steps in [1, 256], or > 256 for a stop (the
// decoder gives [1, 48] and 257); valid starts in [0, nbits). Outside it
// the kernel stops the walk at a step below 1 as at one above 256 (the
// plain version follows the reference there instead), and a valid unit
// whose start lies outside [0, nbits) adds nothing (for a start >= nbits
// both versions agree). Scratch the caller allocates: sup_exit (nbits /
// ZZ_COMMIT_ROW int), start_exit (n_units int), ents (span * n_units
// int). Three launches: one block of ZZ_COMMIT_ROW threads a superrow,
// with 132 096 B of dynamic shared memory, then one thread a unit, then
// one block a superrow again.
#define ZZ_COMMIT_ROW 256
int zz_commit_walk(const int* step, int nbits, const int* start,
                   const unsigned char* valid, int n_units, int span,
                   int* sup_exit, int* start_exit, int* ents,
                   unsigned char* mark, void* stream);

// Device decode's token scatter (the per-bit path): for every bit b below
// nbits (< 2^31) with committed[b] and islit[b] or islen[b], and 0 <= off[b]
// < n_out_pad, one int32 atomicMax each into litval[off] (islit ? sym : 0),
// start_mark[off] (off) and dist_at[off] (islen ? mdist : 0); every other bit
// writes nothing. The masks are bool bytes; off is int64 (the offsets'
// cumsum), sym and mdist int32 as decode_candidates writes them (one thread
// a bit reads them only at its committed token). One launch, one thread a
// bit.
int zz_token_scatter(const long long* off, const unsigned char* committed,
                     const unsigned char* islit, const unsigned char* islen,
                     const int* sym, const int* mdist, int nbits,
                     int* litval, int* start_mark, int* dist_at, int n_out_pad,
                     void* stream);

// Device decode's LZ resolve (both paths), the reference's _resolve_parent
// and _resolve_lz exactly: seg = running max of start_mark; the first hop
// parent = (dist > 0 && seg >= 0) ? seg - d1 + (i - seg) mod d1 : i, with
// dist = dist_at[clip(seg)], d1 = max(dist, 1), in 64-bit arithmetic and
// clipped to [0, n); then doubling rounds parent = parent[parent] while the
// last round changed something, at most ZZ_RESOLVE_ROUNDS; out[i] =
// litval[parent[i]] & 0xFF. n in [1, 2^30].
//
// The schedule: ZZ_RESOLVE_ROUNDS round launches queued back to back, none
// synchronising the host; round r writes flags[r] = 1 if it changed any
// position, and round r > 1 returns at once unless flags[r - 1] is set. So
// every round the reference's while_loop takes is taken, in its order, from
// two buffers (a round reads one and writes the other), and no other: the
// parent and the rounds equal the plain version's for any input, the cap
// included. Why the cap never binds on a decoder's arrays: they hold
// start_mark[j] = -1 or j, so seg <= i, and the first hop lands before the
// token's start: parent[i] < i, or parent[i] = i at a root. The parents form
// a forest less than n deep, which doubling reaches in ceil(log2 n) + 1 <= 40
// rounds for n < 2^39.
//
// Launches: tile maxima (one block of ZZ_RESOLVE_THREADS a tile of
// ZZ_RESOLVE_TILE positions, each warp ZZ_RESOLVE_STEPS runs of 32; block 0
// zeroes flags), the carry (one block), the first hop (one block a tile), the
// ZZ_RESOLVE_ROUNDS rounds, and the gather. The caller allocates parent and
// scratch (n int each: the two round buffers; parent holds the result),
// tmax (ceil(n / ZZ_RESOLVE_TILE) int) and flags (ZZ_RESOLVE_ROUNDS + 1
// int). litval and out are NULL, or neither is: without them only parent
// and rounds are made. rounds (NULL or one int) receives the rounds taken.
#define ZZ_RESOLVE_THREADS 256
#define ZZ_RESOLVE_STEPS 16
#define ZZ_RESOLVE_TILE (ZZ_RESOLVE_THREADS * ZZ_RESOLVE_STEPS)
#define ZZ_RESOLVE_ROUNDS 40
int zz_resolve_lz(const int* litval, const int* start_mark, const int* dist_at,
                  int n, int* parent, int* scratch, int* tmax, int* flags,
                  unsigned char* out, int* rounds, void* stream);

// The level 7-9 optimal parse's DP (zzt_optimal_parse's forward loop, which
// it equals for any input): for each of `batch` rows of n positions, the
// shortest-bit-path choice of every position in [max(start, 0), min(end,
// n)): the match length taken there (>= 3), else 0; 0 outside it. data
// (batch, n) bytes; mlen, mdist (batch, n) int32; starts, ends batch int32;
// lens (batch, nsb, 318) int32, each sub-block's 288 litlen then 30 distance
// code lengths (0 = absent, priced at 30 bits); bounds nsb + 1 int32 (the
// C's sub_bounds); choice (batch, n) int32, every entry written. One launch:
// one block of one warp a row, with ZZ_OPT_RING * 32 * 4 B of dynamic
// shared memory (65 536 B) and 1 KiB of static.
#define ZZ_OPT_RING 512
int zz_optimal_dp(const unsigned char* data, const int* mlen, const int* mdist,
                  const int* starts, const int* ends, const int* lens,
                  const int* bounds, int nsb, int batch, int n, int* choice,
                  void* stream);

#ifdef __cplusplus
}
#endif
