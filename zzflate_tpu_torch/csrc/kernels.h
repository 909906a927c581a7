// Plain C interface of the port's CUDA kernels: the matcher's three,
// device decode's anchor walk and commit walk, and CRC-32 and Adler-32
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

#ifdef __cplusplus
}
#endif
