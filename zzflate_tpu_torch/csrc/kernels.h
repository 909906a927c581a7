// Plain C interface of the matcher's CUDA kernels.
//
// Every entry launches on the given stream without synchronising and
// returns cudaGetLastError() as an int (0 = cudaSuccess). All arrays are
// row-major (batch, n) int32 in device memory; the caller allocates every
// output and scratch buffer. zzflate_tpu_torch/ops/kernels.py binds these
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

#ifdef __cplusplus
}
#endif
