// Plain C interface of the matcher's three CUDA kernels.
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

int zz_scan_candidates(const int* adj, const int* spos, const int* wstart,
                       int* out_len, int* out_dist, int batch, int n,
                       int k_each, int lcp_cap, int backward_only,
                       void* stream);

int zz_propagate_matches(const int* pk, int* out, int batch, int n,
                         void* stream);

int zz_parse_rows(const int* step, const int* starts, int* exit_scratch,
                  int* entry_scratch, int* mark, int batch, int npad,
                  int row, void* stream);

#ifdef __cplusplus
}
#endif
