// Greedy/lazy commit marks by serial row sweeps (three kernels, one call).
//
// Replaces: zzflate_tpu/ops/pallas_kernels.py parse_rows (_parse2_kernel),
// called from zzflate_tpu/ops/matcher.py parse_commit_batch.
//
// The committed set is the orbit of next[p] = p + step[p] from each
// chunk's start, step = take ? max(mlen, 1) : 1 (1 <= step <= 258). Each
// chunk's positions are cut into rows of `row` > 258 positions:
//   P1 (one thread per row) sweeps the row in reverse and records
//      exit[p], the first landing at or after the row's end when walking
//      from p, as a chunk-local flat index;
//   P2 (one thread per chunk) chains the row entries serially from
//      starts[b]: the entry of row r+1 is the exit of row r's entry
//      (every exit lands in the next row because step < row);
//   P3 (one thread per row) walks forward from its entry and marks the
//      committed positions.
// The caller masks the marks to [start, valid_end).
//
// Bound on the H100: dependent-step latency, not bytes. The sweeps are
// row + rows_per + row serial steps (512 + 576 + 512 on the main path),
// while the bytes (read step, write mark: 8 B per element) would take
// about 11 us. P1 and P3 keep each row's state in shared memory (exit
// offsets as u16, marks as u8, laid out [position][row-in-block] so a
// warp's same-position accesses hit distinct banks) and copy it out
// coalesced; P2's chain of global loads is the serial tail.
#include <cuda_runtime.h>

#include "kernels.h"

namespace {

constexpr int kRows = 32;  // rows per block in P1 and P3 (one warp)
constexpr int kSink = 1 << 30;

__global__ void __launch_bounds__(kRows)
    parse_exit_kernel(const int* __restrict__ step, int* __restrict__ exits,
                      int total_rows, int rows_per, int row) {
  // Row-local landing offset in [row, row + 258) of every position.
  extern __shared__ unsigned short ex_s[];  // [row][kRows]
  const int lr = threadIdx.x;
  const int g = blockIdx.x * kRows + lr;
  if (g < total_rows) {
    const int* st = step + static_cast<long long>(g) * row;
    for (int j = row - 1; j >= 0; --j) {
      const int land = j + st[j];
      ex_s[j * kRows + lr] =
          land >= row ? static_cast<unsigned short>(land)
                      : ex_s[min(max(land, 0), row - 1) * kRows + lr];
    }
  }
  __syncthreads();
  const int r_base = blockIdx.x * kRows;
  for (int idx = threadIdx.x; idx < kRows * row; idx += kRows) {
    const int r = idx / row;
    const int j = idx - r * row;
    const int gr = r_base + r;
    if (gr < total_rows) {
      exits[static_cast<long long>(gr) * row + j] =
          (gr % rows_per) * row + ex_s[j * kRows + r];
    }
  }
}

__global__ void parse_entry_kernel(const int* __restrict__ exits,
                                   const int* __restrict__ starts,
                                   int* __restrict__ entries, int batch,
                                   int rows_per, int row) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const int start = starts[b];
  // Floor division, as the reference computes start // row.
  const int r0 = start >= 0 ? start / row : -((row - 1 - start) / row);
  const int* ex = exits + static_cast<long long>(b) * rows_per * row;
  int* ent = entries + static_cast<long long>(b) * rows_per;
  int e = 0;
  for (int r = 0; r < rows_per; ++r) {
    if (r == r0) e = start;
    if (r < r0) {
      ent[r] = kSink;
      continue;
    }
    ent[r] = e;
    const int j = min(max(e - r * row, 0), row - 1);
    e = ex[r * row + j];
  }
}

__global__ void __launch_bounds__(kRows)
    parse_mark_kernel(const int* __restrict__ step,
                      const int* __restrict__ entries, int* __restrict__ mark,
                      int total_rows, int rows_per, int row) {
  extern __shared__ unsigned char mk[];  // [row][kRows]
  for (int idx = threadIdx.x; idx < kRows * row; idx += kRows) mk[idx] = 0;
  __syncthreads();
  const int lr = threadIdx.x;
  const int g = blockIdx.x * kRows + lr;
  if (g < total_rows) {
    const int entry = entries[g];
    int j = entry - (g % rows_per) * row;
    if (entry < kSink && j >= 0 && j < row) {
      const int* st = step + static_cast<long long>(g) * row;
      // At most `row` steps, as in the reference; a step below 1 would
      // otherwise never leave the row.
      for (int t = 0; t < row && j >= 0 && j < row; ++t) {
        mk[j * kRows + lr] = 1;
        j += st[j];
      }
    }
  }
  __syncthreads();
  const int r_base = blockIdx.x * kRows;
  for (int idx = threadIdx.x; idx < kRows * row; idx += kRows) {
    const int r = idx / row;
    const int j = idx - r * row;
    const int gr = r_base + r;
    if (gr < total_rows) {
      mark[static_cast<long long>(gr) * row + j] = mk[j * kRows + r];
    }
  }
}

}  // namespace

extern "C" int zz_parse_rows(const int* step, const int* starts,
                             int* exit_scratch, int* entry_scratch, int* mark,
                             int batch, int npad, int row, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows_per = npad / row;
  const int total_rows = batch * rows_per;
  const int blocks = (total_rows + kRows - 1) / kRows;
  parse_exit_kernel<<<blocks, kRows, kRows * row * sizeof(unsigned short),
                      s>>>(step, exit_scratch, total_rows, rows_per, row);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  parse_entry_kernel<<<(batch + 31) / 32, 32, 0, s>>>(
      exit_scratch, starts, entry_scratch, batch, rows_per, row);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  parse_mark_kernel<<<blocks, kRows, kRows * row, s>>>(
      step, entry_scratch, mark, total_rows, rows_per, row);
  return static_cast<int>(cudaGetLastError());
}
