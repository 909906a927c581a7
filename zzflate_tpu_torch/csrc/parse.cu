// Greedy/lazy commit marks by row sweeps over segments of rows (two
// kernels, called in turn).
//
// Replaces: zzflate_tpu/ops/pallas_kernels.py parse_rows (_parse2_kernel),
// called from zzflate_tpu/ops/matcher.py parse_commit_batch.
//
// The committed set is the orbit of next[p] = p + step[p] from each
// chunk's start, step = take ? max(mlen, 1) : 1 (1 <= step <= 258). Each
// chunk's positions are cut into rows of `row` > 258 positions, the rows
// into segments of kG = 32, and each row into kParts parts of w = row /
// kParts. The walk enters row r at offset e_r and leaves it into row r + 1
// at offset E_r(e_r), where E_r(j) in [0, 258) is the exit of j (the first
// landing at or past the row's end, less `row`). Every row after the start
// row r0 is entered in [0, 258), so the transfer table T_r = E_r on
// [0, 258) carries the chain; a segment's map M_s composes its rows'
// tables.
//   Exits (one block per segment) stages the segment's steps in shared
//      memory. One thread per (row, part) sweeps its part in reverse to the
//      first landing past the part; kParts rounds, right to left, turn the
//      landings into exits E_r (a landing past part q is past the row or
//      in a later part, final by then). One thread per table column writes
//      the prefix tables P_r = T_r o ... o T_first (u16, 258 per row; the
//      segment's last is M_s). The block holding r0 also chains r0's own
//      rows from the start offset and writes their entries and the next
//      segment's entry (`head`).
//   Marks (one block per segment) stages the steps again. A block after
//      r0's segment stages the maps of the segments between, chains its
//      own entry from `head` with one thread, and takes each row's entry
//      as P_{r-1}(segment entry). One thread per (row, part) sweeps the
//      part landings as above; one thread per row hops from its entry part
//      to part (at most kParts hops), and one thread per (row, part) walks
//      its part forward, flagging committed positions in bit 15 of the
//      staged step; the marks leave coalesced.
// Rows before r0 get no marks; a negative start walks from position 0, as
// the reference's floor division leaves it; the caller masks the marks to
// [start, valid_end). Steps are clamped to [1, 258] as they are staged, so
// no input can send a read or write out of bounds, and every walk ends
// within its part (the reference's at-most-`row`-steps guard never binds).
//
// Bound on the H100: bytes. Read step and write mark, 8 B per position:
// 37.7 MB at (16, 294912), 11.3 us at 3.35 TB/s. Serial depth, every step
// a shared-memory access: exits w reverse steps + kParts fix-up rounds +
// kG composition steps; marks one step per segment between the start's and
// its own + w + kParts + w. On the main path 64 + 8 + 32 and up to
// 14 + 64 + 8 + 64. Latency: every global load of a stage (steps, maps) is
// issued before its shared-memory stores; a sweep loads its next step
// before the store of its current landing; the fix-up rounds batch their
// loads ahead of their stores; the row entries' table loads overlap the
// sweep; tables and marks leave as coalesced stores. Rows are staged
// [row][position] with a one-word pad (row + 2 u16), so a warp's
// same-position accesses hit distinct banks: 32.9 KB a block for exits,
// twice that for marks (steps and landings) at row 512.
#include <cuda_runtime.h>

#include "kernels.h"

namespace {

constexpr int kG = 32;         // rows per segment
constexpr int kParts = 8;      // parts per row, swept in parallel
constexpr int kT = 258;        // table width: max step; entries after r0 lie in [0, kT)
constexpr int kThreads = 288;  // >= kG * kParts and > kT
constexpr int kCols = kThreads / kG;  // fix-up columns in flight per row
constexpr int kBatch = 4;      // fix-up loads in flight a thread
constexpr int kStageBatch = 8; // 16-byte step loads in flight a thread
constexpr int kMapBatch = 16;  // map loads in flight a thread
constexpr int kStepFlag = 0x8000;

static_assert(kThreads >= kG * kParts, "one thread per (row, part)");
static_assert(kThreads > kT, "the exits kernel's chain thread must not compose");
static_assert(kThreads % kG == 0, "fix-up threads cover whole rows");

__device__ __forceinline__ int clamp_step(int v) {
  return min(max(v, 1), kT);
}

// The start row and offset; a negative start walks from position 0.
__device__ __forceinline__ void start_of(int start, int row, int* r0,
                                         int* off) {
  const int s = max(start, 0);
  *r0 = s / row;
  *off = s - *r0 * row;
}

// Stage `nrows` rows of steps (contiguous from src) as clamped u16 into
// dst[r * (row + 2) + j]: 16-byte global loads, neighbouring threads on
// neighbouring addresses, a batch of them issued before its stores.
__device__ __forceinline__ void stage_steps(const int* __restrict__ src,
                                            unsigned short* dst, int nrows,
                                            int row) {
  const int4* s4 = reinterpret_cast<const int4*>(src);
  const int q_per_row = row >> 2;
  const int n4 = nrows * q_per_row;
  for (int base = 0; base < n4; base += kStageBatch * kThreads) {
    int4 v[kStageBatch];
#pragma unroll
    for (int k = 0; k < kStageBatch; ++k) {
      const int i = base + k * kThreads + threadIdx.x;
      v[k] = i < n4 ? __ldg(s4 + i) : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int k = 0; k < kStageBatch; ++k) {
      const int i = base + k * kThreads + threadIdx.x;
      if (i < n4) {
        const int r = i / q_per_row;
        unsigned int* d = reinterpret_cast<unsigned int*>(
            dst + r * (row + 2) + 4 * (i - r * q_per_row));
        d[0] = clamp_step(v[k].x) | (clamp_step(v[k].y) << 16);
        d[1] = clamp_step(v[k].z) | (clamp_step(v[k].w) << 16);
      }
    }
  }
}

// out[j] = the first landing at or past the end of j's part, walking the
// steps st; one thread per (row, part), warp q on part q. `out` may be
// `st`: slot j - 1 is read before slot j is written.
__device__ __forceinline__ void part_sweep(const unsigned short* st,
                                           unsigned short* out, int nrows,
                                           int row) {
  const int r = threadIdx.x % kG;
  const int q = threadIdx.x / kG;
  if (q >= kParts || r >= nrows) return;
  const int w = row / kParts;
  const int lo = q * w;
  const int end = lo + w;
  const unsigned short* s_row = st + r * (row + 2);
  unsigned short* o_row = out + r * (row + 2);
  int s = s_row[end - 1];
  for (int j = end - 1; j >= lo; --j) {
    const int s_next = j > lo ? s_row[j - 1] : 0;
    const int land = j + s;
    o_row[j] = static_cast<unsigned short>(land >= end ? land : o_row[land]);
    s = s_next;
  }
}

__global__ void __launch_bounds__(kThreads)
    parse_exit_kernel(const int* __restrict__ step,
                      const int* __restrict__ starts,
                      unsigned short* __restrict__ pre,
                      int* __restrict__ seg0_ent, int rows_per, int row) {
  extern __shared__ unsigned short sm[];  // [kG][row + 2]: steps, then exits
  const int b = blockIdx.y;
  const int r_first = blockIdx.x * kG;
  const int nrows = min(kG, rows_per - r_first);
  const int stride = row + 2;
  const long long row_base = static_cast<long long>(b) * rows_per + r_first;
  stage_steps(step + row_base * row, sm, nrows, row);
  __syncthreads();
  part_sweep(sm, sm, nrows, row);

  // Landings to exits, part by part from the right: a landing L past part
  // q is past the row (exit L - row) or in a later part, already an exit.
  // Lane = row, so a warp's same-column accesses hit distinct banks.
  const int w = row / kParts;
  const int fr = threadIdx.x % kG;
  unsigned short* xr = sm + fr * stride;
  for (int q = kParts - 1; q >= 0; --q) {
    __syncthreads();
    if (fr >= nrows) continue;
    for (int c0 = threadIdx.x / kG; c0 < w; c0 += kBatch * kCols) {
      int val[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int c = c0 + k * kCols;
        val[k] = c < w ? xr[q * w + c] : 0;
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (c0 + k * kCols < w) {
          val[k] = val[k] >= row ? val[k] - row : xr[val[k]];
        }
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int c = c0 + k * kCols;
        if (c < w) xr[q * w + c] = static_cast<unsigned short>(val[k]);
      }
    }
  }
  __syncthreads();

  // Prefix tables: column o follows the entry o through the segment.
  for (int o = threadIdx.x; o < kT; o += blockDim.x) {
    unsigned short* out = pre + row_base * kT + o;
    int x = o;
    for (int k = 0; k < nrows; ++k) {
      x = sm[k * stride + x];
      out[static_cast<long long>(k) * kT] = static_cast<unsigned short>(x);
    }
  }

  // The start row's segment: rows before r0 get no entry, r0 is entered
  // at the start offset (anywhere in the row), later rows through E.
  int r0, off;
  start_of(starts[b], row, &r0, &off);
  if (r0 >= r_first && r0 < r_first + nrows) {
    int* e = seg0_ent + b * (kG + 1);
    const int k0 = r0 - r_first;
    if (threadIdx.x < k0) e[threadIdx.x] = -1;
    if (threadIdx.x == kThreads - 1) {
      int x = off;
      for (int k = k0; k < nrows; ++k) {
        e[k] = x;
        x = sm[k * stride + x];
      }
      e[kG] = x;  // head: the next segment's entry
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    parse_mark_kernel(const int* __restrict__ step,
                      const int* __restrict__ starts,
                      const unsigned short* __restrict__ pre,
                      const int* __restrict__ seg0_ent,
                      int* __restrict__ mark, int rows_per, int row) {
  // [kG][row + 2] steps (bit 15 flags a committed position), then
  // [kG][row + 2] part landings (first the staged segment maps), then
  // [kG][kParts] part entries.
  extern __shared__ unsigned short sm[];
  __shared__ int seg_entry;
  const int b = blockIdx.y;
  const int s = blockIdx.x;
  const int r_first = s * kG;
  const int nrows = min(kG, rows_per - r_first);
  const int stride = row + 2;
  const int w = row / kParts;
  unsigned short* land = sm + kG * stride;
  int* part_entry = reinterpret_cast<int*>(land + kG * stride);
  const long long row_base = static_cast<long long>(b) * rows_per + r_first;
  int r0, off;
  start_of(starts[b], row, &r0, &off);
  const int seg0 = r0 < rows_per ? r0 / kG : (rows_per + kG - 1) / kG;
  const int* e0 = seg0_ent + b * (kG + 1);
  if (threadIdx.x < kG * kParts) part_entry[threadIdx.x] = -1;
  stage_steps(step + row_base * row, sm, nrows, row);

  // This segment's entry: from head through the maps of the segments
  // between r0's and this one, kG maps a pass (kG * kT <= kG * stride).
  if (s > seg0) {
    const unsigned short* pb = pre + static_cast<long long>(b) * rows_per * kT;
    int x = e0[kG];  // carried by thread 0
    for (int s_base = seg0 + 1; s_base < s; s_base += kG) {
      const int n = min(kG, s - s_base) * kT;
      for (int i0 = 0; i0 < n; i0 += kMapBatch * kThreads) {
        unsigned short v[kMapBatch];
#pragma unroll
        for (int k = 0; k < kMapBatch; ++k) {
          const int i = i0 + k * kThreads + threadIdx.x;
          const int m = i / kT;
          const long long last = (s_base + m + 1) * kG - 1;  // < r_first
          v[k] = i < n ? pb[last * kT + (i - m * kT)] : 0;
        }
#pragma unroll
        for (int k = 0; k < kMapBatch; ++k) {
          const int i = i0 + k * kThreads + threadIdx.x;
          if (i < n) land[i] = v[k];
        }
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        for (int m = 0; m < n / kT; ++m) x = land[m * kT + x];
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) seg_entry = x;
  }
  __syncthreads();
  int entry = -1;
  if (threadIdx.x < nrows) {
    if (s == seg0) {
      entry = e0[threadIdx.x];
    } else if (s > seg0) {
      entry = threadIdx.x == 0
                  ? seg_entry
                  : pre[(row_base + threadIdx.x - 1) * kT + seg_entry];
    }
  }
  part_sweep(sm, land, nrows, row);
  __syncthreads();

  // Part entries of each row: from the row entry, hop part to part.
  if (entry >= 0) {
    const unsigned short* l_row = land + threadIdx.x * stride;
    for (int j = entry; j < row; j = l_row[j]) {
      part_entry[threadIdx.x * kParts + j / w] = j;
    }
  }
  __syncthreads();

  // Forward walk of each (row, part) from its part entry.
  if (threadIdx.x < kG * kParts) {
    const int r = threadIdx.x % kG;
    const int q = threadIdx.x / kG;
    int j = part_entry[r * kParts + q];
    if (j >= 0) {
      unsigned short* x = sm + r * stride;
      const int end = (q + 1) * w;
      while (j < end) {
        const int st = x[j];
        x[j] = static_cast<unsigned short>(st | kStepFlag);
        j += st;
      }
    }
  }
  __syncthreads();

  int4* out = reinterpret_cast<int4*>(mark + row_base * row);
  const int q_per_row = row >> 2;
  for (int i = threadIdx.x; i < nrows * q_per_row; i += blockDim.x) {
    const int r = i / q_per_row;
    const unsigned int* wd = reinterpret_cast<const unsigned int*>(
        sm + r * stride + 4 * (i - r * q_per_row));
    const unsigned int a = wd[0];
    const unsigned int c = wd[1];
    out[i] = make_int4((a >> 15) & 1, a >> 31, (c >> 15) & 1, c >> 31);
  }
}

int allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

}  // namespace

extern "C" int zz_parse_exits(const int* step, const int* starts,
                              unsigned short* pre, int* seg0_ent, int batch,
                              int npad, int row, void* stream) {
  const int rows_per = npad / row;
  const dim3 grid((rows_per + kG - 1) / kG, batch);
  const size_t smem = kG * (row + 2) * sizeof(unsigned short);
  const int rc =
      allow_smem(reinterpret_cast<const void*>(parse_exit_kernel), smem);
  if (rc != 0) return rc;
  parse_exit_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      step, starts, pre, seg0_ent, rows_per, row);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int zz_parse_marks(const int* step, const int* starts,
                              const unsigned short* pre, const int* seg0_ent,
                              int* mark, int batch, int npad, int row,
                              void* stream) {
  const int rows_per = npad / row;
  const dim3 grid((rows_per + kG - 1) / kG, batch);
  const size_t smem = 2 * kG * (row + 2) * sizeof(unsigned short) +
                      kG * kParts * sizeof(int);
  const int rc =
      allow_smem(reinterpret_cast<const void*>(parse_mark_kernel), smem);
  if (rc != 0) return rc;
  parse_mark_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      step, starts, pre, seg0_ent, mark, rows_per, row);
  return static_cast<int>(cudaGetLastError());
}
