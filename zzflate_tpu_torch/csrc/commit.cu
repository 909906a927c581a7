// Device decode's commit walk (the per-bit path): commit_walk.
//
// Replaces: zzflate_tpu/models/inflate_tpu.py _commit_walk (:477), five
// lax.fori_loops (:505, :521, :537, :555, :572) inside the reference's one
// jitted decode program (_decode_all). Not a Pallas kernel. Given a
// candidate token width step[p] at every bit p of a group, it marks the
// token starts that each valid unit (Huffman block) reaches from its
// first-token bit by next[p] = p + step[p], in the reference's
// hierarchical sweeps over rows of 256 bits and superrows of 256 rows:
//   P1   exit1[p]: where the walk from p leaves p's row (or the sink);
//   P2a  exit2[p]: where it leaves p's superrow;
//   P2b  per unit, its entries into max_sup_span superrows (a chain of
//        exit2 hops from its start bit);
//   P2c  per superrow entry, the row entries (a chain of exit1 hops), each
//        row keeping only its least entry;
//   P3   per row, the marks from that entry to the row's end.
// The reference's quirks are kept: a row walks from its least entry only
// (so a block whose first token shares a row with the previous block's EOB
// loses that row's tokens, tests/test_torch_commit_walk.py pins it), the
// chain stops after max_sup_span superrows, and the EOB bit is marked.
//
// Domain (kernels.h): nbits a multiple of 65 536 below 2^30; steps in
// [1, 256], or > 256 for a stop (the decoder gives [1, 48] and 257).
//
// Bound on the H100: bytes, step read once (4 B a bit) and mark written
// once (1 B a bit): 21 MB, 6.3 us, for a 4 194 304-bit group; the work is
// a few integer operations a bit, under that. But the walk is a serial
// chain: P1 and P3 are up to 256 dependent steps a row, P2a 256 dependent
// rows a superrow, P2c 256 dependent rows an entry and P2b max_sup_span
// dependent superrows a unit, so latency, not bytes, sets the time.
//
// The design: three launches.
//   rows (P1, P2a): one block a superrow, one thread a row. The block
//      stages its 65 536 steps into shared memory as u16 codes (0 for a
//      stop), each row at a stride of 258 u16 (129 words), so the 32
//      threads of a warp, one row each, read the same column in 32 banks.
//      P1: each thread sweeps its row in reverse, replacing each step by
//      its exit code in place (a next-row offset, or the sink): a landing
//      inside the row reads a code already written. P2a: the rows in
//      reverse, one thread a column, one barrier a row: a bit's exit2 is
//      its exit1 if that leaves the superrow, else the exit2 (already in
//      place) where it lands in the next row. Every exit2 lies in the next
//      superrow's first row, so only that row's 256 exit2 values and the
//      units' start bits' are written out.
//   chain (P2b): one thread a unit hops superrows through those values.
//   marks (P1 again, P2c, P3): one block a superrow. It stages the steps
//      and sweeps P1 again, in shared memory (cheaper than writing every
//      exit1 out and reading it back); walks each entry into this
//      superrow (a unit's start, or its chain's entry k = this superrow
//      minus the start's) along the row exits, with an atomicMin into a
//      shared row-entry array; stages the steps once more and walks each
//      row from its entry, setting bit 15 of each mark's code; then writes
//      the superrow's marks out, four bytes a thread. A block writes every
//      mark of its superrow, so no buffer is zeroed first.
// Measured on the H100 (PERF.md section 6, chip_smoke.py phase 6): 0.08
// ms a 4 194 304-bit group, and 0.08 ms for one superrow with one unit:
// the serial depth's floor, whatever the size.
#include <cuda_runtime.h>

#include "kernels.h"

namespace {

constexpr int kR = ZZ_COMMIT_ROW;   // bits a row, rows a superrow
constexpr int kRR = kR * kR;        // bits a superrow
constexpr int kThreads = kR;        // one thread a row, or a column
constexpr int kStride = kR + 2;     // u16 a staged row: 129 words
constexpr int kSmem = kR * kStride * 2;  // 132 096 B of dynamic shared memory
constexpr unsigned short kSink = 0xffff;  // exit code: the walk stops
constexpr unsigned short kMarked = 0x8000;
constexpr int kChainThreads = 128;

static_assert(kR == 256, "codes are next-row offsets below 256");
static_assert((kStride / 2) % 32 == 1, "a row's stride is 1 bank mod 32");

// A step as a u16 code: itself in [1, kR]; 0, a stop, for anything else.
__device__ __forceinline__ unsigned short step_code(int s) {
  return (s >= 1 && s <= kR) ? static_cast<unsigned short>(s) : 0;
}

// The superrow's steps into a[row * kStride + col], as codes; coalesced
// 16-byte loads, four bits of one row each.
__device__ void stage_steps(const int* __restrict__ step, int sup,
                            unsigned short* a) {
  const int4* src = reinterpret_cast<const int4*>(step) +
                    static_cast<size_t>(sup) * (kRR / 4);
  for (int i = threadIdx.x; i < kRR / 4; i += kThreads) {
    const int4 v = src[i];
    unsigned short* d = a + (i / (kR / 4)) * kStride + (i % (kR / 4)) * 4;
    d[0] = step_code(v.x);
    d[1] = step_code(v.y);
    d[2] = step_code(v.z);
    d[3] = step_code(v.w);
  }
}

// P1: thread r turns row r's step codes into exit codes, in reverse. The
// card's last row has no next row: every exit from it is the sink.
__device__ void row_exits(unsigned short* a, bool last_sup) {
  unsigned short* row = a + threadIdx.x * kStride;
  const bool last_row = last_sup && threadIdx.x == kR - 1;
  for (int j = kR - 1; j >= 0; --j) {
    const int s = row[j];
    unsigned short ex = kSink;
    if (s != 0) {
      const int land = j + s;
      if (land < kR) {
        ex = row[land];
      } else if (!last_row) {
        ex = static_cast<unsigned short>(land - kR);
      }
    }
    row[j] = ex;
  }
}

// An exit code of superrow sup as an absolute bit (the sink is nbits).
__device__ __forceinline__ int next_sup_bit(unsigned short code, int sup,
                                            int nbits) {
  return code == kSink ? nbits : (sup + 1) * kRR + code;
}

__global__ void __launch_bounds__(kThreads)
commit_rows_kernel(const int* __restrict__ step, int nbits, int nsup,
                   const int* __restrict__ start,
                   const unsigned char* __restrict__ valid, int n_units,
                   int* __restrict__ sup_exit, int* __restrict__ start_exit) {
  extern __shared__ unsigned short a[];
  const int sup = blockIdx.x;
  const int t = threadIdx.x;
  stage_steps(step, sup, a);
  __syncthreads();
  row_exits(a, sup == nsup - 1);
  __syncthreads();
  // P2a: row j's exit2 codes replace its exit1 codes, the next row's
  // already in place. The last row's exit1 codes are its exit2 codes.
  for (int j = kR - 2; j >= 0; --j) {
    const unsigned short x = a[j * kStride + t];
    if (x != kSink) a[j * kStride + t] = a[(j + 1) * kStride + x];
    __syncthreads();
  }
  sup_exit[sup * kR + t] = next_sup_bit(a[t], sup, nbits);
  for (int u = t; u < n_units; u += kThreads) {
    const int s = start[u];
    if (valid[u] && s >= 0 && s < nbits && s / kRR == sup) {
      const int off = s - sup * kRR;
      start_exit[u] = next_sup_bit(a[(off / kR) * kStride + off % kR], sup,
                                   nbits);
    }
  }
}

// P2b: ents[k * n_units + u] = unit u's entry into its start's superrow +
// k, or nbits (none).
__global__ void __launch_bounds__(kChainThreads)
commit_chain_kernel(int nbits, const int* __restrict__ start,
                    const unsigned char* __restrict__ valid, int n_units,
                    int span, const int* __restrict__ sup_exit,
                    const int* __restrict__ start_exit,
                    int* __restrict__ ents) {
  const int u = blockIdx.x * kChainThreads + threadIdx.x;
  if (u >= n_units) return;
  const int s = start[u];
  int e = (valid[u] && s >= 0 && s < nbits) ? s : nbits;
  for (int k = 0; k < span; ++k) {
    ents[k * n_units + u] = e;
    if (e < nbits) {
      e = k == 0 ? start_exit[u] : sup_exit[(e / kRR) * kR + e % kRR];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
commit_marks_kernel(const int* __restrict__ step, int nbits, int nsup,
                    const int* __restrict__ start,
                    const unsigned char* __restrict__ valid, int n_units,
                    int span, const int* __restrict__ ents,
                    unsigned char* __restrict__ mark) {
  extern __shared__ unsigned short a[];
  __shared__ int rent[kR];  // least entry offset of each row; kR: none
  const int sup = blockIdx.x;
  const int t = threadIdx.x;
  stage_steps(step, sup, a);
  rent[t] = kR;
  __syncthreads();
  row_exits(a, sup == nsup - 1);
  __syncthreads();
  // P2c: every entry into this superrow walks the row exits to its end.
  for (int u = t; u < n_units; u += kThreads) {
    const int s = start[u];
    if (!valid[u] || s < 0 || s >= nbits) continue;
    const int k = sup - s / kRR;
    if (k < 0 || k >= span) continue;
    const int p = ents[k * n_units + u];
    if (p >= nbits) continue;
    int r = (p - sup * kRR) / kR;
    int c = p % kR;
    for (;;) {
      atomicMin(&rent[r], c);
      const unsigned short x = a[r * kStride + c];
      if (x == kSink || r == kR - 1) break;
      ++r;
      c = x;
    }
  }
  __syncthreads();
  stage_steps(step, sup, a);
  __syncthreads();
  // P3: thread r marks row r's tokens from its entry to the row's end.
  {
    unsigned short* row = a + t * kStride;
    for (int c = rent[t]; c < kR;) {
      const int s = row[c];
      row[c] = static_cast<unsigned short>(s | kMarked);
      if (s == 0) break;
      c += s;
    }
  }
  __syncthreads();
  unsigned* out = reinterpret_cast<unsigned*>(mark) +
                  static_cast<size_t>(sup) * (kRR / 4);
  for (int i = t; i < kRR / 4; i += kThreads) {
    const unsigned short* m = a + (i / (kR / 4)) * kStride + (i % (kR / 4)) * 4;
    out[i] = (m[0] >> 15) | ((m[1] >> 15) << 8) | ((m[2] >> 15) << 16) |
             (static_cast<unsigned>(m[3] >> 15) << 24);
  }
}

}  // namespace

extern "C" int zz_commit_walk(const int* step, int nbits, const int* start,
                              const unsigned char* valid, int n_units,
                              int span, int* sup_exit, int* start_exit,
                              int* ents, unsigned char* mark, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nsup = nbits / kRR;
  cudaFuncSetAttribute(commit_rows_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  cudaFuncSetAttribute(commit_marks_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  commit_rows_kernel<<<nsup, kThreads, kSmem, s>>>(
      step, nbits, nsup, start, valid, n_units, sup_exit, start_exit);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_units > 0 && span > 0) {
    commit_chain_kernel<<<(n_units + kChainThreads - 1) / kChainThreads,
                          kChainThreads, 0, s>>>(
        nbits, start, valid, n_units, span, sup_exit, start_exit, ents);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  commit_marks_kernel<<<nsup, kThreads, kSmem, s>>>(
      step, nbits, nsup, start, valid, n_units, span, ents, mark);
  return static_cast<int>(cudaGetLastError());
}
