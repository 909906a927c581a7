// CRC-32 and Adler-32 over row ranges: crc32_rows and adler32_rows.
//
// Replaces: zzflate_tpu/ops/checksums.py _crc32_impl (:245) and
// _adler32_impl (:174), each one jitted program, which the reference's
// encoder vmaps over a batch for the per-chunk partials
// (zzflate_tpu/models/deflate_encoder.py:535-540) and its device decode
// runs on every group (zzflate_tpu/models/inflate_tpu.py:906, :955,
// :1256). Not Pallas kernels in the reference: each is one XLA program.
// Each kernel here computes the checksum of data[r, start_r:end_r] for
// every row r of a (batch, n) uint8 array.
//
// Domain (kernels.h): n < 2^31 and 0 <= start <= end <= n.
//
// Bound on the H100: bytes. Each function reads a range's bytes once (a
// 4 MiB decode group: 1.25 us at 3.35 TB/s) and writes 8 B a row; a table
// CRC needs about 4 integer operations a byte and Adler about 2, under the
// bytes' time at 16.7e12 op/s.
//
// The design:
//   Right-aligned segments. A row's range is cut into segments of
//      ZZ_CKS_SEG bytes counted back from its end, one a thread, and
//      ZZ_CKS_THREADS segments make a block of ZZ_CKS_BLOCK_BYTES; bytes
//      before the range's start read as zero. Zeros on the left are
//      transparent to both sums: a zero-init CRC state stays 0 over zero
//      bytes (T[0] = 0), and Adler's W weights a byte by its distance to
//      the range's end. So every segment and every block has the same
//      length, every CRC combine shifts by a power of two, and no
//      right-padding correction (the reference's per-bit loop) is needed.
//   Staging. A block reads its bytes once, coalesced, into shared memory,
//      the range mask and CRC's init fold applied there; a thread's 16
//      words lie at a stride of 17, so the 32 threads of a warp read 32
//      banks.
//   CRC-32. Each thread runs a zero-init table CRC over its segment (the
//      1 KiB table in shared memory). Segments combine as
//      c(L||R) = A^len(R) c(L) ^ c(R), with A^(2^j) applied as the XOR of
//      four byte-table lookups (tables in device memory, read through L1):
//      five shuffle levels in a warp, three over the block's warps. A
//      second launch, one block a row, combines the row's block partials
//      the same way and adds the init and the final xor: the init
//      0xFFFFFFFF contributes what 0xFF XORed into the range's first four
//      bytes does (staged so), and a range under 4 bytes takes a constant.
//   Adler-32. Each thread sums s = sum(x) and w = sum((end - pos) x) over
//      its segment, reduced mod 65521 before any product or cross-thread
//      sum, so nothing overflows 32 bits; partials add. The second launch
//      adds a row's block partials and forms
//      ((n + w) mod m) << 16 | (1 + s) mod m, with n = end - start.
//   No order between blocks and no atomics: two launches a call, and a
//      call's result is the same on every run.
// Measured on the H100 (PERF.md section 6, utils/checksum_bench.py): a
// call takes 11-19 us on a one-block row (its two launches and the table
// reads after an L2 flush) and 17-33 us on a 4 MiB range. Combining by
// the 32 GF(2) columns of each A^(2^j) staged in shared memory, and
// staging with 16-byte loads, were each slower on one of the shapes the
// port runs (the 64 MiB row) and no more than ~10 us faster on any.
#include <cuda_runtime.h>

#include "kernels.h"

namespace {

constexpr int kSeg = ZZ_CKS_SEG;          // bytes a thread
constexpr int kThreads = ZZ_CKS_THREADS;  // threads a block, both launches
constexpr int kBlock = ZZ_CKS_BLOCK_BYTES;
constexpr int kWarps = kThreads / 32;
constexpr int kSegWords = kSeg / 4;
constexpr int kStride = kSegWords + 1;  // a thread's words in shared memory
constexpr int kLogSeg = 6;
constexpr int kLogWarps = 3;
constexpr int kLogBlock = 14;
constexpr unsigned kMod = 65521u;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kSeg == 1 << kLogSeg, "a segment is 2^kLogSeg bytes");
static_assert(kWarps == 1 << kLogWarps, "a block is 2^kLogWarps warps");
static_assert(kBlock == 1 << kLogBlock, "a block is 2^kLogBlock bytes");
static_assert(kSegWords == 16, "the staging index w + (w >> 4) needs 16");
static_assert(kThreads == 256, "one thread loads one entry of T");

struct Range {
  long long start, end;
};

// Row r's range: its own, or the one every row shares (ends == nullptr).
__device__ __forceinline__ Range row_range(const int* ends, const int* starts,
                                           int end0, int start0, int r) {
  if (ends != nullptr) return Range{starts[r], ends[r]};
  return Range{start0, end0};
}

// The first of row r's blocks in launch 1 starts at this position; its
// blocks end at the range's end. Positions below 0 are never read.
__device__ __forceinline__ long long block_lo(Range rg, int nblk, int b) {
  return rg.end - static_cast<long long>(nblk - b) * kBlock;
}

// Stage a block's bytes at positions [vlo, vlo + kBlock) of `row` into
// shared memory: byte i in word i / 4 of its thread's run (stride kStride),
// zero outside [start, end); with kFold, 0xFF XORed into the range's first
// four bytes (CRC's init).
template <bool kFold>
__device__ __forceinline__ void stage(const unsigned char* __restrict__ row,
                                      long long vlo, Range rg,
                                      unsigned char* sbytes) {
#pragma unroll 8
  for (int i = threadIdx.x; i < kBlock; i += kThreads) {
    const long long p = vlo + i;
    unsigned x = 0;
    if (p >= rg.start && p < rg.end) {
      x = __ldg(row + p);
      if (kFold && p < rg.start + 4) x ^= 0xFFu;
    }
    const int w = i >> 2;
    sbytes[4 * (w + (w >> 4)) + (i & 3)] = static_cast<unsigned char>(x);
  }
}

// A^(2^j) v: the XOR of the byte-table entries of v's four bytes.
__device__ __forceinline__ unsigned shift_pow2(const unsigned* __restrict__ pw,
                                               int j, unsigned v) {
  const unsigned* t = pw + (j << 10);
  return __ldg(t + (v & 0xFFu)) ^ __ldg(t + 256 + ((v >> 8) & 0xFFu))
       ^ __ldg(t + 512 + ((v >> 16) & 0xFFu)) ^ __ldg(t + 768 + (v >> 24));
}

// Combine the block's per-thread CRC contributions, thread t's covering
// the 2^log_len bytes just left of thread t + 1's. The block's
// contribution ends up in thread kWarps - 1. warp_c: kWarps shared words.
__device__ __forceinline__ unsigned crc_block_combine(
    unsigned c, int log_len, const unsigned* __restrict__ pw,
    unsigned* warp_c) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // Level j: the last lane of each run of 2^(j+1) joins its left half.
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    const unsigned left = __shfl_up_sync(kFull, c, 1 << j);
    if (((lane + 1) & ((2 << j) - 1)) == 0) {
      c = shift_pow2(pw, log_len + j, left) ^ c;
    }
  }
  if (lane == 31) warp_c[warp] = c;
  __syncthreads();
  if (warp == 0) {
    c = lane < kWarps ? warp_c[lane] : 0u;
#pragma unroll
    for (int j = 0; j < kLogWarps; ++j) {
      const unsigned left = __shfl_up_sync(kFull, c, 1 << j);
      if (((lane + 1) & ((2 << j) - 1)) == 0) {
        c = shift_pow2(pw, log_len + 5 + j, left) ^ c;
      }
    }
  }
  return c;
}

// Launch 1 of crc32_rows: block (r, b) writes the zero-init contribution
// of its kBlock bytes to part[r * nblk + b].
__global__ void __launch_bounds__(kThreads)
crc_blocks_kernel(const unsigned char* __restrict__ data, int n,
                  const int* __restrict__ ends, const int* __restrict__ starts,
                  int end0, int start0, const unsigned* __restrict__ tables,
                  unsigned* __restrict__ part, int nblk) {
  __shared__ unsigned words[kThreads * kStride];
  __shared__ unsigned tab[256];
  __shared__ unsigned warp_c[kWarps];
  const int r = blockIdx.x / nblk;
  const Range rg = row_range(ends, starts, end0, start0, r);
  const long long vlo = block_lo(rg, nblk, blockIdx.x % nblk);
  if (vlo + kBlock <= rg.start) {  // all before the range: contributes 0
    if (threadIdx.x == 0) part[blockIdx.x] = 0;
    return;
  }
  tab[threadIdx.x] = __ldg(tables + threadIdx.x);
  stage<true>(data + static_cast<long long>(r) * n, vlo, rg,
              reinterpret_cast<unsigned char*>(words));
  __syncthreads();
  const unsigned* seg = words + threadIdx.x * kStride;
  unsigned c = 0;
#pragma unroll 4
  for (int k = 0; k < kSegWords; ++k) {
    const unsigned x = seg[k];
    c = tab[(c ^ x) & 0xFFu] ^ (c >> 8);
    c = tab[(c ^ (x >> 8)) & 0xFFu] ^ (c >> 8);
    c = tab[(c ^ (x >> 16)) & 0xFFu] ^ (c >> 8);
    c = tab[(c ^ (x >> 24)) & 0xFFu] ^ (c >> 8);
  }
  c = crc_block_combine(c, kLogSeg, tables + 256, warp_c);
  if (threadIdx.x == kWarps - 1) part[blockIdx.x] = c;
}

// Launch 2 of crc32_rows: block r combines row r's nblk partials. Thread t
// takes `per` consecutive ones (a power of two), right-aligned to the
// row's last block; indices before 0 are zero blocks on the left.
__global__ void __launch_bounds__(kThreads)
crc_rows_kernel(const int* __restrict__ ends, const int* __restrict__ starts,
                int end0, int start0, const unsigned* __restrict__ tables,
                const unsigned* __restrict__ part, int nblk,
                long long* __restrict__ out) {
  __shared__ unsigned warp_c[kWarps];
  const int r = blockIdx.x;
  const unsigned* pr = part + static_cast<long long>(r) * nblk;
  const unsigned* pw = tables + 256;
  int log_per = 0;
  while ((kThreads << log_per) < nblk) ++log_per;
  const int per = 1 << log_per;
  const int lead = (kThreads << log_per) - nblk;
  unsigned c = 0;
  for (int k = 0; k < per; ++k) {
    const int v = threadIdx.x * per + k - lead;
    c = shift_pow2(pw, kLogBlock, c) ^ (v >= 0 ? pr[v] : 0u);
  }
  c = crc_block_combine(c, kLogBlock + log_per, pw, warp_c);
  if (threadIdx.x == kWarps - 1) {
    const Range rg = row_range(ends, starts, end0, start0, r);
    const long long len = rg.end - rg.start;
    // A range under 4 bytes folded 0xFF into len bytes only: its init
    // contributes the CRC state after len 0xFF bytes from 0xFFFFFFFF
    // more (0xFFFFFFFF itself for len 0, so an empty range gives 0).
    unsigned fix = 0;
    if (len < 4) {
      fix = kFull;
      for (int k = 0; k < len; ++k) {
        fix = __ldg(tables + ((fix ^ 0xFFu) & 0xFFu)) ^ (fix >> 8);
      }
    }
    out[r] = static_cast<long long>(c ^ fix ^ kFull);
  }
}

// Launch 1 of adler32_rows: block (r, b) writes its bytes' s and w, each
// mod 65521, to part[2 (r * nblk + b)] and the word after it.
__global__ void __launch_bounds__(kThreads)
adler_blocks_kernel(const unsigned char* __restrict__ data, int n,
                    const int* __restrict__ ends,
                    const int* __restrict__ starts, int end0, int start0,
                    unsigned* __restrict__ part, int nblk) {
  __shared__ unsigned words[kThreads * kStride];
  __shared__ unsigned warp_s[kWarps], warp_w[kWarps];
  const int r = blockIdx.x / nblk;
  const Range rg = row_range(ends, starts, end0, start0, r);
  const long long vlo = block_lo(rg, nblk, blockIdx.x % nblk);
  if (vlo + kBlock <= rg.start) {
    if (threadIdx.x == 0) {
      part[2 * blockIdx.x] = 0;
      part[2 * blockIdx.x + 1] = 0;
    }
    return;
  }
  stage<false>(data + static_cast<long long>(r) * n, vlo, rg,
               reinterpret_cast<unsigned char*>(words));
  __syncthreads();
  const unsigned* seg = words + threadIdx.x * kStride;
  // s <= 255 * 64 < 65521; w (weights kSeg..1 from the segment's end)
  // <= 255 * 2080.
  unsigned s = 0, w = 0;
#pragma unroll 4
  for (int k = 0; k < kSegWords; ++k) {
    const unsigned x = seg[k];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned v = (x >> (8 * i)) & 0xFFu;
      s += v;
      w += static_cast<unsigned>(kSeg - 4 * k - i) * v;
    }
  }
  // Weights from the range's end: the segment ends gap bytes before it.
  // gap * s < 65521 * 16320 and w < 2^20: the sum stays under 2^31.
  const long long seg_end =
      vlo + static_cast<long long>(threadIdx.x + 1) * kSeg;
  const unsigned gap = static_cast<unsigned>((rg.end - seg_end) % kMod);
  w = (w + gap * s) % kMod;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {  // 32 values under 65521 each
    s += __shfl_down_sync(kFull, s, o);
    w += __shfl_down_sync(kFull, w, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    warp_s[warp] = s;
    warp_w[warp] = w;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned ss = 0, ww = 0;
    for (int k = 0; k < kWarps; ++k) {
      ss += warp_s[k];
      ww += warp_w[k];
    }
    part[2 * blockIdx.x] = ss % kMod;
    part[2 * blockIdx.x + 1] = ww % kMod;
  }
}

// Launch 2 of adler32_rows: block r adds row r's partials and forms the
// checksum.
__global__ void __launch_bounds__(kThreads)
adler_rows_kernel(const int* __restrict__ ends,
                  const int* __restrict__ starts, int end0, int start0,
                  const unsigned* __restrict__ part, int nblk,
                  long long* __restrict__ out) {
  __shared__ unsigned long long warp_s[kWarps], warp_w[kWarps];
  const int r = blockIdx.x;
  const unsigned* pr = part + 2LL * r * nblk;
  unsigned long long s = 0, w = 0;
  for (int k = threadIdx.x; k < nblk; k += kThreads) {
    s += pr[2 * k];
    w += pr[2 * k + 1];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_down_sync(kFull, s, o);
    w += __shfl_down_sync(kFull, w, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    warp_s[warp] = s;
    warp_w[warp] = w;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    s = 0;
    w = 0;
    for (int k = 0; k < kWarps; ++k) {
      s += warp_s[k];
      w += warp_w[k];
    }
    const Range rg = row_range(ends, starts, end0, start0, r);
    const unsigned long long len =
        static_cast<unsigned long long>(rg.end - rg.start);
    const unsigned long long s2 = (len % kMod + w % kMod) % kMod;
    const unsigned long long s1 = (1 + s % kMod) % kMod;
    out[r] = static_cast<long long>((s2 << 16) | s1);
  }
}

}  // namespace

extern "C" int zz_crc32_rows(const unsigned char* data, int batch, int n,
                             const int* ends, const int* starts, int end0,
                             int start0, const unsigned* tables,
                             unsigned* part, int nblk, long long* out,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  crc_blocks_kernel<<<batch * nblk, kThreads, 0, s>>>(
      data, n, ends, starts, end0, start0, tables, part, nblk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  crc_rows_kernel<<<batch, kThreads, 0, s>>>(ends, starts, end0, start0,
                                             tables, part, nblk, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int zz_adler32_rows(const unsigned char* data, int batch, int n,
                               const int* ends, const int* starts, int end0,
                               int start0, unsigned* part, int nblk,
                               long long* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  adler_blocks_kernel<<<batch * nblk, kThreads, 0, s>>>(
      data, n, ends, starts, end0, start0, part, nblk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  adler_rows_kernel<<<batch, kThreads, 0, s>>>(ends, starts, end0, start0,
                                               part, nblk, out);
  return static_cast<int>(cudaGetLastError());
}
