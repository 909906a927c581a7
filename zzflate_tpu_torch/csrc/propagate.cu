// Interior-suffix propagation of the packed best-match array.
//
// Replaces: zzflate_tpu/ops/pallas_kernels.py propagate_matches
// (_prop_kernel), called from zzflate_tpu/ops/matcher.py find_matches.
//
// pk = len << 15 | (32768 - dist), 0 where no match; every entry lies in
// [0, 2^31) (kernels.h). A match (len, dist) at p implies (len - k, dist) at
// p + k. The reference's CPU path runs nine doubling rounds (shifts 1, 2, ..,
// 256, each candidate gated at >= 3 << 15); they come to a closed form, with
// C = 2^15 and i row-local:
//   M(i)   = max over m in [max(0, i - 511), i] of pk[m] - (i - m) * C
//   out[i] = M(i) >= 3 * C ? M(i) : pk[i]
// m = i is in the window, so M(i) >= pk[i] and lengths 1-2 stay as they are.
// The TPU kernel takes i - m in [0, 255] only, which agrees whenever every
// length is <= 258; the matcher's extension hands in longer ones, so the
// port keeps the 512-wide window of the CPU path.
//
// Bound on the H100: bytes. The function reads pk and writes the result,
// 8 B per element (37.7 MB at (16, 294912): 11.3 us at 3.35 TB/s), and needs
// about 5 integer operations per element (1.4 us). The design:
//   A sliding-window max (van Herk / Gil-Werman). With offsets taken down
//      from the tile's end E, u[m] = pk[m] - (E - m) * C, the decay becomes
//      a plain max: M(i) = max(u over the window) + (E - i) * C. Blocks of
//      512 aligned to the row start split every window in two: the prefix
//      max of i's block up to i, and the max of the block before over the
//      positions after i - 512. That is about 3 maxima per element, whatever
//      the width. Taking the offsets down (never pk + m * C) keeps every
//      value inside int32 for pk in [0, 2^31).
//   Registers only. One warp a 512-block, 16 elements a thread in four
//      chunks of 4 (chunk q at 128 q + 4 lane), so each load and store is
//      16 bytes a thread and 512 contiguous bytes a warp. A running max over
//      the chunk, 5 shuffle steps over the lanes, and a carry over the
//      chunks give the prefix and the suffix maxima.
//   One barrier. Each warp publishes the suffix maxima of its block in
//      shared memory (about 2 shared-memory words per element; the nine
//      doubling rounds took 34), and the warp of the next block reads them.
//      The block's first warp loads the 512 elements before its tile and
//      only publishes.
// Measured at (16, 294912) (PERF.md section 6): 8 elements a thread, 4 or 16
// blocks a tile, and a persistent grid that loads the next tile while it
// computes the current one were no faster. With the scans cut out the
// kernel keeps 15.2 of its 15.5 us: its memory pass holds it.
#include <cuda_runtime.h>

#include "kernels.h"

namespace {

constexpr int kLenUnit = 1 << 15;  // C
constexpr int kReach = 512;        // window: i - m in [0, 511]; a warp's block
constexpr int kQ = 4;              // chunks of 4 elements a thread
constexpr int kWarps = 8;          // blocks a tile; one more warp loads the halo
constexpr int kTile = kWarps * kReach;
constexpr int kThreads = 32 * (kWarps + 1);
constexpr int kNeg = -(1 << 30);   // below every u: max's identity here

// A warp's block [b0, b0 + 512) of one row, chunk q of a lane at
// b0 + 128 q + 4 lane; entries outside [0, n) are 0, which no window takes
// (they decay below every pk[i] >= 0).
__device__ __forceinline__ void load_block(const int* row, int n, int b0,
                                           bool vec, int lane,
                                           int (&v)[kQ][4]) {
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int g = b0 + 128 * q + 4 * lane;
    if (vec && g >= 0 && g + 4 <= n) {
      const int4 x = __ldg(reinterpret_cast<const int4*>(row + g));
      v[q][0] = x.x;
      v[q][1] = x.y;
      v[q][2] = x.z;
      v[q][3] = x.w;
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        v[q][r] = g + r >= 0 && g + r < n ? __ldg(row + g + r) : 0;
      }
    }
  }
}

// u = pk - (E - m) * C for the thread's elements, off = (E - b0 - 4 lane) C:
// (E - m) * C = off - (128 q + r) * C is positive, so u >= -(E - m) * C.
__device__ __forceinline__ void offsets_down(const int (&v)[kQ][4], int off,
                                             int (&x)[kQ][4]) {
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x[q][r] = v[q][r] - (off - (128 * q + r) * kLenUnit);
    }
  }
}

// x becomes its prefix max over the warp's block.
__device__ __forceinline__ void prefix_max(int lane, int (&x)[kQ][4]) {
  int tot[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
#pragma unroll
    for (int r = 1; r < 4; ++r) x[q][r] = max(x[q][r], x[q][r - 1]);
    tot[q] = x[q][3];
  }
  // Lanes below d get their own value back, which max leaves as it is.
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      tot[q] = max(tot[q], __shfl_up_sync(0xffffffffu, tot[q], d));
    }
  }
  int carry = kNeg;  // the max of the chunks before q
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int before = __shfl_up_sync(0xffffffffu, tot[q], 1);
    const int in = lane ? max(before, carry) : carry;
#pragma unroll
    for (int r = 0; r < 4; ++r) x[q][r] = max(x[q][r], in);
    carry = max(carry, __shfl_sync(0xffffffffu, tot[q], 31));
  }
}

// x becomes the max over the warp's block of the positions after each
// element (kNeg after the block's last).
__device__ __forceinline__ void suffix_max_after(int lane, int (&x)[kQ][4]) {
  int tot[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
#pragma unroll
    for (int r = 2; r >= 0; --r) x[q][r] = max(x[q][r], x[q][r + 1]);
    tot[q] = x[q][0];
  }
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      tot[q] = max(tot[q], __shfl_down_sync(0xffffffffu, tot[q], d));
    }
  }
  int carry = kNeg;  // the max of the chunks after q
#pragma unroll
  for (int q = kQ - 1; q >= 0; --q) {
    const int after = __shfl_down_sync(0xffffffffu, tot[q], 1);
    const int in = lane < 31 ? max(after, carry) : carry;
    carry = max(carry, __shfl_sync(0xffffffffu, tot[q], 0));
#pragma unroll
    for (int r = 0; r < 3; ++r) x[q][r] = max(x[q][r + 1], in);
    x[q][3] = in;
  }
}

// One block per tile of kWarps 512-blocks of one row (blockIdx.y); warp 0
// loads the 512 elements before the tile, warp w > 0 the tile's block w - 1.
__global__ void __launch_bounds__(kThreads)
    propagate_kernel(const int* __restrict__ pk, int* __restrict__ out,
                     int n, int vec) {
  __shared__ int4 after[kWarps][kQ][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long rowoff = static_cast<long long>(blockIdx.y) * n;
  const int b0 = (blockIdx.x * kWarps + warp - 1) * kReach;
  // (E - m) * C for the lane's first element: at most (kTile + 512) * C.
  const int off = ((blockIdx.x + 1) * kTile - b0 - 4 * lane) * kLenUnit;

  int v[kQ][4];
  int x[kQ][4];
  load_block(pk + rowoff, n, b0, vec != 0, lane, v);
  if (warp < kWarps) {  // the last block's suffix feeds no one
    offsets_down(v, off, x);
    suffix_max_after(lane, x);
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      after[warp][q][lane] = make_int4(x[q][0], x[q][1], x[q][2], x[q][3]);
    }
  }
  if (warp > 0) {
    offsets_down(v, off, x);
    prefix_max(lane, x);
  }
  __syncthreads();
  if (warp == 0) return;

#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int4 a4 = after[warp - 1][q][lane];
    const int a[4] = {a4.x, a4.y, a4.z, a4.w};
    int res[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      // Back from the offsets: + (E - i) * C; M(i) <= max pk, no overflow.
      const int m = max(x[q][r], a[r]) + (off - (128 * q + r) * kLenUnit);
      res[r] = m >= 3 * kLenUnit ? m : v[q][r];
    }
    const int g = b0 + 128 * q + 4 * lane;
    int* dst = out + rowoff + g;
    if (vec && g + 4 <= n) {
      *reinterpret_cast<int4*>(dst) = make_int4(res[0], res[1], res[2], res[3]);
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (g + r < n) dst[r] = res[r];
      }
    }
  }
}

}  // namespace

extern "C" int zz_propagate_matches(const int* pk, int* out, int batch, int n,
                                    void* stream) {
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
  };
  const int vec = n % 4 == 0 && aligned(pk) && aligned(out);
  const dim3 grid((n + kTile - 1) / kTile, batch);
  propagate_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pk, out, n, vec);
  return static_cast<int>(cudaGetLastError());
}
