// K-neighbour candidate scan over one sorted suffix order.
//
// Replaces: zzflate_tpu/ops/pallas_kernels.py scan_candidates (_scan_kernel),
// called from zzflate_tpu/ops/matcher.py _scan_order.
//
// For sorted element i and k = 1..K the LCP to i-k is the running min of
// adj over (i-k, i], capped at lcp_cap; the candidate distance
// spos[i] - spos[i-k] is accepted when 1 <= d <= 32768 and the source is
// at or after the row's window_start. The same runs forward (i+k) unless
// backward_only. The longest length wins, then the smallest distance.
// Neighbours outside [0, n) of their own row are rejected (the TPU kernel
// pads them with position -2^30, which fails the distance test).
//
// Bound on the H100: bytes. Each element reads adj and spos and writes two
// outputs (16 B); the K-loop is 2K compare-selects on shared memory. The
// design is a 1-D stencil: one block loads its tile plus a K-element halo
// on each side into shared memory once, and each thread scores one element
// from there, so global memory is read about once (halo overhead 2K/256).
#include <cuda_runtime.h>

#include "kernels.h"

namespace {

constexpr int kTile = 256;
constexpr int kWindow = 32768;
constexpr int kPadPos = -(1 << 30);

__device__ __forceinline__ void consider(int len_ok, int dist, bool ok,
                                         int& best_len, int& best_dist) {
  const int ln = ok ? len_ok : 0;
  const bool better =
      ok && (ln > best_len || (ln == best_len && ln > 0 && dist < best_dist));
  if (better) {
    best_len = ln;
    best_dist = dist;
  }
}

__global__ void scan_kernel(const int* __restrict__ adj,
                            const int* __restrict__ spos,
                            const int* __restrict__ wstart,
                            int* __restrict__ out_len,
                            int* __restrict__ out_dist, int n, int k_each,
                            int lcp_cap, int backward_only) {
  extern __shared__ int smem[];
  const int span = kTile + 2 * k_each;
  int* s_adj = smem;
  int* s_pos = smem + span;
  const long long row = static_cast<long long>(blockIdx.y) * n;
  const int tile0 = blockIdx.x * kTile;
  for (int t = threadIdx.x; t < span; t += blockDim.x) {
    const int g = tile0 - k_each + t;
    const bool in = g >= 0 && g < n;
    s_adj[t] = in ? adj[row + g] : 0;
    s_pos[t] = in ? spos[row + g] : kPadPos;
  }
  __syncthreads();

  const int i = tile0 + threadIdx.x;
  if (i >= n) return;
  const int li = threadIdx.x + k_each;
  const int p0 = s_pos[li];
  const int ws = wstart[blockIdx.y];
  int best_len = 0;
  int best_dist = 0;
  int back_min = lcp_cap;
  int fwd_min = lcp_cap;
  for (int k = 1; k <= k_each; ++k) {
    back_min = min(back_min, s_adj[li - k + 1]);
    int cpos = s_pos[li - k];
    int dist = p0 - cpos;
    consider(back_min, dist, dist >= 1 && dist <= kWindow && cpos >= ws,
             best_len, best_dist);
    if (backward_only) continue;
    fwd_min = min(fwd_min, s_adj[li + k]);
    cpos = s_pos[li + k];
    dist = p0 - cpos;
    consider(fwd_min, dist, dist >= 1 && dist <= kWindow && cpos >= ws,
             best_len, best_dist);
  }
  out_len[row + i] = best_len;
  out_dist[row + i] = best_dist;
}

}  // namespace

extern "C" int zz_scan_candidates(const int* adj, const int* spos,
                                  const int* wstart, int* out_len,
                                  int* out_dist, int batch, int n, int k_each,
                                  int lcp_cap, int backward_only,
                                  void* stream) {
  const dim3 grid((n + kTile - 1) / kTile, batch);
  const size_t shm = 2 * (kTile + 2 * k_each) * sizeof(int);
  scan_kernel<<<grid, kTile, shm, static_cast<cudaStream_t>(stream)>>>(
      adj, spos, wstart, out_len, out_dist, n, k_each, lcp_cap,
      backward_only);
  return static_cast<int>(cudaGetLastError());
}
