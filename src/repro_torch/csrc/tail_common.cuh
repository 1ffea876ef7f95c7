// Stages shared by the fused query tails (kernel D, query_fused.cu, and
// kernel E, query_payload.cu): load a query's candidate row into shared
// memory, merge its ascending runs, rank the first occurrences with a block
// scan and compact the first c_comp unique indices, plus the warp-per-row L1
// distance both tails use for their exact f32 distances. Keeping one copy
// is what makes E's exact top-k bit-identical to D's on the same rows.
#pragma once

#include "topk.cuh"

constexpr int QT_THREADS = 256;  // one block of 256 threads per query
constexpr int SENT = INT_MAX;    // sorts after any real index

__device__ __forceinline__ bool first_occurrence(const int* s, int i) {
  return s[i] != SENT && (i == 0 || s[i] != s[i - 1]);
}

// Exclusive prefix sum of v over the block in thread order; the block total
// is left in warp_sums[nwarps - 1]. Ends with __syncthreads().
__device__ inline int block_exclusive_scan(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int incl = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int s = lane < nw ? warp_sums[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s += t;
    }
    if (lane < nw) warp_sums[lane] = s;  // inclusive warp totals
  }
  __syncthreads();
  return (warp > 0 ? warp_sums[warp - 1] : 0) + incl - v;
}

// Sort s[0, n) ascending (n a power of two) given that every aligned block
// of start_width already ascends: merge ascending blocks of size/2 into
// ascending blocks of size by comparing each element with its mirror in the
// partner block, then half-cleaning with halving strides. From width 1 this
// is a full bitonic sort; from the run width it only merges the runs.
// Ends with __syncthreads().
template <class K>
__device__ void bitonic_merge_from(K* s, int n, int start_width) {
  const int half_n = n >> 1;
  for (int size = start_width << 1; size <= n; size <<= 1) {
    const int half = size >> 1;
    for (int i = threadIdx.x; i < half_n; i += blockDim.x) {
      const int blk = i / half;
      const int j = i - blk * half;
      const int a = blk * size + j;
      const int b = blk * size + size - 1 - j;
      const K va = s[a], vb = s[b];
      if (va > vb) { s[a] = vb; s[b] = va; }
    }
    __syncthreads();
    for (int stride = half >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < half_n; i += blockDim.x) {
        const int a = (i / stride) * 2 * stride + i % stride;
        const int b = a + stride;
        const K va = s[a], vb = s[b];
        if (va > vb) { s[a] = vb; s[b] = va; }
      }
      __syncthreads();
    }
  }
}

// Stages 3-4 for one query row of `C` candidates (-1 = masked) padded to
// Cp: sort the row into s[0, Cp) from its runs, write the first c_comp
// unique indices ascending to comp[0, min(total, c_comp)), and return
// total (the query's `comparisons`). Ends with __syncthreads().
__device__ inline int dedup_compact(const int* __restrict__ row, int C,
                                    int Cp, int start_width, int c_comp,
                                    int* s, int* comp, int* warp_sums) {
  for (int i = threadIdx.x; i < Cp; i += blockDim.x) {
    const int v = i < C ? row[i] : -1;
    s[i] = v < 0 ? SENT : v;
  }
  __syncthreads();
  bitonic_merge_from(s, Cp, start_width);

  // rank first occurrences: each thread owns a contiguous slice of the row
  const int per = (Cp + blockDim.x - 1) / blockDim.x;
  const int lo = min(static_cast<int>(threadIdx.x) * per, Cp);
  const int hi = min(lo + per, Cp);
  int local = 0;
  for (int i = lo; i < hi; ++i) local += first_occurrence(s, i);
  int rank = block_exclusive_scan(local, warp_sums);
  const int total = warp_sums[(blockDim.x >> 5) - 1];
  for (int i = lo; i < hi; ++i) {
    if (first_occurrence(s, i)) {
      if (rank < c_comp) comp[rank] = s[i];
      ++rank;
    }
  }
  __syncthreads();
  return total;
}

// L1 distance of data row x to query qv over d coordinates, computed by one
// warp: lane l sums coordinates l, l+32, ... and a butterfly adds the lanes.
// Every lane returns the same sum. Loads are coalesced across the lanes.
__device__ __forceinline__ float warp_l1_row(const float* __restrict__ x,
                                             const float* __restrict__ qv,
                                             int d) {
  const int lane = threadIdx.x & 31;
  float acc = 0.0f;
  for (int j = lane; j < d; j += 32) acc += fabsf(x[j] - qv[j]);
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}
