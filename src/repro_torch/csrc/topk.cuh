// Warp-level top-k smallest on (distance, position) keys.
//
// Shared by the l1_topk kernel (one warp per query row) and the fused query
// tails (every warp of a query's block, then one warp over their lists).
// Order: smaller distance first, then lower position — the lowest-position
// tie rule of lax.top_k that the JAX package's Pallas kernels rely on.
#pragma once

#include "common.cuh"

constexpr int TOPK_MAX = 32;  // largest k a launch accepts

__device__ __forceinline__ bool key_less(float da, int pa, float db, int pb) {
  return da < db || (da == db && pa < pb);
}

// k smallest keys over candidates i in [0, n), written ascending to
// out_d/out_p[0..k); key(i, dv, pos) sets candidate i's distance and
// position (positions are distinct). Lane l scans i = l, l+32, ... keeping
// its own sorted list of at most k keys; then k rounds of a warp-wide
// butterfly argmin pop the lists in global order. Infinite (masked)
// distances never enter a list, so slots past the last finite candidate
// come out as (inf, -1). Every lane of the warp must call it with the same
// n, k.
template <class KeyFn>
__device__ void warp_topk_keys(KeyFn key, int n, int k, float* out_d,
                               int* out_p) {
  const int lane = threadIdx.x & 31;
  float ld[TOPK_MAX];
  int lp[TOPK_MAX];
  int cnt = 0;
  for (int i = lane; i < n; i += 32) {
    float dv;
    int pos;
    key(i, dv, pos);
    if (!(dv < INFINITY)) continue;
    if (cnt == k && !key_less(dv, pos, ld[k - 1], lp[k - 1])) continue;
    int j = cnt < k ? cnt++ : k - 1;
    while (j > 0 && key_less(dv, pos, ld[j - 1], lp[j - 1])) {
      ld[j] = ld[j - 1];
      lp[j] = lp[j - 1];
      --j;
    }
    ld[j] = dv;
    lp[j] = pos;
  }
  int head = 0;
  for (int r = 0; r < k; ++r) {
    float bd = head < cnt ? ld[head] : INFINITY;
    int bp = head < cnt ? lp[head] : INT_MAX;
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, bd, off);
      const int op = __shfl_xor_sync(0xffffffffu, bp, off);
      if (key_less(od, op, bd, bp)) {
        bd = od;
        bp = op;
      }
    }
    if (head < cnt && lp[head] == bp) ++head;
    if (lane == 0) {
      out_d[r] = bp == INT_MAX ? INFINITY : bd;
      out_p[r] = bp == INT_MAX ? -1 : bp;
    }
  }
}

// k smallest of dist(pos) over pos in [0, n): warp_topk_keys with each
// candidate's own index as its position.
template <class DistFn>
__device__ void warp_topk_smallest(DistFn dist, int n, int k, float* out_d,
                                   int* out_p) {
  warp_topk_keys(
      [&](int i, float& dv, int& pos) {
        dv = dist(i);
        pos = i;
      },
      n, k, out_d, out_p);
}
