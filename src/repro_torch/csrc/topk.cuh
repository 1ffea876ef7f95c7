// Top-k smallest on (distance, position) keys, and the block-wide selection
// the tails build on.
//
// Shared by the l1_topk kernel (C) and the fused query tails (D and E).
// Order: smaller distance first, then lower position — the lowest-position
// tie rule of lax.top_k that the JAX package's Pallas kernels rely on.
//
// Two forms of the top-k: the warp form (warp_topk_keys) for k <= TOPK_MAX,
// lane lists in registers popped by a warp butterfly; and the block form
// (block_topk_sorted) for any k, a sort of 64-bit keys. warp_sort32 sorts
// 32 such keys in a warp's registers, and block_select picks the rank-th
// smallest 64-bit key without sorting (a radix select).
#pragma once

#include "common.cuh"

constexpr int TOPK_MAX = 32;  // largest k of the warp form

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
// n, k (k <= TOPK_MAX).
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

// ------------------------------------------------------ 64-bit keys

// Monotone map of a float's bits to uint32 (-0 < +0 aside): larger floats
// give larger keys, +inf the largest finite-or-infinite one.
__device__ __forceinline__ uint32_t ordered_bits(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

constexpr unsigned long long NO_KEY = ~0ull;  // sorts after every key

// (dist, pos) as one 64-bit key in key_less's order for distances >= +0
// (an L1 distance), NO_KEY for an infinite or NaN distance.
__device__ __forceinline__ unsigned long long topk_key(float d, int pos) {
  return d < INFINITY ? (static_cast<unsigned long long>(ordered_bits(d)) << 32) |
                            static_cast<uint32_t>(pos)
                      : NO_KEY;
}

__device__ __forceinline__ float key_dist(unsigned long long key) {
  if (key == NO_KEY) return INFINITY;
  const uint32_t u = static_cast<uint32_t>(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ int key_pos(unsigned long long key) {
  return key == NO_KEY ? -1 : static_cast<int>(key & 0xffffffffu);
}

// The 32 keys of a warp, one a lane, sorted ascending across the lanes (a
// bitonic network of 15 shuffle steps): lane r returns the r-th smallest.
__device__ __forceinline__ unsigned long long warp_sort32(unsigned long long key) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const unsigned long long other = __shfl_xor_sync(0xffffffffu, key, stride);
      const bool keep_min = ((lane & stride) == 0) == ((lane & size) == 0);
      key = keep_min ? min(key, other) : max(key, other);
    }
  }
  return key;
}

// Sort s[0, n) ascending in shared or device memory (n a power of two),
// given that every aligned block of start_width elements already ascends:
// merge ascending blocks of size/2 into ascending blocks of size by
// comparing each element with its mirror in the partner block, then
// half-cleaning with halving strides. From width 1 this is a full bitonic
// sort. One barrier per pass; ends with __syncthreads().
template <class K>
__device__ void bitonic_merge_from(K* s, int n, int start_width) {
  const int half_n = n >> 1;
  for (int size = start_width << 1; size <= n; size <<= 1) {
    const int lg = __ffs(size) - 2;  // log2(size / 2)
    for (int i = threadIdx.x; i < half_n; i += blockDim.x) {
      const int j = i & ((1 << lg) - 1);
      const int a = ((i >> lg) << (lg + 1)) + j;
      const int b = a ^ (size - 1);
      const K va = s[a], vb = s[b];
      if (va > vb) { s[a] = vb; s[b] = va; }
    }
    __syncthreads();
    for (int ls = lg - 1; ls >= 0; --ls) {
      for (int i = threadIdx.x; i < half_n; i += blockDim.x) {
        const int a = ((i >> ls) << (ls + 1)) + (i & ((1 << ls) - 1));
        const int b = a + (1 << ls);
        const K va = s[a], vb = s[b];
        if (va > vb) { s[a] = vb; s[b] = va; }
      }
      __syncthreads();
    }
  }
  __syncthreads();
}

__host__ __device__ __forceinline__ int next_pow2(int m) {
  int p = 1;
  while (p < m) p <<= 1;
  return p;
}

// The block form of the top-k, for any k: sort the m keys in keys[0, m)
// (topk_key; the buffer holds next_pow2(m), padded here with NO_KEY) and
// hand the first k to store(r, dist, pos) for r in [0, k), (inf, -1) past
// the last finite key. Every thread of the block calls it with the same m,
// k; keys may lie in shared or device memory. Ends with __syncthreads().
template <class Store>
__device__ void block_topk_sorted(unsigned long long* keys, int m, int k,
                                  Store store) {
  const int np2 = next_pow2(m);
  for (int i = m + threadIdx.x; i < np2; i += blockDim.x) keys[i] = NO_KEY;
  __syncthreads();
  bitonic_merge_from(keys, np2, 1);
  for (int r = threadIdx.x; r < k; r += blockDim.x) {
    const unsigned long long key = r < m ? keys[r] : NO_KEY;
    store(r, key_dist(key), key_pos(key));
  }
  __syncthreads();
}

// Shared memory of block_select.
struct SelectSmem {
  int hist[2][256];  // this pass's counts and the next pass's, zeroed early
  int sel[3], count[32], ncand;
  unsigned long long lo[32], hi[32], cand[32], found;
};

// The rank-th smallest (0 = the smallest) of the distinct 64-bit keys
// key(i, v) yields for i in [0, n) where it returns true; rank must be
// below their count. lo, hi and count are the calling thread's share of the
// keys' minimum, maximum and number (any split of them over the block's
// threads: the caller often has them from the pass that made the keys). A
// block-wide radix select: every key shares the bits above the highest bit
// where the smallest and the largest key differ, so the passes start there,
// 8 bits a pass, each counting the keys that carry the digits fixed so far
// in a 256-bin histogram from which warp 0 picks the bin that holds the
// rank. As soon as at most 32 keys carry the fixed digits (often before the
// first pass, or after it), warp 0 sorts them in registers and reads the
// rank off. Every thread of the block calls it; ends with __syncthreads().
template <class KeyFn>
__device__ unsigned long long block_select(KeyFn key, int n, int rank,
                                           SelectSmem& sm, unsigned long long lo,
                                           unsigned long long hi, int count) {
  using K = unsigned long long;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  count = __reduce_add_sync(0xffffffffu, count);
  if (lane == 0) {
    sm.lo[warp] = lo;
    sm.hi[warp] = hi;
    sm.count[warp] = count;
  }
  if (threadIdx.x == 0) sm.ncand = 0;
  for (int b = threadIdx.x; b < 256; b += blockDim.x) sm.hist[0][b] = 0;
  __syncthreads();
  {  // each warp folds the warps' partials itself: a load a lane
    const bool w_in = lane < static_cast<int>(blockDim.x >> 5);
    lo = w_in ? sm.lo[lane] : ~0ull;
    hi = w_in ? sm.hi[lane] : 0;
    count = __reduce_add_sync(0xffffffffu, w_in ? sm.count[lane] : 0);
    for (int off = 16; off > 0; off >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
  }
  K prefix = lo, fixed = ~0ull;
  if (lo != hi) {
    const int top = 63 - __clzll(static_cast<long long>(lo ^ hi));
    fixed = top == 63 ? 0 : ~0ull << (top + 1);
    prefix = lo & fixed;
    for (int shift = max(top - 7, 0), buf = 0; count > 32;
         shift = max(shift - 8, 0), buf ^= 1) {
      int* hist = sm.hist[buf];
      for (int base = 0; base < n; base += 4 * blockDim.x) {  // 4 keys' loads at once
        K v[4];
        bool in[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = base + u * blockDim.x + threadIdx.x;
          v[u] = 0;
          in[u] = i < n && key(i, v[u]) && (v[u] & fixed) == prefix;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (in[u]) atomicAdd(&hist[static_cast<int>((v[u] >> shift) & 255)], 1);
      }
      for (int b = threadIdx.x; b < 256; b += blockDim.x) sm.hist[buf ^ 1][b] = 0;
      __syncthreads();
      if (threadIdx.x < 32) {
        int c[8], s = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          c[j] = hist[lane * 8 + j];
          s += c[j];
        }
        int incl = s;
        for (int off = 1; off < 32; off <<= 1) {
          const int t = __shfl_up_sync(0xffffffffu, incl, off);
          if (lane >= off) incl += t;
        }
        if (rank >= incl - s && rank < incl) {
          int below = incl - s;
          bool done = false;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (!done && below + c[j] > rank) {
              sm.sel[0] = lane * 8 + j;
              sm.sel[1] = below;
              sm.sel[2] = c[j];
              done = true;
            }
            if (!done) below += c[j];
          }
        }
      }
      __syncthreads();
      rank -= sm.sel[1];
      count = sm.sel[2];
      prefix |= static_cast<K>(sm.sel[0]) << shift;  // bits already fixed agree
      fixed |= 255ull << shift;
      if (shift == 0) break;
    }
  }
  if (fixed != ~0ull) {  // at most 32 keys left under the fixed digits
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      K v = 0;
      if (key(i, v) && (v & fixed) == prefix) sm.cand[atomicAdd(&sm.ncand, 1)] = v;
    }
    __syncthreads();
    if (warp == 0) {
      const K v = warp_sort32(lane < sm.ncand ? sm.cand[lane] : ~0ull);
      if (lane == rank) sm.found = v;
    }
  } else if (threadIdx.x == 0) {
    sm.found = prefix;
  }
  __syncthreads();
  const K v = sm.found;
  __syncthreads();
  return v;
}
