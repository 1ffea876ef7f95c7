// Stages shared by the fused query tails (kernel D, query_fused.cu, and
// kernel E, query_payload.cu) and by kernel C (l1_topk.cu): stages 3-4 in
// two forms, D's (merge a query's candidate runs in registers, rank the
// first occurrences with a block scan and compact the first c_comp unique
// indices) and E's (a hash set whose cost follows the row's live entries),
// plus the one L1 order every exact f32 distance of C, D and E takes.
// Keeping one copy of it is what makes E's exact top-k and C's distances
// bit-identical to D's on the same rows.
#pragma once

#include <type_traits>

#include "topk.cuh"

constexpr int QT_THREADS = 256;  // threads of a query's block
constexpr int QT_WARPS = QT_THREADS / 32;
constexpr int QT_NARROW_D = 32;  // rows this narrow: one thread per row
constexpr int SENT = INT_MAX;    // sorts after any real index

// Calls launch(std::integral_constant<int, E>{}) with E, the registers a
// thread holds of a merge of width Cp (a power of two, at most 64 *
// QT_THREADS), and returns what it returns: how kernel D picks the
// instance of its kernel templated on E.
template <class Launch>
static int with_merge_regs(int Cp, Launch&& launch) {
  switch (Cp <= QT_THREADS ? 1 : Cp / QT_THREADS) {
    case 1: return launch(std::integral_constant<int, 1>{});
    case 2: return launch(std::integral_constant<int, 2>{});
    case 4: return launch(std::integral_constant<int, 4>{});
    case 8: return launch(std::integral_constant<int, 8>{});
    case 16: return launch(std::integral_constant<int, 16>{});
    case 32: return launch(std::integral_constant<int, 32>{});
    default: return launch(std::integral_constant<int, 64>{});
  }
}

// ------------------------------------------------------------ the merge
//
// A block holds a row of Cp <= QT_THREADS * E candidates in registers,
// E contiguous elements per thread (element e = thread * E + register), so
// a warp spans 32 * E elements. A compare-exchange at a distance below E
// stays in a thread's registers, one below 32 * E is a __shfl_xor_sync,
// and only the wider ones go through shared memory with one barrier each
// (two buffers in turn, so a step's writes never meet the previous step's
// reads). From run width 16 to Cp = 1,024 (E = 4) that is 6 barriers.

template <int E>
__device__ __forceinline__ void cmp_swap_regs(int (&v)[E], int a, int b) {
  const int lo = min(v[a], v[b]);
  v[b] = max(v[a], v[b]);
  v[a] = lo;
}

// w[r] = the partner thread's v[src(r)], the partner being this thread with
// its index xor'ed by tmask: a shuffle inside a warp, shared memory across
// warps (xbuf: 2 * QT_THREADS * E ints, *cur the buffer to use next).
template <int E, class Src>
__device__ __forceinline__ void exchange(const int (&v)[E], int (&w)[E],
                                         int tmask, bool in_warp, int* xbuf,
                                         int* cur, Src src) {
  if (in_warp) {
#pragma unroll
    for (int r = 0; r < E; ++r) w[r] = __shfl_xor_sync(0xffffffffu, v[src(r)], tmask);
    return;
  }
  int* buf = xbuf + *cur * QT_THREADS * E;
  const int t = threadIdx.x;
#pragma unroll
  for (int r = 0; r < E; ++r) buf[r * QT_THREADS + t] = v[r];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < E; ++r) w[r] = buf[src(r) * QT_THREADS + (t ^ tmask)];
  *cur ^= 1;
}

// Sort the block's row ascending given that every aligned block of
// start_width elements already ascends (Cp, start_width powers of two):
// merge ascending blocks of size/2 into ascending blocks of size by
// comparing each element with its mirror in the partner block, then
// half-cleaning with halving strides. From width 1 this is a full bitonic
// sort; from the run width it only merges the runs. Elements past Cp hold
// SENT and never meet one below it.
template <int E>
__device__ void bitonic_merge_regs(int (&v)[E], int Cp, int start_width,
                                   int* xbuf) {
  constexpr int WSPAN = 32 * E;  // elements a warp holds
  const int t = threadIdx.x;
  int cur = 0;
  int w[E];
  for (int size = start_width << 1; size <= Cp; size <<= 1) {
    if (size <= E) {  // mirror inside a thread
#pragma unroll
      for (int sz = 2; sz <= E; sz <<= 1) {
        if (sz == size) {
#pragma unroll
          for (int r = 0; r < E; ++r)
            if (r < (r ^ (sz - 1))) cmp_swap_regs(v, r, r ^ (sz - 1));
        }
      }
    } else {  // element t*E + r meets (t ^ (size/E - 1))*E + E-1-r
      exchange(v, w, size / E - 1, size <= WSPAN, xbuf, &cur,
               [](int r) { return E - 1 - r; });
      const bool lower = (t & (size / (2 * E))) == 0;
#pragma unroll
      for (int r = 0; r < E; ++r) v[r] = lower ? min(v[r], w[r]) : max(v[r], w[r]);
    }
    for (int st = size >> 2; st >= E; st >>= 1) {  // across threads
      exchange(v, w, st / E, st < WSPAN, xbuf, &cur, [](int r) { return r; });
      const bool lower = (t & (st / E)) == 0;
#pragma unroll
      for (int r = 0; r < E; ++r) v[r] = lower ? min(v[r], w[r]) : max(v[r], w[r]);
    }
#pragma unroll
    for (int s = E >> 1; s > 0; s >>= 1) {  // inside a thread
      if (s <= (size >> 2)) {
#pragma unroll
        for (int r = 0; r < E; ++r)
          if (r < (r ^ s)) cmp_swap_regs(v, r, r ^ s);
      }
    }
  }
}

// Exclusive prefix sum of v over a block of NWARPS warps in thread order;
// the block total is left in warp_sums[NWARPS - 1]. Ends with
// __syncthreads().
template <int NWARPS = QT_WARPS>
__device__ inline int block_exclusive_scan(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int s = lane < NWARPS ? warp_sums[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s += t;
    }
    if (lane < NWARPS) warp_sums[lane] = s;  // inclusive warp totals
  }
  __syncthreads();
  return (warp > 0 ? warp_sums[warp - 1] : 0) + incl - v;
}

// Stages 3-4 for one query row of `C` candidates (-1 = masked; columns
// C..Cp-1 count as -1): sort the row from its runs in registers, write the
// first c_comp unique indices ascending to comp[0, min(total, c_comp)), and
// return total (the query's `comparisons`). xbuf holds 2 * QT_THREADS * E
// ints; warp_sums and warp_last 32 each. Ends with __syncthreads().
template <int E>
__device__ int dedup_compact(const int* __restrict__ row, int C, int Cp,
                             int start_width, int c_comp, int* xbuf,
                             int* comp, int* warp_sums, int* warp_last) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  int v[E];
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int e = t * E + r;
    const int x = e < C ? row[e] : -1;
    v[r] = x < 0 ? SENT : x;
  }
  bitonic_merge_regs(v, Cp, start_width, xbuf);

  // first occurrences, ranked in element order
  int prev = __shfl_up_sync(0xffffffffu, v[E - 1], 1);
  if (lane == 31) warp_last[warp] = v[E - 1];
  __syncthreads();
  if (lane == 0) prev = warp > 0 ? warp_last[warp - 1] : -1;
  int local = 0;
#pragma unroll
  for (int r = 0; r < E; ++r)
    local += v[r] != SENT && v[r] != (r > 0 ? v[r - 1] : prev);
  int rank = block_exclusive_scan(local, warp_sums);
  const int total = warp_sums[QT_WARPS - 1];
#pragma unroll
  for (int r = 0; r < E; ++r) {
    if (v[r] != SENT && v[r] != (r > 0 ? v[r - 1] : prev)) {
      if (rank < c_comp) comp[rank] = v[r];
      ++rank;
    }
  }
  __syncthreads();
  return total;
}

// ------------------------------------------------------ the hash-set dedup
//
// Stages 3-4 at a cost that follows the row's live entries rather than its
// width (kernel E's; kernel D keeps dedup_compact): count the row's
// non-negative entries, insert them into an open-addressing hash set of
// next_pow2(4 * live) slots (at least THREADS, at most h_cap >= 2 * C:
// load at most 1/4, or 1/2 for a row of nearly C live entries) by
// hash_insert_block, -1 skipped, and compact the set's entries with a
// block scan. When more than c_comp indices are unique, a bisection over
// the row's index range finds the c_comp-th smallest, and only indices up
// to it are kept, so comp holds the c_comp smallest unique indices, as the
// sorted form keeps them. comp[0, min(total, c_comp)) is in slot order, not
// ascending: every later tie is broken by the index itself. table: h_cap
// ints; warp_sums 32 ints of shared memory. Returns total (the query's
// `comparisons`); ends with __syncthreads().

__device__ __forceinline__ uint32_t hash_index(uint32_t x) {  // murmur3's finalizer
  x ^= x >> 16;
  x *= 0x85ebca6bu;
  x ^= x >> 13;
  x *= 0xc2b2ae35u;
  return x ^ (x >> 16);
}

// Insert every thread's entries v[r] >= 0 into the set, without atomics,
// in rounds of linear probing: an entry whose slot reads empty writes
// itself there, and after a barrier reads the slot back; an entry that
// finds another index moves to the next slot for the next round. Copies of
// one index probe the same slots in the same rounds, so each index lands in
// exactly one slot, and a slot once set is never written again. Every
// thread of the block calls it.
template <int R>
__device__ void hash_insert_block(int* table, uint32_t mask, const int (&v)[R]) {
  uint32_t slot[R];
  bool pending[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    pending[r] = v[r] >= 0;
    slot[r] = hash_index(static_cast<uint32_t>(v[r])) & mask;
  }
  for (;;) {
    int cur[R];
#pragma unroll
    for (int r = 0; r < R; ++r) cur[r] = pending[r] ? table[slot[r]] : 0;
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (pending[r] && cur[r] == -1) table[slot[r]] = v[r];
    __syncthreads();
    bool again = false;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (pending[r]) {
        pending[r] = table[slot[r]] != v[r];
        slot[r] = pending[r] ? (slot[r] + 1) & mask : slot[r];
        again |= pending[r];
      }
    }
    if (!__syncthreads_or(again)) break;
  }
}

template <int THREADS>
__device__ inline int dedup_hash_compact(const int* row, int C,
                                         int c_comp, int h_cap, int* table,
                                         int* comp, int* warp_sums) {
  // the row in passes of DEDUP_REGS entries a thread, all loads of a pass in
  // flight together (a row of up to 4,096 is loaded once and kept in
  // registers: `row` is not __restrict__, so the loads are not repeated
  // after the barriers)
  constexpr int NWARPS = THREADS / 32;
  constexpr int DEDUP_REGS = 4096 / THREADS;  // row entries a thread loads at once
  constexpr int DEDUP_SLOTS = 8192 / THREADS;  // set slots a thread holds in registers
  constexpr int PASS = THREADS * DEDUP_REGS;
  int v[DEDUP_REGS];
  auto load = [&](int base) {
#pragma unroll
    for (int r = 0; r < DEDUP_REGS; ++r) {
      const int e = base + r * THREADS + static_cast<int>(threadIdx.x);
      v[r] = e < C ? row[e] : -1;
    }
  };
  int live = 0, lo = INT_MAX, hi = -1;  // the thread's live entries and their bounds
  for (int base = 0; base < C; base += PASS) {
    load(base);
#pragma unroll
    for (int r = 0; r < DEDUP_REGS; ++r) {
      live += v[r] >= 0;
      if (v[r] >= 0) {
        lo = min(lo, v[r]);
        hi = max(hi, v[r]);
      }
    }
  }
  block_exclusive_scan<NWARPS>(live, warp_sums);
  const int h = min(h_cap, max(THREADS, next_pow2(4 * warp_sums[NWARPS - 1])));
  for (int s = threadIdx.x; s < h / 4; s += THREADS)  // table is 16-byte aligned
    reinterpret_cast<int4*>(table)[s] = make_int4(-1, -1, -1, -1);
  __syncthreads();
  for (int base = 0; base < C; base += PASS) {
    if (C > PASS) load(base);
    hash_insert_block(table, static_cast<uint32_t>(h - 1), v);
  }
  // the set's entries, thread t taking slots t + THREADS * j: in
  // registers for a set of at most THREADS * DEDUP_SLOTS slots
  const int per = h / THREADS;
  const bool in_regs = per <= DEDUP_SLOTS;
  int sv[DEDUP_SLOTS];
#pragma unroll
  for (int j = 0; j < DEDUP_SLOTS; ++j)
    sv[j] = in_regs && j < per ? table[threadIdx.x + THREADS * j] : -1;
  auto count_upto = [&](int t) {  // this thread's entries up to index t >= 0
    int c = 0;                     // (an empty slot's -1 is above t unsigned)
    if (in_regs) {
#pragma unroll
      for (int j = 0; j < DEDUP_SLOTS; ++j) c += static_cast<unsigned>(sv[j]) <= static_cast<unsigned>(t);
    } else {
      for (int j = 0; j < per; ++j)
        c += static_cast<unsigned>(table[threadIdx.x + THREADS * j]) <= static_cast<unsigned>(t);
    }
    return c;
  };
  int off = block_exclusive_scan<NWARPS>(count_upto(INT_MAX), warp_sums);
  const int total = warp_sums[NWARPS - 1];
  int limit = INT_MAX;  // keep the indices up to this one
  if (total > c_comp) {
    // the c_comp-th smallest index, by narrowing the row's [lo, hi] with
    // histograms of at most SEL_BINS bins of 2^sh indices (shared atomics):
    // each level keeps the bin that holds the rank, SEL_BINS times narrower,
    // so an index range of up to 2^20 takes two levels and any range at
    // most three.
    constexpr int SEL_BINS = 1024;
    constexpr int PER = SEL_BINS / THREADS;  // bins a thread scans
    __shared__ int hist[SEL_BINS];
    __shared__ int red[2 * NWARPS + 2];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if (lane == 0) {
      red[warp] = lo;
      red[NWARPS + warp] = hi;
    }
    for (int b = threadIdx.x; b < SEL_BINS; b += THREADS) hist[b] = 0;
    __syncthreads();
    lo = __reduce_min_sync(0xffffffffu, lane < NWARPS ? red[lane] : INT_MAX);
    hi = __reduce_max_sync(0xffffffffu, lane < NWARPS ? red[NWARPS + lane] : -1);
    int rank = c_comp - 1;  // of the wanted index among those in [lo, hi]
    while (lo < hi) {
      // bins of 2^sh indices: the fewest bits that leave at most SEL_BINS
      int sh = 0;
      while (((hi - lo) >> sh) >= SEL_BINS) ++sh;
      auto add = [&](int x) {
        if (x >= lo && x <= hi) atomicAdd(&hist[(x - lo) >> sh], 1);
      };
      if (in_regs) {
#pragma unroll
        for (int j = 0; j < DEDUP_SLOTS; ++j) add(sv[j]);
      } else {
        for (int j = 0; j < per; ++j) add(table[threadIdx.x + THREADS * j]);
      }
      __syncthreads();
      int c[PER > 0 ? PER : 1], mine = 0;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        c[i] = hist[threadIdx.x * PER + i];
        mine += c[i];
      }
      int below = block_exclusive_scan<NWARPS>(mine, warp_sums);
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        if (rank >= below && rank < below + c[i]) {
          red[2 * NWARPS] = threadIdx.x * PER + i;
          red[2 * NWARPS + 1] = below;
        }
        below += c[i];
      }
#pragma unroll
      for (int i = 0; i < PER; ++i) hist[threadIdx.x * PER + i] = 0;  // for the next level
      __syncthreads();
      const int bstar = red[2 * NWARPS];
      rank -= red[2 * NWARPS + 1];
      lo += bstar << sh;
      hi = min(hi, lo + (1 << sh) - 1);
      __syncthreads();  // red is read before the next level writes it
    }
    limit = lo;
    off = block_exclusive_scan<NWARPS>(count_upto(limit), warp_sums);
  }
  if (in_regs) {
#pragma unroll
    for (int j = 0; j < DEDUP_SLOTS; ++j)
      if (sv[j] >= 0 && sv[j] <= limit) comp[off++] = sv[j];
  } else {
    for (int j = 0; j < per; ++j) {
      const int x = table[threadIdx.x + THREADS * j];
      if (x >= 0 && x <= limit) comp[off++] = x;
    }
  }
  __syncthreads();
  return total;
}

// ------------------------------------------------------------ the L1 order
//
// Both tails' exact L1 distance, the same bits on every path: lane class l
// (0..31) sums |x_j - q_j| over j = l, l+32, ... in ascending order from 0,
// and the 32 class sums fold by the butterfly a_l = a_l + a_(l^16), then
// ^8, ^4, ^2, ^1 (a float add is commutative, so a lane and its partner
// agree); the distance is a_0. l1_warp computes it with one warp per row
// (lane l is class l: loads coalesced, any d); l1_thread with one thread
// per row of d <= 32 coordinates (class l holds coordinate l alone),
// replaying the butterfly in registers.

template <class X>
__device__ __forceinline__ float l1_warp(const X* __restrict__ x,
                                         const float* __restrict__ q, int d) {
  const int lane = threadIdx.x & 31;
  float acc = 0.0f;
#pragma unroll 8
  for (int j = lane; j < d; j += 32)
    acc = __fadd_rn(acc, fabsf(__fsub_rn(x[j], q[j])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  return acc;
}

// The class sums of a row of d <= 32 coordinates, loaded V floats at a
// time (V divides d, and the row is 4V-byte aligned): a[l] = |x_l - q_l|
// (0 + y is y), 0 past d.
template <int V>
__device__ __forceinline__ void l1_load32(const float* __restrict__ x,
                                          const float* __restrict__ q, int d,
                                          float (&a)[32]) {
#pragma unroll
  for (int j = 0; j < 32; j += V) {
    if (j < d) {
      if constexpr (V == 4) {
        const float4 v = *reinterpret_cast<const float4*>(x + j);
        a[j] = fabsf(__fsub_rn(v.x, q[j]));
        a[j + 1] = fabsf(__fsub_rn(v.y, q[j + 1]));
        a[j + 2] = fabsf(__fsub_rn(v.z, q[j + 2]));
        a[j + 3] = fabsf(__fsub_rn(v.w, q[j + 3]));
      } else if constexpr (V == 2) {
        const float2 v = *reinterpret_cast<const float2*>(x + j);
        a[j] = fabsf(__fsub_rn(v.x, q[j]));
        a[j + 1] = fabsf(__fsub_rn(v.y, q[j + 1]));
      } else {
        a[j] = fabsf(__fsub_rn(x[j], q[j]));
      }
    } else {
#pragma unroll
      for (int m = 0; m < V; ++m) a[j + m] = 0.0f;
    }
  }
}

__device__ __forceinline__ float l1_fold32(float (&a)[32]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int l = 0; l < off; ++l) a[l] = __fadd_rn(a[l], a[l + off]);
  return a[0];
}

// l1_warp over R rows at once, their loads in flight together: out[r] gets
// l1_warp(x[r], q, d)'s bits.
template <int R>
__device__ __forceinline__ void l1_warp_rows(const float* const (&x)[R],
                                             const float* __restrict__ q, int d,
                                             float (&out)[R]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < R; ++r) out[r] = 0.0f;
  for (int j = lane; j < d; j += 32) {
    const float qj = q[j];
    float xv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) xv[r] = x[r][j];
#pragma unroll
    for (int r = 0; r < R; ++r) out[r] = __fadd_rn(out[r], fabsf(__fsub_rn(xv[r], qj)));
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      out[r] = __fadd_rn(out[r], __shfl_xor_sync(0xffffffffu, out[r], off));
}

// Widest row load (4, 2 or 1 floats) that d and the base address allow.
inline int row_vec(const float* data, int d) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(data);
  if (d % 4 == 0 && p % 16 == 0) return 4;
  if (d % 2 == 0 && p % 8 == 0) return 2;
  return 1;
}

// Exact distances of the rows i in [i0, i1), one thread per row (d <=
// QT_NARROW_D), two rows per thread at a time so both rows' loads are in
// flight together; row_of(i) is the row's data index (< 0 skips it) and
// store(i, dist) takes the result.
template <int V, class RowOf, class Store>
__device__ void l1_thread_rows(const float* __restrict__ data, int d,
                               const float* __restrict__ q, int i0, int i1,
                               RowOf row_of, Store store) {
  for (int i = i0 + threadIdx.x; i < i1; i += 2 * blockDim.x) {
    const int i2 = i + blockDim.x;
    const int ra = row_of(i);
    const int rb = i2 < i1 ? row_of(i2) : -1;
    float a[32], b[32];
    l1_load32<V>(data + static_cast<size_t>(max(ra, 0)) * d, q, d, a);
    l1_load32<V>(data + static_cast<size_t>(max(rb, 0)) * d, q, d, b);
    if (ra >= 0) store(i, l1_fold32(a));
    if (rb >= 0) store(i2, l1_fold32(b));
  }
}

template <class RowOf, class Store>
__device__ void l1_thread_rows(int vec, const float* __restrict__ data, int d,
                               const float* __restrict__ q, int i0, int i1,
                               RowOf row_of, Store store) {
  if (vec == 4) l1_thread_rows<4>(data, d, q, i0, i1, row_of, store);
  else if (vec == 2) l1_thread_rows<2>(data, d, q, i0, i1, row_of, store);
  else l1_thread_rows<1>(data, d, q, i0, i1, row_of, store);
}
