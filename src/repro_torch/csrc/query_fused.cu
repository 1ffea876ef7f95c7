// The fused query tail (kernel D of the port): dedup -> compact -> gather ->
// L1 -> top-k in one launch.
//
// Replaces the JAX package's repro/kernels/query_fused/query_fused.py:
// query_tail_pallas (_tail_kernel_dma / _tail_kernel_interpret, helpers
// merge_sorted_runs, _prefix_sum, _dedup_compact, _finish_topk). Per query:
// merge the candidate row's ascending runs into one sorted row, flag the
// first occurrence of each valid index (their count is `comparisons`),
// compact the first c_comp unique indices in ascending order, gather their
// data rows, take L1 to the query and keep the k nearest (ties to the lowest
// compacted position, i.e. the lowest global index); overflow =
// max(comparisons - c_comp, 0).
//
// What bounds it on an H100: the row gather — each surviving candidate's d
// floats are read once at a data-dependent address (the paper's "linear
// search over the candidates"), so the time is HBM round trips unless many
// rows are in flight at once; the merge and scan are on-chip work on a few
// KB per query.
//
// Design. A query belongs to a thread-block cluster of `cs` blocks (1 for
// narrow rows or many queries; up to 8 when few queries of wide rows would
// leave SMs idle, as the kNN-LM hook's single query at d = 4,096 does).
// Every block of the cluster loads the query's candidate row (C ints; the
// columns past C count as -1, so the caller pads nothing) straight into
// registers and merges its runs there (tail_common.cuh: shuffles inside a
// warp, shared memory with one barrier per step across warps), ranks the
// first occurrences with a block scan and compacts them in shared memory;
// block b of the cluster then takes the b-th contiguous share of the
// compacted rows. Rows of d <= 32 are gathered one per thread, two at a
// time with vector loads (a 50-query chunk at d = 30 keeps 512 rows' loads
// in flight per block); wider rows one per warp, each copied whole into
// the warp's slot of shared memory with 16-byte cp.async (all of a 16 KB
// row in flight at once, no registers held) where d % 4 == 0 and it fits,
// else read with coalesced loads. Every path computes the L1 in one order
// (tail_common.cuh), so a query gets the same bits alone or in a chunk, on
// any cluster size, and kernel E's exact rerank gets D's. Each warp keeps
// lane lists of its share's k nearest, one warp merges the block's lists,
// and block 0 merges the cluster's block lists through distributed shared
// memory; for k > 32 (one block a query) the block sorts 64-bit (distance,
// position) keys instead (topk.cuh's block form). Candidate vectors touch
// device memory once and no (Q, c_comp, d) block is written.
//
// The hash form. A row that one block cannot hold — a merge width past
// 64 * QT_THREADS registers, or shared memory past its budget (c_comp=0 at
// 16,384 columns) — goes to this file's second kernel,
// query_tail_hash_kernel, in one launch all the same: stages 3-4 as kernel
// E's hash-set dedup
// (tail_common.cuh's dedup_hash_compact, whose cost follows the row's live
// entries and which has no width ceiling), its set, the compacted indices,
// their distances and the query in shared memory or, past the budget, in a
// per-query slice of a device scratch the wrapper allocates; then the same
// L1 order and top-k. Its compacted set is not in index order, so the
// top-k keys carry the index itself (ties to the lowest index, as the
// reference's ascending positions give).
#include <cooperative_groups.h>

#include "tail_common.cuh"

namespace cg = cooperative_groups;

constexpr int QT_CLUSTER_MAX = 8;

struct TailArgs {
  const float* data;     // (n, d)
  const float* queries;  // (Q, d)
  const int* cand;       // (Q, C)
  int n, d, C, Cp, start_width, c_comp, k;
  int vec;               // row load width of the narrow path
  bool stage;            // wide path: rows through shared memory by cp.async
  float* kd;
  int* ki;
  int* comparisons;
  int* overflow;
};

// Dynamic shared memory of one block: the wide path's row slots, the
// query (an even number of floats, so the exchange buffers after it are
// 8-byte aligned for the k > TOPK_MAX sort's keys), the merge's exchange
// buffers, comp and dist (the wrapper's tail_smem_bytes computes the same).
static size_t tail_smem_bytes(int d, int Cp, int c_comp, bool stage) {
  const size_t e = static_cast<size_t>(Cp > QT_THREADS ? Cp : QT_THREADS);
  return ((stage ? static_cast<size_t>(QT_WARPS) * d : 0) + d + (d & 1) + 2 * e +
          2 * static_cast<size_t>(c_comp)) * 4;
}

template <int E, bool SORT_K>  // SORT_K: k > TOPK_MAX, one block a query
__global__ void __launch_bounds__(QT_THREADS) query_tail_kernel(const TailArgs a) {
  extern __shared__ __align__(16) float qt_smem[];
  __shared__ int warp_sums[32];
  __shared__ int warp_last[32];
  __shared__ float wl_d[QT_WARPS * TOPK_MAX];  // each warp's k nearest
  __shared__ int wl_p[QT_WARPS * TOPK_MAX];
  __shared__ float bl_d[TOPK_MAX];  // the block's k nearest
  __shared__ int bl_p[TOPK_MAX];

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int qi = blockIdx.x / cs;
  const int d = a.d;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* slots = qt_smem;                        // QT_WARPS rows of d (stage)
  float* qs = slots + (a.stage ? QT_WARPS * d : 0);  // the query
  int* xbuf = reinterpret_cast<int*>(qs + d + (d & 1));  // 2 * QT_THREADS * E
  int* comp = xbuf + 2 * QT_THREADS * E;         // c_comp unique indices
  float* dist = reinterpret_cast<float*>(comp + a.c_comp);  // their L1

  const float* qv = a.queries + static_cast<size_t>(qi) * d;
  for (int j = threadIdx.x; j < d; j += QT_THREADS) qs[j] = qv[j];
  const int total = dedup_compact<E>(a.cand + static_cast<size_t>(qi) * a.C, a.C, a.Cp,
                                     a.start_width, a.c_comp, xbuf, comp, warp_sums,
                                     warp_last);
  const int nc = min(total, a.c_comp);
  const int share = (nc + cs - 1) / cs;
  const int lo = min(rank * share, nc);
  const int hi = min(lo + share, nc);
  const int n1 = a.n - 1;

  if (d <= QT_NARROW_D) {
    l1_thread_rows(
        a.vec, a.data, d, qs, lo, hi, [&](int r) { return min(max(comp[r], 0), n1); },
        [&](int r, float v) { dist[r] = v; });
  } else if (a.stage) {
    float* slot = slots + warp * d;
    for (int r = lo + warp; r < hi; r += QT_WARPS) {
      const float* src = a.data + static_cast<size_t>(min(max(comp[r], 0), n1)) * d;
      for (int c = lane; c < (d >> 2); c += 32) cp_async16(smem_addr(slot + 4 * c), src + 4 * c, 16);
      cp_async_commit();
      cp_async_wait<0>();
      __syncwarp();
      const float v = l1_warp(slot, qs, d);
      if (lane == 0) dist[r] = v;
      __syncwarp();  // the slot is read before the next row lands in it
    }
  } else {
    for (int r = lo + warp; r < hi; r += QT_WARPS) {
      const float v = l1_warp(a.data + static_cast<size_t>(min(max(comp[r], 0), n1)) * d, qs, d);
      if (lane == 0) dist[r] = v;
    }
  }
  __syncthreads();

  const int k = a.k;
  if constexpr (SORT_K) {  // sort (dist, position) keys in the merge's
    // exchange buffers, free now and at least Cp >= next_pow2(nc) keys wide
    unsigned long long* keys = reinterpret_cast<unsigned long long*>(xbuf);
    for (int r = threadIdx.x; r < nc; r += QT_THREADS) keys[r] = topk_key(dist[r], r);
    const size_t o = static_cast<size_t>(qi) * k;
    block_topk_sorted(keys, nc, k, [&](int r, float dv, int pos) {
      a.kd[o + r] = dv;
      a.ki[o + r] = pos >= 0 ? comp[pos] : -1;
    });
    if (threadIdx.x == 0) {
      a.comparisons[qi] = total;
      a.overflow[qi] = max(total - a.c_comp, 0);
    }
    return;
  }

  // the block's k nearest: warp w takes positions lo + 32w + lane + 256i
  const int span = ((hi - lo + QT_THREADS - 1) / QT_THREADS) * 32;
  warp_topk_keys(
      [&](int i, float& dv, int& pos) {
        pos = lo + 32 * warp + (i & 31) + (i >> 5) * QT_THREADS;
        dv = pos < hi ? dist[pos] : INFINITY;
      },
      span, k, wl_d + warp * k, wl_p + warp * k);
  __syncthreads();
  if (warp == 0) {
    warp_topk_keys(
        [&](int i, float& dv, int& pos) {
          dv = wl_d[i];
          pos = wl_p[i];
        },
        QT_WARPS * k, k, bl_d, bl_p);
  }
  float* top_d = bl_d;
  int* top_p = bl_p;
  if (cs > 1) {
    cluster.sync();  // every block's list is in place
    if (rank == 0 && warp == 0) {
      warp_topk_keys(
          [&](int i, float& dv, int& pos) {
            const int q = i / k;
            dv = cluster.map_shared_rank(&bl_d[0], q)[i - q * k];
            pos = cluster.map_shared_rank(&bl_p[0], q)[i - q * k];
          },
          cs * k, k, wl_d, wl_p);
    }
    top_d = wl_d;
    top_p = wl_p;
    cluster.sync();  // block 0 has read the other blocks' lists
  }
  if (rank == 0 && warp == 0) {
    __syncwarp();
    const size_t o = static_cast<size_t>(qi) * k;
    for (int r = lane; r < k; r += 32) {
      a.kd[o + r] = top_d[r];
      a.ki[o + r] = top_p[r] >= 0 ? comp[top_p[r]] : -1;
    }
    if (lane == 0) {
      a.comparisons[qi] = total;
      a.overflow[qi] = max(total - a.c_comp, 0);
    }
  }
}

template <int E, bool SORT_K>
static int launch(const TailArgs& a, int Q, int cs, cudaStream_t stream) {
  const size_t smem = tail_smem_bytes(a.d, a.Cp, a.c_comp, a.stage);
  int err = allow_dynamic_smem(query_tail_kernel<E, SORT_K>, smem);
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Q * cs);
  cfg.blockDim = dim3(QT_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, query_tail_kernel<E, SORT_K>, a));
}

// Cp is the merge width (a power of two, C <= Cp <= 16,384), start_width the
// run width the merge starts from, cluster the blocks per query (1, 2, 4 or
// 8; 1 when k > TOPK_MAX) and stage whether wide rows go through shared
// memory (d % 4 == 0 and a 16-byte aligned data pointer). Returns the CUDA
// error code.
extern "C" int query_tail_launch(const float* data, const float* queries,
                                 const int* cand, int n, int d, int Q, int C,
                                 int Cp, int start_width, int c_comp, int k,
                                 int cluster, int stage, float* kd, int* ki,
                                 int* comparisons, int* overflow,
                                 void* stream) {
  if (Q > 0) {
    const bool ok = C >= 1 && C <= Cp && (Cp & (Cp - 1)) == 0 && Cp <= 64 * QT_THREADS &&
                    cluster >= 1 && cluster <= QT_CLUSTER_MAX && (cluster & (cluster - 1)) == 0 &&
                    k >= 1 && (k <= TOPK_MAX || cluster == 1) &&
                    (!stage || (d % 4 == 0 && reinterpret_cast<uintptr_t>(data) % 16 == 0));
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    const TailArgs a{data, queries, cand, n, d, C, Cp, start_width, c_comp, k,
                     row_vec(data, d), stage != 0, kd, ki, comparisons, overflow};
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int err = with_merge_regs(Cp, [&](auto e) {
      return k > TOPK_MAX ? launch<decltype(e)::value, true>(a, Q, cluster, st)
                          : launch<decltype(e)::value, false>(a, Q, cluster, st);
    });
    if (err != 0) return err;
  }
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ the hash form

struct HashTailArgs {
  TailArgs t;
  int h_cap;               // hash-set slots a query may use
  unsigned char* scratch;  // per-query workspaces in device memory, or null
  size_t ws_bytes;         // one query's workspace
};

// A query's workspace in the hash form: the hash set (whose slots hold the
// block sort's 64-bit keys once the dedup is done: h_cap >= 2 *
// next_pow2(C) ints), comp and dist (c_comp each) and the query; its size
// in bytes, rounded up to 16 (the wrapper's hash_ws_bytes).
struct HashLayout {
  size_t table, comp, dist, qs, bytes;
  __host__ __device__ HashLayout(int h_cap, int c_comp, int d) {
    table = 0;
    comp = table + static_cast<size_t>(h_cap) * 4;
    dist = comp + static_cast<size_t>(c_comp) * 4;
    qs = dist + static_cast<size_t>(c_comp) * 4;
    bytes = (qs + static_cast<size_t>(d) * 4 + 15) / 16 * 16;
  }
};

template <bool SORT_K, bool SPILL>
__global__ void __launch_bounds__(QT_THREADS) query_tail_hash_kernel(const HashTailArgs h) {
  extern __shared__ __align__(16) unsigned char qh_smem[];
  __shared__ int warp_sums[32];
  __shared__ float wl_d[QT_WARPS * TOPK_MAX];  // each warp's k nearest
  __shared__ int wl_p[QT_WARPS * TOPK_MAX];

  const TailArgs& a = h.t;
  const int qi = blockIdx.x;
  const int d = a.d, k = a.k;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const HashLayout lay(h.h_cap, a.c_comp, d);
  unsigned char* ws = SPILL ? h.scratch + qi * h.ws_bytes : qh_smem;
  int* table = reinterpret_cast<int*>(ws + lay.table);
  int* comp = reinterpret_cast<int*>(ws + lay.comp);
  float* dist = reinterpret_cast<float*>(ws + lay.dist);
  float* qs = reinterpret_cast<float*>(ws + lay.qs);

  const float* qv = a.queries + static_cast<size_t>(qi) * d;
  for (int j = threadIdx.x; j < d; j += QT_THREADS) qs[j] = qv[j];
  const int total = dedup_hash_compact<QT_THREADS>(a.cand + static_cast<size_t>(qi) * a.C, a.C,
                                                   a.c_comp, h.h_cap, table, comp, warp_sums);
  const int nc = min(total, a.c_comp);
  const int n1 = a.n - 1;

  if (d <= QT_NARROW_D) {
    l1_thread_rows(
        a.vec, a.data, d, qs, 0, nc, [&](int r) { return min(max(comp[r], 0), n1); },
        [&](int r, float v) { dist[r] = v; });
  } else {
    for (int r = warp; r < nc; r += QT_WARPS) {
      const float v = l1_warp(a.data + static_cast<size_t>(min(max(comp[r], 0), n1)) * d, qs, d);
      if (lane == 0) dist[r] = v;
    }
  }
  __syncthreads();

  const size_t o = static_cast<size_t>(qi) * k;
  if constexpr (SORT_K) {  // (dist, index) keys in the set's slots, free now
    unsigned long long* keys = reinterpret_cast<unsigned long long*>(table);
    for (int r = threadIdx.x; r < nc; r += QT_THREADS) keys[r] = topk_key(dist[r], comp[r]);
    block_topk_sorted(keys, nc, k, [&](int r, float dv, int idx) {
      a.kd[o + r] = dv;
      a.ki[o + r] = idx;
    });
  } else {  // warp w takes positions 32w + lane + 256i, then warp 0 merges
    const int span = ((nc + QT_THREADS - 1) / QT_THREADS) * 32;
    warp_topk_keys(
        [&](int i, float& dv, int& idx) {
          const int r = 32 * warp + (i & 31) + (i >> 5) * QT_THREADS;
          dv = r < nc ? dist[r] : INFINITY;
          idx = r < nc ? comp[r] : -1;
        },
        span, k, wl_d + warp * k, wl_p + warp * k);
    __syncthreads();
    if (warp == 0) {
      warp_topk_keys(
          [&](int i, float& dv, int& idx) {
            dv = wl_d[i];
            idx = wl_p[i];
          },
          QT_WARPS * k, k, a.kd + o, a.ki + o);
    }
  }
  if (threadIdx.x == 0) {
    a.comparisons[qi] = total;
    a.overflow[qi] = max(total - a.c_comp, 0);
  }
}

template <bool SORT_K>
static int launch_hash(const HashTailArgs& h, int Q, cudaStream_t stream) {
  if (h.scratch != nullptr) {
    query_tail_hash_kernel<SORT_K, true><<<Q, QT_THREADS, 0, stream>>>(h);
    return 0;
  }
  const int err = allow_dynamic_smem(query_tail_hash_kernel<SORT_K, false>, h.ws_bytes);
  if (err != 0) return err;
  query_tail_hash_kernel<SORT_K, false><<<Q, QT_THREADS, h.ws_bytes, stream>>>(h);
  return 0;
}

// The hash form, for rows query_tail_launch cannot hold: h_cap is the hash
// set's slots (a power of two, at least 2 * C and QT_THREADS), ws_bytes one
// query's workspace (HashLayout), scratch null to hold it in shared memory,
// else Q * ws_bytes of device memory. Any C, c_comp, d and k. Returns the
// CUDA error code.
extern "C" int query_tail_hash_launch(const float* data, const float* queries,
                                      const int* cand, int n, int d, int Q, int C,
                                      int c_comp, int k, int h_cap, void* scratch,
                                      long long ws_bytes, float* kd, int* ki,
                                      int* comparisons, int* overflow, void* stream) {
  if (Q > 0) {
    const HashLayout lay(h_cap, c_comp, d);
    const bool ok = C >= 1 && n >= 1 && c_comp >= 1 && k >= 1 && h_cap >= QT_THREADS &&
                    (h_cap & (h_cap - 1)) == 0 && h_cap >= 2 * next_pow2(C) &&
                    static_cast<size_t>(ws_bytes) >= lay.bytes && ws_bytes % 16 == 0;
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    const HashTailArgs h{TailArgs{data, queries, cand, n, d, C, 0, 0, c_comp, k, row_vec(data, d), false,
                                  kd, ki, comparisons, overflow},
                         h_cap, static_cast<unsigned char*>(scratch), static_cast<size_t>(ws_bytes)};
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int err = k > TOPK_MAX ? launch_hash<true>(h, Q, st) : launch_hash<false>(h, Q, st);
    if (err != 0) return err;
  }
  return static_cast<int>(cudaGetLastError());
}
