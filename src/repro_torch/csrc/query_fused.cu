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
// search over the candidates"); the sort network and scan are shared-memory
// work on a few KB per query. Design: one block per query. The candidate row
// (C <= a few thousand int32) lives in shared memory for the whole tail:
// a bitonic merge network joins the gather's ascending runs (starting at the
// run width, so no general sort when the run is a power of two), a block
// scan (__shfl_up_sync within warps plus one pass over warp totals) ranks
// the first occurrences, and the compacted indices and their distances stay
// in shared memory too. Rows are gathered one warp per row with coalesced
// lane-per-coordinate loads and a butterfly sum, and warp 0 selects the top-k
// with the device function the l1_topk kernel uses (topk.cuh). Candidate
// vectors therefore touch device memory exactly once and no (Q, c_comp, d)
// block is ever written. cp.async staging of the gather is later work.
#include "topk.cuh"

constexpr int QT_THREADS = 256;
constexpr int SENT = INT_MAX;  // sorts after any real index

__device__ __forceinline__ bool first_occurrence(const int* s, int i) {
  return s[i] != SENT && (i == 0 || s[i] != s[i - 1]);
}

// Exclusive prefix sum of v over the block in thread order; the block total
// is left in warp_sums[nwarps - 1]. Ends with __syncthreads().
__device__ int block_exclusive_scan(int v, int* warp_sums) {
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

__global__ void __launch_bounds__(QT_THREADS)
query_tail_kernel(const float* __restrict__ data,
                  const float* __restrict__ queries,
                  const int* __restrict__ cand, int n, int d, int C, int Cp,
                  int start_width, int c_comp, int k, float* __restrict__ kd,
                  int* __restrict__ ki, int* __restrict__ comparisons,
                  int* __restrict__ overflow) {
  extern __shared__ int smem[];
  int* s = smem;                                      // Cp sorted candidates
  int* comp = s + Cp;                                 // c_comp unique indices
  float* dist = reinterpret_cast<float*>(comp + c_comp);  // c_comp distances
  __shared__ int warp_sums[32];
  __shared__ float top_d[TOPK_MAX];
  __shared__ int top_p[TOPK_MAX];

  const int qi = blockIdx.x;
  const int* row = cand + static_cast<size_t>(qi) * C;
  for (int i = threadIdx.x; i < Cp; i += blockDim.x) {
    const int v = i < C ? row[i] : -1;
    s[i] = v < 0 ? SENT : v;
  }
  __syncthreads();

  // Merge ascending blocks of `size / 2` into ascending blocks of `size`:
  // compare each element with its mirror in the partner block, then
  // half-clean with halving strides. Starting from width 1 this is a full
  // bitonic sort; starting from the run width it only merges the runs.
  const int half_n = Cp >> 1;
  for (int size = start_width << 1; size <= Cp; size <<= 1) {
    const int half = size >> 1;
    for (int i = threadIdx.x; i < half_n; i += blockDim.x) {
      const int blk = i / half;
      const int j = i - blk * half;
      const int a = blk * size + j;
      const int b = blk * size + size - 1 - j;
      const int va = s[a], vb = s[b];
      if (va > vb) { s[a] = vb; s[b] = va; }
    }
    __syncthreads();
    for (int stride = half >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < half_n; i += blockDim.x) {
        const int a = (i / stride) * 2 * stride + i % stride;
        const int b = a + stride;
        const int va = s[a], vb = s[b];
        if (va > vb) { s[a] = vb; s[b] = va; }
      }
      __syncthreads();
    }
  }

  // Rank first occurrences: each thread owns a contiguous slice of the row.
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
  const int nc = min(total, c_comp);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* qv = queries + static_cast<size_t>(qi) * d;
  for (int r = warp; r < nc; r += blockDim.x >> 5) {
    const int idx = min(max(comp[r], 0), n - 1);
    const float* x = data + static_cast<size_t>(idx) * d;
    float acc = 0.0f;
    for (int j = lane; j < d; j += 32) acc += fabsf(x[j] - qv[j]);
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) dist[r] = acc;
  }
  __syncthreads();

  if (warp == 0) {
    warp_topk_smallest([&](int pos) { return dist[pos]; }, nc, k, top_d,
                       top_p);
    __syncwarp();
    const size_t o = static_cast<size_t>(qi) * k;
    for (int r = lane; r < k; r += 32) {
      kd[o + r] = top_d[r];
      ki[o + r] = top_p[r] >= 0 ? comp[top_p[r]] : -1;
    }
    if (lane == 0) {
      comparisons[qi] = total;
      overflow[qi] = max(total - c_comp, 0);
    }
  }
}

extern "C" int query_tail_launch(const float* data, const float* queries,
                                 const int* cand, int n, int d, int Q, int C,
                                 int Cp, int start_width, int c_comp, int k,
                                 float* kd, int* ki, int* comparisons,
                                 int* overflow, void* stream) {
  if (Q > 0) {
    const size_t smem =
        (static_cast<size_t>(Cp) + 2 * static_cast<size_t>(c_comp)) * 4;
    const int err = allow_dynamic_smem(query_tail_kernel, smem);
    if (err != 0) return err;
    query_tail_kernel<<<Q, QT_THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        data, queries, cand, n, d, C, Cp, start_width, c_comp, k, kd, ki,
        comparisons, overflow);
  }
  return static_cast<int>(cudaGetLastError());
}
