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
// block is ever written. cp.async staging of the gather is later work. The
// merge, scan, compaction and per-row L1 live in tail_common.cuh, shared
// with the compressed-payload tail (query_payload.cu).
#include "tail_common.cuh"

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
  const int total =
      dedup_compact(cand + static_cast<size_t>(qi) * C, C, Cp, start_width,
                    c_comp, s, comp, warp_sums);
  const int nc = min(total, c_comp);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* qv = queries + static_cast<size_t>(qi) * d;
  for (int r = warp; r < nc; r += blockDim.x >> 5) {
    const int idx = min(max(comp[r], 0), n - 1);
    const float acc = warp_l1_row(data + static_cast<size_t>(idx) * d, qv, d);
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
