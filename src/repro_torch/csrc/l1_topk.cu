// Masked L1 distance + top-k (kernel C of the port).
//
// Replaces the JAX package's repro/kernels/l1_topk/l1_topk.py:
// l1_topk_pallas (_l1_topk_kernel): for each query row b, the k smallest
// masked L1 distances from q[b] to cands[b, :, :], ascending, ties to the
// lowest position, inf/-1 padded. It is the "cuda" backend's l1_topk, the
// distance stage of the staged pipeline form.
//
// What bounds it on an H100: every valid candidate row is read once
// (d floats) for 3 operations per element (subtract, abs, add), about
// 0.75 flop per byte, so it is bound by device-memory bytes.
//
// Design: one block of 256 threads per query row. The block reads the
// row's mask once (each thread a contiguous run of positions), ranks the
// valid positions with a block scan and lists them in ascending order in
// its workspace, so only valid rows are read. Rows of d <= 32 then go one
// per thread, two at a time, with the widest vector loads row_vec allows;
// wider rows one per warp, coalesced. The L1 is tail_common.cuh's one
// summation order (l1_thread_rows / l1_warp), so C's distances equal
// kernel D's bits on the same compacted rows: the staged form with C and
// the fused tail give the same answer. Each (distance,
// position) is kept as one 64-bit key in the list's slot. Up to k = 32
// every warp keeps lane lists of its share and warp 0 merges the warps'
// lists (topk.cuh's warp form, as D does); beyond, the block sorts the
// keys. The query lives in shared memory when d fits; the workspace (one
// key per position, next_pow2 of them for the sort) too, else in a
// per-row slice of a device scratch the wrapper allocates, so no width and
// no k is refused.
#include "tail_common.cuh"

constexpr int L1_Q_SMEM_MAX = 8192;  // widest query held in shared memory

struct L1Args {
  const float* q;         // (B, d)
  const float* cands;     // (B, C, d)
  const uint8_t* mask;    // (B, C)
  int C, d, k;
  int vec;                // row load width of the narrow path
  int ws_cap;             // workspace keys of one row
  unsigned long long* scratch;  // B * ws_cap keys in device memory, or null
  float* out_d;
  int* out_p;
};

static bool q_in_smem(int d) { return d <= L1_Q_SMEM_MAX; }

template <bool SPILL>
__global__ void __launch_bounds__(QT_THREADS) l1_topk_kernel(const L1Args a) {
  extern __shared__ __align__(16) unsigned char l1_smem[];
  __shared__ int warp_sums[32];
  __shared__ float wl_d[QT_WARPS * TOPK_MAX];  // each warp's k nearest
  __shared__ int wl_p[QT_WARPS * TOPK_MAX];

  const int b = blockIdx.x;
  const int C = a.C, d = a.d, k = a.k;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned long long* w = SPILL ? a.scratch + static_cast<size_t>(b) * a.ws_cap
                                : reinterpret_cast<unsigned long long*>(l1_smem);
  const float* qb = a.q + static_cast<size_t>(b) * d;
  const float* qs = qb;
  if (d <= L1_Q_SMEM_MAX) {
    float* qsm = reinterpret_cast<float*>(l1_smem + (SPILL ? 0 : static_cast<size_t>(a.ws_cap) * 8));
    for (int j = threadIdx.x; j < d; j += QT_THREADS) qsm[j] = qb[j];
    qs = qsm;
  }

  // the valid positions, ascending
  const uint8_t* mb = a.mask + static_cast<size_t>(b) * C;
  const int per = (C + QT_THREADS - 1) / QT_THREADS;
  const int lo = min(static_cast<int>(threadIdx.x) * per, C);
  const int hi = min(lo + per, C);
  int mine = 0;
  for (int p = lo; p < hi; ++p) mine += mb[p] != 0;
  int off = block_exclusive_scan(mine, warp_sums);
  const int nv = warp_sums[QT_WARPS - 1];
  for (int p = lo; p < hi; ++p)
    if (mb[p]) w[off++] = static_cast<unsigned long long>(p);
  __syncthreads();

  // their L1 distances, each stored with its position as one key
  const float* cb = a.cands + static_cast<size_t>(b) * C * d;
  if (d <= QT_NARROW_D) {
    l1_thread_rows(a.vec, cb, d, qs, 0, nv, [&](int i) { return static_cast<int>(w[i]); },
                   [&](int i, float e) { w[i] = topk_key(e, static_cast<int>(w[i])); });
  } else {
    for (int i = warp; i < nv; i += QT_WARPS) {
      const int pos = static_cast<int>(w[i]);
      const float e = l1_warp(cb + static_cast<size_t>(pos) * d, qs, d);
      __syncwarp();
      if (lane == 0) w[i] = topk_key(e, pos);
    }
  }
  __syncthreads();

  float* out_d = a.out_d + static_cast<size_t>(b) * k;
  int* out_p = a.out_p + static_cast<size_t>(b) * k;
  if (k > TOPK_MAX) {
    block_topk_sorted(w, nv, k, [&](int r, float dv, int pos) {
      out_d[r] = dv;
      out_p[r] = pos;
    });
    return;
  }
  // warp w takes list slots 32w + lane + 256i, then warp 0 merges the lists
  const int span = ((nv + QT_THREADS - 1) / QT_THREADS) * 32;
  warp_topk_keys(
      [&](int i, float& dv, int& pos) {
        const int s = 32 * warp + (i & 31) + (i >> 5) * QT_THREADS;
        const unsigned long long key = s < nv ? w[s] : NO_KEY;
        dv = key_dist(key);
        pos = key_pos(key);
      },
      span, k, wl_d + warp * k, wl_p + warp * k);
  __syncthreads();
  if (warp == 0) {
    warp_topk_keys(
        [&](int i, float& dv, int& pos) {
          dv = wl_d[i];
          pos = wl_p[i];
        },
        QT_WARPS * k, k, out_d, out_p);
  }
}

// ws_cap: workspace keys of one row (C, or next_pow2(C) when k > 32);
// scratch: null to hold them in shared memory, else B * ws_cap keys of
// device memory. Returns the CUDA error code.
extern "C" int l1_topk_launch(const float* q, const float* cands,
                              const uint8_t* mask, int B, int C, int d, int k,
                              int ws_cap, void* scratch, float* out_d,
                              int* out_p, void* stream) {
  if (B > 0) {
    const bool ok = C >= 1 && d >= 1 && k >= 1 && ws_cap >= C &&
                    (k <= TOPK_MAX || ws_cap >= next_pow2(C));
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    const L1Args a{q, cands, mask, C, d, k, row_vec(cands, d), ws_cap,
                   static_cast<unsigned long long*>(scratch), out_d, out_p};
    const size_t q_bytes = q_in_smem(d) ? static_cast<size_t>(d) * 4 : 0;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (scratch != nullptr) {
      const int err = allow_dynamic_smem(l1_topk_kernel<true>, q_bytes);
      if (err != 0) return err;
      l1_topk_kernel<true><<<B, QT_THREADS, q_bytes, st>>>(a);
    } else {
      const size_t smem = static_cast<size_t>(ws_cap) * 8 + q_bytes;
      const int err = allow_dynamic_smem(l1_topk_kernel<false>, smem);
      if (err != 0) return err;
      l1_topk_kernel<false><<<B, QT_THREADS, smem, st>>>(a);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
