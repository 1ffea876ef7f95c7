// The compressed-payload query tail (kernel E of the port): dedup ->
// compact -> approximate L1 over f16/i8 rows -> c_rerank shortlist -> exact
// f32 rerank -> top-k -> rerank-margin misses, in one launch.
//
// Replaces the JAX package's repro/kernels/query_fused/query_fused.py:
// query_tail_payload_pallas (_tail_kernel_payload_dma /
// _tail_kernel_payload_interpret, epilogue _payload_finish). Per query:
// kernel D's stages 3-4 (tail_common.cuh) give the compacted indices
// comp[0, nc) of the first c_comp unique candidates; position r < nc gets
// the approximate distance ad[r] = sum_j |qdata[comp[r], j] * scale - q[j]|
// and the row's L1 quantization error qerr[r] (+inf / unused past nc). The
// shortlist is the cr smallest (ad, position) keys over all c_comp
// positions, infinite ones included when fewer than cr are valid, as
// lax.top_k(-ad, cr) picks them. Each valid shortlisted row gets its exact
// f32 L1, scattered back to position order (+inf elsewhere), and the exact
// top-k over that row (ties to the lowest position) gives kd and ki. A miss
// is a valid, unshortlisted position with ad - qerr <= kd[k-1]; zero misses
// certify kd/ki equal to kernel D's on the same index, bit for bit, because
// both compute the exact L1 with the same device functions (l1_warp and
// l1_thread_rows in tail_common.cuh).
//
// What bounds it on an H100: the gathers at data-dependent addresses, as
// for D — each compacted candidate's d quantized values plus 8 bytes of
// meta (30 B + 8 for i8, 60 B + 8 for f16 at d = 30), then d f32 values for
// each of the cr shortlisted rows; the merge network, the scan and the
// shortlist sort are on-chip work on a few tens of KB per query.
// Design: one block of 256 threads per query, everything per query held in
// shared memory (comp, ad, qerr, exact distances, shortlist flags, 64-bit
// sort keys); the candidate row is merged in registers by kernel D's code
// (tail_common.cuh). The approximate pass runs one thread per compacted
// position, summing its row's coordinates in ascending order with
// round-to-nearest intrinsics (no FMA contraction), so ad — and so the
// shortlist and the miss count — equal the plain version's exactly. The
// shortlist is a block-wide bitonic sort of (order-preserving ad bits,
// position) keys over next_pow2(c_comp) entries, since cr may be as large as
// c_comp (beyond the warp top-k's TOPK_MAX). The exact rerank computes
// kernel D's L1 with D's device functions (one thread per shortlisted row
// up to d = 32, one warp per row beyond), so a query with no miss gets D's
// bits; the final top-k is warp 0's warp_topk_smallest, and the miss count a
// block reduction. cp.async/TMA staging of the quantized rows and several
// queries per block are later work.
#include <cuda_fp16.h>

#include "tail_common.cuh"

__device__ __forceinline__ float payload_to_f32(__half v) {
  return __half2float(v);
}
__device__ __forceinline__ float payload_to_f32(int8_t v) {
  return static_cast<float>(v);
}

// Monotone map of a float's bits to uint32 (-0 < +0 aside): larger floats
// give larger keys, +inf the largest finite-or-infinite one.
__device__ __forceinline__ uint32_t ordered_bits(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

template <class T, int E>
__global__ void __launch_bounds__(QT_THREADS)
query_tail_payload_kernel(const float* __restrict__ data,
                          const T* __restrict__ qdata,
                          const float* __restrict__ meta,
                          const float* __restrict__ queries,
                          const int* __restrict__ cand, int n, int d, int C,
                          int Cp, int start_width, int c_comp, int c_keys,
                          int cr, int k, int vec, float* __restrict__ kd,
                          int* __restrict__ ki, int* __restrict__ comparisons,
                          int* __restrict__ overflow,
                          int* __restrict__ misses) {
  extern __shared__ unsigned long long smem_keys[];
  unsigned long long* keys = smem_keys;  // c_keys shortlist sort keys
  int* xbuf = reinterpret_cast<int*>(keys + c_keys);  // the merge's exchange
  int* comp = xbuf + 2 * QT_THREADS * E;              // c_comp unique indices
  float* ad = reinterpret_cast<float*>(comp + c_comp);  // approximate L1
  float* qerr = ad + c_comp;  // per-position quantization error bound
  float* ed = qerr + c_comp;  // exact L1 in position order, +inf off list
  float* qs = ed + c_comp;    // the query row (d floats)
  int* in_short = reinterpret_cast<int*>(qs + d);  // c_comp shortlist flags
  __shared__ int warp_sums[32];
  __shared__ int warp_last[32];
  __shared__ float top_d[TOPK_MAX];
  __shared__ int top_p[TOPK_MAX];

  const int qi = blockIdx.x;
  const float* qv = queries + static_cast<size_t>(qi) * d;
  for (int j = threadIdx.x; j < d; j += blockDim.x) qs[j] = qv[j];
  const int total =
      dedup_compact<E>(cand + static_cast<size_t>(qi) * C, C, Cp, start_width,
                       c_comp, xbuf, comp, warp_sums, warp_last);
  const int nc = min(total, c_comp);

  // approximate pass: one thread per compacted position
  for (int r = threadIdx.x; r < c_comp; r += blockDim.x) {
    float acc = INFINITY, err = 0.0f;
    if (r < nc) {
      const size_t idx = static_cast<size_t>(min(max(comp[r], 0), n - 1));
      const T* row = qdata + idx * d;
      const float scale = meta[idx * 2];
      err = meta[idx * 2 + 1];
      acc = 0.0f;
      for (int j = 0; j < d; ++j) {
        const float deq = __fmul_rn(payload_to_f32(row[j]), scale);
        acc = __fadd_rn(acc, fabsf(__fsub_rn(deq, qs[j])));
      }
    }
    ad[r] = acc;
    qerr[r] = err;
    ed[r] = INFINITY;
    in_short[r] = 0;
  }
  for (int r = threadIdx.x; r < c_keys; r += blockDim.x) {
    keys[r] = r < c_comp ? (static_cast<unsigned long long>(
                                ordered_bits(r < nc ? ad[r] : INFINITY))
                            << 32) | static_cast<unsigned>(r)
                         : ~0ull;
  }
  __syncthreads();

  // shortlist: the cr smallest (ad, position) keys
  bitonic_merge_from(keys, c_keys, 1);

  // exact rerank of the shortlisted rows with kernel D's L1
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  auto short_pos = [&](int i) { return static_cast<int>(keys[i] & 0xffffffffu); };
  auto row_of = [&](int i) {
    const int pos = short_pos(i);
    return pos < nc ? min(max(comp[pos], 0), n - 1) : -1;
  };
  if (d <= QT_NARROW_D) {
    l1_thread_rows(vec, data, d, qs, 0, cr, row_of,
                   [&](int i, float e) { ed[short_pos(i)] = e; });
  } else {
    for (int i = warp; i < cr; i += QT_WARPS) {
      const int idx = row_of(i);
      if (idx >= 0) {
        const float e = l1_warp(data + static_cast<size_t>(idx) * d, qs, d);
        if (lane == 0) ed[short_pos(i)] = e;
      }
    }
  }
  for (int i = threadIdx.x; i < cr; i += QT_THREADS) in_short[short_pos(i)] = 1;
  __syncthreads();

  // exact top-k in position order (ties to the lowest position)
  if (warp == 0) {
    warp_topk_smallest([&](int pos) { return ed[pos]; }, nc, k, top_d, top_p);
  }
  __syncthreads();

  // rerank-margin misses against the k-th exact distance
  const float dk = top_d[k - 1];
  const int per = (c_comp + blockDim.x - 1) / blockDim.x;
  const int lo = min(static_cast<int>(threadIdx.x) * per, c_comp);
  const int hi = min(lo + per, c_comp);
  int local = 0;
  for (int r = lo; r < hi; ++r)
    local += r < nc && !in_short[r] && __fsub_rn(ad[r], qerr[r]) <= dk;
  block_exclusive_scan(local, warp_sums);
  const int miss_total = warp_sums[(blockDim.x >> 5) - 1];

  if (warp == 0) {
    const size_t o = static_cast<size_t>(qi) * k;
    for (int r = lane; r < k; r += 32) {
      kd[o + r] = top_d[r];
      ki[o + r] = top_p[r] >= 0 ? comp[top_p[r]] : -1;
    }
    if (lane == 0) {
      comparisons[qi] = total;
      overflow[qi] = max(total - c_comp, 0);
      misses[qi] = miss_total;
    }
  }
}

// Dynamic shared memory of one block, in bytes (the wrapper checks the same
// sum against its budget).
static size_t payload_smem_bytes(int Cp, int c_comp, int c_keys, int d) {
  const size_t e = static_cast<size_t>(Cp > QT_THREADS ? Cp : QT_THREADS);
  return static_cast<size_t>(c_keys) * 8 +
         (2 * e + 5 * static_cast<size_t>(c_comp) + d) * 4;
}

template <class T, int E>
static int launch_e(const float* data, const T* qdata, const float* meta,
                    const float* queries, const int* cand, int n, int d, int Q,
                    int C, int Cp, int start_width, int c_comp, int c_keys,
                    int cr, int k, float* kd, int* ki, int* comparisons,
                    int* overflow, int* misses, cudaStream_t stream) {
  const size_t smem = payload_smem_bytes(Cp, c_comp, c_keys, d);
  const int err = allow_dynamic_smem(query_tail_payload_kernel<T, E>, smem);
  if (err != 0) return err;
  query_tail_payload_kernel<T, E><<<Q, QT_THREADS, smem, stream>>>(
      data, qdata, meta, queries, cand, n, d, C, Cp, start_width, c_comp,
      c_keys, cr, k, row_vec(data, d), kd, ki, comparisons, overflow, misses);
  return 0;
}

// Cp is the merge width (a power of two, C <= Cp <= 16,384) and
// start_width the run width the merge starts from; the columns past C count
// as -1. Returns the CUDA error code.
template <class T>
static int launch(const float* data, const T* qdata, const float* meta,
                  const float* queries, const int* cand, int n, int d, int Q,
                  int C, int Cp, int start_width, int c_comp, int c_keys,
                  int cr, int k, float* kd, int* ki, int* comparisons,
                  int* overflow, int* misses, void* stream) {
  if (Q > 0) {
    if (!(C >= 1 && C <= Cp && (Cp & (Cp - 1)) == 0 && Cp <= 64 * QT_THREADS))
      return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int err = with_merge_regs(Cp, [&](auto e) {
      return launch_e<T, decltype(e)::value>(
          data, qdata, meta, queries, cand, n, d, Q, C, Cp, start_width, c_comp,
          c_keys, cr, k, kd, ki, comparisons, overflow, misses, st);
    });
    if (err != 0) return err;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int query_tail_payload_f16_launch(
    const float* data, const void* qdata, const float* meta,
    const float* queries, const int* cand, int n, int d, int Q, int C, int Cp,
    int start_width, int c_comp, int c_keys, int cr, int k, float* kd,
    int* ki, int* comparisons, int* overflow, int* misses, void* stream) {
  return launch(data, static_cast<const __half*>(qdata), meta, queries, cand,
                n, d, Q, C, Cp, start_width, c_comp, c_keys, cr, k, kd, ki,
                comparisons, overflow, misses, stream);
}

extern "C" int query_tail_payload_i8_launch(
    const float* data, const void* qdata, const float* meta,
    const float* queries, const int* cand, int n, int d, int Q, int C, int Cp,
    int start_width, int c_comp, int c_keys, int cr, int k, float* kd,
    int* ki, int* comparisons, int* overflow, int* misses, void* stream) {
  return launch(data, static_cast<const int8_t*>(qdata), meta, queries, cand,
                n, d, Q, C, Cp, start_width, c_comp, c_keys, cr, k, kd, ki,
                comparisons, overflow, misses, stream);
}
