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
// both use the same warp_l1_row.
//
// What bounds it on an H100: the gathers at data-dependent addresses, as
// for D — each compacted candidate's d quantized values plus 8 bytes of
// meta (30 B + 8 for i8, 60 B + 8 for f16 at d = 30), then d f32 values for
// each of the cr shortlisted rows; the merge network, the scan and the
// shortlist sort are shared-memory work on a few tens of KB per query.
// Design: one block of 256 threads per query, everything per query held in
// shared memory (candidate row, comp, ad, qerr, exact distances, shortlist
// flags, 64-bit sort keys). The approximate pass runs one thread per
// compacted position, summing its row's coordinates in ascending order with
// round-to-nearest intrinsics (no FMA contraction), so ad — and so the
// shortlist and the miss count — equal the plain version's exactly. The
// shortlist is a block-wide bitonic sort of (order-preserving ad bits,
// position) keys over next_pow2(c_comp) entries, since cr may be as large as
// c_comp (beyond the warp top-k's TOPK_MAX). The exact rerank is one warp
// per shortlisted row, the final top-k is warp 0's warp_topk_smallest, and
// the miss count a block reduction. cp.async/TMA staging of the quantized
// rows and several queries per block are later work.
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

template <class T>
__global__ void __launch_bounds__(QT_THREADS)
query_tail_payload_kernel(const float* __restrict__ data,
                          const T* __restrict__ qdata,
                          const float* __restrict__ meta,
                          const float* __restrict__ queries,
                          const int* __restrict__ cand, int n, int d, int C,
                          int Cp, int start_width, int c_comp, int c_keys,
                          int cr, int k, float* __restrict__ kd,
                          int* __restrict__ ki, int* __restrict__ comparisons,
                          int* __restrict__ overflow,
                          int* __restrict__ misses) {
  extern __shared__ unsigned long long smem_keys[];
  unsigned long long* keys = smem_keys;  // c_keys shortlist sort keys
  int* s = reinterpret_cast<int*>(keys + c_keys);  // Cp sorted candidates
  int* comp = s + Cp;                               // c_comp unique indices
  float* ad = reinterpret_cast<float*>(comp + c_comp);  // approximate L1
  float* qerr = ad + c_comp;  // per-position quantization error bound
  float* ed = qerr + c_comp;  // exact L1 in position order, +inf off list
  float* qs = ed + c_comp;    // the query row (d floats)
  int* in_short = reinterpret_cast<int*>(qs + d);  // c_comp shortlist flags
  __shared__ int warp_sums[32];
  __shared__ float top_d[TOPK_MAX];
  __shared__ int top_p[TOPK_MAX];

  const int qi = blockIdx.x;
  const float* qv = queries + static_cast<size_t>(qi) * d;
  for (int j = threadIdx.x; j < d; j += blockDim.x) qs[j] = qv[j];
  const int total =
      dedup_compact(cand + static_cast<size_t>(qi) * C, C, Cp, start_width,
                    c_comp, s, comp, warp_sums);
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

  // exact rerank, one warp per shortlisted row
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = warp; i < cr; i += blockDim.x >> 5) {
    const int pos = static_cast<int>(keys[i] & 0xffffffffu);
    if (pos < nc) {
      const int idx = min(max(comp[pos], 0), n - 1);
      const float e = warp_l1_row(data + static_cast<size_t>(idx) * d, qs, d);
      if (lane == 0) ed[pos] = e;
    }
    if (lane == 0) in_short[pos] = 1;
  }
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
  return static_cast<size_t>(c_keys) * 8 +
         (static_cast<size_t>(Cp) + 5 * static_cast<size_t>(c_comp) + d) * 4;
}

template <class T>
static int launch(const float* data, const T* qdata, const float* meta,
                  const float* queries, const int* cand, int n, int d, int Q,
                  int C, int Cp, int start_width, int c_comp, int c_keys,
                  int cr, int k, float* kd, int* ki, int* comparisons,
                  int* overflow, int* misses, void* stream) {
  if (Q > 0) {
    const size_t smem = payload_smem_bytes(Cp, c_comp, c_keys, d);
    const int err = allow_dynamic_smem(query_tail_payload_kernel<T>, smem);
    if (err != 0) return err;
    query_tail_payload_kernel<T><<<Q, QT_THREADS, smem,
                                   static_cast<cudaStream_t>(stream)>>>(
        data, qdata, meta, queries, cand, n, d, C, Cp, start_width, c_comp,
        c_keys, cr, k, kd, ki, comparisons, overflow, misses);
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
