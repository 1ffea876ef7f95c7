// Masked L1 distance + top-k (kernel C of the port).
//
// Replaces the JAX package's repro/kernels/l1_topk/l1_topk.py:
// l1_topk_pallas (_l1_topk_kernel): for each query row b, the k smallest
// masked L1 distances from q[b] to cands[b, :, :], ascending, ties to the
// lowest position, inf/-1 padded.
//
// What bounds it on an H100: every candidate row is read once (B*C*d floats)
// for 3 operations per element (subtract, abs, add), about 0.75 flop per
// byte, so it is bound by device-memory bytes. Design: one warp per query
// row; lane l owns candidates l, l+32, ... and accumulates each one's L1
// over d in registers, so a distance never goes to memory; the lane keeps a
// running sorted top-k of its own candidates and the warp merges the 32
// lists on (dist, pos) keys (topk.cuh). Simple and exact on ties; the loads
// are per-lane rows rather than coalesced tiles, which a later version can
// stage through shared memory.
#include "topk.cuh"

constexpr int L1_THREADS = 256;  // 8 query rows per block

__global__ void __launch_bounds__(L1_THREADS)
l1_topk_kernel(const float* __restrict__ q, const float* __restrict__ cands,
               const uint8_t* __restrict__ mask, int B, int C, int d, int k,
               float* __restrict__ out_d, int* __restrict__ out_p) {
  const int b = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (b >= B) return;  // whole warps leave together
  const float* qb = q + static_cast<size_t>(b) * d;
  const float* cb = cands + static_cast<size_t>(b) * C * d;
  const uint8_t* mb = mask + static_cast<size_t>(b) * C;
  auto dist = [&](int pos) -> float {
    if (!mb[pos]) return INFINITY;
    const float* row = cb + static_cast<size_t>(pos) * d;
    float acc = 0.0f;
    for (int j = 0; j < d; ++j) acc += fabsf(row[j] - qb[j]);
    return acc;
  };
  warp_topk_smallest(dist, C, k, out_d + static_cast<size_t>(b) * k,
                     out_p + static_cast<size_t>(b) * k);
}

extern "C" int l1_topk_launch(const float* q, const float* cands,
                              const uint8_t* mask, int B, int C, int d, int k,
                              float* out_d, int* out_p, void* stream) {
  if (B > 0) {
    const int blocks = (B * 32 + L1_THREADS - 1) / L1_THREADS;
    l1_topk_kernel<<<blocks, L1_THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(q, cands, mask, B,
                                                          C, d, k, out_d,
                                                          out_p);
  }
  return static_cast<int>(cudaGetLastError());
}
