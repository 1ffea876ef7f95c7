// Flash attention, forward (kernel F of the port): online-softmax GQA
// attention with causal, sliding-window, kv-length and q-offset masks.
//
// Replaces the JAX package's repro/kernels/flash_attention/flash_attention.py:
// flash_attention_pallas (_flash_kernel). For q (B, Hq, Sq, dh) and k, v
// (B, Hkv, Skv, dh), query row i of batch row b sits at position
// q_offset[b] + i and may see key j when j < kv_len[b], j <= q position
// (causal) and j > q position - window (window > 0). Output
// o = softmax(q k^T / sqrt(dh)) v per (b, q-head), with q-head h reading
// kv-head h / (Hq / Hkv); a row that sees no key gives 0.
//
// Differences from the Pallas kernel, all of them its calling convention:
// q_offset and kv_len are per-row int32 device arrays, so one launch serves
// a prefill (equal offsets) and a batched decode step whose rows each have
// their own cache length; the kernel masks the ragged edges of Sq, Skv and
// dh itself instead of taking operands padded to its tiles; and it scales q
// by 1/sqrt(dh) as it loads it, as the model's chunked_attention does,
// where the Pallas kernel scales the scores after the dot.
//
// What bounds it on an H100: at the model's shapes the work is
// 4 * B * Hq * (visible q-k pairs) * dh flops (two products), and the bytes
// are q, k, v read once and o written once. For the datastore pass
// (B = 8, Hq = 32, Hkv = 8, S = 1,024, dh = 128, causal) that is 69 GFLOP
// against 42 MB: bound by operations, about 70 us at the card's 989 TFLOP/s
// bf16 tensor-core rate. A decode step (Sq = 1) is bound by the bytes of
// the cache it reads.
//
// Design: this first kernel is simple and exact in float32, not fast. One
// block of 256 threads per (q-tile of 64 rows, q-head, batch row); the loop
// over 64-key tiles runs inside the block and carries the online-softmax
// state (row max m, row sum l in shared memory, the 64 x dh accumulator in
// registers: each thread owns 4 rows x dh/16 columns), which on the TPU
// persisted over a sequential grid dimension. K and V tiles are converted
// to float32 in shared memory; both products are float32 FMAs on the CUDA
// cores with a 4 x 4 (scores) and 4 x dh/16 (values) register tile per
// thread. The key loop stops at the causal edge of the q-tile and starts at
// its window edge, so key tiles past the diagonal are not visited. Tensor
// cores (mma / wgmma), TMA staging and a split over the key axis for the
// one-row decode step are later work.
#include "common.cuh"

#include <cuda_bf16.h>

constexpr int FA_BQ = 64;        // query rows per block
constexpr int FA_BK = 64;        // keys per tile
constexpr int FA_THREADS = 256;  // 16 x 16 threads: ty owns rows, tx columns
constexpr int FA_DH_MAX = 256;

using T = __nv_bfloat16;  // q, k, v and o: bf16 in, bf16 out, as on the model path

// Shared-memory row strides: odd strides for Q and K, whose columns are read
// by 16 rows at once, keep those reads free of bank conflicts.
__host__ __device__ inline int fa_ld(int dh) { return (dh % 2 == 0) ? dh + 1 : dh; }

__host__ __device__ inline size_t fa_smem_floats(int dh, int dhp) {
  return static_cast<size_t>(FA_BQ) * fa_ld(dh)    // Q tile, scaled
         + static_cast<size_t>(FA_BK) * fa_ld(dh)  // K tile
         + static_cast<size_t>(FA_BK) * dhp        // V tile, padded columns 0
         + static_cast<size_t>(FA_BQ) * (FA_BK + 1)  // scores, then weights
         + 3 * FA_BQ;                              // m, l, correction per row
}

struct Strides {
  long long b, h, s;  // elements; the last (dh) axis is contiguous
};

template <int NJ>  // NJ = dh rounded up to 16, over 16
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       Strides qs, Strides ks, Strides vs, Strides os,
                       int Hq, int Hkv, int Sq, int Skv, int dh, float scale,
                       int causal, int window,
                       const int* __restrict__ q_offset,
                       const int* __restrict__ kv_len) {
  constexpr int DHP = 16 * NJ;
  extern __shared__ float smem[];
  const int ld = fa_ld(dh);
  float* Qs = smem;
  float* Ks = Qs + FA_BQ * ld;
  float* Vs = Ks + FA_BK * ld;
  float* Ps = Vs + FA_BK * DHP;
  float* m_s = Ps + FA_BQ * (FA_BK + 1);
  float* l_s = m_s + FA_BQ;
  float* c_s = l_s + FA_BQ;
  constexpr int LDP = FA_BK + 1;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * FA_BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int rows = min(FA_BQ, Sq - q0);
  const int qo = q_offset[b];
  const int kl = min(kv_len[b], Skv);

  // the keys any row of this tile may see: [lo, hi)
  int hi = kl;
  if (causal) hi = min(hi, qo + q0 + rows);
  int lo = 0;
  if (window > 0) lo = max(0, qo + q0 - window + 1);

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  for (int i = tid; i < FA_BQ * dh; i += FA_THREADS) {
    const int r = i / dh;
    const int c = i - r * dh;
    Qs[r * ld + c] = r < rows ? __bfloat162float(qb[(q0 + r) * qs.s + c]) * scale : 0.0f;
  }
  for (int i = tid; i < FA_BK * DHP; i += FA_THREADS) Vs[i] = 0.0f;
  if (tid < FA_BQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.0f;
  }

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;

  for (int k0 = (lo / FA_BK) * FA_BK; k0 < hi; k0 += FA_BK) {
    __syncthreads();  // the previous tile's K, V and weights are consumed
    for (int i = tid; i < FA_BK * dh; i += FA_THREADS) {
      const int r = i / dh;
      const int c = i - r * dh;
      const int key = k0 + r;
      const bool in = key < Skv;
      Ks[r * ld + c] = in ? __bfloat162float(kb[key * ks.s + c]) : 0.0f;
      Vs[r * DHP + c] = in ? __bfloat162float(vb[key * vs.s + c]) : 0.0f;
    }
    __syncthreads();

    // scores: rows ty*4 + i, keys tx + 16*jj
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.0f;
    for (int d = 0; d < dh; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * ld + d];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) kv[jj] = Ks[(tx + 16 * jj) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = fmaf(qv[i], kv[jj], s[i][jj]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int qp = qo + q0 + r;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = tx + 16 * jj;
        const int kp = k0 + c;
        bool ok = r < rows && kp < kl;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        Ps[r * LDP + c] = ok ? s[i][jj] : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: four threads per row, 16 keys each
    {
      const int r = tid >> 2;
      const int part = tid & 3;
      float* pr = Ps + r * LDP + part * 16;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, pr[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float m_use = m_new == -INFINITY ? 0.0f : m_new;  // row sees nothing yet
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(pr[c] - m_use);
        pr[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (part == 0) {
        const float corr = expf(m_old - m_use);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    for (int kk = 0; kk < FA_BK; ++kk) {
      float pv[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * LDP + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = Vs[kk * DHP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= rows) continue;
    const float l = l_s[r];
    const float inv = l > 0.0f ? 1.0f / l : 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < dh) ob[(q0 + r) * os.s + c] = __float2bfloat16_rn(acc[i][j] * inv);
    }
  }
}

template <int NJ>
static int launch_nj(const void* q, const void* k, const void* v, void* o,
                     Strides qs, Strides ks, Strides vs, Strides os, int B,
                     int Hq, int Hkv, int Sq, int Skv, int dh, float scale,
                     int causal, int window, const int* q_offset,
                     const int* kv_len, cudaStream_t stream) {
  const size_t smem = fa_smem_floats(dh, 16 * NJ) * sizeof(float);
  const int err = allow_dynamic_smem(flash_attention_kernel<NJ>, smem);
  if (err != 0) return err;
  const dim3 grid((Sq + FA_BQ - 1) / FA_BQ, Hq, B);
  flash_attention_kernel<NJ><<<grid, FA_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), qs, ks, vs, os, Hq, Hkv,
      Sq, Skv, dh, scale, causal, window, q_offset, kv_len);
  return 0;
}

// Strides are in elements, (b, h, s) for each operand. Returns the CUDA
// error code.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B,
    int Hq, int Hkv, int Sq, int Skv, int dh, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss, long long vsb,
    long long vsh, long long vss, long long osb, long long osh, long long oss,
    float scale, int causal, int window, const int* q_offset,
    const int* kv_len, void* stream) {
  if (B > 0 && Hq > 0 && Sq > 0) {
    if (dh < 1 || dh > FA_DH_MAX || Hkv < 1 || Hq % Hkv != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
        os{osb, osh, oss};
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int nj = (dh + 15) / 16;
    const int err =
        nj <= 2   ? launch_nj<2>(q, k, v, o, qs, ks, vs, os, B, Hq, Hkv, Sq, Skv,
                                 dh, scale, causal, window, q_offset, kv_len, st)
        : nj <= 4 ? launch_nj<4>(q, k, v, o, qs, ks, vs, os, B, Hq, Hkv, Sq, Skv,
                                 dh, scale, causal, window, q_offset, kv_len, st)
        : nj <= 8 ? launch_nj<8>(q, k, v, o, qs, ks, vs, os, B, Hq, Hkv, Sq, Skv,
                                 dh, scale, causal, window, q_offset, kv_len, st)
                  : launch_nj<16>(q, k, v, o, qs, ks, vs, os, B, Hq, Hkv, Sq,
                                  Skv, dh, scale, causal, window, q_offset,
                                  kv_len, st);
    if (err != 0) return err;
  }
  return static_cast<int>(cudaGetLastError());
}
