// The compressed-payload query tail (kernel E of the port): dedup ->
// compact -> approximate L1 over f16/i8 rows -> c_rerank shortlist -> exact
// f32 rerank -> top-k -> rerank-margin misses, in one launch.
//
// Replaces the JAX package's repro/kernels/query_fused/query_fused.py:
// query_tail_payload_pallas (_tail_kernel_payload_dma /
// _tail_kernel_payload_interpret, epilogue _payload_finish). Per query:
// the first c_comp unique candidates in index order are compacted;
// compacted row r gets the approximate distance ad = sum_j |qdata[idx, j] *
// scale - q[j]| and the row's L1 quantization error qerr. The shortlist is
// the cr smallest (ad, index) keys; each shortlisted row gets its exact
// f32 L1, and the exact top-k over the shortlist (ties to the lowest
// index) gives kd and ki. A miss is a compacted row outside the shortlist
// with ad - qerr <= kd[k-1]; zero misses certify kd/ki equal to kernel D's
// on the same index, bit for bit, because both compute the exact L1 in one
// order (tail_common.cuh: l1_warp, l1_warp_rows and l1_thread_rows give the
// same bits). In the reference the compacted positions ascend with
// the index, so its position ties are index ties: breaking every tie by
// the index gives its answer from any layout of the compacted set.
//
// What bounds it on an H100: the gathers at data-dependent addresses, as
// for D — each compacted candidate's d quantized values plus 8 bytes of
// meta (30 B + 8 for i8, 60 B + 8 for f16 at d = 30), then d f32 values for
// each of the cr shortlisted rows; about 0.75 operations a byte, and the
// rest is on-chip work on a few tens of KB per query.
//
// Design: one block of 512 threads per query, its arrays in shared memory
// (or, for rows too wide for it, in a per-query slice of a device scratch
// the wrapper allocates). Stages 3-4 are tail_common.cuh's hash-set dedup,
// whose cost follows the row's live entries, not the sorting network over
// its whole width that D runs; a query with more than c_comp unique
// candidates keeps the c_comp smallest through two levels of histograms.
// The approximate pass gives each thread two compacted rows at a time and
// reads each row as the few aligned 16-byte chunks that hold it (three for
// an i8 row of 30 bytes, at most five for an f16 row), realigned in
// registers, every load issued before the first sum; it sums the
// coordinates in ascending order with round-to-nearest intrinsics (no FMA
// contraction), so ad — and so the shortlist and the miss count — equal
// the plain version's exactly. The shortlist is a radix select of the
// cr-th smallest (ad, index) key (block_select in topk.cuh: a pass or two
// past the bits all keys share, for any cr) and a scan that gathers the
// keys up to it. The exact rerank computes kernel D's L1 in D's order
// (l1_warp's lane classes and butterfly, four rows a warp with their loads
// in flight); the final top-k runs over the cr shortlisted rows only (up
// to 32 of them and k <= 32 sorted in warp 0's registers, else by the
// block sort); the miss count is a block reduction. The kernel's time is
// its slowest query's: a query that overflows c_comp handles about four
// times the rows of a typical one, so the block has 512 threads (more
// loads in flight and fewer rounds a thread than 256 give, without the
// longer barriers of 1,024). Spreading a query over a cluster, as D does
// for wide rows, is left out: every block of a cluster would repeat the
// dedup.
#include <cuda_fp16.h>

#include "tail_common.cuh"

struct PayloadArgs {
  const float* data;     // (n, d) exact rows
  const void* qdata;     // (n, d) f16 or i8 rows
  const float2* meta;    // (n,) [dequant scale, L1 error bound]
  const float* queries;  // (Q, d)
  const int* cand;       // (Q, C), -1 where masked
  int n, d, C, c_comp, cr, k;
  int h_cap;             // hash-set slots a query may use
  unsigned char* scratch;  // per-query workspaces in device memory, or null
  size_t ws_bytes;       // one query's workspace
  float* kd;
  int* ki;
  int* comparisons;
  int* overflow;
  int* misses;
};

// A query's workspace: the block sort's keys (past the warp form: k or cr
// over TOPK_MAX), the hash
// set, comp, ad, qerr, the shortlisted indices and their exact distances,
// and the query; its size in bytes, rounded up to 16.
struct PayloadLayout {
  size_t keys, table, comp, ad, qerr, sidx, ed, qs, bytes;
  __host__ __device__ PayloadLayout(int h_cap, int c_comp, int cr, int k, int d) {
    keys = 0;
    const bool sort = k > TOPK_MAX || cr > TOPK_MAX;
    table = keys + (sort ? (static_cast<size_t>(next_pow2(cr)) * 8 + 15) / 16 * 16 : 0);
    comp = table + static_cast<size_t>(h_cap) * 4;
    ad = comp + static_cast<size_t>(c_comp) * 4;
    qerr = ad + static_cast<size_t>(c_comp) * 4;
    sidx = qerr + static_cast<size_t>(c_comp) * 4;
    ed = sidx + static_cast<size_t>(cr) * 4;
    qs = ed + static_cast<size_t>(cr) * 4;
    bytes = (qs + static_cast<size_t>(d) * 4 + 15) / 16 * 16;
  }
};

__device__ __forceinline__ float payload_to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float payload_to_f32(int8_t v) { return static_cast<float>(v); }

// The first NW 32-bit words of the bytes at p, for any alignment of p: the
// 16-byte-aligned chunks that hold the first `bytes` of them (bytes <= 4 *
// NW; every load issued together, none past the chunk that holds the last
// byte), realigned in registers with funnel shifts. Three 16-byte loads
// read an i8 row of 30 bytes at its 2-byte alignment, five an f16 row of
// 60: a scattered row costs a few wide transactions rather than one per
// element pair.
template <int NW>
__device__ __forceinline__ void load_words(const void* p, int bytes, uint32_t (&a)[NW]) {
  constexpr int NC = (4 * NW + 30) / 16;  // chunks the words can span
  const uintptr_t u = reinterpret_cast<uintptr_t>(p);
  const int off = static_cast<int>(u & 15);
  const uint4* chunk = reinterpret_cast<const uint4*>(u - off);
  uint32_t w[4 * NC + 4];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const uint4 t = c * 16 < off + bytes ? chunk[c] : make_uint4(0, 0, 0, 0);
    w[4 * c] = t.x;
    w[4 * c + 1] = t.y;
    w[4 * c + 2] = t.z;
    w[4 * c + 3] = t.w;
  }
#pragma unroll
  for (int i = 4 * NC; i < 4 * NC + 4; ++i) w[i] = 0;
  const int q = off >> 2, sh = 8 * (off & 3);
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint32_t lo = q == 0 ? w[i] : q == 1 ? w[i + 1] : q == 2 ? w[i + 2] : w[i + 3];
    const uint32_t hi = q == 0 ? w[i + 1] : q == 1 ? w[i + 2] : q == 2 ? w[i + 3] : w[i + 4];
    a[i] = __funnelshift_r(lo, hi, sh);
  }
}

// Element j of a quantized row held as words (j a compile-time index after
// unrolling), exactly as a float.
__device__ __forceinline__ float payload_elem(const uint32_t* a, int j, int8_t) {
  return static_cast<float>(static_cast<int8_t>(a[j >> 2] >> (8 * (j & 3))));
}
__device__ __forceinline__ float payload_elem(const uint32_t* a, int j, __half) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(a[j >> 1] >> (16 * (j & 1)))));
}

// The approximate distances of R rows, out[r] = sum_j |x[r][j] * scale[r] -
// q[j]| over j in ascending order, one rounded product, difference and add
// at a time (the plain version's order), QT_NARROW_D elements of every row
// loaded at a time; a row that is not live is not read.
template <int R, class T>
__device__ __forceinline__ void approx_l1(const T* const (&x)[R], const bool (&live)[R],
                                          const float (&scale)[R], const float* __restrict__ q,
                                          int d, float (&out)[R]) {
  constexpr int NW = QT_NARROW_D * static_cast<int>(sizeof(T)) / 4;
#pragma unroll
  for (int r = 0; r < R; ++r) out[r] = 0.0f;
  for (int j0 = 0; j0 < d; j0 += QT_NARROW_D) {
    const int bytes = min(d - j0, QT_NARROW_D) * static_cast<int>(sizeof(T));
    uint32_t a[R][NW];
#pragma unroll
    for (int r = 0; r < R; ++r) load_words(x[r] + j0, live[r] ? bytes : 0, a[r]);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < QT_NARROW_D; ++j)
        if (j0 + j < d)
          out[r] = __fadd_rn(out[r], fabsf(__fsub_rn(__fmul_rn(payload_elem(a[r], j, T{}), scale[r]),
                                                    q[j0 + j])));
  }
}

constexpr int E_THREADS = 512;  // threads of a query's block
constexpr int E_WARPS = E_THREADS / 32;
constexpr int APPROX_ROWS = 2;  // compacted rows a thread reads at once
constexpr int RERANK_ROWS = 4;  // shortlisted rows a warp reranks at once

template <class T, bool SPILL>
__global__ void __launch_bounds__(E_THREADS)
query_tail_payload_kernel(const PayloadArgs a) {
  extern __shared__ __align__(16) unsigned char pl_smem[];
  __shared__ int warp_sums[32];
  __shared__ SelectSmem sel;
  __shared__ float dk_s;

  const int qi = blockIdx.x;
  const int d = a.d, k = a.k, cr = a.cr;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const PayloadLayout lay(a.h_cap, a.c_comp, cr, k, d);
  unsigned char* ws = SPILL ? a.scratch + qi * a.ws_bytes : pl_smem;
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(ws + lay.keys);
  int* table = reinterpret_cast<int*>(ws + lay.table);
  int* comp = reinterpret_cast<int*>(ws + lay.comp);
  float* ad = reinterpret_cast<float*>(ws + lay.ad);
  float* qerr = reinterpret_cast<float*>(ws + lay.qerr);
  int* sidx = reinterpret_cast<int*>(ws + lay.sidx);
  float* ed = reinterpret_cast<float*>(ws + lay.ed);
  float* qs = reinterpret_cast<float*>(ws + lay.qs);

  const float* qv = a.queries + static_cast<size_t>(qi) * d;
  for (int j = threadIdx.x; j < d; j += E_THREADS) qs[j] = qv[j];
  const int total = dedup_hash_compact<E_THREADS>(a.cand + static_cast<size_t>(qi) * a.C, a.C,
                                       a.c_comp, a.h_cap, table, comp, warp_sums);
  const int nc = min(total, a.c_comp);
  const int n1 = a.n - 1;

  // approximate pass: each thread takes APPROX_ROWS compacted rows at a
  // time, their loads in flight together, and keeps the bounds of their
  // shortlist keys (ad, index) for the select
  auto akey_of = [](float ad_r, int idx) {
    return (static_cast<unsigned long long>(ordered_bits(ad_r)) << 32) | static_cast<uint32_t>(idx);
  };
  auto akey = [&](int r) { return akey_of(ad[r], comp[r]); };
  const T* qdata = static_cast<const T*>(a.qdata);
  unsigned long long key_lo = NO_KEY, key_hi = 0;
  int keys_here = 0;
  for (int r0 = threadIdx.x; r0 < nc; r0 += APPROX_ROWS * E_THREADS) {
    const T* rows[APPROX_ROWS];
    bool live[APPROX_ROWS];
    float2 m[APPROX_ROWS];
    float scale[APPROX_ROWS], e[APPROX_ROWS];
#pragma unroll
    for (int i = 0; i < APPROX_ROWS; ++i) {
      live[i] = r0 + i * E_THREADS < nc;
      const int idx = live[i] ? min(max(comp[r0 + i * E_THREADS], 0), n1) : 0;
      rows[i] = qdata + static_cast<size_t>(idx) * d;
      m[i] = live[i] ? a.meta[idx] : make_float2(0.0f, 0.0f);
      scale[i] = m[i].x;
    }
    approx_l1(rows, live, scale, qs, d, e);
#pragma unroll
    for (int i = 0; i < APPROX_ROWS; ++i) {
      const int r = r0 + i * E_THREADS;
      if (r < nc) {
        ad[r] = e[i];
        qerr[r] = m[i].y;
        const unsigned long long key = akey_of(e[i], comp[r]);
        key_lo = min(key_lo, key);
        key_hi = max(key_hi, key);
        ++keys_here;
      }
    }
  }
  __syncthreads();

  // shortlist: the keys up to the cr-th smallest (ad, index)
  unsigned long long last = NO_KEY;  // the largest shortlisted key
  if (nc > cr) {
    last = block_select(
        [&](int r, unsigned long long& v) {
          v = akey(r);
          return true;
        },
        nc, cr - 1, sel, key_lo, key_hi, keys_here);
  }
  const int ns = min(nc, cr);
  {
    int mine = 0;
    for (int r = threadIdx.x; r < nc; r += E_THREADS) mine += akey(r) <= last;
    int off = block_exclusive_scan<E_WARPS>(mine, warp_sums);
    for (int r = threadIdx.x; r < nc; r += E_THREADS)
      if (akey(r) <= last) sidx[off++] = min(max(comp[r], 0), n1);
    __syncthreads();
  }

  // exact rerank of the shortlisted rows with kernel D's L1: each warp takes
  // RERANK_ROWS of them at a time, all their loads in flight together
  for (int base = warp * RERANK_ROWS; base < ns; base += E_WARPS * RERANK_ROWS) {
    const float* rows[RERANK_ROWS];
#pragma unroll
    for (int r = 0; r < RERANK_ROWS; ++r)
      rows[r] = a.data + static_cast<size_t>(sidx[min(base + r, ns - 1)]) * d;
    float e[RERANK_ROWS];
    l1_warp_rows(rows, qs, d, e);
    if (lane < RERANK_ROWS && base + lane < ns) {
#pragma unroll
      for (int r = 0; r < RERANK_ROWS; ++r)
        if (r == lane) ed[base + r] = e[r];
    }
  }
  __syncthreads();

  // exact top-k over the shortlist, ties to the lowest index
  const size_t o = static_cast<size_t>(qi) * k;
  if (k <= TOPK_MAX && cr <= TOPK_MAX) {  // a key a lane: sort them in warp 0
    if (warp == 0) {
      const unsigned long long key =
          warp_sort32(lane < ns ? topk_key(ed[lane], sidx[lane]) : NO_KEY);
      if (lane < k) {
        a.kd[o + lane] = key_dist(key);
        a.ki[o + lane] = key_pos(key);
      }
      if (lane == k - 1) dk_s = key_dist(key);
    }
    __syncthreads();
  } else {
    for (int i = threadIdx.x; i < ns; i += E_THREADS) keys[i] = topk_key(ed[i], sidx[i]);
    block_topk_sorted(keys, ns, k, [&](int r, float dv, int pos) {
      a.kd[o + r] = dv;
      a.ki[o + r] = pos;
      if (r == k - 1) dk_s = dv;
    });
  }

  // rerank-margin misses against the k-th exact distance
  const float dk = dk_s;
  int local = 0;
  for (int r = threadIdx.x; r < nc; r += E_THREADS)
    local += akey(r) > last && __fsub_rn(ad[r], qerr[r]) <= dk;
  block_exclusive_scan<E_WARPS>(local, warp_sums);
  if (threadIdx.x == 0) {
    a.comparisons[qi] = total;
    a.overflow[qi] = max(total - a.c_comp, 0);
    a.misses[qi] = warp_sums[E_WARPS - 1];
  }
}

template <class T>
static int launch(const PayloadArgs& a, int Q, void* stream) {
  if (Q <= 0) return static_cast<int>(cudaGetLastError());
  const PayloadLayout lay(a.h_cap, a.c_comp, a.cr, a.k, a.d);
  const bool ok = a.C >= 1 && a.n >= 1 && a.c_comp >= 1 && a.cr >= 1 && a.k >= 1 &&
                  a.h_cap >= E_THREADS && (a.h_cap & (a.h_cap - 1)) == 0 &&
                  a.h_cap >= 2 * a.C && a.ws_bytes >= lay.bytes &&
                  reinterpret_cast<uintptr_t>(a.meta) % 8 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.scratch != nullptr) {
    query_tail_payload_kernel<T, true><<<Q, E_THREADS, 0, st>>>(a);
  } else {
    const int err = allow_dynamic_smem(query_tail_payload_kernel<T, false>, a.ws_bytes);
    if (err != 0) return err;
    query_tail_payload_kernel<T, false><<<Q, E_THREADS, a.ws_bytes, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// h_cap: the hash set's slots (a power of two, at least 2 * C and 256);
// ws_bytes: one query's workspace (PayloadLayout; the wrapper's
// payload_ws_bytes); scratch: null to hold it in shared memory, else Q *
// ws_bytes of device memory. Returns the CUDA error code.
#define PAYLOAD_LAUNCH(NAME, T)                                                          \
  extern "C" int NAME(const float* data, const void* qdata, const float* meta,           \
                      const float* queries, const int* cand, int n, int d, int Q, int C,  \
                      int c_comp, int cr, int k, int h_cap, void* scratch,                \
                      long long ws_bytes, float* kd, int* ki, int* comparisons,           \
                      int* overflow, int* misses, void* stream) {                         \
    const PayloadArgs a{data, qdata, reinterpret_cast<const float2*>(meta), queries,      \
                        cand, n, d, C, c_comp, cr, k, h_cap,                               \
                        static_cast<unsigned char*>(scratch), static_cast<size_t>(ws_bytes), \
                        kd, ki, comparisons, overflow, misses};                            \
    return launch<T>(a, Q, stream);                                                        \
  }

PAYLOAD_LAUNCH(query_tail_payload_f16_launch, __half)
PAYLOAD_LAUNCH(query_tail_payload_i8_launch, int8_t)
