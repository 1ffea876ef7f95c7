// Flash attention, forward (kernel F of the port): online-softmax GQA
// attention with causal, sliding-window, kv-length and q-offset masks, on
// the tensor cores.
//
// Replaces the JAX package's repro/kernels/flash_attention/flash_attention.py:
// flash_attention_pallas (_flash_kernel, flash_attention.py:125). For q
// (B, Hq, Sq, dh) and k, v (B, Hkv, Skv, dh), query row i of batch row b
// sits at position q_offset[b] + i and may see key j when j < kv_len[b],
// j <= q position (causal) and j > q position - window (window > 0). Output
// o = softmax(q k^T / sqrt(dh)) v per (b, q-head), with q-head h reading
// kv-head h / (Hq / Hkv); a row that sees no key gives 0.
//
// Differences from the Pallas kernel, all of them its calling convention:
// q_offset and kv_len are per-row int32 device arrays, so one launch serves
// a prefill (equal offsets) and a batched decode step whose rows each have
// their own cache length; the kernel masks the ragged edges of Sq, Skv and
// dh itself instead of taking operands padded to its tiles; operands are
// read by their strides, so the model passes transposed views of its
// (B, S, H, dh) activations and of its (B, S_max, Hkv, dh) cache.
//
// What bounds it on an H100: the work is 4 * B * Hq * (visible q-k pairs)
// * dh flops (two products) and the bytes are q, k, v read once and o
// written once. The datastore pass (B = 8, Hq = 32, Hkv = 8, S = 1,024,
// dh = 128, causal) is 69 GFLOP against 42 MB: bound by operations, about
// 70 us at the card's 989 TFLOP/s bf16 tensor-core rate. A decode step
// (Sq = 1) and the other short-q shapes are bound by the bytes of the cache
// they read.
//
// Design: a block is two warpgroups (8 warps, 256 threads); each
// warpgroup owns a 64-row q-tile, and the two share every K and V tile;
// the loop over 64-key tiles runs inside the block.
// 1. Both products on the tensor cores with Hopper's warpgroup MMA
//    (wgmma.mma_async, bf16 operands, float32 accumulation): S = Q K^T with
//    Q and K read from shared memory through matrix descriptors
//    (m64n64k16), and O += P V with P from registers and V from shared
//    memory, transposed by the instruction (m64nNk16, N = 64, 32 or 16 per
//    call). Each warp holds 16 rows of S and of O in the mma fragment
//    layout, so the scores stay in registers: after the softmax they become
//    P's A fragments directly, and the row max and row sum are reduced
//    across the 4 threads of a quad with __shfl_xor_sync. Tiles are stored
//    in shared memory as 8-row x 16-byte core matrices (no swizzle), the
//    layout wgmma reads without bank conflicts. S is written by wgmma
//    alone and copied out before the softmax: a wgmma accumulator register
//    that another instruction defines makes ptxas serialize every wgmma.
//    P is split as hi + lo, two bf16 values (P - hi rounds to lo), and P V
//    is two products, hi V + lo V. One bf16 P (as a library kernel does)
//    moves a row's output by up to 2^-8 * sum_j w_j |v_j|, which on a row
//    with a few visible keys reaches several 1e-3 and breaks the per-element
//    check against the float32 plain version; hi + lo leaves 2^-16.
// 2. K and V are staged by cp.async, 16 bytes per thread, in a ring of two
//    slots: after one barrier per tile, tile t + 1 is copied while tile t's
//    products and softmax run. A block holds two Q tiles and four K/V
//    tiles (96 KB at dh = 128, so two blocks share an SM; 192 KB at
//    dh = 256). cp.async needs 16-byte
//    rows (dh % 8 == 0, every stride % 8 == 0, aligned base pointers);
//    where that does not hold, the same kernel stages the tiles by plain
//    loads. A head_dim that is not a multiple of 16 is zero-filled in shared
//    memory, so any dh in [1, 256] is taken; keys at or past kv_len are
//    zero-filled.
// 3. Scores are scaled in float32 after the product: p = exp2(s * (scale *
//    log2 e) - m * (scale * log2 e)). Q is never scaled and rounded to bf16
//    before the product, which would add an error the plain version lacks.
//    The output is rescaled only when a row max of the warp moved.
// 4. GQA: the grid is (ceil(row tiles / 2), Hkv, B), and a block's rows all
//    belong to one kv-head. At Sq >= 64, row tile u is q-head u % group at
//    positions [64 (u / group), + 64), so a block's two warpgroups take two
//    q-heads of the group at the same positions and read each K/V tile
//    once for both. When Sq < 64 (decode, a short prefill, the q_offset
//    case) the rows are packed: the (q-head in the group, q row) pairs of
//    the kv-head in order, 64 per row tile, so each K/V tile is read once
//    for the whole group and a decode tile has `group` busy rows instead of
//    one. Masks use each row's own q position. The key loop starts at the
//    block's window edge and stops at its causal edge; only the tiles on an
//    edge are masked.
#include "common.cuh"

#include <cuda_bf16.h>

#include <initializer_list>

constexpr int FA_WGS = 2;                 // warpgroups per block, sharing K and V
constexpr int FA_BQ = 64;                 // query rows per warpgroup: wgmma's M
constexpr int FA_BK = 64;                 // keys per tile
constexpr int FA_THREADS = 128 * FA_WGS;  // 4 warps per warpgroup, 16 rows each
constexpr int FA_DH_MAX = 256;

using T = __nv_bfloat16;  // q, k, v and o: bf16 in, bf16 out, as on the model path

__host__ __device__ constexpr size_t fa_smem_bytes(int dhp) {
  return static_cast<size_t>(FA_WGS * FA_BQ + 4 * FA_BK) * dhp * sizeof(T);  // Q, K x2, V x2
}

// Two blocks share an SM wherever their shared memory fits (dh <= 128): the
// registers are then capped at 128 a thread, which costs no spill there,
// and the second block's warps hide the first one's waits.
__host__ __device__ constexpr int fa_min_blocks(int dhp) {
  return 2 * fa_smem_bytes(dhp) <= 227 * 1024 ? 2 : 1;
}

struct Strides {
  long long b, h, s;  // elements; the last (dh) axis is contiguous
};

struct Args {
  const T* q;
  const T* k;
  const T* v;
  T* o;
  Strides qs, ks, vs, os;
  int Hq, Hkv, Sq, Skv, dh;
  float scale_log2;  // 1/sqrt(dh) * log2(e)
  int causal, window;
  int packed;  // rows are (q-head in group, q row) pairs of one kv-head
  int vec;     // 16-byte rows and pointers: stage by cp.async
  const int* q_offset;
  const int* kv_len;
};

// ---------------------------------------------------------------- wgmma

// Matrix descriptor of a shared tile of 8-row x 16-byte core matrices with
// no swizzle: lbo and sbo are the byte distances between core matrices
// along the leading dimension (K of a K-major operand, K of an MN-major
// one) and along the other.
__device__ inline uint64_t fa_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

__device__ inline void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ inline void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ inline void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pin accumulator registers across a wgmma pipeline stage, so the compiler
// moves none of them between the wgmma that writes them and the wait.
__device__ inline void reg_fence(float* r, int n) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// make this thread's cp.async and st.shared writes visible to wgmma's reads
__device__ inline void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 x 64 per warpgroup, 32 per thread) = A (smem, K-major) *
// B (smem, K-major) [+ d when acc]
__device__ inline void wg_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x N) += A (registers: each warp's mma A fragment of its 16 rows) *
// B (smem, MN-major, transposed by the instruction), N = 64, 32 or 16
__device__ inline void wg_rs_n64(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ inline void wg_rs_n32(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ inline void wg_rs_n16(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---------------------------------------------------------------- helpers

__device__ inline float fa_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ inline uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// p as hi + lo: hi = bf16(p), lo = bf16(p - hi), two values per register
__device__ inline void split_bf16(float p0, float p1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(p0 - __low2float(h), p1 - __high2float(h));
}

// Row r of row tile u of kv-head hk -> (q-head, q row); false past the
// last row. Packed (Sq < 64): the tiles cut the (q-head in group, q row)
// pairs in order. Otherwise tile u holds rows [64 (u / group), + 64) of
// q-head u % group, so the tiles of one block share their rows' positions.
__device__ inline bool fa_row(const Args& a, int u, int r, int hk, int& head, int& i) {
  const int group = a.Hq / a.Hkv;
  if (a.packed) {
    const int t = u * FA_BQ + r;
    head = hk * group + t / a.Sq;
    i = t % a.Sq;
    return t < group * a.Sq;
  }
  head = hk * group + u % group;
  i = (u / group) * FA_BQ + r;
  return i < a.Sq;
}

// The q rows [lo, hi] of row tile u; false for a tile past the last.
__device__ inline bool fa_tile_rows(const Args& a, int u, int& lo, int& hi) {
  const int group = a.Hq / a.Hkv;
  if (a.packed) {
    const int n = group * a.Sq;
    const int t0 = u * FA_BQ, t1 = min(t0 + FA_BQ, n) - 1;
    const bool one = t0 / a.Sq == t1 / a.Sq;
    lo = one ? t0 % a.Sq : 0;
    hi = one ? t1 % a.Sq : a.Sq - 1;
    return t0 < n;
  }
  lo = (u / group) * FA_BQ;
  hi = min(lo + FA_BQ, a.Sq) - 1;
  return lo < a.Sq;
}

// Stage NR rows of width dh into a shared tile of padded width DHP, stored
// as core matrices: row r, 16-byte chunk c at byte (r / 8) * DHP * 16 +
// c * 128 + (r % 8) * 16. src(r) is row r's first element, or nullptr for
// a row to zero-fill; columns [dh, DHP) are zero-filled. Each 8 threads in
// turn fill one core matrix (128 contiguous bytes).
template <int DHP, int NR, class RowPtr>
__device__ inline void fa_stage(T* dst, int dh, bool vec, RowPtr src) {
  constexpr int CH = DHP / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < NR * CH; idx += FA_THREADS) {
    const int q = idx & 7;
    const int c = (idx >> 3) % CH;
    const int band = (idx >> 3) / CH;
    const T* row = src(band * 8 + q);
    T* d = dst + band * DHP * 8 + c * 64 + q * 8;
    if (vec) {
      const bool in = row != nullptr && c * 8 < dh;
      cp_async16(smem_addr(d), in ? row + c * 8 : dst, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = (row != nullptr && c * 8 + e < dh) ? row[c * 8 + e] : __float2bfloat16_rn(0.0f);
    }
  }
}

// The same layout for a K or V tile of 64 keys from k0 (row key at
// base + key * stride); keys from kl on are zero-filled.
template <int DHP>
__device__ inline void fa_stage_kv(T* dst, const T* base, long long stride, int k0, int kl,
                                   int dh, bool vec) {
  fa_stage<DHP, FA_BK>(dst, dh, vec, [&](int r) -> const T* {
    return k0 + r < kl ? base + (k0 + r) * stride : nullptr;
  });
}

template <int DHP>
__global__ void __launch_bounds__(FA_THREADS, fa_min_blocks(DHP)) flash_attention_kernel(const Args a) {
  static_assert(DHP % 16 == 0 && DHP % 64 != 48, "P V runs in column chunks of 64, 32 and 16");
  constexpr int KS = DHP / 16;         // k-steps of Q K^T
  constexpr int NO = DHP / 8;          // n-tiles of the output
  constexpr uint32_t BAND = DHP * 16;  // bytes of an 8-row band of a tile
  extern __shared__ __align__(128) unsigned char fa_smem[];
  T* Qs = reinterpret_cast<T*>(fa_smem);
  T* Ks = Qs + FA_WGS * FA_BQ * DHP;  // two slots
  T* Vs = Ks + 2 * FA_BK * DHP;  // two slots

  const int tid = threadIdx.x;
  const int wg = tid >> 7;           // this thread's warpgroup and row tile
  const int warp = (tid >> 5) & 3;   // warp within the warpgroup
  const int lane = tid & 31;
  const int g = lane >> 2;  // row within the 8-row half of an mma tile
  const int tq = lane & 3;  // thread within the quad
  const int b = blockIdx.z;
  const int hk = blockIdx.y;
  const int u = blockIdx.x * FA_WGS + wg;
  const int qo = a.q_offset[b];
  const int kl = min(a.kv_len[b], a.Skv);

  // the range of q rows in the block's tiles, and the keys any of them may see
  int i_lo = INT_MAX, i_hi = -1;
#pragma unroll
  for (int w = 0; w < FA_WGS; ++w) {
    int lo_w, hi_w;
    if (fa_tile_rows(a, blockIdx.x * FA_WGS + w, lo_w, hi_w)) {
      i_lo = min(i_lo, lo_w);
      i_hi = max(i_hi, hi_w);
    }
  }
  int hi = kl;
  if (a.causal) hi = min(hi, qo + i_hi + 1);
  const int lo = a.window > 0 ? max(0, qo + i_lo - a.window + 1) : 0;
  const int k_first = (lo / FA_BK) * FA_BK;
  const int n_tiles = hi > k_first ? (hi - k_first + FA_BK - 1) / FA_BK : 0;

  // this thread's two rows (g and g + 8 of its warp's 16) and positions
  const int r0 = warp * 16 + g;
  int head0, i0, head1, i1;
  const bool ok0 = fa_row(a, u, r0, hk, head0, i0);
  const bool ok1 = fa_row(a, u, r0 + 8, hk, head1, i1);
  const int qp0 = qo + i0, qp1 = qo + i1;

  const T* kb = a.k + b * a.ks.b + hk * a.ks.h;
  const T* vb = a.v + b * a.vs.b + hk * a.vs.h;
  // K and V rings of two slots each: tile t in slot t % 2
  auto stage_k = [&](int tile) {
    fa_stage_kv<DHP>(Ks + (tile & 1) * FA_BK * DHP, kb, a.ks.s, k_first + tile * FA_BK, kl, a.dh, a.vec);
  };
  auto stage_v = [&](int tile) {
    fa_stage_kv<DHP>(Vs + (tile & 1) * FA_BK * DHP, vb, a.vs.s, k_first + tile * FA_BK, kl, a.dh, a.vec);
  };

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY;  // row max of the raw scores
  float l0 = 0.0f, l1 = 0.0f;            // this thread's part of the row sum
  float s[8][4];                         // S of one tile: 8 n-tiles of 8 keys
  uint32_t ph[4][4], pl[4][4];           // P of one tile as hi + lo A fragments

  // Q and K are K-major (dh chunks 128 bytes apart, 8-row bands BAND
  // apart); V is MN-major in P V (8-key bands BAND apart along K, dh chunks
  // 128 bytes apart along N). Descriptor addresses count 16-byte units.
  const uint64_t dq = fa_desc(smem_addr(Qs + wg * FA_BQ * DHP), 128, BAND);
  const uint64_t dk = fa_desc(smem_addr(Ks), 128, BAND);
  const uint64_t dv = fa_desc(smem_addr(Vs), BAND, 128);
  constexpr uint32_t SLOT = FA_BK * DHP * sizeof(T) / 16;  // a ring slot, in 16-byte units
  auto mma_qk = [&](int tile) {  // S = Q K^T, 16 dh per k-step: two chunks, 256 bytes
    const uint64_t dkt = dk + (tile & 1) * SLOT;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      wg_ss_n64(*reinterpret_cast<float(*)[32]>(&s[0][0]), dq + ks * 16, dkt + ks * 16, ks > 0);
    wg_commit();
  };
  // O += P V in column chunks of 64, 32 and 16 (N); keys 16kk.. are the
  // bands 2kk and 2kk + 1, dh column n the chunk n / 8
  auto mma_pv = [&](int tile) {
    const uint64_t dvt = dv + (tile & 1) * SLOT;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dvk = dvt + kk * 2 * (BAND >> 4);
#pragma unroll
      for (int n0 = 0; n0 < DHP; n0 += 64) {
        const uint64_t dvn = dvk + n0 / 8 * (128 >> 4);
        float* d = &acc[n0 / 8][0];
        if (DHP - n0 >= 64) {
          wg_rs_n64(d, ph[kk], dvn);
          wg_rs_n64(d, pl[kk], dvn);
        } else if (DHP - n0 == 32) {
          wg_rs_n32(d, ph[kk], dvn);
          wg_rs_n32(d, pl[kk], dvn);
        } else {
          wg_rs_n16(d, ph[kk], dvn);
          wg_rs_n16(d, pl[kk], dvn);
        }
      }
    }
    wg_commit();
  };

  // Per tile: one barrier, after which K and V of the next tile are copied
  // into the other ring slots while this tile's products and softmax run.
  fa_stage<DHP, FA_WGS * FA_BQ>(Qs, a.dh, a.vec, [&](int r) -> const T* {
    int head, i;
    if (!fa_row(a, blockIdx.x * FA_WGS + r / FA_BQ, r % FA_BQ, hk, head, i)) return nullptr;
    return a.q + b * a.qs.b + head * a.qs.h + i * a.qs.s;
  });
  if (n_tiles > 0) {
    stage_k(0);
    stage_v(0);
  }
  cp_async_commit();

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_first + it * FA_BK;
    // K and V of tile it have landed; every warp is done with tile it - 1,
    // whose slots take tile it + 1
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();
    if (it + 1 < n_tiles) {
      stage_k(it + 1);
      stage_v(it + 1);
    }
    cp_async_commit();

    reg_fence(&s[0][0], 32);
    mma_qk(it);
    wg_wait<0>();
    reg_fence(&s[0][0], 32);

    // the scores into p (s is written by wgmma alone: an accumulator
    // register defined by another instruction makes ptxas serialize every
    // wgmma), masked only on a tile that crosses an edge
    float p[8][4];
    const bool edge = k0 + FA_BK > kl || (a.causal && k0 + FA_BK - 1 > qo + i_lo) ||
                      (a.window > 0 && k0 <= qo + i_hi - a.window);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[j][e] = s[j][e];
        if (edge) {
          const int kp = k0 + j * 8 + 2 * tq + (e & 1);
          const int qp = e < 2 ? qp0 : qp1;
          bool ok = kp < kl;
          if (a.causal) ok = ok && kp <= qp;
          if (a.window > 0) ok = ok && kp > qp - a.window;
          if (!ok) p[j][e] = -INFINITY;
        }
      }

    // online softmax over the two rows, reduced across the quad
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(p[j][0], p[j][1]));
      mx1 = fmaxf(mx1, fmaxf(p[j][2], p[j][3]));
    }
#pragma unroll
    for (int sh = 1; sh <= 2; sh <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float mu0 = mn0 == -INFINITY ? 0.0f : mn0;  // the row sees nothing yet
    const float mu1 = mn1 == -INFINITY ? 0.0f : mn1;
    const float c0 = fa_exp2((m0 - mu0) * a.scale_log2);
    const float c1 = fa_exp2((m1 - mu1) * a.scale_log2);
    const float nb0 = -mu0 * a.scale_log2, nb1 = -mu1 * a.scale_log2;
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      p[j][0] = fa_exp2(fmaf(p[j][0], a.scale_log2, nb0));
      p[j][1] = fa_exp2(fmaf(p[j][1], a.scale_log2, nb0));
      p[j][2] = fa_exp2(fmaf(p[j][2], a.scale_log2, nb1));
      p[j][3] = fa_exp2(fmaf(p[j][3], a.scale_log2, nb1));
      sum0 += p[j][0] + p[j][1];
      sum1 += p[j][2] + p[j][3];
    }
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
    reg_fence(&acc[0][0], 4 * NO);
    if (__any_sync(0xffffffffu, c0 != 1.0f || c1 != 1.0f)) {  // a row max of the warp moved
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        acc[j][0] *= c0;
        acc[j][1] *= c0;
        acc[j][2] *= c1;
        acc[j][3] *= c1;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // P, 16 keys per k-step
      split_bf16(p[2 * kk][0], p[2 * kk][1], ph[kk][0], pl[kk][0]);
      split_bf16(p[2 * kk][2], p[2 * kk][3], ph[kk][1], pl[kk][1]);
      split_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1], ph[kk][2], pl[kk][2]);
      split_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3], ph[kk][3], pl[kk][3]);
    }
    reg_fence(&acc[0][0], 4 * NO);
    mma_pv(it);
    wg_wait<0>();
    reg_fence(&acc[0][0], 4 * NO);
  }
  cp_async_wait<0>();  // Q's group, when no tile was visited

#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
    l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
  }
  const float inv0 = l0 > 0.0f ? 1.0f / l0 : 0.0f;
  const float inv1 = l1 > 0.0f ? 1.0f / l1 : 0.0f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (!(half ? ok1 : ok0)) continue;
    const int head = half ? head1 : head0;
    const int i = half ? i1 : i0;
    const float inv = half ? inv1 : inv0;
    T* orow = a.o + b * a.os.b + head * a.os.h + i * a.os.s;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int c = j * 8 + 2 * tq;
      const float x0 = acc[j][2 * half] * inv, x1 = acc[j][2 * half + 1] * inv;
      if (a.vec && c + 1 < a.dh) {
        *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(x0, x1);
      } else {
        if (c < a.dh) orow[c] = __float2bfloat16_rn(x0);
        if (c + 1 < a.dh) orow[c + 1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

template <int DHP>
static int launch_dhp(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = fa_smem_bytes(DHP);
  const int err = allow_dynamic_smem(flash_attention_kernel<DHP>, smem);
  if (err != 0) return err;
  const int group = a.Hq / a.Hkv;
  const int tiles = a.packed ? (group * a.Sq + FA_BQ - 1) / FA_BQ
                             : (a.Sq + FA_BQ - 1) / FA_BQ * group;
  const dim3 grid((tiles + FA_WGS - 1) / FA_WGS, a.Hkv, B);
  flash_attention_kernel<DHP><<<grid, FA_THREADS, smem, stream>>>(a);
  return 0;
}

static bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

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
    Args a{};
    a.q = static_cast<const T*>(q);
    a.k = static_cast<const T*>(k);
    a.v = static_cast<const T*>(v);
    a.o = static_cast<T*>(o);
    a.qs = {qsb, qsh, qss};
    a.ks = {ksb, ksh, kss};
    a.vs = {vsb, vsh, vss};
    a.os = {osb, osh, oss};
    a.Hq = Hq;
    a.Hkv = Hkv;
    a.Sq = Sq;
    a.Skv = Skv;
    a.dh = dh;
    a.scale_log2 = scale * 1.4426950408889634f;
    a.causal = causal;
    a.window = window;
    a.packed = Sq < FA_BQ;
    bool vec = dh % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o);
    for (long long s : {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss})
      vec = vec && s % 8 == 0;
    a.vec = vec;
    a.q_offset = q_offset;
    a.kv_len = kv_len;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int err = dh <= 16    ? launch_dhp<16>(a, B, st)
                    : dh <= 32  ? launch_dhp<32>(a, B, st)
                    : dh <= 64  ? launch_dhp<64>(a, B, st)
                    : dh <= 80  ? launch_dhp<80>(a, B, st)
                    : dh <= 96  ? launch_dhp<96>(a, B, st)
                    : dh <= 128 ? launch_dhp<128>(a, B, st)
                    : dh <= 192 ? launch_dhp<192>(a, B, st)
                                : launch_dhp<256>(a, B, st);
    if (err != 0) return err;
  }
  return static_cast<int>(cudaGetLastError());
}
