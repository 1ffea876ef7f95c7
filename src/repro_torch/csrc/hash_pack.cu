// Signature packing for both LSH families (kernels A and B of the port).
//
// bitsample_pack (A) replaces the JAX package's
//   repro/kernels/hash_pack/hash_pack.py: bitsample_gather_pallas and
//   bitsample_gather_margins_pallas (_bitsample_gather_kernel,
//   _bitsample_gather_margins_kernel):
//   words = pack32(x[:, dims] > thrs), margins = |x[:, dims] - thrs|.
// proj_sign_pack (B) replaces
//   hash_pack.py: hash_pack_pallas and hash_pack_margins_pallas
//   (_hash_pack_kernel, _hash_pack_margins_kernel):
//   s = x @ P + bias, words = pack32(s >= 0 & col % m_pad < m), margins = |s|.
//
// Columns are the whole family's: table t owns [t*m_pad, (t+1)*m_pad), with
// m_pad a multiple of 32, so word w of row r packs columns [32w, 32w+32).
//
// A: what bounds it on an H100 is device-memory bytes (one compare per
// column, only the sampled coordinates of a row needed) and, at the paths'
// small shapes (a 50-row query chunk, the kNN-LM hook's one row), the
// launch itself. One launch writes the int64 words the callers use (32
// bits zero-extended), so no widening pass follows. A block loads the
// family's dims and thrs into shared memory once and takes tiles of one
// row per warp; the rows per block follow T (one warp per block for a
// 50-row chunk, so it spreads over 50 SMs; eight for a build chunk), and a
// grid of at most HP_A_GRID blocks walks the tiles. Where a row has no
// more coordinates than the family has columns (d = 30 against 128), the
// tile, one contiguous span of rows, arrives by cp.async (16-byte copies
// where aligned); wider rows (d = 4,096 against 64 columns) are gathered
// at their sampled coordinates only. A warp packs a row's words by
// __ballot_sync, lane j evaluating column 32w + j, and writes them in one
// coalesced store. A only gathers, compares and subtracts: bit-exact with
// the plain version.
//
// B: 2*d flops per (row, real column) and x read once. At the inner
// family's widths (48 real columns) it is bound by operations at d = 4,096
// and by bytes at d = 30; for one row (a decode step's kNN-LM hook) by
// reading P once (d * 48 floats).
//
// B's summation order, the same for every row whatever the batch: d is cut
// into slices of HP_SLICE floats; within a slice a sequential fmaf chain
// from 0 over the slice's elements in ascending order gives the partial
// p_k; the partials are folded left in ascending slice order,
// s = ((p_0 + p_1) + p_2) + ..., and then s + bias. Both paths below
// compute exactly this, so a vector gets the same bits in a batch of 1,024
// (the build) and alone (a query, the hook). With a one-hot P and bias
// -thr, every product but one is an exact zero, so s == x[dim] - thr bit
// for bit: B reproduces A's margins, and A's words wherever x[dim] != thr.
// In IEEE float32 on the CUDA cores, never TF32: one sign flip changes a
// bucket key.
//
// Only the columns that can set a bit are computed: real columns
// c -> (c / m) * m_pad + c % m in words mode (48 of the inner family's
// 128), every column in margins mode. A block takes a chunk of HP_CHUNK
// physical columns (whole words) and the chunk's computed columns.
// - Batches: a tiled SIMT GEMM. A block takes 16 * RT rows; each of its 256
//   threads keeps RT rows x CC columns in registers (RT = 4 once the rows
//   fill HP_BATCH_TALL_BLOCKS blocks of 64, else 1, so that a batch of
//   1,024 still spreads over 64 SMs). The loop runs over d slice by slice;
//   cp.async stages the x tile (rows x HP_SLICE) and the P tile (HP_SLICE x
//   computed columns) in a two-stage ring, so one slice's copy overlaps the
//   previous slice's products.
// - Few rows: a thread-block cluster of HP_CLUSTER blocks takes R rows
//   (4, or 16 from 16 rows on where the partials fit) and cuts d into
//   HP_CLUSTER contiguous ranges of slices, one per block. A block's 16
//   warps take one slice each per round; its lanes take the computed
//   columns, P is read once per cluster with coalesced loads, all of a
//   slice's loads in flight at once, and x arrives by shuffles. Every
//   slice's partials stay in their block's shared memory, and block 0
//   folds them in ascending order through distributed shared memory.
// Both end with s in shared memory and each warp packing a row's words by
// __ballot_sync; columns that are not real give 0 bits. The entry point
// takes the few-row path below HP_FEW_MAX_T rows when d spans more than one
// slice: the crossover measured on the card (PERF.md, section 6: at
// d = 4,096 the two paths' device times meet between 256 and 1,024 rows).
#include "common.cuh"

#include <cooperative_groups.h>

#include <algorithm>

namespace cg = cooperative_groups;

constexpr int HP_A_GRID = 132 * 8;   // A: most blocks a launch takes
constexpr size_t HP_A_SMEM = 48 * 1024;  // A: a block's columns and row tile
constexpr int HP_THREADS = 256;  // 8 warps

constexpr int HP_SLICE = 32;        // B: floats of d per slice of the summation order
constexpr int HP_CHUNK = 128;       // B: physical columns per block (4 words)
constexpr int HP_BATCH_TALL_BLOCKS = 264;  // B batch path: 64-row blocks from this many, else 16
constexpr int HP_XS = HP_SLICE + 4; // B batch path: x tile row stride (floats)
constexpr int HP_FEW_ROWS = 4;      // B few-row path: rows per cluster
constexpr int HP_FEW_ROWS_WIDE = 16; // B few-row path: rows per cluster from 16 rows, where they fit
constexpr int HP_FEW_THREADS = 512; // B few-row path: 16 warps, one slice each per round
constexpr int HP_CLUSTER = 8;       // B few-row path: blocks per cluster, each a range of slices
constexpr size_t HP_FEW_SMEM = 200 * 1024;  // B few-row path: partials a block may hold
constexpr int HP_FEW_MAX_T = 512;   // B: the few-row path below this many rows

// cp.async of the floats [0, cnt) of src into dst, where dst sits at the
// same offset from a 16-byte boundary as src: 4-byte copies to the first
// boundary and after the last, 16-byte copies between.
__device__ inline void stage_span(float* dst, const float* src, int cnt) {
  const int head = min(cnt, static_cast<int>((16 - reinterpret_cast<uintptr_t>(src) % 16) % 16 / 4));
  const int body = (cnt - head) >> 2;
  for (int i = threadIdx.x; i < head; i += blockDim.x)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst + i)), "l"(src + i));
  for (int i = threadIdx.x; i < body; i += blockDim.x)
    cp_async16(smem_addr(dst + head + 4 * i), src + head + 4 * i, 16);
  for (int i = head + 4 * body + threadIdx.x; i < cnt; i += blockDim.x)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst + i)), "l"(src + i));
}

__global__ void __launch_bounds__(HP_THREADS)
bitsample_pack_kernel(const float* __restrict__ x, const int* __restrict__ dims,
                      const float* __restrict__ thrs, int T, int d, int M,
                      bool staged, unsigned long long* __restrict__ words,
                      float* __restrict__ margins) {
  extern __shared__ __align__(16) float bp_smem[];
  int* ds = reinterpret_cast<int*>(bp_smem);  // M sampled coordinates
  float* ts = bp_smem + M;                    // M thresholds
  float* tile = bp_smem + 2 * M + 4;          // a row per warp, staged
  const int nw = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int W = M >> 5;
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    ds[i] = dims[i];
    ts[i] = thrs[i];
  }
  for (int row0 = blockIdx.x * nw; row0 < T; row0 += gridDim.x * nw) {
    const int rows = min(nw, T - row0);
    const float* src = x + static_cast<size_t>(row0) * d;
    // the span lands at src's offset from a 16-byte boundary
    float* span = tile + (reinterpret_cast<uintptr_t>(src) % 16) / 4;
    if (staged) {
      __syncthreads();  // the previous tile is read
      stage_span(span, src, rows * d);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    if (warp < rows) {
      const size_t t = static_cast<size_t>(row0 + warp);
      const float* xr = staged ? span + warp * d : src + warp * d;
      for (int wb = 0; wb < W; wb += 32) {
        const int nwd = min(32, W - wb);
        unsigned long long mine = 0;
        for (int i = 0; i < nwd; ++i) {
          const int col = ((wb + i) << 5) + lane;
          const float g = xr[ds[col]];
          const float th = ts[col];
          const unsigned bits = __ballot_sync(0xffffffffu, g > th);
          if (lane == i) mine = bits;
          if (margins != nullptr) margins[t * M + col] = fabsf(g - th);
        }
        if (lane < nwd) words[t * W + wb + lane] = mine;
      }
    }
  }
}

// ------------------------------------------------------------------ B

struct SignArgs {
  const float* x;     // (T, d)
  const float* P;     // (d, M)
  const float* bias;  // (M,)
  int T, d, M, m, m_pad;
  int mc;             // computed columns per table: m (words) or m_pad (margins)
  uint32_t* words;    // (T, M / 32)
  float* margins;     // (T, M) or nullptr
  bool vec_x, vec_p;  // 16-byte cp.async for the x / P tiles
};

// computed columns of the family before physical column pc
__host__ __device__ inline int hp_computed_before(int pc, int mc, int m_pad) {
  const int o = pc % m_pad;
  return (pc / m_pad) * mc + (o < mc ? o : mc);
}

// physical column of computed column c
__host__ __device__ inline int hp_physical(int c, int mc, int m_pad) {
  return (c / mc) * m_pad + c % mc;
}

__device__ inline void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

// Pack the block's s tile (st[r * ld + k], k the computed column less c_lo)
// into words (and margins): each warp takes rows, and a row's words.
__device__ inline void hp_pack(const SignArgs& a, const float* st, int ld, int rows,
                               int row0, int p0, int p1, int c_lo) {
  constexpr int NWMAX = HP_CHUNK / 32;
  const int W = a.M >> 5;
  const int nwords = (p1 - p0) >> 5;
  const int lane = threadIdx.x & 31;
  int kw[NWMAX];  // this lane's column of each word: its place in st, or -1
  bool real[NWMAX];
#pragma unroll
  for (int w = 0; w < NWMAX; ++w) {
    const int pc = p0 + 32 * w + lane;
    const int o = pc % a.m_pad;
    real[w] = o < a.m;
    kw[w] = o < a.mc ? hp_computed_before(pc, a.mc, a.m_pad) - c_lo : -1;
  }
  for (int r = threadIdx.x >> 5; r < rows; r += blockDim.x >> 5) {
    const size_t t = static_cast<size_t>(row0 + r);
#pragma unroll
    for (int w = 0; w < NWMAX; ++w) {
      if (w < nwords) {
        const float s = kw[w] >= 0 ? st[r * ld + kw[w]] : 0.0f;
        const unsigned bits = __ballot_sync(0xffffffffu, real[w] && s >= 0.0f);
        if (lane == 0) a.words[t * W + (p0 >> 5) + w] = bits;
        if (a.margins != nullptr) a.margins[t * a.M + p0 + 32 * w + lane] = fabsf(s);  // mc == m_pad
      }
    }
  }
}

// Batch path: 16 * RT rows x the chunk's computed columns; each of 256
// threads keeps RT rows x CC columns (k = tx + 16 * cc) in registers.
template <int RT, int CC>
__global__ void __launch_bounds__(HP_THREADS) proj_sign_batch_kernel(const SignArgs a) {
  constexpr int BR = 16 * RT;
  constexpr int PS = 16 * CC;  // P tile row stride
  constexpr int XT = BR * HP_XS;
  constexpr int PT = HP_SLICE * PS;
  extern __shared__ __align__(16) float hp_smem[];  // 2 x (x tile, P tile)
  __shared__ int pcol[HP_CHUNK];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int row0 = blockIdx.x * BR;
  const int rows = min(BR, a.T - row0);
  const int p0 = blockIdx.y * HP_CHUNK;
  const int p1 = min(p0 + HP_CHUNK, a.M);
  const int c_lo = hp_computed_before(p0, a.mc, a.m_pad);
  const int cb = hp_computed_before(p1, a.mc, a.m_pad) - c_lo;
  for (int k = tid; k < cb; k += HP_THREADS) pcol[k] = hp_physical(c_lo + k, a.mc, a.m_pad);
  __syncthreads();

  auto stage = [&](int sl, int buf) {
    float* xs = hp_smem + buf * (XT + PT);
    float* ps = xs + XT;
    const int j0 = sl * HP_SLICE;
    if (a.vec_x) {
      for (int i = tid; i < BR * (HP_SLICE / 4); i += HP_THREADS) {
        const int r = i / (HP_SLICE / 4);
        const int j = (i - r * (HP_SLICE / 4)) * 4;
        const bool in = r < rows && j0 + j < a.d;
        cp_async16(smem_addr(xs + r * HP_XS + j),
                   in ? a.x + static_cast<size_t>(row0 + r) * a.d + j0 + j : a.x, in ? 16 : 0);
      }
    } else {
      for (int i = tid; i < BR * HP_SLICE; i += HP_THREADS) {
        const int r = i / HP_SLICE;
        const int j = i - r * HP_SLICE;
        const bool in = r < rows && j0 + j < a.d;
        cp_async4(smem_addr(xs + r * HP_XS + j),
                  in ? a.x + static_cast<size_t>(row0 + r) * a.d + j0 + j : a.x, in ? 4 : 0);
      }
    }
    if (a.vec_p) {  // mc % 4 == 0: four computed columns are four adjacent physical ones
      const int q4 = cb / 4;
      for (int i = tid; i < HP_SLICE * q4; i += HP_THREADS) {
        const int j = i / q4;
        const int k = (i - j * q4) * 4;
        const bool in = j0 + j < a.d;
        cp_async16(smem_addr(ps + j * PS + k),
                   in ? a.P + static_cast<size_t>(j0 + j) * a.M + pcol[k] : a.P, in ? 16 : 0);
      }
    } else {
      for (int i = tid; i < HP_SLICE * cb; i += HP_THREADS) {
        const int j = i / cb;
        const int k = i - j * cb;
        const bool in = j0 + j < a.d;
        cp_async4(smem_addr(ps + j * PS + k),
                  in ? a.P + static_cast<size_t>(j0 + j) * a.M + pcol[k] : a.P, in ? 4 : 0);
      }
    }
  };

  float acc[RT][CC];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int c = 0; c < CC; ++c) acc[i][c] = -0.0f;  // -0 + p == p, bit for bit

  const int n_sl = (a.d + HP_SLICE - 1) / HP_SLICE;
  stage(0, 0);
  cp_async_commit();
  for (int sl = 0; sl < n_sl; ++sl) {
    if (sl + 1 < n_sl) stage(sl + 1, (sl + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // slice sl has landed
    __syncthreads();
    const float* xb = hp_smem + (sl & 1) * (XT + PT) + ty * RT * HP_XS;
    const float* pb = hp_smem + (sl & 1) * (XT + PT) + XT + tx;
    float pr[RT][CC];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int c = 0; c < CC; ++c) pr[i][c] = 0.0f;
    auto step = [&](int j) {
      float xv[RT], pv[CC];
#pragma unroll
      for (int i = 0; i < RT; ++i) xv[i] = xb[i * HP_XS + j];
#pragma unroll
      for (int c = 0; c < CC; ++c) pv[c] = pb[j * PS + 16 * c];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int c = 0; c < CC; ++c) pr[i][c] = fmaf(xv[i], pv[c], pr[i][c]);
    };
    const int jn = min(HP_SLICE, a.d - sl * HP_SLICE);
    if (jn == HP_SLICE) {
#pragma unroll
      for (int j = 0; j < HP_SLICE; ++j) step(j);
    } else {
      for (int j = 0; j < jn; ++j) step(j);
    }
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int c = 0; c < CC; ++c) acc[i][c] = acc[i][c] + pr[i][c];
    __syncthreads();  // this stage is consumed
  }

  float* st = hp_smem;  // BR x PS, over the drained ring
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int c = 0; c < CC; ++c) {
      const int k = tx + 16 * c;
      if (k < cb) st[(ty * RT + i) * PS + k] = acc[i][c] + a.bias[pcol[k]];
    }
  __syncthreads();
  hp_pack(a, st, PS, rows, row0, p0, p1, c_lo);
}

// Few-row path: a cluster of HP_CLUSTER blocks takes R rows x the chunk's
// computed columns, and block q of the cluster the q-th contiguous range of
// `per` slices. Its 16 warps take one slice each per round; lane l takes
// computed columns l + 32 * g, g < CG, for all R rows. Every slice's
// partials stay in their block's shared memory; block 0 of the cluster
// folds them in ascending order, reading the other blocks' through
// distributed shared memory.
template <int R, int CG>
__global__ void __cluster_dims__(HP_CLUSTER, 1, 1) __launch_bounds__(HP_FEW_THREADS)
    proj_sign_few_kernel(const SignArgs a, int per) {
  constexpr int NW = HP_FEW_THREADS / 32;
  constexpr int CBS = 32 * CG;  // partial row stride
  extern __shared__ __align__(16) float hp_smem[];  // part[per][R][CBS], then st[R][CBS]
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = (blockIdx.x / HP_CLUSTER) * R;
  const int rows = min(R, a.T - row0);
  const int p0 = blockIdx.y * HP_CHUNK;
  const int p1 = min(p0 + HP_CHUNK, a.M);
  const int c_lo = hp_computed_before(p0, a.mc, a.m_pad);
  const int cb = hp_computed_before(p1, a.mc, a.m_pad) - c_lo;
  const int n_sl = (a.d + HP_SLICE - 1) / HP_SLICE;
  int pc[CG];
#pragma unroll
  for (int g = 0; g < CG; ++g) {
    const int k = lane + 32 * g;
    pc[g] = k < cb ? hp_physical(c_lo + k, a.mc, a.m_pad) : -1;
  }

  const int s_lo = rank * per;
  const int s_hi = min(s_lo + per, n_sl);
  for (int sl = s_lo + warp; sl < s_hi; sl += NW) {
    const int j0 = sl * HP_SLICE;
    const int jn = min(HP_SLICE, a.d - j0);
    float xr[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      xr[r] = r < rows && lane < jn ? a.x[static_cast<size_t>(row0 + r) * a.d + j0 + lane] : 0.0f;
    float* part = hp_smem + (sl - s_lo) * R * CBS;
#pragma unroll
    for (int g = 0; g < CG; ++g) {
      float pv[HP_SLICE];
#pragma unroll
      for (int j = 0; j < HP_SLICE; ++j)
        pv[j] = pc[g] >= 0 && j < jn ? a.P[static_cast<size_t>(j0 + j) * a.M + pc[g]] : 0.0f;
      float pr[R];
#pragma unroll
      for (int r = 0; r < R; ++r) pr[r] = 0.0f;
#pragma unroll
      for (int j = 0; j < HP_SLICE; ++j) {
        if (j < jn) {  // warp-uniform
#pragma unroll
          for (int r = 0; r < R; ++r)
            pr[r] = fmaf(__shfl_sync(0xffffffffu, xr[r], j), pv[j], pr[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) part[r * CBS + lane + 32 * g] = pr[r];
    }
  }
  cluster.sync();  // every slice's partials are in place

  if (rank == 0) {
    float* st = hp_smem + per * R * CBS;
    for (int i = tid; i < R * CBS; i += HP_FEW_THREADS) {
      const int fr = i / CBS;  // the (row, column) this thread folds
      const int fk = i - fr * CBS;
      if (fr < rows && fk < cb) {
        float acc = -0.0f;  // -0 + p == p, bit for bit
        for (int q = 0; q < HP_CLUSTER; ++q) {
          const float* rp = cluster.map_shared_rank(hp_smem, q);
          const int n = min(per, n_sl - q * per);
          for (int k = 0; k < n; ++k) acc = acc + rp[(k * R + fr) * CBS + fk];
        }
        st[i] = acc + a.bias[hp_physical(c_lo + fk, a.mc, a.m_pad)];
      }
    }
    __syncthreads();
    hp_pack(a, st, CBS, rows, row0, p0, p1, c_lo);
  }
  cluster.sync();  // the other blocks' partials stay until block 0 has read them
}

template <int RT, int CC>
static int launch_batch(const SignArgs& a, int chunks, cudaStream_t stream) {
  const size_t smem = 2 * (16 * RT * HP_XS + HP_SLICE * 16 * CC) * sizeof(float);
  const int err = allow_dynamic_smem(proj_sign_batch_kernel<RT, CC>, smem);
  if (err != 0) return err;
  const dim3 grid((a.T + 16 * RT - 1) / (16 * RT), chunks);
  proj_sign_batch_kernel<RT, CC><<<grid, HP_THREADS, smem, stream>>>(a);
  return 0;
}

template <int RT>
static int launch_batch_cc(const SignArgs& a, int cc, int chunks, cudaStream_t stream) {
  switch (cc) {
    case 1: return launch_batch<RT, 1>(a, chunks, stream);
    case 2: return launch_batch<RT, 2>(a, chunks, stream);
    case 3: return launch_batch<RT, 3>(a, chunks, stream);
    case 4: return launch_batch<RT, 4>(a, chunks, stream);
    case 5: return launch_batch<RT, 5>(a, chunks, stream);
    case 6: return launch_batch<RT, 6>(a, chunks, stream);
    case 7: return launch_batch<RT, 7>(a, chunks, stream);
    default: return launch_batch<RT, 8>(a, chunks, stream);
  }
}

template <int R>
static size_t few_smem(int per, int n_cg) {
  return (static_cast<size_t>(per) + 1) * R * 32 * n_cg * sizeof(float);
}

template <int R, int CG>
static int launch_few(const SignArgs& a, int per, int chunks, cudaStream_t stream) {
  const size_t smem = few_smem<R>(per, CG);
  const int err = allow_dynamic_smem(proj_sign_few_kernel<R, CG>, smem);
  if (err != 0) return err;
  const dim3 grid((a.T + R - 1) / R * HP_CLUSTER, chunks);
  proj_sign_few_kernel<R, CG><<<grid, HP_FEW_THREADS, smem, stream>>>(a, per);
  return 0;
}

template <int R>
static int launch_few_cg(const SignArgs& a, int per, int n_cg, int chunks, cudaStream_t stream) {
  switch (n_cg) {
    case 1: return launch_few<R, 1>(a, per, chunks, stream);
    case 2: return launch_few<R, 2>(a, per, chunks, stream);
    case 3: return launch_few<R, 3>(a, per, chunks, stream);
    default: return launch_few<R, 4>(a, per, chunks, stream);
  }
}

static bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Kernel A: warps (rows) per block from T, so a small chunk spreads over
// many SMs; rows staged when a row has no more coordinates than the family
// has columns and a tile fits. Returns the CUDA error code.
extern "C" int bitsample_pack_launch(const float* x, const int* dims,
                                     const float* thrs, int T, int d, int M,
                                     unsigned long long* words, float* margins,
                                     void* stream) {
  if (T > 0) {
    if (d < 1 || M < 32 || M % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
    const int nw = std::min(HP_THREADS / 32, std::max(1, (T + 131) / 132));
    const size_t cols = (2 * static_cast<size_t>(M) + 4) * sizeof(float);
    const size_t tile = (static_cast<size_t>(nw) * d + 4) * sizeof(float);
    const bool staged = d <= M && cols + tile <= HP_A_SMEM;
    const size_t smem = cols + (staged ? tile : 0);
    const int err = allow_dynamic_smem(bitsample_pack_kernel, smem);
    if (err != 0) return err;
    const int blocks = std::min((T + nw - 1) / nw, HP_A_GRID);
    bitsample_pack_kernel<<<blocks, nw * 32, smem, static_cast<cudaStream_t>(stream)>>>(
        x, dims, thrs, T, d, M, staged, words, margins);
  }
  return static_cast<int>(cudaGetLastError());
}

// Kernel B: the few-row path below HP_FEW_MAX_T rows when d spans more
// than one slice and the partials fit, else the batch path (both give the
// same bits). Returns the CUDA error code.
extern "C" int proj_sign_pack_launch(const float* x, const float* P,
                                     const float* bias, int T, int d, int M,
                                     int m, int m_pad, uint32_t* words,
                                     float* margins, void* stream) {
  if (T > 0) {
    if (d < 1 || M % 32 != 0 || m_pad % 32 != 0 || M % m_pad != 0 || m < 1 || m > m_pad)
      return static_cast<int>(cudaErrorInvalidValue);
    SignArgs a{x, P, bias, T, d, M, m, m_pad, margins != nullptr ? m_pad : m, words, margins,
               false, false};
    a.vec_x = d % 4 == 0 && aligned16(x);
    a.vec_p = a.mc % 4 == 0 && aligned16(P);
    const int chunks = (M + HP_CHUNK - 1) / HP_CHUNK;
    int cb_max = 0;  // computed columns of the widest chunk
    for (int c = 0; c < chunks; ++c) {
      const int p0 = c * HP_CHUNK, p1 = std::min(p0 + HP_CHUNK, M);
      cb_max = std::max(cb_max, hp_computed_before(p1, a.mc, m_pad) - hp_computed_before(p0, a.mc, m_pad));
    }
    // the few-row path keeps every slice's partials in its cluster's shared
    // memory: HP_FEW_ROWS_WIDE rows per cluster where they fit, else
    // HP_FEW_ROWS
    const int n_sl = (d + HP_SLICE - 1) / HP_SLICE;
    const int per = (n_sl + HP_CLUSTER - 1) / HP_CLUSTER;
    const int n_cg = std::max(1, (cb_max + 31) / 32);
    const bool wide = T >= HP_FEW_ROWS_WIDE && few_smem<HP_FEW_ROWS_WIDE>(per, n_cg) <= HP_FEW_SMEM;
    const bool fits = wide || few_smem<HP_FEW_ROWS>(per, n_cg) <= HP_FEW_SMEM;
    const bool few = fits && T < HP_FEW_MAX_T && n_sl > 1;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int err = few ? (wide ? launch_few_cg<HP_FEW_ROWS_WIDE>(a, per, n_cg, chunks, st)
                                 : launch_few_cg<HP_FEW_ROWS>(a, per, n_cg, chunks, st))
                    : (T + 63) / 64 >= HP_BATCH_TALL_BLOCKS
                        ? launch_batch_cc<4>(a, std::max(1, (cb_max + 15) / 16), chunks, st)
                        : launch_batch_cc<1>(a, std::max(1, (cb_max + 15) / 16), chunks, st);
    if (err != 0) return err;
  }
  return static_cast<int>(cudaGetLastError());
}
