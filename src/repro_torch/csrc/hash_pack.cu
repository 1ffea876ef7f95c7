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
// What bounds them on an H100: both read each x row once and write one word
// per 32 columns (plus 4 bytes per column with margins); A does one compare
// per column and B 2*d flops, far below the card's float32 rate at the
// family widths here (d = 30, a few hundred columns), so both are bound by
// device-memory bytes. The design therefore reads x once per block: a block
// stages a tile of up to HP_ROWS rows in shared memory with coalesced loads,
// each warp then produces one (row, word) pair per step — lane j evaluates
// column 32w + j from the staged row and __ballot_sync packs the 32 bits
// into the word in one instruction, so bits never touch device memory.
// dims/thrs and P (a few KB to tens of KB) stay in L1/L2 across blocks.
//
// Wide rows (a hidden-state datastore has d = 4,096; the repo's widest
// d_model is 18,432): HP_ROWS rows of d floats fit a block's 227 KB only
// while d <= 1,816. Past that, A reads its sampled coordinates straight
// from global memory (it touches M of the d floats, so staging the whole row
// buys nothing), and B stages as many rows as fit (14 at d = 4,096, 3 at
// d = 18,432), reading x from global memory only when not one row fits.
//
// B skips the fmaf loop in lanes whose column is padding (col % m_pad >= m)
// unless margins are asked for: their bit is 0 whatever s is. At the inner
// family's m = 12 of m_pad = 32 that is 20 idle lanes per word.
//
// Exactness: A only gathers, compares and subtracts, so it is bit-exact with
// the plain version. B sums s in a fixed sequential fmaf order over d in
// float32 (no TF32); with a one-hot P and bias -thr every fmaf but one adds
// an exact zero, so s == x[dim] - thr bit for bit and B reproduces A's
// margins, and A's words wherever x[dim] != thr.
#include "common.cuh"

#include <algorithm>

constexpr int HP_ROWS = 32;      // x rows per block (staged when they fit)
constexpr int HP_THREADS = 256;  // 8 warps
constexpr size_t HP_SMEM_MAX = 232448;  // dynamic shared memory a block may use

// Rows per block and whether they are staged, for rows of width d: up to
// HP_ROWS staged rows that fit in shared memory; with gather_ok (kernel A)
// only a full tile is worth staging.
struct RowTile {
  int rows;
  bool staged;
};

inline RowTile row_tile(int d, bool gather_ok) {
  const size_t row_bytes = static_cast<size_t>(d) * sizeof(float);
  const int fit = static_cast<int>(
      row_bytes == 0 ? HP_ROWS : std::min<size_t>(HP_ROWS, HP_SMEM_MAX / row_bytes));
  if (fit == HP_ROWS || (!gather_ok && fit > 0)) return {fit, true};
  return {HP_ROWS, false};
}

// Copy the block's rows to shared memory when staged; returns how many rows
// the block holds (fewer than R in the last block).
__device__ inline int stage_rows(const float* __restrict__ x, float* xs,
                                 int T, int d, int R, bool staged) {
  const int row0 = blockIdx.x * R;
  const int rows = min(R, T - row0);
  if (staged) {
    for (int i = threadIdx.x; i < rows * d; i += blockDim.x)
      xs[i] = x[static_cast<size_t>(row0) * d + i];
  }
  __syncthreads();
  return rows;
}

__global__ void __launch_bounds__(HP_THREADS)
bitsample_pack_kernel(const float* __restrict__ x, const int* __restrict__ dims,
                      const float* __restrict__ thrs, int T, int d, int M,
                      int R, bool staged, uint32_t* __restrict__ words,
                      float* __restrict__ margins) {
  extern __shared__ float xs[];  // R * d when staged
  const int row0 = blockIdx.x * R;
  const int rows = stage_rows(x, xs, T, d, R, staged);
  const float* base = staged ? xs : x + static_cast<size_t>(row0) * d;
  const int W = M >> 5;
  const int lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  for (int p = threadIdx.x >> 5; p < rows * W; p += nw) {
    const int r = p / W;
    const int w = p - r * W;
    const int col = (w << 5) + lane;
    const float thr = thrs[col];
    const float g = base[static_cast<size_t>(r) * d + dims[col]];
    const unsigned bits = __ballot_sync(0xffffffffu, g > thr);
    const size_t t = static_cast<size_t>(row0 + r);
    if (lane == 0) words[t * W + w] = bits;
    if (margins != nullptr) margins[t * M + col] = fabsf(g - thr);
  }
}

__global__ void __launch_bounds__(HP_THREADS)
proj_sign_pack_kernel(const float* __restrict__ x, const float* __restrict__ P,
                      const float* __restrict__ bias, int T, int d, int M,
                      int m, int m_pad, int R, bool staged,
                      uint32_t* __restrict__ words,
                      float* __restrict__ margins) {
  extern __shared__ float xs[];  // R * d when staged
  const int row0 = blockIdx.x * R;
  const int rows = stage_rows(x, xs, T, d, R, staged);
  const float* base = staged ? xs : x + static_cast<size_t>(row0) * d;
  const int W = M >> 5;
  const int lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  for (int p = threadIdx.x >> 5; p < rows * W; p += nw) {
    const int r = p / W;
    const int w = p - r * W;
    const int col = (w << 5) + lane;
    const float* xr = base + static_cast<size_t>(r) * d;
    const bool real = col % m_pad < m;
    float s = 0.0f;
    if (real || margins != nullptr) {
      for (int j = 0; j < d; ++j)
        s = fmaf(xr[j], P[static_cast<size_t>(j) * M + col], s);
      s = s + bias[col];
    }
    const bool bit = real && (s >= 0.0f);
    const unsigned bits = __ballot_sync(0xffffffffu, bit);
    const size_t t = static_cast<size_t>(row0 + r);
    if (lane == 0) words[t * W + w] = bits;
    if (margins != nullptr) margins[t * M + col] = fabsf(s);
  }
}

extern "C" int bitsample_pack_launch(const float* x, const int* dims,
                                     const float* thrs, int T, int d, int M,
                                     uint32_t* words, float* margins,
                                     void* stream) {
  if (T > 0) {
    const RowTile tile = row_tile(d, /*gather_ok=*/true);
    const size_t smem = tile.staged ? static_cast<size_t>(tile.rows) * d * sizeof(float) : 0;
    const int err = allow_dynamic_smem(bitsample_pack_kernel, smem);
    if (err != 0) return err;
    const int blocks = (T + tile.rows - 1) / tile.rows;
    bitsample_pack_kernel<<<blocks, HP_THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
        x, dims, thrs, T, d, M, tile.rows, tile.staged, words, margins);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int proj_sign_pack_launch(const float* x, const float* P,
                                     const float* bias, int T, int d, int M,
                                     int m, int m_pad, uint32_t* words,
                                     float* margins, void* stream) {
  if (T > 0) {
    const RowTile tile = row_tile(d, /*gather_ok=*/false);
    const size_t smem = tile.staged ? static_cast<size_t>(tile.rows) * d * sizeof(float) : 0;
    const int err = allow_dynamic_smem(proj_sign_pack_kernel, smem);
    if (err != 0) return err;
    const int blocks = (T + tile.rows - 1) / tile.rows;
    proj_sign_pack_kernel<<<blocks, HP_THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
        x, P, bias, T, d, M, m, m_pad, tile.rows, tile.staged, words, margins);
  }
  return static_cast<int>(cudaGetLastError());
}
