// DPQ/MGQE nearest-centroid assignment on Hopper:
// e_sub (B, D, S) + centroids (D, K, S), both float32 or both bfloat16,
// + k_limit (B,) int32 or null -> codes (B, D) int32,
// codes[b, d] = argmin over k < k_limit[b] of ||c_dk||^2 - 2 e_bd . c_dk,
// ties to the first index; a zero budget gives code 0.
//
// Replaces the TPU kernel src/repro/kernels/dpq_assign/dpq_assign.py::
// dpq_assign (Pallas body _assign_kernel), which fed the distances to the
// MXU as a (block, S) x (S, K) product with float32 accumulation
// (preferred_element_type) and ||c||^2 from the values cast to float32.
// This kernel computes the same function: for one subspace d, A =
// e_sub[:, d, :] (B x S, row stride D*S) and B^T = centroids[d] (K x S),
// distances = c_sq - 2 A.B^T, reduced by a masked argmin that never
// leaves the chip.
//
// Bound: operations for float32 (2*S FLOP for every centroid a row's
// budget reaches, against 67 TFLOP/s), bytes for bfloat16 at the LM
// widths (the rows, read once, against 3.35 TB/s).  Two entries share
// the launch below.
//
// The tiled product (float32 at S > 16, every bfloat16 call):
//   * grid: one block per (row tile, subspace), the subspace fastest, so
//     the blocks of one row tile, which read that tile's D neighbouring
//     row segments, run together.  A block walks the centroids in tiles
//     of 64 and carries each row's running (best, index) in registers
//     from one tile to the next; nothing crosses blocks;
//   * skip past the budget: the block takes the largest budget of its
//     rows (a warp reduction, then shared memory; the first stage loads
//     meanwhile) and never loads a centroid tile past it.  An MGQE tail tier (K = 64 of 256) needs one
//     tile of four.  The per-row mask k >= k_limit[b] is applied in the
//     epilogue;
//   * S is streamed through shared memory in k-steps (block_s values),
//     double-buffered: the next k-step (or the next centroid tile's
//     first) loads with cp.async, 16 bytes a thread along S, while this
//     one computes, so a row tile's loads read whole row segments and
//     no subspace's table has to fit whole (gemma3-27b's is 344 KB).
//     Rows are padded so the compute reads fall in distinct banks; S
//     past its end and rows past B or K are zero-filled (a zero adds
//     exactly 0 to a dot).  Rows that are not 16-byte aligned (S % 4 != 0
//     in float32, S % 8 != 0 in bfloat16) take plain loads into the same
//     buffers;
//   * float32 on the CUDA cores: 256 threads, each owning a register
//     micro-tile of TM rows x 8 centroids (rows rg + 32 i, centroids
//     cg + 8 j), so each value read from shared memory feeds 8 (or TM)
//     FMAs; at TM = 8 the launch bounds allow one block an SM (254
//     registers, no spills; two blocks at 128 registers spilled).  Each
//     dot is summed with fmaf in order s = 0..S-1 from +0.0, exactly as
//     the one-thread-a-row walk this kernel replaced, so its codes are
//     bit for bit that kernel's.  No TF32: it rounds the dot differently
//     from the plain version;
//   * bfloat16 on the tensor cores: mma.sync m16n8k16 bf16 -> f32, a
//     warp owning 16 rows x 64 centroids (8 accumulator tiles), A and B
//     fragments through ldmatrix from the padded tiles.  bf16 x bf16 is
//     exact in f32, so codes differ from the plain version only where
//     the order of the f32 sums decides a near-tie.  wgmma and TMA are
//     not needed at K <= 256;
//   * ||c_k||^2 comes from a pre-pass (norms_kernel), one thread a
//     centroid, in f32 from the (possibly bf16) values: a square, then an
//     add, in order s = 0..S-1.  Summed inside the tiled kernel, that
//     chain held every warp at the k-step's barrier while two warps ran
//     it (in bfloat16 it outlasted the step's mma work);
//   * epilogue: each thread reduces its micro-tile (or accumulator
//     fragment) first, in increasing k with a strict <, then the lanes
//     that share a row reduce by shuffles, lower k winning at equal
//     distances; a later tile replaces the running best only when
//     strictly smaller.  So ties keep the first index, as torch.argmin
//     and jnp.argmin do.
// The walk (float32 at S <= 16, deepfm's S = 2 among them): at S = 2 a
// product has almost nothing to contract, and the tiled product ran
// 3.7x slower there than this walk on an H100 (PERF.md section 6,
// chip_smoke.py's deepfm export on both routes).  So each thread
// walks the centroids for R rows held in registers, the table and its
// norms staged once in shared memory (assign_walk_kernel below).  Its
// dots and norms are summed in the same order as the tiled product's,
// so the two entries give the same codes.

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBN = 64;                  // centroids a tile

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d (16 x 8, f32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma16816(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ bf16 zero<bf16>() {
  return __float2bfloat16_rn(0.0f);
}

__device__ __forceinline__ float as_f32(float x) { return x; }
__device__ __forceinline__ float as_f32(bf16 x) { return __bfloat162float(x); }

// One k-step of a tile: rows [row0, row0 + ROWS) of a (n_rows, S) slab
// (row stride `stride` elements), columns [s0, s0 + KS), into dst (row
// stride LD); rows >= n_rows and columns >= S are zeros.  cp.async 16
// bytes at a time when `async` (S a multiple of a chunk, rows 16-byte
// aligned), else plain loads.
template <typename T, int ROWS, int KS, int LD, int THREADS>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long stride, long long row0,
                                          long long n_rows, int s0, int S,
                                          bool async) {
  constexpr int kCh = 16 / static_cast<int>(sizeof(T));  // a chunk
  if constexpr (KS >= kCh && KS % kCh == 0) {
    if (async) {
      constexpr int kChunks = KS / kCh;
      for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += THREADS) {
        const int r = idx / kChunks;
        const int c = idx - r * kChunks;
        const long long row = row0 + r;
        const int s = s0 + c * kCh;
        const bool real = row < n_rows && s < S;
        cp_async16(dst + r * LD + c * kCh,
                   real ? src + row * stride + s : src, real ? 16 : 0);
      }
      return;
    }
  }
  for (int idx = threadIdx.x; idx < ROWS * KS; idx += THREADS) {
    const int r = idx / KS;
    const int c = idx - r * KS;
    const long long row = row0 + r;
    const int s = s0 + c;
    dst[r * LD + c] = row < n_rows && s < S ? src[row * stride + s]
                                            : zero<T>();
  }
}

// Row `row`'s budget: its k_limit clamped to [0, K] (K without one), 0
// past B.
__device__ __forceinline__ int row_budget(const int32_t* k_limit,
                                          long long row, long long B,
                                          int K) {
  if (row >= B) return 0;
  if (k_limit == nullptr) return K;
  const int l = k_limit[row];
  return l < 0 ? 0 : (l < K ? l : K);
}

// The largest v over the block (of budgets: the centroids any of its rows
// may use); `slot` is a shared int.
__device__ __forceinline__ int block_max(int v, int* slot) {
  if (threadIdx.x == 0) *slot = 0;
  __syncthreads();
  v = __reduce_max_sync(0xffffffffu, v);
  if (threadIdx.x % 32 == 0) atomicMax(slot, v);
  __syncthreads();
  return *slot;
}

// (dist, k) against (best, idx): lower distance, then lower index
__device__ __forceinline__ void lane_min(float& best, int& idx, int lanes) {
  for (int off = 1; off < lanes; off <<= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
    if (ob < best || (ob == best && oi < idx)) {
      best = ob;
      idx = oi;
    }
  }
}

// ||c_k||^2 of every (d, k), one thread a centroid: square, then add, in
// order s = 0..S-1 (rounded as the plain version's two ops round).  The
// tiled kernels read it in their epilogue; a chain this long inside them
// would hold the whole block at a barrier while one warp sums it.
template <typename T>
__global__ void norms_kernel(const T* __restrict__ cent,
                             float* __restrict__ csq, int n, int S) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T* c = cent + static_cast<long long>(i) * S;
  float acc = 0.0f;
  for (int s = 0; s < S; ++s) {
    const float x = as_f32(c[s]);
    acc = __fadd_rn(acc, __fmul_rn(x, x));
  }
  csq[i] = acc;
}

// ----------------------------------------------------------------------
// float32 on the CUDA cores
// ----------------------------------------------------------------------

template <int TM, int KS>
struct F32Tiles {
  static constexpr int kThreads = 256;
  static constexpr int kBM = 32 * TM;         // 32 row groups of TM rows
  static constexpr int kTN = kBN / 8;         // 8 centroid groups
  // an odd number of 16-byte chunks a row, so the 8 centroid rows a
  // half-warp reads fall in distinct banks (k-steps of 2: 2 floats)
  static constexpr int kLd = KS == 2 ? 2 : 4 * ((KS / 4 + 1) | 1);
  static constexpr int kA = kBM * kLd;
  static constexpr int kB = kBN * kLd;
  static constexpr long long kBytes =
      2LL * (kA + kB) * static_cast<long long>(sizeof(float));
};

template <int TM, int KS>
__global__ void __launch_bounds__(256, TM >= 8 ? 1 : 2)
    assign_f32_kernel(const float* __restrict__ e_sub,
                      const float* __restrict__ cent,
                      const int32_t* __restrict__ k_limit,
                      const float* __restrict__ csq,
                      int32_t* __restrict__ codes, long long B, int D, int K,
                      int S, bool async) {
  using L = F32Tiles<TM, KS>;
  constexpr int kBM = L::kBM;
  constexpr int kTN = L::kTN;
  constexpr int kLd = L::kLd;
  extern __shared__ __align__(16) float smem[];
  float* a_s = smem;                      // 2 stages of (kBM, kLd)
  float* b_s = a_s + 2 * L::kA;           // 2 stages of (kBN, kLd)
  __shared__ int kmax_s;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int rg = (tid / 32) * 4 + lane / 8;   // rows rg + 32 i
  const int cg = lane % 8;                    // centroids cg + 8 j
  const int d = static_cast<int>(blockIdx.x % D);
  const long long row0 = static_cast<long long>(blockIdx.x / D) * kBM;

  int lim[TM];
  int mine = 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    lim[i] = row_budget(k_limit, row0 + rg + 32 * i, B, K);
    mine = max(mine, lim[i]);
  }
  const int n_ks = (S + KS - 1) / KS;
  const float* e_d = e_sub + static_cast<long long>(d) * S;
  const long long e_stride = static_cast<long long>(D) * S;
  const float* c_d = cent + static_cast<long long>(d) * K * S;
  auto load = [&](int st) {
    const int ct = st / n_ks;
    const int s0 = (st - ct * n_ks) * KS;
    load_tile<float, kBM, KS, kLd, 256>(a_s + (st & 1) * L::kA, e_d,
                                        e_stride, row0, B, s0, S, async);
    load_tile<float, kBN, KS, kLd, 256>(b_s + (st & 1) * L::kB, c_d, S,
                                        static_cast<long long>(ct) * kBN, K,
                                        s0, S, async);
  };

  float best[TM];
  int idx[TM];
  float acc[TM][kTN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    best[i] = INFINITY;
    idx[i] = 0;
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;
  }
  const float* csq_d = csq + static_cast<long long>(d) * K;

  // the first stage loads while the block takes its budget (a block
  // whose rows have none discards it)
  load(0);
  cp_async_commit();
  const int n_ct = (block_max(mine, &kmax_s) + kBN - 1) / kBN;
  const int n_st = n_ct * n_ks;
  if (n_st == 0) cp_async_wait<0>();
  for (int st = 0; st < n_st; ++st) {
    const int ct = st / n_ks;
    const bool last = st - ct * n_ks == n_ks - 1;
    if (st + 1 < n_st) {
      load(st + 1);                     // its buffer was freed at st - 1
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                    // stage st visible to all
    const float* a = a_s + (st & 1) * L::kA;
    const float* bt = b_s + (st & 1) * L::kB;
#pragma unroll
    for (int s = 0; s < KS; s += 2) {
      float2 av[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        av[i] = *reinterpret_cast<const float2*>(a + (rg + 32 * i) * kLd + s);
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const float2 bv =
            *reinterpret_cast<const float2*>(bt + (cg + 8 * j) * kLd + s);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          acc[i][j] = fmaf(av[i].x, bv.x, acc[i][j]);
          acc[i][j] = fmaf(av[i].y, bv.y, acc[i][j]);
        }
      }
    }
    __syncthreads();                    // both buffers free again
    if (last) {
      const int k0 = ct * kBN;
      float cq[kTN];
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int k = k0 + cg + 8 * j;
        cq[j] = k < K ? __ldg(csq_d + k) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        float tb = INFINITY;
        int ti = 0;
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          const int k = k0 + cg + 8 * j;
          const float dist = cq[j] - 2.0f * acc[i][j];
          if (k < lim[i] && dist < tb) {
            tb = dist;
            ti = k;
          }
          acc[i][j] = 0.0f;
        }
        lane_min(tb, ti, 8);            // the row group's 8 lanes
        if (tb < best[i]) {             // a later tile: strictly smaller
          best[i] = tb;
          idx[i] = ti;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long row = row0 + rg + 32 * i;
    if (i % 8 == cg && row < B) codes[row * D + d] = idx[i];
  }
}

// ----------------------------------------------------------------------
// bfloat16 on the tensor cores
// ----------------------------------------------------------------------

template <int WARPS, int KS>
struct TcTiles {
  static constexpr int kThreads = 32 * WARPS;
  static constexpr int kBM = 16 * WARPS;      // 16 rows a warp
  static constexpr int kLd = KS + 8;          // +16 bytes a row
  static constexpr int kA = kBM * kLd;
  static constexpr int kB = kBN * kLd;
  static constexpr long long kBytes =
      2LL * (kA + kB) * static_cast<long long>(sizeof(bf16));
};

template <int WARPS, int KS>
__global__ void __launch_bounds__(32 * WARPS)
    assign_bf16_kernel(const bf16* __restrict__ e_sub,
                       const bf16* __restrict__ cent,
                       const int32_t* __restrict__ k_limit,
                       const float* __restrict__ csq,
                       int32_t* __restrict__ codes, long long B, int D, int K,
                       int S, bool async) {
  using L = TcTiles<WARPS, KS>;
  constexpr int kThreads = L::kThreads;
  constexpr int kBM = L::kBM;
  constexpr int kLd = L::kLd;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* a_s = reinterpret_cast<bf16*>(smem_raw);   // 2 stages of (kBM, kLd)
  bf16* b_s = a_s + 2 * L::kA;                     // 2 stages of (kBN, kLd)
  __shared__ int kmax_s;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;                 // the lane's rows: g and g + 8
  const int tq = lane % 4;                // its columns: 2 tq, 2 tq + 1
  const int d = static_cast<int>(blockIdx.x % D);
  const long long row0 = static_cast<long long>(blockIdx.x / D) * kBM;
  const long long my_row = row0 + warp * 16 + g;

  int lim[2];
  lim[0] = row_budget(k_limit, my_row, B, K);
  lim[1] = row_budget(k_limit, my_row + 8, B, K);
  const int n_ks = (S + KS - 1) / KS;
  const bf16* e_d = e_sub + static_cast<long long>(d) * S;
  const long long e_stride = static_cast<long long>(D) * S;
  const bf16* c_d = cent + static_cast<long long>(d) * K * S;
  auto load = [&](int st) {
    const int ct = st / n_ks;
    const int s0 = (st - ct * n_ks) * KS;
    load_tile<bf16, kBM, KS, kLd, kThreads>(a_s + (st & 1) * L::kA, e_d,
                                            e_stride, row0, B, s0, S, async);
    load_tile<bf16, kBN, KS, kLd, kThreads>(b_s + (st & 1) * L::kB, c_d, S,
                                            static_cast<long long>(ct) * kBN,
                                            K, s0, S, async);
  };

  // ldmatrix row addresses (elements).  A (rows x S, 16 x 16): rows
  // lane % 16, columns (lane / 16) * 8.  B (centroid rows x S): rows
  // lane % 8 + (lane / 16) * 8, columns ((lane / 8) % 2) * 8 -> b0, b1
  // of two 8-centroid tiles.
  const int a_off = (warp * 16 + lane % 16) * kLd + (lane / 16) * 8;
  const int b_off = (lane % 8 + (lane / 16) * 8) * kLd + ((lane / 8) % 2) * 8;

  float acc[kBN / 8][4];
#pragma unroll
  for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float best[2] = {INFINITY, INFINITY};
  int idx[2] = {0, 0};
  const float* csq_d = csq + static_cast<long long>(d) * K;

  load(0);                              // while the block takes its budget
  cp_async_commit();
  const int n_ct = (block_max(max(lim[0], lim[1]), &kmax_s) + kBN - 1) / kBN;
  const int n_st = n_ct * n_ks;
  if (n_st == 0) cp_async_wait<0>();
  for (int st = 0; st < n_st; ++st) {
    const int ct = st / n_ks;
    const bool last = st - ct * n_ks == n_ks - 1;
    if (st + 1 < n_st) {
      load(st + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* a = a_s + (st & 1) * L::kA;
    const bf16* bt = b_s + (st & 1) * L::kB;
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk) {
      uint32_t af[4];
      ldsm_x4(af, smem_u32(a + a_off + kk * 16));
#pragma unroll
      for (int np = 0; np < kBN / 16; ++np) {
        uint32_t bq[4];
        ldsm_x4(bq, smem_u32(bt + np * 16 * kLd + kk * 16 + b_off));
        mma16816(acc[2 * np], af, bq[0], bq[1]);
        mma16816(acc[2 * np + 1], af, bq[2], bq[3]);
      }
    }
    __syncthreads();                    // both buffers free again
    if (last) {
      const int k0 = ct * kBN;
      float cq[kBN / 8][2];
#pragma unroll
      for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int k = k0 + n * 8 + 2 * tq + c;
          cq[n][c] = k < K ? __ldg(csq_d + k) : 0.0f;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {       // rows g, g + 8
        float tb = INFINITY;
        int ti = 0;
#pragma unroll
        for (int n = 0; n < kBN / 8; ++n) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = n * 8 + 2 * tq + c;
            const float dist = cq[n][c] - 2.0f * acc[n][2 * h + c];
            if (k0 + col < lim[h] && dist < tb) {
              tb = dist;
              ti = k0 + col;
            }
          }
        }
        lane_min(tb, ti, 4);              // the quad that shares the row
        if (tb < best[h]) {
          best[h] = tb;
          idx[h] = ti;
        }
      }
#pragma unroll
      for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
    }
  }
  if (tq < 2) {
    const long long row = my_row + 8 * tq;
    if (row < B) codes[row * D + d] = tq == 0 ? idx[0] : idx[1];
  }
}

// ----------------------------------------------------------------------
// float32, small S: the per-row walk
// ----------------------------------------------------------------------

// At S = 2 a product has almost nothing to contract: the argmin's compare
// and select cost as much as the two FMAs, and a tile's staging and
// barriers cost more.  So each thread keeps R rows' S values in
// registers and walks the centroids its rows' budgets reach, the table
// staged once in shared memory, each centroid beside its norm in one row
// of W floats (S = 2: c0, c1, ||c||^2, 0 -- one 16-byte broadcast read
// serves R rows).  Up to the smallest budget of its rows a thread walks
// unmasked; past it, each row checks its own; no thread walks past its
// rows' largest budget.  Rows tid + 256 r.
template <int SS>
struct WalkRow {
  static constexpr int kW = SS == 1 ? 2 : (SS + 4) / 4 * 4;  // floats
};

template <int SS, int R>
__device__ __forceinline__ void walk_step(const float* row, int k,
                                          const float (&ev)[R][SS],
                                          float (&best)[R], int (&idx)[R],
                                          const int (&lim)[R], bool masked) {
  constexpr int kW = WalkRow<SS>::kW;
  float cv[kW];
  if constexpr (kW % 4 == 0) {
#pragma unroll
    for (int w = 0; w < kW; w += 4) {
      const float4 q = *reinterpret_cast<const float4*>(row + w);
      cv[w] = q.x;
      cv[w + 1] = q.y;
      cv[w + 2] = q.z;
      cv[w + 3] = q.w;
    }
  } else {
    const float2 q = *reinterpret_cast<const float2*>(row);
    cv[0] = q.x;
    cv[1] = q.y;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float dot = 0.0f;
#pragma unroll
    for (int s = 0; s < SS; ++s) dot = fmaf(ev[r][s], cv[s], dot);
    const float dist = cv[SS] - 2.0f * dot;
    if ((!masked || k < lim[r]) && dist < best[r]) {
      best[r] = dist;
      idx[r] = k;
    }
  }
}

template <int SS, int R>
__global__ void __launch_bounds__(256)
    assign_walk_kernel(const float* __restrict__ e_sub,
                       const float* __restrict__ cent,
                       const int32_t* __restrict__ k_limit,
                       int32_t* __restrict__ codes, long long B, int D,
                       int K) {
  constexpr int kW = WalkRow<SS>::kW;
  extern __shared__ __align__(16) float smem[];   // (K, kW)
  const int tid = threadIdx.x;
  const int d = static_cast<int>(blockIdx.x % D);
  const long long row0 = static_cast<long long>(blockIdx.x / D) * 256 * R;

  // the budgets, the rows and the whole table load at once: one memory
  // latency, not three in a chain, in a launch of a few microseconds
  int lim[R];
  int lo = K, hi = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    lim[r] = row_budget(k_limit, row0 + tid + 256 * r, B, K);
    lo = min(lo, lim[r]);
    hi = max(hi, lim[r]);
  }
  float ev[R][SS];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long row = row0 + tid + 256 * r;
    const float* e = e_sub + (row < B ? (row * D + d) * SS : 0);
#pragma unroll
    for (int s = 0; s < SS; ++s) ev[r][s] = row < B ? e[s] : 0.0f;
  }
  const float* cd = cent + static_cast<long long>(d) * K * SS;
  for (int k = tid; k < K; k += 256) {
    // square, then add, in order: rounded as the plain version's ops
    float* row = smem + k * kW;
    float acc = 0.0f;
#pragma unroll
    for (int s = 0; s < SS; ++s) {
      const float x = cd[k * SS + s];
      row[s] = x;
      acc = __fadd_rn(acc, __fmul_rn(x, x));
    }
    row[SS] = acc;
#pragma unroll
    for (int w = SS + 1; w < kW; ++w) row[w] = 0.0f;
  }
  __syncthreads();

  float best[R];
  int idx[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    best[r] = INFINITY;
    idx[r] = 0;
  }
  int k = 0;
#pragma unroll 4
  for (; k < lo; ++k) walk_step<SS, R>(smem + k * kW, k, ev, best, idx, lim,
                                       false);
  for (; k < hi; ++k) walk_step<SS, R>(smem + k * kW, k, ev, best, idx, lim,
                                       true);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long row = row0 + tid + 256 * r;
    if (row < B) codes[row * D + d] = idx[r];
  }
}

// ----------------------------------------------------------------------
// launch
// ----------------------------------------------------------------------

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

int set_smem(const void* kern, long long smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

constexpr long long kMaxBlocks = 0x7fffffffLL;

// the norms, then the tiled product
template <typename T>
int launch_tiled(void (*kern)(const T*, const T*, const int32_t*,
                              const float*, int32_t*, long long, int, int,
                              int, bool),
                 long long smem, int threads, long long blocks,
                 cudaStream_t stream, const T* e, const T* c,
                 const int32_t* lim, float* csq, int32_t* codes, long long B,
                 int D, int K, int S, bool async) {
  if (blocks > kMaxBlocks || csq == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = set_smem(reinterpret_cast<const void*>(kern), smem);
  if (err) return err;
  const int n = D * K;
  norms_kernel<T><<<(n + 255) / 256, 256, 0, stream>>>(c, csq, n, S);
  err = repro_last_error();
  if (err) return err;
  kern<<<static_cast<unsigned>(blocks), threads, static_cast<size_t>(smem),
         stream>>>(e, c, lim, csq, codes, B, D, K, S, async);
  return repro_last_error();
}

template <int SS, int R>
int launch_walk(cudaStream_t stream, const float* e, const float* c,
                const int32_t* lim, int32_t* codes, long long B, int D,
                int K) {
  const long long blocks = (B + 256LL * R - 1) / (256LL * R) * D;
  const long long smem = static_cast<long long>(K) * WalkRow<SS>::kW * 4;
  if (blocks > kMaxBlocks) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = assign_walk_kernel<SS, R>;
  const int err = set_smem(reinterpret_cast<const void*>(kern), smem);
  if (err) return err;
  kern<<<static_cast<unsigned>(blocks), 256, static_cast<size_t>(smem),
         stream>>>(e, c, lim, codes, B, D, K);
  return repro_last_error();
}

}  // namespace

// The instantiations.  Tiled product: (rows a block, S a k-step) per
// dtype, float32 TM = rows / 32 rows a thread, bfloat16 WARPS = rows /
// 16.  Walk (float32, block_s = 0): (S, rows a thread R), 256 R rows a
// block.
#define DPQ_F32_TILES(X)                                                   \
  X(2, 2) X(2, 4) X(2, 8) X(2, 16) X(2, 32) X(4, 2) X(4, 4) X(4, 8)        \
  X(4, 16) X(4, 32) X(8, 2) X(8, 4) X(8, 8) X(8, 16) X(8, 32)
#define DPQ_BF16_TILES(X) \
  X(4, 16) X(4, 32) X(4, 64) X(8, 16) X(8, 32) X(8, 64)
#define DPQ_WALKS(X)                                                       \
  X(1, 1) X(1, 2) X(1, 4) X(2, 1) X(2, 2) X(2, 4) X(3, 1) X(3, 2) X(3, 4)  \
  X(4, 1) X(4, 2) X(4, 4) X(8, 1) X(8, 2) X(8, 4) X(16, 1) X(16, 2)        \
  X(16, 4)

// e_sub: (B, D, S) contiguous; cent: (D, K, S) contiguous, both float32
// (dtype 0) or both bfloat16 (dtype 1); k_limit: (B,) int32 or null
// (every row may use all K); csq: (D, K) float32 scratch for the tiled
// product's norms (unused by the walk); codes: (B, D) int32.  B > 0;
// block_m rows a block and block_s S values a k-step (0: the walk), one
// of the instantiations above.  Returns a cudaError_t (0 on success).
extern "C" int dpq_assign_launch(const void* e_sub, const void* cent,
                                 const void* k_limit, void* csq, void* codes,
                                 long long B, int D, int K, int S, int dtype,
                                 int block_m, int block_s, void* stream) {
  if (B <= 0 || D <= 0 || K <= 0 || S <= 0 || D > (1 << 30) / K)
    return static_cast<int>(cudaErrorInvalidValue);
  const int32_t* lim = static_cast<const int32_t*>(k_limit);
  float* norms = static_cast<float*>(csq);
  int32_t* out = static_cast<int32_t*>(codes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool al = aligned16(e_sub) && aligned16(cent);
#define DPQ_F32_LAUNCH(TM, KS)                                             \
  if (dtype == 0 && block_m == 32 * TM && block_s == KS) {                 \
    using L = F32Tiles<TM, KS>;                                            \
    return launch_tiled(assign_f32_kernel<TM, KS>, L::kBytes, L::kThreads, \
                        (B + L::kBM - 1) / L::kBM * D, st,                 \
                        static_cast<const float*>(e_sub),                  \
                        static_cast<const float*>(cent), lim, norms, out,  \
                        B, D, K, S, al && S % 4 == 0);                     \
  }
#define DPQ_BF16_LAUNCH(W, KS)                                             \
  if (dtype == 1 && block_m == 16 * W && block_s == KS) {                  \
    using L = TcTiles<W, KS>;                                              \
    return launch_tiled(assign_bf16_kernel<W, KS>, L::kBytes, L::kThreads, \
                        (B + L::kBM - 1) / L::kBM * D, st,                 \
                        static_cast<const bf16*>(e_sub),                   \
                        static_cast<const bf16*>(cent), lim, norms, out,   \
                        B, D, K, S, al && S % 8 == 0);                     \
  }
#define DPQ_WALK_LAUNCH(SS, R)                                             \
  if (dtype == 0 && block_s == 0 && block_m == 256 * R && S == SS)         \
    return launch_walk<SS, R>(st, static_cast<const float*>(e_sub),        \
                              static_cast<const float*>(cent), lim, out,   \
                              B, D, K);
  DPQ_F32_TILES(DPQ_F32_LAUNCH)
  DPQ_BF16_TILES(DPQ_BF16_LAUNCH)
  DPQ_WALKS(DPQ_WALK_LAUNCH)
#undef DPQ_F32_LAUNCH
#undef DPQ_BF16_LAUNCH
#undef DPQ_WALK_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
