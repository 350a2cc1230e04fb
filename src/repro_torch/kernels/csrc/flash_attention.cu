// Blocked causal/windowed GQA attention (forward) on Hopper:
// q (B, Sq, H, hd), k and v (B, Skv, Hkv, hd), float32 or bfloat16 ->
// o (B, Sq, H, hd) in q's dtype.  Query i sees key j iff
// 0 <= i - j < window (positions are the indices); query head h reads KV
// head h / (H / Hkv).
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py::flash_attention
// (Pallas body _flash_kernel), and computes what it computes: scores in
// f32 times hd^-0.5, masked scores set to -1e30 (not -inf), the online
// softmax state (m, l) per row, P rounded to v's dtype before the P.V
// product (l summed from the unrounded P), summed in f32, and
// acc / max(l, 1e-30) stored in q's dtype.  A row that sees no key at all
// (i >= Skv + window - 1) averages every value, as the reference does.
//
// Bound: operations.  4 * hd FLOP for every visible (query, key) pair of
// every head against about 2 * (q + k + v + o) bytes: at gemma3-4b's
// hd = 320 and S = 4,096 that is ~1,000 FLOP a byte, far above the card's
// balance point.  Two kernels share the launch below:
//
// bfloat16: both products on the tensor cores (mma.sync m16n8k16, bf16
// in, f32 accumulation), one block per (query tile of 64 rows, query
// head, batch row), 4 warps of 16 query rows each.
//   * S = Q.K^T: hd is the reduction dimension.  Q and K fragments come
//     from shared memory through ldmatrix; Q is held in registers when
//     hd <= 128 and re-read at every k-step above (at hd = 320 the
//     16 x 320 f32 output accumulator alone takes 160 registers a
//     thread, so Q cannot stay);
//   * the softmax stays in registers, in the mma accumulator layout: a
//     quad of lanes shares a row, so a row's max takes two shuffles and
//     its sum is reduced once, at the end;
//   * O += P.V: P is rounded to bf16 in registers and becomes the A
//     operand directly (the accumulators of two score tiles are one
//     A fragment); V comes through ldmatrix.trans; hd is the N
//     dimension, 8 columns an mma;
//   * K and V tiles come in by cp.async into shared memory rows padded
//     by 16 bytes (a row stride of 4 mod 8 words, so ldmatrix's eight
//     rows fall in distinct banks).  Two stages (K_{t+1} and V_{t+1}
//     load while tile t computes) where two blocks still fit an SM;
//     otherwise one K and one V buffer, staggered: K_{t+1} loads while
//     the softmax and P.V of tile t run, V_{t+1} while Q.K_{t+1}^T runs;
//   * hd = 168 (gemma3-27b) is not a multiple of the mma's k-depth: Q, K
//     and V rows are zero-padded to 176 in shared memory (zero columns
//     add exactly 0) and only the 168 real output columns are stored;
//   * inputs whose rows are not 16-byte aligned take plain loads into the
//     same buffers (slower, same numbers).
// It reaches about 150 TFLOP/s at hd = 320 on an H100 SXM (PERF.md
// section 6).  wgmma and TMA are later work: a first wgmma version (no
// swizzle, one warpgroup, the two products and the softmax in turn) ran
// slower than this one.
// Registers and spills per variant (nvcc -Xptxas -v, sm_90a) are in
// PERF.md section 6, from chip_smoke.py's build report.
//
// float32: the products stay on the CUDA cores in f32.  TF32 tensor cores
// would keep about three decimal digits of each product, which breaks the
// 2e-5 bar the JAX package holds its f32 kernel to.  One block per (query
// tile of 64 rows, query head, batch row), 256 threads; shared memory
// holds the q tile, one K-or-V tile (K, then V in the same buffer) and
// the (64, BK) f32 scores; rows padded to an odd number of words so a
// warp's 16 key rows fall in 16 banks; each thread computes a 4 x (BK/16)
// register tile of scores and a 4 x ceil(hd/16) tile of the output; 4
// threads share a row's softmax.
//
// Both: the TPU kernel's sequential kv grid dimension becomes a loop
// inside the block; (B, S, H, hd) is read through strides, with no
// transpose and no g-fold repeat of K/V for GQA
// (flash_attention.py:101-107 repeats); KV tiles wholly outside the
// query tile's band are skipped (exact: a fully masked tile adds
// exp(-1e30 - m) = 0 once a row has seen a key), so a local layer of
// window 1,024 at S = 4,096 walks ~17 tiles of 64 keys per query tile
// instead of up to 64; any Sq and Skv: ragged tiles are zero-filled,
// keys past Skv score -inf (they do not exist), rows past Sq are not
// stored.  Differences from the reference's order (a dense softmax, sums
// in another order) stay within the tests' bars: 2e-5 in f32, 3e-2 in
// bf16.

#include <cmath>
#include <cstdint>
#include <initializer_list>

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kBlockQ = 64;              // query rows per block
constexpr float kNegInf = -1e30f;        // the reference's mask value
constexpr size_t kHalfSm = 113 * 1024;   // two blocks an SM
constexpr size_t kSmemMax = 227 * 1024;

// The band of KV tiles (of BK keys) that rows [q0, q0 + kBlockQ) see:
// every tile when a row of the block sees no key (the reference then
// averages over all of them).
template <int BK>
__device__ __forceinline__ void band(int q0, int Sq, int Skv,
                                     long long window, int* t_begin,
                                     int* t_end) {
  const long long q_last = (q0 + kBlockQ < Sq ? q0 + kBlockQ : Sq) - 1;
  long long lo = 0, hi = Skv - 1;
  if (window >= 1 && q_last < Skv + window - 1) {
    lo = q0 - window + 1 > 0 ? q0 - window + 1 : 0;
    hi = q_last < Skv - 1 ? q_last : Skv - 1;
  }
  *t_begin = static_cast<int>(lo / BK);
  *t_end = static_cast<int>(hi / BK);
}

// ----------------------------------------------------------------------
// float32 on the CUDA cores
// ----------------------------------------------------------------------

constexpr int kF32Threads = 256;

template <int HD, int BK>
struct F32Layout {
  static constexpr int kLd = HD + 1;     // an odd number of words a row
  static constexpr int kLdP = BK + 1;    // scores row stride (floats)
  static constexpr size_t kQBytes = size_t(kBlockQ) * kLd * sizeof(float);
  static constexpr size_t kKvBytes = size_t(BK) * kLd * sizeof(float);
  static constexpr size_t kPBytes = size_t(kBlockQ) * kLdP * sizeof(float);
  static constexpr size_t kBytes =
      kQBytes + kKvBytes + kPBytes + 3 * kBlockQ * sizeof(float);
};

// rows [row0, row0 + ROWS) of a (rows, HD) slab with row stride
// `stride` (elements) into dst (row stride LD); rows >= n are zeros.
template <int HD, int ROWS, int LD>
__device__ __forceinline__ void load_f32(float* dst, const float* src,
                                         long long stride, int row0, int n) {
  for (int idx = threadIdx.x; idx < ROWS * HD; idx += kF32Threads) {
    const int r = idx / HD;
    const int c = idx - r * HD;
    const int row = row0 + r;
    dst[r * LD + c] = row < n ? src[row * stride + c] : 0.0f;
  }
}

template <int HD, int BK>
__global__ void __launch_bounds__(kF32Threads)
    flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int Sq, int Skv, int H, int group, long long qsb,
                     long long qss, long long qsh, long long ksb,
                     long long kss, long long ksh, long long vsb,
                     long long vss, long long vsh, long long window,
                     float scale) {
  using L = F32Layout<HD, BK>;
  constexpr int kLd = L::kLd;
  constexpr int kLdP = L::kLdP;
  constexpr int kRows = kBlockQ / 16;          // query rows per thread
  constexpr int kCols = BK / 16;               // score columns per thread
  constexpr int kAcc = (HD + 15) / 16;         // output columns per thread
  constexpr int kTpr = kF32Threads / kBlockQ;  // softmax threads per row
  constexpr int kPc = BK / kTpr;               // their columns each

  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* kvs = reinterpret_cast<float*>(smem + L::kQBytes);
  float* ps = reinterpret_cast<float*>(smem + L::kQBytes + L::kKvBytes);
  float* m_s = ps + kBlockQ * kLdP;
  float* l_s = m_s + kBlockQ;
  float* a_s = l_s + kBlockQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + hk * ksh;
  const float* vb = v + b * vsb + hk * vsh;
  int t_begin, t_end;
  band<BK>(q0, Sq, Skv, window, &t_begin, &t_end);

  load_f32<HD, kBlockQ, kLd>(qs, qb, qss, q0, Sq);
  for (int i = tid; i < kBlockQ; i += kF32Threads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.0f;
  }
  float acc[kRows][kAcc];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kAcc; ++c) acc[r][c] = 0.0f;

  for (int t = t_begin; t <= t_end; ++t) {
    const int k0 = t * BK;
    load_f32<HD, BK, kLd>(kvs, kb, kss, k0, Skv);
    __syncthreads();                   // q, K and the row state visible

    // scores: a kRows x kCols register tile, rows ty + 16 r, keys tx + 16 c
    float s[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[r][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[kRows], bk[kCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r) a[r] = qs[(ty + 16 * r) * kLd + d];
#pragma unroll
      for (int c = 0; c < kCols; ++c) bk[c] = kvs[(tx + 16 * c) * kLd + d];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) s[r][c] = fmaf(a[r], bk[c], s[r][c]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const long long i = q0 + ty + 16 * r;
        const long long j = k0 + tx + 16 * c;
        float val = -INFINITY;         // past Skv: no key at all
        if (j < Skv) {
          const long long delta = i - j;
          val = (delta >= 0 && delta < window) ? s[r][c] * scale : kNegInf;
        }
        ps[(ty + 16 * r) * kLdP + tx + 16 * c] = val;
      }
    }
    __syncthreads();                   // scores complete, K no longer read
    load_f32<HD, BK, kLd>(kvs, vb, vss, k0, Skv);

    // online softmax: kTpr neighbouring lanes per row
    {
      const int row = tid / kTpr;
      const int part = tid % kTpr;
      float* pr = ps + row * kLdP + part * kPc;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < kPc; ++c) mx = fmaxf(mx, pr[c]);
#pragma unroll
      for (int off = kTpr / 2; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[row];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < kPc; ++c) {
        const float p = expf(pr[c] - m_new);
        sum += p;
        pr[c] = p;
      }
#pragma unroll
      for (int off = kTpr / 2; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[row] = alpha;
        l_s[row] = l_s[row] * alpha + sum;
        m_s[row] = m_new;
      }
    }
    __syncthreads();                   // P, alpha and V visible

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float alpha = a_s[ty + 16 * r];
#pragma unroll
      for (int c = 0; c < kAcc; ++c) acc[r][c] *= alpha;
    }
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      float p[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) p[r] = ps[(ty + 16 * r) * kLdP + j];
#pragma unroll
      for (int c = 0; c < kAcc; ++c) {
        // hd = 168: the last column group is ragged
        if (HD % 16 != 0 && tx + 16 * c >= HD) continue;
        const float vv = kvs[j * kLd + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r][c] = fmaf(p[r], vv, acc[r][c]);
      }
    }
    __syncthreads();                   // before the next tile overwrites
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = ty + 16 * r;
    const long long i = q0 + row;
    if (i >= Sq) continue;
    const float l = fmaxf(l_s[row], 1e-30f);
    float* orow = o + ((static_cast<long long>(b) * Sq + i) * H + h) * HD;
#pragma unroll
    for (int c = 0; c < kAcc; ++c)
      if (HD % 16 == 0 || tx + 16 * c < HD) orow[tx + 16 * c] = acc[r][c] / l;
  }
}

// ----------------------------------------------------------------------
// bfloat16 on the tensor cores
// ----------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kWarps = kBlockQ / 16;     // 16 query rows a warp
constexpr int kTcThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD, int BK>
struct TcLayout {
  static constexpr int kHdp = (HD + 15) / 16 * 16;  // padded to the k-depth
  static constexpr int kLd = kHdp + 8;              // +16 bytes a row
  static constexpr size_t kQBytes = size_t(kBlockQ) * kLd * 2;
  static constexpr size_t kKvBytes = size_t(BK) * kLd * 2;   // one tile
  static constexpr size_t kTwo = kQBytes + 4 * kKvBytes;     // K, V x 2
  static constexpr size_t kOne = kQBytes + 2 * kKvBytes;
  // two stages where two blocks still fit an SM; else one stage if that
  // lets two fit; else two stages for the one block
  static constexpr int kStages =
      kTwo <= kHalfSm ? 2 : (kOne <= kHalfSm ? 1 : (kTwo <= kSmemMax ? 2 : 1));
  static constexpr size_t kBytes = kStages == 2 ? kTwo : kOne;
  static constexpr bool kQInRegs = kHdp <= 128;
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// rows [row0, row0 + ROWS) of a (n, HD) slab (row stride `stride`
// elements) into dst (row stride LD, HDP columns); rows >= n and columns
// >= HD are zeros.  cp.async 16 bytes at a time when `async` (rows
// 16-byte aligned), else plain loads.
template <int HD, int HDP, int ROWS, int LD>
__device__ __forceinline__ void load_bf16(bf16* dst, const bf16* src,
                                          long long stride, int row0, int n,
                                          bool async) {
  if (async) {
    constexpr int kChunks = HDP / 8;
    for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += kTcThreads) {
      const int r = idx / kChunks;
      const int c = idx - r * kChunks;
      const int row = row0 + r;
      const bool real = row < n && c * 8 < HD;
      cp_async16(dst + r * LD + c * 8, real ? src + row * stride + c * 8 : src,
                 real ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * HDP; idx += kTcThreads) {
      const int r = idx / HDP;
      const int c = idx - r * HDP;
      const int row = row0 + r;
      dst[r * LD + c] = row < n && c < HD ? src[row * stride + c]
                                          : __float2bfloat16_rn(0.0f);
    }
  }
}

template <int HD, int BK>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      int Sq, int Skv, int H, int group, long long qsb,
                      long long qss, long long qsh, long long ksb,
                      long long kss, long long ksh, long long vsb,
                      long long vss, long long vsh, long long window,
                      float scale_log2, bool async) {
  using L = TcLayout<HD, BK>;
  constexpr int kHdp = L::kHdp;
  constexpr int kLd = L::kLd;
  constexpr int kS = BK / 8;       // score tiles (8 keys) a warp
  constexpr int kD = kHdp / 8;     // output tiles (8 columns) a warp
  constexpr int kKs = kHdp / 16;   // k-steps of Q.K^T
  constexpr int kStages = L::kStages;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kBlockQ * kLd;
  bf16* vs = ks + kStages * BK * kLd;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;                 // the lane's rows: g and g + 8
  const int tq = lane % 4;                // its columns: 2 tq, 2 tq + 1
  const int n_qt = (Sq + kBlockQ - 1) / kBlockQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const bf16* qb = q + b * qsb + h * qsh;
  const bf16* kb = k + b * ksb + hk * ksh;
  const bf16* vb = v + b * vsb + hk * vsh;
  int t_begin, t_end;
  band<BK>(q0, Sq, Skv, window, &t_begin, &t_end);

  // group 0: Q and K of the first tile; then V of the first tile, in the
  // same group (two stages) or a group of its own (one stage)
  load_bf16<HD, kHdp, kBlockQ, kLd>(qs, qb, qss, q0, Sq, async);
  load_bf16<HD, kHdp, BK, kLd>(ks, kb, kss, t_begin * BK, Skv, async);
  if (kStages == 1) cp_async_commit();
  load_bf16<HD, kHdp, BK, kLd>(vs, vb, vss, t_begin * BK, Skv, async);
  cp_async_commit();

  // ldmatrix row addresses.  A (Q, 16 x 16): rows lane % 16, columns
  // (lane / 16) * 8.  B of Q.K^T (K rows are keys): keys lane % 8 +
  // (lane / 16) * 8, columns ((lane / 8) % 2) * 8 -> b0, b1 of two key
  // tiles.  B of P.V (transposed): keys lane % 8 + ((lane / 8) % 2) * 8,
  // columns (lane / 16) * 8 -> b0, b1 of two column tiles.
  const uint32_t q_addr =
      smem_u32(qs + (warp * 16 + lane % 16) * kLd + (lane / 16) * 8);
  const int k_off = (lane % 8 + (lane / 16) * 8) * kLd + ((lane / 8) % 2) * 8;
  const int v_off = (lane % 8 + ((lane / 8) % 2) * 8) * kLd + (lane / 16) * 8;

  float acc[kD][4];
#pragma unroll
  for (int d = 0; d < kD; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.0f;
  float m_r[2] = {kNegInf, kNegInf};    // rows g, g + 8 (log2 domain)
  float l_r[2] = {0.0f, 0.0f};          // this lane's part of the row sum
  uint32_t qf[L::kQInRegs ? kKs : 1][4];

  const int row0 = q0 + warp * 16;      // the warp's first query row
  for (int t = t_begin; t <= t_end; ++t) {
    const int k0 = t * BK;
    const bool more = t < t_end;
    const int stage = kStages == 2 ? (t - t_begin) & 1 : 0;
    const bf16* kst = ks + stage * BK * kLd;
    const bf16* vst = vs + stage * BK * kLd;
    if constexpr (kStages == 2) {
      if (more) {
        const int nxt = stage ^ 1;
        load_bf16<HD, kHdp, BK, kLd>(ks + nxt * BK * kLd, kb, kss, k0 + BK,
                                     Skv, async);
        load_bf16<HD, kHdp, BK, kLd>(vs + nxt * BK * kLd, vb, vss, k0 + BK,
                                     Skv, async);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      cp_async_wait<1>();               // K of this tile (and Q)
    }
    __syncthreads();
    if constexpr (L::kQInRegs) {
      if (t == t_begin) {
#pragma unroll
        for (int kk = 0; kk < kKs; ++kk) ldsm_x4(qf[kk], q_addr + kk * 32);
      }
    }

    // S = Q.K^T, 16 x BK a warp, in the accumulator layout
    float s[kS][4];
#pragma unroll
    for (int j = 0; j < kS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kKs; ++kk) {
      uint32_t a[4];
      if constexpr (L::kQInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        ldsm_x4(a, q_addr + kk * 32);
      }
#pragma unroll
      for (int np = 0; np < kS / 2; ++np) {
        uint32_t bq[4];
        ldsm_x4(bq, smem_u32(kst + np * 16 * kLd + kk * 16 + k_off));
        mma16816(s[2 * np], a, bq[0], bq[1]);
        mma16816(s[2 * np + 1], a, bq[2], bq[3]);
      }
    }
    if constexpr (kStages == 1) {
      __syncthreads();                  // every warp is done with K
      if (more) {
        load_bf16<HD, kHdp, BK, kLd>(ks, kb, kss, k0 + BK, Skv, async);
        cp_async_commit();
      }
    }

    // scale (log2 domain) and mask; a warp's tile wholly inside the band
    // skips the mask
    const bool inside = k0 + BK <= Skv && k0 + BK - 1 <= row0
                        && static_cast<long long>(row0) + 15 - k0 < window;
#pragma unroll
    for (int j = 0; j < kS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (!inside) {
          const int col = k0 + j * 8 + 2 * tq + (e & 1);
          const long long delta =
              static_cast<long long>(row0 + g + (e >= 2 ? 8 : 0)) - col;
          if (col >= Skv)
            x = -INFINITY;                // no such key
          else if (delta < 0 || delta >= window)
            x = kNegInf;
        }
        s[j][e] = x;
      }
    }

    // online softmax in registers: a quad of lanes shares a row
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m_r[r] - mx[r]);
      m_r[r] = mx[r];
    }
    // P in bf16 as the A operand of P.V: score tiles 2 kk and 2 kk + 1
    // are A fragment kk; l from the unrounded P
    uint32_t pf[BK / 16][4];
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      const float p0 = exp2f(s[j][0] - m_r[0]);
      const float p1 = exp2f(s[j][1] - m_r[0]);
      const float p2 = exp2f(s[j][2] - m_r[1]);
      const float p3 = exp2f(s[j][3] - m_r[1]);
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      pf[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
      pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + rs[r];
#pragma unroll
    for (int d = 0; d < kD; ++d) {
      acc[d][0] *= alpha[0];
      acc[d][1] *= alpha[0];
      acc[d][2] *= alpha[1];
      acc[d][3] *= alpha[1];
    }

    if constexpr (kStages == 1) {
      if (more)
        cp_async_wait<1>();             // V of this tile; K of the next
      else                              // may still be in flight
        cp_async_wait<0>();
      __syncthreads();
    }

    // O += P.V, 16 x hd a warp
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int dp = 0; dp < kD / 2; ++dp) {
        uint32_t bv[4];
        ldsm_x4_t(bv, smem_u32(vst + kk * 16 * kLd + dp * 16 + v_off));
        mma16816(acc[2 * dp], pf[kk], bv[0], bv[1]);
        mma16816(acc[2 * dp + 1], pf[kk], bv[2], bv[3]);
      }
    }
    __syncthreads();                    // every warp is done with V
    if constexpr (kStages == 1) {
      if (more) {
        load_bf16<HD, kHdp, BK, kLd>(vs, vb, vss, k0 + BK, Skv, async);
        cp_async_commit();
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long i = row0 + g + 8 * r;
    if (i >= Sq) continue;
    const float l = fmaxf(l_r[r], 1e-30f);
    bf16* orow = o + ((static_cast<long long>(b) * Sq + i) * H + h) * HD;
#pragma unroll
    for (int d = 0; d < kD; ++d) {
      const int col = d * 8 + 2 * tq;
      if (HD == kHdp || col < HD)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(acc[d][2 * r] / l, acc[d][2 * r + 1] / l);
    }
  }
}

// ----------------------------------------------------------------------
// launch
// ----------------------------------------------------------------------

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Sq, Skv, H, Hkv;
  long long st[9];
  long long window;
  float scale;
  cudaStream_t stream;
};

template <typename Kern>
int allow_smem(Kern kern, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

template <int HD, int BK>
int launch_f32(const Args& a) {
  using L = F32Layout<HD, BK>;
  auto kern = flash_f32_kernel<HD, BK>;
  const int err = allow_smem(kern, L::kBytes);
  if (err) return err;
  const dim3 grid(static_cast<unsigned>((a.Sq + kBlockQ - 1) / kBlockQ),
                  static_cast<unsigned>(a.H), static_cast<unsigned>(a.B));
  kern<<<grid, kF32Threads, L::kBytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.Sq, a.Skv,
      a.H, a.H / a.Hkv, a.st[0], a.st[1], a.st[2], a.st[3], a.st[4], a.st[5],
      a.st[6], a.st[7], a.st[8], a.window, a.scale);
  return repro_last_error();
}

template <int HD, int BK>
int launch_bf16(const Args& a) {
  using L = TcLayout<HD, BK>;
  auto kern = flash_bf16_kernel<HD, BK>;
  const int err = allow_smem(kern, L::kBytes);
  if (err) return err;
  // cp.async moves 16-byte chunks: every row start must be 16-byte
  // aligned (HD is a multiple of 8, so the chunks of a row then are)
  bool async = true;
  for (const void* p : {a.q, a.k, a.v})
    async = async && (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
  for (long long s : a.st) async = async && s % 8 == 0;
  const dim3 grid(static_cast<unsigned>((a.Sq + kBlockQ - 1) / kBlockQ),
                  static_cast<unsigned>(a.H), static_cast<unsigned>(a.B));
  kern<<<grid, kTcThreads, L::kBytes, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o), a.Sq, a.Skv,
      a.H, a.H / a.Hkv, a.st[0], a.st[1], a.st[2], a.st[3], a.st[4], a.st[5],
      a.st[6], a.st[7], a.st[8], a.window, a.scale * kLog2e, async);
  return repro_last_error();
}

template <int BK>
int launch_hd(int hd, int dtype, const Args& a) {
  switch (hd) {
#define REPRO_FLASH_HD(HD)                                        \
  case HD:                                                        \
    return dtype == 1 ? launch_bf16<HD, BK>(a) : launch_f32<HD, BK>(a);
    REPRO_FLASH_HD(16)
    REPRO_FLASH_HD(32)
    REPRO_FLASH_HD(64)
    REPRO_FLASH_HD(80)
    REPRO_FLASH_HD(128)
    REPRO_FLASH_HD(168)
    REPRO_FLASH_HD(320)
#undef REPRO_FLASH_HD
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: (B, Sq, H, hd), k and v: (B, Skv, Hkv, hd), each with strides
// (batch, seq, head) in elements and the head dim contiguous; o: (B, Sq,
// H, hd) contiguous.  hd in {16, 32, 64, 80, 128, 168, 320}; block_k in
// {32, 64}; dtype 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores),
// all four tensors.  B, Sq, H > 0, Skv > 0, H a multiple of Hkv.  Returns
// a cudaError_t (0 on success).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int Sq,
    int Skv, int H, int Hkv, int hd, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long window,
    float scale, int block_k, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || Sq <= 0 || Skv <= 0 || H <= 0 || H > 65535
      || Hkv <= 0 || H % Hkv != 0 || (block_k != 32 && block_k != 64)
      || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, B, Sq, Skv, H, Hkv,
               {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh},
               window, scale, static_cast<cudaStream_t>(stream)};
  return block_k == 32 ? launch_hd<32>(hd, dtype, a)
                       : launch_hd<64>(hd, dtype, a);
}
