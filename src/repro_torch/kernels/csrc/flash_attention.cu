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
// product, summed in f32, and acc / max(l, 1e-30) stored in q's dtype.
// A row that sees no key at all (i >= Skv + window - 1) averages every
// value, as the reference does.
//
// Bound: operations.  4 * hd FLOP for every visible (query, key) pair of
// every head against about 2 * (q + k + v + o) bytes: at gemma3-4b's
// hd = 320 and S = 4,096 that is ~1,000 FLOP a byte, far above the card's
// balance point.  This first version is simple and right; it runs its
// products on the CUDA cores in f32 (exact for bf16 inputs, whose products
// f32 holds exactly), not on the tensor cores, so it sits far below the
// bf16 tensor peak.  wgmma, TMA and a warp-specialised pipeline are later
// work.  What the design does:
//   * the TPU kernel's sequential kv grid dimension becomes a loop inside
//     the block; one block per (query tile of 64 rows, query head, batch
//     row), 256 threads;
//   * it reads (B, S, H, hd) through strides: no transpose, and no g-fold
//     repeat of K/V for GQA as flash_attention.py:101-107 does;
//   * KV tiles wholly outside the query tile's band are skipped: a local
//     layer of window 1,024 at S = 4,096 walks ~17 tiles of 64 keys per
//     query tile instead of up to 64, so gemma's 29 local layers cost a
//     quarter of its global ones.  Skipping is exact: a fully masked tile
//     adds exp(-1e30 - m) = 0 once a row has seen a key;
//   * any Sq and Skv: ragged tiles are zero-filled, keys past Skv score
//     -inf (they do not exist), rows past Sq are not stored;
//   * shared memory holds the q tile, one K-or-V tile (K, then V in the
//     same buffer) and the (64, BK) f32 scores; rows are padded to an odd
//     number of 32-bit words so a warp's 16 key rows fall in 16 banks.
//     At hd = 320 in f32 that is 177.5 KB (dynamic shared memory above
//     48 KB); the f32 accumulator (64 x 320) lives in registers, 80 a
//     thread;
//   * each thread computes a 4 x (BK/16) register tile of scores and a
//     4 x (hd/16) tile of the output; 4 threads share a row's softmax.
// Differences from the reference's order (a dense softmax, sums in
// another order) stay within the tests' bars: 2e-5 in f32, 3e-2 in bf16.

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlockQ = 64;              // query rows per block
constexpr float kNegInf = -1e30f;        // the reference's mask value

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Shared-memory layout of one block.
template <typename T, int HD, int BK>
struct Layout {
  // row stride in elements: HD plus 4 bytes, an odd number of words
  static constexpr int kLd = HD + 4 / static_cast<int>(sizeof(T));
  static constexpr int kLdP = BK + 1;    // scores row stride (floats)
  static constexpr size_t kQBytes = size_t(kBlockQ) * kLd * sizeof(T);
  static constexpr size_t kKvBytes = size_t(BK) * kLd * sizeof(T);
  static constexpr size_t kPBytes = size_t(kBlockQ) * kLdP * sizeof(float);
  static constexpr size_t kBytes =
      kQBytes + kKvBytes + kPBytes + 3 * kBlockQ * sizeof(float);
};

// rows [row0, row0 + ROWS) of a (rows, HD) slab with row stride
// `stride` (elements) into dst (row stride ld); rows >= n are zeros.
template <typename T, int HD, int ROWS, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long stride, int row0,
                                          int n) {
  for (int idx = threadIdx.x; idx < ROWS * HD; idx += kThreads) {
    const int r = idx / HD;
    const int c = idx - r * HD;
    const int row = row0 + r;
    dst[r * LD + c] = row < n ? src[row * stride + c] : from_float<T>(0.0f);
  }
}

template <typename T, int HD, int BK>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq,
                 int Skv, int H, int group, long long qsb, long long qss,
                 long long qsh, long long ksb, long long kss, long long ksh,
                 long long vsb, long long vss, long long vsh,
                 long long window, float scale) {
  using L = Layout<T, HD, BK>;
  constexpr int kLd = L::kLd;
  constexpr int kLdP = L::kLdP;
  constexpr int kRows = kBlockQ / 16;          // query rows per thread
  constexpr int kCols = BK / 16;               // score columns per thread
  constexpr int kAcc = HD / 16;                // output columns per thread
  constexpr int kTpr = kThreads / kBlockQ;     // softmax threads per row
  constexpr int kPc = BK / kTpr;               // their columns each

  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* kvs = reinterpret_cast<T*>(smem + L::kQBytes);
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
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;

  // the band of keys any row of this tile sees; every key when a row
  // sees none (the reference then averages over all of them)
  const long long q_last = (q0 + kBlockQ < Sq ? q0 + kBlockQ : Sq) - 1;
  long long lo = 0, hi = Skv - 1;
  if (window >= 1 && q_last < Skv + window - 1) {
    lo = q0 - window + 1 > 0 ? q0 - window + 1 : 0;
    hi = q_last < Skv - 1 ? q_last : Skv - 1;
  }
  const int t_begin = static_cast<int>(lo / BK);
  const int t_end = static_cast<int>(hi / BK);

  load_tile<T, HD, kBlockQ, kLd>(qs, qb, qss, q0, Sq);
  for (int i = tid; i < kBlockQ; i += kThreads) {
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
    load_tile<T, HD, BK, kLd>(kvs, kb, kss, k0, Skv);
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
      for (int r = 0; r < kRows; ++r)
        a[r] = to_float(qs[(ty + 16 * r) * kLd + d]);
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        bk[c] = to_float(kvs[(tx + 16 * c) * kLd + d]);
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
    load_tile<T, HD, BK, kLd>(kvs, vb, vss, k0, Skv);

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
        pr[c] = to_float(from_float<T>(p));   // P in v's dtype
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
        const float vv = to_float(kvs[j * kLd + tx + 16 * c]);
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
    T* orow = o + ((static_cast<long long>(b) * Sq + i) * H + h) * HD;
#pragma unroll
    for (int c = 0; c < kAcc; ++c)
      orow[tx + 16 * c] = from_float<T>(acc[r][c] / l);
  }
}

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

template <typename T, int HD, int BK>
int launch(const Args& a) {
  using L = Layout<T, HD, BK>;
  auto kern = flash_kernel<T, HD, BK>;
  if (L::kBytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::kBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>((a.Sq + kBlockQ - 1) / kBlockQ),
                  static_cast<unsigned>(a.H), static_cast<unsigned>(a.B));
  kern<<<grid, kThreads, L::kBytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.Sq, a.Skv, a.H,
      a.H / a.Hkv, a.st[0], a.st[1], a.st[2], a.st[3], a.st[4], a.st[5],
      a.st[6], a.st[7], a.st[8], a.window, a.scale);
  return repro_last_error();
}

template <typename T, int BK>
int launch_hd(int hd, const Args& a) {
  switch (hd) {
    case 16: return launch<T, 16, BK>(a);
    case 32: return launch<T, 32, BK>(a);
    case 64: return launch<T, 64, BK>(a);
    case 80: return launch<T, 80, BK>(a);
    case 128: return launch<T, 128, BK>(a);
    case 320: return launch<T, 320, BK>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: (B, Sq, H, hd), k and v: (B, Skv, Hkv, hd), each with strides
// (batch, seq, head) in elements and the head dim contiguous; o: (B, Sq,
// H, hd) contiguous.  hd in {16, 32, 64, 80, 128, 320}; block_k in {32,
// 64}; dtype 0 = float32, 1 = bfloat16 (all four tensors).  B, Sq, H > 0,
// Skv > 0, H a multiple of Hkv.  Returns a cudaError_t (0 on success).
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
  if (dtype == 1)
    return block_k == 32 ? launch_hd<__nv_bfloat16, 32>(hd, a)
                         : launch_hd<__nv_bfloat16, 64>(hd, a);
  return block_k == 32 ? launch_hd<float, 32>(hd, a)
                       : launch_hd<float, 64>(hd, a);
}
